"""Core pytree containers shared across the framework.

The reference keeps problem state as an append-only ``(i, j, value)`` ratings
array plus Python ``rated``/``unrated`` sets (reference: python-pmf/pmf.py:42-53,
64-91).  On an accelerator we need static shapes, so a problem is a dense value matrix
plus boolean masks; "adding a rating" is a functional mask/value update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree with every field a leaf.

    ``obj.replace(**changes)`` returns a copy with the named fields changed.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class Problem:
    """Dense masked view of an active matrix-completion problem.

    Attributes:
      R_obs:     (n, m) float. Observed (or hypothesized, during lookahead)
                 value for every rated cell; arbitrary elsewhere (multiply by
                 ``rated`` before use).
      rated:     (n, m) bool. Cells whose value the learner currently knows.
      queryable: (n, m) bool. Cells the learner may still query. Disjoint from
                 ``rated``; shrinks as queries are made.
      test:      (n, m) bool. Held-out cells used for RMSE / misclassification.

    ``rating_values`` (the discrete label set) is deliberately *not* stored
    here: it is static metadata and lives in model/loop configs so that it can
    shape compiled code (reference analogue: ``_rating_values`` tuple,
    python-pmf/active_pmf.py:171-185).
    """

    R_obs: jax.Array
    rated: jax.Array
    queryable: jax.Array
    test: jax.Array

    @property
    def shape(self) -> Tuple[int, int]:
        return self.R_obs.shape

    @property
    def n_rated(self) -> jax.Array:
        return jnp.sum(self.rated)

    def mean_rating(self) -> jax.Array:
        """Mean of the currently observed ratings (reference: pmf.py:45,90)."""
        cnt = jnp.maximum(jnp.sum(self.rated), 1)
        return jnp.sum(jnp.where(self.rated, self.R_obs, 0.0)) / cnt

    def add_rating(self, i, j, value) -> "Problem":
        """Functionally record value for cell (i, j).

        Replaces ``ProbabilisticMatrixFactorization.add_rating``
        (reference: pmf.py:64-91) — a pure O(1) scatter instead of an array
        append, so it is jit/vmap-safe and usable inside the lookahead fan-out.
        """
        return self.replace(
            R_obs=self.R_obs.at[i, j].set(value),
            rated=self.rated.at[i, j].set(True),
            queryable=self.queryable.at[i, j].set(False),
        )


def problem_from_dense(
    real: np.ndarray,
    known: np.ndarray,
    queryable: Optional[np.ndarray] = None,
    test: Optional[np.ndarray] = None,
    dtype=jnp.float32,
    zeros_unknowable: bool = True,
) -> Problem:
    """Build a Problem from a dense matrix + initially-known mask.

    Mirrors how reference CLIs derive knowable/pickable/test masks
    (reference: python-pmf/bayes_pmf.py:739-772): cells with value 0 or NaN
    are unknowable (for LOADED data; pass zeros_unknowable=False for
    synthetic data, where the reference treats every cell as knowable —
    active_pmf.py:1216-1219 applies the 0-rule only to --load-data);
    queryable defaults to knowable-and-not-known; test defaults to all
    knowable cells. When an explicit held-out ``test`` mask is given, test
    cells are EXCLUDED from the query pool (reference:
    mn_active_pmf.py:1091-1093, stan-bpmf/bpmf.py:915) so the learner cannot
    train on its own test set.
    """
    real = np.asarray(real, dtype=np.float64)
    known = np.asarray(known, dtype=bool)
    knowable = np.isfinite(real)
    if zeros_unknowable:
        knowable &= real != 0
    if queryable is None:
        queryable = knowable & ~known
        if test is not None:
            queryable = queryable & ~np.asarray(test, dtype=bool)
    if test is None:
        test = knowable
    r_obs = np.where(known, np.nan_to_num(real), 0.0)
    return Problem(
        R_obs=jnp.asarray(r_obs, dtype=dtype),
        rated=jnp.asarray(known),
        queryable=jnp.asarray(np.asarray(queryable, dtype=bool)),
        test=jnp.asarray(np.asarray(test, dtype=bool)),
    )


def ratings_array(problem: Problem) -> np.ndarray:
    """Export the rated cells as the reference's (n_rated, 3) [i, j, value]
    array (schema documented at reference stan-bpmf/bpmf.py:744-754)."""
    rated = np.asarray(problem.rated)
    r = np.asarray(problem.R_obs)
    ii, jj = np.nonzero(rated)
    return np.stack([ii, jj, r[ii, jj]], axis=1).astype(np.float64)


def problem_from_ratings(
    ratings: np.ndarray,
    shape: Optional[Tuple[int, int]] = None,
    real: Optional[np.ndarray] = None,
    test: Optional[np.ndarray] = None,
    dtype=jnp.float32,
) -> Problem:
    """Build a Problem from the reference's (k, 3) ratings array.

    If ``real`` is given, unknowable cells (0 / NaN in ``real``) are excluded
    from the queryable set, as in reference active_pmf.py:1217-1219.
    """
    ratings = np.asarray(ratings, dtype=np.float64)
    if shape is None:
        if real is not None:
            shape = real.shape
        else:
            shape = (int(ratings[:, 0].max()) + 1, int(ratings[:, 1].max()) + 1)
    known = np.zeros(shape, dtype=bool)
    r_obs = np.zeros(shape, dtype=np.float64)
    ii = ratings[:, 0].astype(int)
    jj = ratings[:, 1].astype(int)
    known[ii, jj] = True
    r_obs[ii, jj] = ratings[:, 2]
    if real is not None:
        knowable = np.isfinite(np.asarray(real, dtype=np.float64))
        knowable &= np.asarray(real) != 0
    else:
        knowable = np.ones(shape, dtype=bool)
    queryable = knowable & ~known
    if test is None:
        test_mask = knowable
    else:
        # held-out test cells are not queryable (see problem_from_dense)
        test_mask = np.asarray(test, dtype=bool)
        queryable = queryable & ~test_mask
    return Problem(
        R_obs=jnp.asarray(r_obs, dtype=dtype),
        rated=jnp.asarray(known),
        queryable=jnp.asarray(queryable),
        test=jnp.asarray(test_mask),
    )


def rating_bounds(rating_values: Tuple[float, ...]) -> np.ndarray:
    """Midpoints between sorted rating values, with +-inf ends.

    Used to convert a predictive normal into per-value probability masses
    (reference: active_pmf.py:171-185, bayes_pmf.py:137-150).
    """
    vals = np.sort(np.asarray(rating_values, dtype=np.float64))
    v = np.empty(len(vals) + 2)
    v[0] = -np.inf
    v[1:-1] = vals
    v[-1] = np.inf
    return (v[1:] + v[:-1]) / 2
