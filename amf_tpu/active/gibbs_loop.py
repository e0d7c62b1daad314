"""Active-learning loop for the Gibbs BPMF model.

Capability parity with the reference's ``bayes_pmf.full_test``/
``compare_active`` (python-pmf/bayes_pmf.py:657-825): criterion registry
KEYS, query/test-set splitting, per-step MAP refit + fresh sample chain,
results in the reference schema.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from amf_tpu.analysis import metrics
from amf_tpu.models import bpmf_gibbs, pmf
from amf_tpu.types import Problem, rating_bounds, ratings_array


class GibbsKey(NamedTuple):
    nice_name: str
    kind: str  # 'random' | 'pred-variance' | 'exp-variance' | 'pred' | 'prob-ge'
    choose_max: bool
    cutoff: Optional[float] = None


# reference: bayes_pmf.KEYS :660-670
KEYS = {
    "random": GibbsKey("Random", "random", True),
    "pred-variance": GibbsKey("Var[R_ij]", "pred-variance", True),
    "exp-variance": GibbsKey("E[Var[R]]", "exp-variance", False),
    "pred": GibbsKey("Pred", "pred", True),
    "prob-ge-3.5": GibbsKey("Prob >= 3.5", "prob-ge", True, 3.5),
    "prob-ge-.5": GibbsKey("Prob >= .5", "prob-ge", True, 0.5),
    "prob-ge-0": GibbsKey("Prob >= 0", "prob-ge", True, 0.0),
}

_CUTOFFS = (3.5, 0.5, 0.0)


def split_query_test(
    real: np.ndarray,
    ratings: np.ndarray,
    test_set: str = "all",
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(query_on, test_on) masks (reference: compare_active :739-772).

    test_set: 'all' (test on every knowable cell, query on all unrated
    knowable); a float fraction; or an integer count of test cells.
    """
    rng = rng or np.random.default_rng(0)
    knowable = np.isfinite(real) & (real != 0)
    pickable = knowable.copy()
    pickable[ratings[:, 0].astype(int), ratings[:, 1].astype(int)] = False

    if test_set == "all":
        return pickable, knowable
    t = float(test_set)
    if t % 1 == 0 and t != 1:
        avail = np.transpose(pickable.nonzero())
        picked = avail[rng.choice(len(avail), size=int(t), replace=False)]
        picker = np.zeros(pickable.shape, bool)
        picker[tuple(picked.T)] = True
    else:
        picker = rng.binomial(1, t, size=pickable.shape).astype(bool)
    test_on = picker & pickable
    query_on = ~picker & pickable
    return query_on, test_on


def run_active_gibbs(
    problem: Problem,
    real: np.ndarray,
    key_names: Sequence[str],
    latent_d: int = 5,
    rating_values: Tuple[float, ...] = (),
    subtract_mean: bool = True,
    num_samps: int = 128,
    lookahead_samps: int = 30,
    lookahead_tile: int = 0,
    lookahead_host_tiles: bool = False,
    steps: Optional[int] = None,
    seed: int = 0,
    fit_type: tuple = ("batch",),
    pcfg: Optional[pmf.PMFConfig] = None,
    mesh=None,  # jax.sharding.Mesh: shard lookahead candidates over devices
    dtype=jnp.float64,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 20,
    binary_acc: bool = False,
    replay: Optional[Dict[str, list]] = None,
) -> Dict[str, object]:
    """Multi-criterion Gibbs active loop (reference: compare_active :733-825).

    binary_acc: record binary misclassification instead of RMSE — the
    reference's DrugBank metric (stan-bpmf/bpmf.py:53-54; its deprecated
    bayes driver records RMSE only, so this is a deliberate extension for
    the ±1 workloads, PARITY.md).

    replay: {criterion: pick list} — re-drive a previous run's pick
    sequence (scoring skipped; identical refit key stream) to re-score its
    err trace, e.g. under the binary metric. See driver.drive_active."""
    for k in key_names:
        if k not in KEYS:
            raise ValueError(f"unknown Gibbs criterion {k!r}")
    n, m = problem.shape
    problem = jax.tree.map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        problem,
    )
    pcfg = pcfg or pmf.PMFConfig(latent_d=latent_d, subtract_mean=subtract_mean)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=latent_d, subtract_mean=subtract_mean)

    vals = tuple(sorted(rating_values)) if rating_values else ()
    bounds = tuple(rating_bounds(vals)) if vals else None

    key = jax.random.PRNGKey(seed)
    key, kinit = jax.random.split(key)
    real_j = jnp.asarray(real, dtype=dtype)

    @jax.jit
    def sample_only(pst, prob, k):
        chain = bpmf_gibbs.init_chain(pst)
        _, stats, _ = bpmf_gibbs.run_chain(
            k, chain, prob, gcfg, num_samps,
            cutoffs=_CUTOFFS, value_bounds=bounds,
        )
        return stats

    def fit_and_sample(prob, k):
        # do_fit stays un-jitted: the 'mini-valid' fit type draws its
        # validation subset host-side (models/pmf.py)
        pst = pmf.init_state(
            jax.random.fold_in(k, 1), n, m, pcfg, prob, dtype=dtype
        )
        pst = pmf.do_fit(pst, prob, pcfg, fit_type=fit_type, key=k)
        stats = sample_only(pst, prob, jax.random.fold_in(k, 2))
        return pst, stats

    @jax.jit
    def refit_and_sample(pst, prob, k):
        pst = pmf.refresh_mean_rating(pst, prob)
        pst, _ = pmf.fit(pst, prob, pcfg)
        chain = bpmf_gibbs.init_chain(pst)
        _, stats, _ = bpmf_gibbs.run_chain(
            k, chain, prob, gcfg, num_samps, cutoffs=_CUTOFFS, value_bounds=bounds
        )
        return pst, stats

    # vals = () makes exp_variance_scores take the continuous path (normal
    # fit + trapezoid over ppf points, bayes_pmf.py:446-453 semantics)
    if mesh is not None:
        # candidates sharded over the mesh (the reference's pool.map hot
        # loop, bayes_pmf.py:514-519); per-lane PRNG streams are global-index
        # derived so this matches the unsharded path to tolerance
        from amf_tpu.parallel.sharding import sharded_candidate_scores

        @jax.jit
        def lookahead_fn(k, pst, prob, stats):
            def score_flat(cand, kk):
                return bpmf_gibbs.exp_variance_scores(
                    kk, pst, prob, pcfg, gcfg, stats, vals,
                    num_samps=lookahead_samps, n_base_samples=num_samps,
                    cand=cand, candidate_tile=lookahead_tile,
                )

            run = sharded_candidate_scores(score_flat, n * m, mesh)
            return run(k).reshape(n, m)
    elif lookahead_host_tiles and lookahead_tile:
        # One bounded device program PER TILE, dispatched from the host,
        # instead of a single lax.map program spanning every tile: each
        # tile compiles once (fixed chunk shape) and a crashed step resumes
        # at the driver checkpoint. Lane PRNG streams are global-candidate-
        # index derived (utils.rng.lane_keys), so results match the fused
        # path lane-for-lane.
        tile = int(lookahead_tile)

        @jax.jit
        def _tile_scores(k, pst, prob, stats, cand):
            return bpmf_gibbs.exp_variance_scores(
                k, pst, prob, pcfg, gcfg, stats, vals,
                num_samps=lookahead_samps, n_base_samples=num_samps,
                cand=cand,
            )

        def lookahead_fn(k, pst, prob, stats):
            queryable = np.asarray(prob.queryable).ravel()
            cand_all = np.flatnonzero(queryable).astype(np.int32)
            out = np.full(n * m, np.nan)
            pad = (-len(cand_all)) % tile
            cand_pad = np.concatenate(
                [cand_all, np.zeros(pad, np.int32)]
            )
            n_tiles = len(cand_pad) // tile
            for t in range(n_tiles):
                chunk = cand_pad[t * tile:(t + 1) * tile]
                s = np.asarray(
                    _tile_scores(k, pst, prob, stats, jnp.asarray(chunk))
                )
                take = tile if t < n_tiles - 1 else tile - pad
                out[chunk[:take]] = s[:take]
                if verbose and (t % 32 == 0 or t == n_tiles - 1):
                    print(f"    lookahead tile {t + 1}/{n_tiles}",
                          flush=True)
            return jnp.asarray(out, dtype).reshape(n, m)
    else:
        lookahead_fn = jax.jit(
            lambda k, pst, prob, stats: bpmf_gibbs.exp_variance_scores(
                k, pst, prob, pcfg, gcfg, stats, vals,
                num_samps=lookahead_samps, n_base_samples=num_samps,
                candidate_tile=lookahead_tile,
            ).reshape(n, m)
        )

    pst0, stats0 = fit_and_sample(problem, kinit)

    results: Dict[str, object] = {
        "_real": np.asarray(real),
        "_ratings": ratings_array(problem),
        "_rating_vals": vals or None,
    }

    def evals_for(kname: str, pst, stats, prob, k):
        spec = KEYS[kname]
        if spec.kind == "random":
            ev = jax.random.uniform(k, (n, m), dtype=dtype)
        elif spec.kind == "pred-variance":
            ev = stats.var
        elif spec.kind == "pred":
            ev = stats.mean
        elif spec.kind == "prob-ge":
            ev = stats.prob_ge[_CUTOFFS.index(spec.cutoff)]
        elif spec.kind == "exp-variance":
            ev = lookahead_fn(k, pst, prob, stats)
        else:
            raise ValueError(spec.kind)
        return jnp.where(prob.queryable, ev, jnp.nan)

    from amf_tpu.active.driver import Family, drive_active
    from amf_tpu.utils.checkpoint import LoopCheckpointer

    ckpt = LoopCheckpointer.for_problem(
        checkpoint_path, problem, real, every=checkpoint_every
    )

    family = Family(
        nice_name=lambda kname: KEYS[kname].nice_name,
        score=lambda kname, st, prob, k: (
            evals_for(kname, st[0], st[1], prob, k), KEYS[kname].choose_max
        ),
        refit=lambda st, prob, k: refit_and_sample(st[0], prob, k),
        err=lambda st, prob: (
            metrics.binary_misclassification(st[1].mean, real_j, prob.test)
            if binary_acc
            else metrics.rmse_on(st[1].mean, real_j, prob.test)
        ),
    )
    results.update(
        drive_active(problem, real, key_names, family, (pst0, stats0), key,
                     steps=steps, ckpt=ckpt, verbose=verbose, replay=replay)
    )
    return results
