"""Rating-concentration (maxent) matrix completion.

Capability parity with the reference's ratingconcentration/ MATLAB+MEX suite
(ratingconcentration.m, maxentmulti.m, dual3.m, computep.m, setbounds.m,
sets_square5.m, and the sparse MEX kernels spouterprod/sprowsumprod): the
Huang–Jebara maxent model — per-cell multinomials over the rating values whose
per-row/per-column expected feature vectors are matched to the observed
averages within McDiarmid-style concentration bounds, fit through the
box-constrained dual over Lagrange multipliers (gamma+/-, lambda+/-).

Accelerator-first redesign:
  * the dual objective is a dense masked logsumexp over (value, row, column)
    — the reference's sparse MEX inner loops (spouterprod.c:47-120,
    sprowsumprod.c) become batched einsums, and its explicit gradient
    (dual3.m:60-83) becomes autodiff;
  * the Fortran L-BFGS-B becomes ops.lbfgsb (projected L-BFGS);
  * the reference's cutting-plane active-set loop (maxentmulti.m) exists to
    keep the CPU solve small; we solve the full box-constrained dual directly
    — same KKT optimum, one compiled solve;
  * overflow clamps (computep.m:20-26, spouterprod.c:114-115) are replaced by
    a max-shifted logsumexp, which is exact.

Note (SURVEY.md §2.5): the reference's evaluate_active.m:29 unconditionally
overrides the feature function with @sets_square5; our feature map follows
the declared value set instead.
"""

from __future__ import annotations

from itertools import combinations
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from amf_tpu.ops.lbfgsb import lbfgsb
from amf_tpu.types import Problem, pytree_dataclass


def feature_map(values: Tuple[float, ...]) -> np.ndarray:
    """Per-value feature vectors F (n_values, k).

    For 5 values this reproduces sets_square5.m:1-14 exactly: 5 indicators,
    10 pairwise-membership indicators, normalized linear and quadratic terms
    (17 features). The same construction generalizes to any value count
    (2 values -> the binary variant's role, sets_binary.m).
    """
    v = np.asarray(sorted(values), dtype=np.float64)
    nv = v.size
    pairs = list(combinations(range(nv), 2))
    k = nv + len(pairs) + 2
    F = np.zeros((nv, k))
    for r in range(nv):
        F[r, r] = 1.0
        for p, (a, b) in enumerate(pairs):
            if r == a or r == b:
                F[r, nv + p] = 1.0
        span = max(v[-1] - v[0], 1.0)
        F[r, -2] = (v[r] - v[0]) / span
        F[r, -1] = ((v[r] - v[0]) ** 2) / span**2
    return F


def set_bounds(c, d, C, D, delta: float):
    """Concentration bounds alpha (rows), beta (cols)
    (reference: setbounds.m:1-28, including its clip-at-2 quirk: note the
    original clips beta by the *alpha* condition — we clip each by its own)."""
    eps = np.finfo(np.float64).eps
    c = jnp.maximum(c, eps)
    d = jnp.maximum(d, eps)
    C = jnp.maximum(C, eps)
    D = jnp.maximum(D, eps)
    if delta > 0:
        alpha = (2 - delta) * (jnp.sqrt(1 / (2 * C)) + jnp.sqrt((c + C) / (2 * C * c)))
        beta = (2 - delta) * (jnp.sqrt(1 / (2 * D)) + jnp.sqrt((d + D) / (2 * D * d)))
        alpha = jnp.minimum(alpha, 2.0)
        beta = jnp.minimum(beta, 2.0)
    else:
        alpha = 2.0 * jnp.ones_like(c)
        beta = 2.0 * jnp.ones_like(d)
    return alpha, beta


class RCConfig(NamedTuple):
    rating_values: Tuple[float, ...] = (1.0, 2.0, 3.0, 4.0, 5.0)
    delta: float = 1.5  # reference default (evaluate_active.m:5)
    upper: float = 1e4  # multiplier box upper bound (maxentmulti.m lbfgsb call)
    max_iters: int = 500
    pgtol: float = 1e-7


@pytree_dataclass
class RCData:
    """Static-per-problem tensors for the dual."""

    F: jax.Array  # (V, k) feature map
    prior: jax.Array  # (V,) empirical value distribution of observed ratings
    log_prior: jax.Array
    mu: jax.Array  # (n, k) per-row observed feature means
    nu: jax.Array  # (m, k) per-col observed feature means
    alpha: jax.Array  # (n, k) row bounds
    beta: jax.Array  # (m, k) col bounds
    c: jax.Array  # (n,) query counts per row
    d: jax.Array  # (m,) query counts per col
    qmask: jax.Array  # (n, m) query cells (the reference's `mask`)


def prepare(problem: Problem, cfg: RCConfig, dtype=jnp.float64) -> RCData:
    """Compute observed averages, prior, and bounds
    (reference: maxentmulti.m computeaverages/setbounds calls)."""
    vals = np.asarray(sorted(cfg.rating_values), dtype=np.float64)
    F_np = feature_map(cfg.rating_values)
    V, k = F_np.shape
    F = jnp.asarray(F_np, dtype)

    rated = problem.rated
    ratedf = rated.astype(dtype)
    qmask = problem.queryable
    qf = qmask.astype(dtype)

    # map each observed rating to its value index -> one-hot -> features
    r = problem.R_obs
    val_arr = jnp.asarray(vals, dtype)
    idx = jnp.argmin(jnp.abs(r[..., None] - val_arr), axis=-1)  # (n, m)
    onehot = jax.nn.one_hot(idx, V, dtype=dtype) * ratedf[..., None]
    feats_cells = onehot @ F  # (n, m, k)

    Cn = ratedf.sum(1)  # observed per row
    Dm = ratedf.sum(0)
    mu = feats_cells.sum(1) / jnp.maximum(Cn[:, None], 1)
    nu = feats_cells.sum(0) / jnp.maximum(Dm[:, None], 1)

    c = qf.sum(1)
    d = qf.sum(0)
    a, b = set_bounds(c, d, Cn, Dm, cfg.delta)
    alpha = jnp.broadcast_to(a[:, None], (a.shape[0], k))
    beta = jnp.broadcast_to(b[:, None], (b.shape[0], k))

    # prior over values from observed ratings (ratingconcentration.m:47-52)
    counts = onehot.sum((0, 1))
    prior = counts / jnp.maximum(counts.sum(), 1)
    prior = jnp.maximum(prior, 1e-12)
    return RCData(
        F=F, prior=prior, log_prior=jnp.log(prior),
        mu=mu, nu=nu, alpha=alpha, beta=beta, c=c, d=d, qmask=qmask,
    )


def _split(x, n, m, k):
    gp = x[: n * k].reshape(n, k)
    gm = x[n * k : 2 * n * k].reshape(n, k)
    lp = x[2 * n * k : 2 * n * k + m * k].reshape(m, k)
    lm = x[2 * n * k + m * k :].reshape(m, k)
    return gp, gm, lp, lm


def dual_objective(x: jax.Array, data: RCData) -> jax.Array:
    """The maxent dual (reference: dual3.m:1-58), dense and masked.

    f = -sum((g+ - g-) mu) - sum((l+ - l-) nu)
      + sum((g+ + g-) alpha) + sum((l+ + l-) beta)
      + sum_{ij in qmask} log Z_ij,
    Z_ij = sum_s prior_s exp(F_s U_i + F_s V_j),
    U_i = (g+ - g-)_i / c_i, V_j = (l+ - l-)_j / d_j.
    """
    n, k = data.mu.shape
    m = data.nu.shape[0]
    gp, gm, lp, lm = _split(x, n, m, k)

    f = -jnp.sum((gp - gm) * data.mu) - jnp.sum((lp - lm) * data.nu)
    f = f + jnp.sum((gp + gm) * data.alpha) + jnp.sum((lp + lm) * data.beta)

    eps = jnp.finfo(x.dtype).eps
    U = (gp - gm) / jnp.maximum(data.c, eps)[:, None]  # (n, k)
    Vm = (lp - lm) / jnp.maximum(data.d, eps)[:, None]  # (m, k)
    fu = U @ data.F.T  # (n, V)
    fv = Vm @ data.F.T  # (m, V)
    logits = (
        data.log_prior[None, None, :] + fu[:, None, :] + fv[None, :, :]
    )  # (n, m, V)
    logZ = jax.scipy.special.logsumexp(logits, axis=-1)
    f = f + jnp.sum(jnp.where(data.qmask, logZ, 0.0))
    return f


def cell_probs(x: jax.Array, data: RCData, cells_mask: jax.Array) -> jax.Array:
    """(n, m, V) normalized per-cell multinomials over ``cells_mask``
    (reference: computep.m normalized, ratingconcentration.m:60-77)."""
    n, k = data.mu.shape
    m = data.nu.shape[0]
    gp, gm, lp, lm = _split(x, n, m, k)
    eps = jnp.finfo(x.dtype).eps
    U = (gp - gm) / jnp.maximum(data.c, eps)[:, None]
    Vm = (lp - lm) / jnp.maximum(data.d, eps)[:, None]
    logits = (
        data.log_prior[None, None, :]
        + (U @ data.F.T)[:, None, :]
        + (Vm @ data.F.T)[None, :, :]
    )
    P = jax.nn.softmax(logits, axis=-1)
    return jnp.where(cells_mask[..., None], P, 0.0)


def fit(
    problem: Problem,
    cfg: RCConfig,
    warmstart: Optional[jax.Array] = None,
    dtype=jnp.float64,
) -> Tuple[jax.Array, RCData, jax.Array]:
    """Fit the multipliers; returns (x, data, n_iters)
    (reference: ratingconcentration.m -> maxentmulti.m)."""
    data = prepare(problem, cfg, dtype)
    n, k = data.mu.shape
    m = data.nu.shape[0]
    dim = 2 * (n + m) * k
    x0 = warmstart if warmstart is not None else jnp.zeros(dim, dtype)

    val_grad = jax.value_and_grad(lambda x: dual_objective(x, data))
    res = lbfgsb(
        val_grad, x0, 0.0, cfg.upper,
        max_iters=cfg.max_iters, pgtol=cfg.pgtol,
    )
    return res.x, data, res.n_iters


def predictions(
    x: jax.Array, data: RCData, problem: Problem, cfg: RCConfig
) -> Tuple[jax.Array, jax.Array]:
    """(E, P): expected ratings and per-cell multinomials over query+observed
    cells (reference: ratingconcentration.m:55-77)."""
    cells = data.qmask | problem.rated
    P = cell_probs(x, data, cells)
    vals = jnp.asarray(sorted(cfg.rating_values), dtype=x.dtype)
    E = P @ vals
    return E, P


RC_KEYS = {
    "ge-1": ("Prob >= 1", 1.0),
    "ge-4": ("Prob >= 4", 4.0),
    "entropy": ("Entropy Lookahead", None),
    "random": ("Random", None),
}


def entropy_lookahead_scores(
    x: jax.Array,
    data: RCData,
    problem: Problem,
    cfg: RCConfig,
    lookahead_iters: int = 60,
    cand: Optional[jax.Array] = None,
    dtype=jnp.float64,
    candidate_tile: int = 0,
) -> jax.Array:
    """select_1step_lowest_entropy.m:1-41: for each candidate cell and value,
    refit the maxent model (warm-started, budgeted) and compute the entropy of
    the remaining query cells' multinomials; expectation under the current
    cell multinomial. One vmapped pass over (candidate x value); the reference
    refits the full model per candidate per value in a MATLAB loop.
    """
    n, m = problem.shape
    if cand is None:
        cand = jnp.arange(n * m, dtype=jnp.int32)
    vals = jnp.asarray(sorted(cfg.rating_values), dtype=dtype)
    P_now = cell_probs(x, data, data.qmask)

    def eval_one(i, j, v):
        prob2 = problem.add_rating(i, j, v)
        x2, data2, _ = fit(
            prob2, cfg._replace(max_iters=lookahead_iters), warmstart=x,
            dtype=dtype,
        )
        P2 = cell_probs(x2, data2, data2.qmask)
        plogp = jnp.where(P2 > 0, P2 * jnp.log(P2), 0.0)
        return -jnp.sum(plogp)

    ii, jj = cand // m, cand % m

    def per_cand(i, j):
        ents = jax.vmap(lambda v: eval_one(i, j, v))(vals)
        w = P_now[i, j]
        return jnp.sum(w * ents)

    c_total = cand.shape[0]
    if candidate_tile and c_total > candidate_tile:
        # each lane solves a full warm-started dual with (n, m, V) logits
        # intermediates — chunk the fan-out to bound peak memory
        tile = candidate_tile
        pad = (-c_total) % tile
        ii_p = jnp.pad(ii, (0, pad))
        jj_p = jnp.pad(jj, (0, pad))
        chunks = lambda x: x.reshape(-1, tile)
        scores = jax.lax.map(
            lambda args: jax.vmap(per_cand)(*args),
            (chunks(ii_p), chunks(jj_p)),
        ).reshape(-1)[:c_total]
    else:
        scores = jax.vmap(per_cand)(ii, jj)
    return jnp.where(problem.queryable[ii, jj], scores, jnp.nan)
