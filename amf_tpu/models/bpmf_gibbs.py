"""Bayesian PMF via Gibbs sampling.

Capability parity with the reference's ``BayesianPMF``
(python-pmf/bayes_pmf.py:72-545): Salakhutdinov-Mnih BPMF with
Gaussian-Wishart hyperpriors, per-row conditional Gaussian draws, predictive
quantities from sample sets, and the expensive ``exp_variance`` one-step
lookahead (fresh MCMC per candidate per rating value, bayes_pmf.py:457-598).

Accelerator-first redesign:
  * per-user/per-item conditional draws — a Python loop of d x d inverses in
    the reference (bayes_pmf.py:283-300), distributed over a process pool in
    ``samples_parallel`` (:402-422) — become one batched precision build
    (einsum over the rated mask) + batched Cholesky solve for ALL rows at
    once (rows are conditionally independent given the other factor);
  * the Markov chain is a ``lax.scan``; prediction statistics (mean /
    variance / P(>=cutoff) / per-bin histograms) accumulate inside the scan,
    so the (num_samps, n, m) prediction tensor is never materialized;
  * the exp-variance lookahead fans out over (candidate x rating value) with
    ``vmap``: each lane runs a budgeted MAP refit + a short Gibbs chain
    (the reference deep-copies the model and re-runs MCMC per task in a
    multiprocessing pool, bayes_pmf.py:560-598).

Deliberate fix (SURVEY.md §2.5 do-not-replicate list): the reference's
Gaussian-Wishart posterior scale uses ``np.dot(mu0_xbar, mu0_xbar.T)`` on a
1-D vector — an inner product (scalar broadcast) where the posterior requires
the outer product (bayes_pmf.py:176). We use the correct outer product.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from amf_tpu.models import pmf
from amf_tpu.ops import chol_sample
from amf_tpu.types import Problem, rating_bounds, pytree_dataclass
from amf_tpu.utils.rng import lane_keys


class GibbsConfig(NamedTuple):
    """Static knobs (reference defaults: bayes_pmf.py:73-109)."""

    latent_d: int = 5
    subtract_mean: bool = True
    beta: float = 2.0  # observation noise precision
    b0: float = 2.0  # scale on the Gaussian's precision
    # Wishart scale = I, dof = latent_d, mu0 = 0 (bayes_pmf.py:97-109)
    num_gibbs: int = 2  # factor sweeps per hyperparameter update


@pytree_dataclass
class ChainState:
    U: jax.Array  # (n, d) current factor sample
    V: jax.Array  # (m, d)
    mean_rating: jax.Array


def init_chain(pmf_state: pmf.PMFState) -> ChainState:
    """Start the Markov chain at the MAP estimate (bayes_pmf.py:261-263)."""
    return ChainState(
        U=pmf_state.U, V=pmf_state.V, mean_rating=pmf_state.mean_rating
    )


# ---------------------------------------------------------------------------
# Wishart / Gaussian-Wishart sampling


def sample_wishart(key: jax.Array, sigma: jax.Array, dof) -> jax.Array:
    """Wishart(dof, sigma) draw via the Bartlett decomposition.

    The reference switches between a direct normal-product scheme and
    Bartlett by a MATLAB heuristic (bayes_pmf.py:41-59); both are exact, so
    we always use Bartlett (static shapes, no data-dependent branch).
    """
    d = sigma.shape[0]
    chol = jnp.linalg.cholesky(sigma)
    kc, kn = jax.random.split(key)
    dof = jnp.asarray(dof, dtype=sigma.dtype)
    # chi^2(k) = 2 * Gamma(k/2)
    chi2 = 2.0 * jax.random.gamma(
        kc, (dof - jnp.arange(d, dtype=sigma.dtype)) / 2.0, (d,), dtype=sigma.dtype
    )
    a = jnp.diag(jnp.sqrt(chi2))
    lower = jnp.tril(jax.random.normal(kn, (d, d), dtype=sigma.dtype), -1)
    X = chol @ (a + lower)
    return X @ X.T


def sample_hyperparam(
    key: jax.Array, feats: jax.Array, cfg: GibbsConfig
) -> Tuple[jax.Array, jax.Array]:
    """Gaussian-Wishart posterior draw of (mu, alpha) given a factor matrix
    (reference: bayes_pmf.sample_hyperparam :157-186, with the outer-product
    fix described in the module docstring)."""
    d = feats.shape[1]
    N = feats.shape[0]
    dtype = feats.dtype
    x_bar = jnp.mean(feats, axis=0)
    centered = feats - x_bar
    S_bar = centered.T @ centered / (N - 1)  # np.cov ddof=1 (bayes_pmf.py:169)

    mu0 = jnp.zeros(d, dtype=dtype)
    mu0_xbar = mu0 - x_bar
    wi_inv = jnp.eye(d, dtype=dtype)  # inv(I)
    WI_post = jnp.linalg.inv(
        wi_inv
        + N * S_bar
        + (cfg.b0 * N) / (cfg.b0 + N) * jnp.outer(mu0_xbar, mu0_xbar)
    )
    WI_post = (WI_post + WI_post.T) / 2

    kw, km = jax.random.split(key)
    alpha = sample_wishart(kw, WI_post, d + N)  # dof = df + N, df = latent_d

    mu_temp = (cfg.b0 * mu0 + N * x_bar) / (cfg.b0 + N)
    lam = jnp.linalg.cholesky(jnp.linalg.inv((cfg.b0 + N) * alpha))
    mu = lam @ jax.random.normal(km, (d,), dtype=dtype) + mu_temp
    return mu, alpha


# ---------------------------------------------------------------------------
# Batched conditional factor draws


def _sample_rows(
    key: jax.Array,
    mask: jax.Array,  # (rows, cols) bool — which cells this side observes
    ratings_c: jax.Array,  # (rows, cols) mean-centered ratings
    other: jax.Array,  # (cols, d) the fixed factor
    mu: jax.Array,  # (d,)
    alpha: jax.Array,  # (d, d)
    beta: float,
) -> jax.Array:
    """Draw all rows of one factor from their conditional Gaussians at once.

    Per row i: precision S_i = alpha + beta * sum_j mask_ij v_j v_j^T,
    mean = S_i^{-1} (beta * sum_j mask_ij r_ij v_j + alpha mu)
    (reference: bayes_pmf.sample_feature :189-216, one row at a time).
    """
    maskf = mask.astype(other.dtype)
    d = other.shape[1]
    # masked Gram for all rows at once, shaped as ONE large-K matmul:
    # S_i = sum_j mask_ij v_j v_j^T  ==  (mask @ vv) with vv_j = vec(v_j v_j^T).
    # (a direct einsum('ij,jk,jl->ikl') lowers to an (n, m, d, d)-ish
    # contraction; this form is (n, m) @ (m, d^2))
    vv = (other[:, :, None] * other[:, None, :]).reshape(-1, d * d)
    rhs = beta * ((maskf * ratings_c) @ other) + (alpha @ mu)[None, :]

    # z ~ N(0, I); x = S^{-1} rhs + chol(S)^{-T} z ~ N(S^{-1} rhs, S^{-1}).
    z = jax.random.normal(key, rhs.shape, dtype=rhs.dtype)
    if chol_sample.use_unrolled(d):
        # the unrolled solve reads S entry-major, (d*d, rows): the Gram
        # matmul writes that layout directly (vv_j and alpha are symmetric)
        S_cols = alpha.reshape(-1, 1) + beta * (vv.T @ maskf.T)
        return chol_sample.chol_solve_sample_unrolled(S_cols, rhs.T, z.T).T
    S = alpha[None] + beta * (maskf @ vv).reshape(-1, d, d)
    return chol_sample.chol_solve_sample_reference(S, rhs, z)


def gibbs_round(
    key: jax.Array, chain: ChainState, problem: Problem, cfg: GibbsConfig
) -> ChainState:
    """One hyperparameter draw + num_gibbs factor sweeps
    (reference: bayes_pmf.samples :277-302)."""
    r_c = problem.R_obs - (chain.mean_rating if cfg.subtract_mean else 0.0)
    k_hu, k_hv, key = jax.random.split(key, 3)
    mu_u, alpha_u = sample_hyperparam(k_hu, chain.U, cfg)
    mu_v, alpha_v = sample_hyperparam(k_hv, chain.V, cfg)

    def sweep(_, carry):
        key, U, V = carry
        key, ku, kv = jax.random.split(key, 3)
        U = _sample_rows(ku, problem.rated, r_c, V, mu_u, alpha_u, cfg.beta)
        V = _sample_rows(
            kv, problem.rated.T, r_c.T, U, mu_v, alpha_v, cfg.beta
        )
        return key, U, V

    # a loop, not unrolled: each sweep's row draws are compiled once
    _, U, V = jax.lax.fori_loop(0, cfg.num_gibbs, sweep,
                                (key, chain.U, chain.V))
    return chain.replace(U=U, V=V)


# ---------------------------------------------------------------------------
# Chains with in-scan prediction statistics


class PredStats(NamedTuple):
    """Streaming statistics of the predicted matrix over a sample chain."""

    mean: jax.Array  # (n, m) E[R_ij]
    var: jax.Array  # (n, m) Var[R_ij]
    prob_ge: jax.Array  # (n_cutoffs, n, m) P(R_ij >= cutoff)
    bin_counts: Optional[jax.Array]  # (n_bins, n, m) histogram over values


def run_chain(
    key: jax.Array,
    chain: ChainState,
    problem: Problem,
    cfg: GibbsConfig,
    num_samps: int,
    cutoffs: Tuple[float, ...] = (),
    value_bounds: Optional[Tuple[float, ...]] = None,
    keep_samples: bool = False,
) -> Tuple[ChainState, PredStats, Optional[Tuple[jax.Array, jax.Array]]]:
    """Run ``num_samps`` Gibbs rounds, accumulating prediction statistics.

    value_bounds: rating-bin edges (from types.rating_bounds) to accumulate
    per-bin counts for the discrete lookahead marginals
    (reference: bayes_pmf._distribute :489-501).
    """
    n, m = problem.shape
    dtype = chain.U.dtype
    n_cut = len(cutoffs)
    cut_arr = jnp.asarray(cutoffs, dtype=dtype).reshape(n_cut, 1, 1)
    if value_bounds is not None:
        # finite inner edges; bin v = (bounds[v] <= x < bounds[v+1])
        edges = jnp.asarray(value_bounds, dtype=dtype)
        n_bins = edges.shape[0] - 1
    else:
        n_bins = 0

    def step(carry, k):
        chain, s1, s2, ge, bins = carry
        chain = gibbs_round(k, chain, problem, cfg)
        pred = chain.U @ chain.V.T
        if cfg.subtract_mean:
            pred = pred + chain.mean_rating
        s1 = s1 + pred
        s2 = s2 + pred * pred
        if n_cut:
            ge = ge + (pred[None] >= cut_arr).astype(dtype)
        if n_bins:
            in_bin = (pred[None] >= edges[:-1, None, None]) & (
                pred[None] < edges[1:, None, None]
            )
            bins = bins + in_bin.astype(dtype)
        out = (chain.U, chain.V) if keep_samples else None
        return (chain, s1, s2, ge, bins), out

    init = (
        chain,
        jnp.zeros((n, m), dtype),
        jnp.zeros((n, m), dtype),
        jnp.zeros((n_cut, n, m), dtype),
        jnp.zeros((n_bins, n, m), dtype),
    )
    keys = jax.random.split(key, num_samps)
    (chain, s1, s2, ge, bins), samples = jax.lax.scan(step, init, keys)

    mean = s1 / num_samps
    var = s2 / num_samps - mean**2  # np.var convention (ddof=0)
    stats = PredStats(
        mean=mean,
        var=jnp.maximum(var, 0.0),
        prob_ge=ge / num_samps,
        bin_counts=bins if n_bins else None,
    )
    return chain, stats, samples


# ---------------------------------------------------------------------------
# exp-variance lookahead (reference: bayes_pmf.exp_variance :457-468,
# _integrate_lookahead :560-598)


def exp_variance_scores(
    key: jax.Array,
    pmf_state: pmf.PMFState,
    problem: Problem,
    pcfg: pmf.PMFConfig,
    cfg: GibbsConfig,
    base_stats: PredStats,
    rating_values: Tuple[float, ...],
    num_samps: int = 30,
    fit_first: bool = True,
    fit_budget: int = 200,
    cand: Optional[jax.Array] = None,
    dirichlet_alpha: float = 0.1,
    n_base_samples: int = 128,
    candidate_tile: int = 0,
    num_integration_pts: int = 50,
    poly_ls: bool = True,
) -> jax.Array:
    """E[total Var[R]] after hypothetically observing each candidate cell.

    Weights: Dirichlet-smoothed histogram of the base chain's predictions
    per cell (reference: bayes_pmf.py:489-501); for continuous data a
    fitted normal integrated by trapezoid over ppf points (:446-453 — on
    the mu + sigma z substitution the weights are candidate-independent,
    see bpmf_hmc.lookahead_scores). Each (candidate, value) lane refits the
    MAP (fit_first) and runs a fresh short Gibbs chain.
    Returns flat scores (NaN off the queryable pool).
    """
    n, m = problem.shape
    if cand is None:
        cand = jnp.arange(n * m, dtype=jnp.int32)
    dtype = pmf_state.U.dtype
    ii, jj = cand // m, cand % m

    if rating_values and base_stats.bin_counts is None:
        raise ValueError(
            "rating_values given but base_stats has no bin_counts — run the "
            "base chain with value_bounds for the discrete lookahead"
        )
    if rating_values:
        values = jnp.asarray(sorted(rating_values), dtype=dtype)
        n_vals = values.shape[0]
        counts = base_stats.bin_counts  # raw per-bin counts, base chain
        denom = n_base_samples + dirichlet_alpha * n_vals
        weights_full = (counts + dirichlet_alpha) / denom  # (V, n, m)
        w_c = weights_full[:, ii, jj].T  # (C, V)
        vals_c = jnp.broadcast_to(values, (cand.shape[0], n_vals))
    else:
        from amf_tpu.ops.quadrature import normal_trapezoid_grid

        z, w = normal_trapezoid_grid(num_integration_pts)
        n_vals = num_integration_pts
        mean_c = base_stats.mean[ii, jj]
        std_c = jnp.sqrt(jnp.maximum(base_stats.var[ii, jj], 1e-12))
        vals_c = mean_c[:, None] + std_c[:, None] * jnp.asarray(z, dtype)
        w_c = jnp.broadcast_to(jnp.asarray(w, dtype), vals_c.shape)

    def eval_one(i, j, v, k):
        prob2 = problem.add_rating(i, j, v)
        pst = pmf_state
        if fit_first:
            pst = pmf.refresh_mean_rating(pst, prob2)
            # poly_ls: rejected lrs in the per-lane MAP refit are adjudicated
            # by an exact scalar quartic (ops.linesearch.adaptive_descent_poly)
            # instead of full value passes — the refit ladder dominates this
            # fan-out's cost (~4.6 rejects/accept measured at ML-100k shape)
            pst, _ = pmf.fit(pst, prob2, pcfg, max_steps=fit_budget,
                             poly_ls=poly_ls)
        chain = init_chain(pst)
        _, stats, _ = run_chain(k, chain, prob2, cfg, num_samps)
        # total variance over ALL cells: the reference's lookahead calls
        # total_variance with the default which=Ellipsis (bayes_pmf.py:565-569)
        return jnp.sum(stats.var)

    keys = lane_keys(key, cand, n_vals)  # shard/tile-invariant streams
    eval_tile = jax.vmap(
        lambda i, j, vs, ks: jax.vmap(
            lambda v, k: eval_one(i, j, v, k))(vs, ks)
    )

    c_total = cand.shape[0]
    if candidate_tile and c_total > candidate_tile:
        # memory-bounded blocked sweep over candidate chunks (each lane
        # carries its own problem copy and Gibbs chain state)
        tile = candidate_tile
        pad = (-c_total) % tile

        def padded(x):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)

        chunks = lambda x: x.reshape((-1, tile) + x.shape[1:])
        evals = jax.lax.map(
            lambda args: eval_tile(*args),
            (chunks(padded(ii)), chunks(padded(jj)), chunks(padded(vals_c)),
             chunks(padded(keys))),
        ).reshape(c_total + pad, n_vals)[:c_total]
    else:
        evals = eval_tile(ii, jj, vals_c, keys)  # (C, V)

    scores = jnp.sum(evals * w_c, axis=-1)
    return jnp.where(problem.queryable[ii, jj], scores, jnp.nan)
