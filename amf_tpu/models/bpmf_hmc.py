"""Bayesian PMF sampled with native NUTS — the Stan-path replacement.

Capability parity with the reference's ``BPMF`` class + Stan models
(stan-bpmf/bpmf.py:176-478, bpmf_w0identity.stan): the Wishart-
reparameterized hierarchical prior (chi-squared diagonal / standard-normal
lower triangle building a Wishart(nu_0, I) factor A, latent-factor
covariance L L^T with L = A^{-1}), multi-normal-Cholesky priors on U and V,
normal likelihood, sampled-mode warm starts, and the sample-based criteria.

The reference runs RStan's NUTS in-process via rpy2 per fit
(rstan_interface.py:116-166) — including a full fresh NUTS run per lookahead
candidate x rating value (stan-bpmf/bpmf.py:488-491). Here the posterior is a
pure JAX log-density and chains are compiled scans (mcmc.nuts), so chains and
lookahead candidates batch with vmap.

Replicated Stan quirk: the standardized means are given sd = 1/beta_0
(``mu_u_stdized ~ normal(0, one_over_beta_0)``, bpmf_w0identity.stan:107),
not 1/sqrt(beta_0) as the comment in the model suggests; we match the code.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from amf_tpu.mcmc import nuts
from amf_tpu.models import pmf
from amf_tpu.types import Problem, pytree_dataclass
from amf_tpu.utils.rng import lane_keys


class HMCConfig(NamedTuple):
    """Hyperparameters (reference defaults: stan-bpmf/bpmf.py:187-193)."""

    latent_d: int = 5
    subtract_mean: bool = True
    rating_std: float = 0.5
    beta_0: float = 2.0
    # nu_0 = latent_d, mu_0 = 0, w_0 = I (the w0identity model)
    max_depth: int = 8
    # density variant (reference --model-filename, stan-bpmf/bpmf.py:739-742):
    # 'w0identity' = bpmf_w0identity.stan (default; skips the w_0 solves);
    # 'bpmf' = the general bpmf.stan construction with w_0 = I supplied as
    # data (the only w_0 the reference ever passes, bpmf.py:193) — same
    # posterior, exercises the general cov_L = A^{-1} chol(w_0)^{-1} path.
    # Arbitrary w_0 / mu_0 / nu_0 are available via log_posterior's args.
    model: str = "w0identity"


class ParamShapes(NamedTuple):
    n: int
    m: int
    d: int

    @property
    def n_tri(self) -> int:
        return max(self.d * (self.d - 1) // 2, 1)

    @property
    def dim(self) -> int:
        return (self.n + self.m) * self.d + 2 * self.d + 2 * (self.d + self.n_tri)


def unpack(q: jax.Array, s: ParamShapes) -> Dict[str, jax.Array]:
    """Split the flat unconstrained vector into named parameter blocks."""
    idx = 0

    def take(k):
        nonlocal idx
        out = q[idx : idx + k]
        idx += k
        return out

    out = {
        "U": take(s.n * s.d).reshape(s.n, s.d),
        "V": take(s.m * s.d).reshape(s.m, s.d),
        "mu_u_std": take(s.d),
        "mu_v_std": take(s.d),
        "log_c_u": take(s.d),
        "z_u": take(s.n_tri),
        "log_c_v": take(s.d),
        "z_v": take(s.n_tri),
    }
    return out


def pack(params: Dict[str, jax.Array]) -> jax.Array:
    return jnp.concatenate(
        [
            params["U"].reshape(-1),
            params["V"].reshape(-1),
            params["mu_u_std"],
            params["mu_v_std"],
            params["log_c_u"],
            params["z_u"],
            params["log_c_v"],
            params["z_v"],
        ]
    )


def init_params(
    s: ParamShapes, dtype, U: Optional[jax.Array] = None,
    V: Optional[jax.Array] = None,
) -> Dict[str, jax.Array]:
    """Identity-covariance init; factors at the MAP estimate if given
    (the reference's --model-init PMF warm start, stan-bpmf/bpmf.py:827-865)."""
    z = lambda k: jnp.zeros(k, dtype)
    return {
        "U": (U if U is not None else jnp.zeros((s.n, s.d))).astype(dtype),
        "V": (V if V is not None else jnp.zeros((s.m, s.d))).astype(dtype),
        "mu_u_std": z(s.d),
        "mu_v_std": z(s.d),
        "log_c_u": z(s.d),
        "z_u": z(s.n_tri),
        "log_c_v": z(s.d),
        "z_v": z(s.n_tri),
    }


def _tri_from(z: jax.Array, sqrt_c: jax.Array, d: int) -> jax.Array:
    """Lower-triangular Bartlett factor A: diag = sqrt(c), strict lower = z
    (bpmf_w0identity.stan:83-102; column-major fill order as in Stan)."""
    a = jnp.diag(sqrt_c)
    if d > 1:
        # Stan fills (i, j) for j in 1..d, i in j+1..d — column-major strict
        # lower (bpmf_w0identity.stan:86-101):
        order = [(i, j) for j in range(d) for i in range(j + 1, d)]
        ii = jnp.asarray([o[0] for o in order])
        jj = jnp.asarray([o[1] for o in order])
        a = a.at[ii, jj].set(z[: len(order)])
    return a


def _prior_logp_half(
    feats: jax.Array,  # (rows, d) factor matrix
    mu_std: jax.Array,
    log_c: jax.Array,
    z: jax.Array,
    cfg: HMCConfig,
    d: int,
    w0_chol: Optional[jax.Array] = None,  # chol(w_0); None = identity
    mu_0: Optional[jax.Array] = None,  # None = zeros
    nu_0: Optional[float] = None,  # None = d (the reference default)
) -> jax.Array:
    """Log prior for one side (U or V): chi2/normal Wishart-factor prior,
    standardized mean, and multi_normal_cholesky factor prior.

    The default arguments give bpmf_w0identity.stan; passing w0_chol /
    mu_0 / nu_0 gives the general model (bpmf.stan:66-127): the covariance
    Cholesky factor becomes ``cov_L = A^{-1} chol(w_0)^{-1}``
    (bpmf.stan:104-105 ``mdivide_left_tri_low(cov_A, w_0_L_inv)``) and the
    factor-mean shifts by mu_0 (bpmf.stan:115-116)."""
    dtype = feats.dtype
    c = jnp.exp(log_c)
    nu = jnp.asarray(d if nu_0 is None else nu_0, dtype)
    k = nu - jnp.arange(d, dtype=dtype)  # nu_0 - i + 1, i = 1..d

    # c_i ~ chi2(k_i), plus log|dc/dlog_c| = sum(log_c)
    lp = jnp.sum((k / 2 - 1) * log_c - c / 2) + jnp.sum(log_c)
    lp = lp - 0.5 * jnp.sum(z * z)
    # mu_std ~ N(0, (1/beta_0)^2)  [Stan sd = 1/beta_0 — see module docstring]
    lp = lp - 0.5 * jnp.sum((mu_std * cfg.beta_0) ** 2)

    a = _tri_from(z, jnp.sqrt(c), d)
    rows = feats.shape[0]
    if w0_chol is None:
        # L = A^{-1}; mu = L mu_std; x_i ~ MVN(mu, L L^T)
        # log|L| = -log|A| = -0.5 sum(log c); quadratic via A (x - mu)
        mu = jax.scipy.linalg.solve_triangular(a, mu_std, lower=True)
        resid = (feats - mu) @ a.T  # A (x_i - mu) for all rows at once
        lp = lp + rows * 0.5 * jnp.sum(log_c) - 0.5 * jnp.sum(resid * resid)
    else:
        # general w_0: L = A^{-1} W_L^{-1} so L^{-1} = W_L A and
        # log|L| = -0.5 sum(log c) - sum(log diag(W_L))
        w0_chol = w0_chol.astype(dtype)
        mu = jax.scipy.linalg.solve_triangular(
            a,
            jax.scipy.linalg.solve_triangular(w0_chol, mu_std, lower=True),
            lower=True,
        )
        if mu_0 is not None:
            mu = mu_0.astype(dtype) + mu
        resid = (feats - mu) @ (w0_chol @ a).T  # L^{-1} (x_i - mu)
        lp = (
            lp
            + rows * (0.5 * jnp.sum(log_c)
                      + jnp.sum(jnp.log(jnp.diag(w0_chol))))
            - 0.5 * jnp.sum(resid * resid)
        )
    return lp


def _prior_logp_half_straightforward(
    feats: jax.Array,  # (rows, d)
    mu: jax.Array,  # (d,) — the factor mean DIRECTLY (no standardization)
    log_diag: jax.Array,  # (d,) log diag of chol(cov)
    z: jax.Array,  # strict lower of chol(cov)
    cfg: HMCConfig,
    d: int,
    w0_chol: Optional[jax.Array] = None,
    mu_0: Optional[jax.Array] = None,
    nu_0: Optional[float] = None,
) -> jax.Array:
    """One side of bpmf_straightforward.stan:41-58 — the naive
    centered parameterization: cov ~ inv_wishart(nu_0, w_0) on a
    Cholesky-with-log-diagonal unconstrained cov (Stan's cov_matrix
    transform; Jacobian sum_i (d - i + 2) log L_ii), mu ~
    multi_normal(mu_0, cov / beta_0), rows ~ multi_normal(mu, cov).
    NOTE the reference's own variants disagree on the beta_0 scaling:
    bpmf.stan/bpmf_w0identity.stan put sd 1/beta_0 on the standardized
    mean (i.e. mu ~ MVN(mu_0, cov/beta_0^2)) while
    bpmf_straightforward.stan uses cov/beta_0 — so the straightforward
    posterior differs slightly from the reparameterized ones (PARITY.md
    lists this as a known reference inconsistency). We mirror each
    density as written; kept for parity with the reference's comparison
    model. (The reference's .stan
    file itself declares V as n_users x rank — a latent bug that keeps it
    from compiling on rectangular problems; we implement the intended
    density.)"""
    dtype = feats.dtype
    nu = jnp.asarray(d if nu_0 is None else nu_0, dtype)
    rows = feats.shape[0]
    L = _tri_from(z, jnp.exp(log_diag), d)
    logdet_cov = 2.0 * jnp.sum(log_diag)

    # inv_wishart(nu_0, w_0): -(nu+d+1)/2 log|S| - tr(w_0 S^{-1})/2
    if w0_chol is None:
        Linv = jax.scipy.linalg.solve_triangular(
            L, jnp.eye(d, dtype=dtype), lower=True
        )
        tr_term = jnp.sum(Linv * Linv)
    else:
        LiW = jax.scipy.linalg.solve_triangular(
            L, w0_chol.astype(dtype), lower=True
        )
        tr_term = jnp.sum(LiW * LiW)
    lp = -(nu + d + 1) / 2 * logdet_cov - 0.5 * tr_term
    # cov_matrix Cholesky-log-diag Jacobian (constants dropped)
    lp = lp + jnp.sum(
        (d - jnp.arange(d, dtype=dtype) + 1) * log_diag
    )  # (d - i + 2) for i = 1..d

    mu_c = mu - (0.0 if mu_0 is None else mu_0.astype(dtype))
    wmu = jax.scipy.linalg.solve_triangular(L, mu_c, lower=True)
    lp = lp - 0.5 * logdet_cov - 0.5 * cfg.beta_0 * jnp.sum(wmu * wmu)

    resid = jax.scipy.linalg.solve_triangular(
        L, (feats - mu).T, lower=True
    )
    lp = lp - 0.5 * rows * logdet_cov - 0.5 * jnp.sum(resid * resid)
    return lp


def log_posterior(
    q: jax.Array,
    problem: Problem,
    mean_rating,
    cfg: HMCConfig,
    shapes: ParamShapes,
    w0_chol: Optional[jax.Array] = None,
    mu_0: Optional[jax.Array] = None,
    nu_0: Optional[float] = None,
) -> jax.Array:
    if w0_chol is None and cfg.model == "bpmf":
        # general-model path with the reference's w_0 = I data
        w0_chol = jnp.eye(shapes.d, dtype=q.dtype)
    p = unpack(q, shapes)
    if cfg.model == "straightforward":
        # same unconstrained dimension; blocks reinterpreted (mu directly,
        # chol(cov) log-diag / strict-lower)
        lp = _prior_logp_half_straightforward(
            p["U"], p["mu_u_std"], p["log_c_u"], p["z_u"], cfg, shapes.d,
            w0_chol=w0_chol, mu_0=mu_0, nu_0=nu_0,
        )
        lp = lp + _prior_logp_half_straightforward(
            p["V"], p["mu_v_std"], p["log_c_v"], p["z_v"], cfg, shapes.d,
            w0_chol=w0_chol, mu_0=mu_0, nu_0=nu_0,
        )
        pred = p["U"] @ p["V"].T
        r = problem.R_obs - (mean_rating if cfg.subtract_mean else 0.0)
        err = jnp.where(problem.rated, r - pred, 0.0)
        return lp - 0.5 * jnp.sum(err * err) / cfg.rating_std**2
    lp = _prior_logp_half(
        p["U"], p["mu_u_std"], p["log_c_u"], p["z_u"], cfg, shapes.d,
        w0_chol=w0_chol, mu_0=mu_0, nu_0=nu_0,
    )
    lp = lp + _prior_logp_half(
        p["V"], p["mu_v_std"], p["log_c_v"], p["z_v"], cfg, shapes.d,
        w0_chol=w0_chol, mu_0=mu_0, nu_0=nu_0,
    )
    pred = p["U"] @ p["V"].T
    r = problem.R_obs - (mean_rating if cfg.subtract_mean else 0.0)
    err = jnp.where(problem.rated, r - pred, 0.0)
    lp = lp - 0.5 * jnp.sum(err * err) / cfg.rating_std**2
    return lp


@pytree_dataclass
class BPMFState:
    """Carries the sampled-mode warm start (stan-bpmf/bpmf.py:218-220).

    adapt_eps / adapt_inv_mass optionally carry NUTS adaptation (step-size
    anchor + diagonal inverse mass) between active steps — populated only
    by ``samples(..., carry_adapt=True)``; a zero-size adapt_inv_mass means
    "no carried adaptation" (the shape is a static jit signal). The
    reference re-runs full Stan warmup each step; carrying the metric is a
    deliberate extension (PARITY.md)."""

    mode_q: jax.Array  # best-lp flat parameter vector seen so far
    mode_lp: jax.Array
    mean_rating: jax.Array
    adapt_eps: jax.Array
    adapt_inv_mass: jax.Array


def init_state(
    problem: Problem, cfg: HMCConfig,
    U: Optional[jax.Array] = None, V: Optional[jax.Array] = None,
    dtype=jnp.float32,
) -> BPMFState:
    n, m = problem.shape
    s = ParamShapes(n, m, cfg.latent_d)
    q0 = pack(init_params(s, dtype, U=U, V=V))
    return BPMFState(
        mode_q=q0,
        mode_lp=jnp.asarray(-jnp.inf, dtype),
        mean_rating=problem.mean_rating().astype(dtype),
        adapt_eps=jnp.zeros((), dtype),
        adapt_inv_mass=jnp.zeros((0,), dtype),
    )


def invalidate_mode(state: BPMFState, problem: Problem) -> BPMFState:
    """After new ratings the stored lp is stale (stan-bpmf/bpmf.py:270-272)."""
    return state.replace(
        mode_lp=jnp.asarray(-jnp.inf, state.mode_lp.dtype),
        mean_rating=problem.mean_rating().astype(state.mean_rating.dtype),
    )


def samples(
    key: jax.Array,
    state: BPMFState,
    problem: Problem,
    cfg: HMCConfig,
    num_samps: int,
    warmup: Optional[int] = None,
    chains: int = 1,
    chain_mesh=None,  # jax.sharding.Mesh: shard the chain axis over devices
    carry_adapt: bool = False,
    warm_warmup: Optional[int] = None,
) -> Tuple[BPMFState, Dict[str, jax.Array]]:
    """Run NUTS for num_samps draws after warmup (default num_samps // 2,
    stan-bpmf/bpmf.py:310-311), starting at the sampled mode; update the mode
    from the best-lp draw. Returns (state, {'U','V','lp__'}).

    chains > 1 vmaps independent chains (num_samps draws each, pooled) — the
    device-parallel replacement for the reference's process-parallel Stan chains
    (stan-bpmf/bpmf.py:314); warmup runs per chain. chain_mesh additionally
    shards the chain axis over a device mesh (parallel.sharding
    .sharded_chain_map) — identical draws to the vmapped path, since
    per-chain streams come from the explicit keys.

    If the state carries adaptation (adapt_inv_mass non-empty — stored by a
    previous carry_adapt=True call), the chain warm-starts from that metric
    and eps anchor: the reasonable-eps search is skipped and warmup drops
    to ``warm_warmup`` (if given). carry_adapt stores this run's final
    adaptation on the returned state (per-chain when chains > 1). The
    reference re-runs full warmup per active step; see PARITY.md.
    """
    if warmup is None:
        warmup = num_samps // 2
    n, m = problem.shape
    shapes = ParamShapes(n, m, cfg.latent_d)

    warm = state.adapt_inv_mass.size > 0  # static: shape-based jit signal
    if warm and warm_warmup is not None:
        warmup = warm_warmup

    def logp(q):
        return log_posterior(q, problem, state.mean_rating, cfg, shapes)

    def run_one(k, eps_anchor=None, init_inv_mass=None):
        return nuts.run_nuts(
            k, state.mode_q, logp, num_samps, warmup,
            cfg=nuts.NUTSConfig(max_depth=cfg.max_depth),
            eps_anchor=eps_anchor, init_inv_mass=init_inv_mass,
            return_adaptation=True,
        )

    adapt = None
    if chains > 1:
        keys = jax.random.split(key, chains)
        # the carried metric broadcasts to every chain via the closure
        # (chains target the same posterior), so the warm path composes
        # with both vmap and the sharded chain map
        f = ((lambda k: run_one(k, state.adapt_eps, state.adapt_inv_mass))
             if warm else run_one)
        if chain_mesh is not None:
            from amf_tpu.parallel.sharding import sharded_chain_map

            qs, info, adapt = sharded_chain_map(f, chain_mesh)(keys)
        else:
            qs, info, adapt = jax.vmap(f)(keys)
        # pool a single carried metric: the mean adapted state across
        # chains (they target the same posterior)
        adapt = {"eps": jnp.mean(adapt["eps"]),
                 "inv_mass": jnp.mean(adapt["inv_mass"], axis=0)}
        qs = qs.reshape(chains * num_samps, -1)
        info = jax.tree.map(lambda x: x.reshape(chains * num_samps), info)
        num_samps = chains * num_samps
    else:
        qs, info, adapt = run_one(
            key,
            eps_anchor=state.adapt_eps if warm else None,
            init_inv_mass=state.adapt_inv_mass if warm else None,
        )
    lps = info.logprob
    best = jnp.argmax(lps)
    better = lps[best] > state.mode_lp
    new_state = state.replace(
        mode_q=jnp.where(better, qs[best], state.mode_q),
        mode_lp=jnp.where(better, lps[best], state.mode_lp),
    )
    if carry_adapt:
        new_state = new_state.replace(
            adapt_eps=adapt["eps"].astype(state.mode_q.dtype),
            adapt_inv_mass=adapt["inv_mass"].astype(state.mode_q.dtype),
        )
    nd = n * cfg.latent_d
    U_s = qs[:, :nd].reshape(num_samps, n, cfg.latent_d)
    V_s = qs[:, nd : nd + m * cfg.latent_d].reshape(num_samps, m, cfg.latent_d)
    return new_state, {"U": U_s, "V": V_s, "lp__": lps}


# ---------------------------------------------------------------------------
# Lookahead criteria (reference: stan-bpmf/bpmf.py:392-418, 483-521)


def lookahead_scores(
    key: jax.Array,
    state: BPMFState,
    problem: Problem,
    cfg: HMCConfig,
    base_stats,
    rating_values: Tuple[float, ...],
    stat: str = "total-variance",  # or 'entropy-est'
    num_samps: int = 30,
    warmup: int = 15,
    cand: Optional[jax.Array] = None,
    dirichlet_alpha: float = 0.1,
    n_base_samples: int = 128,
    candidate_tile: int = 0,
    num_integration_pts: int = 50,
) -> jax.Array:
    """exp-variance / exp-entropy-est: per (candidate, value) a fresh short
    NUTS run from the sampled mode, statistic integrated under the per-cell
    marginals — Dirichlet-smoothed histograms for discrete rating values
    (stan-bpmf/bpmf.py:436-443), or a fitted normal integrated by trapezoid
    over ``num_integration_pts`` ppf points for continuous data (:450-453,
    :505-510). With pts = mu + sigma z the trapezoid weights
    trapz(evals * pdf(pts), pts) reduce to candidate-independent
    c_k * phi(z_k) on the standard-normal quantile grid, so only the
    evaluation points vary per candidate.

    candidate_tile bounds peak memory by chunking the vmapped candidate
    fan-out through lax.map (each lane carries its own problem copy and NUTS
    chain state; at reference scale the untiled fan-out cannot fit)."""
    from amf_tpu.models import sample_stats

    n, m = problem.shape
    if cand is None:
        cand = jnp.arange(n * m, dtype=jnp.int32)
    dtype = state.mode_q.dtype
    ii, jj = cand // m, cand % m

    if rating_values and base_stats.bin_counts is None:
        raise ValueError(
            "rating_values given but base_stats has no bin_counts — compute "
            "the base stats with value_bounds for the discrete lookahead"
        )
    if rating_values:
        values = jnp.asarray(sorted(rating_values), dtype=dtype)
        n_vals = values.shape[0]
        counts = base_stats.bin_counts
        denom = n_base_samples + dirichlet_alpha * n_vals
        weights_full = (counts + dirichlet_alpha) / denom
        w_c = weights_full[:, ii, jj].T  # (C, K)
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
        st2 = invalidate_mode(state, prob2)
        # lanes adapt cold even when the loop state carries adaptation:
        # the base chain's eps anchor is tuned for long exploration and
        # measurably mistunes the short per-lane chains (slower trees,
        # worse picks — scripts/probe_warm_adapt.py negative result)
        st2 = st2.replace(
            adapt_eps=jnp.zeros((), dtype),
            adapt_inv_mass=jnp.zeros((0,), dtype),
        )
        st2, samps = samples(k, st2, prob2, cfg, num_samps, warmup)
        if stat == "entropy-est":
            return sample_stats.entropy_est_from_factors(
                samps["U"], samps["V"], st2.mean_rating, cfg.subtract_mean
            )
        stats = sample_stats.prediction_stats(
            samps["U"], samps["V"], st2.mean_rating, cfg.subtract_mean
        )
        return jnp.sum(stats.var)

    keys = lane_keys(key, cand, n_vals)  # shard/tile-invariant streams
    eval_tile = jax.vmap(
        lambda i, j, vs, ks: jax.vmap(
            lambda v, k: eval_one(i, j, v, k))(vs, ks)
    )
    c_total = cand.shape[0]
    if candidate_tile and c_total > candidate_tile:
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
        evals = eval_tile(ii, jj, vals_c, keys)
    scores = jnp.sum(evals * w_c, axis=-1)
    return jnp.where(problem.queryable[ii, jj], scores, jnp.nan)
