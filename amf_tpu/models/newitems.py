"""Cold-start ("new items") BPMF variant.

Capability parity with the reference's ``NewItemsBPMF``
(stan-bpmf/bpmf_newitems.py:12-138 + bpmf_newitems_w0identity.stan): a
two-phase scheme —
  phase 1: full BPMF fit on the old-item submatrix; posterior-mean factors
           Ubar (users) and Vbar_fixed (old items) become data;
  phase 2: only the new-item columns' factors V_new (plus the item
           hyperprior) are sampled, with V_fixed informing the hyperprior and
           the likelihood restricted to observed new-item cells; the active
           loop queries new-item cells only.

The reference remaps column indices into the new-item submatrix
(``jigger_ratings``, bpmf_newitems.py:41-45); here the phase-2 problem is the
dense (n, m_new) submatrix with masks, so no index jiggling is needed.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from amf_tpu.mcmc import nuts
from amf_tpu.models.bpmf_hmc import HMCConfig, _prior_logp_half
from amf_tpu.types import Problem, pytree_dataclass


class NewItemsShapes(NamedTuple):
    n: int
    m_new: int
    d: int

    @property
    def n_tri(self) -> int:
        return max(self.d * (self.d - 1) // 2, 1)

    @property
    def dim(self) -> int:
        return self.m_new * self.d + self.d + self.d + self.n_tri


def unpack(q: jax.Array, s: NewItemsShapes) -> Dict[str, jax.Array]:
    idx = 0

    def take(k):
        nonlocal idx
        out = q[idx : idx + k]
        idx += k
        return out

    return {
        "V_new": take(s.m_new * s.d).reshape(s.m_new, s.d),
        "mu_v_std": take(s.d),
        "log_c_v": take(s.d),
        "z_v": take(s.n_tri),
    }


def log_posterior(
    q: jax.Array,
    problem_new: Problem,  # (n, m_new) masked problem over new columns
    U_fixed: jax.Array,  # (n, d) posterior-mean users from phase 1
    V_fixed: jax.Array,  # (m_old, d) posterior-mean old items
    mean_rating,
    cfg: HMCConfig,
    s: NewItemsShapes,
) -> jax.Array:
    """bpmf_newitems_w0identity.stan: V_fixed and V_new share the sampled
    item hyperprior; likelihood over observed new-item cells only.
    cfg.model == 'bpmf' uses the general bpmf_newitems.stan construction
    (w_0 = I data — the only w_0 the reference passes)."""
    if cfg.model == "straightforward":
        raise ValueError(
            "the newitems model has no straightforward-parameterization "
            "variant (reference ships only bpmf_newitems[_w0identity].stan)"
        )
    p = unpack(q, s)
    feats = jnp.concatenate([V_fixed.astype(q.dtype), p["V_new"]], axis=0)
    w0_chol = jnp.eye(s.d, dtype=q.dtype) if cfg.model == "bpmf" else None
    lp = _prior_logp_half(
        feats, p["mu_v_std"], p["log_c_v"], p["z_v"], cfg, s.d,
        w0_chol=w0_chol,
    )
    pred = U_fixed.astype(q.dtype) @ p["V_new"].T
    r = problem_new.R_obs - (mean_rating if cfg.subtract_mean else 0.0)
    err = jnp.where(problem_new.rated, r - pred, 0.0)
    return lp - 0.5 * jnp.sum(err * err) / cfg.rating_std**2


@pytree_dataclass
class NewItemsState:
    mode_q: jax.Array
    mode_lp: jax.Array
    mean_rating: jax.Array
    U_fixed: jax.Array
    V_fixed: jax.Array


def init_state(
    problem_new: Problem,
    U_fixed: jax.Array,
    V_fixed: jax.Array,
    cfg: HMCConfig,
    mean_rating,
    dtype=jnp.float64,
) -> NewItemsState:
    m_new = problem_new.shape[1]
    s = NewItemsShapes(U_fixed.shape[0], m_new, cfg.latent_d)
    q0 = jnp.zeros(s.dim, dtype)
    return NewItemsState(
        mode_q=q0,
        mode_lp=jnp.asarray(-jnp.inf, dtype),
        mean_rating=jnp.asarray(mean_rating, dtype),
        U_fixed=U_fixed.astype(dtype),
        V_fixed=V_fixed.astype(dtype),
    )


def invalidate_mode(state: NewItemsState) -> NewItemsState:
    return state.replace(mode_lp=jnp.asarray(-jnp.inf, state.mode_lp.dtype))


def samples(
    key: jax.Array,
    state: NewItemsState,
    problem_new: Problem,
    cfg: HMCConfig,
    num_samps: int,
    warmup: Optional[int] = None,
) -> Tuple[NewItemsState, Dict[str, jax.Array]]:
    """NUTS over the phase-2 posterior; returns V_new draws.

    The returned dict carries 'U' broadcast to the sample axis so the shared
    sample_stats helpers apply unchanged."""
    if warmup is None:
        warmup = num_samps // 2
    n, m_new = problem_new.shape
    s = NewItemsShapes(n, m_new, cfg.latent_d)

    def logp(q):
        return log_posterior(
            q, problem_new, state.U_fixed, state.V_fixed,
            state.mean_rating, cfg, s,
        )

    qs, info = nuts.run_nuts(
        key, state.mode_q, logp, num_samps, warmup,
        cfg=nuts.NUTSConfig(max_depth=cfg.max_depth),
    )
    lps = info.logprob
    best = jnp.argmax(lps)
    better = lps[best] > state.mode_lp
    state = state.replace(
        mode_q=jnp.where(better, qs[best], state.mode_q),
        mode_lp=jnp.where(better, lps[best], state.mode_lp),
    )
    V_new = qs[:, : m_new * cfg.latent_d].reshape(num_samps, m_new, cfg.latent_d)
    U_b = jnp.broadcast_to(
        state.U_fixed[None], (num_samps, *state.U_fixed.shape)
    )
    return state, {"U": U_b, "V": V_new, "lp__": lps}


def initial_full_fit(
    key: jax.Array,
    problem: Problem,
    is_new_item: np.ndarray,
    cfg: HMCConfig,
    num_samps: int = 200,
    warmup: Optional[int] = None,
    dtype=jnp.float64,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Phase 1 (reference: do_initial_fit, bpmf_newitems.py:58-64): full BPMF
    on the old-item columns; returns (U_mean, V_fixed_mean, mean_rating).
    Cacheable by the caller (the reference's --initial-fit-file)."""
    from amf_tpu.models import bpmf_hmc

    is_new = np.asarray(is_new_item, dtype=bool)
    old_cols = np.nonzero(~is_new)[0]
    prob_old = Problem(
        R_obs=problem.R_obs[:, old_cols],
        rated=problem.rated[:, old_cols],
        queryable=problem.queryable[:, old_cols],
        test=problem.test[:, old_cols],
    )
    st = bpmf_hmc.init_state(prob_old, cfg, dtype=dtype)
    st, samps = bpmf_hmc.samples(key, st, prob_old, cfg, num_samps, warmup)
    return samps["U"].mean(0), samps["V"].mean(0), st.mean_rating


def lookahead_scores(
    key: jax.Array,
    state: NewItemsState,
    problem_new: Problem,
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
) -> jax.Array:
    """exp-variance / exp-entropy-est over the NEW-ITEM submatrix.

    The reference's cold-start MainProgram inherits the full lookahead KEYS
    registry (stan-bpmf/bpmf_newitems.py:48 reusing bpmf.py:544-556): per
    (candidate, value) a fresh short phase-2 NUTS run from the mode, the
    statistic integrated under the base chain's Dirichlet-smoothed per-cell
    marginals (bpmf.py:436-443, 483-521). Same engine shape as
    bpmf_hmc.lookahead_scores but sampling only V_new.
    """
    from amf_tpu.models import sample_stats
    from amf_tpu.utils.rng import lane_keys

    n, m_new = problem_new.shape
    if cand is None:
        cand = jnp.arange(n * m_new, dtype=jnp.int32)
    values = jnp.asarray(sorted(rating_values), dtype=state.mode_q.dtype)
    n_vals = values.shape[0]

    counts = base_stats.bin_counts
    denom = n_base_samples + dirichlet_alpha * n_vals
    weights_full = (counts + dirichlet_alpha) / denom
    ii, jj = cand // m_new, cand % m_new
    w_c = weights_full[:, ii, jj].T  # (C, V)

    def eval_one(i, j, v, k):
        prob2 = problem_new.add_rating(i, j, v)
        st2 = invalidate_mode(state)
        st2, samps = samples(k, st2, prob2, cfg, num_samps, warmup)
        if stat == "entropy-est":
            return sample_stats.entropy_est_from_factors(
                samps["U"], samps["V"], state.mean_rating, cfg.subtract_mean
            )
        stats = sample_stats.prediction_stats(
            samps["U"], samps["V"], state.mean_rating, cfg.subtract_mean
        )
        return jnp.sum(stats.var)

    keys = lane_keys(key, cand, n_vals)  # shard/tile-invariant streams
    eval_tile = jax.vmap(
        lambda i, j, ks: jax.vmap(lambda v, k: eval_one(i, j, v, k))(values, ks)
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
            (chunks(padded(ii)), chunks(padded(jj)), chunks(padded(keys))),
        ).reshape(c_total + pad, n_vals)[:c_total]
    else:
        evals = eval_tile(ii, jj, keys)  # (C, V)

    scores = jnp.sum(evals * w_c, axis=-1)
    return jnp.where(problem_new.queryable[ii, jj], scores, jnp.nan)
