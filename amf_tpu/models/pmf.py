"""MAP Probabilistic Matrix Factorization.

Capability parity with the reference's ``ProbabilisticMatrixFactorization``
(python-pmf/pmf.py:22-335 and its Cython twin pmf_cy.pyx:34-291): Gaussian
likelihood with Gaussian priors on U and V, adaptive-learning-rate batch
gradient ascent (``fit_lls``), an SGD minibatch variant with momentum and
validation-based early stopping, and type-II ML updates of the noise/prior
variances (``update_sigma``/``update_sigma_uv``).

Architecture differences (deliberate, accelerator-first):
  * the ratings list + Python loop over nnz in ``gradient`` (pmf.py:132-149)
    becomes one dense masked matmul pair covering the whole nnz sweep;
  * the generator-based ``fit_lls`` becomes ``ops.adaptive_descent``
    (a ``lax.while_loop``), preserving its accept/reject trajectory;
  * state is an immutable pytree so lookahead can ``vmap`` over hypothesized
    ratings instead of deepcopying models (active_pmf.py:668-676).

Note: the reference's pure-python ``update_sigma_uv`` computes ``item_norm2``
from ``self.users`` (a copy/paste bug, pmf.py:165); we follow the corrected
Cython behavior (pmf_cy.pyx:243).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from amf_tpu.ops.linesearch import (
    DescentInfo, adaptive_descent, adaptive_descent_poly,
)
from amf_tpu.types import Problem, pytree_dataclass


class PMFConfig(NamedTuple):
    """Static hyperparameters (reference defaults: pmf.py:26-41)."""

    latent_d: int = 1
    subtract_mean: bool = False
    learning_rate: float = 1e-4
    min_learning_rate: float = 1e-10
    stop_thresh: float = 1e-2
    max_fit_steps: int = 2000
    # negative variance = no hyperprior on log sigma_{u,v}^2 (pmf.py:37-41)
    sig_u_mean: float = 0.0
    sig_u_var: float = -1.0
    sig_v_mean: float = 0.0
    sig_v_var: float = -1.0


@pytree_dataclass
class PMFState:
    U: jax.Array  # (n, d)
    V: jax.Array  # (m, d)
    sigma_sq: jax.Array
    sigma_u_sq: jax.Array
    sigma_v_sq: jax.Array
    mean_rating: jax.Array


def init_state(
    key: jax.Array, n: int, m: int, cfg: PMFConfig, problem: Optional[Problem] = None,
    dtype=jnp.float32,
) -> PMFState:
    """Uniform(0,1) factor init (reference: pmf.py:55-56), explicit PRNG."""
    ku, kv = jax.random.split(key)
    mean_rating = problem.mean_rating() if problem is not None else jnp.zeros((), dtype)
    return PMFState(
        U=jax.random.uniform(ku, (n, cfg.latent_d), dtype=dtype),
        V=jax.random.uniform(kv, (m, cfg.latent_d), dtype=dtype),
        sigma_sq=jnp.ones((), dtype),
        sigma_u_sq=jnp.asarray(10.0, dtype),
        sigma_v_sq=jnp.asarray(10.0, dtype),
        mean_rating=jnp.asarray(mean_rating, dtype),
    )


def refresh_mean_rating(state: PMFState, problem: Problem) -> PMFState:
    """Recompute the observed-mean after mask changes (pmf.py:90)."""
    return state.replace(mean_rating=problem.mean_rating().astype(state.U.dtype))


def predicted_matrix(state: PMFState, cfg: PMFConfig) -> jax.Array:
    pred = state.U @ state.V.T
    if cfg.subtract_mean:
        pred = pred + state.mean_rating
    return pred


def log_likelihood(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    U: Optional[jax.Array] = None, V: Optional[jax.Array] = None,
) -> jax.Array:
    """Unnormalized log posterior (reference: pmf.py:104-121)."""
    U = state.U if U is None else U
    V = state.V if V is None else V
    pred = U @ V.T
    if cfg.subtract_mean:
        pred = pred + state.mean_rating
    err = jnp.where(problem.rated, problem.R_obs - pred, 0.0)
    sq_error = jnp.sum(err * err)
    return (
        -sq_error / (2 * state.sigma_sq)
        - jnp.sum(U * U) / (2 * state.sigma_u_sq)
        - jnp.sum(V * V) / (2 * state.sigma_v_sq)
    )


def ll_prior_adjustment(state: PMFState, problem: Problem, cfg: PMFConfig) -> jax.Array:
    """Variance-dependent normalization terms (reference: pmf.py:123-127)."""
    n, m = problem.shape
    d = cfg.latent_d
    return -0.5 * (
        jnp.log(state.sigma_sq) * problem.n_rated
        + n * d * jnp.log(state.sigma_u_sq)
        + m * d * jnp.log(state.sigma_v_sq)
    )


def gradient(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    U: Optional[jax.Array] = None, V: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Closed-form ascent gradient; one masked residual + two matmuls
    replace the reference's Python loop over ratings (pmf.py:132-149)."""
    U = state.U if U is None else U
    V = state.V if V is None else V
    pred = U @ V.T
    if cfg.subtract_mean:
        pred = pred + state.mean_rating
    resid = jnp.where(problem.rated, problem.R_obs - pred, 0.0) / state.sigma_sq
    grad_u = resid @ V - U / state.sigma_u_sq
    grad_v = resid.T @ U - V / state.sigma_v_sq
    return grad_u, grad_v


def _delta_poly(state, problem, cfg, uv, g):
    """Exact improvement quartic along the ascent ray (poly line search).

    The neg-log-posterior at ``(U + a*gu, V + a*gv)`` is a quartic in ``a``
    because pred' = pred + a*P1 + a^2*P2 with P1 = gu V^T + U gv^T,
    P2 = gu gv^T.  Returns (c1..c4) of the IMPROVEMENT polynomial
    ``delta(a) = f(0) - f(a)`` — built from masked cross-reductions directly,
    so no big-value cancellation enters the accept/reject decision.
    """
    U, V = uv
    gu, gv = g
    pred = U @ V.T
    if cfg.subtract_mean:
        pred = pred + state.mean_rating
    E = jnp.where(problem.rated, problem.R_obs - pred, 0.0)
    P1 = gu @ V.T + U @ gv.T
    P2 = gu @ gv.T
    mp1 = jnp.where(problem.rated, P1, 0.0)
    mp2 = jnp.where(problem.rated, P2, 0.0)
    a2 = jnp.vdot(E, mp2)
    a11 = jnp.vdot(mp1, mp1)
    a12 = jnp.vdot(mp1, mp2)
    a22 = jnp.vdot(mp2, mp2)
    s = state.sigma_sq
    b2 = 0.5 * (
        jnp.vdot(gu, gu) / state.sigma_u_sq
        + jnp.vdot(gv, gv) / state.sigma_v_sq
    )
    # c1 = a1/s - <U,gu>/su - <V,gv>/sv algebraically, but that difference of
    # large reductions IS the squared gradient norm (catastrophic cancellation
    # near convergence) — use the exact identity instead.
    c1 = jnp.vdot(gu, gu) + jnp.vdot(gv, gv)
    c2 = -(a11 - 2.0 * a2) / (2.0 * s) - b2
    c3 = -a12 / s
    c4 = -a22 / (2.0 * s)
    return c1, c2, c3, c4


def fit(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    max_steps: Optional[int] = None,
    poly_ls: bool = False,
) -> Tuple[PMFState, DescentInfo]:
    """Batch MAP fit — the reference's ``fit_lls`` adaptive-LR ascent
    (pmf.py:179-211) as a single compiled while-loop.

    Matches the reference trajectory: gradient recomputed only on accepted
    steps; lr grows 1.25x on accept, halves on reject; stops when an accepted
    step improves by < stop_thresh or lr < min_learning_rate.

    ``poly_ls=True`` switches to the polynomial-in-alpha epoch loop
    (ops.linesearch.adaptive_descent_poly): rejected learning rates are
    adjudicated by an exact scalar quartic instead of full value passes —
    same trajectory up to f32 near-ties (scoring-grade; used by the
    lookahead refit fan-outs where the reject-heavy ladder dominates).
    """
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps

    def value_fn(uv):
        return -log_likelihood(state, problem, cfg, U=uv[0], V=uv[1])

    def value_and_grad_fn(uv):
        # one fused pass: the forward residual is reused by the backward
        # matmuls (vs the reference's separate log_likelihood + gradient)
        f, (gu, gv) = jax.value_and_grad(value_fn)(uv)
        return f, (-gu, -gv)  # ascent direction, matching gradient()

    def step_fn(uv, g, lr):
        return (uv[0] + lr * g[0], uv[1] + lr * g[1])

    if poly_ls:
        (U, V), info = adaptive_descent_poly(
            (state.U, state.V),
            value_and_grad_fn,
            step_fn,
            lambda uv, g: _delta_poly(state, problem, cfg, uv, g),
            lr0=cfg.learning_rate,
            stop_thresh=cfg.stop_thresh,
            min_lr=cfg.min_learning_rate,
            max_steps=max_steps,
        )
        return state.replace(U=U, V=V), info

    (U, V), info = adaptive_descent(
        (state.U, state.V),
        value_fn,
        None,
        step_fn,
        lr0=cfg.learning_rate,
        stop_thresh=cfg.stop_thresh,
        min_lr=cfg.min_learning_rate,
        max_steps=max_steps,
        value_and_grad_fn=value_and_grad_fn,
    )
    return state.replace(U=U, V=V), info


def fit_lbfgs(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    max_iters: int = 500,
) -> PMFState:
    """MAP fit via (unconstrained) L-BFGS — the faster alternative to the
    reference's adaptive-LR ascent for large problems (SURVEY.md §7 build
    plan). Same optimum, different trajectory; use fit() for parity runs.
    """
    from amf_tpu.ops.lbfgsb import lbfgsb

    n, m = problem.shape
    d = cfg.latent_d
    x0 = jnp.concatenate([state.U.reshape(-1), state.V.reshape(-1)])

    def neg_ll(x):
        U = x[: n * d].reshape(n, d)
        V = x[n * d :].reshape(m, d)
        return -log_likelihood(state, problem, cfg, U=U, V=V)

    res = lbfgsb(
        jax.value_and_grad(neg_ll), x0,
        -jnp.inf, jnp.inf, max_iters=max_iters, pgtol=1e-8,
    )
    return state.replace(
        U=res.x[: n * d].reshape(n, d), V=res.x[n * d :].reshape(m, d)
    )


def update_sigma(state: PMFState, problem: Problem, cfg: PMFConfig) -> PMFState:
    """Type-II ML noise-variance update (reference: pmf.py:151-157)."""
    pred = predicted_matrix(state, cfg)
    err = jnp.where(problem.rated, problem.R_obs - pred, 0.0)
    n_rated = jnp.maximum(problem.n_rated, 1)
    return state.replace(sigma_sq=jnp.sum(err * err) / n_rated)


def update_sigma_uv(state: PMFState, problem: Problem, cfg: PMFConfig) -> PMFState:
    """Prior-variance updates (reference: pmf.py:159-177, corrected per
    pmf_cy.pyx:243)."""
    n, m = problem.shape
    d = cfg.latent_d
    user_norm2 = jnp.sum(state.U * state.U)
    item_norm2 = jnp.sum(state.V * state.V)

    if cfg.sig_u_var > 0:
        denom_u = n * d + 2 + 2 * (
            jnp.log(state.sigma_u_sq) - cfg.sig_u_mean
        ) / cfg.sig_u_var
        sigma_u_sq = user_norm2 / denom_u
    else:
        sigma_u_sq = user_norm2 / (n * d)

    if cfg.sig_v_var > 0:
        denom_v = m * d + 2 + 2 * (
            jnp.log(state.sigma_v_sq) - cfg.sig_v_mean
        ) / cfg.sig_v_var
        sigma_v_sq = item_norm2 / denom_v
    else:
        sigma_v_sq = item_norm2 / (m * d)

    return state.replace(sigma_u_sq=sigma_u_sq, sigma_v_sq=sigma_v_sq)


def fit_with_sigmas(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    max_outer: int = 25, max_steps: Optional[int] = None,
) -> PMFState:
    """Alternate factor fitting with sigma updates until the joint fit stops
    improving.

    The reference interleaves sigma updates every few accepted steps inside
    the running generator (pmf.py:286-305); we alternate full inner fits with
    sigma updates — same type-II ML fixed point, compiler-friendly loop.
    """
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps

    def body(carry):
        st, _, outer = carry
        st, info = fit(st, problem, cfg, max_steps=max_steps)
        st = update_sigma(st, problem, cfg)
        st = update_sigma_uv(st, problem, cfg)
        return st, info.n_accepts, outer + 1

    def cond(carry):
        _, n_accepts, outer = carry
        return jnp.logical_and(n_accepts > 1, outer < max_outer)

    init = (state, jnp.int32(2 ** 30), jnp.int32(0))
    st, _, _ = jax.lax.while_loop(cond, body, init)
    return st


# ---------------------------------------------------------------------------
# Batched lookahead refits (the hot path of one-step lookahead scoring)


def batched_value_grad(U, V, R, rated, delta_i, delta_j, delta_v, sigmas):
    """Per-lane neg-log-posterior and ascent gradient with one hypothesized
    rating (delta_i, delta_j, delta_v) added to the shared (R, rated).

    U (L, n, d), V (L, m, d); sigmas = (sigma_sq, sigma_u_sq, sigma_v_sq).
    Returns (neg_ll (L,), gu (L, n, d), gv (L, m, d)).
    """
    sigma_sq, sigma_u_sq, sigma_v_sq = sigmas[0], sigmas[1], sigmas[2]

    def one(u, v, di, dj, dv):
        mask = rated.astype(u.dtype).at[di, dj].set(1.0)
        rv = R.astype(u.dtype).at[di, dj].set(dv)
        pred = u @ v.T
        resid = mask * (rv - pred)
        neg_ll = (
            jnp.sum(resid * resid) / (2 * sigma_sq)
            + jnp.sum(u * u) / (2 * sigma_u_sq)
            + jnp.sum(v * v) / (2 * sigma_v_sq)
        )
        gu = resid @ v / sigma_sq - u / sigma_u_sq
        gv = resid.T @ u / sigma_sq - v / sigma_v_sq
        return neg_ll, gu, gv

    return jax.vmap(one)(U, V, delta_i, delta_j, delta_v)


def fit_lookahead_batch(
    state: PMFState,
    problem: Problem,
    delta_i: jax.Array,  # (L,) candidate rows
    delta_j: jax.Array,  # (L,) candidate cols
    delta_v: jax.Array,  # (L,) hypothesized values
    cfg: PMFConfig,
    max_steps: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Refit the MAP factors for L hypothesized (i, j, v) ratings at once.

    Same adaptive-LR accept/reject semantics as ``fit``, vectorized over
    lanes: every lane starts from ``state`` and sees the shared R/mask plus
    its own added rating.

    Returns (U (L, n, d), V (L, m, d), neg_ll (L,)).
    Note: assumes subtract_mean=False (the ActivePMF setting).
    """
    L = delta_i.shape[0]
    n, m = problem.shape
    sigmas = jnp.stack(
        [state.sigma_sq, state.sigma_u_sq, state.sigma_v_sq]
    ).astype(jnp.float32)

    def value_grad(U, V):
        return batched_value_grad(U, V, problem.R_obs, problem.rated,
                                  delta_i, delta_j, delta_v, sigmas)

    U0 = jnp.broadcast_to(state.U[None], (L, n, cfg.latent_d)).astype(jnp.float32)
    V0 = jnp.broadcast_to(state.V[None], (L, m, cfg.latent_d)).astype(jnp.float32)
    f0, gu0, gv0 = value_grad(U0, V0)
    lr0 = jnp.full((L,), cfg.learning_rate, jnp.float32)
    done0 = jnp.zeros((L,), bool)

    def cond(c):
        *_, done, it = c
        return jnp.any(~done) & (it < max_steps)

    def body(c):
        U, V, gu, gv, lr, f, done, it = c
        Up = U + lr[:, None, None] * gu
        Vp = V + lr[:, None, None] * gv
        fp, gup, gvp = value_grad(Up, Vp)
        accept = jnp.isfinite(fp) & (fp < f) & ~done
        reject = ~accept & ~done
        conv = jnp.where(
            accept, (f - fp) < cfg.stop_thresh,
            lr * 0.5 < cfg.min_learning_rate,
        )
        sel = lambda a, b: jnp.where(accept[:, None, None], a, b)
        U = sel(Up, U)
        V = sel(Vp, V)
        gu = sel(gup, gu)
        gv = sel(gvp, gv)
        lr = jnp.where(accept, lr * 1.25, jnp.where(reject, lr * 0.5, lr))
        f = jnp.where(accept, fp, f)
        done = done | ((accept | reject) & conv)
        return U, V, gu, gv, lr, f, done, it + 1

    U, V, _, _, _, f, _, _ = jax.lax.while_loop(
        cond, body, (U0, V0, gu0, gv0, lr0, f0, done0, jnp.int32(0))
    )
    return U, V, f


# ---------------------------------------------------------------------------
# Minibatch SGD path (reference: fit_minibatches* pmf.py:226-284)


def _coo_gradient(state, cfg, ii, jj, rr, valid):
    """Ascent gradient over a gathered COO minibatch (scatter-add form)."""
    u_rows = state.U[ii]  # (b, d)
    v_rows = state.V[jj]
    pred = jnp.sum(u_rows * v_rows, axis=1)
    if cfg.subtract_mean:
        pred = pred + state.mean_rating
    resid = jnp.where(valid, (rr - pred) / state.sigma_sq, 0.0)
    grad_u = jnp.zeros_like(state.U).at[ii].add(resid[:, None] * v_rows)
    grad_v = jnp.zeros_like(state.V).at[jj].add(resid[:, None] * u_rows)
    grad_u = grad_u - state.U / state.sigma_u_sq
    grad_v = grad_v - state.V / state.sigma_v_sq
    return grad_u, grad_v


def fit_minibatches_until_validation(
    state: PMFState,
    problem: Problem,
    cfg: PMFConfig,
    key: jax.Array,
    batch_size: int,
    valid_size: int,
    lr: float = 1.0,
    momentum: float = 0.8,
    stop_thresh: float = 1e-3,
    max_epochs: int = 500,
) -> PMFState:
    """Momentum SGD over shuffled rating minibatches with validation-based
    early stopping (reference: pmf.py:226-284, fit type 'mini-valid').

    The epoch loop is one compiled while-loop over a padded flat-cell
    permutation (capacity = all cells; non-training cells masked out). The
    validation subset is drawn host-side — this entry point is CLI-level, not
    used inside the vmapped lookahead.  Each epoch reshuffles with the carried
    PRNG key (the reference shuffles with global RNG, pmf.py:239).
    """
    import numpy as np

    n, m = problem.shape
    cap = n * m
    flat_rated = np.asarray(problem.rated).ravel()
    rated_idx = np.nonzero(flat_rated)[0]

    kv, key = jax.random.split(key)
    host_rng = np.random.default_rng(
        np.asarray(jax.random.key_data(kv)).ravel()[-1]
    )
    valid_idx = jnp.asarray(
        host_rng.choice(rated_idx, size=min(valid_size, rated_idx.size), replace=False)
    )
    valid_i, valid_j = valid_idx // m, valid_idx % m
    valid_r = problem.R_obs.ravel()[valid_idx]

    is_valid_cell = jnp.zeros((cap,), bool).at[valid_idx].set(True)
    train_mask_flat = jnp.asarray(flat_rated) & ~is_valid_cell
    r_flat = problem.R_obs.ravel()

    n_batches = (cap + batch_size - 1) // batch_size
    pad = n_batches * batch_size - cap

    def epoch(carry):
        st, u_inc, v_inc, key, last_valid, epoch_i, done = carry
        key, kshuf = jax.random.split(key)
        perm = jax.random.permutation(kshuf, cap)
        perm = jnp.concatenate([perm, perm[:pad]]) if pad else perm

        def batch_step(b, inner):
            st, u_inc, v_inc = inner
            sel = jax.lax.dynamic_slice(perm, (b * batch_size,), (batch_size,))
            valid = train_mask_flat[sel]
            cnt = jnp.maximum(jnp.sum(valid), 1)
            gu, gv = _coo_gradient(
                st, cfg, sel // m, sel % m, r_flat[sel], valid
            )
            u_inc = u_inc * momentum + gu * (lr / cnt)
            v_inc = v_inc * momentum + gv * (lr / cnt)
            st = st.replace(U=st.U + u_inc, V=st.V + v_inc)
            return st, u_inc, v_inc

        st, u_inc, v_inc = jax.lax.fori_loop(
            0, n_batches, batch_step, (st, u_inc, v_inc)
        )
        pred_valid = jnp.sum(st.U[valid_i] * st.V[valid_j], axis=1)
        if cfg.subtract_mean:
            pred_valid = pred_valid + st.mean_rating
        valid_err = jnp.sqrt(jnp.mean((pred_valid - valid_r) ** 2))
        done = valid_err > last_valid - stop_thresh
        return st, u_inc, v_inc, key, valid_err, epoch_i + 1, done

    def cond(carry):
        *_, epoch_i, done = carry
        return jnp.logical_and(~done, epoch_i < max_epochs)

    init = (
        state,
        jnp.zeros_like(state.U),
        jnp.zeros_like(state.V),
        key,
        jnp.asarray(jnp.inf, state.U.dtype),
        jnp.int32(0),
        jnp.asarray(False),
    )
    st, *_ = jax.lax.while_loop(cond, epoch, init)
    return st


def parse_fit_type(string: str) -> tuple:
    """Parse the reference's fit-type mini-DSL, e.g. 'mini-valid,100,50'
    (reference: pmf.py:338-350)."""
    parts = string.split(",")
    res = []
    for x in parts:
        for fn in (int, float):
            try:
                res.append(fn(x))
                break
            except ValueError:
                pass
        else:
            res.append(x)
    return tuple(res)


def do_fit(
    state: PMFState,
    problem: Problem,
    cfg: PMFConfig,
    fit_type: tuple = ("batch",),
    key: Optional[jax.Array] = None,
) -> PMFState:
    """Dispatch on fit type (reference: pmf.py:217-224)."""
    kind, *args = fit_type
    if kind == "batch":
        return fit(state, problem, cfg)[0]
    if kind == "lbfgs":
        return fit_lbfgs(state, problem, cfg, *args)
    if kind == "mini-valid":
        if key is None:
            key = jax.random.PRNGKey(0)
        return fit_minibatches_until_validation(state, problem, cfg, key, *args)
    raise ValueError(f"unknown fit type {kind!r}")


def rmse(state: PMFState, problem: Problem, cfg: PMFConfig, real, on=None):
    from amf_tpu.analysis import metrics

    pred = predicted_matrix(state, cfg)
    if on is None:
        return metrics.rmse(pred, real)
    return metrics.rmse_on(pred, real, on)
