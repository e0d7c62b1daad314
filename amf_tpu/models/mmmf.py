"""Max-Margin Matrix Factorization (MMMF).

Capability parity with the reference's MATLAB SDP path (mmmf/solveD.m:37-94 +
evaluate_active.m + select_*.m): soft-margin nuclear-norm MMMF on binary
labels. The reference solves the dual SDP with YALMIP/SeDuMi per active step
(an interior-point solve, with a C-jitter retry hack, solveD.m:70-79) and
extracts factors from the SVD of the dual matrix.

Accelerator-first replacement: the *primal* convex problem the SDP is dual to,

    min_X  ||X||_*  +  C * sum_{(i,j) observed} max(0, 1 - y_ij X_ij),

solved by ADMM with two closed-form proximal maps:
  * nuclear norm   -> singular-value soft-thresholding (one batched SVD);
  * hinge loss     -> an elementwise three-zone prox.
ADMM converges to the same global optimum as the interior-point SDP (both
solve the identical convex program), so margins match SeDuMi's to solver
tolerance — the BASELINE.md "equivalent margins" target — while every
iteration is dense matrix work for the accelerator's matmul units. Warm starts across
active-learning steps replace the reference's from-scratch re-solves.
Factors (xu, xv) come from the SVD of the learned X, matching the
reference's dual-matrix factor extraction (solveD.m:80-88) up to the usual
SVD sign/rotation ambiguity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from amf_tpu.types import pytree_dataclass

# Provenance tag stamped into experiment digests (analysis.parity.digest).
# "eigh-svt-v1" = the repaired ADMM solver (eigh-based SVT + cold-restart
# guard + adaptive rho); digests without the field predate the fix for the
# gesdd-NaN warm-start poisoning (PARITY.md adjudication 4).
SOLVER_ERA = "eigh-svt-v1"


class MMMFConfig(NamedTuple):
    C: float = 1.0  # slack penalty (reference default in evaluate_active.m)
    rho: float = 1.0  # initial ADMM penalty
    max_iters: int = 2000
    tol: float = 1e-6  # primal/dual residual tolerance (Frobenius, relative)
    # residual balancing (Boyd et al. 2011 §3.4.1): scale rho up/down by
    # rho_scale when one residual exceeds balance_mu x the other. Cuts the
    # iteration count severalfold on the active-loop re-solves, where the
    # fixed-rho iteration always hit the max_iters cap.
    adapt_rho: bool = True
    balance_mu: float = 10.0
    rho_scale: float = 2.0
    # over-relaxation (Boyd et al. 2011 §3.4.3). Measured NEGATIVE here on
    # the hard newmovies-20d solve (472x413, f32, with adaptive rho):
    # alpha=1.6 reaches obj 438.80 vs 438.55 at the same 2000-iter cap
    # (439.95 vs 439.18 at 500) and no change on toys — the residual
    # balancing already takes the slack. Default off; knob kept.
    over_relax: float = 1.0


@pytree_dataclass
class MMMFState:
    """ADMM variables, carried across active steps for warm starting."""

    X: jax.Array  # learned matrix (the reference's x)
    Z: jax.Array  # split variable
    W: jax.Array  # scaled dual


def init_state(n: int, m: int, dtype=jnp.float32) -> MMMFState:
    z = jnp.zeros((n, m), dtype)
    return MMMFState(X=z, Z=z, W=z)


def _svt(a: jax.Array, tau) -> jax.Array:
    """Singular-value soft-thresholding: prox of tau * ||.||_*.

    Computed from eigh of the small-side Gram rather than a full SVD:
    A = U S V^T gives A^T A = V S^2 V^T and svt(A) = A V diag(f) V^T with
    f = (s - tau)_+ / s. LAPACK's divide-and-conquer SVD (gesdd, what
    jnp.linalg.svd lowers to on CPU) intermittently fails to converge on
    warm-started ADMM iterates and emits NaN (observed as a poisoned chain +
    DLASCL 'illegal value' warnings on the newmovies-20d mmmf run); syevd on
    the symmetrized Gram is robust, and only singular values above tau
    matter, so the 1/s factor never divides by anything below tau. The
    squared condition number is harmless here: s >= tau = 1/rho is huge
    against eps * s_max^2 at these scales.
    """
    n, m = a.shape
    if m <= n:
        w, V = jnp.linalg.eigh(a.T @ a)
        s = jnp.sqrt(jnp.maximum(w, 0.0))
        f = jnp.where(s > tau, (s - tau) / jnp.maximum(s, tau), 0.0)
        return ((a @ V) * f[None, :]) @ V.T
    w, U = jnp.linalg.eigh(a @ a.T)
    s = jnp.sqrt(jnp.maximum(w, 0.0))
    f = jnp.where(s > tau, (s - tau) / jnp.maximum(s, tau), 0.0)
    return (U * f[None, :]) @ (U.T @ a)


def _hinge_prox(a: jax.Array, y: jax.Array, observed: jax.Array, c_over_rho):
    """Elementwise prox of (C/rho) * max(0, 1 - y z) at a; identity on
    unobserved cells."""
    u = y * a
    z = jnp.where(
        u >= 1.0,
        a,
        jnp.where(u >= 1.0 - c_over_rho, y, a + c_over_rho * y),
    )
    return jnp.where(observed, z, a)


def solve(
    Y: jax.Array,
    cfg: MMMFConfig = MMMFConfig(),
    state: Optional[MMMFState] = None,
) -> Tuple[MMMFState, jax.Array]:
    """Solve soft-margin nuclear-norm MMMF for a +1/0/-1 label matrix.

    Returns (state, n_iters); ``state.X`` is the learned matrix whose sign
    should agree (up to slack) with Y. Pass the previous step's state to warm
    start (replaces the reference's cold SDP re-solve per step).
    """
    Y = jnp.asarray(Y)
    observed = Y != 0
    n, m = Y.shape
    if state is None:
        state = init_state(n, m, Y.dtype)
    scale = jnp.maximum(
        jnp.sqrt(jnp.sum(observed, dtype=Y.dtype)), jnp.ones((), Y.dtype)
    )
    rho0 = jnp.asarray(cfg.rho, Y.dtype)

    def cond(carry):
        st, rho, it, resid = carry
        return (resid > cfg.tol) & (it < cfg.max_iters)

    def body(carry):
        st, rho, it, _ = carry
        X = _svt(st.Z - st.W, 1.0 / rho)
        # over-relaxed splitting point (X itself stays the f-prox output)
        Xh = cfg.over_relax * X + (1.0 - cfg.over_relax) * st.Z
        Z = _hinge_prox(Xh + st.W, Y, observed, cfg.C / rho)
        W = st.W + Xh - Z
        primal = jnp.linalg.norm(X - Z) / scale
        dual = rho * jnp.linalg.norm(Z - st.Z) / scale
        resid = jnp.maximum(primal, dual)
        if cfg.adapt_rho:
            # residual balancing; the scaled dual W = u/rho rescales with rho
            up = primal > cfg.balance_mu * dual
            down = dual > cfg.balance_mu * primal
            one = jnp.ones((), Y.dtype)
            fac = jnp.where(up, cfg.rho_scale * one,
                            jnp.where(down, one / cfg.rho_scale, one))
            rho = rho * fac
            W = W / fac
        return MMMFState(X=X, Z=Z, W=W), rho, it + 1, resid

    init = (state, rho0, jnp.int32(0), jnp.asarray(jnp.inf, Y.dtype))
    st, rho_end, it, _ = jax.lax.while_loop(cond, body, init)
    # express the scaled dual at the NOMINAL rho on exit (u = rho_end * W):
    # rho0 * W stays the true dual u, so the KKT certificate and the next
    # warm start (which re-enters at rho0) both read W consistently
    st = st.replace(W=st.W * (rho_end / rho0))

    # Failure recovery (SURVEY.md §5.3): a non-finite iterate — e.g. a NaN
    # carried in from a poisoned warm-start state — makes the residual NaN,
    # so the loop exits immediately and every subsequent warm start would
    # inherit the poison. Detect it and re-solve cold from zeros.
    bad = ~jnp.isfinite(
        jnp.sum(st.X) + jnp.sum(st.Z) + jnp.sum(st.W)
    )

    def _cold(_):
        z = init_state(n, m, Y.dtype)
        cst, crho, cit, _ = jax.lax.while_loop(
            cond, body, (z, rho0, jnp.int32(0), jnp.asarray(jnp.inf, Y.dtype))
        )
        return cst.replace(W=cst.W * (crho / rho0)), cit

    return jax.lax.cond(bad, _cold, lambda _: (st, it), None)


def factors(X: jax.Array, rank: Optional[int] = None) -> Tuple[jax.Array, jax.Array]:
    """Low-norm factors xu, xv with X = xu @ xv.T (reference: solveD.m:83-88,
    via SVD with singular values split evenly)."""
    u, s, vt = jnp.linalg.svd(X, full_matrices=False)
    if rank is not None:
        u, s, vt = u[:, :rank], s[:rank], vt[:rank]
    root = jnp.sqrt(s)
    return u * root[None, :], (vt.T) * root[None, :]


def objective(X: jax.Array, Y: jax.Array, C: float) -> jax.Array:
    """||X||_* + C * sum hinge — for solver validation."""
    s = jnp.linalg.svd(X, compute_uv=False)
    hinge = jnp.where(Y != 0, jnp.maximum(0.0, 1.0 - Y * X), 0.0)
    return jnp.sum(s) + C * jnp.sum(hinge)


# ---------------------------------------------------------------------------
# Max-norm mode (reference: solveD.m 'm' mode, :37-45)


class MaxNormConfig(NamedTuple):
    C: float = 1.0
    rank: Optional[int] = None  # factor rank; None = min(n, m) (exact)
    max_iters: int = 4000
    lr0: float = 0.1


@pytree_dataclass
class MaxNormState:
    U: jax.Array
    V: jax.Array

    @property
    def X(self) -> jax.Array:
        return self.U @ self.V.T


def solve_maxnorm(
    Y: jax.Array,
    cfg: MaxNormConfig = MaxNormConfig(),
    state: Optional[MaxNormState] = None,
    key: Optional[jax.Array] = None,
) -> Tuple[MaxNormState, jax.Array]:
    """Soft-margin MAX-NORM MMMF (the reference's solveD 'm' objective):

        min  max(max_i ||U_i||^2, max_j ||V_j||^2)
             + C * sum_{obs} hinge(1 - y_ij U_i . V_j)

    The reference expresses this as the SDP diag-bound variable
    (solveD.m:37-45, max over all diagonal entries of the Gram block matrix);
    in the factored (Burer-Monteiro) form that diagonal IS the row norms of
    U and V, so the objective above is the same program at full rank. Solved
    by subgradient descent with diminishing steps (the max term contributes
    a subgradient on the argmax row). Returns (state, final objective).

    The committed experiments only exercise the 'a' (nuclear) mode
    (evaluate_active.m:49); this completes the solveD mode surface.
    """
    Y = jnp.asarray(Y)
    n, m = Y.shape
    observed = Y != 0
    d = cfg.rank or min(n, m)
    if state is None:
        key = key if key is not None else jax.random.PRNGKey(0)
        ku, kv = jax.random.split(key)
        U0 = 0.1 * jax.random.normal(ku, (n, d), Y.dtype)
        V0 = 0.1 * jax.random.normal(kv, (m, d), Y.dtype)
        state = MaxNormState(U=U0, V=V0)

    def body(t, carry):
        U, V = carry
        X = U @ V.T
        act = observed & (Y * X < 1.0)
        dX = jnp.where(act, -cfg.C * Y, 0.0)
        dU = dX @ V
        dV = dX.T @ U
        # subgradient of max(max_i ||U_i||^2, max_j ||V_j||^2)
        un = jnp.sum(U * U, axis=1)
        vn = jnp.sum(V * V, axis=1)
        iu, iv = jnp.argmax(un), jnp.argmax(vn)
        u_side = un[iu] >= vn[iv]
        dU = dU + jnp.where(
            u_side, 2.0, 0.0
        ) * jnp.zeros_like(U).at[iu].set(U[iu])
        dV = dV + jnp.where(
            u_side, 0.0, 2.0
        ) * jnp.zeros_like(V).at[iv].set(V[iv])
        eta = cfg.lr0 / jnp.sqrt(t + 1.0)
        return U - eta * dU, V - eta * dV

    U, V = jax.lax.fori_loop(0, cfg.max_iters, body, (state.U, state.V))
    st = MaxNormState(U=U, V=V)
    return st, maxnorm_objective(U, V, Y, cfg.C)


def maxnorm_objective(U, V, Y, C: float) -> jax.Array:
    X = U @ V.T
    hinge = jnp.where(Y != 0, jnp.maximum(0.0, 1.0 - Y * X), 0.0)
    return (
        jnp.maximum(jnp.max(jnp.sum(U * U, 1)), jnp.max(jnp.sum(V * V, 1)))
        + C * jnp.sum(hinge)
    )


# ---------------------------------------------------------------------------
# Ordinal-label MMMF (reference: solveDord.m:1-60)


class OrdinalConfig(NamedTuple):
    C: float = 1.0  # >0: immediate-threshold hinge; use all_thresholds below
    all_thresholds: bool = False  # reference C<0 mode (loss over all thresholds)
    per_row_thresh: bool = False  # reference perrowthresh
    require_thresh_order: bool = True  # reference requirethreshord (isotonic)
    max_iters: int = 4000
    lr0: float = 0.5


def _isotonic(v: jax.Array) -> jax.Array:
    """Exact L2 projection onto nondecreasing vectors along the last axis via
    the minimax representation of isotonic regression:
        iso(v)_k = max_{i <= k} min_{j >= k} mean(v[i..j]).
    O(R^3) in the threshold count — trivial for the <= R-1 thresholds here,
    and fully vectorized (no PAV recursion)."""
    R = v.shape[-1]
    cs = jnp.concatenate(
        [jnp.zeros(v.shape[:-1] + (1,), v.dtype), jnp.cumsum(v, -1)], -1
    )
    i = jnp.arange(R)[:, None]  # segment start
    j = jnp.arange(R)[None, :]  # segment end (inclusive)
    seg_mean = (cs[..., j + 1] - cs[..., i]) / jnp.maximum(j - i + 1, 1)
    valid = j >= i
    big = jnp.asarray(jnp.inf, v.dtype)
    seg_mean = jnp.where(valid, seg_mean, big)  # (..., R, R), [i, j]

    k = jnp.arange(R)
    # min over j >= k of mean(i..j): (..., K, I)
    mask_kj = j[0][None, :] >= k[:, None]  # (K, J)
    min_over_j = jnp.min(
        jnp.where(mask_kj[:, None, :], seg_mean[..., None, :, :], big),
        axis=-1,
    )
    # max over i <= k: (..., K)
    mask_ki = i[:, 0][None, :] <= k[:, None]  # (K, I)
    return jnp.max(jnp.where(mask_ki, min_over_j, -big), axis=-1)


def ordinal_loss_grads(X, theta, Y_int, observed, R: int, cfg: OrdinalConfig):
    """(loss, dX, dtheta) for the ordinal hinge losses.

    Immediate-threshold (Shashua–Levin, reference C>0): per observed cell
    with label r, hinge(1 - (x - theta_{r-1})) + hinge(1 - (theta_r - x)).
    All-thresholds (reference C<0): sum_k<r hinge(1 - (x - theta_k)) +
    sum_k>=r hinge(1 - (theta_k - x)).
    theta: (R-1,) or (n, R-1) (per-row).
    """
    n, m = X.shape
    C = cfg.C
    nt = R - 1
    th = theta if theta.ndim == 2 else jnp.broadcast_to(theta[None], (n, nt))
    k_idx = jnp.arange(nt)

    # masks over thresholds per cell: which side each threshold constrains
    r = Y_int[..., None]  # (n, m, 1), labels 1..R
    below = k_idx[None, None, :] < (r - 1)  # thresholds strictly below label
    above = ~below
    if not cfg.all_thresholds:
        below = below & (k_idx[None, None, :] == (r - 2))
        above = above & (k_idx[None, None, :] == (r - 1))

    diff_low = 1.0 - (X[..., None] - th[:, None, :])  # want x > theta_k + 1
    diff_up = 1.0 - (th[:, None, :] - X[..., None])  # want x < theta_k - 1
    obs = observed[..., None]
    act_low = (diff_low > 0) & below & obs
    act_up = (diff_up > 0) & above & obs

    loss = C * (
        jnp.sum(jnp.where(act_low, diff_low, 0.0))
        + jnp.sum(jnp.where(act_up, diff_up, 0.0))
    )
    dX = C * (
        -jnp.sum(act_low, axis=-1).astype(X.dtype)
        + jnp.sum(act_up, axis=-1).astype(X.dtype)
    )
    dth_rows = C * (
        jnp.sum(act_low, axis=1).astype(X.dtype)
        - jnp.sum(act_up, axis=1).astype(X.dtype)
    )  # (n, R-1)
    dtheta = dth_rows if cfg.per_row_thresh else jnp.sum(dth_rows, axis=0)
    return loss, dX, dtheta


def solve_ordinal(
    Y: jax.Array,  # (n, m) integer labels 1..R, 0 = missing
    R: Optional[int] = None,
    cfg: OrdinalConfig = OrdinalConfig(),
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Ordinal-label nuclear-norm MMMF (reference: solveDord.m).

    min_{X, theta} ||X||_* + C * ordinal_hinge(X, theta; Y), by proximal
    subgradient with diminishing steps (SVT prox on X; free thresholds,
    optionally isotonic-projected) — replaces the reference's per-solve SDP.

    Returns (xy predicted labels, X, theta).
    """
    Y = jnp.asarray(Y)
    if not jnp.issubdtype(Y.dtype, jnp.floating):
        Y = Y.astype(jnp.float32)  # integer labels are the documented input
    n, m = Y.shape
    if R is None:
        R = int(jnp.max(Y))
    observed = Y > 0
    Y_int = Y.astype(jnp.int32)
    nt = R - 1
    theta0 = jnp.arange(1, R, dtype=Y.dtype) + 0.5
    if cfg.per_row_thresh:
        theta0 = jnp.broadcast_to(theta0[None], (n, nt)).astype(Y.dtype)
    X0 = jnp.zeros((n, m), Y.dtype)

    def body(t, carry):
        X, theta = carry
        _, dX, dtheta = ordinal_loss_grads(X, theta, Y_int, observed, R, cfg)
        eta = cfg.lr0 / jnp.sqrt(t + 1.0)
        X = _svt(X - eta * dX, eta)
        theta = theta - eta * dtheta
        if cfg.require_thresh_order:
            theta = _isotonic(theta)
        return X, theta

    X, theta = jax.lax.fori_loop(0, cfg.max_iters, body, (X0, theta0))
    xy = predict_ordinal(X, theta, n)
    return xy, X, theta


def predict_ordinal(X: jax.Array, theta: jax.Array, n: int) -> jax.Array:
    """Labels from thresholds: xy = 1 + #{k: x > theta_k}
    (reference: solveDord.m output contract :41-46)."""
    th = theta if theta.ndim == 2 else jnp.broadcast_to(
        theta[None], (n, theta.shape[-1])
    )
    return 1 + jnp.sum(X[..., None] > th[:, None, :], axis=-1)


def ordinal_objective(X, theta, Y, R, cfg: OrdinalConfig):
    s = jnp.linalg.svd(X, compute_uv=False)
    loss, _, _ = ordinal_loss_grads(
        X, theta, Y.astype(jnp.int32), Y > 0, R, cfg
    )
    return jnp.sum(s) + loss


# ---------------------------------------------------------------------------
# Selectors (reference: mmmf/select_*.m)


def selector_evals(name: str, X: jax.Array, can_query: jax.Array, key=None):
    """Margin maps for the selector registry (NaN off the pool).

    min-margin / max-margin use |x| (select_min_margin.m:1-12);
    min-margin-pos uses the signed margin with non-positives masked to +inf
    (select_min_margin_pos.m:7); max-margin-pos is the UNMASKED signed max —
    the reference's mask line is commented out (select_max_margin_pos.m:7),
    so it just takes the largest margin.
    """
    if name == "random":
        ev = jax.random.uniform(key, X.shape, dtype=X.dtype)
        return jnp.where(can_query, ev, jnp.nan), True
    if name == "min-margin":
        return jnp.where(can_query, jnp.abs(X), jnp.nan), False
    if name == "max-margin":
        return jnp.where(can_query, jnp.abs(X), jnp.nan), True
    if name == "min-margin-pos":
        ev = jnp.where(X > 0, X, jnp.inf)
        return jnp.where(can_query, ev, jnp.nan), False
    if name == "max-margin-pos":
        return jnp.where(can_query, X, jnp.nan), True
    raise ValueError(f"unknown MMMF selector {name!r}")


MMMF_KEYS = {
    "random": "Random",
    "min-margin": "Min Margin",
    "min-margin-pos": "Min Margin Positive",
    "max-margin": "Max Margin",
    "max-margin-pos": "Max Margin Positive",
}
