"""Full-covariance variational normal approximation (the ActivePMF layer).

Capability parity with the reference's ``ActivePMF`` approximation machinery
(python-pmf/active_pmf.py:102-400): a multivariate normal over
vec(U, V) fit by gradient descent on KL(q || PMF model) with PSD projection
after every covariance step, plus the batched predictive quantities the
selection criteria consume.

Accelerator-first differences:
  * the KL and all moments are the closed-form all-pairs einsums of
    ``ops.moments`` (the reference calls per-cell Cython kernels in Python
    loops, active_pmf.py:215-229, 301-390);
  * the KL gradient is JAX autodiff of the (vectorized) KL value, with the
    covariance gradient symmetrized as G + G^T - diag(G) to reproduce the
    reference's triangular-half convention exactly (normal_exps_cy.pyx:140-303
    differentiates w.r.t. one triangular half and mirrors);
  * ``fit_normal_kls``'s adaptive-LR loop (active_pmf.py:251-288) is
    ``ops.adaptive_descent`` with PSD projection inside the step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from amf_tpu.ops.linesearch import DescentInfo, adaptive_descent
from amf_tpu.ops.moments import vn_pred_covs, vn_pred_mean_var
from amf_tpu.ops.psd import project_psd
from amf_tpu.models.pmf import PMFState
from amf_tpu.types import Problem, pytree_dataclass


class VNConfig(NamedTuple):
    """Static knobs (reference defaults: active_pmf.py:144-146, 251-288).

    cov_param selects the covariance descent parameterization:
      * "psd-project" (default, parity): descend on the full covariance and
        eigh-project to the PSD cone after every proposal, exactly the
        reference's fit_normal_kls trajectory (active_pmf.py:251-288).
      * "chol": descend on a Cholesky factor L with cov = L L^T + min_eig I —
        every iterate is PSD by construction, so the per-proposal (k, k)
        eigh disappears entirely. Same KL objective and stationary points,
        DIFFERENT trajectory (a deliberate non-parity fast path for the
        lookahead fan-out; SURVEY.md "hard parts", PARITY.md deviations).
    """

    latent_d: int = 1
    learning_rate: float = 1e-4  # normal_learning_rate
    min_eig: float = 1e-5
    stop_thresh: float = 0.005
    min_lr: float = 1e-10
    max_fit_steps: int = 500
    cov_param: str = "psd-project"  # or "chol"


@pytree_dataclass
class VNState:
    mean: jax.Array  # ((n+m)*d,)
    cov: jax.Array  # ((n+m)*d, (n+m)*d)


def initialize_approx(
    key: jax.Array, pmf_state: PMFState, cfg: VNConfig
) -> VNState:
    """Mean at the MAP values, random PSD covariance
    (reference: active_pmf.initialize_approx :190-200)."""
    mean = jnp.concatenate([pmf_state.U.reshape(-1), pmf_state.V.reshape(-1)])
    k = mean.shape[0]
    s = 2.0 * jax.random.normal(key, (k, k), dtype=mean.dtype)
    return VNState(mean=mean, cov=project_psd(s, min_eig=cfg.min_eig))


def kl_divergence(
    vn: VNState,
    pmf_state: PMFState,
    problem: Problem,
    cfg: VNConfig,
    mean: Optional[jax.Array] = None,
    cov: Optional[jax.Array] = None,
) -> jax.Array:
    """KL(PMF model || approximation) up to an additive constant
    (reference: active_pmf.kl_divergence :202-240), fully vectorized."""
    mean = vn.mean if mean is None else mean
    cov = vn.cov if cov is None else cov
    n, m = problem.shape
    d = cfg.latent_d

    pred_mean, pred_var = vn_pred_mean_var(mean, cov, n, m, d)
    e_dot_sq = pred_mean**2 + pred_var

    r = problem.R_obs
    data_terms = jnp.where(
        problem.rated, e_dot_sq - 2.0 * r * pred_mean + r * r, 0.0
    )
    div = jnp.sum(data_terms) / (2 * pmf_state.sigma_sq)

    nd = n * d
    mu_u, mu_v = mean[:nd], mean[nd:]
    diag = jnp.diagonal(cov)
    div = div + (jnp.sum(mu_u**2) + jnp.sum(diag[:nd])) / (2 * pmf_state.sigma_u_sq)
    div = div + (jnp.sum(mu_v**2) + jnp.sum(diag[nd:])) / (2 * pmf_state.sigma_v_sq)

    _, log_det = jnp.linalg.slogdet(cov)
    return div - log_det / 2


def _tri_symmetrize(g: jax.Array) -> jax.Array:
    """Convert an autodiff full-matrix gradient to the reference's
    triangular-half convention: off-diagonals doubled (G + G^T), diagonal
    kept (normal_exps_cy.pyx differentiates w.r.t. one triangular half and
    writes the value to both mirror positions)."""
    return g + g.T - jnp.diag(jnp.diagonal(g))


def fit_normal(
    vn: VNState,
    pmf_state: PMFState,
    problem: Problem,
    cfg: VNConfig,
    max_steps: Optional[int] = None,
) -> Tuple[VNState, DescentInfo]:
    """Gradient descent on the KL with adaptive LR + PSD projection
    (reference: active_pmf.fit_normal_kls :251-288)."""
    if cfg.cov_param == "chol":
        return _fit_normal_chol(vn, pmf_state, problem, cfg, max_steps)
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps

    def value_fn(x):
        return kl_divergence(vn, pmf_state, problem, cfg, mean=x[0], cov=x[1])

    kl_vag = jax.value_and_grad(value_fn)

    def value_and_grad_fn(x):
        f, (gm, gc) = kl_vag(x)
        return f, (gm, _tri_symmetrize(gc))

    def step_fn(x, g, lr):
        return (
            x[0] - lr * g[0],
            project_psd(x[1] - lr * g[1], min_eig=cfg.min_eig),
        )

    (mean, cov), info = adaptive_descent(
        (vn.mean, vn.cov),
        value_fn,
        None,
        step_fn,
        lr0=cfg.learning_rate,
        stop_thresh=cfg.stop_thresh,
        min_lr=cfg.min_lr,
        max_steps=max_steps,
        value_and_grad_fn=value_and_grad_fn,
    )
    return VNState(mean=mean, cov=cov), info


def _fit_normal_chol(
    vn: VNState,
    pmf_state: PMFState,
    problem: Problem,
    cfg: VNConfig,
    max_steps: Optional[int] = None,
) -> Tuple[VNState, DescentInfo]:
    """KL descent in the Cholesky-factor parameterization (VNConfig
    cov_param="chol"): descend on lower-triangular L with
    cov = L L^T + min_eig I, so every proposal is PSD by construction and
    the per-proposal (k, k) eigh of the projection path vanishes.

    Same KL objective as fit_normal (and the reference's fit_normal_kls,
    active_pmf.py:251-288); the descent TRAJECTORY differs — a documented
    non-parity fast path for the in-lookahead refit fan-out where only the
    refit endpoint's statistic matters (VERDICT r4 #8; PARITY.md). The
    state keeps the plain (mean, cov) layout: one Cholesky at entry, one
    L L^T at exit.
    """
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps
    dtype = vn.cov.dtype
    k = vn.cov.shape[0]
    eye = jnp.eye(k, dtype=dtype)
    floor = jnp.asarray(cfg.min_eig, dtype)

    # entry factor: cov from initialize_approx / a previous fit is PSD with
    # eigenvalues >= min_eig; the tiny extra jitter keeps the one-time
    # factorization safe in f32
    L0 = jnp.linalg.cholesky(vn.cov + 1e-6 * jnp.trace(vn.cov) / k * eye)

    def cov_of(L):
        Lt = jnp.tril(L)
        # HIGHEST precision: a reduced-precision f32 matmul (bf16 or TF32
        # passes, ~1e-3..1e-2 relative error) dwarfs the min_eig floor and
        # leaves the reconstructed covariance indefinite for the KL's
        # cholesky/logdet
        return (
            jnp.matmul(Lt, Lt.T, precision=jax.lax.Precision.HIGHEST)
            + floor * eye
        )

    def value_fn(x):
        return kl_divergence(
            vn, pmf_state, problem, cfg, mean=x[0], cov=cov_of(x[1])
        )

    value_and_grad_fn = jax.value_and_grad(value_fn)

    def step_fn(x, g, lr):
        # the gradient through cov_of is already zero above the diagonal
        # (tril); no projection needed — L - lr*g stays a valid factor
        return (x[0] - lr * g[0], x[1] - lr * g[1])

    (mean, L), info = adaptive_descent(
        (vn.mean, L0),
        value_fn,
        None,
        step_fn,
        lr0=cfg.learning_rate,
        stop_thresh=cfg.stop_thresh,
        min_lr=cfg.min_lr,
        max_steps=max_steps,
        value_and_grad_fn=value_and_grad_fn,
    )
    return VNState(mean=mean, cov=cov_of(L)), info


# ---------------------------------------------------------------------------
# Predictive quantities consumed by criteria


def approx_pred_means_vars(
    vn: VNState, problem: Problem, cfg: VNConfig
) -> Tuple[jax.Array, jax.Array]:
    """(n, m) predictive mean and variance matrices
    (reference: active_pmf.approx_pred_means_vars :301-322, batched)."""
    n, m = problem.shape
    return vn_pred_mean_var(vn.mean, vn.cov, n, m, cfg.latent_d)


def approx_pred_covs(vn: VNState, problem: Problem, cfg: VNConfig) -> jax.Array:
    """(n*m, n*m) prediction covariance
    (reference: active_pmf.approx_pred_covs :324-390, batched)."""
    n, m = problem.shape
    return vn_pred_covs(vn.mean, vn.cov, n, m, cfg.latent_d)


def approx_entropy(vn: VNState) -> jax.Array:
    """log-det entropy of the approximation, up to constants
    (reference: active_pmf._approx_entropy :526-530)."""
    _, logdet = jnp.linalg.slogdet(vn.cov)
    return logdet


def mean_meandiff(vn: VNState, pmf_state: PMFState) -> jax.Array:
    p = jnp.concatenate([pmf_state.U.reshape(-1), pmf_state.V.reshape(-1)])
    return jnp.abs(vn.mean - p).mean()
