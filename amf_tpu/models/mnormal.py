"""Matrix-normal (Kronecker-factored) variational approximation.

Capability parity with the reference's ``MNActivePMF`` approximation layer
(python-pmf/mn_active_pmf.py:119-330 + matrix_normal_exps_cy.pyx): the
posterior over X = vstack(U, V) is MN(mean, cov_useritems (x) cov_latents),
shrinking state from ((n+m)d)^2 to (n+m)^2 + d^2 — the reference's (and our)
memory-scaling strategy for larger problems (SURVEY.md §5.7).

Known reference bugs fixed here (SURVEY.md §2.5; do-not-replicate list):
  * matrix_normal_exps_cy.pyx:176 computes num_items = 0, so the item-trace
    regularization term never accumulates and :192 reads a stale loop index;
  * :196-197 divides the item regularizer by sigma_u_sq instead of
    sigma_v_sq.
The *gradient* in the reference (matrix_normal_exps_cy._mnormal_grad:447-462)
handles users/items correctly; our autodiff gradient of the fixed KL value is
consistent by construction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from amf_tpu.ops.linesearch import DescentInfo, adaptive_descent
from amf_tpu.ops.moments import mn_pred_mean_var
from amf_tpu.ops.psd import project_psd
from amf_tpu.models.pmf import PMFState
from amf_tpu.types import Problem, pytree_dataclass


class MNConfig(NamedTuple):
    """Static knobs (reference defaults: mn_active_pmf.py:156-158)."""

    latent_d: int = 1
    learning_rate: float = 1e-4
    min_eig: float = 1e-5
    stop_thresh: float = 0.005
    min_lr: float = 1e-10
    max_fit_steps: int = 500


@pytree_dataclass
class MNState:
    mean: jax.Array  # (n+m, d)
    cov_useritems: jax.Array  # (n+m, n+m)
    cov_latents: jax.Array  # (d, d)


def initialize_approx(
    pmf_state: PMFState,
    cfg: MNConfig,
    key: Optional[jax.Array] = None,
    random_cov: bool = False,
) -> MNState:
    """Mean at MAP, identity covariances (or random PSD if random_cov)
    (reference: mn_active_pmf.initialize_approx :202-219)."""
    mean = jnp.concatenate([pmf_state.U, pmf_state.V], axis=0)
    n_ui = mean.shape[0]
    d = mean.shape[1]
    if random_cov:
        ka, kb = jax.random.split(key)
        a = jax.random.normal(ka, (n_ui, n_ui), dtype=mean.dtype)
        b = jax.random.normal(kb, (d, d), dtype=mean.dtype)
        return MNState(mean=mean, cov_useritems=a @ a.T, cov_latents=b @ b.T)
    return MNState(
        mean=mean,
        cov_useritems=jnp.eye(n_ui, dtype=mean.dtype),
        cov_latents=jnp.eye(d, dtype=mean.dtype),
    )


def kl_divergence(
    mn: MNState,
    pmf_state: PMFState,
    problem: Problem,
    cfg: MNConfig,
    mean=None,
    cov_useritems=None,
    cov_latents=None,
) -> jax.Array:
    """KL(approximation || PMF model), up to an additive constant
    (reference: matrix_normal_exps_cy.mn_kl_divergence :159-213, with the
    item-regularizer bugs fixed — see module docstring)."""
    mean = mn.mean if mean is None else mean
    Sr = mn.cov_useritems if cov_useritems is None else cov_useritems
    Sc = mn.cov_latents if cov_latents is None else cov_latents
    n, m = problem.shape
    d = mean.shape[1]

    pred_mean, pred_var = mn_pred_mean_var(mean, Sr, Sc, n, m)
    e_dot_sq = pred_mean**2 + pred_var
    r = problem.R_obs
    data_terms = jnp.where(problem.rated, e_dot_sq - 2 * r * pred_mean + r * r, 0.0)
    kl = jnp.sum(data_terms) / (2 * pmf_state.sigma_sq)

    # entropy term
    _, logdet_r = jnp.linalg.slogdet(Sr)
    _, logdet_c = jnp.linalg.slogdet(Sc)
    kl = kl - (logdet_r * d + logdet_c * (n + m)) / 2

    # regularization: E||U||^2 = ||mean_u||^2 + tr(Sr_uu) tr(Sc), etc.
    tr_c = jnp.trace(Sc)
    diag_r = jnp.diagonal(Sr)
    kl = kl + (jnp.sum(mean[:n] ** 2) + jnp.sum(diag_r[:n]) * tr_c) / (
        2 * pmf_state.sigma_u_sq
    )
    kl = kl + (jnp.sum(mean[n:] ** 2) + jnp.sum(diag_r[n:]) * tr_c) / (
        2 * pmf_state.sigma_v_sq
    )
    return kl


def _tri_symmetrize(g: jax.Array) -> jax.Array:
    """Reference triangular-half gradient convention (see vnormal)."""
    return g + g.T - jnp.diag(jnp.diagonal(g))


def fit_normal(
    mn: MNState,
    pmf_state: PMFState,
    problem: Problem,
    cfg: MNConfig,
    max_steps: Optional[int] = None,
) -> Tuple[MNState, DescentInfo]:
    """Adaptive-LR KL descent, PSD-projecting both covariance factors
    (reference: mn_active_pmf.fit_normal_kls :242-288)."""
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps

    def value_fn(x):
        return kl_divergence(
            mn, pmf_state, problem, cfg,
            mean=x[0], cov_useritems=x[1], cov_latents=x[2],
        )

    kl_vag = jax.value_and_grad(value_fn)

    def value_and_grad_fn(x):
        f, (gm, gr, gc) = kl_vag(x)
        return f, (gm, _tri_symmetrize(gr), _tri_symmetrize(gc))

    def step_fn(x, g, lr):
        return (
            x[0] - lr * g[0],
            project_psd(x[1] - lr * g[1], min_eig=cfg.min_eig),
            project_psd(x[2] - lr * g[2], min_eig=cfg.min_eig),
        )

    (mean, Sr, Sc), info = adaptive_descent(
        (mn.mean, mn.cov_useritems, mn.cov_latents),
        value_fn,
        None,
        step_fn,
        lr0=cfg.learning_rate,
        stop_thresh=cfg.stop_thresh,
        min_lr=cfg.min_lr,
        max_steps=max_steps,
        value_and_grad_fn=value_and_grad_fn,
    )
    return MNState(mean=mean, cov_useritems=Sr, cov_latents=Sc), info


def approx_pred_means_vars(
    mn: MNState, problem: Problem
) -> Tuple[jax.Array, jax.Array]:
    """(n, m) predictive means/variances
    (reference: mn_active_pmf.approx_pred_means_vars :317-330, batched)."""
    n, m = problem.shape
    return mn_pred_mean_var(mn.mean, mn.cov_useritems, mn.cov_latents, n, m)


def approx_entropy(mn: MNState, n: int, m: int) -> jax.Array:
    """log-det entropy of the Kronecker covariance, up to constants:
    d*logdet(Sr) + (n+m)*logdet(Sc)."""
    d = mn.mean.shape[1]
    _, logdet_r = jnp.linalg.slogdet(mn.cov_useritems)
    _, logdet_c = jnp.linalg.slogdet(mn.cov_latents)
    return d * logdet_r + (n + m) * logdet_c


def mean_meandiff(mn: MNState, pmf_state: PMFState) -> jax.Array:
    p = jnp.concatenate([pmf_state.U, pmf_state.V], axis=0)
    return jnp.abs(mn.mean - p).mean()
