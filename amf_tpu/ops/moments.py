"""Closed-form Gaussian moments (Isserlis), batched over all matrix cells.

Reference analogues: python-pmf/normal_exps_cy.pyx:40-135 (scalar moments,
one cell at a time inside O(d^2) Python/Cython loops) and
matrix_normal_exps_cy.pyx:28-154 (Kronecker-structured versions).

Accelerator-first redesign: the per-cell scalar kernels become all-pairs einsums, so
quantities the reference computes cell-by-cell inside a multiprocessing
fan-out (e.g. ``approx_pred_means_vars``, active_pmf.py:301-322, and
``approx_pred_covs``, :324-390) are one device pass each.

Key identity used throughout (general Isserlis, valid for repeated indices):
  E[x1 x2 x3 x4] = m1 m2 m3 m4
    + m1 m2 C34 + m1 m3 C24 + m1 m4 C23 + m2 m3 C14 + m2 m4 C13 + m3 m4 C12
    + C12 C34 + C13 C24 + C14 C23
Summing over latent dims k, l with x1=U_ik, x2=V_jk, x3=U_il, x4=V_jl yields

  E[(U_i^T V_j)^2] = (mu_i . mv_j + tr A)^2                  (= E[U_i^T V_j]^2)
    + mu_i^T Bv mu_i + mv_j^T Bu mv_j + 2 mv_j^T A mu_i
    + sum(Bu * Bv) + tr(A A)                                 (= Var[U_i^T V_j])

with A_kl = cov(U_ik, V_jl), Bu_kl = cov(U_ik, U_il), Bv_kl = cov(V_jk, V_jl).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Scalar moments (kept for tests / parity with normal_exps_cy.pyx:40-135)


def tripexpect(mean, cov, a, b, c):
    """E[X_a X_b X_c] for N(mean, cov)."""
    return (
        mean[a] * mean[b] * mean[c]
        + mean[a] * cov[b, c]
        + mean[b] * cov[a, c]
        + mean[c] * cov[a, b]
    )


def quadexpect(mean, cov, a, b, c, d):
    """E[X_a X_b X_c X_d] (general Isserlis; valid for repeated indices)."""
    ma, mb, mc, md = mean[a], mean[b], mean[c], mean[d]
    return (
        ma * mb * mc * md
        + ma * mb * cov[c, d]
        + ma * mc * cov[b, d]
        + ma * md * cov[b, c]
        + mb * mc * cov[a, d]
        + mb * md * cov[a, c]
        + mc * md * cov[a, b]
        + cov[a, b] * cov[c, d]
        + cov[a, c] * cov[b, d]
        + cov[a, d] * cov[b, c]
    )


def exp_squared(mean, cov, a, b):
    """E[X_a^2 X_b^2]."""
    return (
        4 * mean[a] * mean[b] * cov[a, b]
        + 2 * cov[a, b] ** 2
        + (mean[a] ** 2 + cov[a, a]) * (mean[b] ** 2 + cov[b, b])
    )


def exp_a2bc(mean, cov, a, b, c):
    """E[X_a^2 X_b X_c]."""
    ma, mb, mc = mean[a], mean[b], mean[c]
    return (
        (ma**2 + cov[a, a]) * (mb * mc + cov[b, c])
        + 2 * ma * mc * cov[a, b]
        + 2 * ma * mb * cov[a, c]
        + 2 * cov[a, b] * cov[a, c]
    )


# ---------------------------------------------------------------------------
# Full-covariance (vector-normal) batched moments


class VNBlocks(NamedTuple):
    """Views of the flat (K, K) covariance, K = (n+m)*d, flat index of
    U_{ik} = i*d+k and V_{jk} = n*d + j*d + k (layout matches the reference's
    index arrays, active_pmf.py:141-142)."""

    mu_u: jnp.ndarray  # (n, d)
    mu_v: jnp.ndarray  # (m, d)
    Cuu: jnp.ndarray  # (n, d, n, d)
    Cuv: jnp.ndarray  # (n, d, m, d)
    Cvv: jnp.ndarray  # (m, d, m, d)
    Bu: jnp.ndarray  # (n, d, d) per-row covariance diag blocks
    Bv: jnp.ndarray  # (m, d, d)


def vn_blocks(mean: jnp.ndarray, cov: jnp.ndarray, n: int, m: int, d: int) -> VNBlocks:
    mu_u = mean[: n * d].reshape(n, d)
    mu_v = mean[n * d :].reshape(m, d)
    Cuu = cov[: n * d, : n * d].reshape(n, d, n, d)
    Cuv = cov[: n * d, n * d :].reshape(n, d, m, d)
    Cvv = cov[n * d :, n * d :].reshape(m, d, m, d)
    Bu = jnp.einsum("ikil->ikl", Cuu)
    Bv = jnp.einsum("jkjl->jkl", Cvv)
    return VNBlocks(mu_u, mu_v, Cuu, Cuv, Cvv, Bu, Bv)


def vn_pred_mean_var(
    mean: jnp.ndarray, cov: jnp.ndarray, n: int, m: int, d: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(n, m) predictive means and variances of R_ij = U_i^T V_j.

    One batched pass replacing the reference's double loop over cells calling
    ``exp_dotprod_sq`` per cell (active_pmf.py:301-322).
    """
    b = vn_blocks(mean, cov, n, m, d)
    trA = jnp.einsum("ikjk->ij", b.Cuv)
    pred_mean = b.mu_u @ b.mu_v.T + trA
    var = (
        jnp.einsum("ik,jkl,il->ij", b.mu_u, b.Bv, b.mu_u)
        + jnp.einsum("jk,ikl,jl->ij", b.mu_v, b.Bu, b.mu_v)
        + 2 * jnp.einsum("jk,ikjl,il->ij", b.mu_v, b.Cuv, b.mu_u)
        + jnp.einsum("ikl,jkl->ij", b.Bu, b.Bv)
        + jnp.einsum("ikjl,iljk->ij", b.Cuv, b.Cuv)
    )
    return pred_mean, var


def vn_exp_dotprod_sq(
    mean: jnp.ndarray, cov: jnp.ndarray, n: int, m: int, d: int
) -> jnp.ndarray:
    """(n, m) matrix of E[(U_i^T V_j)^2] (normal_exps_cy.exp_dotprod_sq:111,
    batched)."""
    pm, var = vn_pred_mean_var(mean, cov, n, m, d)
    return pm**2 + var


def vn_pred_covs(
    mean: jnp.ndarray, cov: jnp.ndarray, n: int, m: int, d: int
) -> jnp.ndarray:
    """(n*m, n*m) covariance of the predicted matrix entries.

    cov(U_i.V_j, U_a.V_b); replaces the reference's O((nm)^2 d^2) Python
    double loop (active_pmf.py:324-390) with six einsums. Only used by the
    pred-entropy-bound criterion on small problems.
    """
    b = vn_blocks(mean, cov, n, m, d)
    # indices: x1=U_ik, x2=V_jk, x3=U_al, x4=V_bl; see module docstring.
    t3 = jnp.einsum("ik,jkbl,al->ijab", b.mu_u, b.Cvv, b.mu_u)
    t4 = jnp.einsum("ik,aljk,bl->ijab", b.mu_u, b.Cuv, b.mu_v)
    t5 = jnp.einsum("jk,ikbl,al->ijab", b.mu_v, b.Cuv, b.mu_u)
    t6 = jnp.einsum("jk,ikal,bl->ijab", b.mu_v, b.Cuu, b.mu_v)
    t9 = jnp.einsum("ikal,jkbl->ijab", b.Cuu, b.Cvv)
    t10 = jnp.einsum("ikbl,aljk->ijab", b.Cuv, b.Cuv)
    out = t3 + t4 + t5 + t6 + t9 + t10
    return out.reshape(n * m, n * m)


# ---------------------------------------------------------------------------
# Matrix-normal (Kronecker) batched moments
# cov(X_{ik}, X_{jl}) = cov_rows[i, j] * cov_cols[k, l], X = vstack(U, V)
# (reference: matrix_normal_exps_cy.pyx:28-154)


def mn_pred_mean_var(
    mean: jnp.ndarray,  # (n+m, d)
    cov_rows: jnp.ndarray,  # (n+m, n+m)  "cov_useritems"
    cov_cols: jnp.ndarray,  # (d, d)      "cov_latents"
    n: int,
    m: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(n, m) predictive means/variances under the Kronecker factorization.

    Specializes the VN formulas with A = S_uv[i,j] * Oc, Bu = S_uu[i,i] * Oc,
    Bv = S_vv[j,j] * Oc (replacing mn_active_pmf.approx_pred_means_vars's
    double loop, mn_active_pmf.py:300-330).
    """
    mu_u, mu_v = mean[:n], mean[n:]
    S_uv = cov_rows[:n, n:]  # (n, m)
    s_u = jnp.diagonal(cov_rows)[:n]  # (n,)
    s_v = jnp.diagonal(cov_rows)[n:]  # (m,)
    tr_c = jnp.trace(cov_cols)
    frob2 = jnp.sum(cov_cols * cov_cols)

    pred_mean = mu_u @ mu_v.T + S_uv * tr_c

    uOu = jnp.einsum("ik,kl,il->i", mu_u, cov_cols, mu_u)  # (n,)
    vOv = jnp.einsum("jk,kl,jl->j", mu_v, cov_cols, mu_v)  # (m,)
    vOu = jnp.einsum("jk,kl,il->ij", mu_v, cov_cols, mu_u)  # (n, m)

    var = (
        uOu[:, None] * s_v[None, :]
        + vOv[None, :] * s_u[:, None]
        + 2 * S_uv * vOu
        + (s_u[:, None] * s_v[None, :]) * frob2
        + (S_uv**2) * frob2
    )
    return pred_mean, var


def mn_exp_dotprod_sq(mean, cov_rows, cov_cols, n: int, m: int) -> jnp.ndarray:
    pm, var = mn_pred_mean_var(mean, cov_rows, cov_cols, n, m)
    return pm**2 + var
