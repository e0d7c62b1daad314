"""Batched small-matrix Cholesky solve+sample for the Gibbs row draws.

The Gibbs conditional row draws (models/bpmf_gibbs._sample_rows; reference:
python-pmf/bayes_pmf.py sample_feature :189-216) need, for every row i of a
factor, a draw  x_i = S_i^{-1} b_i + L_i^{-T} z_i  with S_i = L_i L_i^T a
(d x d) posterior precision and d the latent rank. At lookahead width that
is ~10^5 independent factorizations per Gibbs sweep.

Two formulations of the same draw:

* ``chol_solve_sample_unrolled`` writes the factorization and both
  substitutions out entry by entry on entry-major inputs, so that every
  operation is elementwise over the batch: XLA fuses the solve into a few
  loop kernels that read S once. The code grows as d^3, and so does XLA's
  compile time, hence the cap ``MAX_UNROLLED_D``.
* ``chol_solve_sample_reference`` is ``jnp.linalg.cholesky`` plus triangular
  solves: batched cuSOLVER/cuBLAS calls on a GPU, each of which passes over
  the whole (B, d, d) batch again; LAPACK on the CPU. It is the CPU path and
  the tests' oracle.

``use_unrolled`` picks the first on a GPU. The unrolled sample is
x = L^{-T}(L^{-1} b + z), equal to the reference's mean + L^{-T} z up to
rounding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# the largest rank the reference's experiments use; XLA compiles the
# unrolled solve in about 10 s there on an H100
MAX_UNROLLED_D = 20


def chol_solve_sample_unrolled(
    S_cols: jax.Array,  # (..., d*d, B): row j*d + i holds S[:, i, j]
    rhs: jax.Array,  # (..., d, B)
    z: jax.Array,  # (..., d, B) standard-normal draws
) -> jax.Array:
    """x = S^{-1} rhs + chol(S)^{-T} z per column b, as (..., d, B)."""
    d = rhs.shape[-2]
    if S_cols.shape[-2] != d * d or z.shape != rhs.shape:
        raise ValueError(
            f"shapes {S_cols.shape}, {rhs.shape}, {z.shape} are not "
            f"(..., d*d, B), (..., d, B), (..., d, B)")
    L = {}  # (i, j) -> L[i, j] for i > j
    inv_diag = []
    y = []
    for j in range(d):  # column j of L, left-looking; y_j alongside
        dg = S_cols[..., j * d + j, :]
        for k in range(j):
            dg = dg - L[j, k] * L[j, k]
        r = jax.lax.rsqrt(dg)
        inv_diag.append(r)
        v = rhs[..., j, :]
        for k in range(j):
            v = v - L[j, k] * y[k]
        y.append(v * r)
        for i in range(j + 1, d):
            v = S_cols[..., j * d + i, :]
            for k in range(j):
                v = v - L[i, k] * L[j, k]
            L[i, j] = v * r
    x = [None] * d
    for j in reversed(range(d)):  # L^T x = y + z
        v = y[j] + z[..., j, :]
        for k in range(j + 1, d):
            v = v - L[k, j] * x[k]
        x[j] = v * inv_diag[j]
    return jnp.stack(x, axis=-2)


def chol_solve_sample_reference(
    S: jax.Array, rhs: jax.Array, z: jax.Array
) -> jax.Array:
    """Plain-JAX version on (..., d, d) / (..., d): x = S^{-1} rhs +
    chol(S)^{-T} z, with two back substitutions."""
    L = jnp.linalg.cholesky(S)
    y = jax.scipy.linalg.solve_triangular(L, rhs[..., None], lower=True)
    mean = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )[..., 0]
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), z[..., None], lower=False
    )[..., 0]
    return mean + x


def use_unrolled(d: int) -> bool:
    """The unrolled solve serves d <= MAX_UNROLLED_D on a GPU; everything
    else takes the reference. The platform is the one computation lands on:
    the default device where one is set (the CPU mesh of tests and dryruns),
    else the default backend."""
    dev = jax.config.jax_default_device
    platform = dev.platform if dev is not None else jax.default_backend()
    return platform == "gpu" and d <= MAX_UNROLLED_D
