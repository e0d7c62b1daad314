"""Cholesky solve+sample for the Gibbs row draws (ops/chol_sample.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from amf_tpu.models import bpmf_gibbs
from amf_tpu.ops import chol_sample


def _spd_batch(rng, B, d, dtype=np.float32):
    A = rng.normal(size=(B, d, d)).astype(dtype)
    return A @ np.swapaxes(A, 1, 2) + d * np.eye(d, dtype=dtype)


def _cols(S):
    """(..., B, d, d) -> entry-major (..., d*d, B)."""
    *lead, B, d, _ = S.shape
    return np.moveaxis(np.swapaxes(S, -1, -2).reshape(*lead, B, d * d), -2, -1)


def _problem(rng, B, d):
    S = _spd_batch(rng, B, d)
    rhs = rng.normal(size=(B, d)).astype(np.float32)
    z = rng.normal(size=(B, d)).astype(np.float32)
    return S, rhs, z


def _reference(S, rhs, z):
    return np.asarray(chol_sample.chol_solve_sample_reference(
        jnp.asarray(S), jnp.asarray(rhs), jnp.asarray(z)))


@pytest.mark.parametrize("d", [1, 4, 10, 20])
def test_unrolled_matches_reference(d):
    rng = np.random.default_rng(0)
    B = 37
    S, rhs, z = _problem(rng, B, d)
    got = np.asarray(jax.jit(chol_sample.chol_solve_sample_unrolled)(
        jnp.asarray(_cols(S)), jnp.asarray(rhs.T), jnp.asarray(z.T))).T
    np.testing.assert_allclose(got, _reference(S, rhs, z), rtol=2e-4,
                               atol=2e-4)


def test_unrolled_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        chol_sample.chol_solve_sample_unrolled(
            jnp.zeros((9, 5)), jnp.zeros((2, 5)), jnp.zeros((2, 5)))


def test_reference_is_a_gaussian_draw():
    """x = S^{-1} b + L^{-T} z has mean S^{-1} b and covariance S^{-1}."""
    rng = np.random.default_rng(1)
    d = 3
    S = _spd_batch(rng, 1, d, np.float64)[0]
    b = rng.normal(size=d)
    N = 40000
    Z = rng.normal(size=(N, d))
    xs = np.asarray(chol_sample.chol_solve_sample_reference(
        jnp.asarray(np.broadcast_to(S, (N, d, d))),
        jnp.asarray(np.broadcast_to(b, (N, d))),
        jnp.asarray(Z)))
    np.testing.assert_allclose(xs.mean(0), np.linalg.solve(S, b), atol=0.05)
    emp_cov = np.cov(xs.T)
    np.testing.assert_allclose(emp_cov, np.linalg.inv(S), atol=0.05)


def test_dispatch_multibatch_shape():
    """Leading batch axes, as such and under vmap."""
    rng = np.random.default_rng(2)
    d, B = 4, 9
    S, rhs, z = _problem(rng, 6 * B, d)
    S, rhs, z = (S.reshape(2, 3, B, d, d), rhs.reshape(2, 3, B, d),
                 z.reshape(2, 3, B, d))
    args = (jnp.asarray(_cols(S)), jnp.asarray(np.swapaxes(rhs, -1, -2)),
            jnp.asarray(np.swapaxes(z, -1, -2)))
    want = _reference(S, rhs, z)
    for fn in (chol_sample.chol_solve_sample_unrolled,
               jax.vmap(jax.vmap(chol_sample.chol_solve_sample_unrolled))):
        out = fn(*args)
        assert out.shape == (2, 3, d, B)
        np.testing.assert_allclose(np.swapaxes(np.asarray(out), -1, -2),
                                   want, rtol=2e-4, atol=2e-4)


def test_use_unrolled_choice(monkeypatch):
    assert not chol_sample.use_unrolled(20)  # the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert chol_sample.use_unrolled(1)
    assert chol_sample.use_unrolled(chol_sample.MAX_UNROLLED_D)
    assert not chol_sample.use_unrolled(chol_sample.MAX_UNROLLED_D + 1)


def test_sample_rows_unrolled_layout_matches_reference(monkeypatch):
    """The entry-major precision the Gibbs draw builds for the unrolled
    solve is the reference's (rows, d, d) batch: both paths draw the same
    x from the same key."""
    rng = np.random.default_rng(4)
    rows, cols, d = 11, 7, 3
    mask = jnp.asarray(rng.random((rows, cols)) < 0.6)
    ratings = jnp.asarray(rng.normal(size=(rows, cols)), jnp.float32)
    other = jnp.asarray(rng.normal(size=(cols, d)), jnp.float32)
    mu = jnp.asarray(rng.normal(size=d), jnp.float32)
    alpha = jnp.asarray(_spd_batch(rng, 1, d)[0])
    args = (jax.random.PRNGKey(0), mask, ratings, other, mu, alpha, 2.0)
    want = bpmf_gibbs._sample_rows(*args)
    monkeypatch.setattr(chol_sample, "use_unrolled", lambda d: True)
    got = bpmf_gibbs._sample_rows(*args)
    assert got.shape == (rows, d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.gpu
def test_unrolled_on_gpu_matches_reference(gpu):
    """The unrolled solve as XLA compiles it for the card, at d = 20."""
    rng = np.random.default_rng(5)
    B, d = 8 * 306, 20
    S, rhs, z = _problem(rng, B, d)
    with jax.default_device(gpu):
        got = np.asarray(jax.jit(chol_sample.chol_solve_sample_unrolled)(
            jnp.asarray(_cols(S)), jnp.asarray(rhs.T), jnp.asarray(z.T))).T
    np.testing.assert_allclose(got, _reference(S, rhs, z), rtol=1e-4,
                               atol=1e-4)
