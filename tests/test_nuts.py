"""NUTS correctness: posterior-summary agreement on analytically known
targets (the validation methodology SURVEY.md prescribes for the Stan
replacement)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amf_tpu.mcmc import nuts


def test_std_normal_1d(key):
    logp = lambda q: -0.5 * jnp.sum(q**2)
    samples, info = nuts.run_nuts(
        key, jnp.zeros(1), logp, num_samples=2000, warmup=500
    )
    s = np.asarray(samples).ravel()
    assert abs(s.mean()) < 0.1
    assert s.std() == pytest.approx(1.0, abs=0.1)
    assert float(np.asarray(info.diverging).mean()) < 0.01


def test_correlated_gaussian(key):
    rng = np.random.default_rng(0)
    d = 4
    a = rng.normal(size=(d, d))
    cov = a @ a.T + 0.5 * np.eye(d)
    prec = jnp.asarray(np.linalg.inv(cov))
    mu = jnp.asarray(rng.normal(size=d))

    def logp(q):
        z = q - mu
        return -0.5 * z @ prec @ z

    samples, info = nuts.run_nuts(
        key, jnp.zeros(d), logp, num_samples=4000, warmup=1000
    )
    s = np.asarray(samples)
    np.testing.assert_allclose(s.mean(0), np.asarray(mu), atol=0.25)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.5, rtol=0.25)
    # healthy sampler: acceptance near target, very few divergences
    assert 0.5 < float(np.asarray(info.accept_prob).mean()) <= 1.0
    assert float(np.asarray(info.diverging).mean()) < 0.02


def test_anisotropic_needs_mass_adaptation(key):
    """Scales differing by 100x: without mass adaptation this would need tiny
    steps; the adapted diagonal mass should recover both scales."""
    scales = jnp.asarray([0.1, 10.0])

    def logp(q):
        return -0.5 * jnp.sum((q / scales) ** 2)

    samples, info = nuts.run_nuts(
        key, jnp.zeros(2), logp, num_samples=3000, warmup=1000
    )
    s = np.asarray(samples)
    np.testing.assert_allclose(s.std(0), np.asarray(scales), rtol=0.2)


def test_banana_no_nans(key):
    """Rosenbrock-ish target: just assert stability (finite, low divergence)."""

    def logp(q):
        x, y = q[0], q[1]
        return -0.5 * (x**2 / 4 + (y - x**2) ** 2)

    samples, info = nuts.run_nuts(
        key, jnp.asarray([0.1, 0.1]), logp, num_samples=1500, warmup=800
    )
    assert np.isfinite(np.asarray(samples)).all()
    assert float(np.asarray(info.num_leaves).mean()) > 3


def test_vmapped_chains(key):
    """Chains must vmap (the device-parallel replacement for Stan's process-parallel
    chains, stan-bpmf/bpmf.py:314)."""
    logp = lambda q: -0.5 * jnp.sum(q**2)
    keys = jax.random.split(key, 4)
    samples, info = jax.vmap(
        lambda k: nuts.run_nuts(k, jnp.zeros(3), logp, 500, 300)
    )(keys)
    s = np.asarray(samples)
    assert s.shape == (4, 500, 3)
    pooled = s.reshape(-1, 3)
    assert abs(pooled.mean()) < 0.1
    assert pooled.std() == pytest.approx(1.0, abs=0.12)


def test_find_reasonable_step_size(key):
    logp = lambda q: -0.5 * jnp.sum(q**2)
    eps = nuts.find_reasonable_step_size(key, jnp.zeros(5), logp, jnp.ones(5))
    assert 0.01 < float(eps) < 10.0


def test_sampler_diagnostics_on_nuts_chains(key):
    """ESS / split-R-hat (analysis.metrics) certify the native sampler's
    quality on a known target: well-mixed NUTS chains on a standard normal
    should show R-hat ~ 1 and a healthy fraction of nominal ESS, while a
    deliberately unmixed pair of chains is flagged."""
    from amf_tpu.analysis import metrics

    logp = lambda q: -0.5 * jnp.sum(q**2)
    keys = jax.random.split(key, 4)
    samples, _ = jax.vmap(
        lambda k: nuts.run_nuts(k, jnp.zeros(3), logp, 400, 300)
    )(keys)
    draws = np.asarray(samples)  # (chains, n, dim)
    rhat = metrics.split_rhat(draws)
    assert np.all(rhat < 1.05), rhat
    e = metrics.ess(draws)
    assert np.all(e > 0.25 * draws.shape[0] * draws.shape[1]), e

    # two "chains" sampling different modes -> R-hat far from 1
    bad = np.stack([draws[0, :, 0], draws[1, :, 0] + 10.0])
    assert metrics.split_rhat(bad) > 1.5
    # a random walk has tiny ESS relative to its length
    rw = np.cumsum(np.asarray(jax.random.normal(key, (2, 400))), axis=1)
    assert metrics.ess(rw) < 100


def test_funnel_chain_keeps_moving(key):
    """Regression guard for the frozen-chain pathology fixed in round 3
    (PARITY.md "Regression adjudication" #2): on funnel-shaped
    targets the accept-vs-eps curve is non-monotone and accept-targeting
    dual averaging drove eps to ~4e-5, freezing the chain in place; the
    ESJD-grid warmup must keep the chain traveling. Assert actual
    movement, not just acceptance: mean squared jump per transition and
    across-draw spread in both the neck and base coordinates."""
    def logp(q):
        # Neal's funnel (d=8): v ~ N(0, 3^2); x_i | v ~ N(0, e^v)
        v, x = q[0], q[1:]
        return (
            -0.5 * (v / 3.0) ** 2
            - 0.5 * jnp.sum(x**2) * jnp.exp(-v)
            - 0.5 * (q.shape[0] - 1) * v
        )

    samples, info = nuts.run_nuts(
        key, jnp.zeros(8), logp, num_samples=600, warmup=400
    )
    s = np.asarray(samples)
    jumps = np.sum(np.diff(s, axis=0) ** 2, axis=1)
    assert jumps.mean() > 0.5, jumps.mean()   # frozen chains gave ~1e-4
    assert s[:, 0].std() > 1.0, s[:, 0].std()  # v spread (true sd = 3)
    assert np.isfinite(s).all()


def test_warm_start_adaptation(key):
    """eps_anchor + init_inv_mass warm-start: a short-warmup chain carrying
    the adaptation of a previous run on the same target matches the
    posterior as well as a full cold warmup (the active-loop refit case)."""
    scales = jnp.asarray([0.1, 1.0, 10.0])
    logp = lambda q: -0.5 * jnp.sum((q / scales) ** 2)
    k1, k2 = jax.random.split(key)
    _, _, adapt = nuts.run_nuts(
        k1, jnp.zeros(3), logp, num_samples=500, warmup=300,
        return_adaptation=True,
    )
    assert adapt["inv_mass"].shape == (3,)
    samples, info = nuts.run_nuts(
        k2, jnp.zeros(3), logp, num_samples=1500, warmup=30,
        eps_anchor=adapt["eps"], init_inv_mass=adapt["inv_mass"],
    )
    s = np.asarray(samples)
    np.testing.assert_allclose(s.std(0), np.asarray(scales), rtol=0.25)
    assert float(np.asarray(info.diverging).mean()) < 0.05
