import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amf_tpu import types
from amf_tpu.data import make_fake_data
from amf_tpu.models import mnormal, pmf, vnormal
from amf_tpu.ops import moments


def _setup(rng, key, n=5, m=4, d=2):
    real, known, vals = make_fake_data(
        num_users=n, num_items=m, rank=d, mask_type=0.4, data_type=5, rng=rng
    )
    prob = types.problem_from_dense(real, known, dtype=jnp.float64)
    cfg = pmf.PMFConfig(latent_d=d, max_fit_steps=500)
    st = pmf.init_state(key, n, m, cfg, prob, dtype=jnp.float64)
    st, _ = pmf.fit(st, prob, cfg)
    return real, prob, cfg, st


def _numpy_kl(mean, cov, prob, st, n, m, d):
    """Oracle KL implementing active_pmf.kl_divergence:202-240 literally,
    with per-cell scalar moments."""
    u = np.arange(0, n * d).reshape(n, d).T
    v = np.arange(n * d, (n + m) * d).reshape(m, d).T
    mean = np.asarray(mean)
    cov = np.asarray(cov)
    rated = np.asarray(prob.rated)
    r_obs = np.asarray(prob.R_obs)

    def e_dot_sq(i, j):
        total = 0.0
        jm = jnp.asarray(mean)
        jc = jnp.asarray(cov)
        for k in range(d):
            total += float(moments.exp_squared(jm, jc, u[k, i], v[k, j]))
            for l in range(k + 1, d):
                total += 2 * float(
                    moments.quadexpect(jm, jc, u[k, i], v[k, j], u[l, i], v[l, j])
                )
        return total

    div = 0.0
    for i in range(n):
        for j in range(m):
            if not rated[i, j]:
                continue
            rij = r_obs[i, j]
            pm = (mean[u[:, i]] * mean[v[:, j]] + cov[u[:, i], v[:, j]]).sum()
            div += e_dot_sq(i, j) - 2 * rij * pm + rij**2
    div /= 2 * float(st.sigma_sq)

    us = u.reshape(-1)
    vs = v.reshape(-1)
    div += ((mean[us] ** 2).sum() + cov[us, us].sum()) / (2 * float(st.sigma_u_sq))
    div += ((mean[vs] ** 2).sum() + cov[vs, vs].sum()) / (2 * float(st.sigma_v_sq))
    _, logdet = np.linalg.slogdet(cov)
    return div - logdet / 2


def test_kl_matches_scalar_oracle(rng, key):
    real, prob, cfg, st = _setup(rng, key)
    vcfg = vnormal.VNConfig(latent_d=cfg.latent_d)
    vn = vnormal.initialize_approx(jax.random.PRNGKey(1), st, vcfg)
    got = float(vnormal.kl_divergence(vn, st, prob, vcfg))
    n, m = prob.shape
    want = _numpy_kl(vn.mean, vn.cov, prob, st, n, m, cfg.latent_d)
    assert got == pytest.approx(want, rel=1e-8)


def test_kl_gradient_finite_difference(rng, key):
    """Finite-difference check of the KL gradient — the reference's
    check-grad.ipynb methodology, automated."""
    real, prob, cfg, st = _setup(rng, key, n=3, m=3, d=1)
    vcfg = vnormal.VNConfig(latent_d=1)
    vn = vnormal.initialize_approx(jax.random.PRNGKey(1), st, vcfg)
    # use a well-conditioned covariance: near-singular spectra (min_eig=1e-5)
    # make the log-det term's curvature too large for finite differences
    from amf_tpu.ops.psd import project_psd

    vn = vnormal.VNState(
        mean=vn.mean, cov=project_psd(vn.cov, min_eig=1.0)
    )

    def kl_flat(mean, cov):
        return vnormal.kl_divergence(vn, st, prob, vcfg, mean=mean, cov=cov)

    gm, gc = jax.grad(kl_flat, argnums=(0, 1))(vn.mean, vn.cov)
    eps = 1e-6
    mean_np = np.asarray(vn.mean)
    for idx in [0, 2, 5]:
        e = np.zeros_like(mean_np)
        e[idx] = eps
        fd = (
            float(kl_flat(jnp.asarray(mean_np + e), vn.cov))
            - float(kl_flat(jnp.asarray(mean_np - e), vn.cov))
        ) / (2 * eps)
        assert float(gm[idx]) == pytest.approx(fd, rel=1e-4, abs=1e-5)

    # covariance: check the triangular-half convention (off-diag doubled)
    cov_np = np.asarray(vn.cov)
    tri = np.asarray(vnormal._tri_symmetrize(gc))
    for a, b in [(0, 0), (1, 3), (2, 4)]:
        e = np.zeros_like(cov_np)
        if a == b:
            e[a, a] = eps
        else:
            e[a, b] = eps
            e[b, a] = eps  # symmetric perturbation = triangular-half derivative
        fd = (
            float(kl_flat(vn.mean, jnp.asarray(cov_np + e)))
            - float(kl_flat(vn.mean, jnp.asarray(cov_np - e)))
        ) / (2 * eps)
        assert float(tri[a, b]) == pytest.approx(fd, rel=1e-4, abs=1e-5)


def test_fit_normal_decreases_kl_and_tracks_map(rng, key):
    real, prob, cfg, st = _setup(rng, key)
    vcfg = vnormal.VNConfig(latent_d=cfg.latent_d, max_fit_steps=800)
    vn = vnormal.initialize_approx(jax.random.PRNGKey(1), st, vcfg)
    kl0 = float(vnormal.kl_divergence(vn, st, prob, vcfg))
    vn2, info = vnormal.fit_normal(vn, st, prob, vcfg)
    kl1 = float(info.final_value)
    assert kl1 < kl0
    assert int(info.n_accepts) > 3
    # the fitted mean should stay in the same ballpark as the MAP factors
    assert float(vnormal.mean_meandiff(vn2, st)) < 2.0


def test_pred_variance_positive_and_mc(rng, key):
    real, prob, cfg, st = _setup(rng, key, n=3, m=3, d=2)
    vcfg = vnormal.VNConfig(latent_d=2, max_fit_steps=500)
    vn = vnormal.initialize_approx(jax.random.PRNGKey(1), st, vcfg)
    vn, _ = vnormal.fit_normal(vn, st, prob, vcfg)
    pm, pv = vnormal.approx_pred_means_vars(vn, prob, vcfg)
    assert np.all(np.asarray(pv) > 0)
    # MC check of mean/var from the fitted normal
    rng2 = np.random.default_rng(0)
    s = rng2.multivariate_normal(np.asarray(vn.mean), np.asarray(vn.cov), 200_000)
    n, m, d = 3, 3, 2
    U = s[:, : n * d].reshape(-1, n, d)
    V = s[:, n * d :].reshape(-1, m, d)
    preds = np.einsum("sik,sjk->sij", U, V)
    np.testing.assert_allclose(np.asarray(pm), preds.mean(0), rtol=0.1, atol=0.1)
    np.testing.assert_allclose(np.asarray(pv), preds.var(0), rtol=0.1, atol=0.1)


# ---------------------------------------------------------------------------
# matrix-normal


def test_mn_kl_gradient_finite_difference(rng, key):
    real, prob, cfg, st = _setup(rng, key, n=4, m=3, d=2)
    mcfg = mnormal.MNConfig(latent_d=2)
    mn = mnormal.initialize_approx(st, mcfg)

    def kl(mean, Sr, Sc):
        return mnormal.kl_divergence(
            mn, st, prob, mcfg, mean=mean, cov_useritems=Sr, cov_latents=Sc
        )

    gm, gr, gc = jax.grad(kl, argnums=(0, 1, 2))(
        mn.mean, mn.cov_useritems, mn.cov_latents
    )
    eps = 1e-6
    # mean entries
    mean_np = np.asarray(mn.mean)
    e = np.zeros_like(mean_np)
    e[1, 0] = eps
    fd = (
        float(kl(jnp.asarray(mean_np + e), mn.cov_useritems, mn.cov_latents))
        - float(kl(jnp.asarray(mean_np - e), mn.cov_useritems, mn.cov_latents))
    ) / (2 * eps)
    assert float(gm[1, 0]) == pytest.approx(fd, rel=1e-4, abs=1e-6)

    # row-cov off-diagonal, triangular-half convention
    tri = np.asarray(mnormal._tri_symmetrize(gr))
    Sr_np = np.asarray(mn.cov_useritems)
    e = np.zeros_like(Sr_np)
    e[0, 2] = eps
    e[2, 0] = eps
    fd = (
        float(kl(mn.mean, jnp.asarray(Sr_np + e), mn.cov_latents))
        - float(kl(mn.mean, jnp.asarray(Sr_np - e), mn.cov_latents))
    ) / (2 * eps)
    assert float(tri[0, 2]) == pytest.approx(fd, rel=1e-4, abs=1e-6)


def test_mn_fit_decreases_kl(rng, key):
    real, prob, cfg, st = _setup(rng, key, n=6, m=5, d=2)
    mcfg = mnormal.MNConfig(latent_d=2, max_fit_steps=800)
    mn = mnormal.initialize_approx(st, mcfg)
    kl0 = float(mnormal.kl_divergence(mn, st, prob, mcfg))
    mn2, info = mnormal.fit_normal(mn, st, prob, mcfg)
    assert float(info.final_value) < kl0
    pm, pv = mnormal.approx_pred_means_vars(mn2, prob)
    assert np.all(np.asarray(pv) > 0)
    assert np.all(np.isfinite(np.asarray(pm)))


def test_mn_matches_vn_for_kron_cov(rng, key):
    """MN KL == VN KL when the VN covariance is the matching Kronecker
    product (consistency between the two approximation layers)."""
    real, prob, cfg, st = _setup(rng, key, n=3, m=2, d=2)
    mcfg = mnormal.MNConfig(latent_d=2)
    mn = mnormal.initialize_approx(st, mcfg, key=jax.random.PRNGKey(2), random_cov=True)
    vcfg = vnormal.VNConfig(latent_d=2)
    full_cov = jnp.kron(mn.cov_useritems, mn.cov_latents)
    vn = vnormal.VNState(mean=mn.mean.reshape(-1), cov=full_cov)
    got_mn = float(mnormal.kl_divergence(mn, st, prob, mcfg))
    got_vn = float(vnormal.kl_divergence(vn, st, prob, vcfg))
    assert got_mn == pytest.approx(got_vn, rel=1e-8)


def test_fit_normal_chol_matches_psd_project_fixpoint(rng, key):
    """The Cholesky-factor fast path (VNConfig cov_param="chol") minimizes
    the same KL as the projected-descent parity path: from the same init,
    both must descend, and the chol endpoint's KL must be at least as good
    as (or within a small tolerance of) the projected path's at an equal
    step budget. The trajectory is allowed to differ (documented non-parity
    fast path; PARITY.md)."""
    real, prob, cfg, st = _setup(rng, key)
    base = vnormal.VNConfig(latent_d=cfg.latent_d, max_fit_steps=800)
    vn0 = vnormal.initialize_approx(jax.random.PRNGKey(1), st, base)
    kl0 = float(vnormal.kl_divergence(vn0, st, prob, base))

    vn_p, info_p = vnormal.fit_normal(vn0, st, prob, base)
    vn_c, info_c = vnormal.fit_normal(
        vn0, st, prob, base._replace(cov_param="chol")
    )
    kl_p = float(vnormal.kl_divergence(vn_p, st, prob, base))
    kl_c = float(vnormal.kl_divergence(vn_c, st, prob, base))
    assert kl_c < kl0
    assert int(info_c.n_accepts) > 3
    # equal-footing endpoint quality: within 2% of the projected path
    # (both stop on the same stop_thresh rule)
    assert kl_c <= kl_p + 0.02 * abs(kl_p), (kl_c, kl_p, kl0)
    # the returned covariance is PSD with the configured floor
    evals = np.linalg.eigvalsh(np.asarray(vn_c.cov))
    assert evals.min() >= base.min_eig * 0.5


def test_lookahead_scores_chol_budget_stable_and_lower_kl(rng, key):
    """Characterize the chol fast path at the lookahead level.

    Measured (8x7 d=2): the
    projected-descent parity path STALLS — its total-variance scores are
    byte-identical at 400 and 3000 proposal budgets (the adaptive LR
    collapses after projection-spoiled proposals and the stop rule fires
    at a high-KL endpoint, median score ~700), while the chol path reaches
    far lower KL endpoints (median ~200) with a candidate ranking that is
    budget-STABLE (tau(chol@400, chol@3000) = 1.0). The two paths select
    differently (tau ~ 0.18) — that is the documented PARITY.md deviation,
    so the asserts here pin the chol path's own guarantees: budget-stable
    ranking + systematically-lower KL refit endpoints."""
    from amf_tpu.active.criteria import KEY_FUNCS
    from amf_tpu.active.lookahead import (
        LookaheadConfig, lookahead_scores, vn_adapter)
    from scipy import stats as sps
    from amf_tpu.data import make_fake_data

    real, known, _ = make_fake_data(
        num_users=8, num_items=7, rank=2, mask_type=0.2, data_type=5,
        rng=rng)
    prob = types.problem_from_dense(real, known, dtype=jnp.float64)
    cfg = pmf.PMFConfig(latent_d=2, max_fit_steps=300)
    st = pmf.init_state(key, 8, 7, cfg, prob, dtype=jnp.float64)
    st, _ = pmf.fit(st, prob, cfg)
    crit = KEY_FUNCS["total-variance"]

    def run(mode, budget):
        vcfg = vnormal.VNConfig(latent_d=2, max_fit_steps=budget,
                                cov_param=mode)
        vn = vnormal.initialize_approx(jax.random.PRNGKey(1), st, vcfg)
        vn, _ = vnormal.fit_normal(vn, st, prob, vcfg)
        lcfg = LookaheadConfig(
            rating_values=(), refit_lookahead=True,
            pmf_refit_steps=50, approx_refit_steps=budget,
            n_integration_nodes=8)
        return np.asarray(lookahead_scores(
            crit, st, vn, prob, jax.random.PRNGKey(7), cfg,
            vn_adapter(vcfg), lcfg))

    c300 = run("chol", 300)
    c600 = run("chol", 600)
    p600 = run("psd-project", 600)

    sel = np.isfinite(c300) & np.isfinite(c600) & np.isfinite(p600)
    assert sel.sum() >= 15, sel.sum()
    # ranking is budget-stable for the chol path
    tau_budget = sps.kendalltau(c300[sel], c600[sel])[0]
    assert tau_budget > 0.9, tau_budget
    # chol refit endpoints carry systematically lower posterior variance
    # (deeper KL minima) than the stalled projected path
    assert np.median(c600[sel]) < np.median(p600[sel]), (
        np.median(c600[sel]), np.median(p600[sel]))
