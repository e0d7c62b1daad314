import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amf_tpu import types
from amf_tpu.data import make_fake_data
from amf_tpu.models import pmf


def _problem(rng, n=15, m=12, rank=3, noise=0.1, mask=0.5):
    real, known, _ = make_fake_data(
        num_users=n, num_items=m, rank=rank, noise=noise, mask_type=mask, rng=rng
    )
    return real, types.problem_from_dense(real, known, dtype=jnp.float64)


def _numpy_ll(U, V, real, rated, sigma_sq=1.0, su=10.0, sv=10.0):
    pred = U @ V.T
    err = np.where(rated, real - pred, 0.0)
    return (
        -np.sum(err**2) / (2 * sigma_sq)
        - np.sum(U * U) / (2 * su)
        - np.sum(V * V) / (2 * sv)
    )


def test_log_likelihood_matches_numpy(rng, key):
    real, prob = _problem(rng)
    cfg = pmf.PMFConfig(latent_d=3)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    got = float(pmf.log_likelihood(st, prob, cfg))
    want = _numpy_ll(np.asarray(st.U), np.asarray(st.V), real, np.asarray(prob.rated))
    assert got == pytest.approx(want, rel=1e-10)


def test_gradient_matches_autodiff(rng, key):
    real, prob = _problem(rng)
    cfg = pmf.PMFConfig(latent_d=3)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    gu, gv = pmf.gradient(st, prob, cfg)
    agu, agv = jax.grad(
        lambda u, v: pmf.log_likelihood(st, prob, cfg, U=u, V=v), argnums=(0, 1)
    )(st.U, st.V)
    np.testing.assert_allclose(np.asarray(gu), np.asarray(agu), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(agv), rtol=1e-8)


def test_fit_improves_ll_and_rmse(rng, key):
    real, prob = _problem(rng, noise=0.05, mask=0.6)
    cfg = pmf.PMFConfig(latent_d=3)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    ll0 = float(pmf.log_likelihood(st, prob, cfg))
    st2, info = pmf.fit(st, prob, cfg)
    ll1 = float(pmf.log_likelihood(st2, prob, cfg))
    assert ll1 > ll0
    assert int(info.n_accepts) > 5
    # training rmse should be small on observed entries
    train_rmse = float(pmf.rmse(st2, prob, cfg, real, on=prob.rated))
    assert train_rmse < 0.5


def test_fit_matches_reference_trajectory_semantics(rng, key):
    """Replicate the reference fit_lls loop in numpy on identical inputs and
    check the compiled loop reproduces the same accept/reject trajectory
    (reference: pmf.py:179-211)."""
    real, prob = _problem(rng, n=8, m=6)
    cfg = pmf.PMFConfig(latent_d=2, max_fit_steps=4000)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)

    U = np.asarray(st.U).copy()
    V = np.asarray(st.V).copy()
    rated = np.asarray(prob.rated)
    r_obs = np.asarray(prob.R_obs)

    def ll(u, v):
        return _numpy_ll(u, v, r_obs, rated)

    def grad(u, v):
        resid = np.where(rated, r_obs - u @ v.T, 0.0)
        return resid @ v - u / 10.0, resid.T @ u - v / 10.0

    lr = cfg.learning_rate
    old_ll = ll(U, V)
    converged = False
    iters = 0
    while not converged and iters < cfg.max_fit_steps:
        gu, gv = grad(U, V)
        while not converged:
            iters += 1
            nu, nv = U + lr * gu, V + lr * gv
            new_ll = ll(nu, nv)
            if new_ll > old_ll:
                U, V = nu, nv
                lr *= 1.25
                if new_ll - old_ll < cfg.stop_thresh:
                    converged = True
                old_ll = new_ll
                break
            else:
                lr *= 0.5
                if lr < cfg.min_learning_rate:
                    converged = True
                    break
            if iters >= cfg.max_fit_steps:
                converged = True

    st2, info = pmf.fit(st, prob, cfg)
    np.testing.assert_allclose(np.asarray(st2.U), U, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st2.V), V, rtol=1e-9, atol=1e-12)


def test_fit_is_jit_and_vmap_safe(rng, key):
    real, prob = _problem(rng, n=6, m=5)
    cfg = pmf.PMFConfig(latent_d=2, max_fit_steps=300)
    keys = jax.random.split(key, 4)
    states = jax.vmap(
        lambda k: pmf.init_state(k, *prob.shape, cfg, prob, dtype=jnp.float64)
    )(keys)
    fitted = jax.jit(
        jax.vmap(lambda s: pmf.fit(s, prob, cfg)[0])
    )(states)
    lls = jax.vmap(lambda s: pmf.log_likelihood(s, prob, cfg))(fitted)
    assert np.all(np.isfinite(np.asarray(lls)))


def test_update_sigma(rng, key):
    real, prob = _problem(rng)
    cfg = pmf.PMFConfig(latent_d=3)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    st2, _ = pmf.fit(st, prob, cfg)
    st3 = pmf.update_sigma(st2, prob, cfg)
    pred = np.asarray(pmf.predicted_matrix(st2, cfg))
    rated = np.asarray(prob.rated)
    want = np.sum(np.where(rated, np.asarray(prob.R_obs) - pred, 0) ** 2) / rated.sum()
    assert float(st3.sigma_sq) == pytest.approx(want, rel=1e-8)
    st4 = pmf.update_sigma_uv(st3, prob, cfg)
    n, m = prob.shape
    assert float(st4.sigma_u_sq) == pytest.approx(
        float(np.sum(np.asarray(st2.U) ** 2)) / (n * 3), rel=1e-8
    )


def test_fit_with_sigmas_runs(rng, key):
    real, prob = _problem(rng, n=8, m=8)
    cfg = pmf.PMFConfig(latent_d=2, max_fit_steps=500)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    st2 = pmf.fit_with_sigmas(st, prob, cfg, max_outer=5)
    assert float(st2.sigma_sq) > 0
    assert np.isfinite(float(pmf.log_likelihood(st2, prob, cfg)))


def test_minibatch_fit(rng, key):
    real, prob = _problem(rng, n=20, m=15, mask=0.7, noise=0.05)
    cfg = pmf.PMFConfig(latent_d=3)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    st2 = pmf.fit_minibatches_until_validation(
        st, prob, cfg, key, batch_size=32, valid_size=20, lr=0.2, max_epochs=100
    )
    r0 = float(pmf.rmse(st, prob, cfg, real, on=prob.rated))
    r1 = float(pmf.rmse(st2, prob, cfg, real, on=prob.rated))
    assert r1 < r0


def test_parse_fit_type():
    assert pmf.parse_fit_type("batch") == ("batch",)
    assert pmf.parse_fit_type("mini-valid,100,50") == ("mini-valid", 100, 50)
    assert pmf.parse_fit_type("mini-valid,100,50,0.5") == ("mini-valid", 100, 50, 0.5)


def test_fit_lbfgs_reaches_map(rng, key):
    """L-BFGS fit must reach at least the adaptive-LR fit's log likelihood
    (same MAP objective, faster optimizer)."""
    real, prob = _problem(rng, n=15, m=12, noise=0.05, mask=0.6)
    cfg = pmf.PMFConfig(latent_d=3)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    st_grad, _ = pmf.fit(st, prob, cfg)
    st_lbfgs = pmf.fit_lbfgs(st, prob, cfg, max_iters=400)
    ll_grad = float(pmf.log_likelihood(st_grad, prob, cfg))
    ll_lbfgs = float(pmf.log_likelihood(st_lbfgs, prob, cfg))
    assert ll_lbfgs >= ll_grad - 1e-3
    # dispatch through the fit-type DSL
    st_dsl = pmf.do_fit(st, prob, cfg, fit_type=pmf.parse_fit_type("lbfgs,200"))
    assert float(pmf.log_likelihood(st_dsl, prob, cfg)) >= ll_grad - 1e-2


def test_poly_ls_quartic_is_exact(rng, key):
    """The improvement polynomial (pmf._delta_poly) must equal the directly
    evaluated f(0) - f(alpha) along the ascent ray, for any alpha — the
    exactness adaptive_descent_poly's closed-form ladder walk relies on."""
    real, prob = _problem(rng, n=10, m=9)
    cfg = pmf.PMFConfig(latent_d=3, subtract_mean=True)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    st = pmf.refresh_mean_rating(st, prob)
    gu, gv = pmf.gradient(st, prob, cfg)
    c1, c2, c3, c4 = pmf._delta_poly(st, prob, cfg, (st.U, st.V), (gu, gv))

    def f(alpha):
        return float(-pmf.log_likelihood(
            st, prob, cfg, U=st.U + alpha * gu, V=st.V + alpha * gv))

    f0 = f(0.0)
    for alpha in (1e-6, 1e-4, 3e-3, 0.1, 1.7):
        delta = float(
            alpha * (c1 + alpha * (c2 + alpha * (c3 + alpha * c4))))
        np.testing.assert_allclose(f0 - f(alpha), delta, rtol=1e-8, atol=1e-10)


def test_poly_ls_matches_plain_trajectory(rng, key):
    """In float64 the polynomial line search reproduces the plain
    accept/reject trajectory bit-for-bit (same exact quartic, no rounding
    flips at f64 precision on this scale)."""
    real, prob = _problem(rng, n=12, m=10, noise=0.05, mask=0.5)
    cfg = pmf.PMFConfig(latent_d=3, max_fit_steps=800)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    st_a, ia = pmf.fit(st, prob, cfg)
    st_b, ib = pmf.fit(st, prob, cfg, poly_ls=True)
    assert int(ia.n_iters) == int(ib.n_iters)
    assert int(ia.n_accepts) == int(ib.n_accepts)
    np.testing.assert_allclose(np.asarray(st_b.U), np.asarray(st_a.U),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(st_b.V), np.asarray(st_a.V),
                               rtol=1e-12, atol=1e-14)


def test_poly_ls_vmap_safe(rng, key):
    """poly_ls refits must vmap over hypothesized ratings (the lookahead
    fan-out pattern) and agree with the per-lane plain fits."""
    real, prob = _problem(rng, n=8, m=7, mask=0.6)
    cfg = pmf.PMFConfig(latent_d=2, max_fit_steps=120)
    st = pmf.init_state(key, *prob.shape, cfg, prob, dtype=jnp.float64)
    st, _ = pmf.fit(st, prob, cfg)
    qi, qj = np.nonzero(np.asarray(prob.queryable))
    ii, jj = jnp.asarray(qi[:5]), jnp.asarray(qj[:5])
    vv = jnp.full((5,), 2.0, jnp.float64)

    def one(i, j, v, poly):
        prob2 = prob.add_rating(i, j, v)
        st2, _ = pmf.fit(st, prob2, cfg, max_steps=60, poly_ls=poly)
        return st2.U, st2.V

    U_a, V_a = jax.vmap(lambda i, j, v: one(i, j, v, False))(ii, jj, vv)
    U_b, V_b = jax.vmap(lambda i, j, v: one(i, j, v, True))(ii, jj, vv)
    np.testing.assert_allclose(np.asarray(U_b), np.asarray(U_a),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(V_b), np.asarray(V_a),
                               rtol=1e-10, atol=1e-12)


def test_reference_matches_pmf_gradient(rng):
    """The batched value-and-gradient agrees with models.pmf.gradient and
    log_likelihood on each lane's own problem."""
    L, n, m, d = 3, 12, 9, 4
    U = jnp.asarray(rng.normal(size=(L, n, d)), jnp.float32)
    V = jnp.asarray(rng.normal(size=(L, m, d)), jnp.float32)
    R = jnp.asarray(rng.integers(1, 6, size=(n, m)), jnp.float32)
    rated = jnp.asarray(rng.random((n, m)) < 0.4)
    di = jnp.asarray(rng.integers(0, n, L), jnp.int32)
    dj = jnp.asarray(rng.integers(0, m, L), jnp.int32)
    dv = jnp.asarray(rng.integers(1, 6, L), jnp.float32)
    sigmas = jnp.asarray([1.0, 10.0, 10.0], jnp.float32)
    neg_ll, gu, gv = pmf.batched_value_grad(U, V, R, rated, di, dj, dv,
                                            sigmas)
    cfg = pmf.PMFConfig(latent_d=d)
    for lane in range(L):
        prob = types.Problem(
            R_obs=R.at[di[lane], dj[lane]].set(dv[lane]),
            rated=rated.at[di[lane], dj[lane]].set(True),
            queryable=jnp.zeros_like(rated),
            test=rated,
        )
        st = pmf.PMFState(
            U=U[lane], V=V[lane],
            sigma_sq=sigmas[0], sigma_u_sq=sigmas[1], sigma_v_sq=sigmas[2],
            mean_rating=jnp.float32(0),
        )
        want_gu, want_gv = pmf.gradient(st, prob, cfg)
        want_ll = -pmf.log_likelihood(st, prob, cfg)
        np.testing.assert_allclose(np.asarray(gu[lane]), np.asarray(want_gu),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(gv[lane]), np.asarray(want_gv),
                                   rtol=1e-5, atol=1e-5)
        assert float(neg_ll[lane]) == pytest.approx(float(want_ll), rel=1e-5)


@pytest.mark.parametrize("n, m", [(12, 8), (13, 9)])
def test_fit_lookahead_batch_matches_per_lane_fit(rng, n, m):
    """Each lane of the batched refit follows pmf.fit on its own
    add_rating problem: same accept/reject trajectory, same factors."""
    d = 3
    R = jnp.asarray(rng.integers(1, 6, size=(n, m)), jnp.float32)
    rated = jnp.asarray(rng.random((n, m)) < 0.5)
    prob = types.Problem(R_obs=jnp.where(rated, R, 0.0), rated=rated,
                         queryable=~rated, test=rated)
    cfg = pmf.PMFConfig(latent_d=d)
    st = pmf.init_state(jax.random.PRNGKey(0), n, m, cfg, prob,
                        dtype=jnp.float32)
    st, _ = pmf.fit(st, prob, cfg, max_steps=50)
    di = jnp.asarray([0, n // 2, n - 1], jnp.int32)
    dj = jnp.asarray([1, m - 1, 0], jnp.int32)
    dv = jnp.asarray([3.0, 1.0, 5.0], jnp.float32)
    steps = 30
    U, V, f = pmf.fit_lookahead_batch(st, prob, di, dj, dv, cfg,
                                      max_steps=steps)
    assert U.shape == (3, n, d) and V.shape == (3, m, d) and f.shape == (3,)
    for lane in range(3):
        prob_l = prob.add_rating(di[lane], dj[lane], dv[lane])
        want, _ = pmf.fit(st, prob_l, cfg, max_steps=steps)
        np.testing.assert_allclose(np.asarray(U[lane]), np.asarray(want.U),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(np.asarray(V[lane]), np.asarray(want.V),
                                   rtol=1e-3, atol=1e-4)
        want_f = -pmf.log_likelihood(want, prob_l, cfg)
        assert float(f[lane]) == pytest.approx(float(want_f), rel=1e-4)
