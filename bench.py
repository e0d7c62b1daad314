#!/usr/bin/env python3
"""Benchmark: registry-criterion lookahead throughput (BASELINE.json north
star). Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Headline — ``exp-variance`` (a reference CLI key, python-pmf/bayes_pmf.py
KEYS :660-670) at the MovieLens-100k shape (943 x 1682, ~5% seed, d=10):
per candidate the engine hypothesizes each of the 5 rating values, refits
the MAP, runs a fresh 30-sample Gibbs chain, and integrates total predictive
variance under Dirichlet-smoothed histogram weights — exactly the
reference's hot loop (bayes_pmf.exp_variance :457-468 ->
_integrate_lookahead :560-598), which it fans over a multiprocessing.Pool.

``vs_baseline`` is a measured pool running the same per-lane numpy Gibbs
chain (reference sample_feature/samples semantics, bayes_pmf.py:189-302);
the JSON also reports the pool worker count so the ratio can be rescaled.

Secondary rows: the vn ``total-variance`` lookahead criterion
(active_pmf.py:612-633 semantics, with approx refit) on a shape the
full-covariance model supports.

Runs on a GPU only: with none, it exits non-zero and prints no result.
"""

import json
import multiprocessing
import time

import numpy as np

# ---- headline workload (Gibbs exp-variance @ ML-100k shape) ----
N, M, D = 943, 1682, 10
VALS = (1.0, 2.0, 3.0, 4.0, 5.0)
N_CAND = 256
TILE = 32  # candidates per device program (x5 value lanes)
BASE_SAMPS = 128
LA_SAMPS = 30

_G = {}


def _pool_init(U0, V0, rated, r_obs, beta):
    _G.update(U0=U0, V0=V0, rated=rated, r_obs=r_obs, beta=beta)


def _np_sample_hyper(rng, F):
    """Reference sample_hyperparam (bayes_pmf.py:157-186) in numpy."""
    n, d = F.shape
    xb = F.mean(0)
    Sb = np.cov(F.T) if n > 1 else np.eye(d)
    wi = np.linalg.inv(np.eye(d) + n * Sb + (2.0 * n) / (2.0 + n)
                       * np.outer(-xb, -xb))
    wi = (wi + wi.T) / 2
    dof = d + n
    L = np.linalg.cholesky(wi)
    A = L @ rng.normal(size=(d, dof))
    alpha = A @ A.T
    mu = (n * xb) / (2.0 + n) + np.linalg.cholesky(
        np.linalg.inv((2.0 + n) * alpha)) @ rng.normal(size=d)
    return mu, alpha


def _np_sample_rows(rng, mask, r, other, mu, alpha, beta):
    """Reference sample_feature (bayes_pmf.py:189-216): one row at a time."""
    rows, d = mask.shape[0], other.shape[1]
    out = np.empty((rows, d))
    am = alpha @ mu
    for i in range(rows):
        idx = np.flatnonzero(mask[i])
        Vo = other[idx]
        S = alpha + beta * Vo.T @ Vo
        rhs = beta * (r[i, idx] @ Vo) + am
        L = np.linalg.cholesky(S)
        mean = np.linalg.solve(L.T, np.linalg.solve(L, rhs))
        out[i] = mean + np.linalg.solve(L.T, rng.normal(size=d))
    return out


def _pool_gibbs_lane(args):
    """One (candidate, value) lookahead lane: 30-sample chain + total var
    (the reference worker body, bayes_pmf.py:560-598)."""
    i, j, v, seed = args
    rng = np.random.default_rng(seed)
    rated = _G["rated"].copy()
    r = _G["r_obs"].copy()
    rated[i, j] = True
    r[i, j] = v
    U, V = _G["U0"].copy(), _G["V0"].copy()
    beta = _G["beta"]
    n, m = r.shape
    s1 = np.zeros((n, m))
    s2 = np.zeros((n, m))
    for _ in range(LA_SAMPS):
        mu_u, al_u = _np_sample_hyper(rng, U)
        mu_v, al_v = _np_sample_hyper(rng, V)
        for _ in range(2):  # num_gibbs
            U = _np_sample_rows(rng, rated, r, V, mu_u, al_u, beta)
            V = _np_sample_rows(rng, rated.T, r.T, U, mu_v, al_v, beta)
        pred = U @ V.T
        s1 += pred
        s2 += pred * pred
    var = s2 / LA_SAMPS - (s1 / LA_SAMPS) ** 2
    return float(var.sum())


def bench_gibbs_exp_variance(jax, jnp, prob, vals):
    from amf_tpu.models import bpmf_gibbs, pmf
    from amf_tpu.types import rating_bounds

    pcfg = pmf.PMFConfig(latent_d=D, subtract_mean=True)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=D, subtract_mean=True)
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    pst = pmf.init_state(k1, N, M, pcfg, problem=prob, dtype=jnp.float32)
    pst, _ = pmf.fit(pst, prob, pcfg)
    chain = bpmf_gibbs.init_chain(pst)
    bounds = tuple(rating_bounds(vals))
    _, stats, _ = bpmf_gibbs.run_chain(
        k2, chain, prob, gcfg, BASE_SAMPS, value_bounds=bounds)
    jax.block_until_ready(stats.var)

    @jax.jit
    def tile_scores(k, cand):
        return bpmf_gibbs.exp_variance_scores(
            k, pst, prob, pcfg, gcfg, stats, vals,
            num_samps=LA_SAMPS, n_base_samples=BASE_SAMPS, cand=cand)

    cand_all = np.flatnonzero(np.asarray(prob.queryable).ravel())
    cand_all = cand_all[:N_CAND].astype(np.int32)
    chunks = [jnp.asarray(cand_all[t:t + TILE])
              for t in range(0, N_CAND, TILE)]
    jax.block_until_ready(tile_scores(k3, chunks[0]))  # compile

    t0 = time.perf_counter()
    outs = [tile_scores(k3, c) for c in chunks]
    jax.block_until_ready(outs)
    e2e_rate = N_CAND / (time.perf_counter() - t0)

    # device-only: 3 dependence-chained sweeps of one tile in one program
    # (the difference vs one sweep cancels the host dispatch)
    def tile_rep(k, cand, reps):
        def body(c, _):
            s = tile_scores(jax.random.fold_in(k, c.astype(jnp.int32)), cand)
            return jnp.nansum(s).astype(jnp.float32), None
        out, _ = jax.lax.scan(body, jnp.float32(0), None, length=reps)
        return out

    r1 = jax.jit(lambda k, c: tile_rep(k, c, 1))
    r3 = jax.jit(lambda k, c: tile_rep(k, c, 3))
    jax.block_until_ready(r1(k3, chunks[0]))
    jax.block_until_ready(r3(k3, chunks[0]))
    t0 = time.perf_counter()
    jax.block_until_ready(r1(k3, chunks[0]))
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(r3(k3, chunks[0]))
    t3 = time.perf_counter() - t0
    dev_rate = TILE / max((t3 - t1) / 2, 1e-9)

    # ---- measured reference-style pool baseline ----
    U0 = np.asarray(pst.U, np.float64)
    V0 = np.asarray(pst.V, np.float64)
    rated = np.asarray(prob.rated)
    r_obs = np.asarray(prob.R_obs, np.float64)
    procs = min(multiprocessing.cpu_count(), 16)
    # one (cand, value) lane per task; a candidate costs len(VALS) lanes
    lanes = [(int(c) // M, int(c) % M, VALS[t % len(VALS)], t)
             for t, c in enumerate(cand_all[:procs])]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(procs, initializer=_pool_init,
                  initargs=(U0, V0, rated, r_obs, float(gcfg.beta))) as pool:
        t0 = time.perf_counter()
        pool.map(_pool_gibbs_lane, lanes)
        lane_rate = len(lanes) / (time.perf_counter() - t0)
    pool_cand_rate = lane_rate / len(VALS)
    return e2e_rate, dev_rate, pool_cand_rate, procs


def bench_vn_total_variance(jax, jnp, cov_param="psd-project"):
    """vn `total-variance` lookahead with approx refit (active_pmf.py
    :612-633 + :668-676) at a full-covariance-supported shape.

    cov_param="chol" measures the eigh-free Cholesky-factor fast path
    (vnormal.VNConfig.cov_param; PARITY.md round-5 deviations) — reported
    as a separate field; the parity path stays the vn headline."""
    from amf_tpu import types
    from amf_tpu.active.criteria import KEY_FUNCS
    from amf_tpu.active.lookahead import (
        LookaheadConfig, lookahead_scores, vn_adapter)
    from amf_tpu.data import make_fake_data
    from amf_tpu.models import pmf, vnormal

    n, me, d = 24, 24, 2
    rng = np.random.default_rng(1)
    real, known, _ = make_fake_data(
        num_users=n, num_items=me, rank=d, mask_type=0.2, rng=rng)
    prob = types.problem_from_dense(real, known)
    pcfg = pmf.PMFConfig(latent_d=d, max_fit_steps=200)
    vcfg = vnormal.VNConfig(latent_d=d, max_fit_steps=100,
                            cov_param=cov_param)
    key = jax.random.PRNGKey(0)
    pst = pmf.init_state(key, n, me, pcfg, prob, dtype=jnp.float32)
    pst, _ = pmf.fit(pst, prob, pcfg)
    ast = vnormal.initialize_approx(jax.random.fold_in(key, 1), pst, vcfg)
    ast = vnormal.fit_normal(ast, pst, prob, vcfg)[0]

    lcfg = LookaheadConfig(
        rating_values=(), refit_lookahead=True,
        pmf_refit_steps=50, approx_refit_steps=50, n_integration_nodes=8)
    crit = KEY_FUNCS["total-variance"]
    adapter = vn_adapter(vcfg)
    cand_all = np.flatnonzero(np.asarray(prob.queryable).ravel())

    # host-tiled dispatch: one bounded device program per 64 candidates
    vt = 64
    n_cand = len(cand_all)
    if n_cand == 0:
        raise RuntimeError("vn bench: problem has no queryable cells")
    # pad the tail tile (repeat the last candidate) so every candidate is
    # measured under ONE compiled shape and a <64-candidate sweep cannot
    # index an empty tile list; the rate counts only the real candidates,
    # so padded duplicate lanes make the number slightly conservative
    padded = np.concatenate([
        cand_all, np.full((-len(cand_all)) % vt, cand_all[-1], cand_all.dtype)
    ])
    tiles = [jnp.asarray(padded[t:t + vt], jnp.int32)
             for t in range(0, len(padded), vt)]
    fn = jax.jit(lambda k, c: lookahead_scores(
        crit, pst, ast, prob, k, pcfg, adapter, lcfg, cand=c))
    jax.block_until_ready(fn(key, tiles[0]))
    t0 = time.perf_counter()
    outs = [fn(jax.random.fold_in(key, 2 + t), c)
            for t, c in enumerate(tiles)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    # a rate over non-finite scores is not a result (the chol path once
    # returned all-NaN under f32): fail the row into fault_notes rather
    # than record a meaningless number
    scores = np.concatenate([np.asarray(o) for o in outs])[:n_cand]
    if not np.isfinite(scores).any():
        raise RuntimeError(
            f"vn {cov_param} scores all non-finite ({n_cand} candidates)")
    return n_cand / dt


def main():
    from amf_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from amf_tpu import types
    from amf_tpu.data import make_fake_data

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX found {device.platform}")

    rng = np.random.default_rng(0)
    real, known, _ = make_fake_data(
        num_users=N, num_items=M, rank=D, noise=0.5,
        mask_type=0.05 * 100000 / (N * M), rng=rng)
    # discrete 1..5 ratings so exp-variance uses the reference's
    # Dirichlet-histogram weights (bayes_pmf.py:489-501)
    real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
    prob = types.problem_from_dense(real, known)
    prob = jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, prob)

    e2e, dev, pool_rate, procs = bench_gibbs_exp_variance(
        jax, jnp, prob, VALS)

    # a secondary row's failure is recorded in the JSON instead of killing
    # the headline
    fault_notes = {}
    try:
        vn_rate = bench_vn_total_variance(jax, jnp)
    except Exception as e:  # noqa: BLE001 — device faults surface as varied types
        vn_rate = None
        fault_notes["vn_total_variance"] = f"{type(e).__name__}: {e}"[:200]
    try:
        vn_chol_rate = bench_vn_total_variance(jax, jnp, cov_param="chol")
    except Exception as e:  # noqa: BLE001
        vn_chol_rate = None
        fault_notes["vn_total_variance_chol"] = f"{type(e).__name__}: {e}"[:200]

    print(json.dumps({
        "metric": "gibbs_exp_variance_scores_per_sec",
        "platform": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
        "value": round(e2e, 2),
        "unit": "candidates/s",
        "vs_baseline": round(e2e / pool_rate, 1),
        "baseline": "multiprocessing.Pool numpy Gibbs lanes, measured",
        "pool_procs": procs,
        "pool_scores_per_sec": round(pool_rate, 4),
        "device_only_scores_per_sec": round(dev, 2),
        "workload": f"{N}x{M} d={D} 5-value lookahead, "
                    f"{LA_SAMPS}-sample chains",
        "vn_total_variance_scores_per_sec": (
            round(vn_rate, 2) if vn_rate is not None else None),
        "vn_total_variance_chol_scores_per_sec": (
            round(vn_chol_rate, 2) if vn_chol_rate is not None else None),
        **({"secondary_bench_faults": fault_notes} if fault_notes else {}),
    }))


if __name__ == "__main__":
    main()
