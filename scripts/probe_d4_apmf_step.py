"""Time ONE active-vn lookahead step of the 10x10_discrete4_d4 apmf arm.

Decides whether the d4 apmf catalog arm (reference:
results/10x10_discrete4_d4/Makefile:67-76, all 15 vn keys) should run
f32-on-chip instead of f64-on-CPU: the orphaned round-3 f64 CPU run
measured 2.65 min/pick => ~60 h for 15 keys x 91 picks, infeasible.

Usage: [JAX_PLATFORMS=cpu] python scripts/probe_d4_apmf_step.py [key ...]
"""
import os
import sys
import time

import numpy as np


def main():
    keys = sys.argv[1:] or ["1step-ge-.5-approx", "total-variance"]
    from amf_tpu.utils.platform import setup as platform_setup

    f64 = os.environ.get("PROBE_F64") == "1"
    platform_setup(use_x64=f64)
    import jax
    import jax.numpy as jnp

    dtype = jnp.float64 if f64 else jnp.float32
    print("backend:", jax.default_backend(), "dtype:", dtype.__name__)

    from amf_tpu.active import criteria as criteria_mod
    from amf_tpu.active import lookahead as lookahead_mod
    from amf_tpu import types
    from amf_tpu.data.loaders import load_npz_schema
    from amf_tpu.models import pmf, vnormal

    data = load_npz_schema("experiments/10x10_discrete4_d4/data.pkl")
    rating_vals = tuple(data.get("_rating_vals", ())) or ()
    prob = types.problem_from_ratings(
        data["_ratings"], real=data["_real"], test=data.get("_test_on"),
        dtype=dtype)
    pcfg = pmf.PMFConfig(latent_d=4)
    acfg = vnormal.VNConfig(latent_d=4)
    adapter = lookahead_mod.vn_adapter(acfg)
    lcfg = lookahead_mod.LookaheadConfig(
        rating_values=tuple(rating_vals), refit_lookahead=True,
        discretize="sum", pmf_refit_steps=300, approx_refit_steps=300)

    key = jax.random.PRNGKey(0)
    pst = pmf.init_state(jax.random.PRNGKey(1), *prob.shape, pcfg, prob,
                         dtype=dtype)
    pst, _ = pmf.fit(pst, prob, pcfg)
    ast = adapter.init_approx(jax.random.PRNGKey(2), pst)
    ast = adapter.fit_approx(ast, pst, prob, 10_000)

    for kname in keys:
        crit = criteria_mod.KEY_FUNCS[kname]

        @jax.jit
        def fn(pst, ast, prob, k, _crit=crit):
            return lookahead_mod.lookahead_scores(
                _crit, pst, ast, prob, k, pcfg, adapter, lcfg).reshape(
                    prob.shape)

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(pst, ast, prob, key))
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(pst, ast, prob, jax.random.fold_in(key, 1)))
        t_step = time.perf_counter() - t0
        n_q = int(np.asarray(prob.queryable).sum())
        print(f"{kname}: first(call+compile) {t_compile:.1f}s, "
              f"steady step {t_step:.2f}s ({n_q} candidates) "
              f"=> 91 picks ~ {(t_compile + 90 * t_step) / 60:.1f} min/key")


if __name__ == "__main__":
    main()
