"""Decompose the ML-100k Gibbs chain (128 rounds) into its per-round
components on the accelerator.

A round's masked-Gram matmuls are 4 x 1.27 GFLOP; the rest is
small-linalg latency chains (hyperparameter draws: inv / cholesky / gamma
of d x d), the conditional-draw solves, and the in-scan prediction
statistics. This probe times each piece as its own jitted scan so the split
is unambiguous, then re-times the full chain.

Usage: python scripts/probe_gibbs_chain.py [rounds] (default 128)
"""

import sys
import time

from amf_tpu.utils.platform import setup as platform_setup

platform_setup(use_x64=False)

import jax
import jax.numpy as jnp
import numpy as np

from amf_tpu.models import bpmf_gibbs as bg
from amf_tpu.models import pmf
from amf_tpu.types import problem_from_ratings


def bench(label, fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{label:<44} {dt * 1e3:9.2f} ms")
    return dt


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    n, m, d = 943, 1682, 20
    rng = np.random.default_rng(0)
    # ~5% observed, ML-100k-like
    n_obs = int(0.05 * n * m)
    ii = rng.integers(0, n, n_obs)
    jj = rng.integers(0, m, n_obs)
    vv = rng.integers(1, 6, n_obs).astype(np.float64)
    ratings = np.stack([ii, jj, vv], 1)
    problem = problem_from_ratings(ratings, shape=(n, m), dtype=jnp.float32)

    cfg = bg.GibbsConfig(latent_d=d)
    key = jax.random.PRNGKey(0)
    U0 = 0.1 * jax.random.normal(key, (n, d), jnp.float32)
    V0 = 0.1 * jax.random.normal(key, (m, d), jnp.float32)
    chain0 = bg.ChainState(U=U0, V=V0, mean_rating=jnp.float32(3.5))

    r_c = problem.R_obs - chain0.mean_rating

    # --- piece 1: hyperparameter draws only ---
    @jax.jit
    def hyper_only(c, k):
        def step(carry, kk):
            k1, k2 = jax.random.split(kk)
            mu_u, al_u = bg.sample_hyperparam(k1, carry.U, cfg)
            mu_v, al_v = bg.sample_hyperparam(k2, carry.V, cfg)
            # touch outputs so nothing is DCE'd
            carry = carry.replace(
                U=carry.U + 0.0 * (al_u[0, 0] + mu_u[0]),
                V=carry.V + 0.0 * (al_v[0, 0] + mu_v[0]),
            )
            return carry, None
        c, _ = jax.lax.scan(step, c, jax.random.split(k, rounds))
        return c.U

    # --- piece 2: factor sweeps only (fixed hyperparams) ---
    mu = jnp.zeros(d, jnp.float32)
    alpha = jnp.eye(d, dtype=jnp.float32)

    @jax.jit
    def sweeps_only(c, k):
        def step(carry, kk):
            U, V = carry
            for _ in range(cfg.num_gibbs):
                kk, ku, kv = jax.random.split(kk, 3)
                U = bg._sample_rows(ku, problem.rated, r_c, V, mu, alpha, cfg.beta)
                V = bg._sample_rows(kv, problem.rated.T, r_c.T, U, mu, alpha, cfg.beta)
            return (U, V), None
        (U, V), _ = jax.lax.scan(step, (c.U, c.V), jax.random.split(k, rounds))
        return U

    # --- piece 3: pred stats only (frozen factors) ---
    @jax.jit
    def stats_only(c, k):
        def step(carry, kk):
            s1, s2 = carry
            pred = c.U @ c.V.T + c.mean_rating
            return (s1 + pred, s2 + pred * pred), None
        init = (jnp.zeros((n, m), jnp.float32),) * 2
        (s1, s2), _ = jax.lax.scan(step, init, jax.random.split(k, rounds))
        return s1

    # --- full chain (the production path) ---
    @jax.jit
    def full(c, k):
        c2, stats, _ = bg.run_chain(k, c, problem, cfg, rounds)
        return stats.var

    print(f"platform={jax.devices()[0].platform} rounds={rounds} "
          f"shape=({n},{m}) d={d}")
    t_h = bench("hyperparameter draws (scan)", hyper_only, chain0, key)
    t_s = bench("factor sweeps (scan, fixed hypers)", sweeps_only, chain0, key)
    t_p = bench("pred mean/var stats (scan)", stats_only, chain0, key)
    t_f = bench("FULL run_chain (mean/var)", full, chain0, key)
    print(f"\npieces sum {1e3 * (t_h + t_s + t_p):.1f} ms vs full "
          f"{1e3 * t_f:.1f} ms")

    # with histogram bins + cutoff (the lookahead-weights configuration)
    @jax.jit
    def full_bins(c, k):
        from amf_tpu.types import rating_bounds
        vb = rating_bounds((1.0, 2.0, 3.0, 4.0, 5.0))
        c2, stats, _ = bg.run_chain(
            k, c, problem, cfg, rounds, cutoffs=(3.5,), value_bounds=vb
        )
        return stats.var
    bench("FULL run_chain (+P(ge), 5-bin hist)", full_bins, chain0, key)


if __name__ == "__main__":
    main()
