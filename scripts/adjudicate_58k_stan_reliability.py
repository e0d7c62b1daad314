"""Part 2 of the 58k-15d pred-variance adjudication: is the *stan/NUTS*
first-step pred-variance map reliable at this scale?

Context (adjudication_noise_floor.json): the Gibbs map at 58k-15d is
internally reliable (split-half tau ~0.46, seed-pair ~0.59, fresh-vs-
recorded ~0.58), yet the stan~bayes cross-engine tau is ~0.003
(adjudication_tau.json). Two reliable maps cannot disagree at tau~0, so
either the NUTS map at s200/w100 is itself MC/adaptation noise (chains not
mixed at 13k params), or the engines genuinely compute different maps.

Method: two fresh NUTS runs (seeds 100/200) at the recorded config,
keeping per-draw predictions; report split-half tau within each run,
seed-pair tau across runs, and tau against a fresh Gibbs map.
Writes adjudication_stan_reliability.json.
"""
import json

import numpy as np

from amf_tpu.utils.platform import setup as _platform_setup

_platform_setup(use_x64=False)  # f32; JAX_PLATFORMS=cpu runs it on the host

import jax
import jax.numpy as jnp

from amf_tpu import types
from amf_tpu.active.gibbs_loop import split_query_test
from amf_tpu.analysis import metrics
from amf_tpu.data.loaders import load_npz_schema
from amf_tpu.models import bpmf_hmc

EXP = "experiments/movielens-58k-from5pct-test5pct-15d"

data = load_npz_schema(f"{EXP}/data.npz")
real, ratings = data["_real"], data["_ratings"]
rng = np.random.default_rng(0)
query_on, _ = split_query_test(real, ratings, "all", rng)
test_on = np.asarray(data["_test_on"], bool)
query_on = query_on & ~test_on
prob = types.problem_from_ratings(
    ratings, real=real, test=test_on, dtype=jnp.float32)
prob = prob.replace(queryable=jnp.asarray(query_on))
cfg = bpmf_hmc.HMCConfig(latent_d=15, subtract_mean=True)


def stan_var_maps(seed):
    st = bpmf_hmc.init_state(prob, cfg, dtype=jnp.float32)
    st, samps = bpmf_hmc.samples(
        jax.random.PRNGKey(seed), st, prob, cfg, 200, 100)
    U, V = samps["U"], samps["V"]  # (S, n, d), (S, m, d)
    preds = jnp.einsum("sid,sjd->sij", U, V) + st.mean_rating
    h = preds.shape[0] // 2
    return (np.asarray(jnp.var(preds[:h], axis=0)),
            np.asarray(jnp.var(preds[h:], axis=0)),
            np.asarray(jnp.var(preds, axis=0)))


a1, a2, af = stan_var_maps(100)
b1, b2, bf = stan_var_maps(200)

q = np.asarray(query_on)


def tau(x, y):
    sel = q & np.isfinite(x) & np.isfinite(y)
    return float(metrics.kendall_tau(x[sel], y[sel]))


out = {
    "check": "stan pred-variance map reliability (fresh NUTS s200/w100)",
    "workload": EXP,
    "cells": int(q.sum()),
    "tau_split_half_seedA": tau(a1, a2),
    "tau_split_half_seedB": tau(b1, b2),
    "tau_seed_pair": tau(af, bf),
    "spread_over_cells": float(np.std(af[q])),
    "mean_abs_half_diff": float(np.mean(np.abs(a1 - a2)[q])),
}
# normalized fields for analysis/parity.py's noise-floor downgrade
out["kind"] = "stan"
out["criteria"] = ["pred-variance"]
out["reliable"] = min(
    out["tau_split_half_seedA"], out["tau_split_half_seedB"],
    out["tau_seed_pair"],
) >= 0.3
import gzip  # noqa: E402

with gzip.open(f"{EXP}/digest_bayes.json.gz", "rt") as f:
    dg = json.load(f)
rec = np.asarray(dg["criteria"]["pred-variance"]["first_step_evals"], float)
out["tau_vs_recorded_gibbs"] = tau(af, rec)
print(json.dumps(out), flush=True)
with open(f"{EXP}/adjudication_stan_reliability.json", "w") as f:
    json.dump(out, f, indent=1)
