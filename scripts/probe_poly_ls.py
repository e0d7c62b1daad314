"""A/B the polynomial line search inside the Gibbs exp-variance lookahead
(the bench.py headline): poly_ls False vs True at the ML-100k shape.

Run: PYTHONPATH=. python scripts/probe_poly_ls.py
"""
import time

import numpy as np

from amf_tpu.utils import platform

print("backend:", platform.setup(use_x64=False))

import jax
import jax.numpy as jnp

from amf_tpu import types
from amf_tpu.data import make_fake_data
from amf_tpu.models import bpmf_gibbs, pmf
from amf_tpu.types import rating_bounds

N, M, D = 943, 1682, 10
VALS = (1.0, 2.0, 3.0, 4.0, 5.0)
TILE = 32
BASE_SAMPS = 128
LA_SAMPS = 30

rng = np.random.default_rng(0)
real, known, _ = make_fake_data(num_users=N, num_items=M, rank=D, noise=0.5,
                                mask_type=0.05 * 100000 / (N * M), rng=rng)
real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
prob = types.problem_from_dense(real, known)
import jax.numpy as _jnp
prob = jax.tree.map(
    lambda x: x.astype(_jnp.float32)
    if _jnp.issubdtype(x.dtype, _jnp.floating) else x, prob)
pcfg = pmf.PMFConfig(latent_d=D, subtract_mean=True)
gcfg = bpmf_gibbs.GibbsConfig(latent_d=D, subtract_mean=True)
key = jax.random.PRNGKey(0)
k1, k2, k3 = jax.random.split(key, 3)
pst = pmf.init_state(k1, N, M, pcfg, problem=prob, dtype=jnp.float32)
pst, _ = pmf.fit(pst, prob, pcfg)
chain = bpmf_gibbs.init_chain(pst)
bounds = tuple(rating_bounds(VALS))
_, stats, _ = bpmf_gibbs.run_chain(k2, chain, prob, gcfg, BASE_SAMPS,
                                   value_bounds=bounds)
jax.block_until_ready(stats.var)

cand = np.flatnonzero(np.asarray(prob.queryable).ravel())[:TILE].astype(np.int32)
cand = jnp.asarray(cand)

for poly in (False, True):
    fn = jax.jit(lambda k, c, p=poly: bpmf_gibbs.exp_variance_scores(
        k, pst, prob, pcfg, gcfg, stats, VALS,
        num_samps=LA_SAMPS, n_base_samples=BASE_SAMPS, cand=c, poly_ls=p))
    out = fn(k3, cand)
    jax.block_until_ready(out)
    ts = []
    for r in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(jax.random.fold_in(k3, r), cand))
        ts.append(time.perf_counter() - t0)
    best = min(ts)
    print(f"poly_ls={poly}: tile of {TILE} in {best*1e3:.1f} ms "
          f"-> {TILE/best:.0f} scores/s  (runs: {[f'{t*1e3:.0f}' for t in ts]})")
    s = np.asarray(out)
    print("  score head:", s[np.isfinite(s)][:4])
