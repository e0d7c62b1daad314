"""Multi-chip dry run used by the driver's ``dryrun_multichip``.

Builds an n-device 1-D mesh over the candidate axis (the framework's scaling
axis — SURVEY.md §2.4.1) and executes one FULL sharded active-learning
training step on tiny shapes, using the real lookahead engine:
  1. vmapped (candidate x rating-value) lookahead refits, candidates sharded
     over the mesh with shard_map;
  2. the argmax collective picking the query cell;
  3. the masked add-rating update;
  4. the PMF MAP refit and variational-normal KL refit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from amf_tpu import types
from amf_tpu.active import criteria as criteria_mod
from amf_tpu.active import lookahead as lookahead_mod
from amf_tpu.data import make_fake_data
from amf_tpu.models import pmf, vnormal
from jax.sharding import Mesh

from amf_tpu.parallel.sharding import best_candidate, sharded_candidate_scores


def run_dryrun(n_devices: int) -> None:
    # the dryrun runs on a virtual CPU mesh: pin the platform before first
    # backend use, so that it needs no accelerator
    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass  # backends already initialized by the caller — use as-is
    try:
        devices = jax.devices()
    except RuntimeError:
        devices = []
    if len(devices) < n_devices:
        # the virtual host devices (requires
        # --xla_force_host_platform_device_count >= n_devices); query the
        # cpu platform directly, since the caller may have started another
        devices = jax.devices("cpu")
        if len(devices) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devices)}; set "
                "XLA_FLAGS=--xla_force_host_platform_device_count"
            )
        jax.config.update("jax_default_device", devices[0])
    mesh = Mesh(np.asarray(devices[:n_devices]), ("candidates",))

    rng = np.random.default_rng(0)
    real, known, vals = make_fake_data(
        num_users=6, num_items=6, rank=2, data_type=5, mask_type="diag", rng=rng
    )
    prob = types.problem_from_dense(real, known)
    n, m = prob.shape
    pcfg = pmf.PMFConfig(latent_d=2, max_fit_steps=40)
    vcfg = vnormal.VNConfig(latent_d=2, max_fit_steps=30)
    adapter = lookahead_mod.vn_adapter(vcfg)
    lcfg = lookahead_mod.LookaheadConfig(
        rating_values=tuple(vals), discretize="sum",
        pmf_refit_steps=15, approx_refit_steps=15,
    )
    crit = criteria_mod.KEY_FUNCS["total-variance"]

    key = jax.random.PRNGKey(0)
    pst = pmf.init_state(key, n, m, pcfg, prob)
    pst, _ = pmf.fit(pst, prob, pcfg)
    ast = adapter.init_approx(jax.random.fold_in(key, 1), pst)
    ast = adapter.fit_approx(ast, pst, prob, 30)

    def score_flat(cand, k):
        return lookahead_mod.lookahead_scores(
            crit, pst, ast, prob, k, pcfg, adapter, lcfg, cand=cand
        )

    score_all = sharded_candidate_scores(score_flat, n * m, mesh)

    @jax.jit
    def train_step(k):
        scores = score_all(k)
        flat = best_candidate(scores, prob.queryable.ravel(), crit.maximize)
        i, j = flat // m, flat % m
        prob2 = prob.add_rating(i, j, 3.0)
        pst2, _ = pmf.fit(pst, prob2, pcfg, max_steps=15)
        ast2 = adapter.fit_approx(ast, pst2, prob2, 15)
        pred = pmf.predicted_matrix(pst2, pcfg)
        return flat, scores, pred, ast2.mean

    flat, scores, pred, _ = train_step(jax.random.fold_in(key, 2))
    flat = int(flat)
    scores_np = np.asarray(scores)
    queryable = np.asarray(prob.queryable).ravel()
    assert 0 <= flat < n * m and queryable[flat]
    assert np.isfinite(scores_np[queryable]).all()
    assert np.isnan(scores_np[~queryable]).all()
    assert np.isfinite(np.asarray(pred)).all()

    # --- sampler-family sharded step: Gibbs exp-variance lookahead (the
    # reference's MCMC-per-candidate hot loop, bayes_pmf.py:514-519,560-598)
    from amf_tpu.models import bpmf_gibbs

    gcfg = bpmf_gibbs.GibbsConfig(latent_d=2)
    _, gstats, _ = bpmf_gibbs.run_chain(
        jax.random.fold_in(key, 3), bpmf_gibbs.init_chain(pst), prob, gcfg,
        8, value_bounds=tuple(types.rating_bounds(vals)),
    )

    def gibbs_flat(cand, k):
        return bpmf_gibbs.exp_variance_scores(
            k, pst, prob, pcfg, gcfg, gstats, vals,
            num_samps=4, fit_budget=10, cand=cand, n_base_samples=8,
        )

    gibbs_scores = jax.jit(
        sharded_candidate_scores(gibbs_flat, n * m, mesh)
    )(jax.random.fold_in(key, 4))
    gs = np.asarray(gibbs_scores)
    assert np.isfinite(gs[queryable]).all()
    assert np.isnan(gs[~queryable]).all()

    # --- NUTS-family sharded lookahead: exp-variance via short NUTS chains
    # per candidate lane (the reference's R/Stan-NUTS-per-candidate hot loop,
    # stan-bpmf/bpmf.py:456-459,488-491)
    from amf_tpu.models import bpmf_hmc, sample_stats

    hcfg = bpmf_hmc.HMCConfig(latent_d=2, subtract_mean=True)
    hst = bpmf_hmc.init_state(prob, hcfg, dtype=jnp.float32)
    hst, hsamps = bpmf_hmc.samples(jax.random.fold_in(key, 5), hst, prob,
                                   hcfg, 8, 4)
    hbase = sample_stats.prediction_stats(
        hsamps["U"], hsamps["V"], hst.mean_rating, hcfg.subtract_mean,
        value_bounds=tuple(types.rating_bounds(vals)),
    )

    def hmc_flat(cand, k):
        return bpmf_hmc.lookahead_scores(
            k, hst, prob, hcfg, hbase, vals, num_samps=3, warmup=2,
            n_base_samples=8, cand=cand,
        )

    hmc_scores = jax.jit(
        sharded_candidate_scores(hmc_flat, n * m, mesh)
    )(jax.random.fold_in(key, 6))
    hs = np.asarray(hmc_scores)
    assert np.isfinite(hs[queryable]).all()
    assert np.isnan(hs[~queryable]).all()

    # --- RC-family sharded lookahead: 1-step lowest-entropy refits (the
    # reference's refit-the-full-maxent-model-per-candidate MATLAB loop,
    # select_1step_lowest_entropy.m:25-28)
    from amf_tpu.models import ratingconc as rc

    rcfg = rc.RCConfig(
        rating_values=tuple(float(v) for v in sorted(vals)), max_iters=25)
    x0, rdata, _ = rc.fit(prob, rcfg, dtype=jnp.float32)

    def rc_flat(cand, _k):
        return rc.entropy_lookahead_scores(
            x0, rdata, prob, rcfg, lookahead_iters=8, dtype=jnp.float32,
            cand=cand,
        )

    rc_scores = jax.jit(
        sharded_candidate_scores(rc_flat, n * m, mesh)
    )(jax.random.PRNGKey(0))
    rs = np.asarray(rc_scores)
    assert np.isnan(rs).sum() < rs.size  # queryable cells scored

    print(
        f"dryrun_multichip ok: {n_devices} devices, 4 sharded lookahead "
        f"families (vn total-variance full step, Gibbs exp-variance, "
        f"NUTS exp-variance, RC 1-step entropy), picked cell "
        f"({flat // m}, {flat % m})"
    )
