"""The active-learning loop for the variational-PMF models.

Capability parity with the reference drivers ``full_test`` /
``_full_test_threaded`` / ``compare`` (python-pmf/active_pmf.py:796-1092,
mn_active_pmf.py): per criterion, loop {score every queryable cell, query the
best, refit} and record ``(num_rated, rmse, (i, j), evals_matrix)`` tuples in
the reference results-pickle schema (plot_results.py:160-166).

The reference runs one Python thread per criterion sharing a lock-guarded
multiprocessing pool; here each per-step computation is one jitted device
program, so criteria just run sequentially (SURVEY.md §2.4.2) — states are
immutable pytrees, so "deepcopy per criterion" is free.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from amf_tpu.active import criteria as criteria_mod
from amf_tpu.active import lookahead as lookahead_mod
from amf_tpu.analysis import metrics
from amf_tpu.models import mnormal, pmf, vnormal
from amf_tpu.types import Problem, ratings_array
def run_active_pmf(
    problem: Problem,
    real: np.ndarray,
    key_names: Sequence[str],
    latent_d: int = 5,
    rating_values: Tuple[float, ...] = (),
    discrete_exp: bool = False,
    refit_lookahead: bool = False,
    fit_sigmas: bool = False,
    steps: Optional[int] = None,
    seed: int = 0,
    model: str = "vn",  # 'vn' (ActivePMF) | 'mn' (MNActivePMF)
    pcfg: Optional[pmf.PMFConfig] = None,
    lookahead_budget: int = 300,
    lookahead_tile: int = 0,
    lookahead_host_tiles: bool = False,
    cov_param: str = "psd-project",  # vn only: 'chol' = eigh-free fast path
    mesh=None,  # jax.sharding.Mesh: shard lookahead candidates over devices
    dtype=jnp.float64,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 20,
    initial_state=None,  # (pst, ast) snapshot to reuse instead of refitting
    # (reference: --load-model reusing _initial_apmf, active_pmf.py:1131,
    # :1214-1215; results store the snapshot as _initial_state)
) -> Dict[str, object]:
    """Run the full multi-criterion comparison (reference: compare(),
    active_pmf.py:1013-1092). Returns the reference results schema."""
    if model == "vn":
        registry = criteria_mod.KEY_FUNCS
    else:
        registry = criteria_mod.MN_KEY_FUNCS
    for k in key_names:
        if k not in registry:
            raise ValueError(f"unknown criterion {k!r} for model {model!r}")

    key = jax.random.PRNGKey(seed)
    n, m = problem.shape
    problem = jax.tree.map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        problem,
    )
    pcfg = pcfg or pmf.PMFConfig(latent_d=latent_d)

    if model == "vn":
        acfg = vnormal.VNConfig(latent_d=latent_d, cov_param=cov_param)
        adapter = lookahead_mod.vn_adapter(acfg)
    else:
        acfg = mnormal.MNConfig(latent_d=latent_d)
        adapter = lookahead_mod.mn_adapter(acfg)

    discretize = (
        discrete_exp if isinstance(discrete_exp, str)
        else ("sum" if discrete_exp else "continuous")
    )
    lcfg = lookahead_mod.LookaheadConfig(
        rating_values=tuple(rating_values or ()),
        refit_lookahead=refit_lookahead,
        discretize=discretize,
        pmf_refit_steps=lookahead_budget,
        approx_refit_steps=lookahead_budget,
        candidate_tile=lookahead_tile,
    )

    # ---- initial fit, shared by all criteria (reference: :1043-1055)
    key, kinit, kapprox = jax.random.split(key, 3)
    needs_approx = any(registry[k].needs_approx for k in key_names)
    if initial_state is not None:
        # --load-model snapshot reuse (reference: active_pmf.py:1214-1215)
        cast = lambda x: (
            jnp.asarray(x).astype(dtype)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
            else jnp.asarray(x)
        )
        pst, ast = initial_state
        pst = jax.tree.map(cast, pst)
        if pst.U.shape != (n, pcfg.latent_d):
            raise ValueError(
                f"loaded model shape {pst.U.shape} does not match problem "
                f"({n}, {pcfg.latent_d})"
            )
        if ast is not None:
            ast = jax.tree.map(cast, ast)
        if needs_approx and ast is None:
            ast = adapter.init_approx(kapprox, pst)
            ast = adapter.fit_approx(ast, pst, problem, 10_000)
    else:
        pst = pmf.init_state(kinit, n, m, pcfg, problem, dtype=dtype)
        if fit_sigmas:
            pst = pmf.fit_with_sigmas(pst, problem, pcfg)
        else:
            pst, _ = pmf.fit(pst, problem, pcfg)

        ast = None
        if needs_approx:
            ast = adapter.init_approx(kapprox, pst)
            ast = adapter.fit_approx(ast, pst, problem, 10_000)

    real_j = jnp.asarray(real, dtype=dtype)

    results: Dict[str, object] = {
        "_real": np.asarray(real),
        "_ratings": ratings_array(problem),
        "_rating_vals": tuple(rating_values) if rating_values else None,
        "_initial_state": (pst, ast),
    }

    # ---- jitted per-step programs, shared across criteria
    @jax.jit
    def refit(pst, ast, prob, kapprox):
        pst2 = pmf.refresh_mean_rating(pst, prob)
        if fit_sigmas:
            pst2 = pmf.fit_with_sigmas(pst2, prob, pcfg)
        else:
            pst2, _ = pmf.fit(pst2, prob, pcfg)
        if needs_approx:
            if refit_lookahead:
                ast2 = adapter.init_approx(kapprox, pst2)
            else:
                ast2 = ast
            ast2 = adapter.fit_approx(ast2, pst2, prob, 10_000)
        else:
            ast2 = ast
        return pst2, ast2

    @jax.jit
    def test_rmse(pst, prob):
        pred = pmf.predicted_matrix(pst, pcfg)
        return metrics.rmse_on(pred, real_j, prob.test)

    score_fns = {}

    def get_score_fn(crit):
        if crit.name not in score_fns:
            if crit.kind == "direct":

                @jax.jit
                def fn(pst, ast, prob, k, _crit=crit):
                    amv = adapter.pred_mean_var(ast, prob) if _crit.needs_approx else None
                    ev = criteria_mod.direct_scores(
                        _crit, pmf.predicted_matrix(pst, pcfg), amv, k
                    )
                    return jnp.where(prob.queryable, ev, jnp.nan)

            elif mesh is not None:
                # shard the candidate axis over the device mesh; states and
                # the problem are closure-captured (replicated), the argmax
                # happens back on the host side of the gathered scores
                from amf_tpu.parallel.sharding import sharded_candidate_scores

                @jax.jit
                def fn(pst, ast, prob, k, _crit=crit):
                    def score_flat(cand, kk):
                        return lookahead_mod.lookahead_scores(
                            _crit, pst, ast, prob, kk, pcfg, adapter, lcfg,
                            cand=cand,
                        )

                    run = sharded_candidate_scores(score_flat, n * m, mesh)
                    return run(k).reshape(prob.shape)

            elif lookahead_host_tiles and lookahead_tile:
                # One bounded device program PER TILE, dispatched from the
                # host, instead of one fused whole-sweep program spanning
                # every candidate x integration-node lane x two budgeted
                # refits (candidate_tile alone tiles *inside* one program).
                # Lane PRNG streams are candidate-index derived
                # (utils.rng.lane_keys), so tiles match the fused path
                # lane-for-lane.
                tile = int(lookahead_tile)
                lcfg_tile = lcfg._replace(candidate_tile=0)

                @jax.jit
                def tile_scores(pst, ast, prob, k, cand, _crit=crit):
                    return lookahead_mod.lookahead_scores(
                        _crit, pst, ast, prob, k, pcfg, adapter, lcfg_tile,
                        cand=cand,
                    )

                def fn(pst, ast, prob, k, _crit=crit, _tile_scores=tile_scores):
                    queryable = np.asarray(prob.queryable).ravel()
                    cand_all = np.flatnonzero(queryable).astype(np.int32)
                    out = np.full(n * m, np.nan)
                    pad = (-len(cand_all)) % tile
                    cand_pad = np.concatenate(
                        [cand_all, np.zeros(pad, np.int32)]
                    )
                    n_tiles = len(cand_pad) // tile
                    for t in range(n_tiles):
                        chunk = cand_pad[t * tile:(t + 1) * tile]
                        s = np.asarray(
                            _tile_scores(pst, ast, prob, k, jnp.asarray(chunk))
                        )
                        take = tile if t < n_tiles - 1 else tile - pad
                        out[chunk[:take]] = s[:take]
                        if verbose and (t % 16 == 0 or t == n_tiles - 1):
                            print(f"    lookahead tile {t + 1}/{n_tiles}",
                                  flush=True)
                    return jnp.asarray(out, dtype).reshape(prob.shape)

            else:

                @jax.jit
                def fn(pst, ast, prob, k, _crit=crit):
                    flat = lookahead_mod.lookahead_scores(
                        _crit, pst, ast, prob, k, pcfg, adapter, lcfg
                    )
                    return flat.reshape(prob.shape)

            score_fns[crit.name] = fn
        return score_fns[crit.name]

    from amf_tpu.active.driver import Family, drive_active
    from amf_tpu.utils.checkpoint import LoopCheckpointer

    ckpt = LoopCheckpointer.for_problem(
        checkpoint_path, problem, real, every=checkpoint_every
    )

    family = Family(
        nice_name=lambda kname: registry[kname].nice_name,
        score=lambda kname, st, prob, k: (
            get_score_fn(registry[kname])(st[0], st[1], prob, k),
            registry[kname].maximize,
        ),
        refit=lambda st, prob, k: refit(st[0], st[1], prob, k),
        err=lambda st, prob: test_rmse(st[0], prob),
    )
    results.update(
        drive_active(problem, real, key_names, family, (pst, ast), key,
                     steps=steps, ckpt=ckpt, verbose=verbose)
    )
    return results
