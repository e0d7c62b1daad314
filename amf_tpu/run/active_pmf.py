"""CLI for the variational active-PMF models.

Mirrors the reference entry points ``python-pmf/active_pmf.py main()``
(:1100-1257) and ``mn_active_pmf.py main()`` (:1011-1128): same flag names,
criterion keys, data schema, and results-pickle layout, so downstream
analysis tooling can diff runs against reference outputs.  ``--model mn``
selects the matrix-normal approximation (the reference's separate
mn_active_pmf CLI).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np


def add_bool_opt(parser, name, default=False):
    parser.add_argument("--" + name, action="store_true", default=default)
    parser.add_argument(
        "--no-" + name, action="store_false", dest=name.replace("-", "_")
    )


def build_parser():
    from amf_tpu.active.criteria import KEY_FUNCS

    parser = argparse.ArgumentParser(description=__doc__)
    model = parser.add_argument_group("Model Options")
    model.add_argument("--model", choices=("vn", "mn"), default="vn")
    model.add_argument("--latent-d", "-D", type=int, default=5)
    model.add_argument(
        "--discrete-integration", nargs="?", const=True, default=False
    )
    model.add_argument(
        "--continuous-integration",
        action="store_false",
        dest="discrete_integration",
    )
    add_bool_opt(model, "fit-sigmas", default=False)
    add_bool_opt(model, "refit-lookahead", default=False)
    model.add_argument("--lookahead-budget", type=int, default=300,
                       help="max inner-fit iterations inside the vmapped lookahead")
    model.add_argument("--cov-param", choices=("psd-project", "chol"),
                       default="psd-project",
                       help="vn covariance descent parameterization: "
                            "psd-project = the reference's eigh-projected "
                            "descent (parity default); chol = Cholesky-"
                            "factor fast path (PSD by construction, no "
                            "per-step eigh; same KL objective, different "
                            "trajectory — see PARITY.md)")
    model.add_argument("keys", nargs="*",
                       help="Choices: {}.".format(", ".join(sorted(KEY_FUNCS))))

    problem_def = parser.add_argument_group("Problem Definition")
    problem_def.add_argument("--load-data", default=None, metavar="FILE")
    problem_def.add_argument("--load-model", default=None, metavar="FILE",
                             help="reuse the fitted initial model/approx "
                                  "snapshot (_initial_state) from a previous "
                                  "results pickle (reference: "
                                  "active_pmf.py:1131,1214-1215)")
    problem_def.add_argument("--gen-rank", "-R", type=int, default=5)
    problem_def.add_argument("--type", default="float")
    problem_def.add_argument("--u-mean", type=float, default=0)
    problem_def.add_argument("--u-std", type=float, default=2)
    problem_def.add_argument("--v-mean", type=float, default=0)
    problem_def.add_argument("--v-std", type=float, default=2)
    problem_def.add_argument("--noise", "-n", type=float, default=0.25)
    problem_def.add_argument("--num-users", "-N", type=int, default=10)
    problem_def.add_argument("--num-items", "-M", type=int, default=10)
    problem_def.add_argument("--mask", "-m", default=0.0)

    running = parser.add_argument_group("Running")
    running.add_argument("--steps", "-s", type=int, default=None)
    running.add_argument("--seed", type=int, default=0)
    running.add_argument("--scan", action="store_true", default=False,
                         help="compile the whole sweep into one device "
                              "program (fast path)")
    running.add_argument("--scan-evals", action="store_true", default=False,
                         help="with --scan: also record per-step criterion "
                              "maps in the results (steps*n*m memory)")
    running.add_argument("--shard-candidates", type=int, default=0,
                         metavar="N_DEVICES",
                         help="shard lookahead candidates over an N-device mesh")
    running.add_argument("--lookahead-tile", type=int, default=0,
                         help="candidates per vmapped pass (memory bound)")
    running.add_argument("--lookahead-host-tiles", action="store_true",
                         default=False,
                         help="dispatch one bounded device program per "
                         "lookahead tile from the host instead of one fused "
                         "sweep (bounded device programs)")
    running.add_argument("--float32", action="store_true",
                         help="run in float32")
    add_bool_opt(running, "verbose", default=True)

    results = parser.add_argument_group("Results")
    results.add_argument("--save-results", nargs="?", default=None, const=True,
                         metavar="FILE")
    results.add_argument("--no-save-results", action="store_false",
                         dest="save_results")
    results.add_argument("--note", action="append",
                         help="Saved into the results file; otherwise unused.")
    results.add_argument("--checkpoint", default=None, metavar="FILE",
                         help="partial-results file for mid-run checkpoints "
                              "and exact resume")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    from amf_tpu.utils.platform import setup as platform_setup

    backend = platform_setup(use_x64=not args.float32)
    if args.verbose:
        print(f"backend: {backend}")

    import jax.numpy as jnp

    from amf_tpu import types
    from amf_tpu.active import loop
    from amf_tpu.active.criteria import KEY_FUNCS, MN_KEY_FUNCS
    from amf_tpu.data import make_fake_data
    from amf_tpu.data.loaders import load_npz_schema

    registry = KEY_FUNCS if args.model == "vn" else MN_KEY_FUNCS
    key_names = args.keys or sorted(registry)
    for k in key_names:
        if k not in registry:
            sys.stderr.write(
                f"Invalid key name {k}; options are {', '.join(sorted(registry))}.\n"
            )
            sys.exit(1)

    try:
        args.mask = float(args.mask)
    except ValueError:
        pass
    try:
        args.type = int(args.type)
    except ValueError:
        pass

    if args.save_results is True:
        args.save_results = "results.pkl"
    if args.save_results:
        dirname = os.path.dirname(args.save_results)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    if args.load_data:
        data = load_npz_schema(args.load_data)
        real = data["_real"]
        vals = tuple(data.get("_rating_vals", ())) or ()
        problem = types.problem_from_ratings(
            data["_ratings"], real=real, test=data.get("_test_on"),
            dtype=jnp.float32 if args.float32 else jnp.float64,
        )
    else:
        real, known, vals = make_fake_data(
            noise=args.noise, num_users=args.num_users, num_items=args.num_items,
            mask_type=args.mask, data_type=args.type, rank=args.gen_rank,
            u_mean=args.u_mean, u_std=args.u_std,
            v_mean=args.v_mean, v_std=args.v_std, rng=rng,
        )
        vals = tuple(vals) if vals else ()
        # synthetic data: every cell is knowable (the reference applies the
        # 0-means-unknowable rule only to --load-data, active_pmf.py:1216-1219)
        problem = types.problem_from_dense(
            real, known, dtype=jnp.float32 if args.float32 else jnp.float64,
            zeros_unknowable=False,
        )

    if args.scan:
        # whole-sweep scan fast path (active/scan_loop.py)
        import jax

        from amf_tpu.active import criteria as criteria_mod
        from amf_tpu.active import lookahead as lookahead_mod
        from amf_tpu.active import scan_loop
        from amf_tpu.models import pmf as pmf_mod

        if args.fit_sigmas:
            sys.stderr.write("--scan does not support --fit-sigmas\n")
            sys.exit(1)
        pcfg = pmf_mod.PMFConfig(latent_d=args.latent_d)
        discretize = (
            args.discrete_integration
            if isinstance(args.discrete_integration, str)
            else ("sum" if args.discrete_integration else "continuous")
        )
        lcfg = lookahead_mod.LookaheadConfig(
            rating_values=vals,
            refit_lookahead=args.refit_lookahead,
            discretize=discretize,
            pmf_refit_steps=args.lookahead_budget,
            approx_refit_steps=args.lookahead_budget,
            candidate_tile=args.lookahead_tile,
        )
        n_q = int(np.asarray(problem.queryable).sum())
        # reference step semantics: --steps counts RECORDS including the
        # initial pre-query one (islice(res, steps), active_pmf.py:1074)
        n_queries = min((args.steps - 1) if args.steps else n_q, n_q)
        results = {
            "_real": np.asarray(real),
            "_rating_vals": vals or None,
        }
        for key_name in key_names:
            crit = registry[key_name]
            res, pst_final = scan_loop.run_active_scan(
                problem, real, crit, n_queries,
                jax.random.PRNGKey(args.seed), pcfg, lcfg=lcfg,
                model=args.model, record_evals=args.scan_evals,
            )
            # initial pre-query record, as in the loop path / reference
            recs = scan_loop.result_to_records(problem, res)
            results[key_name] = recs
            if args.verbose:
                errs = [r[1] for r in recs]
                print(f"{crit.nice_name}: {len(recs)} steps, rmse "
                      f"{errs[0]:.4f} -> {errs[-1]:.4f}")
        if args.save_results:
            print(f"saving results in '{args.save_results}'")
            results["_kind"] = "apmf"
            results["_args"] = vars(args)
            with open(args.save_results, "wb") as f:
                pickle.dump(results, f)
        return

    mesh = None
    if args.shard_candidates:
        from amf_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(args.shard_candidates)

    initial_state = None
    if args.load_model:
        with open(args.load_model, "rb") as f:
            prev = pickle.load(f)
        initial_state = prev.get("_initial_state")
        if initial_state is None:
            sys.stderr.write(
                f"{args.load_model} has no _initial_state snapshot\n"
            )
            sys.exit(1)
        print(f"reusing initial model from {args.load_model}")

    results = loop.run_active_pmf(
        problem, real, key_names,
        latent_d=args.latent_d,
        rating_values=vals,
        discrete_exp=args.discrete_integration,
        refit_lookahead=args.refit_lookahead,
        fit_sigmas=args.fit_sigmas,
        steps=args.steps,
        seed=args.seed,
        model=args.model,
        lookahead_budget=args.lookahead_budget,
        lookahead_tile=args.lookahead_tile,
        lookahead_host_tiles=args.lookahead_host_tiles,
        cov_param=args.cov_param,
        mesh=mesh,
        dtype=jnp.float32 if args.float32 else jnp.float64,
        verbose=args.verbose,
        checkpoint_path=args.checkpoint,
    )

    if args.save_results:
        print(f"saving results in '{args.save_results}'")
        results = dict(results)
        # persist the initial snapshot as host arrays so --load-model can
        # reuse it (the reference pickles _initial_apmf, active_pmf.py:1061)
        if results.get("_initial_state") is not None:
            import jax as _jax

            results["_initial_state"] = _jax.tree.map(
                np.asarray, results["_initial_state"]
            )
        results["_kind"] = "mnpmf" if args.model == "mn" else "apmf"
        results["_args"] = vars(args)
        with open(args.save_results, "wb") as f:
            pickle.dump(results, f)


if __name__ == "__main__":
    main()
