#!/usr/bin/env python3
"""Smoke run of the main path on an NVIDIA GPU, in one process.

    python chip_smoke.py [--seed N]   # phases 1-5 on one GPU
    python chip_smoke.py --multi      # candidate-sharded lookahead, 4 GPUs

Phases (one GPU):
  1. device: JAX's first device must be a GPU; prints its kind and the
     card's name and power limit;
  2. the GPU path of the Gibbs row draw (ops/chol_sample: the unrolled
     Cholesky solve+sample) against its plain-JAX reference at the DrugBank
     70x306 and MovieLens-100k lookahead widths, and one whole
     ``exp_variance_scores`` tile on each;
  3. the flagship: ``bayes_pmf.main`` with the catalog's
     ``drugbank-70x306-gibbs`` / ``bayes_lookahead`` argv for 3 steps, plus
     one tile scored at default and at highest matmul precision;
  4. the MovieLens-100k shape: the catalog's ``bayes`` argv for 3 steps and
     the 256-candidate, 5-value exp-variance lookahead at d=10;
  5. every model family's golden CLI run (tests/golden/regen.py) in float64
     on the GPU, compared with the committed digests.

``--multi`` runs only one exp-variance step of the phase-3 flagship with
``--shard-candidates 4`` and the same step unsharded on device 0.

All data is synthetic, made from ``--seed`` in the reference schema. The
last line of output is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it, as does a run where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

FLAGSHIP = ("drugbank-70x306-gibbs", "bayes_lookahead")
ML100K = ("movielens-100k-from5pct-test5pct", "bayes")
# unrolled solve vs reference, float32 on both sides: the two factor in
# different orders (left-looking columns vs cuSOLVER's potrf), so they agree
# to about cond(S) * d * 2^-24 ~ 1e-5 on these well-conditioned precisions
SOLVE_RTOL = 1e-4
# golden digests store err rounded to 1e-6; tests/test_golden.py's bound
GOLDEN_ATOL = 2e-6
# sharded vs unsharded lookahead scores: the same per-lane math compiled
# into two programs; float reassociation (TF32 products keep ~1e-3) can
# separate them, carried through 30 Gibbs samples
MULTI_RTOL = 1e-2
# default (TF32) vs highest-precision f32 matmuls in the Gibbs chain: a
# report, not a gate; the gate is that every score is finite
TF32_RTOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


class CompileTimer:
    """Seconds JAX spends tracing, lowering and compiling, from its own
    monitoring events."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def median_time(fn, *args, reps: int = 5) -> float:
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# synthetic data in the reference schema


def make_binary_data(path: str, seed: int, n=70, m=306, n_pick=400,
                     n_test=1000, pos_frac=0.1) -> None:
    """A +-1 interaction matrix with n_pick seed ratings and an equal-class
    test set (the drugbank-70x306-gibbs recipe's shape)."""
    from amf_tpu.data.loaders import save_npz_schema

    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(n, 5)) @ rng.normal(size=(5, m))
    latent += rng.normal(scale=0.5, size=(n, m))
    real = np.where(latent > np.quantile(latent, 1 - pos_frac), 1.0, -1.0)
    cells = rng.permutation(n * m)
    known = np.zeros(n * m, bool)
    known[cells[:n_pick]] = True
    rest = cells[n_pick:]
    test = np.zeros(n * m, bool)
    for v in (-1.0, 1.0):
        test[rest[real.ravel()[rest] == v][: n_test // 2]] = True
    save_npz_schema(path, {
        "_real": real, "_known": known.reshape(n, m),
        "_rating_vals": np.asarray([-1.0, 1.0]),
        "_test_on": test.reshape(n, m),
    })


def make_ratings_data(path: str, seed: int, n=943, m=1682, n_known=100000,
                      frac=0.05) -> None:
    """A 1..5 rating matrix with MovieLens-100k's shape and count of known
    cells (the rest are 0, unknowable); frac of the known cells seed the
    model and another frac are the test set."""
    from amf_tpu.data.loaders import save_npz_schema

    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(n, 10)) @ rng.normal(size=(10, m)) / 3.0
    rating = np.clip(np.round(latent + 3.5 + rng.normal(scale=0.5,
                                                         size=(n, m))), 1, 5)
    cells = rng.choice(n * m, size=n_known, replace=False)
    real = np.zeros(n * m)
    real[cells] = rating.ravel()[cells]
    k = int(frac * n_known)
    known = np.zeros(n * m, bool)
    known[cells[:k]] = True
    test = np.zeros(n * m, bool)
    test[cells[k:2 * k]] = True
    save_npz_schema(path, {
        "_real": real.reshape(n, m), "_known": known.reshape(n, m),
        "_rating_vals": np.arange(1.0, 6.0),
        "_test_on": test.reshape(n, m),
    })


def catalog_argv(exp: str, run: str, data: str, out: str, steps: int):
    """The experiment catalog's argv for one run, with its step count cut."""
    from amf_tpu.run import experiment

    module, *argv = experiment.catalog()[exp].runs[run]
    argv = experiment._fill(argv, data, out)
    argv[argv.index("--steps") + 1] = str(steps)
    return module, argv


@contextlib.contextmanager
def step_clock():
    """Wall-clock stamp at each recorded step of drive_active."""
    from amf_tpu.utils.checkpoint import LoopCheckpointer

    stamps = []
    orig = LoopCheckpointer.update

    def update(self, key, records, force=False):
        if not force:
            stamps.append(time.perf_counter())
        return orig(self, key, records, force=force)

    with mock.patch.object(LoopCheckpointer, "update", update):
        yield stamps


def run_cli(module: str, argv, timer: CompileTimer):
    """main(argv) of a CLI in this process; returns (wall s, compile s,
    per-step s)."""
    import importlib

    main = importlib.import_module(module).main
    c0 = timer.total
    t0 = time.perf_counter()
    with step_clock() as stamps:
        main(argv)
    wall = time.perf_counter() - t0
    steps = np.diff([t0] + stamps).tolist()
    return wall, timer.total - c0, steps


def load_results(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def check_records(records, queryable0: np.ndarray, label: str) -> None:
    """Every step scored each queryable cell finitely and picked one."""
    queryable = queryable0.copy()
    for step, rec in enumerate(records[1:], 1):
        (i, j), evals = rec[2], np.asarray(rec[3])
        if not np.all(np.isfinite(evals[queryable])):
            bad = int(np.sum(~np.isfinite(evals[queryable])))
            raise AssertionError(f"{label} step {step}: {bad} queryable "
                                 "scores are not finite")
        if not queryable[i, j]:
            raise AssertionError(f"{label} step {step}: pick ({i},{j}) "
                                 "is not queryable")
        if not np.isfinite(rec[1]):
            raise AssertionError(f"{label} step {step}: err {rec[1]}")
        queryable[i, j] = False


def initial_queryable(data: str) -> np.ndarray:
    from amf_tpu.data.loaders import load_npz_schema

    d = load_npz_schema(data)
    real = d["_real"]
    q = np.isfinite(real) & (real != 0)
    r = d["_ratings"].astype(int)
    q[r[:, 0], r[:, 1]] = False
    return q & ~np.asarray(d["_test_on"], bool)


# ---------------------------------------------------------------------------
# the lookahead tile outside the CLI


def tile_setup(data: str, latent_d: int, seed: int):
    """(jitted tile scorer, its array arguments, candidates) for the
    exp-variance lookahead on ``data``, as the loop's first step sees it."""
    import jax
    import jax.numpy as jnp

    from amf_tpu import types
    from amf_tpu.data.loaders import load_npz_schema
    from amf_tpu.models import bpmf_gibbs, pmf

    d = load_npz_schema(data)
    vals = tuple(float(v) for v in d["_rating_vals"])
    prob = types.problem_from_ratings(d["_ratings"], real=d["_real"],
                                      test=d["_test_on"], dtype=jnp.float32)
    n, m = prob.shape
    pcfg = pmf.PMFConfig(latent_d=latent_d, subtract_mean=True)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=latent_d, subtract_mean=True)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    pst = pmf.init_state(k1, n, m, pcfg, prob, dtype=jnp.float32)
    pst, _ = jax.jit(lambda s, p: pmf.fit(s, p, pcfg))(pst, prob)
    bounds = tuple(types.rating_bounds(vals))
    stats = jax.jit(lambda s, p, k: bpmf_gibbs.run_chain(
        k, bpmf_gibbs.init_chain(s), p, gcfg, 128, value_bounds=bounds)[1]
    )(pst, prob, k2)

    def score(k, pst, prob, stats, cand):
        return bpmf_gibbs.exp_variance_scores(
            k, pst, prob, pcfg, gcfg, stats, vals, num_samps=30,
            n_base_samples=128, cand=cand)

    cand = np.flatnonzero(np.asarray(prob.queryable).ravel()).astype(np.int32)
    return score, (k3, pst, prob, stats), cand


def reference_path():
    """Route the Gibbs row draws to the plain-JAX reference while tracing."""
    from amf_tpu.ops import chol_sample

    return mock.patch.object(chol_sample, "use_unrolled", lambda d: False)


# ---------------------------------------------------------------------------
# phases


def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {dev.device_kind}, {len(jax.devices())} device(s)")
    log(f"card: {smi}")
    return dev


def phase_solve(seed: int, tmp: str, timer: CompileTimer):
    """The GPU path of the Gibbs row draw against its reference; returns
    the flagship tile and its default-precision scores for phase 3."""
    import jax
    import jax.numpy as jnp

    from amf_tpu.ops import chol_sample

    for lanes, rows, d in ((512, 306, 20), (160, 1682, 10)):
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)

        @jax.jit
        def make(k1, k2, k3):
            A = jax.random.normal(k1, (lanes, rows, d, d), jnp.float32)
            S = A @ jnp.swapaxes(A, -1, -2) + d * jnp.eye(d)
            rhs = jax.random.normal(k2, (lanes, rows, d), jnp.float32)
            z = jax.random.normal(k3, (lanes, rows, d), jnp.float32)
            cols = jnp.transpose(S, (0, 3, 2, 1)).reshape(lanes, d * d, rows)
            return S, rhs, z, cols, jnp.swapaxes(rhs, 1, 2), jnp.swapaxes(z, 1, 2)

        S, rhs, z, cols, rhs_t, z_t = make(k1, k2, k3)
        ref_fn = jax.jit(chol_sample.chol_solve_sample_reference)
        unr_fn = jax.jit(chol_sample.chol_solve_sample_unrolled)
        want = np.asarray(ref_fn(S, rhs, z))
        got = np.swapaxes(np.asarray(unr_fn(cols, rhs_t, z_t)), 1, 2)
        err = float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))
        t_ref = median_time(ref_fn, S, rhs, z, reps=10)
        t_unr = median_time(unr_fn, cols, rhs_t, z_t, reps=10)
        log(f"[2 solve] B={lanes}x{rows} d={d}: max scaled err {err:.2e} "
            f"(tol {SOLVE_RTOL:g}); median unrolled {t_unr * 1e3:.3f} ms, "
            f"reference {t_ref * 1e3:.3f} ms")
        if not err <= SOLVE_RTOL:
            raise AssertionError(f"unrolled vs reference err {err:.2e}")
        del S, rhs, z, cols, rhs_t, z_t

    data = os.path.join(tmp, "flagship.npz")
    make_binary_data(data, seed)
    score, args, cand = tile_setup(data, 20, seed)
    tile = jnp.asarray(cand[:256])
    outs = {}
    for name in ("unrolled", "reference"):
        with reference_path() if name == "reference" else contextlib.nullcontext():
            # a fresh function per variant: jit caches traces by function
            fn = jax.jit(lambda *a: score(*a))
            c0 = timer.total
            outs[name] = np.asarray(fn(*args, tile))
            compile_s = timer.total - c0
            t = median_time(fn, *args, tile, reps=3)
        if not np.all(np.isfinite(outs[name])):
            raise AssertionError(f"{name} tile scores not finite")
        log(f"[2 tile] exp_variance_scores 70x306 d=20, 256 candidates x 2 "
            f"values, {name}: median {t:.3f} s, compile {compile_s:.1f} s")
    return score, args, tile, outs["unrolled"]


def phase_flagship(seed: int, tmp: str, timer: CompileTimer, tile_args):
    import jax

    data = os.path.join(tmp, "flagship.npz")
    out = os.path.join(tmp, "flagship")
    module, argv = catalog_argv(*FLAGSHIP, data, out, steps=3)
    wall, comp, steps = run_cli(module, argv, timer)
    res = load_results(os.path.join(out, "results_bayes_la.pkl"))
    recs = res["exp-variance"]
    check_records(recs, initial_queryable(data), "flagship")
    log(f"[3 flagship] {len(recs) - 1} steps in {wall:.1f} s, compile "
        f"{comp:.1f} s; per step " + ", ".join(f"{s:.1f}" for s in steps)
        + " s (the first includes set-up and the initial fit)")

    score, args, tile, default = tile_args
    with jax.default_matmul_precision("highest"):
        highest = np.asarray(jax.jit(score)(*args, tile))
    if not np.all(np.isfinite(highest)):
        raise AssertionError("highest-precision tile: non-finite scores")
    rel = float(np.max(np.abs(default - highest) / np.abs(highest)))
    same = int(np.argmin(default)) == int(np.argmin(highest))
    log(f"[3 precision] default vs highest f32 matmuls, 256 candidates: "
        f"max rel diff {rel:.2e} ({'within' if rel <= TF32_RTOL else 'OUTSIDE'}"
        f" {TF32_RTOL:g}); top pick {'agrees' if same else 'differs'}")


def phase_ml100k(seed: int, tmp: str, timer: CompileTimer):
    import jax
    import jax.numpy as jnp

    data = os.path.join(tmp, "ml100k.npz")
    make_ratings_data(data, seed)
    out = os.path.join(tmp, "ml100k")
    module, argv = catalog_argv(*ML100K, data, out, steps=3)
    wall, comp, steps = run_cli(module, argv, timer)
    res = load_results(os.path.join(out, "results_bayes.pkl"))
    q0 = initial_queryable(data)
    for key in ("random", "pred-variance"):
        check_records(res[key], q0, f"ml100k {key}")
    log(f"[4 ml100k] random + pred-variance, 3 steps each, in {wall:.1f} s, "
        f"compile {comp:.1f} s; per step "
        + ", ".join(f"{s:.1f}" for s in steps) + " s")

    score, args, cand = tile_setup(data, 10, seed)
    fn = jax.jit(score)
    chunks = [jnp.asarray(cand[t:t + 32]) for t in range(0, 256, 32)]
    c0 = timer.total
    jax.block_until_ready(fn(*args, chunks[0]))
    comp = timer.total - c0
    t0 = time.perf_counter()
    scores = np.concatenate([np.asarray(fn(*args, c)) for c in chunks])
    dt = time.perf_counter() - t0
    if not np.all(np.isfinite(scores)):
        raise AssertionError("ml100k lookahead: non-finite scores")
    log(f"[4 lookahead] 943x1682 d=10, 256 candidates x 5 values in tiles "
        f"of 32: {dt:.2f} s ({256 / dt:.1f} candidates/s), compile "
        f"{comp:.1f} s")


def phase_golden(tmp: str, timer: CompileTimer):
    import jax

    golden = os.path.join(HERE, "tests", "golden")
    spec = importlib.util.spec_from_file_location(
        "golden_regen", os.path.join(golden, "regen.py"))
    regen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(regen)
    out = os.path.join(tmp, "golden")
    os.makedirs(out)
    t0 = time.perf_counter()
    c0 = timer.total
    digests = regen.run_all(os.path.join(golden, "golden_data.npz"), out)
    wall, comp = time.perf_counter() - t0, timer.total - c0
    if not jax.config.jax_enable_x64:
        raise AssertionError("golden CLIs did not run in float64")
    worst = 0.0
    notes = []
    for fam, got in digests.items():
        with open(os.path.join(golden, f"golden_{fam}.json")) as f:
            want = json.load(f)
        res = load_results(os.path.join(out, fam + ".pkl"))
        for key, wrecs in want.items():
            grecs = got[key]
            for step, (g, w) in enumerate(zip(grecs, wrecs)):
                if g["pick"] != w["pick"]:
                    evals = np.asarray(res[key][step][3])
                    a, b = evals[tuple(g["pick"])], evals[tuple(w["pick"])]
                    if abs(a - b) > GOLDEN_ATOL * max(1.0, abs(a)):
                        raise AssertionError(
                            f"golden {fam}/{key} step {step}: pick "
                            f"{g['pick']} vs {w['pick']}, scores {a} vs {b}")
                    notes.append(f"{fam}/{key} step {step} tie {a} vs {b}")
                    break  # later steps start from another problem
                diff = abs(g["err"] - w["err"])
                worst = max(worst, diff)
                if g["n_rated"] != w["n_rated"] or diff > GOLDEN_ATOL:
                    raise AssertionError(
                        f"golden {fam}/{key} step {step}: {g} vs {w}")
    log(f"[5 golden] {', '.join(digests)} in float64 on "
        f"{jax.devices()[0].platform}: picks identical"
        + (f" except ties ({'; '.join(notes)})" if notes else "")
        + f", max |err diff| {worst:.1e} (tol {GOLDEN_ATOL:g}); {wall:.1f} s, "
        f"compile {comp:.1f} s")


def phase_multi(seed: int, tmp: str, timer: CompileTimer):
    import jax

    if len(jax.devices()) < 4:
        raise SystemExit(f"--multi needs 4 GPUs, JAX found {len(jax.devices())}")
    data = os.path.join(tmp, "flagship.npz")
    make_binary_data(data, seed)
    evals, picks = {}, {}
    for name, extra in (("unsharded", []), ("sharded", ["--shard-candidates", "4"])):
        out = os.path.join(tmp, name)
        module, argv = catalog_argv(*FLAGSHIP, data, out, steps=2)
        wall, comp, _ = run_cli(module, argv + extra, timer)
        recs = load_results(os.path.join(out, "results_bayes_la.pkl"))["exp-variance"]
        check_records(recs, initial_queryable(data), name)
        evals[name], picks[name] = np.asarray(recs[1][3]), tuple(recs[1][2])
        log(f"[multi {name}] one exp-variance step in {wall:.1f} s, compile "
            f"{comp:.1f} s; pick {picks[name]}")
    a, b = evals["unsharded"], evals["sharded"]
    fin = np.isfinite(a)
    if not np.array_equal(fin, np.isfinite(b)):
        raise AssertionError("sharded and unsharded score different cells")
    rel = float(np.max(np.abs(a[fin] - b[fin]) / np.abs(a[fin])))
    bitwise = bool(np.array_equal(a[fin], b[fin]))
    log(f"[multi] {int(fin.sum())} scores: max rel diff {rel:.2e} (tol "
        f"{MULTI_RTOL:g}), bitwise identical: {bitwise}")
    if picks["sharded"] != picks["unsharded"]:
        raise AssertionError(f"picks differ: {picks}")
    if not rel <= MULTI_RTOL:
        raise AssertionError(f"sharded scores differ by {rel:.2e}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--multi", action="store_true",
                        help="run only the 4-GPU candidate-sharded step")
    args = parser.parse_args(argv)

    from amf_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    import jax

    timer = CompileTimer()
    t0 = time.perf_counter()
    dev = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        if args.multi:
            phase_multi(args.seed, tmp, timer)
        else:
            tile_args = phase_solve(args.seed, tmp, timer)
            phase_flagship(args.seed, tmp, timer, tile_args)
            phase_ml100k(args.seed, tmp, timer)
            phase_golden(tmp, timer)
    log(f"total {time.perf_counter() - t0:.1f} s, compile {timer.total:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
