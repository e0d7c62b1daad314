"""Adjudicate the db94 stan pred-variance strict-band failure (round 3).

The fixed-sampler re-record of drugbank-94x425 stan (reference arm:
results/drugbank-94x425/Makefile, keys random/pred-variance/pred/prob-ge-0)
fails the strict learning band: pred-variance misclassification rises
0.4840 -> 0.5000 over 150 steps. This script quantifies, from the committed
digest alone, whether that is a real regression or single-seed drift at the
metric's noise floor:

- endpoint rise in units of the per-step binomial standard error
  (se = sqrt(p(1-p)/n_test), n_test = 2000 equal-class cells);
- first-quartile vs last-quartile curve means (less endpoint-sensitive;
  note successive steps are correlated so the naive seQ is optimistic);
- the same statistics for every other key on the arm, as controls.

Writes experiments/drugbank-94x425/adjudication_learning_drift.json.
The decisive evidence (4-seed replicate bands, `--seeds 4 --only stan`) is
still to be recorded; until it lands the strict-band failure
STANDS — this artifact documents the drift analysis, it does not downgrade
the fail.
"""

import gzip
import json

import numpy as np

EXP = "experiments/drugbank-94x425"
N_TEST = 2000  # choose_training --n-test 2000 (test-equal-classes)


def main():
    with gzip.open(f"{EXP}/digest_stan.json.gz", "rt") as f:
        dg = json.load(f)
    se = float(np.sqrt(0.25 / N_TEST))
    rows = {}
    for key, v in dg["criteria"].items():
        e = np.asarray(v["err"], float)
        q = len(e) // 4
        d_end = float(e[-1] - e[0])
        d_q = float(e[-q:].mean() - e[:q].mean())
        rows[key] = {
            "err_start": float(e[0]),
            "err_end": float(e[-1]),
            "endpoint_rise": d_end,
            "endpoint_rise_se": d_end / se,
            "firstQ_mean": float(e[:q].mean()),
            "lastQ_mean": float(e[-q:].mean()),
            "quartile_drift": d_q,
        }
    out = {
        "check": "strict learning-band failure adjudication "
                 "(stan pred-variance, misclassification)",
        "workload": EXP,
        "n_test": N_TEST,
        "binomial_se_per_step": se,
        "per_key": rows,
        "observations": [
            "every key, including pure-exploitation `pred`, stays inside "
            "[0.484, 0.50] — the model is at chance on equal-class "
            "misclassification for this workload regardless of criterion",
            "pred-variance endpoint rise is +1.4 se; quartile means drift "
            "up ~0.007 while pred is flat and prob-ge-0 drifts down",
            "the reference-documented DrugBank win is discovery, and it "
            "reproduces: prob-ge-0 finds positives 3.3x faster than random "
            "(discovery band, 738.5 vs 221.5)",
        ],
        "verdict": (
            "single-seed upward drift at the metric noise floor on a "
            "chance-level curve; not yet distinguishable from a mild "
            "criterion pathology — strict-band FAIL stands until the "
            "4-seed replicate bands decide"
        ),
    }
    path = f"{EXP}/adjudication_learning_drift.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["per_key"]["pred-variance"], indent=1))
    print("wrote", path)


if __name__ == "__main__":
    main()
