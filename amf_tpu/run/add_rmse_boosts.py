"""CLI: per-cell RMSE improvement from adding each candidate rating.

Mirrors the reference ``add_rmse_boosts.py`` (188 LoC): for every queryable
cell, add its TRUE rating, refit, and record the RMSE change — the reference
fans this out over a worker pool (fit_worker :50); here the batched
lookahead refit (models/pmf.fit_lookahead_batch) scores every cell in tiles
on-device.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load-data", required=True)
    parser.add_argument("--latent-d", "-D", type=int, default=5)
    parser.add_argument("--refit-steps", type=int, default=200)
    parser.add_argument("--tile", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="rmse_boosts.pkl")
    args = parser.parse_args(argv)

    from amf_tpu.utils.platform import setup as platform_setup

    backend = platform_setup(use_x64=False)
    print(f"backend: {backend}")

    import jax
    import jax.numpy as jnp

    from amf_tpu import types
    from amf_tpu.data.loaders import load_npz_schema
    from amf_tpu.models import pmf

    data = load_npz_schema(args.load_data)
    real = data["_real"]
    prob = types.problem_from_ratings(
        data["_ratings"], real=real, test=data.get("_test_on"),
        dtype=jnp.float32,
    )
    n, m = prob.shape
    cfg = pmf.PMFConfig(latent_d=args.latent_d)
    st = pmf.init_state(jax.random.PRNGKey(args.seed), n, m, cfg, prob)
    st, _ = pmf.fit(st, prob, cfg)

    real_j = jnp.asarray(real, jnp.float32)
    test = prob.test

    @jax.jit
    def base_rmse():
        pred = pmf.predicted_matrix(st, cfg)
        err = jnp.where(test, pred - real_j, 0.0)
        return jnp.sqrt(jnp.sum(err * err) / jnp.maximum(jnp.sum(test), 1))

    # pad candidate list to tile multiple
    qq = np.nonzero(np.asarray(prob.queryable).ravel())[0]
    pad = (-len(qq)) % args.tile
    cand = np.concatenate([qq, np.zeros(pad, qq.dtype)])
    valid = np.concatenate([np.ones(len(qq), bool), np.zeros(pad, bool)])

    @jax.jit
    def tile_rmses(di, dj, dv):
        U, V, _ = pmf.fit_lookahead_batch(
            st, prob, di, dj, dv, cfg, max_steps=args.refit_steps)
        pred = jnp.einsum("lnd,lmd->lnm", U, V)
        err = jnp.where(test[None], pred - real_j[None], 0.0)
        return jnp.sqrt(
            jnp.sum(err * err, axis=(1, 2)) / jnp.maximum(jnp.sum(test), 1)
        )

    r0 = float(base_rmse())
    print(f"base test RMSE: {r0:.5f}; scoring {len(qq)} candidates "
          f"in tiles of {args.tile}")

    boosts = np.full((n, m), np.nan)
    for t in range(len(cand) // args.tile):
        s = slice(t * args.tile, (t + 1) * args.tile)
        di = jnp.asarray(cand[s] // m, jnp.int32)
        dj = jnp.asarray(cand[s] % m, jnp.int32)
        dv = real_j[di, dj]  # TRUE value of each candidate cell
        rmses = np.asarray(tile_rmses(di, dj, dv))
        for c, ok, r in zip(cand[s], valid[s], rmses):
            if ok:
                boosts[c // m, c % m] = r0 - r

    with open(args.out, "wb") as f:
        pickle.dump({"_real": real, "base_rmse": r0, "boosts": boosts}, f)
    finite = boosts[np.isfinite(boosts)]
    print(f"wrote {args.out}; boost mean {finite.mean():.5f}, "
          f"max {finite.max():.5f}")


if __name__ == "__main__":
    main()
