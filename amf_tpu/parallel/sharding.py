"""Sharded lookahead scoring over a device mesh.

The candidate axis of one-step lookahead is the framework's scaling axis
(SURVEY.md §2.4.1): per-candidate refits are independent until the final
argmax, so candidates shard over the mesh via ``shard_map`` with a single
gather at the end — the device-parallel replacement for the reference's
lock-guarded multiprocessing pool (active_pmf.py:1064-1082). Collectives are
XLA's; no pickle IPC.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from amf_tpu.parallel.mesh import CANDIDATE_AXIS


def sharded_candidate_scores(
    score_flat_fn,
    n_cells: int,
    mesh: Mesh,
    axis_name: str = CANDIDATE_AXIS,
):
    """Wrap a flat-candidate scorer for mesh execution.

    score_flat_fn(cand_idx (C,), key) -> (C,) scores (NaN off-pool), where
    every per-candidate computation is independent (it is: each lookahead
    lane refits its own hypothesized problem).

    Returns a jittable fn(key) -> (n_cells,) scores, computed with the
    candidate axis sharded over the mesh (padding to a device multiple).
    """
    n_dev = mesh.devices.size
    pad = (-n_cells) % n_dev
    total = n_cells + pad

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P()),
        out_specs=P(axis_name),
        # the scorers are free to scan from unvarying zero carries (e.g. the
        # Gibbs streaming-stat accumulators); the varying-manual-axes check
        # would reject those even though every lane is genuinely independent
        check_vma=False,
    )
    def score_shard(cand, key):
        # the same key goes to every shard: per-lane streams are derived from
        # GLOBAL candidate indices inside the scorers (utils/rng.lane_keys),
        # so sharded and unsharded runs produce bitwise-identical scores
        return score_flat_fn(cand, key)

    def run(key):
        cand = jnp.arange(total, dtype=jnp.int32)
        scores = score_shard(cand, key)
        return scores[:n_cells]

    return run


def best_candidate(scores: jax.Array, queryable_flat: jax.Array, maximize: bool):
    """Final argmax/argmin reduction (the only cross-candidate communication;
    reference analogue: the chooser over pool.map results,
    active_pmf.py:729-737). Falls back to the first queryable cell when no
    queryable score is finite (the reference selectors' candidate vectors
    only contain queryable cells, so they cannot pick off-pool)."""
    if maximize:
        masked = jnp.where(queryable_flat, scores, -jnp.inf)
        best = jnp.argmax(masked)
    else:
        masked = jnp.where(queryable_flat, scores, jnp.inf)
        best = jnp.argmin(masked)
    return jnp.where(
        jnp.isfinite(masked[best]), best, jnp.argmax(queryable_flat)
    )


def sharded_chain_map(run_one, mesh: Mesh, axis_name: str = CANDIDATE_AXIS):
    """vmap a per-chain function with the chain axis sharded over the mesh —
    the device-parallel replacement for the reference's process-parallel Stan
    chains (stan-bpmf/bpmf.py:314 ``chains`` fan-out over R processes).

    run_one(key) -> pytree of per-chain outputs. Returns fn(keys (C, 2)) ->
    stacked outputs with the leading chain axis sharded; C must be a multiple
    of the mesh size. Chains are independent (no collectives), so sharded ==
    vmapped exactly: per-chain streams come from the explicit keys.
    """
    n_dev = mesh.devices.size

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
        check_vma=False,
    )
    def run_shard(keys):
        return jax.vmap(run_one)(keys)

    def run(keys):
        if keys.shape[0] % n_dev:
            raise ValueError(
                f"chains ({keys.shape[0]}) must be a multiple of the mesh "
                f"size ({n_dev})"
            )
        return run_shard(keys)

    return run
