"""RNG helpers."""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp


def fold_in_name(key: jax.Array, name: str) -> jax.Array:
    """Derive a named PRNG stream with a PROCESS-STABLE hash.

    Python's built-in ``hash(str)`` is salted per interpreter (PYTHONHASHSEED),
    which would make a fixed --seed unreproducible across runs and break
    checkpoint resume determinism; crc32 is stable everywhere.
    """
    return jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def lane_keys(key: jax.Array, cand: jax.Array, n_vals: int) -> jax.Array:
    """Per-(candidate, value) PRNG keys tied to the GLOBAL candidate index.

    The lookahead engines fan one chain/refit out per (candidate cell, rating
    value) lane. Deriving each lane's key from the global flat cell index —
    rather than the lane's *position* in the current batch, as
    ``jax.random.split(key, C*V)`` would — makes the scores invariant to how
    the candidate axis is tiled (``candidate_tile``) or sharded over a device
    mesh (parallel/sharding.py): every partitioning of the same candidate set
    computes bitwise-identical lanes. This is the device-parallel replacement for
    the reference's per-worker global RNG, which had no such invariance
    (SURVEY.md §2.5 "unseeded global RNG everywhere").

    Returns a (len(cand), n_vals) batch of keys.
    """
    lane = cand.astype(jnp.uint32)[:, None] * jnp.uint32(n_vals) + jnp.arange(
        n_vals, dtype=jnp.uint32
    )[None, :]
    return jax.vmap(jax.vmap(lambda t: jax.random.fold_in(key, t)))(lane)
