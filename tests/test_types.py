"""The pytree dataclass helper (types.pytree_dataclass)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amf_tpu.types import pytree_dataclass


@pytree_dataclass
class Pair:
    a: jax.Array
    b: jax.Array


def test_flatten_unflatten_roundtrip():
    p = Pair(a=jnp.arange(3.0), b=jnp.ones((2, 2)))
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2
    q = jax.tree.unflatten(treedef, [x * 2 for x in leaves])
    assert isinstance(q, Pair)
    np.testing.assert_array_equal(q.a, 2 * p.a)
    np.testing.assert_array_equal(q.b, 2 * p.b)


def test_replace_returns_a_changed_copy():
    p = Pair(a=jnp.zeros(2), b=jnp.ones(2))
    q = p.replace(b=jnp.full(2, 5.0))
    np.testing.assert_array_equal(q.b, [5.0, 5.0])
    np.testing.assert_array_equal(p.b, [1.0, 1.0])
    assert q.a is p.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_jit_and_vmap_over_the_dataclass():
    p = Pair(a=jnp.arange(4.0), b=jnp.arange(4.0) + 1)
    out = jax.jit(lambda x: x.replace(a=x.a + x.b))(p)
    np.testing.assert_array_equal(out.a, [1.0, 3.0, 5.0, 7.0])
    summed = jax.vmap(lambda x: x.a * x.b)(p)
    np.testing.assert_array_equal(summed, [0.0, 2.0, 6.0, 12.0])
