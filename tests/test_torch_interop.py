"""Crossing between the reference package and the port: tensor round trips
(f32, bf16 through uint16 bits, int32), the dtype map, the config copy,
and the pure-numpy pieces the port copies (``synthetic_trace`` and
``BlockAllocator``) giving identical results for the same inputs."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import BlockAllocator as JBlockAllocator
from repro.serve.engine import synthetic_trace as jsynthetic_trace
from repro_torch import _interop
from repro_torch.serve.engine import BlockAllocator, synthetic_trace


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_leaf_round_trip(dtype):
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 5)) * 100
    x = x.astype(dtype)
    tree = {"a": {"w": np.asarray(x)}, "b": np.asarray(x)[0]}
    t = _interop.tree_from_numpy(tree)
    assert t["a"]["w"].dtype == _interop.torch_dtype(dtype)
    back = _interop.tree_to_numpy(t)
    want = np.asarray(x).view(np.uint16) if dtype == jnp.bfloat16 else np.asarray(x)
    np.testing.assert_array_equal(back["a"]["w"], want)
    np.testing.assert_array_equal(back["b"], want[0])
    if dtype == jnp.bfloat16:  # the same bits, read as values on both sides
        np.testing.assert_array_equal(t["a"]["w"].float().numpy(), np.asarray(x, np.float32))
        np.testing.assert_array_equal(np.asarray(back["a"]["w"].view(jnp.bfloat16)), np.asarray(x))


def test_dtype_map():
    assert _interop.torch_dtype(jnp.float32) is torch.float32
    assert _interop.torch_dtype(jnp.bfloat16) is torch.bfloat16
    assert _interop.torch_dtype(np.dtype("int32")) is torch.int32
    assert _interop.torch_dtype("float16") is torch.float16
    assert _interop.torch_dtype(torch.bfloat16) is torch.bfloat16
    with pytest.raises(ValueError):
        _interop.torch_dtype("complex64")


@pytest.mark.parametrize("kw", [
    dict(prompt_lens=(8, 16), max_new=16),
    dict(prompt_lens=(64, 128), max_new=32, mean_interarrival=0.5),
    dict(prompt_lens=(5,), max_new=3, prompt_pool=2),
])
def test_synthetic_trace_identical(kw):
    a = synthetic_trace(12, vocab_size=151936, seed=4, **kw)
    b = jsynthetic_trace(12, vocab_size=151936, seed=4, **kw)
    assert [(r.rid, r.max_new, r.arrival_step) for r in a] == \
           [(r.rid, r.max_new, r.arrival_step) for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_block_allocator_identical_under_script():
    """One scripted alloc/free/share sequence through the copy and the
    original gives the same tables, positions and stats at every step."""
    kw = dict(num_blocks=14, block_size=4, max_seq=20, num_slots=4)
    a, b = BlockAllocator(**kw), JBlockAllocator(**kw)
    shared = np.arange(1, 10, dtype=np.int32)
    script = [
        ("admit", 0, shared, 5), ("admit", 1, shared, 3), ("grow", 0), ("grow", 0),
        ("admit", 2, np.arange(3, 6, dtype=np.int32), 6), ("release", 1), ("grow", 2),
        ("admit", 1, shared, 4), ("release", 0), ("invalidate", 1), ("release", 2),
        ("admit", 3, shared, 2), ("release", 1), ("release", 3),
    ]
    for op in script:
        for alloc in (a, b):
            if op[0] == "admit":
                assert alloc.can_admit(op[2], op[3])
                alloc.admit(op[1], op[2], op[3])
            elif op[0] == "grow":
                alloc.ensure_decode_block(op[1])
                alloc.advance(op[1])
            elif op[0] == "release":
                alloc.release(op[1])
            else:
                alloc.invalidate_version(op[1])
            alloc.check()
        np.testing.assert_array_equal(a.tables, b.tables)
        np.testing.assert_array_equal(a.ctx, b.ctx)
        np.testing.assert_array_equal(a.refcount, b.refcount)
        assert a.stats() == b.stats()
