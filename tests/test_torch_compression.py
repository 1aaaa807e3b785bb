"""The port's int8 center-exchange codec against the reference's, on the CPU.

Mirrors ``tests/test_compression.py`` and
``tests/test_distributed.py::TestInt8Codec``: the same numpy inputs go
through ``repro.distributed.compression`` and
``repro_torch.distributed.compression``, and the encodings must agree
EXACTLY (q and scales, and the packed wire bytes), at the block
remainders 0, 1 and 255 and with zeros, block extremes, huge values and
subnormals (which XLA's CPU backend flushes to zero and the port flushes
alike).  Decoding is bitwise too.  ``compressed_tree_mean`` over 2 gloo
ranks must equal the reference's per-shard ``decode_packed(encode_packed(
local_mean))`` averaged, to 0 ulp, with one all-gather.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_workers as w
from repro.distributed import compression as jc
from repro_torch import distributed as tdist
from repro_torch.distributed import compression as tc
from repro_torch.launch.mesh import spawn_local

BLOCK = tc.BLOCK


def _input(n, seed, kind):
    r = np.random.default_rng(seed)
    x = r.normal(size=n).astype(np.float32) * 3.0
    if kind == "mixed":  # zeros, block extremes, huge, tiny and subnormal values
        x[::7] = 0.0
        x[1::11] = 1e30
        x[2::13] = -5.0
        x[3::17] = 1e-40
        x[4::19] = -3e-39
        x[5::23] = 1e-37
    elif kind == "subnormal":  # whole blocks whose max is subnormal or tiny
        x = (r.normal(size=n) * 1e-39).astype(np.float32)
        x[: min(n, BLOCK)] *= 1e3  # one block of normal numbers near 1e-36
    return x


KINDS = ["normal", "mixed", "subnormal"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rem", [0, 1, BLOCK - 1])
@pytest.mark.parametrize("nblocks", [1, 3])
def test_encode_matches_reference_exactly(kind, rem, nblocks):
    n = nblocks * BLOCK + rem
    x = _input(n, n, kind)
    je = jc.int8_codec().encode(jnp.asarray(x))
    te = tc.int8_codec().encode(torch.from_numpy(x))
    np.testing.assert_array_equal(te["q"].numpy(), np.asarray(je["q"]))
    np.testing.assert_array_equal(te["scale"].numpy().view(np.int32),
                                  np.asarray(je["scale"]).view(np.int32))
    assert te["shape"] == tuple(je["shape"]) and te["n"] == int(je["n"])
    jd, td = jc.int8_codec().decode(je), tc.int8_codec().decode(te)
    np.testing.assert_array_equal(td.numpy().view(np.int32), np.asarray(jd).view(np.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rem", [0, 1, BLOCK - 1])
@pytest.mark.parametrize("shape_of", [lambda n: (n,), lambda n: (1, n)])
def test_packed_bytes_match_reference_exactly(kind, rem, shape_of):
    n = 2 * BLOCK + rem
    x = _input(n, 1000 + n, kind).reshape(shape_of(n))
    jp = np.asarray(jc.encode_packed(jnp.asarray(x)))
    tp = tc.encode_packed(torch.from_numpy(x))
    assert tp.dtype == torch.int8 and tuple(tp.shape) == (tc.packed_nbytes(n),)
    np.testing.assert_array_equal(tp.numpy(), jp)
    td = tc.decode_packed(tp, x.shape, n)
    jd = np.asarray(jc.decode_packed(jnp.asarray(jp), x.shape, n))
    np.testing.assert_array_equal(td.numpy().view(np.int32), jd.view(np.int32))
    # the packed encoding written into a slice of a larger buffer is the same
    buf = torch.zeros(tc.packed_nbytes(n) + 8, dtype=torch.int8)
    tc.encode_packed(torch.from_numpy(x), out=buf[4:4 + tc.packed_nbytes(n)])
    np.testing.assert_array_equal(buf[4:4 + tc.packed_nbytes(n)].numpy(), jp)


@pytest.mark.parametrize("shape", [(BLOCK,), (1000,), (3, 7, 11), (1,), (256, 4)])
def test_roundtrip_within_quantization_bound(shape):
    """|decode(encode(x)) - x| <= scale/2 per block, scale = max|block|/127."""
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32) * 3.0
    codec = tc.int8_codec()
    dec = codec.decode(codec.encode(torch.from_numpy(x)))
    assert tuple(dec.shape) == shape and dec.dtype == torch.float32
    flat = x.reshape(-1)
    blocks = np.pad(flat, (0, (-flat.size) % BLOCK)).reshape(-1, BLOCK)
    bound = np.repeat(np.abs(blocks).max(axis=1, keepdims=True) / 127.0, BLOCK,
                      axis=1).reshape(-1)[: flat.size]
    assert np.all(np.abs(dec.numpy().reshape(-1) - flat) <= 0.5 * bound + 1e-7)


def test_zero_blocks_and_extremes():
    """All-zero blocks decode to exact zeros (no 0/0); block maxima map to
    +-127 and decode to themselves."""
    codec = tc.int8_codec()
    x = torch.cat([torch.zeros(BLOCK), torch.full((BLOCK,), 2.0), torch.full((BLOCK,), -5.0),
                   torch.zeros(5)])
    enc = codec.encode(x)
    dec = codec.decode(enc)
    assert torch.equal(dec[:BLOCK], torch.zeros(BLOCK)) and torch.equal(dec[3 * BLOCK:],
                                                                        torch.zeros(5))
    torch.testing.assert_close(dec[BLOCK:3 * BLOCK], x[BLOCK:3 * BLOCK], rtol=1e-6, atol=0)
    assert enc["q"].dtype == torch.int8 and enc["q"][1].abs().max() == 127


def test_wire_format_and_sizes_match_reference():
    codec = tc.int8_codec()
    enc = codec.encode(torch.ones(1000))
    assert tuple(enc["q"].shape) == (4, BLOCK) and enc["n"] == 1000
    assert codec.ratio == pytest.approx(jc.int8_codec().ratio) and codec.ratio < 0.26
    for n in (1, 255, 256, 257, 1000, 596_049_920, 155_582_464):
        assert tc.packed_nbytes(n) == jc.packed_nbytes(n), n
        for comp in (False, True):
            assert (tc.sync_wire_bytes(n, compressed=comp, num_shards=4)
                    == jc.sync_wire_bytes(n, compressed=comp, num_shards=4)), (n, comp)
    assert tdist.int8_codec is tc.int8_codec and isinstance(codec, tdist.Int8Codec)


def test_compressed_tree_mean_two_ranks_matches_reference():
    """Each rank means its 2 local chains, packs both leaves into one int8
    buffer, all-gathers it once; the result is the reference's per-shard
    decode(encode(local mean)) averaged over the shards, to 0 ulp."""
    r = np.random.default_rng(5)
    shapes = {"a": (3, 300), "b": (70,)}
    trees = [{k: (r.normal(size=(2,) + s) * (1 + i)).astype(np.float32)
              for k, s in shapes.items()} for i in range(2)]
    outs = [rank_out[0] for rank_out in spawn_local(w.compressed_mean_rank, 2, trees,
                                                      timeout_s=120)]
    for k, s in shapes.items():
        n = int(np.prod(s))
        per_shard = [np.asarray(jc.decode_packed(jc.encode_packed(
            jnp.mean(jnp.asarray(t[k]), axis=0)), s, n)) for t in trees]
        want = (per_shard[0] + per_shard[1]) / np.float32(2.0)
        for rank, (got, counts) in enumerate(outs):
            np.testing.assert_array_equal(got[k].view(np.int32), want.view(np.int32),
                                          err_msg=f"{k} rank {rank}")
    for _, counts in outs:
        assert counts["all_gather"]["calls"] == 1 and counts["all_reduce"]["calls"] == 0
        assert counts["all_gather"]["bytes"] == sum(tc.packed_nbytes(int(np.prod(s)))
                                                    for s in shapes.values())


def test_tree_mean_axis0_over_two_ranks_is_the_pmean_of_local_means():
    """``core.tree_mean_axis0(tree, axis_name)``: the reference's pmean of
    the local means, one all-reduce for every leaf."""
    r = np.random.default_rng(6)
    shapes = {"a": (3, 30), "b": (7,)}
    trees = [{k: r.normal(size=(2,) + s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    outs = [rank_out[1] for rank_out in spawn_local(w.compressed_mean_rank, 2, trees,
                                                      timeout_s=120)]
    for k in shapes:
        local = [np.asarray(jnp.mean(jnp.asarray(t[k]), axis=0)) for t in trees]
        want = (local[0] + local[1]) / np.float32(2.0)
        for got, counts in outs:
            np.testing.assert_array_equal(got[k], want, err_msg=k)
            assert counts["all_reduce"]["calls"] == 1 and counts["all_gather"]["calls"] == 0
            assert counts["all_reduce"]["bytes"] == 4 * sum(int(np.prod(s))
                                                            for s in shapes.values())
