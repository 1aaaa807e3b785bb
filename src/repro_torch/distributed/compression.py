"""Center-exchange compression for the EC sync collective: the port of
``repro/distributed/compression.py``.

int8 with per-block scales (a block is 256 consecutive elements of the
flat array).  The quantization error of the exchanged chain mean is
absorbed into the center-noise covariance C of Eq. 6: EC-SGHMC is built to
tolerate a noisy center, so compressing its one collective costs no
correctness the sampler relies on.

* ``int8_codec().encode/decode`` — the structured round trip (q, scale),
  used by single-process runs (quantize the already-reduced mean: the wire
  noise without fewer bytes) and by the cache pools' idle parking.
* ``encode_packed``/``decode_packed`` — the wire format: the int8 payload,
  then the f32 scales viewed as int8 (little-endian, as
  ``jax.lax.bitcast_convert_type`` lays them out), in one flat int8
  buffer.  Byte for byte the reference's on the same f32 input.
* ``compressed_tree_mean`` — the s-periodic exchange over a bound chain
  axis: every rank packs its local chain means of every leaf into ONE int8
  buffer and makes ONE all-gather of it, then decodes each rank's row and
  averages them in rank order, so every rank gets the same bits.

Subnormal numbers: the reference runs on XLA's CPU backend, which flushes
subnormal inputs and results to zero.  ``encode`` flushes them the same
way (inputs and scales), so the bytes agree for any f32 input.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_unflatten

from . import collectives

BLOCK = 256
_TINY = torch.finfo(torch.float32).tiny  # the smallest normal f32


class Int8Codec(NamedTuple):
    encode: Callable
    decode: Callable
    ratio: float  # wire-bytes ratio against f32


def _flush(x):
    """Subnormal elements of an f32 tensor to zero, keeping their sign."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def true_div(x, d: float):
    """x / d rounded as IEEE division rounds it.  ``x / d`` with a Python
    number d runs as x * (1 / d) on CUDA, which rounds differently; a 0-d
    tensor on x's device divides."""
    return x / x.new_full((), d)


def _encode(x) -> dict:
    shape = tuple(x.shape)
    flat = _flush(x.float().reshape(-1))
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = _flush(true_div(torch.amax(flat.abs(), dim=1, keepdim=True), 127.0))
    q = torch.round(flat / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale, "shape": shape, "n": x.numel()}


def _decode(enc) -> torch.Tensor:
    flat = enc["q"].float() * enc["scale"]
    return flat.reshape(-1)[: enc["n"]].reshape(enc["shape"])


def int8_codec() -> Int8Codec:
    return Int8Codec(_encode, _decode, ratio=(1 + 4 / BLOCK) / 4)


def _num_blocks(n: int) -> int:
    return max(1, math.ceil(n / BLOCK))


def packed_nbytes(n: int) -> int:
    """Wire bytes of one packed encoding of an ``n``-element f32 array."""
    return _num_blocks(n) * (BLOCK + 4)


def encode_packed(x, out=None) -> torch.Tensor:
    """Encode to a flat int8 wire buffer of ``packed_nbytes(x.numel())``
    bytes on x's device, written into ``out`` when it is given."""
    enc = _encode(x)
    q, scale_bytes = enc["q"].reshape(-1), enc["scale"].reshape(-1).view(torch.int8)
    if out is None:
        return torch.cat([q, scale_bytes])
    out[: q.numel()].copy_(q)
    out[q.numel():].copy_(scale_bytes)
    return out


def decode_packed(packed, shape, n: int) -> torch.Tensor:
    """Inverse of :func:`encode_packed` (``shape`` and ``n`` come from the
    tree's structure, not the wire)."""
    b = _num_blocks(n)
    q = packed[: b * BLOCK].reshape(b, BLOCK)
    scale = packed[b * BLOCK: b * (BLOCK + 4)].contiguous().view(torch.float32).reshape(b, 1)
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compressed_mean_into(outs, local_mean: Callable, axis: collectives.AxisBinding) -> None:
    """The wire-compressed chain mean, leaf by leaf into ``outs``:
    ``local_mean(i)`` is this rank's f32 mean of leaf i over its local
    chains, shaped like ``outs[i]``.  Each local mean is packed into ONE
    int8 buffer as soon as it is made, the buffer is all-gathered over
    ``axis`` (the only collective), and each leaf's rows are decoded and
    averaged in rank order into its ``outs`` tensor.  Equal chain counts per
    rank make the mean of rank means the global chain mean, up to the int8
    noise."""
    sizes = [packed_nbytes(o.numel()) for o in outs]
    packed = torch.empty(sum(sizes), dtype=torch.int8, device=outs[0].device)
    off = 0
    for i, nb in enumerate(sizes):
        encode_packed(local_mean(i), out=packed[off: off + nb])
        off += nb
    rows = collectives.all_gather(packed, axis)  # (W, total) int8
    off = 0
    for out, nb in zip(outs, sizes):
        acc = None
        for r in range(axis.size):
            x = decode_packed(rows[r, off: off + nb], out.shape, out.numel())
            acc = x if acc is None else acc.add_(x)
        out.copy_(true_div(acc, axis.size))
        off += nb


def compressed_tree_mean(tree, axis_name: str):
    """The wire-compressed chain mean of a tree whose leaves carry a
    leading axis of local chains, over the bound chain axis ``axis_name``
    (``collectives.bind_axis``): one all-gather of one packed int8 buffer.
    Returns the tree of f32 global means."""
    leaves = tree_leaves(tree)
    outs = [torch.empty(tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
            for x in leaves]
    compressed_mean_into(outs, lambda i: torch.mean(leaves[i].float(), dim=0),
                         collectives.axis(axis_name))
    return tree_unflatten(tree, outs)


def sync_wire_bytes(num_params: int, *, compressed: bool, num_shards: int = 1) -> int:
    """Per-rank payload bytes of ONE s-periodic center exchange: the raw
    f32 all-reduce's operand (4 bytes a parameter) or the packed int8
    all-gather's (``packed_nbytes``).  Both count the collective's input,
    as the reference does; link traffic scales both by the collective
    algorithm's factor alike."""
    del num_shards
    return packed_nbytes(num_params) if compressed else 4 * num_params
