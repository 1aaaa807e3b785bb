"""Chains across ranks (DESIGN.md §7, items 1-3): the int8 center-exchange
codec and its packed wire format, the chain-axis layout of a sampler's
carry, and the counted collectives the s-periodic exchange issues over a
``torch.distributed`` process group.  The counterpart of
``repro/distributed``."""
from . import collectives, compression, sharding
from .collectives import (
    AxisBinding,
    axis,
    bind_axis,
    collective_counts,
    host_world,
    mesh_axis,
    reset_collective_counts,
)
from .compression import (
    BLOCK,
    Int8Codec,
    compressed_mean_into,
    compressed_tree_mean,
    decode_packed,
    encode_packed,
    int8_codec,
    packed_nbytes,
    sync_wire_bytes,
)
from .sharding import chain_specs, gather_chains, leading_axes_specs, local_block, local_chains

__all__ = [
    "AxisBinding",
    "BLOCK",
    "Int8Codec",
    "axis",
    "bind_axis",
    "chain_specs",
    "collective_counts",
    "collectives",
    "compressed_mean_into",
    "compressed_tree_mean",
    "compression",
    "decode_packed",
    "encode_packed",
    "gather_chains",
    "host_world",
    "int8_codec",
    "leading_axes_specs",
    "local_block",
    "local_chains",
    "mesh_axis",
    "packed_nbytes",
    "reset_collective_counts",
    "sharding",
    "sync_wire_bytes",
]
