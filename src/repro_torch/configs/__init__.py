"""Architecture registry of the port: ``get_config(arch)`` -> ModelConfig
(+ SMOKE variant).  The port serves all ten of the reference's
architectures: the dense (qwen3-0.6b, h2o-danube-1.8b, gemma2-27b,
gemma3-27b), MoE (olmoe-1b-7b, grok-1-314b), hybrid (recurrentgemma-2b)
and ssm (xlstm-350m) decoders, the vlm backbone (qwen2-vl-7b, M-RoPE over
precomputed patch embeddings) and the audio encoder-decoder
(whisper-base, over precomputed frame embeddings).  Beside them, as in the
reference, the input-shape grid (``SHAPES``, ``cells``, ``all_cells``) and
the long-context applicability (``LONG_OK``) that the roofline reads."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

ARCH_IDS = (
    "gemma3-27b",
    "gemma2-27b",
    "h2o-danube-1.8b",
    "qwen3-0.6b",
    "grok-1-314b",
    "olmoe-1b-7b",
    "whisper-base",
    "recurrentgemma-2b",
    "xlstm-350m",
    "qwen2-vl-7b",
)

PORTED = ARCH_IDS  # every architecture of the reference

# EC-SGHMC chain count per arch (the serving ensemble's K), the reference's
EC_CHAINS = {
    "gemma3-27b": 2,
    "gemma2-27b": 2,
    "h2o-danube-1.8b": 4,
    "qwen3-0.6b": 4,
    "grok-1-314b": 1,
    "olmoe-1b-7b": 4,
    "whisper-base": 4,
    "recurrentgemma-2b": 4,
    "xlstm-350m": 4,
    "qwen2-vl-7b": 2,
}


def get_config(arch: str, smoke: bool = False):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE if smoke else mod.CONFIG


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention: the archs whose layers are all
# (or mostly) windowed-local or recurrent run it; pure full-attention
# archs skip it, as in the reference
LONG_OK = frozenset(
    {"gemma3-27b", "gemma2-27b", "h2o-danube-1.8b", "recurrentgemma-2b", "xlstm-350m"}
)


def cells(arch: str):
    """The shape cells this arch runs (the grid minus the documented skips)."""
    out = []
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        if s == "long_500k" and arch not in LONG_OK:
            continue
        out.append(SHAPES[s])
    return tuple(out)


def all_cells():
    return tuple((a, c) for a in ARCH_IDS for c in cells(a))
