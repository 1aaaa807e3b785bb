"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt scaled per pool; unverified]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

_LOCAL = LayerKind("attn", window=1024)
_GLOBAL = LayerKind("attn", window=None)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    vocab_size=262144,
    d_model=5376,
    num_layers=62,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),  # 5:1
    norm_scale_offset=1.0,
    sandwich_norm=True,
    act="gelu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale="sqrt_d",
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=6,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    pattern=(LayerKind("attn", window=8),) * 5 + (LayerKind("attn"),),
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    xent_chunk=16,
)
