"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    vocab_size=32000,
    d_model=2560,
    num_layers=24,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    pattern=(LayerKind("attn", window=4096),),  # mistral-style SWA everywhere
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=3,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    pattern=(LayerKind("attn", window=8),),
    compute_dtype=torch.float32,
    xent_chunk=16,
)
