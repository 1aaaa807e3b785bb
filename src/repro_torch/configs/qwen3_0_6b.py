"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk-norm, GQA, full attention. [hf:Qwen/Qwen3-8B family]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    vocab_size=151936,
    d_model=1024,
    num_layers=28,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    pattern=(LayerKind("attn"),),
    act="silu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=3,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    compute_dtype=torch.float32,
    xent_chunk=16,
)
