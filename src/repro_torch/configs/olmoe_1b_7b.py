"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304 — 64 experts top-8, qk-norm. [arXiv:2409.02060]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    vocab_size=50304,
    d_model=2048,
    num_layers=16,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    pattern=(LayerKind("attn", moe=True),),
    act="silu",
    qk_norm=True,
    moe_num_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
    rope_theta=10_000.0,
    tie_embeddings=False,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=3,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=32,
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    xent_chunk=16,
)
