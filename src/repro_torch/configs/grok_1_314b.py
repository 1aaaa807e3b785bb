"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072 — 8 experts top-2, attn/final logit softcaps.
[hf:xai-org/grok-1; unverified]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    vocab_size=131072,
    d_model=6144,
    num_layers=64,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    pattern=(LayerKind("attn", moe=True),),
    act="gelu",
    attn_logit_softcap=30.0,
    final_logit_softcap=30.0,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=32768,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale="sqrt_d",
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=3,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    moe_num_experts=4,
    moe_top_k=2,
    moe_d_ff=96,
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    xent_chunk=16,
)
