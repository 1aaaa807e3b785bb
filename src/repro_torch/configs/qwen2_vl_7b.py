"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution; vision tower STUBBED
(input_specs provides precomputed patch embeddings). [arXiv:2409.12191]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    vocab_size=152064,
    d_model=3584,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    pattern=(LayerKind("attn"),),
    act="silu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # (t, h, w) of head_dim/2 = 64
    tie_embeddings=False,
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
    d_ff=128,
    mrope_sections=(4, 2, 2),  # head_dim/2 = 8
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    xent_chunk=16,
)
