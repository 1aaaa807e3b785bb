"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcaps. [arXiv:2408.00118]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    vocab_size=256000,
    d_model=4608,
    num_layers=46,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    pattern=(LayerKind("attn", window=4096), LayerKind("attn")),  # alternating
    norm_scale_offset=1.0,
    sandwich_norm=True,
    act="gelu",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=144.0**-0.5,  # query_pre_attn_scalar = d_model / num_heads
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale="sqrt_d",
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=4,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    pattern=(LayerKind("attn", window=8), LayerKind("attn")),
    query_scale=16.0**-0.5,
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    xent_chunk=16,
)
