"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    vocab_size=256000,
    d_model=2560,
    num_layers=26,  # 8 full (rec,rec,attn) periods + 2 remainder rec blocks
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    pattern=(LayerKind("rglru"), LayerKind("rglru"), LayerKind("attn", window=2048)),
    norm_scale_offset=1.0,
    act="gelu",
    rnn_width=2560,
    rglru_conv_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale="sqrt_d",
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=5,  # 1 period + 2 remainder
    num_heads=2,
    num_kv_heads=1,
    head_dim=32,
    d_ff=128,
    pattern=(LayerKind("rglru"), LayerKind("rglru"), LayerKind("attn", window=8)),
    rnn_width=64,
    compute_dtype=torch.float32,
    xent_chunk=16,
)
