"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (7 mLSTM : 1 sLSTM), blocks carry their own projections (d_ff=0).
[arXiv:2405.04517; unverified]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

_PATTERN = (LayerKind("mlstm"),) * 7 + (LayerKind("slstm"),)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    vocab_size=50304,
    d_model=1024,
    num_layers=24,  # 3 periods of [7 mLSTM + 1 sLSTM]
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,  # sLSTM: num_heads * head_dim == d_model
    d_ff=0,
    pattern=_PATTERN,
    act="gelu",
    tie_embeddings=True,
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=4,
    num_heads=2,
    num_kv_heads=2,
    head_dim=32,
    pattern=(LayerKind("mlstm"), LayerKind("slstm")),
    compute_dtype=torch.float32,
    xent_chunk=16,
)
