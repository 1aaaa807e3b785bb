"""whisper-base [audio]: 6L (enc+dec) d_model=512 8H d_ff=2048 vocab=51865 —
encoder-decoder; conv/mel frontend STUBBED (input_specs provides frame
embeddings). [arXiv:2212.04356; unverified]"""
import torch

from repro_torch.models.common import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    vocab_size=51865,
    d_model=512,
    num_layers=6,  # decoder layers
    enc_layers=6,
    enc_seq=1500,  # mel frames after the (stubbed) conv frontend
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    pattern=(LayerKind("attn"),),
    act="gelu",
    mlp_gated=False,
    use_rope=False,  # absolute position embeddings
    tie_embeddings=True,
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
)

SMOKE = CONFIG.replace(
    vocab_size=512,
    d_model=64,
    num_layers=2,
    enc_layers=2,
    enc_seq=32,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    compute_dtype=torch.float32,
    xent_chunk=16,
)
