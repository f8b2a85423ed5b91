"""whisper-base [audio] — 6L(enc)+6L(dec) d_model=512 8H d_ff=2048
vocab=51865, encoder-decoder; conv/mel frontend is a STUB — ``input_specs``
provides precomputed frame embeddings (B, 1500, 512). [arXiv:2212.04356]"""
from repro_torch.models.config import EncoderConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    n_layers=6,                      # decoder layers; encoder below
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    pattern=(LayerSpec(kind="attn", window=None, mlp="dense"),),
    encoder=EncoderConfig(n_layers=6, n_heads=8, n_positions=1500),
    frontend="audio",
    frontend_len=1500,
    frontend_dim=512,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    source="arXiv:2212.04356",
)
