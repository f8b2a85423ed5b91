"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE. [arXiv:2402.19173]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    pattern=(LayerSpec(kind="attn", window=None, mlp="dense"),),
    norm="layernorm",                # starcoder2 uses LayerNorm + biases
    act="gelu",
    gated_mlp=False,
    use_qkv_bias=True,
    rope_theta=100000.0,
    source="arXiv:2402.19173",
)
