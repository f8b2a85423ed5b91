"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    pattern=(LayerSpec(kind="attn", window=None, mlp="dense"),),
    norm="layernorm",                # stablelm-2 uses LayerNorm
    act="silu",
    gated_mlp=True,
    use_qkv_bias=True,
    rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
)
