"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attention-free, data-dependent
decay) d_ff=8960 vocab=65536. [arXiv:2404.05892]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                      # wkv heads of dim 64
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    pattern=(LayerSpec(kind="rwkv", mlp="rwkv_cm"),),
    rwkv_head_dim=64,
    norm="layernorm",
    act="relu2",
    gated_mlp=False,
    source="arXiv:2404.05892",
)
