"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA. [arXiv:2401.04088]"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    pattern=(LayerSpec(kind="attn", window=4096, mlp="moe"),),
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=16384),
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)
