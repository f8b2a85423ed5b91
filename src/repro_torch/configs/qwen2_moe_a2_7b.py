"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, MoE 4 shared + 60 routed top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    pattern=(LayerSpec(kind="attn", window=None, mlp="moe"),),
    moe=MoEConfig(n_experts=60, top_k=4, expert_d_ff=1408,
                  n_shared_experts=4, shared_d_ff=5632),
    use_qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
