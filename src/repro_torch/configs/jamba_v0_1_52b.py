"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2; Mamba:attention 1:7 interleave, MoE on
every other layer. [arXiv:2403.19887]

Pattern period = 8: attention at position 4, Mamba elsewhere; MoE MLP on odd
positions, dense on even.
"""
from repro_torch.models.config import (LayerSpec, MambaConfig, ModelConfig,
                                      MoEConfig)


def _pos(i: int) -> LayerSpec:
    kind = "attn" if i == 4 else "mamba"
    mlp = "moe" if i % 2 == 1 else "dense"
    return LayerSpec(kind=kind, window=None, mlp=mlp)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pattern=tuple(_pos(i) for i in range(8)),
    moe=MoEConfig(n_experts=16, top_k=2, expert_d_ff=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    source="arXiv:2403.19887",
)
