"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8, head_dim=256)
d_ff=14336 vocab=256000, local(4096)+global alternating, attn+logit
softcapping, post-block norms. [arXiv:2408.00118]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    pattern=(
        LayerSpec(kind="attn", window=4096, mlp="dense"),   # local
        LayerSpec(kind="attn", window=None, mlp="dense"),   # global
    ),
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="gelu",
    gated_mlp=True,
    rope_theta=10000.0,
    source="arXiv:2408.00118",
)
