"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT vision tower is a STUB — ``input_specs`` provides
precomputed patch embeddings (B, 256, 1024) consumed through a real
projection layer. [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    pattern=(LayerSpec(kind="attn", window=None, mlp="dense"),),
    frontend="vision",
    frontend_len=256,                # patch tokens per image (stub)
    frontend_dim=1024,               # pixtral ViT hidden size
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000_000.0,
    source="hf:mistralai/Pixtral-12B-2409",
)
