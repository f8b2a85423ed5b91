"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760
vocab=122753, WSD schedule, llama-like. [arXiv:2404.06395]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    pattern=(LayerSpec(kind="attn", window=None, mlp="dense"),),
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    tie_embeddings=True,          # MiniCPM ties embeddings
    rope_theta=10000.0,
    source="arXiv:2404.06395",
)

# MiniCPM trains with the Warmup-Stable-Decay schedule (core/schedule.py:wsd)
SCHEDULE = "wsd"
