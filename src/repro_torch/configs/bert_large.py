"""bert-large-uncased — the paper's own primary benchmark model (MKOR §4).

The port's copy of ``repro/configs/bert_large.py``: encoder-only
(non-causal) transformer trained on the synthetic LM objective."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="bert-large",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    pattern=(LayerSpec(kind="attn", window=None, mlp="dense"),),
    causal=False,                    # bidirectional encoder
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    source="arXiv:1810.04805 (paper's benchmark model)",
)
