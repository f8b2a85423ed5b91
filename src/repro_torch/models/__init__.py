"""Model code: configs, layers (dense with MKOR stat capture, grouped
expert dense, norms), attention (self and cross), MoE, the RWKV-6 and
Mamba mixers, and the stacked-layer model assembly."""
