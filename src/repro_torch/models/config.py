"""Model configuration system (the port's own copy of
``repro/models/config.py``; the port imports nothing of ``repro``).

A ``ModelConfig`` fully describes one architecture from the assigned pool.
Layers are described by a repeating ``pattern`` of ``LayerSpec``s (length P
must divide ``n_layers``); the model is executed as ``n_layers // P``
repetitions of the pattern, which lets us scan over repetitions to keep the
HLO small for the 512-chip dry-run while still supporting heterogeneous
interleaves (Gemma-2 local/global, Jamba Mamba:attn 1:7 + MoE every other
layer).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config for a routed MLP."""

    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0           # qwen2-moe style always-on experts
    shared_d_ff: int = 0                # total hidden of the shared branch
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 0.0
    # MKOR factor policy for expert weights (DESIGN.md §4): "shared"
    # averages the rank-1 stats over experts (one (L⁻¹,R⁻¹) pair per layer
    # position); "per_expert" keeps E pairs (E x factor memory, ablatable)
    per_expert_factors: bool = False


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                    # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating block pattern."""

    kind: str = "attn"                  # "attn" | "mamba" | "rwkv"
    window: Optional[int] = None        # sliding-window size; None = full attn
    mlp: str = "dense"                  # "dense" | "moe" | "none"


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder models (Whisper)."""

    n_layers: int
    n_heads: int
    n_positions: int = 1500             # audio frame positions (stub frontend)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    encoder: Optional[EncoderConfig] = None

    # attention details
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None    # gemma2 attn logit softcap
    logit_softcap: Optional[float] = None   # gemma2 final logit softcap
    attn_scale: Optional[float] = None      # override 1/sqrt(head_dim)
    use_qkv_bias: bool = False              # qwen-style qkv bias
    causal: bool = True

    # mlp / norm details
    norm: str = "rmsnorm"                   # "rmsnorm" | "layernorm"
    act: str = "silu"                       # "silu" | "gelu" | "relu2"
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    post_block_norm: bool = False           # gemma2 post-norms
    tie_embeddings: bool = False
    embed_scale: bool = False               # gemma2 multiplies embeds by sqrt(d)

    # rwkv details
    rwkv_head_dim: int = 64

    # modality frontend (STUB per assignment: precomputed embeddings)
    frontend: str = "none"                  # "none" | "audio" | "vision"
    frontend_len: int = 0                   # frames/patches provided by stub
    frontend_dim: int = 0                   # raw embed dim (0 -> d_model)

    # execution
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    # "nothing"       — recompute everything (paper-era default; lowest mem)
    # "dots_no_batch" — save projection/matmul outputs, recompute attention
    #                   scores/softmax (flash-attention-style; §Perf it.4)
    remat_policy: str = "dots_no_batch"
    # vocab rows are padded to this multiple so the vocab dim of the
    # embedding / lm_head shards evenly over (model x fsdp); padded logit
    # columns are masked to -inf in the forward pass (MaxText-style)
    vocab_pad_multiple: int = 2048

    # citation for the assigned-pool entry
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}"
            )
        if self.mamba is None and any(s.kind == "mamba" for s in self.pattern):
            object.__setattr__(self, "mamba", MambaConfig())

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return -(-self.vocab_size // m) * m

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None

    @property
    def is_attention_free(self) -> bool:
        return all(s.kind != "attn" for s in self.pattern)

    @property
    def max_window(self) -> Optional[int]:
        """None if any pattern position uses full attention, else max window."""
        ws = [s.window for s in self.pattern if s.kind == "attn"]
        if not ws:
            return 0
        if any(w is None for w in ws):
            return None
        return max(ws)

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: attention-free, or every attn layer windowed."""
        return self.max_window is not None

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test variant of the same family (<=2 layers, d_model<=512,
        <=4 experts), preserving the pattern structure."""
        p = len(self.pattern)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe,
                n_experts=min(moe.n_experts, 4),
                top_k=min(moe.top_k, 2),
                expert_d_ff=min(moe.expert_d_ff, 128),
                n_shared_experts=min(moe.n_shared_experts, 1),
                shared_d_ff=min(moe.shared_d_ff, 128) if moe.shared_d_ff else 0,
            )
        pattern = tuple(
            dataclasses.replace(s, window=min(s.window, 64) if s.window else s.window)
            for s in self.pattern
        )
        enc = self.encoder
        if enc is not None:
            enc = dataclasses.replace(enc, n_layers=1, n_heads=n_heads, n_positions=16)
        kw = dict(
            n_layers=p if p >= 2 else 2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=min(self.head_dim, 64) if self.head_dim else 0,
            pattern=pattern,
            moe=moe,
            encoder=enc,
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
            dtype="float32",
            scan_layers=False,
            remat=False,
            vocab_pad_multiple=1,
        )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------- #
# Input shapes assigned to this paper (public pool).
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
