"""Model assembly (port of ``repro/models/model.py``, training forward).

The model is ``n_repeats`` repetitions of a pattern of ``LayerSpec``s, and
every per-position parameter is stacked on a leading ``n_repeats`` axis,
exactly as in the reference: the stacked layout is what gives the MKOR
factor banks their stack dim (``s24`` at bert-large).  Where the reference
runs ``lax.scan`` over the stack, the port unbinds each stacked leaf once
(its backward is a single stack of the layer gradients) and loops in
Python; the per-layer statistics are stacked back into the same
``(n_repeats, d)`` layout.

Every block kind of the assigned pool: attention, RWKV-6 and Mamba
mixers; dense, MoE, RWKV channel-mix and no MLPs; Gemma-2's post-block
norms; the encoder-decoder (Whisper: an encoder stack over projected
frame embeddings, a cross-attention block in each decoder layer) and the
prefix multimodal frontend (Pixtral: projected patch embeddings ahead of
the text).  The frontends themselves are stubs, as in the reference:
``frontend_proj`` is a real linear layer and is MKOR-preconditioned.
Remat is a memory policy with no numerical effect and is not applied.
The KV caches and the decode step arrive with serving.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise the reference's ``ValueError`` for a block kind or an MLP
    kind that no model has."""
    for spec in cfg.pattern:
        if spec.kind not in ("attn", "rwkv", "mamba"):
            raise ValueError(spec.kind)
        if spec.mlp not in ("dense", "moe", "rwkv_cm", "none"):
            raise ValueError(spec.mlp)


# ======================================================================= #
# Init
# ======================================================================= #
def _block_init(gen, cfg: ModelConfig, spec: LayerSpec, *, cross: bool,
                dtype, device) -> Params:
    kw = dict(dtype=dtype, device=device)
    p: Params = {"pre_norm": layers.norm_init(cfg.d_model, cfg.norm,
                                              device=device)}
    if spec.kind == "attn":
        p["mixer"] = attention.attn_init(gen, cfg, **kw)
    elif spec.kind == "rwkv":
        p["mixer"] = ssm.rwkv_init(gen, cfg, **kw)
    else:
        p["mixer"] = ssm.mamba_init(gen, cfg, **kw)
    if cfg.post_block_norm:
        p["post_mixer_norm"] = layers.norm_init(cfg.d_model, cfg.norm,
                                                device=device)
    if cross:
        p["cross_norm"] = layers.norm_init(cfg.d_model, cfg.norm,
                                           device=device)
        p["cross"] = attention.attn_init(gen, cfg, **kw)
    if spec.mlp == "dense":
        p["mlp_norm"] = layers.norm_init(cfg.d_model, cfg.norm, device=device)
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                   gated=cfg.gated_mlp, **kw)
    elif spec.mlp == "moe":
        p["mlp_norm"] = layers.norm_init(cfg.d_model, cfg.norm, device=device)
        p["mlp"] = moe.moe_init(gen, cfg, **kw)
    elif spec.mlp == "rwkv_cm":
        p["mlp_norm"] = layers.norm_init(cfg.d_model, "layernorm",
                                         device=device)
        p["mlp"] = ssm.rwkv_cm_init(gen, cfg, **kw)
    if cfg.post_block_norm and spec.mlp != "none":
        p["post_mlp_norm"] = layers.norm_init(cfg.d_model, cfg.norm,
                                              device=device)
    return p


def _stack_trees(trees: List[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs, 0), trees[0], *trees[1:])


def _stacked_blocks(gen, cfg: ModelConfig, spec: LayerSpec, n: int, *,
                    cross: bool, dtype, device) -> Params:
    return _stack_trees([_block_init(gen, cfg, spec, cross=cross,
                                     dtype=dtype, device=device)
                         for _ in range(n)])


_ENCODER_SPEC = LayerSpec(kind="attn", window=None, mlp="dense")


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Seeded random parameters in the reference's tree layout (``None``
    device means ``cuda``).  The numbers differ from JAX's init."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kw = dict(dtype=dtype, device=dev)
    params: Params = {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, **kw),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    params["blocks"] = [
        _stacked_blocks(gen, cfg, spec, cfg.n_repeats,
                        cross=cfg.is_encoder_decoder, **kw)
        for spec in cfg.pattern]
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            gen, cfg.d_model, cfg.padded_vocab, **kw)
    if cfg.frontend != "none":
        params["frontend_proj"] = layers.dense_init(
            gen, cfg.frontend_dim or cfg.d_model, cfg.d_model, **kw)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "blocks": [_stacked_blocks(gen, cfg, _ENCODER_SPEC,
                                       cfg.encoder.n_layers, cross=False,
                                       **kw)],
            "final_norm": layers.norm_init(cfg.d_model, cfg.norm,
                                           device=dev),
        }
    return params


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def _mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Padded vocab columns never win: -2^30 logits, zero gradient."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= cfg.vocab_size, -2.0 ** 30)


# ======================================================================= #
# Forward
# ======================================================================= #
def _block_apply_full(p: Params, x, cfg: ModelConfig, spec: LayerSpec,
                      positions, *, enc_out=None, causal: bool,
                      stats: Optional[dict]):
    """One block over the full sequence.  Returns (x, stats, moe_aux)."""
    st_mixer = {} if stats is not None else None
    aux = None
    h = layers.apply_norm(p["pre_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    if spec.kind == "attn":
        a = attention.full_seq_attention(p["mixer"], h, cfg, spec, positions,
                                         causal=causal, stats=st_mixer)
    elif spec.kind == "rwkv":
        a, _ = ssm.rwkv_time_mix(p["mixer"], h, cfg, stats=st_mixer)
    else:
        a, _ = ssm.mamba_apply(p["mixer"], h, cfg, stats=st_mixer)
    if "post_mixer_norm" in p:
        a = layers.apply_norm(p["post_mixer_norm"], a, kind=cfg.norm,
                              eps=cfg.norm_eps)
    x = x + a

    st_cross = None
    if "cross" in p:
        hc = layers.apply_norm(p["cross_norm"], x, kind=cfg.norm,
                               eps=cfg.norm_eps)
        st_cross = {} if stats is not None else None
        x = x + attention.full_seq_attention(
            p["cross"], hc, cfg, spec, positions, kv_source=enc_out,
            causal=False, stats=st_cross)

    st_mlp = {} if stats is not None else None
    if spec.mlp != "none":
        h2 = layers.apply_norm(p["mlp_norm"], x,
                               kind="layernorm" if spec.mlp == "rwkv_cm"
                               else cfg.norm, eps=cfg.norm_eps)
        if spec.mlp == "dense":
            f = layers.mlp(p["mlp"], h2, act=cfg.act, stats=st_mlp,
                           name="mlp")
            st_mlp = st_mlp["mlp"] if stats is not None else None
        elif spec.mlp == "moe":
            f, aux = moe.moe_apply(p["mlp"], h2, cfg, stats=st_mlp,
                                   name="moe")
            st_mlp = st_mlp["moe"] if stats is not None else None
        else:
            f, _ = ssm.rwkv_channel_mix(p["mlp"], h2, stats=st_mlp)
        if "post_mlp_norm" in p:
            f = layers.apply_norm(p["post_mlp_norm"], f, kind=cfg.norm,
                                  eps=cfg.norm_eps)
        x = x + f

    st = None
    if stats is not None:
        st = {"mixer": st_mixer, "mlp": st_mlp}
        if st_cross is not None:
            st["cross"] = st_cross
    return x, st, aux


def _unbind_layers(node, n: int) -> List[Any]:
    """A stacked tree → ``n`` per-layer trees, one ``unbind`` per leaf."""
    if isinstance(node, dict):
        subs = {k: _unbind_layers(v, n) for k, v in node.items()}
        return [{k: subs[k][r] for k in node} for r in range(n)]
    if isinstance(node, (list, tuple)):
        subs = [_unbind_layers(v, n) for v in node]
        return [type(node)(s[r] for s in subs) for r in range(n)]
    return list(node.unbind(0))


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[0], x.shape[1]
    return torch.arange(s, dtype=torch.int32, device=x.device)[None] \
        .expand(b, s)


def _encoder_forward(params: Params, cfg: ModelConfig, enc_in, *,
                     stats: Optional[dict]):
    """enc_in: (B, T, d_model) projected frame embeddings; bidirectional
    attention blocks, then the encoder's final norm.  Its stats go under
    ``stats["encoder"] = {"blocks": [...]}``."""
    x = enc_in
    positions = _positions(x)
    sts = []
    for blk in _unbind_layers(params["encoder"]["blocks"][0],
                              cfg.encoder.n_layers):
        x, st, _ = _block_apply_full(blk, x, cfg, _ENCODER_SPEC, positions,
                                     causal=False, stats=stats)
        sts.append(st)
    x = layers.apply_norm(params["encoder"]["final_norm"], x, kind=cfg.norm,
                          eps=cfg.norm_eps)
    if stats is not None:
        stats["encoder"] = {"blocks": [_stack_trees(sts)]}
    return x


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict, *,
                  stats: Optional[dict]):
    """Token embeddings (+ the multimodal prefix).  Returns (x, enc_out)."""
    x = layers.embed(params["embed"], batch["tokens"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    enc_out = None
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        fe = layers.dense(params["frontend_proj"], batch["frontend_embeds"],
                          stats=stats, name="frontend_proj")
        if cfg.is_encoder_decoder:
            enc_out = _encoder_forward(params, cfg, fe, stats=stats)
        else:
            x = torch.cat([fe.to(x.dtype), x], dim=1)
    return x, enc_out


def forward(params: Params, cfg: ModelConfig, batch: Dict, *,
            collect_stats: bool = False):
    """Full-sequence forward.  batch: ``{"tokens": (B, S) int [,
    "frontend_embeds": (B, F, fd)]}``.  Returns ``(logits, aux)`` with
    ``aux = {"stats", "moe_aux"}``; the stats tree mirrors the params
    tree, each dense dict replaced by ``{"a": E[a]}`` (stacked layers carry
    a leading ``n_repeats`` dim) and ``moe_aux`` is the MoE layers' summed
    aux loss (0 without MoE)."""
    check_supported(cfg)
    stats: Optional[dict] = {} if collect_stats else None
    x, enc_out = _embed_inputs(params, cfg, batch, stats=stats)
    positions = _positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    per_layer = [_unbind_layers(bp, cfg.n_repeats) for bp in params["blocks"]]
    sts: List[List[dict]] = [[] for _ in cfg.pattern]
    for r in range(cfg.n_repeats):
        for pos, spec in enumerate(cfg.pattern):
            x, st, a = _block_apply_full(per_layer[pos][r], x, cfg, spec,
                                         positions, enc_out=enc_out,
                                         causal=cfg.causal, stats=stats)
            if a is not None:
                aux = aux + a
            if stats is not None:
                sts[pos].append(st)
    if stats is not None:
        stats["blocks"] = [_stack_trees(s_pos) for s_pos in sts]

    x = layers.apply_norm(params["final_norm"], x, kind=cfg.norm,
                          eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.dense(params["lm_head"], x, stats=stats,
                              name="lm_head")
    logits = layers.softcap(logits, cfg.logit_softcap)
    logits = _mask_pad_logits(logits, cfg)
    return logits, {"stats": stats or {}, "moe_aux": aux}
