"""Model assembly: the forward pass, the caches and the decode step (port
of ``repro/models/model.py``).

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

Serving: ``forward(build_cache=True)`` also returns the reference's cache
tree, ``{"blocks": [one per pattern position, each leaf stacked on
n_repeats], "pos": 0-d int32 [, "enc_out"]}`` (attention: a ring of k, v
and ``slot_pos``; RWKV: ``wkv``, ``x_last``, ``cm_x_last``; Mamba: ``h``,
``conv``; an encoder-decoder block ``{"self", "cross"}``), and
:func:`decode_step` runs one token through it.  The reference's decode
returns a new tree; the port updates the given cache in place (each
layer's slice of the stacked leaves, and ``pos``) and returns it, so a
token costs no copy of the cache.
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
    device means ``cuda``).  The numbers differ from JAX's init.  On
    ``"meta"`` it gives the shapes and dtypes alone and draws nothing, the
    counterpart of the reference's ``jax.eval_shape(init_params)``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = None
    if dev.type != "meta":          # a meta tensor has no generator
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
                      stats: Optional[dict], build_cache: bool = False,
                      cache_len: int = 0):
    """One block over the full sequence.  Returns (x, stats, moe_aux,
    cache): the block's decode cache with ``build_cache`` (an attention
    ring of ``cache_len`` slots), else None."""
    st_mixer = {} if stats is not None else None
    aux = None
    cache = None
    h = layers.apply_norm(p["pre_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    if spec.kind == "attn":
        out = attention.full_seq_attention(
            p["mixer"], h, cfg, spec, positions, causal=causal,
            stats=st_mixer, return_kv=build_cache)
        if build_cache:
            a, kv = out
            cache = _ring_cache_from_kv(kv, positions, cache_len)
        else:
            a = out
    elif spec.kind == "rwkv":
        a, state = ssm.rwkv_time_mix(p["mixer"], h, cfg, stats=st_mixer)
        cache = state if build_cache else None
    else:
        a, state = ssm.mamba_apply(p["mixer"], h, cfg, stats=st_mixer)
        cache = state if build_cache else None
    if "post_mixer_norm" in p:
        a = layers.apply_norm(p["post_mixer_norm"], a, kind=cfg.norm,
                              eps=cfg.norm_eps)
    x = x + a

    st_cross = None
    if "cross" in p:
        hc = layers.apply_norm(p["cross_norm"], x, kind=cfg.norm,
                               eps=cfg.norm_eps)
        st_cross = {} if stats is not None else None
        out = attention.full_seq_attention(
            p["cross"], hc, cfg, spec, positions, kv_source=enc_out,
            causal=False, stats=st_cross, return_kv=build_cache)
        if build_cache:
            out, (ck, cv) = out
            cache = {"self": cache, "cross": {"k": ck, "v": cv}}
        x = x + out

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
            f, cm_last = ssm.rwkv_channel_mix(p["mlp"], h2, stats=st_mlp)
            if cache is not None:
                cache = {**cache, "cm_x_last": cm_last}
        if "post_mlp_norm" in p:
            f = layers.apply_norm(p["post_mlp_norm"], f, kind=cfg.norm,
                                  eps=cfg.norm_eps)
        x = x + f

    st = None
    if stats is not None:
        st = {"mixer": st_mixer, "mlp": st_mlp}
        if st_cross is not None:
            st["cross"] = st_cross
    return x, st, aux, cache


def _ring_cache_from_kv(kv, positions, cache_len: int) -> Dict:
    """The last ``cache_len`` (k, v) rows as a ring-buffer cache whose slot
    for absolute position p is p % cache_len."""
    k, v = kv
    b, s = k.shape[0], k.shape[1]
    take = min(s, cache_len)
    pos_tail = positions[0, s - take:]                    # (take,)
    slots = (pos_tail % cache_len).long()
    ck = k.new_zeros((b, cache_len) + k.shape[2:])
    cv = v.new_zeros((b, cache_len) + v.shape[2:])
    ck.index_copy_(1, slots, k[:, s - take:])
    cv.index_copy_(1, slots, v[:, s - take:])
    slot_pos = torch.full((cache_len,), -1, dtype=torch.int32,
                          device=k.device)
    slot_pos.index_copy_(0, slots, pos_tail.to(torch.int32))
    return {"k": ck, "v": cv, "slot_pos": slot_pos}


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
        x, st, _, _ = _block_apply_full(blk, x, cfg, _ENCODER_SPEC,
                                        positions, causal=False, stats=stats)
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


def _logits(params: Params, cfg: ModelConfig, x, stats=None):
    """Final norm, the vocab projection, the logit softcap and the padded
    columns masked."""
    x = layers.apply_norm(params["final_norm"], x, kind=cfg.norm,
                          eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.dense(params["lm_head"], x, stats=stats,
                              name="lm_head")
    logits = layers.softcap(logits, cfg.logit_softcap)
    return _mask_pad_logits(logits, cfg)


def forward(params: Params, cfg: ModelConfig, batch: Dict, *,
            collect_stats: bool = False, build_cache: bool = False,
            cache_extra: int = 1):
    """Full-sequence forward.  batch: ``{"tokens": (B, S) int [,
    "frontend_embeds": (B, F, fd)]}``.  Returns ``(logits, aux)`` with
    ``aux = {"stats", "moe_aux"}``; the stats tree mirrors the params
    tree, each dense dict replaced by ``{"a": E[a]}`` (stacked layers carry
    a leading ``n_repeats`` dim) and ``moe_aux`` is the MoE layers' summed
    aux loss (0 without MoE).  With ``build_cache`` (prefill) ``aux`` also
    holds ``"cache"``, the decode cache of the S positions (a VLM's prefix
    included) with room for ``cache_extra`` more tokens (module
    docstring)."""
    check_supported(cfg)
    stats: Optional[dict] = {} if collect_stats else None
    x, enc_out = _embed_inputs(params, cfg, batch, stats=stats)
    positions = _positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    total_len = x.shape[1] + cache_extra

    per_layer = [_unbind_layers(bp, cfg.n_repeats) for bp in params["blocks"]]
    sts: List[List[dict]] = [[] for _ in cfg.pattern]
    caches: List[List[dict]] = [[] for _ in cfg.pattern]
    for r in range(cfg.n_repeats):
        for pos, spec in enumerate(cfg.pattern):
            x, st, a, cache = _block_apply_full(
                per_layer[pos][r], x, cfg, spec, positions, enc_out=enc_out,
                causal=cfg.causal, stats=stats, build_cache=build_cache,
                cache_len=attention.kv_cache_len(spec, total_len)
                if spec.kind == "attn" else 0)
            if a is not None:
                aux = aux + a
            if stats is not None:
                sts[pos].append(st)
            if build_cache:
                caches[pos].append(cache)
    if stats is not None:
        stats["blocks"] = [_stack_trees(s_pos) for s_pos in sts]

    logits = _logits(params, cfg, x, stats)
    aux_out: Dict[str, Any] = {"stats": stats or {}, "moe_aux": aux}
    if build_cache:
        aux_out["cache"] = {
            "blocks": [_stack_trees(c_pos) for c_pos in caches],
            "pos": torch.full((), x.shape[1], dtype=torch.int32,
                              device=x.device)}
        if enc_out is not None:
            aux_out["cache"]["enc_out"] = enc_out
    return logits, aux_out


# ======================================================================= #
# Decode
# ======================================================================= #
def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype=None, device: DeviceLike = None) -> Dict:
    """Zero-initialised cache tree sized for a ``seq_len``-token context
    (``None`` device means ``cuda``; ``"meta"`` gives the shapes alone, as
    the reference's ``eval_shape``).  ``pos`` is ``seq_len``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    n = cfg.rwkv_head_dim
    blocks = []
    for spec in cfg.pattern:
        def zeros(*shape, dtype=dt):
            return torch.zeros((cfg.n_repeats,) + shape, dtype=dtype,
                               device=dev)
        if spec.kind == "attn":
            # exactly seq_len ring slots (window-bounded for SWA layers)
            c = attention.init_kv_cache(cfg, spec, batch, seq_len - 1, dt,
                                        dev)
            c = {k: v.expand((cfg.n_repeats,) + v.shape).clone()
                 for k, v in c.items()}
        elif spec.kind == "rwkv":
            c = {"wkv": zeros(batch, cfg.d_model // n, n, n,
                              dtype=torch.float32),
                 "x_last": zeros(batch, cfg.d_model),
                 "cm_x_last": zeros(batch, cfg.d_model)}
        else:
            di = cfg.mamba.expand * cfg.d_model
            c = {"h": zeros(batch, di, cfg.mamba.d_state,
                            dtype=torch.float32),
                 "conv": zeros(batch, cfg.mamba.d_conv - 1, di)}
        if cfg.is_encoder_decoder:
            enc_t = cfg.encoder.n_positions
            c = {"self": c,
                 "cross": {"k": zeros(batch, enc_t, cfg.n_kv_heads,
                                      cfg.head_dim),
                           "v": zeros(batch, enc_t, cfg.n_kv_heads,
                                      cfg.head_dim)}}
        blocks.append(c)
    return {"blocks": blocks,
            "pos": torch.full((), seq_len, dtype=torch.int32, device=dev)}


def _block_decode(p: Params, x, cfg: ModelConfig, spec: LayerSpec, pos,
                  cache: Dict):
    """One-token decode through one block.  Returns (x, new_cache): the
    attention ring written in place, the recurrent states new tensors."""
    cross_cache = None
    self_cache = cache
    if "cross" in p:
        cross_cache, self_cache = cache["cross"], cache["self"]

    h = layers.apply_norm(p["pre_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    if spec.kind == "attn":
        a, new_self = attention.decode_attention(p["mixer"], h, cfg, spec,
                                                 pos, self_cache)
    elif spec.kind == "rwkv":
        a, st = ssm.rwkv_time_mix_decode(
            p["mixer"], h, cfg,
            {"wkv": self_cache["wkv"], "x_last": self_cache["x_last"]})
        new_self = {**st, "cm_x_last": self_cache["cm_x_last"]}
    else:
        a, new_self = ssm.mamba_decode(p["mixer"], h, cfg, self_cache)
    if "post_mixer_norm" in p:
        a = layers.apply_norm(p["post_mixer_norm"], a, kind=cfg.norm,
                              eps=cfg.norm_eps)
    x = x + a

    if "cross" in p:
        hc = layers.apply_norm(p["cross_norm"], x, kind=cfg.norm,
                               eps=cfg.norm_eps)
        c, _ = attention.decode_attention(p["cross"], hc, cfg, spec, pos,
                                          self_cache,
                                          kv_source_cache=cross_cache)
        x = x + c

    if spec.mlp != "none":
        h2 = layers.apply_norm(p["mlp_norm"], x,
                               kind="layernorm" if spec.mlp == "rwkv_cm"
                               else cfg.norm, eps=cfg.norm_eps)
        if spec.mlp == "dense":
            f = layers.mlp(p["mlp"], h2, act=cfg.act)
        elif spec.mlp == "moe":
            f, _ = moe.moe_apply(p["mlp"], h2, cfg)
        else:
            f, cm_last = ssm.rwkv_channel_mix(
                p["mlp"], h2, x_prev=new_self["cm_x_last"][:, None])
            new_self = {**new_self, "cm_x_last": cm_last}
        if "post_mlp_norm" in p:
            f = layers.apply_norm(p["post_mlp_norm"], f, kind=cfg.norm,
                                  eps=cfg.norm_eps)
        x = x + f

    if "cross" in p:
        return x, {"self": new_self, "cross": cross_cache}
    return x, new_self


def _write_back(old, new) -> None:
    """Copy each leaf of ``new`` into the cache slice ``old`` it replaces
    (the attention rings, already written in place, are skipped)."""
    if isinstance(old, dict):
        for k in old:
            _write_back(old[k], new[k])
    elif new is not old:
        old.copy_(new)


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict):
    """Logits (B, 1, V) for one new token, tokens (B, 1), at ``cache``'s
    ``pos``.  Updates ``cache`` in place (every layer's state, and ``pos``
    + 1) and returns (logits, cache); reads nothing back to the host."""
    check_supported(cfg)
    x = layers.embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    pos = cache["pos"]
    per_layer = [_unbind_layers(bp, cfg.n_repeats) for bp in params["blocks"]]
    per_cache = [_unbind_layers(bc, cfg.n_repeats) for bc in cache["blocks"]]
    for r in range(cfg.n_repeats):
        for bpos, spec in enumerate(cfg.pattern):
            layer_cache = per_cache[bpos][r]
            x, new = _block_decode(per_layer[bpos][r], x, cfg, spec, pos,
                                   layer_cache)
            _write_back(layer_cache, new)
    logits = _logits(params, cfg, x)
    pos.add_(1)
    return logits, cache
