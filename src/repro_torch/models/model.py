"""Model assembly (port of ``repro/models/model.py``, training forward).

The model is ``n_repeats`` repetitions of a pattern of ``LayerSpec``s, and
every per-position parameter is stacked on a leading ``n_repeats`` axis,
exactly as in the reference: the stacked layout is what gives the MKOR
factor banks their stack dim (``s24`` at bert-large).  Where the reference
runs ``lax.scan`` over the stack, the port unbinds each stacked leaf once
(its backward is a single stack of the layer gradients) and loops in
Python; the per-layer statistics are stacked back into the same
``(n_repeats, d)`` layout.

Supported so far: attention blocks with dense MLPs (``kind == "attn"``,
``mlp == "dense"``), causal or bidirectional, without the multimodal
frontend — the main path (bert-large).  The other block kinds arrive with
the model zoo (ROADMAP queue 1: the model zoo).  Remat is a memory policy
with no numerical effect and is not applied.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the config space the port does not run yet."""
    for spec in cfg.pattern:
        if spec.kind != "attn" or spec.mlp != "dense":
            raise NotImplementedError(
                f"{cfg.name}: block kind={spec.kind!r} mlp={spec.mlp!r} is "
                "not ported yet (ROADMAP queue 1: the model zoo)")
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder / multimodal frontends are not "
            "ported yet (ROADMAP queue 1: the model zoo)")
    if cfg.post_block_norm:
        raise NotImplementedError(
            f"{cfg.name}: post-block norms are not ported yet "
            "(ROADMAP queue 1: the model zoo)")


# ======================================================================= #
# Init
# ======================================================================= #
def _block_init(gen, cfg: ModelConfig, spec: LayerSpec, *, dtype,
                device) -> Params:
    return {
        "pre_norm": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "mixer": attention.attn_init(gen, cfg, dtype=dtype, device=device),
        "mlp_norm": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                               device=device, gated=cfg.gated_mlp),
    }


def _stack_trees(trees: List[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs, 0), trees[0], *trees[1:])


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Seeded random parameters in the reference's tree layout (``None``
    device means ``cuda``).  The numbers differ from JAX's init."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Params = {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                   dtype=dtype, device=dev),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    params["blocks"] = [
        _stack_trees([_block_init(gen, cfg, spec, dtype=dtype, device=dev)
                      for _ in range(cfg.n_repeats)])
        for spec in cfg.pattern]
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            gen, cfg.d_model, cfg.padded_vocab, dtype=dtype, device=dev)
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
                      positions, *, causal: bool,
                      stats: Optional[dict]) -> Tuple[torch.Tensor,
                                                      Optional[dict]]:
    st_mixer = {} if stats is not None else None
    h = layers.apply_norm(p["pre_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    a = attention.full_seq_attention(p["mixer"], h, cfg, spec, positions,
                                     causal=causal, stats=st_mixer)
    x = x + a
    st_mlp = {} if stats is not None else None
    h2 = layers.apply_norm(p["mlp_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    f = layers.mlp(p["mlp"], h2, act=cfg.act, stats=st_mlp, name="mlp")
    x = x + f
    st = None
    if stats is not None:
        st = {"mixer": st_mixer, "mlp": st_mlp["mlp"]}
    return x, st


def _unbind_layers(node, n: int) -> List[Any]:
    """A stacked tree → ``n`` per-layer trees, one ``unbind`` per leaf."""
    if isinstance(node, dict):
        subs = {k: _unbind_layers(v, n) for k, v in node.items()}
        return [{k: subs[k][r] for k in node} for r in range(n)]
    if isinstance(node, (list, tuple)):
        subs = [_unbind_layers(v, n) for v in node]
        return [type(node)(s[r] for s in subs) for r in range(n)]
    return list(node.unbind(0))


def forward(params: Params, cfg: ModelConfig, batch: Dict, *,
            collect_stats: bool = False):
    """Full-sequence forward.  batch: ``{"tokens": (B, S) int}``.
    Returns ``(logits, aux)`` with ``aux = {"stats", "moe_aux"}``; the
    stats tree mirrors the params tree, each dense dict replaced by
    ``{"a": E[a]}`` (stacked layers carry a leading ``n_repeats`` dim)."""
    check_supported(cfg)
    stats: Optional[dict] = {} if collect_stats else None
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)

    per_layer = [_unbind_layers(bp, cfg.n_repeats) for bp in params["blocks"]]
    sts: List[List[dict]] = [[] for _ in cfg.pattern]
    for r in range(cfg.n_repeats):
        for pos, spec in enumerate(cfg.pattern):
            x, st = _block_apply_full(per_layer[pos][r], x, cfg, spec,
                                      positions, causal=cfg.causal,
                                      stats=stats)
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
    aux = {"stats": stats or {},
           "moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    return logits, aux
