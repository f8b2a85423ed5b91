"""Shared checks of the serving parity tests (tests/test_torch_serving.py,
tests/test_torch_serving_ssm.py); it holds no test of its own.  One tiny
float32 config per block family, a numpy-seeded prompt, the JAX package's
prefill, decode step and ``generate`` on it (computed once a family and
module), and the comparisons of the port against them.

Tolerance: the model tolerance of tests/test_torch_model.py, rtol 1e-4
with an atol of 1e-5 of the leaf's largest entry, for logits and every
float leaf of a cache; the integer leaves (``slot_pos``, ``pos``) and the
greedy tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as j_registry
from repro.models import config as j_config
from repro.models import model as j_model
from repro.training import serving as j_serving
from repro_torch import interop
from repro_torch.models import model as t_model
from repro_torch.training import loop as t_loop
from repro_torch.training import serving as t_serving

import test_torch_zoo_check as zoo

CPU = torch.device("cpu")
BATCH, PROMPT, EXTRA = 2, 12, 4          # prompt, then EXTRA decode steps
N_GEN = 4                                 # generate's tokens


def _cfg(name, pattern, **kw):
    base = dict(name=name, arch_type="dense", n_layers=2 * len(pattern),
                d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=128, pattern=pattern, dtype="float32",
                scan_layers=False, remat=False, vocab_pad_multiple=1)
    base.update(kw)
    return j_config.ModelConfig(**base)


def _spec(kind="attn", window=None, mlp="dense"):
    return j_config.LayerSpec(kind=kind, window=window, mlp=mlp)


def _moe(**kw):
    # drop-free capacity: prefill routes S tokens, decode one, and the two
    # agree only when no choice is dropped (tests/test_serving.py)
    return j_config.MoEConfig(n_experts=4, top_k=2, expert_d_ff=64,
                              capacity_factor=64.0, **kw)


def family_config(family):
    """The JAX config of one block family (2 pattern periods, 64 wide)."""
    if family == "full":
        return _cfg("full", (_spec(),), n_kv_heads=4, use_qkv_bias=True)
    if family == "swa":        # a window shorter than the prompt: the ring wraps
        return _cfg("swa", (_spec(window=6),))
    if family == "gemma2":
        return _cfg("gemma2", (_spec(window=6), _spec()), head_dim=32,
                    attn_softcap=50.0, logit_softcap=30.0,
                    post_block_norm=True, embed_scale=True,
                    tie_embeddings=True, act="gelu")
    if family == "moe":
        return _cfg("moe", (_spec(mlp="moe"),),
                    moe=_moe(n_shared_experts=1, shared_d_ff=64))
    if family == "rwkv":
        return _cfg("rwkv", (_spec("rwkv", mlp="rwkv_cm"),), n_heads=4,
                    n_kv_heads=4, rwkv_head_dim=16, norm="layernorm",
                    act="relu2", gated_mlp=False)
    if family == "mamba":
        return _cfg("mamba", (_spec("mamba"),),
                    mamba=j_config.MambaConfig(d_state=8, d_conv=4,
                                               expand=2))
    if family == "hybrid":     # jamba-like: Mamba and a windowed attention, MoE
        return _cfg("hybrid", (_spec("mamba"), _spec(window=6, mlp="moe")),
                    n_layers=4, moe=_moe(),
                    mamba=j_config.MambaConfig(d_state=8, d_conv=4,
                                               expand=2))
    small = dict(d_model=64, d_ff=128, vocab_size=128, head_dim=16)
    if family == "encdec":
        return j_registry.get_config("whisper-base").reduced(
            frontend_dim=32, **small)
    if family == "prefix":
        return j_registry.get_config("pixtral-12b").reduced(
            frontend_dim=32, frontend_len=4, **small)
    raise ValueError(family)


def prompt(jc, n_text=PROMPT + EXTRA, seed=1):
    """(B, n_text) tokens and, for the frontends, their embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jc.vocab_size,
                                    (BATCH, n_text)).astype(np.int32)}
    if jc.frontend != "none":
        n = jc.encoder.n_positions if jc.is_encoder_decoder \
            else jc.frontend_len
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (BATCH, n, jc.frontend_dim or jc.d_model))).astype(np.float32)
    return batch


def _prefix(batch, n):
    return dict(batch, tokens=batch["tokens"][:, :n])


def to_host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def jax_results(family):
    """The JAX package on ``family``: params, the prompt, the prefill's
    last logits and cache, one decode step from that cache (logits and
    cache) and ``generate``'s tokens, all as numpy."""
    jc = family_config(family)
    params = to_host(j_model.init_params(jax.random.key(3), jc))
    batch = prompt(jc)
    pre = _prefix(batch, PROMPT)
    logits, cache = jax.jit(j_serving.make_prefill_step(
        jc, cache_extra=EXTRA))(params, pre)
    logits, cache = to_host(logits), to_host(cache)
    step = jax.jit(j_serving.make_serve_step(jc))
    tok = batch["tokens"][:, PROMPT:PROMPT + 1]
    nxt, s_logits, s_cache = step(params, jax.tree.map(jnp.asarray, cache),
                                  tok)
    # one compiled program (op by op, an MoE or a scan prefill is slow)
    gen = jax.jit(lambda p, t: j_serving.generate(p, jc, t, N_GEN))(
        params, pre["tokens"])
    return {"cfg": jc, "params": params, "batch": batch, "prefill": pre,
            "logits": logits, "cache": cache, "token": tok,
            "step_next": np.asarray(nxt), "step_logits": to_host(s_logits),
            "step_cache": to_host(s_cache), "generate": np.asarray(gen)}


def port_params(res):
    return interop.params_from_numpy(res["params"], CPU)


def close(want, got, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=what)


def leaves(tree, pre=""):
    """(path, leaf) pairs of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{pre}/{i}")
    else:
        yield pre, tree


def caches_close(want, got):
    """Key for key, dtype for dtype and shape for shape; float leaves at
    the model tolerance, integer leaves equal."""
    jl = dict(leaves(want))
    tl = dict(leaves(interop.cache_to_numpy(got)))
    assert sorted(jl) == sorted(tl)
    for k, j in jl.items():
        j, t = np.asarray(j), tl[k]
        assert j.dtype == t.dtype, k
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=k)
        else:
            close(j, t, k)


def check_prefill(res):
    """The port's prefill against JAX's: last logits and the cache."""
    tc = zoo.port_cfg(res["cfg"])
    logits, cache = t_serving.make_prefill_step(tc, cache_extra=EXTRA)(
        port_params(res), t_loop.batch_to_device(res["prefill"], CPU))
    close(res["logits"], logits.numpy(), "prefill logits")
    caches_close(res["cache"], cache)


def check_decode_step(res):
    """One port decode step from JAX's prefill cache, carried across:
    logits, the greedy token and the new cache."""
    tc = zoo.port_cfg(res["cfg"])
    cache = interop.cache_from_numpy(res["cache"], CPU)
    nxt, logits, new = t_serving.make_serve_step(tc)(
        port_params(res), cache, torch.from_numpy(res["token"]))
    assert new is cache                      # updated in place
    close(res["step_logits"], logits.numpy(), "decode logits")
    np.testing.assert_array_equal(nxt.numpy(), res["step_next"])
    caches_close(res["step_cache"], new)


def check_generate(res):
    tc = zoo.port_cfg(res["cfg"])
    got = t_serving.generate(port_params(res), tc,
                             torch.from_numpy(res["prefill"]["tokens"]),
                             N_GEN)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), res["generate"])


def check_decode_matches_full_forward(res):
    """The port alone: prefill on the first PROMPT tokens, then EXTRA
    teacher-forced decode steps, each step's logits against the port's
    full forward over all PROMPT + EXTRA tokens at that position."""
    tc = zoo.port_cfg(res["cfg"])
    tp = port_params(res)
    batch = t_loop.batch_to_device(res["batch"], CPU)
    with torch.inference_mode():
        full, _ = t_model.forward(tp, tc, batch)
    n_prefix = full.shape[1] - batch["tokens"].shape[1]
    logits, cache = t_serving.make_prefill_step(tc, cache_extra=EXTRA)(
        tp, dict(batch, tokens=batch["tokens"][:, :PROMPT]))
    close(full[:, n_prefix + PROMPT - 1:n_prefix + PROMPT].numpy(),
          logits.numpy(), "prefill")
    step = t_serving.make_serve_step(tc)
    for i in range(PROMPT, PROMPT + EXTRA):
        _, logits, cache = step(tp, cache, batch["tokens"][:, i:i + 1])
        close(full[:, n_prefix + i:n_prefix + i + 1].numpy(),
              logits.numpy(), f"decode position {i}")
    assert int(cache["pos"]) == n_prefix + PROMPT + EXTRA


def check_cache_shapes(jc, batch, seq_len):
    """The port's ``decode_batch_shapes`` (meta tensors) against the
    reference's ``eval_shape``: keys, shapes and dtypes."""
    j_tok, j_cache = j_serving.decode_batch_shapes(jc, batch, seq_len)
    t_tok, t_cache = t_serving.decode_batch_shapes(zoo.port_cfg(jc), batch,
                                                   seq_len)
    jl, tl = dict(leaves(j_cache)), dict(leaves(t_cache))
    assert sorted(jl) == sorted(tl)
    for k, t in [("tokens", t_tok)] + list(tl.items()):
        j = j_tok if k == "tokens" else jl[k]
        assert t.is_meta, k
        assert tuple(t.shape) == j.shape, k
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), k
    return t_cache
