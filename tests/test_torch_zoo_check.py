"""Shared checks of the model-zoo parity tests (tests/test_torch_moe.py,
tests/test_torch_ssm.py, tests/test_torch_zoo*.py); it holds no test of
its own.  A JAX config in the port's config types, the forward and
gradient comparison at the port's model tolerances, and MKOR + LAMB
steps against the JAX package's jitted step at tests/test_torch_mkor.py's
tolerances.

Tolerances (float32): logits rtol 1e-4 / atol 1e-5, the loss and the
MoE aux rtol 1e-6 (tests/test_torch_model.py), statistics rtol 1e-5 /
atol 1e-6, gradients rtol 1e-4 with an atol of 1e-5 of each leaf's
largest entry.  Those elementwise bounds were set on a 64-wide, 3-layer
bert; the reduced zoo configs are 256 wide and up to 8 layers deep, and
float32 rounding in another library's order (MKL's GEMM blocking against
XLA's, the reductions) puts some elements near zero outside them, by up
to 8x on jamba's first layer.  Where a leaf misses its elementwise bound
it is held instead to the computation's own float32 sensitivity: the
norm of its difference at most ``SPREAD_FACTOR`` (8) times the norm of
the change that a one-ulp perturbation of the weights (each float32
weight times 1 ± 2^-23, random signs) makes in JAX's own result.  The
port's differences measure 1.3 to 4 times that spread on these configs.

MKOR runs: the free-running losses rtol 1e-5; each step also from
JAX's state of the step before (carried across with ``interop``), its
float32 banks to 1e-4, LAMB's first moments to 1e-4 and the params to
2e-4 (tests/test_torch_mkor.py's bounds).  LAMB normalises each
element's update (m / (√v + ε)), so an element whose first moment is
near zero (|m| ≤ 1e-3 of its leaf's largest entry, 25 times the 4e-5 of
the leaf to which whisper-base's gradients agree) can move by ±lr·trust
on the sign of rounding noise: such elements are held to 1e-2 (LAMB's
step at lr 1e-2 is below it)."""
import dataclasses
import importlib

import jax
import numpy as np
import torch

from repro.core import firstorder as j_fo
from repro.data import pipeline as j_pipe
from repro.models import model as j_model
from repro.training import loop as j_loop
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.models import config as t_config
from repro_torch.models import model as t_model
from repro_torch.training import loop as t_loop

j_mkor = importlib.import_module("repro.core.mkor")
CPU = torch.device("cpu")


def port_cfg(cfg):
    """A JAX ModelConfig (or any of its sub-configs) as the port's."""
    if isinstance(cfg, tuple):
        return tuple(port_cfg(c) for c in cfg)
    if not dataclasses.is_dataclass(cfg):
        return cfg
    kw = {f.name: port_cfg(getattr(cfg, f.name))
          for f in dataclasses.fields(cfg)}
    return getattr(t_config, type(cfg).__name__)(**kw)


def flat(tree, pre=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{pre}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{pre}/{i}"))
    else:
        out[pre] = np.asarray(tree, np.float32)
    return out


SPREAD_FACTOR = 8.0


def ulp_perturbed(tree, seed=0):
    """Every float32 leaf times 1 ± 2^-23 (one ulp, random signs)."""
    rng = np.random.default_rng(seed)

    def leaf(v):
        v = np.asarray(v)
        if v.dtype != np.float32:
            return v
        sign = rng.choice(np.array([-1.0, 1.0], np.float32), v.shape)
        return (v * (1 + np.float32(2.0 ** -23) * sign)).astype(np.float32)
    return jax.tree.map(leaf, tree)


def assert_close(want, got, *, rtol, atol, what, spread=None):
    """``got`` within rtol·|want| + atol of ``want`` elementwise, or, where
    it is not and ``spread`` (JAX's own change under a one-ulp weight
    perturbation) is given, within SPREAD_FACTOR times that spread in
    norm (module docstring)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape, what
    diff = np.abs(got - want)
    if np.all(diff <= atol + rtol * np.abs(want)):
        return
    if spread is None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    bound = SPREAD_FACTOR * float(np.linalg.norm(spread))
    assert float(np.linalg.norm(diff)) <= bound, (
        f"{what}: |got - want| {np.linalg.norm(diff):.3e} over "
        f"{SPREAD_FACTOR:g} x the one-ulp spread {bound:.3e}, and "
        f"elementwise max {diff.max():.3e}")


def assert_grads_close(jg, tg, zero=(), spread=None):
    """Every gradient leaf at rtol 1e-4, atol 1e-5 of its largest entry
    (or within the one-ulp ``spread`` tree's bound, :func:`assert_close`).
    The leaves named in ``zero`` have a true gradient of 0 (a shift of
    every key of a query's softmax), so both sides are rounding noise:
    each is held to 1e-6 of the largest gradient entry of the model."""
    jf, tf = flat(jg), flat(tg)
    sf = flat(spread) if spread is not None else {}
    assert sorted(jf) == sorted(tf)
    top = max(float(np.abs(v).max(initial=0.0)) for v in jf.values())
    for k in jf:
        if any(k.endswith(z) for z in zero):
            for side in (jf[k], tf[k]):
                assert np.abs(side).max(initial=0.0) <= 1e-6 * top, k
            continue
        scale = max(float(np.abs(jf[k]).max(initial=0.0)), 1e-6)
        assert_close(jf[k], tf[k], rtol=1e-4, atol=1e-5 * scale, what=k,
                     spread=sf.get(k))


def make_batch(cfg, ds, step, batch=2):
    """The launcher's batch: the pipeline's, plus the encoder frames of an
    encoder-decoder model."""
    out = j_pipe.make_batch(ds, step)
    if cfg.is_encoder_decoder:
        out["frontend_embeds"] = j_pipe.encoder_frames(cfg, batch, step)
    return out


def dataset(cfg, seq_len=16, batch=2):
    """Text of ``seq_len`` tokens (after a VLM's patch prefix)."""
    return j_pipe.make_dataset(cfg, global_batch=batch,
                               seq_len=seq_len + j_loop.text_prefix_len(cfg))


def forward_matches(jc, *, seed=3, zero=()):
    """Logits, loss, ``moe_aux``, the stats tree and every gradient of the
    port against JAX at ``jc`` on the same (numpy-converted) params and
    one pipeline batch.  Returns the port's stats tree."""
    params = jax.tree.map(np.asarray,
                          j_model.init_params(jax.random.key(seed), jc))
    batch = make_batch(jc, dataset(jc), 0)
    grad_fn = jax.jit(jax.value_and_grad(j_loop.make_loss_fn(jc),
                                         has_aux=True))
    fwd_fn = jax.jit(lambda p, b: j_model.forward(p, jc, b)[0])
    (j_loss, j_aux), j_grads = grad_fn(params, batch)
    j_logits = fwd_fn(params, batch)
    # JAX's own response to a one-ulp perturbation of the weights (the
    # same compiled functions)
    pert = ulp_perturbed(params)
    (_, p_aux), p_grads = grad_fn(pert, batch)
    spread = {"logits": np.asarray(fwd_fn(pert, batch)) - j_logits,
              "grads": jax.tree.map(lambda a, b: np.asarray(a) - b,
                                    p_grads, j_grads),
              "stats": jax.tree.map(lambda a, b: np.asarray(a) - b,
                                    p_aux["stats"], j_aux["stats"])}

    tc = port_cfg(jc)
    tp = interop.params_from_numpy(params, CPU)
    tb = t_loop.batch_to_device(batch, CPU)
    (t_loss, t_aux), t_grads = t_loop.value_and_grad(
        t_loop.make_loss_fn(tc), tp, tb)
    with torch.no_grad():
        t_logits, _ = t_model.forward(tp, tc, tb)

    assert_close(j_logits, t_logits.numpy(), rtol=1e-4, atol=1e-5,
                 what="logits", spread=spread["logits"])
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(float(t_aux["moe_aux"].detach()),
                               float(j_aux["moe_aux"]), rtol=1e-6)
    js, ts = flat(j_aux["stats"]), flat(interop.tree_to_numpy(
        t_aux["stats"]))
    ss = flat(spread["stats"])
    assert sorted(js) == sorted(ts) and js
    for k in js:
        assert_close(js[k], ts[k], rtol=1e-5, atol=1e-6, what=k,
                     spread=ss[k])
    assert_grads_close(j_grads, interop.tree_to_numpy(t_grads), zero,
                       spread=spread["grads"])
    return t_aux["stats"]


def _within(jtree, ttree, bound, what):
    jf, tf = flat(jtree), flat(interop.tree_to_numpy(ttree))
    assert sorted(jf) == sorted(tf), what
    for k in jf:
        err = np.abs(jf[k] - tf[k]).max(initial=0.0)
        assert err < bound, f"{what}{k}: {err:.3e}"


def mkor_steps_match(jc, *, steps=3, lr=1e-2, **mkor_kw):
    """``steps`` MKOR (float32 banks, inv_freq 2 unless given) + LAMB
    steps of the port (``use_kernels``: each wrapper's plain version on
    the CPU) against JAX's jitted step (the plain reference), on the
    launcher's batches (module docstring).  Returns the port's final free-
    running (params, state)."""
    kw = dict(inv_freq=2, factor_dtype="float32", **mkor_kw)
    j_opt = j_mkor.mkor(j_fo.lamb(lr), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(lr), t_mkor.MKORConfig(use_kernels=True,
                                                         **kw))
    tc = port_cfg(jc)
    jp = j_model.init_params(jax.random.key(0), jc)
    tp = interop.params_from_numpy(jax.tree.map(np.array, jp), CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    assert sorted(ts["factor_banks"]) == sorted(js["factor_banks"])
    j_step = jax.jit(j_loop.make_train_step(jc, j_opt))
    t_step = t_loop.make_train_step(tc, t_opt)
    ds = dataset(jc)
    j_losses, t_losses = [], []
    for i in range(steps):
        batch = make_batch(jc, ds, i)
        tb = t_loop.batch_to_device(batch, CPU)
        # the step from JAX's state
        host = jax.tree.map(np.array, (jp, js))
        sp, ss, _ = t_step(interop.params_from_numpy(host[0], CPU),
                           interop.opt_state_from_numpy(host[1], CPU), tb)
        jp, js, jm = j_step(jp, js, batch)
        _within(js["factor_banks"], ss["factor_banks"], 1e-4, "banks")
        _within(js["backend"]["m"], ss["backend"]["m"], 1e-4, "m")
        m = flat(interop.tree_to_numpy(ss["backend"]["m"]))
        jf, tf = flat(jp), flat(interop.tree_to_numpy(sp))
        for k in jf:
            err = np.abs(jf[k] - tf[k])
            noise = np.abs(m[k]) <= 1e-3 * np.abs(m[k]).max(initial=0.0)
            assert err[~noise].max(initial=0.0) < 2e-4, f"step {i} {k}"
            assert err.max(initial=0.0) < 1e-2, f"step {i} {k}"
        assert int(ss["count"]) == int(js["count"]) == i + 1
        # the free-running port
        tp, ts, tm = t_step(tp, ts, tb)
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert np.all(np.isfinite(t_losses))
    return tp, ts


def zoo_mkor_steps(name):
    """:func:`mkor_steps_match` on ``name``'s ``.reduced()``, then the
    layers MKOR keeps factors for: whisper-base's encoder (stacked once:
    ā of shape (1, d)), cross-attention and frontend projection; none of
    rwkv6-3b's recurrence vectors, which moved all the same (LAMB)."""
    from repro.configs import registry as j_registry
    jc = j_registry.get_config(name).reduced()
    tp, ts = mkor_steps_match(jc)
    layers = t_mkor.factor_slices(ts, tp)
    if jc.is_encoder_decoder:
        assert any(k.startswith("encoder/") for k in layers)
        assert any("/cross/" in k for k in layers)
        assert "frontend_proj" in layers
        return
    assert not any("bonus" in k or "maa" in k for k in layers)
    start = interop.params_from_numpy(jax.tree.map(
        np.asarray, j_model.init_params(jax.random.key(0), jc)), CPU)
    for key in ("bonus", "maa", "decay_w0"):
        assert not torch.equal(tp["blocks"][0]["mixer"][key],
                               start["blocks"][0]["mixer"][key]), key
