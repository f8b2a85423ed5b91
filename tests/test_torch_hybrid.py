"""The port's MKOR-H (``mkor_h``: the sticky switch to first order) and
``factor_slices`` against ``repro/core/mkor.py``.

On the conftest autoencoder, numpy-drawn gradients and statistics and a
fixed loss sequence that flips the switch at count 6 (min steps 3,
threshold 0.054; the test prints the margin of the rate to the threshold
at counts 4-6, so no case sits at an fp32 tie) go through the JAX
``mkor_h`` (jitted) and the port, at rank 1, rank 2, staleness 1 and
int8, on ``sgd`` and ``lamb`` backends.  Held: the same flip step; the
``hybrid`` state bit for bit against the reference's ``_hybrid_update``
run op by op (what the JAX ``mkor_h`` computes unjitted; a jitted XLA
computation may fuse its EMAs into a multiply-add, an fp32 ulp away); the
updates, banks, windows and pending banks at the tolerances of the other
parity tests; banks bit-frozen over two ``inv_freq`` windows after the
flip; stickiness; ``ValueError`` without a loss.  The host-view-off route
(no second-order work) equals the masked route from the same state bit
for bit, and calls none of the second-order functions.  ``train_epoch``
with ``mkor_h`` on the tiny model against the JAX ``train_epoch``, and
against the port's per-step loop bit for bit (the switch flips inside a
chunk)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import firstorder as j_fo
from repro.data import pipeline as j_pipe
from repro.models import model as j_model
from repro.training import loop as j_loop
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.training import loop as t_loop

# the shared parity helpers (tests/ is on sys.path, pytest's default
# "prepend" import mode)
from test_torch_chunk import _assert_bit_equal
from test_torch_mkor_block import _max_err, _port_cfg
from test_torch_mkor_int8 import check_int8_banks, check_int8_windows
from test_torch_state import _draw, _host

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")

# the switch: the rate stays above 0.054 at counts 4 and 5 and falls below
# it at count 6 (the spike), then rises again: the switch must stay off
LOSSES = [5.0, 4.6, 4.2, 3.9, 3.7, 3.6, 6.0, 5.0, 4.0, 3.5, 3.2, 3.0, 2.9,
          2.8, 2.7, 2.6]
FLIP = 6
HYBRID = dict(hybrid_min_steps=3, hybrid_threshold=0.054)
CASES = {
    "bf16-rank1-sgd": ("sgd", dict()),
    "bf16-rank2-lamb": ("lamb", dict(rank=2)),
    "bf16-staleness1-sgd": ("sgd", dict(staleness=1)),
    "int8-rank1-lamb": ("lamb", dict(factor_quant="int8")),
    "int8-staleness1-sgd": ("sgd", dict(factor_quant="int8", staleness=1)),
}


def _opts(backend, kw):
    cfg = dict(inv_freq=2, exclude=(), **HYBRID, **kw)
    make = {"sgd": (lambda: j_fo.sgd(1e-2, momentum=0.9),
                    lambda: t_fo.sgd(1e-2, momentum=0.9)),
            "lamb": (lambda: j_fo.lamb(1e-2), lambda: t_fo.lamb(1e-2))}
    jb, tb = make[backend]
    return (j_mkor.mkor_h(jb(), j_mkor.MKORConfig(**cfg)),
            t_mkor.mkor_h(tb(), t_mkor.MKORConfig(**cfg)))


def _reference_hybrid(losses, kw):
    """The reference's ``_hybrid_update`` op by op over ``losses``: the
    ``hybrid`` state after each step."""
    cfg = j_mkor.MKORConfig(hybrid=True, **HYBRID, **kw)
    h, out = j_mkor._hybrid_init(), []
    for count, loss in enumerate(losses):
        h = j_mkor._hybrid_update(h, jnp.float32(loss), jnp.int32(count),
                                  cfg)
        out.append({k: np.asarray(v) for k, v in h.items()})
    return out


def test_loss_sequence_flips_with_a_margin():
    """The rate (slow − fast)/|slow| of the reference at counts 4-6 against
    the threshold: above it at 4 and 5, below at 6, none within 1e-3."""
    h = j_mkor._hybrid_init()
    cfg = j_mkor.MKORConfig(hybrid=True, **HYBRID)
    margins = {}
    for count, loss in enumerate(LOSSES[:FLIP + 1]):
        h = j_mkor._hybrid_update(h, jnp.float32(loss), jnp.int32(count),
                                  cfg)
        slow, fast = float(h["ema_slow"]), float(h["ema_fast"])
        margins[count] = (slow - fast) / abs(slow) - HYBRID[
            "hybrid_threshold"]
    print(f"rate - threshold at counts 4-6: "
          f"{[round(margins[c], 6) for c in (4, 5, 6)]}")
    assert margins[4] > 1e-3 and margins[5] > 1e-3 and margins[6] < -1e-3


@pytest.mark.parametrize("case", sorted(CASES))
def test_mkor_h_matches_reference(ae_params, case):
    backend, kw = CASES[case]
    j_opt, t_opt = _opts(backend, kw)
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_update = jax.jit(lambda g, s, p, st, loss: j_opt.update(
        g, s, params=p, stats=st, loss=loss))
    want_h = _reference_hybrid(LOSSES, kw)
    rng = np.random.default_rng(5)
    frozen = None
    bank_keys = ["factor_banks"] + (["pending_banks"]
                                    if kw.get("staleness") else [])
    for count, loss in enumerate(LOSSES):
        grads, stats = _draw(rng, host)
        ju, js = j_update(grads, js, jp, stats, jnp.float32(loss))
        # the eager protocol: the host view read once a step
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp,
                              stats=interop.tree_from_numpy(stats, CPU),
                              loss=torch.tensor(loss, dtype=torch.float32),
                              view=t_opt.observe(ts))
        # the switch: the same flip, and the state bit for bit
        assert bool(js["hybrid"]["on"]) == bool(ts["hybrid"]["on"]) == \
            (count < FLIP), count
        for k, want in want_h[count].items():
            got = ts["hybrid"][k].numpy()
            assert got.dtype == want.dtype and got.shape == ()
            assert got.tobytes() == want.tobytes(), (count, k)
        assert _max_err(ju, tu) < 1e-5, count
        if count == FLIP:
            frozen = {k: [t.clone() for t in jax.tree.leaves(ts[k])]
                      for k in bank_keys}
        if count == FLIP + 2 * 2:
            # two inv_freq windows after the flip: every bucket's phase
            # passed twice and the banks did not move
            for k in bank_keys:
                for a, b in zip(frozen[k], jax.tree.leaves(ts[k])):
                    assert torch.equal(a, b), k
    assert int(ts["count"]) == int(js["count"]) == len(LOSSES)
    if kw.get("factor_quant") == "int8":
        for key in bank_keys:
            check_int8_banks(js[key], ts[key], recon_tol=1e-4,
                             flip_slack=0.25)
        if "stat_windows" in js:
            check_int8_windows(js["stat_windows"], ts["stat_windows"])
    else:
        for key in bank_keys:
            # bf16 banks: one bf16 ulp where the fp32 sums round apart
            assert _max_err(js[key], ts[key]) <= 2 ** -6, key
        if "stat_windows" in js:
            assert _max_err(js["stat_windows"], ts["stat_windows"]) < 1e-5
    # the banks left the identity before the flip
    eye = [t for t in jax.tree.leaves(t_opt.init(tp)["factor_banks"])]
    assert any(not torch.equal(a, b) for a, b in
               zip(eye, jax.tree.leaves(ts["factor_banks"])))


def test_mkor_h_is_sticky_and_needs_the_loss(ae_params):
    """As ``tests/test_mkor.py``: a constant loss turns the switch off; a
    falling loss afterwards leaves it off; no loss raises."""
    cfg = t_mkor.MKORConfig(hybrid_min_steps=2, hybrid_threshold=0.5,
                            exclude=())
    opt = t_mkor.mkor_h(t_fo.sgd(1e-2), cfg)
    assert opt.observe is not None and t_mkor.mkor(
        t_fo.sgd(1e-2), t_mkor.MKORConfig()).observe is None
    tp = interop.params_from_numpy(_host(ae_params), CPU)
    state = opt.init(tp)
    rng = np.random.default_rng(6)
    grads, stats = (interop.tree_from_numpy(x, CPU)
                    for x in _draw(rng, _host(ae_params)))
    assert bool(state["hybrid"]["on"])
    with pytest.raises(ValueError, match="loss"):
        opt.update(grads, state, params=tp, stats=stats)
    for _ in range(8):
        _, state = opt.update(grads, state, params=tp, stats=stats,
                              loss=torch.tensor(1.0))
    assert not bool(state["hybrid"]["on"])
    for i in range(3):
        _, state = opt.update(grads, state, params=tp, stats=stats,
                              loss=torch.tensor(1.0 / (i + 2)),
                              view=opt.observe(state))
    assert not bool(state["hybrid"]["on"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_view_off_route_equals_masked_route(ae_params, case, monkeypatch):
    """From the same post-flip state, steps with the host view off equal
    the masked route (no view) bit for bit, updates and whole state, over
    two inv_freq windows; the off route calls no stabilize, SMW, block
    update or precondition."""
    backend, kw = CASES[case]
    _, opt = _opts(backend, kw)
    host = _host(ae_params)
    tp = interop.params_from_numpy(host, CPU)
    state = opt.init(tp)
    rng = np.random.default_rng(7)
    draws = [tuple(interop.tree_from_numpy(x, CPU) for x in _draw(rng, host))
             for _ in range(len(LOSSES))]
    loss = [torch.tensor(x, dtype=torch.float32) for x in LOSSES]

    def step(st, i, **view):
        grads, stats = draws[i]
        pre = opt.precompute(st, params=tp, **view) if opt.precompute \
            else st
        return opt.update(grads, pre, params=tp, stats=stats, loss=loss[i],
                          precomputed=opt.precompute is not None, **view)

    for i in range(FLIP + 1):
        _, state = step(state, i)
    assert not opt.observe(state)
    masked, off = state, state
    for i in range(FLIP + 1, FLIP + 5):
        u_m, masked = step(masked, i)
        with monkeypatch.context() as m:
            for name in ("stabilize", "smw_rank1_update",
                         "fused_block_smw_plain", "precondition"):
                m.setattr(t_mkor, name, _refuse(name))
            u_o, off = step(off, i, view=False)
        _assert_bit_equal(u_o, u_m)
        _assert_bit_equal(off, masked)


def _refuse(name):
    def fn(*a, **k):
        raise AssertionError(f"{name} ran with the host view off")
    return fn


def test_plan_with_hybrid_keys_the_view():
    """``plan``: ``(count % inv_freq, backend key)`` while the switch may
    be on, ``(None, backend key)`` once the view is off, with the
    backend's scalars and the switch's two 0/1 scalars."""
    opt = t_mkor.mkor_h(t_fo.lamb(1e-2), t_mkor.MKORConfig(inv_freq=3,
                                                           **HYBRID))
    for count, first, late in ((0, 1, 0), (3, 0, 0), (4, 0, 1)):
        state = {"count": t_fo.step_count(count),
                 "backend": {"count": t_fo.step_count(count)}}
        key, scalars = opt.plan(state)
        assert key == (count % 3, ())
        assert opt.plan(state, view=True)[0] == key
        assert opt.plan(state, view=False)[0] == (None, ())
        assert sorted(scalars) == ["bc1", "bc2", "hybrid_first",
                                   "hybrid_late", "lr"]
        assert scalars["hybrid_first"] == np.float32(first)
        assert scalars["hybrid_late"] == np.float32(late)


def _tiny_opts(kw):
    cfg = dict(inv_freq=2, hybrid_min_steps=2, hybrid_threshold=1.0, **kw)
    return (j_mkor.mkor_h(j_fo.lamb(1e-2), j_mkor.MKORConfig(**cfg)),
            t_mkor.mkor_h(t_fo.lamb(1e-2), t_mkor.MKORConfig(**cfg)))


def test_train_epoch_mkor_h_matches_jax(tiny_model_cfg):
    """The tiny model, 7 steps in chunks of 3 through the JAX and the
    port's ``train_epoch`` (threshold 1: the switch flips at count 3,
    inside the second chunk): losses and params at the MKOR parity
    tolerances, the switch off in both, its EMAs at fp32 tolerance, the
    bf16 banks at bf16's."""
    cfg = tiny_model_cfg
    j_opt, t_opt = _tiny_opts({})
    jp = j_model.init_params(jax.random.key(0), cfg)
    tp = interop.params_from_numpy(_host(jp), CPU)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    batches = [j_pipe.make_batch(ds, i) for i in range(7)]
    jp, js, j_hist = j_loop.train_epoch(
        j_loop.make_train_step(cfg, j_opt), jp, j_opt.init(jp), batches,
        chunk=3, donate=False)
    tp, ts, t_hist = t_loop.train_epoch(
        t_loop.make_train_step(_port_cfg(cfg), t_opt), tp, t_opt.init(tp),
        batches, chunk=3)
    np.testing.assert_allclose([h["loss"] for h in j_hist],
                               [h["loss"] for h in t_hist], rtol=1e-5)
    assert _max_err(jp, tp) < 2e-4
    assert not bool(js["hybrid"]["on"]) and not bool(ts["hybrid"]["on"])
    for k in ("ema_fast", "ema_slow"):
        np.testing.assert_allclose(np.asarray(js["hybrid"][k]),
                                   ts["hybrid"][k].numpy(), rtol=1e-5)
    assert int(ts["count"]) == int(js["count"]) == 7
    assert _max_err(js["factor_banks"], ts["factor_banks"]) <= 2 ** -6


@pytest.mark.parametrize("kw", [{}, dict(rank=2, staleness=1)],
                         ids=["rank1", "rank2-staleness1"])
def test_train_epoch_mkor_h_equals_per_step_loop(tiny_model_cfg, kw):
    """The port's ``train_epoch`` (the view read once a chunk: the steps
    after the flip inside its chunk take the masked route) against the
    per-step loop (the view read every step: the off route from the step
    after the flip), 7 steps in chunks of 3: losses and the whole state
    bit for bit."""
    cfg = _port_cfg(tiny_model_cfg)
    _, opt = _tiny_opts(kw)
    tp = interop.params_from_numpy(_host(j_model.init_params(
        jax.random.key(0), tiny_model_cfg)), CPU)
    ds = j_pipe.make_dataset(tiny_model_cfg, global_batch=2, seq_len=16)
    batches = [j_pipe.make_batch(ds, i) for i in range(7)]
    step = t_loop.make_train_step(cfg, opt)
    assert step.observe is opt.observe
    p, s, losses = tp, opt.init(tp), []
    for batch in batches:
        p, s, m = step(p, s, t_loop.batch_to_device(batch, CPU))
        losses.append(float(m["loss"]))
    pe, se, hist = t_loop.train_epoch(step, tp, opt.init(tp), batches,
                                      chunk=3)
    assert [h["loss"] for h in hist] == losses
    _assert_bit_equal((pe, se), (p, s))
    assert not bool(se["hybrid"]["on"])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_factor_slices_match(ae_params, quant):
    """A JAX state after three steps, carried into the port: the per-layer
    views of the banks equal the reference's (bf16 bit for bit; int8
    decoded to fp32 the same way)."""
    kw = dict(inv_freq=2, exclude=(), factor_quant=quant)
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    js = j_opt.init(jp)
    j_update = jax.jit(lambda g, s, st: j_opt.update(g, s, params=jp,
                                                     stats=st))
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads, stats = _draw(rng, host)
        _, js = j_update(grads, js, stats)
    ts = interop.opt_state_from_numpy(_host(js), CPU)
    want = j_mkor.factor_slices(js, jp, j_mkor.MKORConfig(**kw))
    got = t_mkor.factor_slices(ts, interop.params_from_numpy(host, CPU),
                               t_mkor.MKORConfig(**kw))
    assert sorted(got) == sorted(want) and len(got) == 4
    for layer, sides in want.items():
        for side, w in sides.items():
            g = got[layer][side]
            w = np.asarray(w)
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name
            np.testing.assert_array_equal(
                interop.tree_to_numpy(g), np.asarray(w, np.float32)
                if w.dtype.name == "bfloat16" else w)
