"""The port's ``sgd``, ``adam`` and ``adamw`` and the knee-point scheduler
against ``repro/core/firstorder.py`` and ``repro/core/schedule.py``: same
inputs (numpy, seeded), k steps at float32 tolerance, with their plans
(the per-step scalars a CUDA graph reads from buffers), their states
carried through ``interop`` both ways (``sgd``'s ``mu`` is ``None``
without momentum), and the knee point's decay steps and state bit for
bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import firstorder as j_fo
from repro.core import schedule as j_sched
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import schedule as t_sched

torch.set_num_threads(2)
CPU = torch.device("cpu")
RTOL, ATOL = 2e-5, 1e-6          # float32 arithmetic in another order

SGD_CASES = {"plain": dict(), "momentum": dict(momentum=0.9),
             "nesterov": dict(momentum=0.9, nesterov=True),
             "momentum-decay": dict(momentum=0.9, weight_decay=1e-2),
             "decay": dict(weight_decay=1e-2)}


def _tree(rng):
    return {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                  "probe": np.zeros(3, np.float32)},
            "blocks": [{"scale": rng.standard_normal((2, 4))
                        .astype(np.float32)}],
            "zero": np.zeros((2, 2), np.float32)}


def _close(jtree, ttree, rtol=RTOL, atol=ATOL):
    jl = jax.tree.leaves(jtree)
    tl = jax.tree.leaves(interop.tree_to_numpy(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=rtol,
                                   atol=atol)


def _pair(name, kw):
    """(JAX optimizer, port optimizer, port schedule) on a cosine lr."""
    j_lr = j_sched.warmup_cosine(1e-2, 2, 8)
    t_lr = t_sched.warmup_cosine(1e-2, 2, 8)
    if name == "sgd":
        return j_fo.sgd(j_lr, **kw), t_fo.sgd(t_lr, **kw), t_lr
    make = {"adam": (j_fo.adam, t_fo.adam), "adamw": (j_fo.adamw,
                                                      t_fo.adamw)}[name]
    return make[0](j_lr, **kw), make[1](t_lr, **kw), t_lr


def _run(name, kw, steps=5, seed=0):
    rng = np.random.default_rng(seed)
    j_opt, t_opt, _ = _pair(name, kw)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.tree_from_numpy(params, CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for _ in range(steps):
        grads = _tree(rng)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, grads), js,
                              params=jp)
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp)
        _close(ju, tu)
        jp, tp = j_fo.apply_updates(jp, ju), t_fo.apply_updates(tp, tu)
    _close(jp, tp)
    return js, ts


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_sgd_k_steps_match(case):
    js, ts = _run("sgd", SGD_CASES[case])
    if SGD_CASES[case].get("momentum"):
        _close(js["mu"], ts["mu"])
    else:
        assert js["mu"] is None and ts["mu"] is None
    assert int(js["count"]) == int(ts["count"]) == 5
    assert ts["count"].device.type == "cpu"


@pytest.mark.parametrize("name,kw", [("adam", {}),
                                     ("adam", dict(weight_decay=1e-2)),
                                     ("adamw", {})],
                         ids=["adam", "adam-decay", "adamw"])
def test_adam_k_steps_match(name, kw):
    js, ts = _run(name, kw)
    _close(js["m"], ts["m"])
    _close(js["v"], ts["v"])
    assert int(js["count"]) == int(ts["count"]) == 5


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_plans_give_the_scalars_and_update_reads_them(name):
    """``plan``: branch key ``()``; ``sgd`` the learning rate at
    ``count``, ``adam`` / ``adamw`` also the bias corrections at ``count +
    1``, as numpy float32.  ``update`` with those scalars as 0-d tensors
    is ``update`` without them, bit for bit."""
    _, opt, lr = _pair(name, dict(momentum=0.9) if name == "sgd" else {})
    rng = np.random.default_rng(1)
    tp = interop.tree_from_numpy(_tree(rng), CPU)
    state = opt.init(tp)
    for _ in range(3):
        key, scalars = opt.plan(state)
        count = int(state["count"])
        assert key == ()
        assert all(isinstance(v, np.float32) for v in scalars.values())
        assert scalars["lr"] == np.float32(lr(count))
        if name == "sgd":
            assert sorted(scalars) == ["lr"]
        else:
            assert sorted(scalars) == ["bc1", "bc2", "lr"]
            assert scalars["bc2"] == np.float32(1) - np.float32(0.999) ** \
                np.float32(count + 1)
        grads = interop.tree_from_numpy(_tree(rng), CPU)
        u0, s0 = opt.update(grads, state, params=tp)
        u1, s1 = opt.update(grads, state, params=tp,
                            scalars=t_fo.device_scalars(scalars, CPU))
        for a, b in zip(jax.tree.leaves(u0), jax.tree.leaves(u1)):
            assert torch.equal(a, b)
        state = s1


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", dict(momentum=0.9)),
                                     ("adamw", {})],
                         ids=["sgd", "sgd-momentum", "adamw"])
def test_states_carry_through_interop(name, kw):
    """A JAX state after 3 steps → the port (``mu`` ``None`` stays
    ``None``) → back, bit for bit; then two more steps on both from the
    carried state match."""
    rng = np.random.default_rng(2)
    j_opt, t_opt, _ = _pair(name, kw)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_opt.init(jp)
    for _ in range(3):
        _, js = j_opt.update(jax.tree.map(jnp.asarray, _tree(rng)), js,
                             params=jp)
    host = jax.tree.map(lambda x: np.array(x, copy=True), js)
    ts = interop.opt_state_from_numpy(host, CPU)
    assert ts["count"].dtype == torch.int32 and \
        ts["count"].device.type == "cpu"
    if name == "sgd" and not kw:
        assert ts["mu"] is None
    back = interop.opt_state_to_numpy(ts)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tp = interop.tree_from_numpy(params, CPU)
    for _ in range(2):
        grads = _tree(rng)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, grads), js,
                              params=jp)
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp)
        _close(ju, tu)
    assert int(ts["count"]) == int(js["count"]) == 5


def _loss_sequence(n=160, seed=3):
    """A decreasing loss that flattens (a knee), then drops and flattens
    again, with seeded noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    curve = 2.0 + 3.0 * np.exp(-t / 12.0) + 1.5 * (t < 90) \
        * np.exp(-np.maximum(t - 60, 0) / 6.0) * (t > 60)
    return (curve + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, dict(min_steps=5, beta=0.3)],
                         ids=["defaults", "min5-beta0.3"])
def test_kneepoint_matches_bit_for_bit(kw):
    """Over a seeded loss sequence with plateaus: every state leaf bit for
    bit at every step against the reference run op by op (a jitted one
    may contract ``ema * r + (1 - ema) * drop`` into a fused multiply-add,
    an ulp away), and the same decay steps, at least one."""
    j_state = j_sched.kneepoint_init(1e-2)
    t_state = t_sched.kneepoint_init(1e-2, device=CPU)
    decays = []
    for i, loss in enumerate(_loss_sequence()):
        j_state = j_sched.kneepoint_update(j_state, jnp.asarray(loss), **kw)
        t_state = t_sched.kneepoint_update(t_state, torch.tensor(loss), **kw)
        for k in j_state:
            want = np.asarray(j_state[k])
            got = t_state[k].numpy()
            assert got.dtype == np.float32 and got.shape == ()
            assert want.tobytes() == got.tobytes(), (i, k, want, got)
        if i and float(t_state["lr"]) != float(prev_lr):
            decays.append(i)
        prev_lr = t_state["lr"]
    assert decays, "the sequence must reach a knee"
    print(f"knee-point decays at steps {decays}")


def test_a_none_subtree_rides_through_the_chunk_runner(tiny_model_cfg,
                                                      monkeypatch):
    """``sgd`` without momentum keeps ``"mu": None``: the chunk runner's
    static-buffer binding (its template, the host counts, the tree it
    hands the step) keeps the ``None``, and a chunk equals the per-step
    loop bit for bit.  (On the CPU every leaf lies on the host, so the
    binding is run with the card's rule: only the 0-d int32 counts.)"""
    from repro_torch.data import pipeline as t_pipe
    from repro_torch.models import model as t_model
    from repro_torch.training import loop as t_loop
    from test_torch_chunk import _assert_bit_equal
    from test_torch_mkor_block import _port_cfg
    cfg = _port_cfg(tiny_model_cfg)
    opt = t_fo.sgd(1e-2)
    step = t_loop.make_train_step(cfg, opt)
    params = t_model.init_params(cfg, seed=0, device=CPU)
    state = opt.init(params)
    assert state["mu"] is None
    ds = t_pipe.make_dataset(cfg, global_batch=2, seq_len=16, seed=0)
    batches = [t_pipe.make_batch(ds, i) for i in range(4)]
    runner = t_loop.make_chunk_runner(step)
    stacked = t_loop.stack_batches(batches[:2])
    monkeypatch.setattr(t_loop, "_host_leaf", lambda t: t.ndim == 0 and
                        t.dtype == torch.int32 and t.device.type == "cpu")
    for _ in range(2):                   # the first bind, then a rebind
        host = runner._bind(params, state, stacked, CPU)
        assert host == [0]               # sgd's count, the one host leaf
        p, s = runner._tree_at(host)
        assert s["mu"] is None and int(s["count"]) == 0
    monkeypatch.undo()
    p, s = params, state
    for b in batches:
        p, s, _ = step(p, s, t_loop.batch_to_device(b, CPU))
    pe, se, _ = t_loop.train_epoch(step, params, state, batches, chunk=2)
    _assert_bit_equal((pe, se), (p, s))
    assert se["mu"] is None and int(se["count"]) == 4
