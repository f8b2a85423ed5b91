"""The port's staleness-1 MKOR (double-buffered inverse banks, the
``precompute`` tick) against ``repro/core/mkor.py``: 6 training steps at
rank 1 and 2 on the same weights and batches, the two call protocols bit
for bit, and runs started from a JAX optimizer state taken mid-window
(banks, windows and pending banks carried over by ``interop``)."""
import importlib

import jax
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
from test_torch_mkor_block import _max_err, _port_cfg, check_runs, run_both

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("rank,factor_dtype", [(1, "bfloat16"),
                                               (2, "float32")])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_mkor_staleness1_six_steps_match(rank, factor_dtype, variant,
                                         tiny_model_cfg):
    """inv_freq=2 with stagger: every bucket ticks three times, and the
    banks promoted at the later ticks carry consumed windows."""
    kw = dict(inv_freq=2, rank=rank, staleness=1, variant=variant,
              factor_dtype=factor_dtype)
    j_run, t_run = run_both(tiny_model_cfg, kw, steps=6)
    check_runs(j_run, t_run, factor_dtype, steps=6)
    ts = t_run[2]
    eye = {b: torch.eye(bank["l_inv"].shape[-1]) for b, bank in
           ts["factor_banks"].items()}
    assert any(not torch.equal(bank["l_inv"][0, ...].float(), eye[b])
               for b, bank in ts["factor_banks"].items())


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _grads_and_stats(rng, host):
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), host)
    stats = {"layers": [{"a": rng.standard_normal(
        p["w"].shape[0]).astype(np.float32)} for p in host["layers"]]}
    return grads, stats


def _assert_bit_equal(a, b):
    """Same tree structure, every tensor leaf equal bit for bit (torch
    tensors are leaves of JAX's tree utilities)."""
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


@pytest.mark.parametrize("rank", [1, 2])
def test_precompute_protocol_bit_equal(ae_params, rank):
    """``precompute`` then ``update(precomputed=True)`` equals ``update``
    running the tick inline, bit for bit: updates and the whole state."""
    opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(
        rank=rank, staleness=1, inv_freq=2, exclude=(),
        factor_dtype="float32"))
    host = _host(ae_params)
    params = interop.params_from_numpy(host, CPU)
    s1 = s2 = opt.init(params)
    rng = np.random.default_rng(rank)
    for _ in range(5):
        grads, stats = (interop.tree_from_numpy(t, CPU)
                        for t in _grads_and_stats(rng, host))
        u1, s1 = opt.update(grads, opt.precompute(s1, params=params),
                            params=params, stats=stats, precomputed=True)
        u2, s2 = opt.update(grads, s2, params=params, stats=stats)
        _assert_bit_equal(u1, u2)
    _assert_bit_equal(s1, s2)
    with pytest.raises(ValueError, match="params"):
        opt.precompute(s1)


def test_sync_optimizer_has_no_precompute():
    assert t_mkor.mkor(t_fo.lamb(1e-3)).precompute is None
    assert t_mkor.mkor(t_fo.lamb(1e-3),
                       t_mkor.MKORConfig(rank=4)).precompute is None
    state = t_mkor.mkor(t_fo.lamb(1e-3), t_mkor.MKORConfig(staleness=1))
    assert state.precompute is not None
    for bad in (dict(rank=0), dict(staleness=2)):
        with pytest.raises(ValueError):
            t_mkor.mkor(t_fo.lamb(1e-3), t_mkor.MKORConfig(**bad))


@pytest.mark.parametrize("kw", [dict(rank=4), dict(rank=2, staleness=1)],
                         ids=["rank4", "rank2-staleness1"])
def test_resume_from_jax_state_mid_window(kw, tiny_model_cfg):
    """Start the port from the JAX optimizer state after 5 steps (windows
    part filled, pending banks mid-flight) and run 3 more steps on both:
    every bucket consumes a window the JAX run filled."""
    cfg = tiny_model_cfg
    kw = dict(inv_freq=4, factor_dtype="float32", **kw)
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    j_step = jax.jit(j_loop.make_train_step(cfg, j_opt))
    t_step = t_loop.make_train_step(_port_cfg(cfg), t_opt)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    jp = j_model.init_params(jax.random.key(0), cfg)
    js = j_opt.init(jp)
    for i in range(5):
        jp, js, _ = j_step(jp, js, j_pipe.make_batch(ds, i))
    hs = _host(js)
    assert max(int(w["n"].max()) for w in hs["stat_windows"].values()) > 0
    tp = interop.params_from_numpy(_host(jp), CPU)
    ts = interop.opt_state_from_numpy(hs, CPU)
    assert ts["stat_windows"][next(iter(ts["stat_windows"]))]["n"].dtype \
        == torch.int32
    for i in range(5, 8):
        batch = j_pipe.make_batch(ds, i)
        jp, js, jm = j_step(jp, js, batch)
        tp, ts, tm = t_step(tp, ts, t_loop.batch_to_device(batch, CPU))
        # float32 model and optimizer: float32 rounding in another order
        np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]),
                                   rtol=1e-5)
    assert _max_err(js["factor_banks"], ts["factor_banks"]) < 1e-4
    assert _max_err(js["stat_windows"], ts["stat_windows"]) < 1e-4
    if "pending_banks" in js:
        assert _max_err(js["pending_banks"], ts["pending_banks"]) < 1e-4
    assert _max_err(jp, tp) < 2e-4
