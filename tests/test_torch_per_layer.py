"""The port's per-layer MKOR layout (``MKORConfig(layout="per_layer")``,
the reference's numerical oracle for the bank layout): against the JAX
package's per-layer path on the ``ae_params`` autoencoder (rank 1 and 3,
staleness 1, stagger off, ``exact_smw``, MKOR-H across its switch) and on
the scan-stacked tiny model; against the port's own bank path through
``factor_slices`` at the reference's tolerance (``tests/test_mkor.py``'s
``rtol=1e-5, atol=1e-6``) on a (48, 48, 48) autoencoder, whose 48×48
bucket holds two layers; ``use_kernels=True`` on the CPU (the per-layer
kernel entries' plain versions) against the plain route; and the
per-layer entries of ``kernels/ops.py`` themselves."""
import dataclasses
import importlib
import warnings

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
from repro_torch.core import baseline_net as t_net
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import ops as t_ops
from repro_torch.training import loop as t_loop

from test_torch_mkor_block import _max_err, _port_cfg

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")

# each case against the JAX package's per-layer path, 5 steps at
# inv_freq 2 on fp32 factors; MKOR-H flips off at count 2 (min steps 1,
# threshold 1: any rate below 1 stalls)
PARITY = {
    "rank1": dict(),
    "rank3": dict(rank=3),
    "staleness1": dict(staleness=1),
    "stagger-off": dict(stagger=False),
    "exact_smw": dict(variant="exact_smw"),
    "mkor_h": dict(hybrid=True, hybrid_min_steps=1, hybrid_threshold=1.0),
}
LOSSES = (3.0, 2.9, 2.85, 2.8, 2.8)


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _draw(rng, host):
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), host)
    stats = {"layers": [{"a": rng.standard_normal(
        p["w"].shape[0]).astype(np.float32)} for p in host["layers"]]}
    return grads, stats


def _cfg_kw(kw):
    return dict(inv_freq=2, exclude=(), factor_dtype="float32",
                layout="per_layer", **kw)


@pytest.mark.parametrize("case", sorted(PARITY))
def test_per_layer_matches_reference(ae_params, case):
    """Updates < 1e-5 every step, factors < 1e-4 and windows < 1e-5 after
    5 steps (the bank path's tolerances, tests/test_torch_mkor.py); the
    port takes MKOR-H's host view each step, as the train step does."""
    kw = _cfg_kw(PARITY[case])
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_update = jax.jit(lambda g, s, p, st, loss: j_opt.update(
        g, s, params=p, stats=st, loss=loss))
    rng = np.random.default_rng(5)
    for loss in LOSSES:
        grads, stats = _draw(rng, host)
        ju, js = j_update(grads, js, jp, stats, jnp.float32(loss))
        view = t_opt.observe(ts) if t_opt.observe is not None else None
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp,
                              stats=interop.tree_from_numpy(stats, CPU),
                              loss=torch.tensor(loss), view=view)
        assert _max_err(ju, tu) < 1e-5
        jp, tp = j_fo.apply_updates(jp, ju), t_fo.apply_updates(tp, tu)
    assert sorted(ts) == sorted(js)
    assert _max_err(js["factors"], ts["factors"]) < 1e-4
    for key in ("stat_windows", "pending_factors"):
        if key in js:
            assert _max_err(js[key], ts[key]) < 1e-4, key
    if case == "mkor_h":
        assert not bool(js["hybrid"]["on"]) and not bool(ts["hybrid"]["on"])


def _ae_batch(step, d_in=96):
    """An autoencoder on low-rank data (tests/test_mkor.py's batches)."""
    rng = np.random.default_rng(step)
    basis = np.random.default_rng(0).standard_normal((8, d_in)) / 3
    x = torch.tensor((rng.standard_normal((64, 8)) @ basis)
                     .astype(np.float32))
    return {"x": x, "y": x}


def _run_layout(layout, params, kw, steps=5):
    opt = t_mkor.mkor(t_fo.sgd(1e-2, momentum=0.9),
                      t_mkor.MKORConfig(layout=layout, exclude=(), **kw))
    state, upds = opt.init(params), []
    for i in range(steps):
        loss, grads, stats = t_net.grads_and_full_stats(params, _ae_batch(i))
        view = opt.observe(state) if opt.observe is not None else None
        upd, state = opt.update(grads, state, params=params, stats=stats,
                                loss=loss, view=view)
        params = t_fo.apply_updates(params, upd)
        upds.append(upd)
    return params, state, upds


def _close(a, b, rtol=1e-5, atol=1e-6):
    for x, y in zip(jax.tree.leaves(interop.tree_to_numpy(a)),
                    jax.tree.leaves(interop.tree_to_numpy(b))):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


@pytest.mark.parametrize("kw", [
    dict(inv_freq=2), dict(inv_freq=3, rank=3),
    dict(inv_freq=3, rank=2, staleness=1),
    dict(inv_freq=2, variant="exact_smw", stagger=False),
    dict(inv_freq=2, factor_quant="bf16"),
    dict(inv_freq=2, hybrid=True, hybrid_min_steps=1,
         hybrid_threshold=1.0)],
    ids=["rank1", "rank3", "rank2-staleness1", "exact-stagger-off", "bf16",
         "mkor_h"])
def test_bank_equals_per_layer(kw):
    """The port's bank path reproduces its per-layer path on the port's
    own autoencoder (96 → 48/48/48 → 96, drawn from a torch.Generator),
    trained by ``baseline_net.grads_and_full_stats``: the same updates
    every step, the same params, and the same factors through
    ``factor_slices`` (the 48×48 bucket holds both hidden layers)."""
    params = t_net.init_autoencoder(torch.Generator().manual_seed(0), 96,
                                    (48, 48, 48))
    p_b, s_b, u_b = _run_layout("bank", params, kw)
    p_l, s_l, u_l = _run_layout("per_layer", params, kw)
    cfg = t_mkor.MKORConfig(exclude=(), **kw)
    assert any(b.n_slots == 2 for b in t_mkor.manifest_for(params, cfg))
    for ub, ul in zip(u_b, u_l):
        _close(ub, ul)
    _close(p_b, p_l)
    fs_b = t_mkor.factor_slices(s_b, params, cfg)
    fs_l = t_mkor.factor_slices(s_l, params, cfg)
    assert sorted(fs_b) == sorted(fs_l) == sorted(s_l["factors"])
    _close(fs_b, fs_l)
    if "pending_factors" in s_l:
        pend = t_mkor.factor_slices({"factor_banks": s_b["pending_banks"]},
                                    params, cfg)
        _close(pend, s_l["pending_factors"])


@pytest.mark.parametrize("kw", [dict(), dict(rank=2, staleness=1)],
                         ids=["rank1", "rank2-staleness1"])
def test_per_layer_kernel_entries_on_cpu(ae_params, monkeypatch, kw):
    """``use_kernels=True`` on CPU tensors: the per-layer entries run
    their kernels' plain versions, held to the plain route at fp32
    tolerance (another association of the same fp32 sums), and the path
    reaches every entry it should (and never the banked ones directly)."""
    calls = {}
    for name in ("smw_rank1_update", "smw_block_update",
                 "fused_precondition"):
        fn = getattr(t_ops, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(t_ops, name, spy)
    host = _host(ae_params)
    tp = interop.params_from_numpy(host, CPU)
    opts = [t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(
        use_kernels=k, **_cfg_kw(kw))) for k in (True, False)]
    states = [o.init(tp) for o in opts]
    rng = np.random.default_rng(6)
    for _ in range(4):
        grads, stats = _draw(rng, host)
        g, st = (interop.tree_from_numpy(x, CPU) for x in (grads, stats))
        (uk, states[0]), (up, states[1]) = (
            o.update(g, s, params=tp, stats=st)
            for o, s in zip(opts, states))
        assert _max_err(interop.tree_to_numpy(uk), up) < 1e-5
    assert _max_err(interop.tree_to_numpy(states[0]["factors"]),
                    states[1]["factors"]) < 1e-5
    smw = "smw_block_update" if kw else "smw_rank1_update"
    # 4 layers: 4 steps of preconditions, and each layer's 2 phase steps
    # of inversions (a side each)
    assert calls == {"fused_precondition": 16, smw: 16}


def test_per_layer_stacked_model_matches_reference(tiny_model_cfg):
    """The tiny model with ``scan_layers=True`` (each dense path a
    (2, d_in, d_out) stack): 4 train steps at rank 2, staleness 1, against
    the JAX package's per-layer path (the losses at fp32 rounding, params
    < 2e-4 as tests/test_torch_mkor.py, factors < 1e-4)."""
    cfg = dataclasses.replace(tiny_model_cfg, scan_layers=True)
    kw = dict(inv_freq=2, rank=2, staleness=1, layout="per_layer",
              factor_dtype="float32")
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    jp = j_model.init_params(jax.random.key(0), cfg)
    tp = interop.params_from_numpy(jax.tree.map(np.array, jp), CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    assert any(f["l_inv"].ndim == 3 for f in ts["factors"].values())
    j_step = jax.jit(j_loop.make_train_step(cfg, j_opt))
    t_step = t_loop.make_train_step(_port_cfg(cfg), t_opt)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    for i in range(4):
        batch = j_pipe.make_batch(ds, i)
        jp, js, jm = j_step(jp, js, batch)
        tp, ts, tm = t_step(tp, ts, t_loop.batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]),
                                   rtol=1e-5)
    assert _max_err(jp, tp) < 2e-4
    assert _max_err(js["factors"], ts["factors"]) < 1e-4
    assert _max_err(js["pending_factors"], ts["pending_factors"]) < 1e-4


def test_per_layer_config_errors_match_reference():
    """int8 with the per-layer layout, and an unknown layout, raise the
    reference's ValueError (health: tests/test_torch_health.py)."""
    for kw, match in ((dict(factor_quant="int8", layout="per_layer"),
                       "layout='bank'"),
                      (dict(layout="columns"), "unknown layout")):
        with pytest.raises(ValueError, match=match):
            j_mkor.mkor(j_fo.lamb(1e-3), j_mkor.MKORConfig(**kw))
        with pytest.raises(ValueError, match=match):
            t_mkor.mkor(t_fo.lamb(1e-3), t_mkor.MKORConfig(**kw))


def test_per_layer_entries():
    """The per-layer entries on CPU tensors: chained rank-1 rows equal
    one update a row; the block update's default window is full; a
    stacked factor is updated whole (each slice as alone); ``matmul_cu``
    is ``matmul``; an extra gradient dim falls back, counted."""
    rng = np.random.default_rng(7)
    d = 12
    a = rng.standard_normal((3, d, d)).astype(np.float32) * 0.1 / d
    j = torch.tensor(np.eye(d, dtype=np.float32) + a @ a.transpose(0, 2, 1))
    v = torch.tensor(rng.standard_normal((3, 2, d)).astype(np.float32))
    chained = t_ops.smw_rank1_update(j[0], v[0], gamma=0.9)
    one = t_ops.smw_rank1_update(j[0], v[0, 0], gamma=0.9)
    assert torch.equal(chained,
                       t_ops.smw_rank1_update(one, v[0, 1], gamma=0.9))
    stacked = t_ops.smw_block_update(j, v, gamma=0.9)
    assert torch.equal(stacked, t_ops.smw_block_update_banked(j, v, 2,
                                                              gamma=0.9))
    for i in range(3):
        torch.testing.assert_close(
            stacked[i], t_ops.smw_block_update(j[i], v[i], gamma=0.9),
            rtol=1e-6, atol=1e-7)
    x = torch.tensor(rng.standard_normal((d, 5)).astype(np.float32))
    assert torch.equal(t_ops.matmul_cu(j[0], x), t_mm.matmul_plain(
        j[0], x, torch.float32))
    g = torch.tensor(rng.standard_normal((3, d, d)).astype(np.float32))
    t_ops.reset_fallback_counts()
    want = t_ops.fused_precondition_banked(j, j, g)
    assert torch.equal(t_ops.fused_precondition(j, j, g), want)
    assert not t_ops.fallback_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", t_ops.KernelFallbackWarning)
        experts = t_ops.fused_precondition(j[0], j[1], g)
    assert t_ops.fallback_counts() == {("fused_precond", "extra_dims"): 1}
    delta = t_mkor.precondition(j[0], j[1], g)
    torch.testing.assert_close(experts, t_mkor.rescale_update(delta, g),
                               rtol=1e-5, atol=1e-6)
