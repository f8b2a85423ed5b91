"""The port's optimizer state trees against ``repro/core``: MKOR's and
LAMB's states hold the reference's key paths, and every leaf its dtype and
shape (``count`` a 0-d int32, MKOR-H's ``hybrid`` scalars), at init and
after steps, for bf16 rank 1, rank 2, staleness 1 and int8 factor state;
``interop.opt_state_from_numpy`` / ``opt_state_to_numpy`` carry a JAX state
across and back bit for bit; and steps taken from a carried JAX state match
the JAX steps (the updates, the params, the banks, and on a model the
loss) at the tolerances of the other parity tests."""
import functools
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
from test_torch_mkor_block import _max_err, _port_cfg

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")

CONFIGS = [dict(rank=1), dict(rank=2), dict(rank=1, staleness=1),
           dict(rank=1, factor_quant="int8"),
           # the health sentinel's subtree; at a pivot tolerance of 1e30
           # every inversion trips, so the carried health leaves are not 0
           dict(rank=2, staleness=1, health=True),
           dict(rank=2, factor_quant="int8", health=True,
                health_pivot_tol=1e30),
           # the per-layer layout: factors, windows and pending factors
           # keyed by layer
           dict(rank=1, layout="per_layer"),
           dict(rank=2, staleness=1, layout="per_layer")]
IDS = ["bf16-rank1", "bf16-rank2", "bf16-staleness1", "int8-rank1",
       "bf16-rank2-staleness1-health", "int8-rank2-health-pivot",
       "per_layer-rank1", "per_layer-rank2-staleness1"]


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _jax_leaves(tree):
    """{key path: (dtype name, shape)} of a JAX (or numpy) tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, x in flat:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        out[key] = (np.asarray(x).dtype.name, tuple(np.shape(x)))
    return out


def _port_leaves(tree, path=()):
    """{key path: (dtype name, shape)} of a port tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_leaves(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_leaves(sub, path + (i,)).items()}
    return {path: (str(tree.dtype).removeprefix("torch."),
                   tuple(tree.shape))}


def _check_tree(js, ts):
    want, got = _jax_leaves(js), _port_leaves(ts)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        assert got[key] == leaf, key
    for key in [k for k in got if k[-1] == "count"]:
        count = ts
        for k in key:
            count = count[k]
        # the schedule's host branch reads it: never a device tensor
        assert count.device.type == "cpu", key


def _draw(rng, host):
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), host)
    stats = {"layers": [{"a": rng.standard_normal(
        p["w"].shape[0]).astype(np.float32)} for p in host["layers"]]}
    return grads, stats


@functools.lru_cache(maxsize=None)
def _jax_opt(kw_items):
    """The JAX optimizer of an MKORConfig (``None``: LAMB alone) and its
    jitted ``update(grads, state, params, stats)``, compiled once a
    config for the whole file."""
    if kw_items is None:
        opt = j_fo.lamb(1e-2)
    else:
        kw = dict(inv_freq=2, exclude=(), **dict(kw_items))
        opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    return opt, jax.jit(lambda g, s, p, st: opt.update(g, s, params=p,
                                                       stats=st))


def _pair(kw):
    """(JAX optimizer, its jitted update, the port's optimizer)."""
    j_opt, j_update = _jax_opt(None if kw is None else
                               tuple(sorted(kw.items())))
    if kw is None:
        return j_opt, j_update, t_fo.lamb(1e-2)
    kw = dict(inv_freq=2, exclude=(), **kw)
    return j_opt, j_update, t_mkor.mkor(t_fo.lamb(1e-2),
                                        t_mkor.MKORConfig(**kw))


def _run_jax(kw, host, steps, rng):
    """``steps`` updates of the JAX optimizer (MKOR, or LAMB for ``None``,
    which ignores ``stats``) on numpy-drawn gradients and statistics;
    returns the state."""
    j_opt, j_update, _ = _pair(kw)
    jp = jax.tree.map(jnp.asarray, host)
    js = j_opt.init(jp)
    for _ in range(steps):
        grads, stats = _draw(rng, host)
        _, js = j_update(grads, js, jp, stats)
    return js


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_mkor_state_tree_matches_reference(ae_params, kw):
    """init and three steps later (a phase step of every bucket at
    inv_freq 2): the same key paths, dtypes and shapes."""
    j_opt, j_update, t_opt = _pair(kw)
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    _check_tree(js, ts)
    assert int(ts["count"]) == 0 and bool(ts["hybrid"]["on"])
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads, stats = _draw(rng, host)
        _, js = j_update(grads, js, jp, stats)
        _, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                             params=tp,
                             stats=interop.tree_from_numpy(stats, CPU))
    _check_tree(js, ts)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert int(ts["backend"]["count"]) == 3
    # with hybrid=False (every config here) the switch is carried unchanged
    for k in ("on", "ema_fast", "ema_slow"):
        assert np.asarray(js["hybrid"][k]) == ts["hybrid"][k].numpy()


def test_lamb_state_tree_matches_reference(ae_params):
    host = _host(ae_params)
    j_opt, j_update, t_opt = _pair(None)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    _check_tree(js, ts)
    rng = np.random.default_rng(2)
    for _ in range(2):
        grads, _ = _draw(rng, host)
        ju, js = j_update(grads, js, jp, None)
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp)
    _check_tree(js, ts)
    assert int(ts["count"]) == int(js["count"]) == 2
    assert _max_err(ju, tu) < 1e-6


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.uint8).reshape(-1)


@pytest.mark.parametrize("kw", CONFIGS + [None], ids=IDS + ["lamb"])
def test_opt_state_round_trips_bit_for_bit(ae_params, kw):
    host = _host(ae_params)
    js = _run_jax(kw, host, 3, np.random.default_rng(3))
    hs = _host(js)
    ts = interop.opt_state_from_numpy(hs, CPU)
    _check_tree(js, ts)
    back = interop.opt_state_to_numpy(ts)
    assert jax.tree.structure(back) == jax.tree.structure(hs)
    for a, b in zip(jax.tree.leaves(hs), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the carried leaves are copies: writing one leaves the host tree alone
    i, leaf = next((i, x) for i, x in enumerate(jax.tree.leaves(ts))
                   if x.is_floating_point())
    before = np.array(jax.tree.leaves(hs)[i], copy=True)
    leaf.add_(1)
    np.testing.assert_array_equal(jax.tree.leaves(hs)[i], before)


def test_opt_state_count_must_be_int32_scalar():
    with pytest.raises(ValueError, match="int32"):
        interop.opt_state_from_numpy({"count": np.int64(3)}, CPU)
    with pytest.raises(ValueError, match="int32"):
        interop.opt_state_from_numpy({"count": np.zeros(2, np.int32)}, CPU)


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_two_steps_from_a_carried_state_match(ae_params, kw):
    """Three JAX steps, then the state carried into the port and two more
    steps on both from the same gradients: updates, applied params and
    banks at fp32 tolerance (int8: codes within one step, as
    tests/test_torch_mkor_int8.py holds them)."""
    _, j_update, t_opt = _pair(kw)
    host = _host(ae_params)
    rng = np.random.default_rng(4)
    js = _run_jax(kw, host, 3, rng)
    ts = interop.opt_state_from_numpy(_host(js), CPU)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    for _ in range(2):
        grads, stats = _draw(rng, host)
        ju, js = j_update(grads, js, jp, stats)
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp,
                              stats=interop.tree_from_numpy(stats, CPU))
        assert _max_err(ju, tu) < 1e-5
        jp = j_fo.apply_updates(jp, ju)
        tp = t_fo.apply_updates(tp, tu)
        assert _max_err(jp, tp) < 1e-5
    assert int(ts["count"]) == int(js["count"]) == 5
    if "health" in js:
        for bid, h in js["health"].items():
            for k, leaf in h.items():
                assert ts["health"][bid][k].dtype == torch.int32
                assert int(ts["health"][bid][k]) == int(leaf), (bid, k)
    for key in ("factor_banks", "pending_banks", "factors",
                "pending_factors"):
        if key not in js:
            continue
        if kw.get("factor_quant") == "int8":
            for bid, jb in js[key].items():
                for side in ("l_inv", "r_inv"):
                    dq = np.abs(np.asarray(jb[side], np.int32)
                                - ts[key][bid][side].numpy())
                    assert dq.max() <= 1, (key, bid, side)
        else:
            # bf16 banks: one bf16 ulp where the fp32 sums round apart
            assert _max_err(js[key], ts[key]) <= 2 ** -6, key


def test_model_steps_from_a_carried_state_match(tiny_model_cfg):
    """The tiny model: four JAX train steps at rank 1 (float32 factors),
    the whole state carried, two more on both: losses, params, banks."""
    cfg = tiny_model_cfg
    kw = dict(inv_freq=2, factor_dtype="float32")
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    j_step = jax.jit(j_loop.make_train_step(cfg, j_opt))
    t_step = t_loop.make_train_step(_port_cfg(cfg), t_opt)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    jp = j_model.init_params(jax.random.key(0), cfg)
    js = j_opt.init(jp)
    for i in range(4):
        jp, js, _ = j_step(jp, js, j_pipe.make_batch(ds, i))
    tp = interop.params_from_numpy(_host(jp), CPU)
    ts = interop.opt_state_from_numpy(_host(js), CPU)
    for i in range(4, 6):
        batch = j_pipe.make_batch(ds, i)
        jp, js, jm = j_step(jp, js, batch)
        tp, ts, tm = t_step(tp, ts, t_loop.batch_to_device(batch, CPU))
        # float32 model and optimizer: float32 rounding in another order
        np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]),
                                   rtol=1e-5)
    assert int(ts["count"]) == int(js["count"]) == 6
    assert _max_err(js["factor_banks"], ts["factor_banks"]) < 1e-4
    assert _max_err(jp, tp) < 2e-4
