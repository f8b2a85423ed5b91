"""The port's MKOR against ``repro/core/mkor.py``: the single-factor math,
the config, and whole training runs — same weights (interop), same
batches, 6 steps at inv_freq=2 with stagger on and off and both variants.
float32 factor banks are held to float32 tolerance; bf16 banks to bf16
tolerance."""
import dataclasses
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
from repro_torch.models import config as t_config
from repro_torch.training import loop as t_loop

from torch_dist_worker import run_ranks

# the module, not the function that repro.core re-exports under its name
j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")


def _spd(rng, d, scale=0.3):
    a = rng.standard_normal((d, d)).astype(np.float32) * scale / np.sqrt(d)
    return (np.eye(d, dtype=np.float32) + a @ a.T).astype(np.float32)


def test_config_fields_match():
    jf = {f.name: f.default for f in dataclasses.fields(j_mkor.MKORConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(t_mkor.MKORConfig)}
    jf["use_kernels"] = jf.pop("use_pallas")
    jf.pop("interpret")                   # Pallas-only, no port counterpart
    assert jf == tf


@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_smw_rank1_update_matches(variant, dtype):
    rng = np.random.default_rng(0)
    j = _spd(rng, 40)
    v = rng.standard_normal(40).astype(np.float32)
    jj = jnp.asarray(j).astype(dtype)
    want = j_mkor.smw_rank1_update(jj, jnp.asarray(v), 0.9, variant)
    got = t_mkor.smw_rank1_update(
        interop.tree_from_numpy(np.asarray(jj), CPU), torch.tensor(v), 0.9,
        variant)
    # bf16 output: one bf16 ulp of the largest entry where rounding flips
    tol = 1e-5 if dtype == np.float32 else 2 ** -7
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.float().numpy(), rtol=tol, atol=tol)
    # batched leading dims give the same per-slice result
    got_b = t_mkor.smw_rank1_update(
        interop.tree_from_numpy(np.asarray(jj), CPU)[None].expand(3, -1, -1),
        torch.tensor(v)[None].expand(3, -1), 0.9, variant)
    np.testing.assert_allclose(got_b[1].float().numpy(),
                               got.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("norm", [10.0, 50.0, 120.0])
def test_stabilize_matches(norm):
    rng = np.random.default_rng(1)
    j = _spd(rng, 16)
    j = j * (norm / np.abs(j).max())
    want = j_mkor.stabilize(jnp.asarray(j), 50.0, 0.95)
    got = t_mkor.stabilize(torch.tensor(j), 50.0, 0.95)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-6,
                               atol=1e-6)
    # per-slice over a leading bank dim
    stacked = t_mkor.stabilize(torch.tensor(np.stack([j, j / 10])), 50.0,
                               0.95)
    np.testing.assert_array_equal(stacked[0].numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(12, 20), (3, 12, 20)])
def test_precondition_and_rescale_match(shape):
    rng = np.random.default_rng(2)
    l, r = _spd(rng, 20), _spd(rng, 12)
    g = rng.standard_normal(shape).astype(np.float32)
    jd = j_mkor.precondition(jnp.asarray(l), jnp.asarray(r), jnp.asarray(g))
    td = t_mkor.precondition(torch.tensor(l), torch.tensor(r),
                             torch.tensor(g))
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(j_mkor.rescale_update(jd, jnp.asarray(g))),
        t_mkor.rescale_update(td, torch.tensor(g)).numpy(), rtol=1e-5,
        atol=1e-6)
    zero = t_mkor.rescale_update(torch.zeros(shape), torch.zeros(shape))
    assert torch.all(zero == 0)


def _port_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["pattern"] = tuple(t_config.LayerSpec(**dataclasses.asdict(s))
                          for s in cfg.pattern)
    return t_config.ModelConfig(**kw)


def _max_err(jtree, ttree):
    errs = jax.tree.map(
        lambda a, b: float(np.max(np.abs(np.asarray(a, np.float32) - b),
                                  initial=0.0)),
        jtree, interop.tree_to_numpy(ttree))
    return max(jax.tree.leaves(errs))


@pytest.mark.parametrize("factor_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
@pytest.mark.parametrize("stagger", [True, False])
def test_mkor_six_steps_match(stagger, variant, factor_dtype,
                              tiny_model_cfg):
    cfg = tiny_model_cfg
    kw = dict(inv_freq=2, stagger=stagger, variant=variant,
              factor_dtype=factor_dtype)
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    jp = j_model.init_params(jax.random.key(0), cfg)
    tp = interop.params_from_numpy(jax.tree.map(np.array, jp), CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_step = jax.jit(j_loop.make_train_step(cfg, j_opt))
    t_step = t_loop.make_train_step(_port_cfg(cfg), t_opt)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    j_losses, t_losses = [], []
    for i in range(6):
        batch = j_pipe.make_batch(ds, i)
        jp, js, jm = j_step(jp, js, batch)
        tp, ts, tm = t_step(tp, ts, t_loop.batch_to_device(batch, CPU))
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    # float32 model and optimizer: float32 rounding in another order
    np.testing.assert_allclose(j_losses, t_losses, rtol=1e-5)
    assert _max_err(jp, tp) < 2e-4
    assert ts["count"] == int(js["count"]) == 6
    assert sorted(ts["factor_banks"]) == sorted(js["factor_banks"])
    bank_err = _max_err(js["factor_banks"], ts["factor_banks"])
    if factor_dtype == "float32":
        assert bank_err < 1e-4
    else:
        # bf16 banks: a rounding flip moves an entry by one bf16 ulp
        # (2^-8 relative near 1, entries stay below 2)
        assert bank_err <= 2 ** -6
    assert _max_err(js["backend"]["m"], ts["backend"]["m"]) < 1e-4


def test_mkor_autoencoder_banks_match(ae_params):
    """Bank update on the ae_params MLP with numpy-drawn gradients and
    statistics fed to both optimizers (no model in the loop)."""
    kw = dict(inv_freq=2, exclude=(), factor_dtype="float32")
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    host = jax.tree.map(np.array, ae_params)
    tp = interop.params_from_numpy(host, CPU)
    jp = jax.tree.map(jnp.asarray, host)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_update = jax.jit(lambda g, s, p, st: j_opt.update(g, s, params=p,
                                                        stats=st))
    rng = np.random.default_rng(3)
    for _ in range(4):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), host)
        stats = {"layers": [{"a": rng.standard_normal(
            p["w"].shape[0]).astype(np.float32)} for p in host["layers"]]}
        ju, js = j_update(grads, js, jp, stats)
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp,
                              stats=interop.tree_from_numpy(stats, CPU))
        assert _max_err(ju, tu) < 1e-5
        jp, tp = j_fo.apply_updates(jp, ju), t_fo.apply_updates(tp, tu)
    assert _max_err(js["factor_banks"], ts["factor_banks"]) < 1e-4


# the ids are the ones pytest gave these cases when each was one (field,
# value) pair; the health sentinel is ported, and its cases went with the
# check they tested (tests/test_torch_health.py holds its config checks).
# The per-layer layout and the data-parallel fields are ported: each case
# now checks that its config builds and steps (tests/test_torch_per_layer.py
# and tests/test_torch_dist.py hold them to the reference).  ``dist`` of
# world 2 steps in two spawned gloo ranks (tests/torch_dist_worker.py);
# ``live`` without ``dist`` is never consulted, as in the reference.
@pytest.mark.parametrize("overrides", [
    pytest.param({"dist": (("data", 2),)}, id="dist-value0"),
    pytest.param({"live": (True, False)}, id="live-value1"),
    pytest.param({"layout": "per_layer"}, id="layout-per_layer")])
def test_unported_configs_raise(overrides, tmp_path):
    if "dist" in overrides:
        ranks = run_ranks(tmp_path, 2, [{"name": "fc", "kind": "fc",
                                         "mkor": overrides}])
        for r in ranks:
            upd, state = r["fc"]["update"], r["fc"]["state"]
            assert sorted(state["factor_banks"]) == ["8x6"]
            assert int(state["count"]) == 1
            assert not np.array_equal(state["factor_banks"]["8x6"]["l_inv"],
                                      np.eye(6)[None])   # a phase step
            assert np.isfinite(upd["fc"]["w"]).all()
            assert not upd["fc"]["probe"].any()
            for a, b in zip(jax.tree.leaves(r["fc"]),
                            jax.tree.leaves(ranks[0]["fc"])):
                assert np.array_equal(a, b)      # replicas hold the same bits
        return
    cfg = t_mkor.MKORConfig(**overrides)
    opt = t_mkor.mkor(t_fo.lamb(1e-3), cfg)
    params = {"fc": {"w": torch.ones((8, 6)), "probe": torch.zeros(6)}}
    state = opt.init(params)
    grads = {"fc": {"w": torch.full((8, 6), 0.5), "probe": torch.ones(6)}}
    stats = {"fc": {"a": torch.ones(8)}}
    upd, state = opt.update(grads, state, params=params, stats=stats)
    assert int(state["count"]) == 1
    factors = t_mkor.factor_slices(state, params, cfg)
    assert sorted(factors) == ["fc"]
    assert not torch.equal(factors["fc"]["l_inv"].float(),
                           torch.eye(6))          # count 0: a phase step
    assert torch.isfinite(upd["fc"]["w"]).all() and \
        torch.equal(upd["fc"]["probe"], torch.zeros(6))
