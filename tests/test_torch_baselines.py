"""The port's second-order baselines against the JAX package: KFAC's
``damped_inverse``, Eva's ``_rank1_damped_apply`` and SNGD's
``sngd_precondition`` at the tolerances of ``tests/test_baselines.py``;
``baseline_net.grads_and_full_stats`` (loss, grads, A and G) at fp32
tolerance; 4 steps each of ``kfac`` (an inversion and a stale step),
``eva`` and ``sngd`` over momentum SGD on the ``ae_params`` autoencoder,
and ``eva`` over LAMB on the tiny model (its layers unstacked and
stacked), params and states at ``rtol=1e-4``; and the Eva and KFAC states
carried across with ``interop`` and through checkpoints both ways, bit
for bit."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as j_ckpt
from repro.core import baseline_net as j_net
from repro.core import firstorder as j_fo
from repro.data import pipeline as j_pipe
from repro.models import model as j_model
from repro.training import loop as j_loop
from repro_torch import interop
from repro_torch.checkpointing import checkpoint as t_ckpt
from repro_torch.core import baseline_net as t_net
from repro_torch.core import firstorder as t_fo
from repro_torch.training import loop as t_loop

from test_torch_mkor_block import _port_cfg

# the modules, not the functions that the packages' core/__init__ export
# under their names
j_eva = importlib.import_module("repro.core.eva")
j_kfac = importlib.import_module("repro.core.kfac")
j_sngd = importlib.import_module("repro.core.sngd")
t_eva = importlib.import_module("repro_torch.core.eva")
t_kfac = importlib.import_module("repro_torch.core.kfac")
t_sngd = importlib.import_module("repro_torch.core.sngd")
torch.set_num_threads(2)
CPU = torch.device("cpu")
# SNGD's (G − UZ)/μ cancels: fp32 keeps about 1e-6 times the cancellation
# factor ‖G‖/‖G − UZ‖ of it, in JAX as in the port.  On this net that
# factor is up to ~1.4e4 at the default μ = 1e-2 (both packages then sit
# ~1 % from float64) and under 30 at μ = 10, where parity at rtol 1e-4
# means something; test_sngd_default_damping_float64_yardstick holds the
# port at the default μ against float64
SNGD_DAMPING = 10.0


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _np(t):
    return t.detach().cpu().numpy()


def test_damped_inverse_matches():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12)).astype(np.float32)
    cov = (a @ a.T / 12).astype(np.float32)
    want = np.asarray(j_kfac.damped_inverse(jnp.asarray(cov), 1e-2, 1e-8))
    got = t_kfac.damped_inverse(torch.tensor(cov), 1e-2, 1e-8)
    np.testing.assert_allclose(_np(got), want, rtol=1e-3, atol=1e-4)
    dense = np.linalg.inv(cov.astype(np.float64) + 1e-2 * np.eye(12))
    np.testing.assert_allclose(_np(got), dense, rtol=1e-3, atol=1e-4)


def test_rank1_damped_apply_matches():
    rng = np.random.default_rng(1)
    d, mu = 8, 0.1
    v = rng.standard_normal(d).astype(np.float32)
    dense = np.linalg.inv(np.outer(v, v).astype(np.float64) + mu * np.eye(d))
    for side, shape in (("l", (d, 5)), ("r", (5, d))):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(j_eva._rank1_damped_apply(
            jnp.asarray(v), jnp.asarray(x), mu, side))
        got = _np(t_eva._rank1_damped_apply(torch.tensor(v), torch.tensor(x),
                                            mu, side))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, dense @ x if side == "l"
                                   else x @ dense, rtol=1e-4, atol=1e-4)
    # leading dims batch: a stack of vectors and gradients
    vs = rng.standard_normal((3, d)).astype(np.float32)
    xs = rng.standard_normal((3, d, 5)).astype(np.float32)
    got = t_eva._rank1_damped_apply(torch.tensor(vs), torch.tensor(xs), mu,
                                    "l")
    for i in range(3):
        np.testing.assert_allclose(_np(got[i]), _np(t_eva._rank1_damped_apply(
            torch.tensor(vs[i]), torch.tensor(xs[i]), mu, "l")),
            rtol=1e-6, atol=1e-6)


def test_sngd_precondition_matches():
    """Against JAX's and the dense (F + NμI)⁻¹ of tests/test_baselines.py
    (``F = U Uᵀ``, u_i = vec(a_i g̃_iᵀ)), in float64."""
    rng = np.random.default_rng(2)
    din, dout, n, mu = 5, 4, 6, 0.3
    a = rng.standard_normal((n, din)).astype(np.float32)
    g_raw = rng.standard_normal((n, dout)).astype(np.float32)
    g = g_raw / n
    gw = rng.standard_normal((din, dout)).astype(np.float32)
    want = np.asarray(j_sngd.sngd_precondition(
        jnp.asarray(a), jnp.asarray(g), jnp.asarray(gw), mu))
    got = _np(t_sngd.sngd_precondition(torch.tensor(a), torch.tensor(g),
                                       torch.tensor(gw), mu))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    u = np.stack([np.outer(a[i], g_raw[i]).reshape(-1) for i in range(n)],
                 1).astype(np.float64)
    dense = (np.linalg.solve(u @ u.T + n * mu * np.eye(din * dout),
                             gw.reshape(-1).astype(np.float64))
             .reshape(din, dout) * n)
    np.testing.assert_allclose(got, dense, rtol=1e-3, atol=1e-4)


def test_sngd_default_damping_float64_yardstick(ae_params):
    """At the default μ = 1e-2, each layer's first preconditioned
    gradient: the port's fp32 result is no farther from the float64
    evaluation of the same formula than twice the JAX package's fp32
    result is (relative Frobenius error)."""
    host = _host(ae_params)
    batch = _ae_batch(0)
    _, grads, stats = j_net.grads_and_full_stats(
        jax.tree.map(jnp.asarray, host), jax.tree.map(jnp.asarray, batch))
    mu = t_sngd.SNGDConfig().damping
    for i, layer in enumerate(stats["layers"]):
        a, g, gw = (np.asarray(x) for x in (layer["A"], layer["G"],
                                            grads["layers"][i]["w"]))
        a64, n = a.astype(np.float64), a.shape[0]
        g64, w64 = g.astype(np.float64) * n, gw.astype(np.float64)
        ug = np.einsum("ni,ij,nj->n", a64, w64, g64)
        z = np.linalg.solve((a64 @ a64.T) * (g64 @ g64.T)
                            + n * mu * np.eye(n), ug)
        want = (w64 - np.einsum("n,ni,nj->ij", z, a64, g64)) / mu
        jx = np.asarray(j_sngd.sngd_precondition(
            jnp.asarray(a), jnp.asarray(g), jnp.asarray(gw), mu))
        tx = _np(t_sngd.sngd_precondition(torch.tensor(a), torch.tensor(g),
                                          torch.tensor(gw), mu))

        def rel(x):
            return np.linalg.norm(x - want) / np.linalg.norm(want)
        assert rel(tx) <= 2 * rel(jx) + 1e-6, (i, rel(tx), rel(jx))


def _ae_batch(step, d_in=96, n=64, kind="mse"):
    """Low-rank inputs (tests/test_baselines.py's batches); class labels
    for the cross-entropy loss."""
    rng = np.random.default_rng(step)
    basis = np.random.default_rng(0).standard_normal((8, d_in)) / 3
    x = (rng.standard_normal((n, 8)) @ basis).astype(np.float32)
    y = x if kind == "mse" else rng.integers(0, d_in, n).astype(np.int32)
    return {"x": x, "y": y}


@pytest.mark.parametrize("kind", ["mse", "ce"])
def test_grads_and_full_stats_match(ae_params, kind):
    host = _host(ae_params)
    batch = _ae_batch(0, kind=kind)
    jl, jg, js = j_net.grads_and_full_stats(
        jax.tree.map(jnp.asarray, host), jax.tree.map(jnp.asarray, batch),
        kind=kind)
    tl, tg, ts = t_net.grads_and_full_stats(
        interop.params_from_numpy(host, CPU),
        {"x": torch.tensor(batch["x"]), "y": torch.tensor(batch["y"])},
        kind=kind)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for want, got in ((jg, tg), (js, ts)):
        got = interop.tree_to_numpy(got)
        assert jax.tree.structure(got) == jax.tree.structure(_host(want))
        for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert np.asarray(w).dtype == t.dtype
            np.testing.assert_allclose(t, np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def _opts(name):
    """(JAX optimizer, port optimizer) over momentum SGD."""
    if name == "kfac":
        kw = dict(inv_freq=2, exclude=())
        return (j_kfac.kfac(j_fo.sgd(1e-2, momentum=0.9),
                            j_kfac.KFACConfig(**kw)),
                t_kfac.kfac(t_fo.sgd(1e-2, momentum=0.9),
                            t_kfac.KFACConfig(**kw)))
    if name == "eva":
        return (j_eva.eva(j_fo.sgd(1e-2, momentum=0.9),
                          j_eva.EvaConfig(exclude=())),
                t_eva.eva(t_fo.sgd(1e-2, momentum=0.9),
                          t_eva.EvaConfig(exclude=())))
    kw = dict(damping=SNGD_DAMPING, exclude=())
    return (j_sngd.sngd(j_fo.sgd(1e-2, momentum=0.9),
                        j_sngd.SNGDConfig(**kw)),
            t_sngd.sngd(t_fo.sgd(1e-2, momentum=0.9),
                        t_sngd.SNGDConfig(**kw)))


def _assert_close(want, got, rtol=1e-4, floor=1e-5):
    """Every leaf at ``rtol``, entries near 0 at ``floor`` of the leaf's
    largest entry (fp32 rounding in another order)."""
    got = interop.opt_state_to_numpy(got)
    assert jax.tree.structure(got) == jax.tree.structure(_host(want))
    for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        assert w.dtype == t.dtype and w.shape == t.shape
        np.testing.assert_allclose(
            t, w, rtol=rtol, atol=floor * float(np.max(np.abs(w),
                                                       initial=0.0)))


def _run_both(ae_params, name, steps=4):
    j_opt, t_opt = _opts(name)
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_update = jax.jit(lambda g, s, p, st: j_opt.update(g, s, params=p,
                                                        stats=st))
    for i in range(steps):
        batch = _ae_batch(i)
        _, jg, jst = j_net.grads_and_full_stats(
            jp, jax.tree.map(jnp.asarray, batch))
        _, tg, tst = t_net.grads_and_full_stats(
            tp, {k: torch.tensor(v) for k, v in batch.items()})
        ju, js = j_update(jg, js, jp, jst)
        tu, ts = t_opt.update(tg, ts, params=tp, stats=tst)
        jp, tp = j_fo.apply_updates(jp, ju), t_fo.apply_updates(tp, tu)
    return jp, js, tp, ts


@pytest.mark.parametrize("name", ["kfac", "eva", "sngd"])
def test_baseline_steps_match(ae_params, name):
    """4 steps on the autoencoder, each package on its own gradients and
    full stats of the same batches.  Params and states at ``rtol=1e-4``
    (entries near 0 at 1e-5 of the leaf's largest).  KFAC inverts at
    counts 0 and 2 (``inv_freq=2``) and carries its inverses at 1 and 3;
    its damped covariances are 0.9·I + 0.1·(new) or more, so fp32 ``eigh``
    stays inside that tolerance (no float64 yardstick is needed).  SNGD
    runs at ``SNGD_DAMPING`` (see its note)."""
    jp, js, tp, ts = _run_both(ae_params, name)
    assert int(ts["count"]) == int(js["count"]) == 4
    _assert_close(jp, tp)
    _assert_close(js, ts)
    if name == "eva":
        assert all(bool(v["seen"]) for v in ts["vecs"].values())
    if name == "kfac":
        # count 3 is a stale step: it carried count 2's inverses bit for
        # bit, and those invert count 2's damped covariances (fp32 eigh
        # of covariances 0.9·I + 0.1·(new): within 1e-4 of I)
        _, _, _, ts3 = _run_both(ae_params, name, steps=3)
        assert sorted(ts["factors"]) == [f"layers/{i}" for i in range(4)]
        for key, fac in ts["factors"].items():
            for side in ("l", "r"):
                old = ts3["factors"][key]
                assert torch.equal(fac[f"{side}_inv"], old[f"{side}_inv"])
                cov = old[f"{side}_cov"].double()
                eye = torch.eye(cov.shape[0], dtype=torch.float64)
                err = old[f"{side}_inv"].double() @ (cov + 1e-3 * eye) - eye
                assert float(err.abs().max()) < 1e-4, (key, side)


@pytest.mark.parametrize("scan", [False, True], ids=["unstacked", "stacked"])
def test_eva_lamb_on_model_matches(tiny_model_cfg, scan):
    """Eva over LAMB through the train step, 3 steps on the tiny model:
    the losses at fp32 rounding, params and states at ``rtol=1e-4``."""
    cfg = dataclasses.replace(tiny_model_cfg, scan_layers=scan)
    j_opt = j_eva.eva(j_fo.lamb(1e-2), j_eva.EvaConfig())
    t_opt = t_eva.eva(t_fo.lamb(1e-2), t_eva.EvaConfig())
    jp = j_model.init_params(jax.random.key(0), cfg)
    tp = interop.params_from_numpy(jax.tree.map(np.array, jp), CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    assert not any(bool(v["seen"]) for v in ts["vecs"].values())
    j_step = jax.jit(j_loop.make_train_step(cfg, j_opt))
    t_step = t_loop.make_train_step(_port_cfg(cfg), t_opt)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    for i in range(3):
        batch = j_pipe.make_batch(ds, i)
        jp, js, jm = j_step(jp, js, batch)
        tp, ts, tm = t_step(tp, ts, t_loop.batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert all(bool(v["seen"]) for v in ts["vecs"].values())
    _assert_close(jp, tp)
    _assert_close(js, ts)
    # the chunk runner takes Eva's plan: the backend's (no branch of its
    # own), with LAMB's per-step scalars
    assert t_opt.plan(ts)[0] == () and sorted(t_opt.plan(ts)[1]) == [
        "bc1", "bc2", "lr"]


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8).reshape(-1)


@pytest.mark.parametrize("name", ["kfac", "eva"])
def test_baseline_states_carry_bit_for_bit(tmp_path, ae_params, name):
    """A JAX Eva or KFAC state after 2 steps: ``interop`` carries it into
    the port and back bit for bit (Eva's ``seen`` a bool, the counts 0-d
    int32 on the CPU); a JAX checkpoint of it restores in the port, and
    the port's checkpoint restores in JAX, every leaf equal."""
    jp, js, tp, _ = _run_both(ae_params, name, steps=2)
    hs = _host(js)
    ts = interop.opt_state_from_numpy(hs, CPU)
    assert ts["count"].device.type == "cpu" and \
        ts["count"].dtype == torch.int32
    if name == "eva":
        assert all(v["seen"].dtype == torch.bool and bool(v["seen"])
                   for v in ts["vecs"].values())
    back = interop.opt_state_to_numpy(ts)
    assert jax.tree.structure(back) == jax.tree.structure(hs)
    for a, b in zip(jax.tree.leaves(hs), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    j_ckpt.save(str(tmp_path / "jax"), 2, (jp, js), {"step": 2})
    like = (tp, _opts(name)[1].init(tp))
    tree, _, step = t_ckpt.restore_latest_valid(str(tmp_path / "jax"), like)
    assert step == 2
    for g, w in zip(jax.tree.leaves(interop.opt_state_to_numpy(tree[1])),
                    jax.tree.leaves(hs)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    t_ckpt.save(str(tmp_path / "port"), 2, (tp, ts), {"step": 2})
    jtree, _ = j_ckpt.restore(str(tmp_path / "port"), 2, (jp, js))
    for g, w in zip(jax.tree.leaves(jtree[1]), jax.tree.leaves(hs)):
        np.testing.assert_array_equal(_bits(np.asarray(g)), _bits(w))
