"""The port's block rank-r MKOR against ``repro/core/mkor.py``: the block
weights, the block Woodbury update of one factor and of a batch (against
the JAX function, the dense oracle of ``repro/kernels/ref.py`` and, for
``exact_smw``, a float64 numpy inverse of the composed target), and whole
training runs of 8 steps at rank 2 and 4 — same weights (interop), same
batches, stagger on and off, both variants.  float32 factor banks are held
to float32 tolerance, bf16 banks to bf16 tolerance."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import firstorder as j_fo
from repro.data import pipeline as j_pipe
from repro.kernels import ref as j_ref
from repro.models import model as j_model
from repro.training import loop as j_loop
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.kernels import ref as t_ref
from repro_torch.models import config as t_config
from repro_torch.training import loop as t_loop

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")


def _spd(rng, d, scale=0.3):
    a = rng.standard_normal((d, d)).astype(np.float32) * scale / np.sqrt(d)
    return (np.eye(d, dtype=np.float32) + a @ a.T).astype(np.float32)


@pytest.mark.parametrize("rank", [1, 2, 4])
def test_block_weights_match(rank):
    for n in range(rank + 2):
        jsq, jgm = j_mkor.block_weights(jnp.asarray(n), rank, 0.9)
        tsq, tgm = t_mkor.block_weights(n, rank, 0.9)
        # the same fp32 powers of 0.9, from two pow implementations
        np.testing.assert_allclose(np.asarray(jsq), tsq.numpy(), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(float(jgm), float(tgm), rtol=1e-6)
    # a tensor of counts gives each its own weights
    counts = torch.arange(rank + 2)
    tsq, tgm = t_mkor.block_weights(counts, rank, 0.9)
    assert tsq.shape == (rank + 2, rank) and tgm.shape == (rank + 2,)
    for n in range(rank + 2):
        one_sq, one_gm = t_mkor.block_weights(n, rank, 0.9)
        assert torch.equal(tsq[n], one_sq) and torch.equal(tgm[n], one_gm)


def _composed_inverse64(j, v, gamma, n):
    """float64 target of exact_smw: inv(γ^m J⁻¹⁻¹ + Σ w_i v_i v_iᵀ)."""
    r = v.shape[0]
    m = min(n, r)
    target = gamma ** m * np.linalg.inv(j.astype(np.float64))
    for i in range(m):
        w = (1 - gamma) * gamma ** (m - 1 - i)
        target += w * np.outer(v[i], v[i]).astype(np.float64)
    return np.linalg.inv(target)


@pytest.mark.parametrize("rank", [1, 2, 4])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_smw_block_update_matches(rank, variant):
    """Well-conditioned inputs: J near I, v ~ N(0, 1) at d = 24."""
    rng = np.random.default_rng(rank)
    d = 24
    j = _spd(rng, d)
    v = rng.standard_normal((rank, d)).astype(np.float32)
    for n in sorted({0, 1, rank}):
        want = j_mkor.smw_block_update(jnp.asarray(j), jnp.asarray(v), 0.9,
                                       variant, n_valid=jnp.asarray(n))
        got = t_mkor.smw_block_update(torch.tensor(j), torch.tensor(v), 0.9,
                                      variant, n_valid=n)
        # fp32 math with a solve on both sides, in another order
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-4,
                                   atol=1e-5)
        oracle = j_ref.smw_block_update_ref(jnp.asarray(j), jnp.asarray(v),
                                            0.9, variant, n_valid=n)
        np.testing.assert_allclose(np.asarray(oracle), got.numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            t_ref.smw_block_update_ref(torch.tensor(j), torch.tensor(v), 0.9,
                                       variant, n_valid=n).numpy(),
            got.numpy(), rtol=1e-4, atol=1e-5)
        if variant == "exact_smw":
            # fp32 against float64: relative error ~1e-7 times the target's
            # condition number (below 10 here)
            np.testing.assert_allclose(_composed_inverse64(j, v, 0.9, n),
                                       got.numpy(), rtol=1e-4, atol=1e-5)
        if n == 0:
            assert torch.equal(got, torch.tensor(j))
    # batched over lead dims with per-slice counts
    jb = np.stack([j, _spd(rng, d)])
    vb = np.stack([v, rng.standard_normal((rank, d)).astype(np.float32)])
    nb = np.array([rank, 1])
    got_b = t_mkor.smw_block_update(torch.tensor(jb), torch.tensor(vb), 0.9,
                                    variant, n_valid=torch.tensor(nb))
    for i in range(2):
        want = j_mkor.smw_block_update(jnp.asarray(jb[i]), jnp.asarray(vb[i]),
                                       0.9, variant,
                                       n_valid=jnp.asarray(nb[i]))
        np.testing.assert_allclose(np.asarray(want), got_b[i].numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_rank1_block_reduces_to_smw_rank1(variant):
    rng = np.random.default_rng(9)
    j = _spd(rng, 20)
    v = rng.standard_normal((1, 20)).astype(np.float32)
    got = t_mkor.smw_block_update(torch.tensor(j), torch.tensor(v), 0.9,
                                  variant)
    want = t_mkor.smw_rank1_update(torch.tensor(j), torch.tensor(v[0]), 0.9,
                                   variant)
    # the same update, with a 1x1 solve in place of a scalar division
    np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_block_pivot_matches_jax():
    rng = np.random.default_rng(10)
    j = _spd(rng, 16)
    v = rng.standard_normal((3, 16)).astype(np.float32)
    for variant in ("paper", "exact_smw"):
        _, jp = j_mkor.smw_block_update(jnp.asarray(j), jnp.asarray(v), 0.9,
                                        variant, n_valid=jnp.asarray(2),
                                        with_pivot=True)
        _, tp = t_mkor.smw_block_update(torch.tensor(j), torch.tensor(v),
                                        0.9, variant, n_valid=2,
                                        with_pivot=True)
        np.testing.assert_allclose(float(jp), float(tp), rtol=1e-5)


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


def run_both(cfg, kw, steps):
    """The same MKORConfig, weights and batches through the JAX package and
    the port; returns the losses and final (params, state) of each."""
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    jp = j_model.init_params(jax.random.key(0), cfg)
    tp = interop.params_from_numpy(jax.tree.map(np.array, jp), CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_step = jax.jit(j_loop.make_train_step(cfg, j_opt))
    t_step = t_loop.make_train_step(_port_cfg(cfg), t_opt)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    j_losses, t_losses = [], []
    for i in range(steps):
        batch = j_pipe.make_batch(ds, i)
        jp, js, jm = j_step(jp, js, batch)
        tp, ts, tm = t_step(tp, ts, t_loop.batch_to_device(batch, CPU))
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    return (j_losses, jp, js), (t_losses, tp, ts)


def check_runs(j_run, t_run, factor_dtype, steps):
    (j_losses, jp, js), (t_losses, tp, ts) = j_run, t_run
    # float32 model and optimizer: float32 rounding in another order
    np.testing.assert_allclose(j_losses, t_losses, rtol=1e-5)
    assert _max_err(jp, tp) < 2e-4
    assert ts["count"] == int(js["count"]) == steps
    # the state tree: the reference's keys, and the same buckets and
    # leaves below each
    assert set(ts) == set(js)
    for key in ("factor_banks", "stat_windows", "pending_banks"):
        if key in js:
            assert jax.tree.structure(jax.tree.map(np.asarray, js[key])) == \
                jax.tree.structure(interop.tree_to_numpy(ts[key]))
    for key in ("factor_banks", "pending_banks"):
        if key not in js:
            continue
        err = _max_err(js[key], ts[key])
        if factor_dtype == "float32":
            assert err < 1e-4, (key, err)
        else:
            # bf16 banks: a rounding flip moves an entry by one bf16 ulp
            # (2^-8 relative near 1, entries stay below 2)
            assert err <= 2 ** -6, (key, err)
    win_err = max(_max_err(w, ts["stat_windows"][b]) for b, w in
                  js["stat_windows"].items())
    # fp32 windows of fp32 stat vectors from the two forwards
    assert win_err < 1e-4
    for b, w in js["stat_windows"].items():
        np.testing.assert_array_equal(np.asarray(w["n"]),
                                      ts["stat_windows"][b]["n"].numpy())
    # LAMB's first moment sums 8 steps of preconditioned gradients: the
    # forwards' fp32 rounding, amplified by factors of norm up to the
    # stabilizer threshold (the rank-1 path shows 2.2e-4 over the same 8
    # steps at inv_freq 4); 5e-4 of the largest entry
    m_max = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree.leaves(js["backend"]["m"]))
    assert _max_err(js["backend"]["m"], ts["backend"]["m"]) < 5e-4 * m_max


@pytest.mark.parametrize("rank", [2, 4])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
@pytest.mark.parametrize("stagger", [True, False])
def test_mkor_rank_r_eight_steps_match(rank, variant, stagger,
                                       tiny_model_cfg):
    """inv_freq=4: each bucket consumes a partial window, then a full one
    (at rank 2 the ring has wrapped by then, so its rows are rotated)."""
    factor_dtype = "float32" if rank == 4 else "bfloat16"
    kw = dict(inv_freq=4, rank=rank, stagger=stagger, variant=variant,
              factor_dtype=factor_dtype)
    j_run, t_run = run_both(tiny_model_cfg, kw, steps=8)
    check_runs(j_run, t_run, factor_dtype, steps=8)
