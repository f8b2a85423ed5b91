"""The port's MoE layer (``repro_torch/models/moe.py``) and its grouped
dense layers against ``repro/models/moe.py`` on numpy-seeded inputs, and
MKOR + LAMB training steps on qwen2-moe-a2.7b ``.reduced()`` against the
JAX package's jitted step with per-expert factors (shared factors:
tests/test_torch_zoo_moe.py).

Tolerances (float32 throughout): outputs, aux losses and statistics to
rtol 1e-5 / atol 1e-6 (the same float32 values summed in another order);
gradients to rtol 1e-4 with an atol of 1e-5 of each leaf's largest
entry, the port's model tolerance (tests/test_torch_model.py); the MKOR
runs to tests/test_torch_zoo_check.py's (tests/test_torch_mkor.py's, with
LAMB's noise-signed elements stated there).  Routes (``top_i``) are
compared first and exactly, so a flipped route is reported as one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_moe_a2_7b as j_qwen
from repro.models import config as j_config
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro_torch import interop
from repro_torch.configs import qwen2_moe_a2_7b as t_qwen
from repro_torch.kernels import ops as t_ops
from repro_torch.models import config as t_config
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe

import test_torch_zoo_check as zoo

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _cfg(mod, n_experts=4, top_k=2, capacity_factor=8.0, n_shared=0,
         per_expert=False, z=0.0):
    """tests/test_moe.py's ``_cfg`` in either package's config types."""
    return mod.ModelConfig(
        name="moe-test", arch_type="moe", n_layers=1, d_model=16,
        n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=64,
        pattern=(mod.LayerSpec(kind="attn", mlp="moe"),),
        moe=mod.MoEConfig(n_experts=n_experts, top_k=top_k, expert_d_ff=32,
                          capacity_factor=capacity_factor,
                          n_shared_experts=n_shared,
                          shared_d_ff=32 if n_shared else 0,
                          per_expert_factors=per_expert,
                          router_z_weight=z),
        dtype="float32", scan_layers=False, remat=False,
        vocab_pad_multiple=1)


def _close(want, got, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("per_expert", [False, True])
def test_grouped_dense_matches(per_expert):
    """Output, E[a] (over all dispatched rows, or per expert) and the
    gradients, with the (d_out,) or (E, 1, d_out) probe."""
    rng = np.random.default_rng(0)
    p = j_layers.grouped_dense_init(jax.random.key(1), 3, 8, 5,
                                    dtype=jnp.float32,
                                    per_expert_probe=per_expert)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["probe"] = rng.standard_normal(p["probe"].shape).astype(np.float32)
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    ct = rng.standard_normal((3, 6, 5)).astype(np.float32)

    def j_loss(p, x):
        st = {}
        y = j_layers.grouped_dense(p, x, stats=st, name="d",
                                   per_expert_stats=per_expert)
        return jnp.sum(y * ct), (y, st)
    (_, (jy, jst)), jg = jax.value_and_grad(j_loss, argnums=(0, 1),
                                            has_aux=True)(p, x)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    st = {}
    ty = t_layers.grouped_dense(tp, tx, stats=st, name="d",
                                per_expert_stats=per_expert)
    torch.sum(ty * torch.tensor(ct)).backward()
    _close(jy, ty.detach(), "y")
    _close(jst["d"]["a"], st["d"]["a"], "a")
    assert st["d"]["a"].shape == ((3, 8) if per_expert else (8,))
    zoo.assert_grads_close(jg, ({k: v.grad for k, v in tp.items()}, tx.grad))
    # the probe's gradient is the mean output gradient, per expert or not
    assert tp["probe"].grad.shape == p["probe"].shape


# (capacity factor, shared experts, per-expert stats, z-loss): room for
# every choice; capacity drops (one slot an expert: later choices go to
# the trash slot); the shared experts; per-expert stats; the z-loss
MOE_CASES = {
    "high_capacity": dict(),
    "capacity_drops": dict(capacity_factor=0.25),
    "shared": dict(n_shared=1, capacity_factor=1.0),
    "per_expert": dict(per_expert=True, capacity_factor=1.0),
    "z_loss": dict(z=1e-3, top_k=3),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches(case):
    kw = MOE_CASES[case]
    jc, tc = _cfg(j_config, **kw), _cfg(t_config, **kw)
    p = jax.tree.map(np.asarray, j_moe.moe_init(jax.random.key(2), jc,
                                                dtype=jnp.float32))
    rng = np.random.default_rng(3)
    # non-zero probes: their gradients are ḡ and flow through every path
    p = jax.tree_util.tree_map_with_path(
        lambda path, v: rng.standard_normal(v.shape).astype(np.float32)
        * 0.1 if path[-1].key == "probe" else v, p)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    ct = rng.standard_normal((2, 12, 16)).astype(np.float32)

    # the routes first: a flipped route is a routing fault, not a rounding
    logits = x @ p["router"]["w"] + p["router"]["probe"]
    _, j_top = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)),
                             jc.moe.top_k)
    _, t_top = torch.topk(torch.softmax(torch.tensor(logits), -1),
                          tc.moe.top_k)
    np.testing.assert_array_equal(np.asarray(j_top), t_top.numpy())
    if case == "capacity_drops":
        c = j_moe.capacity(jc.moe, 12)
        counts = np.stack([np.bincount(np.asarray(j_top)[b].ravel(),
                                       minlength=4) for b in range(2)])
        assert counts.max() > c          # some choices really are dropped

    def j_loss(p, x):
        st = {}
        y, aux = j_moe.moe_apply(p, x, jc, stats=st)
        return jnp.sum(y * ct) + aux, (y, aux, st)
    (_, (jy, jaux, jst)), jg = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(p, x)

    tp = interop.params_from_numpy(p, CPU)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    tx = torch.tensor(x, requires_grad=True)
    st = {}
    ty, taux = t_moe.moe_apply(tp, tx, tc, stats=st)
    (torch.sum(ty * torch.tensor(ct)) + taux).backward()
    _close(jy, ty.detach(), "y")
    _close(jaux, taux.detach(), "aux")
    js, ts = zoo.flat(jst), zoo.flat(interop.tree_to_numpy(st))
    assert sorted(js) == sorted(ts)
    for k in js:
        _close(js[k], ts[k], k)
    zoo.assert_grads_close(jg, (jax.tree.map(lambda t: t.grad, tp), tx.grad))


def test_qwen2_moe_mkor_steps_match_per_expert_factors():
    """3 MKOR (inv_freq 2, float32 banks) + LAMB steps on qwen2-moe
    ``.reduced()`` with ``per_expert_factors`` (tests/test_torch_zoo_check.py):
    the experts' probes are (E, 1, d_out), so their buckets have (2, 4)
    stacks and no extra dims, and nothing falls back.  Shared factors are
    in tests/test_torch_zoo_moe.py."""
    jc = j_qwen.CONFIG.reduced()
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, per_expert_factors=True))
    assert zoo.port_cfg(jc).moe == dataclasses.replace(
        t_qwen.CONFIG.reduced().moe, per_expert_factors=True)
    t_ops.reset_fallback_counts()
    _, ts = zoo.mkor_steps_match(jc)
    assert not [b for b in ts["factor_banks"] if "_e" in b]
    assert any("_s2x4" in b for b in ts["factor_banks"])
    assert t_ops.fallback_counts() == {}
