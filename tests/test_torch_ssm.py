"""The port's attention-free mixers (``repro_torch/models/ssm.py``: RWKV-6
time and channel mixing, Mamba with its causal conv) and the RWKV group
norm against ``repro/models/ssm.py`` and ``repro/models/layers.py`` on
numpy-seeded float32 inputs: outputs, the recurrences' final states, the
E[a] statistics and the gradients of every parameter and of the input.

Tolerances: outputs, states and statistics rtol 1e-5 / atol 1e-6 (the
same float32 values summed in another order), gradients rtol 1e-4 with
an atol of 1e-5 of each leaf's largest entry (tests/test_torch_zoo_check.py,
the port's model tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import config as j_config
from repro.models import layers as j_layers
from repro.models import ssm as j_ssm
from repro_torch import interop
from repro_torch.models import layers as t_layers
from repro_torch.models import ssm as t_ssm

import test_torch_zoo_check as zoo

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _cfg(mod):
    return mod.ModelConfig(
        name="ssm-test", arch_type="ssm", n_layers=1, d_model=32,
        n_heads=4, n_kv_heads=4, d_ff=48, vocab_size=64,
        pattern=(mod.LayerSpec(kind="mamba", mlp="rwkv_cm"),),
        rwkv_head_dim=8, mamba=mod.MambaConfig(d_state=4, d_conv=4,
                                               expand=2),
        norm="layernorm", act="relu2", gated_mlp=False, dtype="float32",
        scan_layers=False, remat=False, vocab_pad_multiple=1)


def _close(want, got, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-6, err_msg=what)


def _perturb(p, rng):
    """Non-zero probes, and decays spread over (0, 1): every path of the
    recurrence carries weight."""
    def leaf(path, v):
        key = path[-1].key
        if key == "probe":
            return rng.standard_normal(v.shape).astype(np.float32) * 0.1
        if key == "decay_w0":
            return rng.uniform(-3.0, 1.0, v.shape).astype(np.float32)
        if key in ("maa_w1", "maa_w2", "decay_w1", "decay_w2", "bonus",
                   "maa_x", "maa", "maa_k", "maa_r", "conv_b"):
            return rng.standard_normal(v.shape).astype(np.float32) * 0.3
        return np.asarray(v)
    return jax.tree_util.tree_map_with_path(leaf, p)


# mixer name -> (init, apply returning (y, state or x_last))
MIXERS = {
    "rwkv_time_mix": ("rwkv_init", "rwkv_time_mix"),
    "rwkv_channel_mix": ("rwkv_cm_init", "rwkv_channel_mix"),
    "mamba_apply": ("mamba_init", "mamba_apply"),
}


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_matches(mixer):
    init, apply = MIXERS[mixer]
    jc, tc = _cfg(j_config), zoo.port_cfg(_cfg(j_config))
    rng = np.random.default_rng(len(mixer))
    p = _perturb(getattr(j_ssm, init)(jax.random.key(5), jc,
                                      dtype=jnp.float32), rng)
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    ct = rng.standard_normal((2, 10, 32)).astype(np.float32)
    takes_cfg = mixer != "rwkv_channel_mix"

    def j_run(p, x):
        st = {}
        args = (p, x, jc) if takes_cfg else (p, x)
        y, state = getattr(j_ssm, apply)(*args, stats=st)
        return jnp.sum(y * ct), (y, state, st)
    (_, (jy, jstate, jst)), jg = jax.jit(jax.value_and_grad(
        j_run, argnums=(0, 1), has_aux=True))(p, x)

    tp = jax.tree.map(lambda t: t.requires_grad_(True),
                      interop.params_from_numpy(p, CPU))
    tx = torch.tensor(x, requires_grad=True)
    st = {}
    args = (tp, tx, tc) if takes_cfg else (tp, tx)
    ty, tstate = getattr(t_ssm, apply)(*args, stats=st)
    torch.sum(ty * torch.tensor(ct)).backward()

    _close(jy, ty.detach(), "y")
    if mixer == "rwkv_time_mix":
        _close(jstate["wkv"], tstate["wkv"].detach(), "wkv state")
        _close(jstate["x_last"], tstate["x_last"].detach(), "x_last")
    elif mixer == "mamba_apply":
        _close(jstate["h"], tstate["h"].detach(), "h state")
    else:
        _close(jstate, tstate.detach(), "x_last")
    js, ts = zoo.flat(jst), zoo.flat(interop.tree_to_numpy(st))
    assert sorted(js) == sorted(ts) and js
    for k in js:
        _close(js[k], ts[k], k)
    zoo.assert_grads_close(jg, (jax.tree.map(lambda t: t.grad, tp),
                                tx.grad))


def test_causal_conv_matches():
    """The depthwise causal conv alone: output and gradients."""
    jc, tc = _cfg(j_config), zoo.port_cfg(_cfg(j_config))
    rng = np.random.default_rng(11)
    p = {"conv_w": rng.standard_normal((4, 64)).astype(np.float32),
         "conv_b": rng.standard_normal(64).astype(np.float32)}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    ct = rng.standard_normal((2, 7, 64)).astype(np.float32)

    def j_run(p, x):
        y, _ = j_ssm._causal_conv(p, x, jc)
        return jnp.sum(y * ct), y
    (_, jy), jg = jax.value_and_grad(j_run, argnums=(0, 1),
                                     has_aux=True)(p, x)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = t_ssm._causal_conv(tp, tx, tc)
    torch.sum(ty * torch.tensor(ct)).backward()
    _close(jy, ty.detach(), "y")
    zoo.assert_grads_close(jg, ({k: v.grad for k, v in tp.items()},
                                tx.grad))
    # causal: the first output depends on the first input only
    grad0 = torch.autograd.grad(t_ssm._causal_conv(tp, tx, tc)[:, 0].sum(),
                                tx)[0]
    assert torch.all(grad0[:, 1:] == 0) and torch.any(grad0[:, 0] != 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches(dtype):
    """Per-head group norm in float32, cast back to the input's dtype:
    float32 to rtol 1e-5 / atol 1e-6, bf16 to one bf16 ulp (2^-7
    relative) where the two round the same float32 value."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 4, 8)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_layers.group_norm(jx, scale, bias), np.float32)
    got = t_layers.group_norm(interop.tree_from_numpy(np.asarray(jx), CPU),
                              torch.tensor(scale), torch.tensor(bias))
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    if dtype == "float32":
        _close(want, got, "group_norm")
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2 ** -7, atol=1e-6)
