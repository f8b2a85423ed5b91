"""The port's serving against the JAX package's for the recurrent and
routed block families: MoE (drop-free capacity, shared experts), RWKV-6,
Mamba and a jamba-like hybrid (Mamba beside windowed attention with MoE);
for each the prefill cache leaf by leaf, one decode step from JAX's cache
carried across, ``generate``'s tokens, and the port's decode against its
own full forward (tests/test_torch_serving_check.py).  Also the one-token
mixers alone (``rwkv_time_mix_decode``, ``mamba_decode``,
``rwkv_channel_mix(x_prev=)``), MoE's capacity at one token, and the
decode cache shapes of the ten assigned configs at full width (and of
the long-context variants) on ``meta`` tensors against ``eval_shape``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import config as j_config
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro_torch import interop
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm

import test_torch_serving_check as chk
import test_torch_zoo_check as zoo

torch.set_num_threads(2)
CPU = torch.device("cpu")

FAMILIES = ["moe", "rwkv", "mamba", "hybrid"]


@pytest.fixture(scope="module")
def results():
    """JAX's results, computed once a family (shared by the tests)."""
    done = {}

    def get(family):
        if family not in done:
            done[family] = chk.jax_results(family)
        return done[family]
    return get


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_cache_matches_jax(results, family):
    chk.check_prefill(results(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_step_from_jax_cache(results, family):
    chk.check_decode_step(results(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_matches_jax(results, family):
    chk.check_generate(results(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_matches_full_forward(results, family):
    chk.check_decode_matches_full_forward(results(family))


def _mixer_case(family, init, seed):
    jc = chk.family_config(family)
    p = chk.to_host(getattr(j_ssm, init)(jax.random.key(seed), jc,
                                         dtype=jax.numpy.float32))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    return jc, p, interop.params_from_numpy(p, CPU), x, rng


def test_rwkv_decode_mixers_match():
    """``rwkv_time_mix_decode`` from a random state, and the channel mix
    with a given previous token, against the reference's."""
    jc, p, tp, x, rng = _mixer_case("rwkv", "rwkv_init", 5)
    n = jc.rwkv_head_dim
    cache = {"wkv": rng.standard_normal(
                 (2, jc.d_model // n, n, n)).astype(np.float32),
             "x_last": rng.standard_normal((2, jc.d_model)).astype(
                 np.float32)}
    jy, jst = j_ssm.rwkv_time_mix_decode(p, x, jc, cache)
    ty, tst = t_ssm.rwkv_time_mix_decode(
        tp, torch.from_numpy(x), zoo.port_cfg(jc),
        interop.tree_from_numpy(cache, CPU))
    chk.close(jy, ty.numpy(), "y")
    chk.close(jst["wkv"], tst["wkv"].numpy(), "wkv")
    chk.close(jst["x_last"], tst["x_last"].numpy(), "x_last")

    pc = chk.to_host(j_ssm.rwkv_cm_init(jax.random.key(6), jc,
                                        dtype=jax.numpy.float32))
    prev = cache["x_last"][:, None]
    jy, jlast = j_ssm.rwkv_channel_mix(pc, x, x_prev=prev)
    ty, tlast = t_ssm.rwkv_channel_mix(interop.params_from_numpy(pc, CPU),
                                       torch.from_numpy(x),
                                       x_prev=torch.from_numpy(prev))
    chk.close(jy, ty.numpy(), "channel mix")
    chk.close(jlast, tlast.numpy(), "channel mix x_last")


def test_mamba_decode_matches():
    """``mamba_decode`` from a random scan state and conv buffer."""
    jc, p, tp, x, rng = _mixer_case("mamba", "mamba_init", 7)
    di = jc.mamba.expand * jc.d_model
    cache = {"h": rng.standard_normal((2, di, jc.mamba.d_state)).astype(
                 np.float32),
             "conv": rng.standard_normal(
                 (2, jc.mamba.d_conv - 1, di)).astype(np.float32)}
    jy, jst = j_ssm.mamba_decode(p, x, jc, cache)
    ty, tst = t_ssm.mamba_decode(tp, torch.from_numpy(x), zoo.port_cfg(jc),
                                 interop.tree_from_numpy(cache, CPU))
    chk.close(jy, ty.numpy(), "y")
    chk.close(jst["h"], tst["h"].numpy(), "h")
    chk.close(jst["conv"], tst["conv"].numpy(), "conv")


@pytest.mark.parametrize("name", ["mixtral-8x22b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
def test_moe_capacity_at_one_token(name):
    """Decode routes one token: the capacity the reference gives it, at
    the config's own factor and at the serving tests' drop-free one."""
    m = j_registry.get_config(name).moe
    tm = zoo.port_cfg(m)
    for seq in (1, 2, 64):
        assert t_moe.capacity(tm, seq) == j_moe.capacity(m, seq)
    big = dataclasses.replace(m, capacity_factor=64.0)
    assert t_moe.capacity(zoo.port_cfg(big), 1) == j_moe.capacity(big, 1)


@pytest.mark.parametrize("name", sorted(j_registry.ASSIGNED))
def test_decode_cache_shapes_match(name):
    """``decode_batch_shapes`` at full width, decode_32k (batch 128 x
    32768), on ``meta`` tensors: keys, shapes and dtypes of JAX's."""
    shape = j_config.INPUT_SHAPES["decode_32k"]
    chk.check_cache_shapes(j_registry.get_config(name), shape.global_batch,
                           shape.seq_len)


@pytest.mark.parametrize("name", j_registry.long_context_archs())
def test_long_context_cache_shapes_match(name):
    """The long_500k variants (batch 1 x 524288): JAX's shapes, and every
    windowed layer's ring bounded by its window."""
    shape = j_config.INPUT_SHAPES["long_500k"]
    jc = j_registry.long_context_variant(j_registry.get_config(name))
    cache = chk.check_cache_shapes(jc, shape.global_batch, shape.seq_len)
    for spec, blk in zip(jc.pattern, cache["blocks"]):
        if spec.kind == "attn" and spec.window is not None:
            assert blk["k"].shape[-3] == spec.window
