"""The routed configs at ``.reduced()`` against ``repro/models/model.py``:
qwen2-moe-a2.7b (routed and shared experts) and mixtral-8x22b (sliding
windows, 8 experts at one layer: its layers are stacked once, so every
bucket has extra dims): logits, the stats tree, ``moe_aux``, the loss and
every gradient; and 3 MKOR + LAMB steps on qwen2-moe with shared factors,
which puts fused_precond's extra-dims route on a CPU path.  Tolerances:
tests/test_torch_zoo_check.py."""

import pytest
import torch

from repro.configs import qwen2_moe_a2_7b as j_qwen
from repro.configs import registry as j_registry
from repro_torch.kernels import ops as t_ops

import test_torch_zoo_check as zoo

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "qwen2-moe-a2.7b"])
def test_reduced_forward_and_grads_match(name):
    jc = j_registry.get_config(name).reduced()
    stats = zoo.forward_matches(jc)
    moe = stats["blocks"][0]["mlp"]
    assert set(moe) >= {"router", "in", "gate", "out"}
    assert ("shared" in moe) == (jc.moe.n_shared_experts > 0)
    # shared factors: one E[a] over all dispatched rows, per layer
    assert moe["in"]["a"].shape == (jc.n_repeats, jc.d_model)


def test_qwen2_moe_mkor_steps_match_shared_factors():
    """3 MKOR (inv_freq 2, float32 banks) + LAMB steps on qwen2-moe
    ``.reduced()`` (tests/test_torch_zoo_check.py).  The port runs with
    ``use_kernels``: on the CPU each wrapper runs its plain version, and
    the expert buckets (``extra == (4,)``) take fused_precond's
    extra-dims route, counted once a step for each of them, two port
    steps a step (from JAX's state, and free-running)."""
    jc = j_qwen.CONFIG.reduced()
    assert not jc.moe.per_expert_factors
    t_ops.reset_fallback_counts()
    _, ts = zoo.mkor_steps_match(jc)
    experts = [b for b in ts["factor_banks"] if "_e" in b]
    assert experts == ["128x256_s2_e4", "256x128_s2_e4"], experts
    assert t_ops.fallback_counts() == {
        ("fused_precond", "extra_dims"): 2 * 3 * len(experts)}
    t_ops.reset_fallback_counts()
