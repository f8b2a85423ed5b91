"""The training forward of the recurrent and hybrid configs at
``.reduced()`` -- rwkv6-3b (RWKV-6 time and channel mixing) and
jamba-v0.1-52b (Mamba, attention and MoE in one period) -- against
``repro/models/model.py``: logits, the stats tree, ``moe_aux``, the loss
and every gradient, at tests/test_torch_zoo_check.py's tolerances."""
import pytest
import torch

from repro.configs import registry as j_registry

import test_torch_zoo_check as zoo

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_reduced_forward_and_grads_match(name):
    jc = j_registry.get_config(name).reduced()
    stats = zoo.forward_matches(jc)
    blocks = stats["blocks"]
    assert len(blocks) == len(jc.pattern)
    for spec, st in zip(jc.pattern, blocks):
        mixer = {"attn": "q", "rwkv": "r", "mamba": "x_proj"}[spec.kind]
        assert st["mixer"][mixer]["a"].shape[0] == jc.n_repeats
        if spec.mlp == "moe":
            assert set(st["mlp"]) >= {"router", "in", "gate", "out"}
            # shared factors: one E[a] over all dispatched rows
            assert st["mlp"]["in"]["a"].shape == (jc.n_repeats, jc.d_model)
        if spec.mlp == "rwkv_cm":
            assert set(st["mlp"]) == {"key", "value", "recept"}
