"""The training forward of the zoo's other attention configs at
``.reduced()`` against ``repro/models/model.py``: gemma2-9b (local and
global layers, softcaps, post-block norms, tied and scaled embeddings),
whisper-base (the encoder over frame embeddings, cross-attention),
pixtral-12b (the patch prefix) and starcoder2-15b (GQA with 4 kv heads,
biases): logits, the stats tree, ``moe_aux``, the loss and every
gradient, at tests/test_torch_zoo_check.py's tolerances."""
import pytest
import torch

from repro.configs import registry as j_registry

import test_torch_zoo_check as zoo

torch.set_num_threads(2)

# whisper's cross-attention key probes have a true gradient of 0 (no RoPE,
# no mask: a shift of every key of a query)
ZERO = {"gemma2-9b": (), "pixtral-12b": (), "starcoder2-15b": (),
        "whisper-base": ("cross/k/probe",)}


@pytest.mark.parametrize("name", sorted(ZERO))
def test_reduced_forward_and_grads_match(name):
    jc = j_registry.get_config(name).reduced()
    stats = zoo.forward_matches(jc, zero=ZERO[name])
    if jc.is_encoder_decoder:
        enc = stats["encoder"]["blocks"][0]["mixer"]["q"]["a"]
        assert enc.shape == (jc.encoder.n_layers, jc.d_model)
        assert "cross" in stats["blocks"][0]
    if jc.frontend != "none":
        assert stats["frontend_proj"]["a"].shape == (
            jc.frontend_dim or jc.d_model,)
