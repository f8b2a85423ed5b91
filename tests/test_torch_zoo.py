"""The model zoo in the port: its registry and config copies against the
JAX package's, the VLM's text-only loss, the training forward of the
dense attention configs at ``.reduced()`` against
``repro/models/model.py`` (logits, the stats tree, ``moe_aux``, the loss
and every gradient, tests/test_torch_zoo_check.py's tolerances), and 3 MKOR
steps on whisper-base.  The zoo's other configs are in
tests/test_torch_zoo_attn.py, tests/test_torch_zoo_ssm.py and
tests/test_torch_zoo_moe.py, its other training runs in
tests/test_torch_zoo_train.py and tests/test_torch_zoo_launch.py (the
files are split to stay under a minute each)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro_torch.configs import registry as t_registry
from repro_torch.models import model as t_model

import test_torch_zoo_check as zoo

torch.set_num_threads(2)

NAMES = sorted(j_registry.ARCHS)


def _config_tuple(cfg):
    """A config as nested plain tuples (the two packages' dataclasses are
    distinct types, so compare their field values)."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            return (type(v).__name__,) + tuple(
                (f.name, conv(getattr(v, f.name)))
                for f in dataclasses.fields(v))
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return conv(cfg)


@pytest.mark.parametrize("name", NAMES)
def test_config_and_reduced_match(name):
    """Every field, full and ``.reduced()`` (with and without overrides),
    and the derived properties the model and the optimizer read."""
    j, t = j_registry.get_config(name), t_registry.get_config(name)
    for jc, tc in [(j, t), (j.reduced(), t.reduced()),
                   (j.reduced(n_layers=2 * len(j.pattern)),
                    t.reduced(n_layers=2 * len(t.pattern)))]:
        assert _config_tuple(tc) == _config_tuple(jc)
        for prop in ("padded_vocab", "n_repeats", "q_per_kv",
                     "is_encoder_decoder", "is_attention_free",
                     "max_window"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        assert zoo.port_cfg(jc) == tc
    assert t_registry.list_configs() == j_registry.list_configs()


def test_registry_lists_and_long_context_match():
    assert t_registry.ASSIGNED == j_registry.ASSIGNED
    assert sorted(t_registry.ARCHS) == sorted(j_registry.ARCHS)
    assert t_registry.long_context_archs() == j_registry.long_context_archs()
    for name in NAMES:
        j = j_registry.get_config(name)
        try:
            want = _config_tuple(j_registry.long_context_variant(j))
        except ValueError as exc:
            with pytest.raises(ValueError, match="pure full-attention"):
                t_registry.long_context_variant(t_registry.get_config(name))
            assert "pure full-attention" in str(exc)
            continue
        got = t_registry.long_context_variant(t_registry.get_config(name))
        assert _config_tuple(got) == want, name
    with pytest.raises(KeyError):
        t_registry.get_config("no-such-arch")
    # the minicpm module keeps its WSD schedule name
    from repro.configs import minicpm_2b as j_minicpm
    from repro_torch.configs import minicpm_2b as t_minicpm
    assert t_minicpm.SCHEDULE == j_minicpm.SCHEDULE == "wsd"


def test_unknown_block_kinds_raise_the_reference_error():
    cfg = t_registry.get_config("bert-large").reduced()
    for spec in (dataclasses.replace(cfg.pattern[0], kind="conv"),
                 dataclasses.replace(cfg.pattern[0], mlp="glu")):
        with pytest.raises(ValueError):
            t_model.init_params(dataclasses.replace(cfg, pattern=(spec,)),
                                device="cpu")


@pytest.mark.parametrize("name", ["bert-large", "minicpm-2b",
                                  "stablelm-12b"])
def test_reduced_forward_and_grads_match(name):
    """The dense attention configs; the others are in
    tests/test_torch_zoo_attn.py, tests/test_torch_zoo_ssm.py and
    tests/test_torch_zoo_moe.py."""
    zoo.forward_matches(j_registry.get_config(name).reduced())


@pytest.mark.parametrize("name", ["whisper-base"])
def test_mkor_steps_match(name):
    """3 MKOR + LAMB steps on whisper-base (encoder frames with each
    batch; the encoder's statistics), tests/test_torch_zoo_check.py."""
    zoo.zoo_mkor_steps(name)


def test_vlm_loss_covers_text_positions_only():
    """pixtral's logits span patch prefix + text, its labels the text."""
    from repro_torch.training import loop as t_loop
    tc = t_registry.get_config("pixtral-12b").reduced()
    assert t_loop.text_prefix_len(tc) == tc.frontend_len == 8
    assert t_loop.text_prefix_len(
        t_registry.get_config("whisper-base")) == 0
    batch = zoo.make_batch(tc, zoo.dataset(tc, seq_len=6), 0)
    assert batch["tokens"].shape == (2, 6)
    params = t_model.init_params(tc, device="cpu")
    tb = t_loop.batch_to_device(batch, torch.device("cpu"))
    logits, _ = t_model.forward(params, tc, tb)
    assert logits.shape[1] == 8 + 6
    loss, _ = t_loop.make_loss_fn(tc)(params, tb)
    want = t_loop.lm_loss(logits[:, 8:], tb["labels"])
    assert torch.equal(loss, want)
    assert np.isfinite(float(loss))
