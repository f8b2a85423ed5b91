"""The port's own copies of the JAX-free modules — model configs, the
registry and the synthetic data pipeline — against the JAX package's."""
import dataclasses

import numpy as np
import pytest

from repro.configs import bert_large as j_bert
from repro.data import pipeline as j_pipe
from repro.models import config as j_config
from repro_torch.configs import bert_large as t_bert
from repro_torch.configs import registry as t_registry
from repro_torch.data import pipeline as t_pipe
from repro_torch.models import config as t_config


def _as_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _config_tuple(cfg):
    """A config as nested plain tuples (the two packages' dataclasses are
    distinct types, so compare their field values)."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            return tuple((f.name, conv(getattr(v, f.name)))
                         for f in dataclasses.fields(v))
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return conv(cfg)


def test_model_config_fields_and_defaults_match():
    for name in ("ModelConfig", "LayerSpec", "MoEConfig", "MambaConfig",
                 "EncoderConfig", "InputShape"):
        jf = [(f.name, repr(f.default)) for f in
              dataclasses.fields(getattr(j_config, name))]
        tf = [(f.name, repr(f.default)) for f in
              dataclasses.fields(getattr(t_config, name))]
        assert jf == tf, name


@pytest.mark.parametrize("overrides", [{}, {"n_layers": 3, "d_model": 64}])
def test_bert_large_config_and_reduced_match(overrides):
    assert _config_tuple(t_bert.CONFIG) == _config_tuple(j_bert.CONFIG)
    assert _config_tuple(t_bert.CONFIG.reduced(**overrides)) == \
        _config_tuple(j_bert.CONFIG.reduced(**overrides))
    assert t_bert.CONFIG.padded_vocab == j_bert.CONFIG.padded_vocab == 30720
    assert t_registry.get_config("bert-large") is t_bert.CONFIG
    # every assigned config resolves since the model zoo was ported; a
    # name that no registry has raises
    with pytest.raises(KeyError):
        t_registry.get_config("no-such-arch")
    assert t_registry.get_config("gemma2-9b").name == "gemma2-9b"


@pytest.mark.parametrize("seq_len,batch,seed", [(16, 2, 0), (33, 3, 7),
                                                (128, 8, 0)])
def test_synthetic_batches_identical(seq_len, batch, seed):
    """Batch for batch (exact integers) for the same seed and step."""
    j_ds = j_pipe.make_dataset(j_bert.CONFIG, global_batch=batch,
                               seq_len=seq_len, seed=seed)
    t_ds = t_pipe.make_dataset(t_bert.CONFIG, global_batch=batch,
                               seq_len=seq_len, seed=seed)
    assert _as_dict(j_ds) == _as_dict(t_ds)
    for step in (0, 1, 5):
        jb, tb = j_pipe.make_batch(j_ds, step), t_pipe.make_batch(t_ds, step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    j_it = list(j_pipe.synthetic_batches(j_ds, 2, start_step=3))
    t_it = list(t_pipe.synthetic_batches(t_ds, 2, start_step=3))
    for jb, tb in zip(j_it, t_it):
        np.testing.assert_array_equal(jb["tokens"], tb["tokens"])


def test_sharded_batches_identical():
    kw = dict(vocab_size=97, seq_len=20, global_batch=4, seed=3, n_shards=2)
    for shard in (0, 1):
        jb = j_pipe.make_batch(j_pipe.SyntheticLMConfig(shard_id=shard, **kw),
                               2)
        tb = t_pipe.make_batch(t_pipe.SyntheticLMConfig(shard_id=shard, **kw),
                               2)
        np.testing.assert_array_equal(jb["labels"], tb["labels"])
