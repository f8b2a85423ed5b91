"""The port's layer discovery and bucket manifest against
``repro/core/stats.py``: bucket ids, slot order and phases."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import bert_large as j_bert
from repro.core import stats as j_stats
from repro.core.mkor import MKORConfig as JCfg, manifest_for as j_manifest
from repro.models import model as j_model
from repro_torch import interop
from repro_torch.core import stats as t_stats
from repro_torch.core.mkor import MKORConfig as TCfg, manifest_for as t_manifest

torch.set_num_threads(2)


def _trees(ae_params):
    bert = j_model.init_params(jax.random.key(0), j_bert.CONFIG.reduced(
        n_layers=3, d_model=32, head_dim=8, d_ff=64, vocab_size=40,
        scan_layers=True))
    return {"ae": ae_params, "bert_reduced": bert}


def _manifest_tuple(m):
    return [(b.bucket_id, b.stack, b.extra, b.d_in, b.d_out, b.paths,
             b.index) for b in m]


@pytest.mark.parametrize("which", ["ae", "bert_reduced"])
@pytest.mark.parametrize("exclude", [("embed", "lm_head"), ()])
def test_manifest_matches(which, exclude, ae_params):
    jtree = _trees(ae_params)[which]
    ttree = interop.params_from_numpy(jax.tree.map(np.array, jtree), "cpu")
    jm = j_manifest(jtree, JCfg(exclude=exclude))
    tm = t_manifest(ttree, TCfg(exclude=exclude))
    assert _manifest_tuple(jm) == _manifest_tuple(tm) and len(tm) > 0
    assert t_stats.iter_dense_layers(ttree) == \
        j_stats.iter_dense_layers(jtree)
    for inv_freq in (1, 2, 3, 10):
        for stagger in (True, False):
            assert t_stats.bucket_phases(tm, inv_freq, stagger) == \
                j_stats.bucket_phases(jm, inv_freq, stagger)
            assert t_stats.layer_phases(tm, inv_freq, stagger) == \
                j_stats.layer_phases(jm, inv_freq, stagger)
    for b in tm:
        assert t_stats.bucket_slices(b) == b.n_slots * int(
            np.prod(b.stack or (1,)))


def test_bert_large_full_width_buckets():
    """The three buckets full-width bert-large gives the kernels (shapes
    only: built from a tree of empty tensors, no model is initialised)."""
    def dense(d_in, d_out):
        return {"w": torch.empty((24, d_in, d_out), device="meta"),
                "probe": torch.empty((24, d_out), device="meta")}
    tree = {"blocks": [{"mixer": {k: dense(1024, 1024) for k in "qkvo"},
                        "mlp": {"in": dense(1024, 4096),
                                "out": dense(4096, 1024)}}],
            "lm_head": dense(1024, 30720)}
    m = t_manifest(tree, TCfg())
    assert [(b.bucket_id, b.n_slots) for b in m] == [
        ("1024x1024_s24", 4), ("1024x4096_s24", 1), ("4096x1024_s24", 1)]
    assert [t_stats.bucket_slices(b) for b in m] == [96, 24, 24]
    assert t_stats.bucket_phases(m, 3) == {
        "1024x1024_s24": 0, "1024x4096_s24": 1, "4096x1024_s24": 2}


def test_vectors_and_zero_probes(ae_params):
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        ae_params)
    tg = interop.tree_from_numpy(grads, "cpu")
    for path in j_stats.iter_dense_layers(grads):
        np.testing.assert_array_equal(
            np.asarray(j_stats.get_g_vec(grads, path)),
            t_stats.get_g_vec(tg, path).numpy())
        assert j_stats.layer_dims(j_stats.tree_get(grads, path)) == \
            t_stats.layer_dims(t_stats.tree_get(tg, path))
    zj = j_stats.zero_probes(grads)
    zt = interop.tree_to_numpy(t_stats.zero_probes(tg))
    for a, b in zip(jax.tree.leaves(zj), jax.tree.leaves(zt)):
        np.testing.assert_array_equal(np.asarray(a), b)
