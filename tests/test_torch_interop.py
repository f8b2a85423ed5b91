"""interop: the JAX package's trees (as numpy) carried into the port —
bit-exact, structure-preserving, and never sharing memory with JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_large as j_bert
from repro.core import firstorder as j_fo
from repro.core.mkor import MKORConfig as JMKORConfig, mkor as j_mkor
from repro.models import model as j_model
from repro_torch import interop

torch.set_num_threads(2)


def _host(tree):
    """JAX tree → numpy, copied (np.array), so nothing downstream can hold a
    view of a JAX buffer."""
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _assert_round_trip(jtree):
    host = _host(jtree)
    ttree = interop.tree_from_numpy(host, "cpu")
    assert jax.tree.structure(host) == jax.tree.structure(
        jax.tree.map(lambda t: 0, ttree))
    back = interop.tree_to_numpy(ttree)
    for a, b, t in zip(jax.tree.leaves(host), jax.tree.leaves(back),
                       jax.tree.leaves(ttree, is_leaf=torch.is_tensor)):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).split(".")[-1] == a.dtype.name
        # exact, bit for bit (bf16 through a uint16 view)
        np.testing.assert_array_equal(np.asarray(a, np.float32)
                                      if a.dtype.name == "bfloat16" else a, b)


def test_round_trip_ae_params(ae_params):
    _assert_round_trip(ae_params)


def test_round_trip_reduced_bert_large_bf16_stacked():
    cfg = j_bert.CONFIG.reduced(n_layers=3, d_model=32, head_dim=8, d_ff=64,
                                vocab_size=50, dtype="bfloat16",
                                scan_layers=True)
    params = j_model.init_params(jax.random.key(0), cfg)
    assert params["blocks"][0]["mixer"]["q"]["w"].shape == (3, 32, 32)
    assert params["blocks"][0]["mixer"]["q"]["w"].dtype == jnp.bfloat16
    _assert_round_trip(params)
    tp = interop.params_from_numpy(_host(params), "cpu")
    assert tp["blocks"][0]["mixer"]["q"]["w"].dtype == torch.bfloat16
    assert tp["blocks"][0]["mixer"]["q"]["probe"].shape == (3, 32)


def test_round_trip_lamb_and_factor_bank_state():
    cfg = j_bert.CONFIG.reduced(n_layers=2, d_model=16, d_ff=32,
                                vocab_size=40)
    params = j_model.init_params(jax.random.key(1), cfg)
    state = j_mkor(j_fo.lamb(1e-3), JMKORConfig()).init(params)
    _assert_round_trip(state["backend"]["m"])
    banks = interop.banks_from_numpy(_host(state["factor_banks"]), "cpu")
    assert sorted(banks) == sorted(state["factor_banks"])
    for bid, bank in banks.items():
        assert bank["l_inv"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            bank["r_inv"].float().numpy(),
            np.asarray(state["factor_banks"][bid]["r_inv"], np.float32))


def test_conversion_copies_and_never_aliases_jax_buffers(ae_params):
    """An in-place update in the port must not reach the JAX arrays (the
    session fixture above all): interop copies every leaf, even when it is
    handed zero-copy np.asarray views."""
    before = _host(ae_params)
    views = jax.tree.map(np.asarray, ae_params)          # zero-copy views
    tp = interop.params_from_numpy(views, "cpu")
    for t in jax.tree.leaves(tp, is_leaf=torch.is_tensor):
        t.add_(1.0)
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(ae_params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_entry_point_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-GPU error path cannot run here")
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.params_from_numpy({"w": np.zeros(2, np.float32)})
