"""The port's int8 factor storage against the JAX package: the quantization
primitives of ``repro/core/stats.py`` bit for bit (codes, scales, error
feedback, quantized windows), their invariants, and the plain versions of
the three int8 kernels (``scale=`` operands) against the JAX package's
int8 kernels in interpret mode, as tests/test_quant.py runs them.  The
CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py)."""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as j_stats
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import stats as t_stats
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import precond as t_pc
from repro_torch.kernels import rank1_smw as t_rk
from repro_torch.kernels import ref as t_ref

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)


def _bank(rng, b, d, scale=0.3):
    """Near-identity symmetric factors, like MKOR's inverses."""
    a = rng.standard_normal((b, d, d)).astype(np.float32) * scale / np.sqrt(d)
    return (np.eye(d, dtype=np.float32) + a @ a.transpose(0, 2, 1))


def _encode_both(x):
    """(JAX codes, JAX scales, port codes, port scales) of the same bank."""
    jq, js = j_stats.quant_encode(jnp.asarray(x))
    tq, ts = t_stats.quant_encode(torch.tensor(x))
    return jq, js, tq, ts


# --------------------------------------------------------------------- #
# Primitives, bit for bit
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,axes", [((3, 2, 24, 24), 2), ((5, 7, 33), 1),
                                        ((4, 17, 9), 2)])
def test_quant_encode_decode_bit_equal(shape, axes):
    rng = np.random.default_rng(len(shape) + axes)
    # slices of magnitudes from 1e-3 to 1e2
    mag = 10.0 ** rng.uniform(-3, 2, shape[:1] + (1,) * (len(shape) - 1))
    x = (rng.standard_normal(shape) * mag).astype(np.float32)
    x[0] = 0.0                               # an all-zero slice
    # ties: values exactly half a code step away from a code
    x[-1, ..., 0] = np.float32(0.5)
    x[-1, ..., -1] = np.float32(127.0)
    jq, js = j_stats.quant_encode(jnp.asarray(x), axes)
    tq, ts = t_stats.quant_encode(torch.tensor(x), axes)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == shape[:-axes]
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(
        np.asarray(j_stats.quant_decode(jq, js, axes)),
        t_stats.quant_decode(tq, ts, axes).numpy())


@pytest.mark.parametrize("ef_scale", [0.0, 1e-3, 1.0])
def test_quant_requantize_bit_equal(ef_scale):
    rng = np.random.default_rng(1)
    x = _bank(rng, 3, 24) * np.float32(7.0)
    ef = (rng.standard_normal(x.shape) * ef_scale).astype(np.float32)
    want = j_stats.quant_requantize(jnp.asarray(x), jnp.asarray(ef))
    got = t_stats.quant_requantize(torch.tensor(x), torch.tensor(ef))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_zero_slice_encodes_to_exact_zeros():
    q, sc = t_stats.quant_encode(torch.zeros((2, 8, 8)))
    assert torch.equal(q, torch.zeros((2, 8, 8), dtype=torch.int8))
    assert bool(torch.all(torch.isfinite(sc)))
    assert torch.equal(t_stats.quant_decode(q, sc), torch.zeros((2, 8, 8)))
    q1, sc1 = t_stats.quant_encode(torch.zeros((3, 5)), axes=1)
    assert torch.equal(t_stats.window_decode(q1, sc1),
                       torch.zeros((3, 5)))


def test_requantize_error_feedback_invariant():
    """decode(q', s') + ef' == x + ef exactly, and |ef'| <= s'/2."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((2, 12, 12)).astype(np.float32))
    ef = torch.tensor((rng.standard_normal((2, 12, 12)) * 1e-3)
                      .astype(np.float32))
    q, sc, ef2 = t_stats.quant_requantize(x, ef)
    assert torch.equal(t_stats.quant_decode(q, sc) + ef2, x + ef)
    assert float(torch.max(ef2.abs() - sc[:, None, None] / 2)) <= 1e-7


def test_window_push_quant_and_decode_bit_equal():
    """Pushes at several counts (the ring wraps): codes and per-row scales
    bit-equal to the reference, rows already in the ring unchanged."""
    rng = np.random.default_rng(3)
    lead, r, d = (3, 2), 4, 10
    jw = jnp.zeros(lead + (r, d), jnp.int8)
    jsc = jnp.zeros(lead + (r,), jnp.float32)
    tw = torch.zeros(lead + (r, d), dtype=torch.int8)
    tsc = torch.zeros(lead + (r,))
    for step in range(6):
        cnt = rng.integers(0, 7, lead[:1])[:, None].astype(np.int32)
        vec = (rng.standard_normal(lead + (d,)) * 3).astype(np.float32)
        jw, jsc = j_stats.window_push_quant(jw, jsc, jnp.asarray(cnt),
                                            jnp.asarray(vec))
        prev = tw.clone()
        tw, tsc = t_stats.window_push_quant(tw, tsc, torch.tensor(cnt),
                                            torch.tensor(vec))
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        np.testing.assert_array_equal(np.asarray(jsc), tsc.numpy())
        pos = cnt % r
        for i in range(lead[0]):
            others = [k for k in range(r) if k != pos[i, 0]]
            assert torch.equal(tw[i][:, others], prev[i][:, others])
    np.testing.assert_array_equal(np.asarray(j_stats.window_decode(jw, jsc)),
                                  t_stats.window_decode(tw, tsc).numpy())


def test_factor_storage_dtype():
    assert t_stats.factor_storage_dtype("bfloat16", "int8") == torch.int8
    assert t_stats.factor_storage_dtype("float32", "bf16") == torch.bfloat16
    assert t_stats.factor_storage_dtype("float32", "none") == torch.float32
    assert t_stats.FACTOR_QUANT_MODES == j_stats.FACTOR_QUANT_MODES
    assert t_stats.INT8_QMAX == j_stats.INT8_QMAX
    assert t_stats.QUANT_SCALE_EPS == j_stats.QUANT_SCALE_EPS


# --------------------------------------------------------------------- #
# The int8 kernels' plain versions against the reference's int8 kernels
# (interpret mode).  Both decode the same codes in fp32 and compute in
# fp32 in another order: rtol 1e-5, atol 1e-6.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_fused_smw_int8_plain_matches_jax_kernel(variant):
    rng = np.random.default_rng(4)
    bank = _bank(rng, 3, 24)
    v = rng.standard_normal((3, 24)).astype(np.float32)
    jq, js, tq, ts = _encode_both(bank)
    want = j_ops.smw_rank1_update_banked(jq, jnp.asarray(v), gamma=0.9,
                                         variant=variant, interpret=True,
                                         scale=js)
    tv = torch.tensor(v)
    got = t_rk.fused_smw_plain(tq, tv, gamma=0.9, variant=variant, scale=ts)
    got_ops = t_ops.smw_rank1_update_banked(tq, tv, gamma=0.9,
                                            variant=variant, scale=ts)
    assert got.dtype == got_ops.dtype == torch.float32
    for g in (got, got_ops):
        np.testing.assert_allclose(np.asarray(want), g.numpy(), rtol=1e-5,
                                   atol=1e-6)
    want_ref = j_ref.smw_rank1_update_quant_ref(jq[0], js[0],
                                                jnp.asarray(v[0]), 0.9,
                                                variant)
    got_ref = t_ref.smw_rank1_update_quant_ref(tq[0], ts[0], tv[0], 0.9,
                                               variant)
    np.testing.assert_allclose(np.asarray(want_ref), got_ref.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_fused_block_smw_int8_plain_matches_jax_kernel(variant):
    """Windows filled to 0, 2 and 4 rows, with the pivot.  The pivot is the
    smallest squared Cholesky diagonal over the slices' real rows, which
    ``repro.core.mkor.smw_block_update(with_pivot=True)`` gives per slice
    (the reference's fused entry also counts its zero padding rows, whose
    pivots are gm² or gm: tests/test_torch_block_smw.py)."""
    rng = np.random.default_rng(5)
    bank = _bank(rng, 3, 24)
    win = rng.standard_normal((3, 4, 24)).astype(np.float32)
    nv = np.array([0, 2, 4], np.int32)
    jq, js, tq, ts = _encode_both(bank)
    want = j_ops.smw_block_update_banked(
        jq, jnp.asarray(win), jnp.asarray(nv), gamma=0.9, variant=variant,
        interpret=True, scale=js)
    got, piv = t_ops.smw_block_update_banked(
        tq, torch.tensor(win), torch.tensor(nv), gamma=0.9, variant=variant,
        with_pivot=True, scale=ts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5,
                               atol=1e-6)
    jd = j_stats.quant_decode(jq, js)
    pivs = [float(j_mkor.smw_block_update(
        jd[i], jnp.asarray(win[i]), 0.9, variant, n_valid=int(nv[i]),
        with_pivot=True)[1]) for i in range(3)]
    np.testing.assert_allclose(float(piv), min(pivs), rtol=1e-5)
    # an empty window returns the decoded bank itself
    assert torch.equal(got[0], t_stats.quant_decode(tq, ts)[0])
    want_ref = j_ref.smw_block_update_quant_ref(
        jq[2], js[2], jnp.asarray(win[2]), 0.9, variant, n_valid=4)
    got_ref = t_ref.smw_block_update_quant_ref(tq[2], ts[2],
                                               torch.tensor(win[2]), 0.9,
                                               variant, n_valid=4)
    np.testing.assert_allclose(np.asarray(want_ref), got_ref.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rescale", [True, False])
@pytest.mark.parametrize("di,do", [(24, 16), (16, 24)])
def test_fused_precond_int8_plain_matches_jax_kernel(rescale, di, do):
    rng = np.random.default_rng(6)
    l_bank, r_bank = _bank(rng, 3, do), _bank(rng, 3, di)
    g = rng.standard_normal((3, di, do)).astype(np.float32)
    lq, lsc, tlq, tlsc = _encode_both(l_bank)
    rq, rsc, trq, trsc = _encode_both(r_bank)
    want = j_ops.fused_precondition_banked(lq, rq, jnp.asarray(g),
                                           rescale=rescale, interpret=True,
                                           l_scale=lsc, r_scale=rsc)
    tg = torch.tensor(g)
    got = t_ops.fused_precondition_banked(tlq, trq, tg, rescale=rescale,
                                          l_scale=tlsc, r_scale=trsc)
    got_pc = t_pc.fused_precond(trq, tg, tlq, rescale=rescale,
                                r_scale=trsc, l_scale=tlsc)
    for x in (got, got_pc):
        np.testing.assert_allclose(np.asarray(want), x.numpy(), rtol=1e-5,
                                   atol=1e-6)
    want_ref = j_ref.fused_precondition_quant_ref(lq[1], lsc[1], rq[1],
                                                  rsc[1], jnp.asarray(g[1]),
                                                  rescale=rescale)
    got_ref = t_ref.fused_precondition_quant_ref(tlq[1], tlsc[1], trq[1],
                                                 trsc[1], tg[1],
                                                 rescale=rescale)
    np.testing.assert_allclose(np.asarray(want_ref), got_ref.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_precond_int8_extra_dims_fallback_decodes_and_counts():
    """A gradient with an extra broadcast dim takes the unfused path: the
    int8 factors are decoded first, and the fallback is counted."""
    rng = np.random.default_rng(7)
    l_bank, r_bank = _bank(rng, 2, 12), _bank(rng, 2, 8)
    g = rng.standard_normal((2, 3, 8, 12)).astype(np.float32)
    _, _, lq, lsc = _encode_both(l_bank)
    _, _, rq, rsc = _encode_both(r_bank)
    t_ops.reset_fallback_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", t_ops.KernelFallbackWarning)
        got = t_ops.fused_precondition_banked(lq, rq, torch.tensor(g),
                                              l_scale=lsc, r_scale=rsc)
    assert t_ops.fallback_counts() == {("fused_precond", "extra_dims"): 1}
    t_ops.reset_fallback_counts()
    lf = t_stats.quant_decode(lq, lsc)
    rf = t_stats.quant_decode(rq, rsc)
    for i in range(2):
        want = t_ref.fused_precondition_ref(lf[i], rf[i], torch.tensor(g[i]))
        np.testing.assert_allclose(want.numpy(), got[i].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_matmul_int8_operand_plain_decodes():
    rng = np.random.default_rng(8)
    _, _, q, sc = _encode_both(_bank(rng, 2, 16))
    x = torch.tensor(rng.standard_normal((2, 16, 5)).astype(np.float32))
    want = t_stats.quant_decode(q, sc) @ x
    assert torch.allclose(t_mm.matmul(q, x, a_scale=sc), want, rtol=1e-6,
                          atol=1e-7)
    xt = x.transpose(1, 2).contiguous()
    assert torch.allclose(t_mm.matmul(xt, q, b_scale=sc),
                          xt @ t_stats.quant_decode(q, sc), rtol=1e-6,
                          atol=1e-7)


def test_int8_wrappers_refuse_a_missing_or_stray_scale():
    rng = np.random.default_rng(9)
    _, _, q, sc = _encode_both(_bank(rng, 2, 8))
    v = torch.zeros((2, 8))
    with pytest.raises(TypeError, match="scale"):
        t_rk.fused_smw(q, v, gamma=0.9)
    with pytest.raises(TypeError, match="scale"):
        t_rk.fused_smw(q.float(), v, gamma=0.9, scale=sc)
    with pytest.raises(TypeError, match="scale"):
        t_rk.fused_block_smw(q, torch.zeros((2, 1, 8)), torch.ones(2))
    with pytest.raises(ValueError, match="both"):
        t_pc.fused_precond(q, torch.zeros((2, 8, 8)), q, r_scale=sc)
    with pytest.raises(TypeError, match="scale"):
        t_mm.matmul(q, torch.zeros((2, 8, 3)))
