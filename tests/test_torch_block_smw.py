"""The block rank-r SMW kernel's plain version and banked entry, and the
``matvec`` / ``rank1_update`` building blocks (what each wrapper runs on a
CPU tensor), against the JAX package's Pallas kernels in interpret mode
(as tests/test_kernels.py runs them) and against the oracles in
``repro/kernels/ref.py``.  The CUDA kernels themselves run only on a GPU
(tests/test_torch_cuda.py)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import rank1_smw as j_rk
from repro.kernels import ref as j_ref
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import rank1_smw as t_rk
from repro_torch.kernels import ref as t_ref

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)

DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bank(rng, b, d, scale=0.3):
    a = rng.standard_normal((b, d, d)).astype(np.float32) * scale / np.sqrt(d)
    return np.eye(d, dtype=np.float32) + a @ a.transpose(0, 2, 1)


def _as(x, tdt, jdt):
    """The same values as a torch tensor and a jnp array of one dtype
    (rounded to bf16 once, through JAX, so both see identical inputs)."""
    jx = jnp.asarray(np.asarray(x, np.float32)).astype(jdt)
    return torch.tensor(np.asarray(jx, np.float32)).to(tdt), jx


def _close(want, got, rel, floor):
    """Elementwise |got − want| ≤ rel·|want| + floor·max|want|."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    tol = rel * np.abs(want) + floor * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), \
        float(np.max(np.abs(got - want) / tol))


@pytest.mark.parametrize("lead", [(3,), (2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_block_smw_banked_matches_jax_kernel(lead, dtype, variant):
    """Ragged d = 100, r = 3, per-slice n_valid mixing 0, 1, 2 and r; v ~
    N(0, 1), so the rank-r term is far above the tolerance floor."""
    d, r = 100, 3
    n = int(np.prod(lead))
    rng = np.random.default_rng(n + d)
    tdt, jdt = DT[dtype]
    tj, jj = _as(_bank(rng, n, d).reshape(lead + (d, d)), tdt, jdt)
    v = rng.standard_normal(lead + (r, d)).astype(np.float32)
    nv = (np.arange(n) % (r + 1)).astype(np.int32).reshape(lead)
    want = j_ops.smw_block_update_banked(jj, jnp.asarray(v),
                                         jnp.asarray(nv), gamma=0.9,
                                         variant=variant, interpret=True)
    got = t_ops.smw_block_update_banked(tj, torch.tensor(v), torch.tensor(nv),
                                        gamma=0.9, variant=variant)
    assert got.dtype == tdt and got.shape == tj.shape
    # fp32: the same fp32 math, summed in another order (the JAX kernel
    # pads d to 128 and r to 8); bf16: one bf16 ulp (2^-8 relative) where
    # a rounding flips
    rel, floor = (1e-4, 1e-5) if dtype == "float32" else (2 ** -7, 1e-5)
    _close(want, got, rel, floor)
    # each slice against the dense oracle with its explicit r x r inverse
    jf = jj.reshape(n, d, d)
    for i, (vi, ni) in enumerate(zip(v.reshape(n, r, d), nv.reshape(n))):
        want_i = j_ref.smw_block_update_ref(jf[i], jnp.asarray(vi), 0.9,
                                            variant, n_valid=int(ni))
        _close(want_i, got.reshape(n, d, d)[i], rel, floor)
        if ni == 0:                       # empty window: bit-unchanged
            assert torch.equal(got.reshape(n, d, d)[i],
                               tj.reshape(n, d, d)[i])


def test_block_smw_plain_matches_jax_fused_kernel():
    """``fused_block_smw_plain`` on pre-weighted rows and per-slice gm
    against the Pallas ``fused_block_smw`` itself (d a block multiple)."""
    rng = np.random.default_rng(3)
    d, r = 64, 3
    j = _bank(rng, 2, d)
    vt = (rng.standard_normal((2, r, d)) * 0.3).astype(np.float32)
    gm = np.array([0.729, 1.0], np.float32)
    for variant in ("paper", "exact_smw"):
        got = t_rk.fused_block_smw_plain(torch.tensor(j), torch.tensor(vt),
                                         torch.tensor(gm), variant=variant)
        for i in range(2):
            want = j_rk.fused_block_smw(
                jnp.asarray(j[i]), jnp.asarray(vt[i]),
                jnp.asarray(gm[i]).reshape(1, 1), variant=variant, block=64,
                interpret=True)
            _close(want, got[i], 1e-4, 1e-5)
        wrapped = t_rk.fused_block_smw(torch.tensor(j), torch.tensor(vt),
                                       torch.tensor(gm), variant=variant)
        assert torch.equal(wrapped, got)


@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_block_smw_pivot_is_reference_pivot(variant):
    """``with_pivot``: per slice the smallest squared Cholesky diagonal of
    the mid matrix, as ``repro.core.mkor.smw_block_update(with_pivot=
    True)`` (the function the docstring names); the banked entry returns
    the min over slices.  The update itself is the same with or without
    it."""
    rng = np.random.default_rng(4)
    d, r, n = 40, 4, 3
    j = _bank(rng, n, d)
    v = rng.standard_normal((n, r, d)).astype(np.float32)
    nv = np.array([r, 1, 2], np.int32)
    got, piv = t_ops.smw_block_update_banked(
        torch.tensor(j), torch.tensor(v), torch.tensor(nv), gamma=0.9,
        variant=variant, with_pivot=True)
    plain = t_ops.smw_block_update_banked(
        torch.tensor(j), torch.tensor(v), torch.tensor(nv), gamma=0.9,
        variant=variant)
    assert torch.equal(got, plain) and piv.shape == ()
    pivs = [float(j_mkor.smw_block_update(
        jnp.asarray(j[i]), jnp.asarray(v[i]), 0.9, variant,
        n_valid=int(nv[i]), with_pivot=True)[1]) for i in range(n)]
    # fp32 Cholesky of the same r x r matrix
    np.testing.assert_allclose(float(piv), min(pivs), rtol=1e-4)


def non_pd_window(d=64, r=4):
    """A finite J that is not positive definite (−10·I) and a full window
    of r equal unit rows: the mid matrix γ^{2m}I + γ^{3m}S (paper) or
    γ^m I + S (exact) then has a negative eigenvalue, so the reference's
    Cholesky pivot is NaN."""
    j = -10.0 * np.eye(d, dtype=np.float32)
    v = np.tile(np.ones(d, np.float32) / np.sqrt(d), (r, 1))
    return j, v


@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_block_smw_pivot_nan_where_mid_not_positive(variant):
    """The plain route's pivot on a mid matrix that is not positive
    definite is NaN, as ``repro.core.mkor.smw_block_update(with_pivot=
    True)`` gives there (``csrc/block_smw.cu`` exports NaN for a pivot
    that is not positive; tests/test_torch_cuda.py holds the kernel to
    the same input); the update itself stays finite and matches."""
    j, v = non_pd_window()
    want, want_piv = j_mkor.smw_block_update(jnp.asarray(j), jnp.asarray(v),
                                             0.9, variant, with_pivot=True)
    assert np.isnan(float(want_piv))
    got, piv = t_ops.smw_block_update_banked(
        torch.tensor(j)[None], torch.tensor(v)[None], v.shape[0], gamma=0.9,
        variant=variant, with_pivot=True)
    assert piv.shape == () and torch.isnan(piv)
    assert torch.isfinite(got).all()
    _close(np.asarray(want), got[0], 1e-5, 1e-6)


def test_block_smw_banked_edges():
    """An empty owner chunk comes back untouched; one factor with no lead
    dims runs as a bank of one; ``out`` may be the bank itself."""
    j = torch.zeros((0, 8, 8))
    v = torch.zeros((0, 2, 8))
    assert t_ops.smw_block_update_banked(j, v, torch.zeros(0), gamma=0.9) is j
    out, piv = t_ops.smw_block_update_banked(j, v, torch.zeros(0), gamma=0.9,
                                             with_pivot=True)
    assert out is j and float(piv) == float("inf")
    rng = np.random.default_rng(5)
    jj = torch.tensor(_bank(rng, 2, 8))
    vv = torch.tensor(rng.standard_normal((2, 2, 8)).astype(np.float32))
    want = t_ops.smw_block_update_banked(jj, vv, 2, gamma=0.9)
    one = t_ops.smw_block_update_banked(jj[1], vv[1], 2, gamma=0.9)
    assert torch.equal(one, want[1])
    inplace = jj.clone()
    res = t_ops.smw_block_update_banked(inplace, vv, 2, gamma=0.9,
                                        out=inplace)
    assert res.data_ptr() == inplace.data_ptr()
    assert torch.equal(inplace, want)
    with pytest.raises(ValueError, match="window"):
        t_ops.smw_block_update_banked(jj, vv[0], 2, gamma=0.9)


def test_port_block_ref_matches_jax_ref():
    rng = np.random.default_rng(6)
    j = _bank(rng, 1, 12)[0]
    v = rng.standard_normal((3, 12)).astype(np.float32)
    for variant in ("paper", "exact_smw"):
        for nv in (None, 0, 2):
            want = j_ref.smw_block_update_ref(jnp.asarray(j), jnp.asarray(v),
                                              0.9, variant, n_valid=nv)
            got = t_ref.smw_block_update_ref(torch.tensor(j),
                                             torch.tensor(v), 0.9, variant,
                                             n_valid=nv)
            # explicit fp32 inverses on both sides
            np.testing.assert_allclose(np.asarray(want), got.numpy(),
                                       rtol=1e-4, atol=1e-5)


# (256, 256), (512, 256): the reference's default block; (1001, 1001): a
# ragged d that no 256-wide tiling divides, as one block
@pytest.mark.parametrize("d,block", [(64, 64), (128, 64), (96, 32),
                                     (256, 256), (512, 256), (1001, 1001)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matvec_and_rank1_update_match_jax_kernels(d, block, dtype):
    rng = np.random.default_rng(d + block)
    tdt, jdt = DT[dtype]
    tj, jj = _as(_bank(rng, 1, d)[0], tdt, jdt)
    v = rng.standard_normal((d, 1)).astype(np.float32)
    want_u = j_rk.matvec(jj, jnp.asarray(v), block=block, interpret=True)
    for got in (t_rk.matvec(tj, torch.tensor(v)),
                t_rk.matvec_plain(tj, torch.tensor(v)),
                t_ref.matvec_ref(tj, torch.tensor(v))):
        assert got.dtype == torch.float32 and got.shape == (d, 1)
        # identical (bf16-exact) inputs, fp32 sums in another order
        np.testing.assert_allclose(np.asarray(want_u), got.numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(j_ref.matvec_ref(jj, jnp.asarray(v))),
        t_rk.matvec(tj, torch.tensor(v)).numpy(), rtol=1e-5, atol=1e-5)
    u, s = t_rk.smw_vectors(tj, torch.tensor(v))
    ju, js = j_rk.smw_vectors(jj, jnp.asarray(v), block=block,
                              interpret=True)
    np.testing.assert_allclose(np.asarray(ju), u.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(js), float(s), rtol=1e-5)

    uu = (np.asarray(want_u) / np.sqrt(d)).astype(np.float32)
    coef = np.array([[0.37]], np.float32)
    want = j_rk.rank1_update(jj, jnp.asarray(uu), jnp.asarray(coef),
                             gamma=0.9, block=block, interpret=True)
    got = t_rk.rank1_update(tj, torch.tensor(uu), torch.tensor(coef),
                            gamma=0.9)
    assert got.dtype == tdt
    rel = 1e-6 if dtype == "float32" else 2 ** -7   # bf16: one ulp flips
    for g in (got, t_rk.rank1_update_plain(tj, torch.tensor(uu),
                                           torch.tensor(coef), gamma=0.9)):
        _close(want, g, rel, 1e-6)
    inplace = tj.clone()
    t_rk.rank1_update(inplace, torch.tensor(uu), torch.tensor(coef),
                      gamma=0.9, out=inplace)
    assert torch.equal(inplace, got)


def test_new_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a GPU is refused, never
    routed to the plain version; shapes are checked first."""
    j = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_rk.fused_block_smw(j, torch.empty((2, 3, 8), device="meta"),
                             torch.empty((2,), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        t_rk.matvec(j[0], torch.empty((8, 1), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        t_rk.rank1_update(j[0], torch.empty((8, 1), device="meta"),
                          torch.empty((1, 1), device="meta"), gamma=0.9)
    with pytest.raises(ValueError, match=r"\(B, r, d\)"):
        t_rk.fused_block_smw(torch.zeros((2, 8, 8)), torch.zeros((2, 8)),
                             torch.zeros(2))
    with pytest.raises(ValueError, match=r"\(d, 1\)"):
        t_rk.matvec(torch.zeros((8, 8)), torch.zeros(8))
