"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one (the kernels have no
CPU mode).  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import ctypes

import pytest
import torch

import smw_plan_check
from repro_torch.core.mkor import block_weights
from repro_torch.kernels import build
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import precond as t_pc
from repro_torch.kernels import rank1_smw as t_rk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); see this file's docstring")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(2, 64), (3, 1001)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_fused_smw_matches_plain(cuda_device, b, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    j = (torch.eye(d, device=cuda_device) + 0.01 * torch.randn(
        (b, d, d), generator=gen, device=cuda_device)).to(dtype)
    # v ~ N(0, 1): the rank-1 term is ~1/d an element, which an
    # elementwise bound sees beside the near-identity J
    v = torch.randn((b, d), generator=gen, device=cuda_device)
    for variant in ("paper", "exact_smw"):
        got = t_rk.fused_smw(j, v, gamma=0.9, variant=variant).float()
        want = t_rk.fused_smw_plain(j, v, gamma=0.9, variant=variant).float()
        # bf16 out: fp32 sums in another order may round an element to its
        # neighbouring bf16 value (2^-7 of itself); fp32 out: rounding only.
        # The floor covers elements near zero.
        rel, floor = (2 ** -7, 1e-5) if dtype == torch.bfloat16 else \
            (1e-5, 1e-6)
        tol = rel * want.abs() + floor * want.abs().max()
        assert bool(torch.all((got - want).abs() <= tol))


@pytest.mark.cuda
@pytest.mark.parametrize("b,di,do", [(2, 64, 96), (3, 1001, 600),
                                     (2, 600, 1001)])
def test_cuda_fused_precond_and_matmul_match_plain(cuda_device, b, di, do):
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def bank(d):
        return (torch.eye(d, device=cuda_device) + 0.01 * torch.randn(
            (b, d, d), generator=gen, device=cuda_device)).to(torch.bfloat16)
    r, l = bank(di), bank(do)
    g = (0.01 * torch.randn((b, di, do), generator=gen,
                            device=cuda_device)).to(torch.bfloat16)
    for rescale in (True, False):
        got = t_pc.fused_precond(r, g, l, rescale=rescale)
        want = t_pc.fused_precond_plain(r, g, l, rescale=rescale)
        assert float((got - want).abs().max()) <= \
            2e-4 * float(want.abs().max())
    got = t_mm.matmul(r, g)
    want = t_mm.matmul_plain(r, g)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _within(got, want, rel, floor):
    """Elementwise |got − want| ≤ rel·|want| + floor·max|want|."""
    got, want = got.float(), want.float()
    tol = rel * want.abs() + floor * want.abs().max()
    return bool(torch.all((got - want).abs() <= tol))


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,r", [(2, 64, 4), (3, 1001, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_cuda_fused_block_smw_matches_plain(cuda_device, b, d, r, dtype,
                                            variant):
    """Per-slice windows filled to 0, 1 and r rows; v ~ N(0, 1), so the
    rank-r term is far above the floor of the bound."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    j = (torch.eye(d, device=cuda_device) + 0.01 * torch.randn(
        (b, d, d), generator=gen, device=cuda_device)).to(dtype)
    v = torch.randn((b, r, d), generator=gen, device=cuda_device)
    n = torch.tensor([0, 1, r][:b], device=cuda_device)
    sq, gm = block_weights(n, r, 0.9)
    vt = (v * sq[..., None]).contiguous()
    got, piv = t_rk.fused_block_smw(j, vt, gm, variant=variant,
                                    with_pivot=True)
    want, want_piv = t_rk.fused_block_smw_plain(j, vt, gm, variant=variant,
                                                with_pivot=True)
    # bf16 out: fp32 sums in another order may round an element to its
    # neighbouring bf16 value (2^-7 of itself); fp32 out: rounding only.
    # The floor, 1e-5 (bf16) or 1e-6 (fp32) of the largest entry, covers
    # elements near zero.
    rel, floor = (2 ** -7, 1e-5) if dtype == torch.bfloat16 else \
        (1e-5, 1e-6)
    assert _within(got, want, rel, floor)
    assert torch.equal(got[0], j[0])               # empty window
    # the kernel's Gauss-Jordan pivots against the Cholesky diagonal, fp32
    assert torch.allclose(piv, want_piv, rtol=1e-3)
    same = t_rk.fused_block_smw(j, vt, gm, variant=variant)
    assert torch.equal(same, got)
    inplace = j.clone()
    t_ops.smw_block_update_banked(inplace, v, n, gamma=0.9,
                                  variant=variant, out=inplace)
    assert torch.equal(inplace, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_cuda_block_smw_pivot_nan_where_mid_not_positive(cuda_device, dtype,
                                                         variant):
    """A bank of I and a finite J that is not positive definite (−10·I),
    each with a full window of r equal unit rows: the second slice's mid
    matrix has a negative eigenvalue, so its pivot is NaN, as the plain
    route's Cholesky (and the reference's) gives; the first slice's
    pivot matches the plain one; both updates stay finite and match."""
    d, r = 64, 4
    eye = torch.eye(d, device=cuda_device)
    j = torch.stack([eye, -10.0 * eye]).to(dtype)
    v = torch.ones((2, r, d), device=cuda_device) / d ** 0.5
    sq, gm = block_weights(torch.full((2,), r, device=cuda_device), r, 0.9)
    vt = (v * sq[..., None]).contiguous()
    got, piv = t_rk.fused_block_smw(j, vt, gm, variant=variant,
                                    with_pivot=True)
    want, want_piv = t_rk.fused_block_smw_plain(j, vt, gm, variant=variant,
                                                with_pivot=True)
    assert torch.isfinite(want_piv[0]) and torch.isnan(want_piv[1])
    assert torch.isnan(piv[1]) and torch.allclose(piv[0], want_piv[0],
                                                  rtol=1e-3)
    assert torch.isfinite(got).all()
    rel, floor = (2 ** -7, 1e-5) if dtype == torch.bfloat16 else \
        (1e-5, 1e-6)
    assert _within(got, want, rel, floor)
    _, bank_piv = t_ops.smw_block_update_banked(j, v, r, gamma=0.9,
                                                variant=variant,
                                                with_pivot=True)
    assert torch.isnan(bank_piv)                # the bank's min is NaN


def _near_identity(d, dtype, gen, device):
    return (torch.eye(d, device=device) + 0.01 * torch.randn(
        (d, d), generator=gen, device=device)).to(dtype)


def _rank1_tol(dtype):
    # bf16 out: one ulp may flip; fp32 out: rounding only
    return (2 ** -7, 1e-5) if dtype == torch.bfloat16 else (1e-6, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 1001, 1024, 4096, 8200])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_matvec_and_rank1_update_match_plain(cuda_device, d, dtype):
    """Both kernels against their plain versions at the shapes
    chip_smoke.py times (1024, 4096, 1001), a small one and 8200, past
    the columns a block keeps staged; the same bits from a second call,
    in place equal to out of place, smw_vectors as matvec then vᵀu."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    j = _near_identity(d, dtype, gen, cuda_device)
    v = torch.randn((d, 1), generator=gen, device=cuda_device)
    u = t_rk.matvec(j, v)
    # fp32 out, the same products summed in another order
    assert _within(u, t_rk.matvec_plain(j, v), 0.0, 1e-5)
    assert torch.equal(t_rk.matvec(j, v), u)
    uu, s = t_rk.smw_vectors(j, v)
    assert torch.equal(uu, u)
    assert torch.allclose(s, torch.sum(v[:, 0] * u[:, 0]))
    un = u / d ** 0.5
    coef = torch.full((1, 1), 0.37, device=cuda_device)
    got = t_rk.rank1_update(j, un, coef, gamma=0.9)
    assert got.dtype == dtype
    assert _within(got, t_rk.rank1_update_plain(j, un, coef, gamma=0.9),
                   *_rank1_tol(dtype))
    assert torch.equal(t_rk.rank1_update(j, un, coef, gamma=0.9), got)
    inplace = j.clone()
    t_rk.rank1_update(inplace, un, coef, gamma=0.9, out=inplace)
    assert torch.equal(inplace, got)


def _offset_view(x, shape):
    """x's values in a view whose base lies one element past a 16-byte
    boundary."""
    buf = torch.empty((x.numel() + 1,), dtype=x.dtype, device=x.device)
    view = buf[1:].view(shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1024, 1001, 8199, 8201])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_matvec_and_rank1_update_unaligned_rows(cuda_device, d, dtype):
    """J, v and u in offset views, so no row of J starts on 16 bytes (the
    wrappers pass vec = 0 and the kernels find each row's boundary) and
    the vectors stage without float4 loads; an output on another 16-byte
    phase than J's is written by scalars, and gives the same bits as the
    vector paths.  At 8199 and 8201 the rows are ragged and wider than the
    columns a block keeps staged, so per-row heads and scalar columns
    cross a tile boundary."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    jc = _near_identity(d, dtype, gen, cuda_device)
    j = _offset_view(jc, (d, d))
    assert not build.rows_aligned(j, d)
    v = _offset_view(torch.randn((d, 1), generator=gen, device=cuda_device),
                     (d, 1))
    u = t_rk.matvec(j, v)
    assert _within(u, t_rk.matvec_plain(jc, v), 0.0, 1e-5)
    assert torch.equal(t_rk.matvec(j, v), u)
    un = _offset_view(u / d ** 0.5, (d, 1))
    coef = torch.full((1, 1), 0.37, device=cuda_device)
    want = t_rk.rank1_update(jc, un, coef, gamma=0.9)      # vectors
    assert _within(want, t_rk.rank1_update_plain(jc, un, coef, gamma=0.9),
                   *_rank1_tol(dtype))
    got = t_rk.rank1_update(j, un, coef, gamma=0.9)        # other phase
    assert torch.equal(got, want)
    same = _offset_view(torch.zeros_like(jc), (d, d))      # same phase
    t_rk.rank1_update(j, un, coef, gamma=0.9, out=same)
    assert torch.equal(same, want)
    t_rk.rank1_update(j, un, coef, gamma=0.9, out=j)       # in place
    assert torch.equal(j, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_matvec_and_rank1_update_empty(cuda_device, dtype):
    """d = 0 launches nothing and returns empty results."""
    j = torch.empty((0, 0), dtype=dtype, device=cuda_device)
    v = torch.empty((0, 1), device=cuda_device)
    t_ops.reset_launch_counts()
    assert t_rk.matvec(j, v).shape == (0, 1)
    out = t_rk.rank1_update(j, v, torch.ones((1, 1), device=cuda_device),
                            gamma=0.9)
    assert out.shape == (0, 0) and out.dtype == dtype
    assert t_ops.launch_counts() == {}


def _int8_bank(b, d, gen, device):
    """int8 codes and (b,) scales of a near-identity bank with off-diagonal
    noise of 0.05, so the codes spread over about ±30 off the diagonal."""
    from repro_torch.core.stats import quant_encode
    x = 0.05 * torch.randn((b, d, d), generator=gen, device=device)
    return quant_encode(torch.eye(d, device=device) + (x + x.transpose(1, 2))
                        / 2 ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(2, 64), (3, 1001)])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_cuda_fused_smw_int8_matches_plain(cuda_device, b, d, variant):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, sc = _int8_bank(b, d, gen, cuda_device)
    v = torch.randn((b, d), generator=gen, device=cuda_device)
    t_ops.reset_launch_counts()
    got = t_rk.fused_smw(q, v, gamma=0.9, variant=variant, scale=sc)
    assert t_ops.launch_counts() == {"fused_smw[int8]": 1}
    want = t_rk.fused_smw_plain(q, v, gamma=0.9, variant=variant, scale=sc)
    # fp32 out from the same decoded values, summed in another order
    assert got.dtype == torch.float32 and _within(got, want, 1e-5, 1e-6)
    banked = t_ops.smw_rank1_update_banked(q, v, gamma=0.9, variant=variant,
                                           scale=sc)
    assert torch.equal(banked, got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,r", [(3, 64, 4), (3, 1001, 3)])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_cuda_fused_block_smw_int8_matches_plain(cuda_device, b, d, r,
                                                 variant):
    """Windows filled to 0, 1 and r rows, with the pivot."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, sc = _int8_bank(b, d, gen, cuda_device)
    v = torch.randn((b, r, d), generator=gen, device=cuda_device)
    n = torch.tensor([0, 1, r], device=cuda_device)
    sq, gm = block_weights(n, r, 0.9)
    vt = (v * sq[..., None]).contiguous()
    t_ops.reset_launch_counts()
    got, piv = t_rk.fused_block_smw(q, vt, gm, variant=variant,
                                    with_pivot=True, scale=sc)
    assert t_ops.launch_counts() == {"fused_block_smw[int8]": 1}
    want, want_piv = t_rk.fused_block_smw_plain(q, vt, gm, variant=variant,
                                                with_pivot=True, scale=sc)
    assert got.dtype == torch.float32 and _within(got, want, 1e-5, 1e-6)
    # an empty window returns the decoded slice exactly
    assert torch.equal(got[0], q[0].float() * sc[0])
    assert torch.allclose(piv, want_piv, rtol=1e-3)
    banked = t_ops.smw_block_update_banked(q, v, n, gamma=0.9,
                                           variant=variant, scale=sc)
    assert torch.equal(banked, got)


def _int8_route(*dims):
    """The core int8 codes take: the Hopper core for rows of 16 codes."""
    return "wmma" if any(d % 16 for d in dims) else "wgmma"


@pytest.mark.cuda
@pytest.mark.parametrize("b,di,do", [(2, 64, 96), (3, 1001, 600),
                                     (2, 600, 1001), (2, 1008, 720),
                                     (2, 720, 1008), (2, 1000, 712)])
def test_cuda_fused_precond_int8_matches_plain(cuda_device, b, di, do):
    """On the core the route picks -- the Hopper core (codes widened in
    shared memory) for rows of 16 codes, tiles ragged at 1008 and 720; the
    WMMA core for 1001, 600 and 1000 -- and on each core forced where it
    takes the operands."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    rq, rsc = _int8_bank(b, di, gen, cuda_device)
    lq, lsc = _int8_bank(b, do, gen, cuda_device)
    g = (0.01 * torch.randn((b, di, do), generator=gen,
                            device=cuda_device)).to(torch.bfloat16)
    route = _int8_route(di, do)
    for core in (None, "wgmma", "wmma") if route == "wgmma" else \
            (None, "wmma"):
        for rescale in (True, False):
            t_ops.reset_launch_counts()
            got = t_pc.fused_precond(rq, g, lq, rescale=rescale,
                                     r_scale=rsc, l_scale=lsc, core=core)
            assert t_ops.launch_counts() == {"fused_precond[int8]": 1,
                                             "matmul[int8 operand]": 1}
            assert t_ops.gemm_core_counts() == {core or route: 2}
            want = t_pc.fused_precond_plain(rq, g, lq, rescale=rescale,
                                            r_scale=rsc, l_scale=lsc)
            # the fp32 first product rides the tensor cores as a bf16
            # hi/lo pair, as on the bf16 route: 2e-4 of the largest entry
            assert float((got - want).abs().max()) <= \
                2e-4 * float(want.abs().max())
    if route == "wmma":
        with pytest.raises(ValueError, match="wgmma"):
            t_pc.fused_precond(rq, g, lq, r_scale=rsc, l_scale=lsc,
                               core="wgmma")
    # the first products alone: int8 codes enter exactly, the scale in
    # the epilogue; bf16 products are exact in fp32, only the order differs
    for a, b_, kw in ((rq, g, dict(a_scale=rsc)), (g, lq, dict(b_scale=lsc))):
        want = t_mm.matmul_plain(a, b_, **kw)
        for core in (None, "wmma"):
            t_ops.reset_launch_counts()
            got = t_mm.matmul(a, b_, core=core, **kw)
            assert t_ops.launch_counts() == {"matmul[int8 operand]": 1}
            assert t_ops.gemm_core_counts() == {
                core or t_mm.route_of(a, b_): 1}
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,n", [(2, 1000, 1008, 720), (3, 64, 96, 144),
                                     (130, 128, 128, 128),
                                     (3, 1001, 600, 701)])
@pytest.mark.parametrize("side", ["a", "b"])
def test_cuda_int8_operand_cores(cuda_device, b, m, k, n, side):
    """matmul with int8 codes as A or B on each core that takes them, the
    Hopper core's hi/lo pair of the scaled product, and a ragged int8 row
    (600 or 701 codes) that stays on the WMMA core, whose wgmma forcing
    raises.  130 slices of 128^3 wrap the persistent grid."""
    from repro_torch.kernels.ref import split_hi_lo
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    x = torch.randn((b, m, k) if side == "b" else (b, k, n), generator=gen,
                    device=cuda_device)
    q8 = torch.randint(-127, 128, (b, m, k) if side == "a" else (b, k, n),
                       generator=gen, device=cuda_device).to(torch.int8)
    sc = torch.rand((b,), generator=gen, device=cuda_device) / 127 + 1e-3
    x = (x / k ** 0.5).to(torch.bfloat16)
    a, w, kw = (q8, x, dict(a_scale=sc)) if side == "a" else \
        (x, q8, dict(b_scale=sc))
    route = t_mm.route_of(a, w)
    assert route == _int8_route(k if side == "a" else n)
    want = t_mm.matmul_plain(a, w, **kw)
    for core in (None, "wgmma", "wmma") if route == "wgmma" else \
            (None, "wmma"):
        t_ops.reset_launch_counts()
        got = t_mm.matmul(a, w, core=core, **kw)
        assert t_ops.launch_counts() == {"matmul[int8 operand]": 1}
        assert t_ops.gemm_core_counts() == {core or route: 1}
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    if route == "wgmma":
        hi, lo = t_mm.matmul_split(a, w, **kw)
        want_hi, _ = split_hi_lo(want)
        assert float((hi.float() + lo.float() - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
        assert _within(hi, want_hi, 2 ** -7, 1e-5)
    else:
        with pytest.raises(ValueError, match="wgmma"):
            t_mm.matmul(a, w, core="wgmma", **kw)


# ----------------------------------------------------------------------- #
# The two GEMM cores: the Hopper core (TMA ring + wgmma) where the route
# sends bf16 operands with 16-byte rows, the WMMA core elsewhere
# ----------------------------------------------------------------------- #
def _matmul_tol(want, k):
    # bf16 products are exact in fp32: only the summation order differs
    return 1e-5 * float(want.abs().max()) * k ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,n", [(2, 1000, 600, 712), (3, 64, 96, 136),
                                     (300, 128, 128, 128)])
def test_cuda_wgmma_matmul_matches_plain(cuda_device, b, m, k, n):
    """Shapes TMA takes but the 128 x 128 tile does not divide, and a batch
    of 300 tiles, which wraps the persistent grid (one block an SM) more
    than twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    a = torch.randn((b, m, k), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    w = (torch.randn((b, k, n), generator=gen, device=cuda_device)
         / k ** 0.5).to(torch.bfloat16)
    want = t_mm.matmul_plain(a, w)
    for core in (None, "wgmma", "wmma"):
        t_ops.reset_launch_counts()
        got = t_mm.matmul(a, w, core=core)
        assert t_ops.gemm_core_counts() == {core or "wgmma": 1}
        assert t_ops.launch_counts() == {"matmul": 1}
        assert float((got - want).abs().max()) <= _matmul_tol(want, k)
    # a bf16 output is the hi part of the pair epilogue
    got = t_mm.matmul(a, w, out_dtype=torch.bfloat16)
    assert _within(got, want, 2 ** -7, 1e-5)


@pytest.mark.cuda
def test_cuda_wgmma_matmul_broadcast_operand(cuda_device):
    """A 2-D operand broadcast over the other's batch takes a 2-D tensor
    map, on either side."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    a3 = torch.randn((3, 200, 136), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    b2 = torch.randn((136, 264), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    a2 = torch.randn((200, 136), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    b3 = torch.randn((3, 136, 264), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    for a, b in ((a3, b2), (a2, b3), (a2, b2)):
        t_ops.reset_launch_counts()
        got = t_mm.matmul(a, b)
        assert t_ops.gemm_core_counts() == {"wgmma": 1}
        want = t_mm.matmul_plain(a, b)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= _matmul_tol(want, 136)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,n", [(2, 1000, 600, 712), (3, 64, 96, 136)])
def test_cuda_wgmma_hilo_epilogue(cuda_device, b, m, k, n):
    """The pair epilogue against split_hi_lo of the plain product: hi + lo
    within the fp32 bound, hi the bf16 rounding of the product (one bf16
    ulp apart where the two fp32 sums straddle a rounding boundary)."""
    from repro_torch.kernels.ref import split_hi_lo
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    a = torch.randn((b, m, k), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    w = (torch.randn((b, k, n), generator=gen, device=cuda_device)
         / k ** 0.5).to(torch.bfloat16)
    t_ops.reset_launch_counts()
    hi, lo = t_mm.matmul_split(a, w)
    assert t_ops.gemm_core_counts() == {"wgmma": 1}
    want = t_mm.matmul_plain(a, w)
    want_hi, want_lo = split_hi_lo(want)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert float((hi.float() + lo.float() - want).abs().max()) <= \
        _matmul_tol(want, k)
    assert _within(hi, want_hi, 2 ** -7, 1e-5)
    # lo is the rounding residue of hi: at most half a bf16 ulp of hi
    assert bool(torch.all(lo.float().abs() <= hi.float().abs() * 2 ** -8
                          + 1e-30))
    with pytest.raises(ValueError, match="wgmma"):
        t_mm.matmul_split(a[:, :, :k - 1].contiguous(),
                          w[:, :k - 1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("b,di,do", [(2, 1000, 712), (2, 712, 1000),
                                     (3, 64, 136), (3, 1001, 600)])
def test_cuda_fused_precond_cores(cuda_device, b, di, do):
    """fused_precond on the core its route picks -- the Hopper core in split
    mode for the TMA-eligible shapes (T on the right for d_out >= d_in, on
    the left otherwise), the WMMA core for 1001 -- and on the WMMA core
    forced, against the plain version, rescale on and off."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)

    def bank(d):
        return (torch.eye(d, device=cuda_device) + 0.01 * torch.randn(
            (b, d, d), generator=gen, device=cuda_device)).to(torch.bfloat16)
    r, l = bank(di), bank(do)
    g = (0.01 * torch.randn((b, di, do), generator=gen,
                            device=cuda_device)).to(torch.bfloat16)
    route = "wmma" if di % 8 or do % 8 else "wgmma"
    for core in (None, "wmma"):
        for rescale in (True, False):
            t_ops.reset_launch_counts()
            got = t_pc.fused_precond(r, g, l, rescale=rescale, core=core)
            assert t_ops.launch_counts() == {"fused_precond": 1, "matmul": 1}
            assert t_ops.gemm_core_counts() == {core or route: 2}
            want = t_pc.fused_precond_plain(r, g, l, rescale=rescale)
            assert float((got - want).abs().max()) <= \
                2e-4 * float(want.abs().max())
    if route == "wmma":
        with pytest.raises(ValueError, match="wgmma"):
            t_pc.fused_precond(r, g, l, core="wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("b,di,do", [(4, 1024, 4096), (4, 4096, 1024),
                                     (3, 1001, 600), (2, 1008, 720)])
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_fused_precond_bit_repeatable(cuda_device, b, di, do, quant):
    """ΣG² and ΣΔ² are added in a fixed order (csrc/precond.cu): a second
    call on the same inputs gives the same bits, on both cores, bf16 and
    int8 factors, rescale on and off."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    if quant:
        (r, rsc), (l, lsc) = (_int8_bank(b, d, gen, cuda_device)
                              for d in (di, do))
        kw = dict(r_scale=rsc, l_scale=lsc)
    else:
        r, l = ((torch.eye(d, device=cuda_device) + 0.01 * torch.randn(
            (b, d, d), generator=gen, device=cuda_device)).to(torch.bfloat16)
            for d in (di, do))
        kw = {}
    g = (0.01 * torch.randn((b, di, do), generator=gen,
                            device=cuda_device)).to(torch.bfloat16)
    route = t_pc.precond_route(r.dtype, g.dtype, l.dtype, di, do,
                               r.data_ptr(), g.data_ptr(), l.data_ptr())
    for core in ((None, "wmma") if route == "wgmma" else (None,)):
        for rescale in (True, False):
            first = t_pc.fused_precond(r, g, l, rescale=rescale, core=core,
                                       **kw)
            for _ in range(3):
                again = t_pc.fused_precond(r, g, l, rescale=rescale,
                                           core=core, **kw)
                assert torch.equal(again, first), (core, rescale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("rank", [1, 4])
def test_cuda_smw_owned_chunk_with_padded_tail(cuda_device, kind, rank):
    """The data-parallel path's owned chunk of a bank the world does not
    divide (5 slices at world 2: rank 1 owns slices 3, 4 and one zero slot,
    a zero factor with a zero vector, or a window count of 0): the real
    slices as the full-bank launch's, the padded slot zero."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    n, chunk, d = 5, 3, 256
    if kind == "int8":
        j, sc = _int8_bank(n, d, gen, cuda_device)
    else:
        j, sc = (torch.eye(d, device=cuda_device) + 0.01 * torch.randn(
            (n, d, d), generator=gen, device=cuda_device)).to(
                torch.bfloat16), None

    def tail(x):
        return torch.cat([x[chunk:], x.new_zeros((2 * chunk - n,)
                                                 + tuple(x.shape[1:]))])
    sc_c = None if sc is None else tail(sc)
    if rank == 1:
        v = torch.randn((n, d), generator=gen, device=cuda_device)
        full = t_rk.fused_smw(j, v, gamma=0.9, scale=sc)
        part = t_rk.fused_smw(tail(j), tail(v), gamma=0.9, scale=sc_c)
    else:
        w = torch.randn((n, rank, d), generator=gen, device=cuda_device)
        cnt = torch.full((n,), rank, device=cuda_device)
        cnt_c = tail(cnt)
        sq, gm = block_weights(cnt, rank, 0.9)
        sq_c, gm_c = block_weights(cnt_c, rank, 0.9)
        full = t_rk.fused_block_smw(j, (w * sq[..., None]).contiguous(), gm,
                                    scale=sc)
        part = t_rk.fused_block_smw(tail(j), (tail(w) * sq_c[..., None])
                                    .contiguous(), gm_c, scale=sc_c)
    own = n - chunk
    assert int(torch.count_nonzero(part[own:])) == 0
    rel, floor = (2 ** -7, 1e-5) if kind == "bfloat16" else (1e-5, 1e-6)
    assert _within(part[:own], full[chunk:], rel, floor)


@pytest.mark.cuda
@pytest.mark.parametrize("extra,match", [
    (["--dist-devices", "2"], "--dist-backend gloo"),
    (["--dist-devices", "2", "--dist-backend", "gloo"], "--chunk 1")])
def test_cuda_launcher_dist_refusals(cuda_device, extra, match):
    """NCCL with more ranks than cards exits naming --dist-backend gloo
    (on a one-card machine), and gloo on the card refuses a capture."""
    from repro_torch.launch import train as t_train
    if "gloo" not in extra and torch.cuda.device_count() >= 2:
        pytest.skip("needs fewer cards than ranks")
    with pytest.raises(SystemExit, match=match):
        t_train.main(["--arch", "bert-large", "--reduced", "--steps", "1",
                      "--global-batch", "2", "--dist", "--chunk", "4"]
                     + extra)


# ----------------------------------------------------------------------- #
# The persistent SMW kernel (block_smw.cu): fused_block_smw at every built
# rank and fused_smw as its r = 1 instance, on every body (bf16, fp32 and
# int8 codes with fp32 out)
# ----------------------------------------------------------------------- #
SMW_KINDS = ["bfloat16", "float32", "int8"]
# (b, d, unaligned): a bucket of 64 slices of 1024² whose write runs and
# pass-1 runs interleave, a batch of 1, ragged d (1001, the element path),
# and a base one element off 16-byte alignment (the element path at d = 64)
SMW_SHAPES = [(64, 1024, False), (1, 1024, False), (3, 1001, False),
              (2, 64, True)]
SMW_ITEM = {"bfloat16": 2, "float32": 4, "int8": 1}


def _smw_bank(kind, b, d, unaligned, gen, device):
    """(j, scale) of kind ``kind``; ``unaligned`` puts j one element past
    an aligned base."""
    if kind == "int8":
        q, sc = _int8_bank(b, d, gen, device)
    else:
        q = (torch.eye(d, device=device) + 0.01 * torch.randn(
            (b, d, d), generator=gen, device=device)).to(getattr(torch, kind))
        sc = None
    return (_unaligned_copy(q) if unaligned else q), sc


def _unaligned_copy(x):
    """A copy of x whose base lies one element past an aligned one."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:].copy_(x.reshape(-1))
    return flat[1:].view(x.shape)


def _smw_tol(kind):
    # bf16 out: fp32 sums in another order may round an element to its
    # neighbouring bf16 value (2^-7 of itself); fp32 out: rounding only
    return (2 ** -7, 1e-5) if kind == "bfloat16" else (1e-5, 1e-6)


def _launch_plan(kind, b, d, rank, vec=1):
    """The kernel's library (its plan entries bound), and the blocks this
    card holds at once for a launch on a (b, d, d) bank of ``kind`` at
    kernel rank ``rank`` (``vec``: the bulk path's alignment)."""
    from repro_torch.kernels import build
    lib = smw_plan_check.bind(build.library("block_smw"))
    resident = ctypes.c_longlong()
    build.check(lib.mkor_block_smw_resident(
        d, b, rank, {"bfloat16": 0, "float32": 1, "int8": 2}[kind], vec,
        ctypes.byref(resident)), "mkor_block_smw_resident")
    return lib, resident.value


def _interleaved(kind, b, d, r):
    """The launch on a (b, d, d) bank at rank r (padded to a built kernel
    rank) lets write runs come between pass-1 runs (the two passes are not
    one after the other)."""
    rank = next(k for k in t_rk.BLOCK_RANKS if k >= r)
    lib, resident = _launch_plan(kind, b, d, rank)
    plan = smw_plan_check.plan(lib, b, d, rank, SMW_ITEM[kind], resident)
    return plan["lag"] < b * plan["runs"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,unaligned", SMW_SHAPES)
@pytest.mark.parametrize("kind", SMW_KINDS)
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_cuda_block_smw_design(cuda_device, b, d, unaligned, kind,
                               variant):
    """Every built rank, with padding (r = 1, 2, 3, 4, 5, 8, 13, 16),
    windows filled to 0, 1 and r (full at a batch of 1), with the pivot:
    against the plain version; an empty window's slice is its input
    exactly; a second call gives the same bits (S summed in a fixed
    order); the update in place (out is j) gives them too."""
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    j, sc = _smw_bank(kind, b, d, unaligned, gen, cuda_device)
    rel, floor = _smw_tol(kind)
    for r in (1, 2, 3, 4, 5, 8, 13, 16):
        if (b, d) == (64, 1024):
            assert _interleaved(kind, b, d, r)
        v = torch.randn((b, r, d), generator=gen, device=cuda_device)
        n = torch.tensor([(0, 1, r)[i % 3] for i in range(b)] if b > 1
                         else [r], device=cuda_device)
        sq, gm = block_weights(n, r, 0.9)
        vt = (v * sq[..., None]).contiguous()
        t_ops.reset_launch_counts()
        got, piv = t_rk.fused_block_smw(j, vt, gm, variant=variant,
                                        with_pivot=True, scale=sc)
        name = "fused_block_smw" + ("[int8]" if sc is not None else "")
        assert t_ops.launch_counts() == {name: 1}
        want, want_piv = t_rk.fused_block_smw_plain(
            j, vt, gm, variant=variant, with_pivot=True, scale=sc)
        assert _within(got, want, rel, floor), r
        assert torch.allclose(piv, want_piv, rtol=1e-3), r
        empty = n == 0
        base = j[empty] if sc is None else \
            j[empty].float() * sc[empty][:, None, None]
        assert torch.equal(got[empty], base), r
        again, again_piv = t_rk.fused_block_smw(
            j, vt, gm, variant=variant, with_pivot=True, scale=sc)
        assert torch.equal(again, got) and torch.equal(again_piv, piv), r
        if sc is None:
            inplace = _unaligned_copy(j) if unaligned else j.clone()
            t_rk.fused_block_smw(inplace, vt, gm, variant=variant,
                                 out=inplace)
            assert torch.equal(inplace, got), r


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,unaligned", SMW_SHAPES)
@pytest.mark.parametrize("kind", SMW_KINDS)
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_cuda_fused_smw_design(cuda_device, b, d, unaligned, kind, variant):
    """fused_smw, the r = 1 instance of the same kernel: one launch under
    its own name, against its plain version, a second call giving the same
    bits, and in place (out is j)."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    j, sc = _smw_bank(kind, b, d, unaligned, gen, cuda_device)
    if (b, d) == (64, 1024):
        assert _interleaved(kind, b, d, 1)
    v = torch.randn((b, d), generator=gen, device=cuda_device)
    t_ops.reset_launch_counts()
    got = t_rk.fused_smw(j, v, gamma=0.9, variant=variant, scale=sc)
    name = "fused_smw" + ("[int8]" if sc is not None else "")
    assert t_ops.launch_counts() == {name: 1}
    want = t_rk.fused_smw_plain(j, v, gamma=0.9, variant=variant, scale=sc)
    assert _within(got, want, *_smw_tol(kind))
    assert torch.equal(t_rk.fused_smw(j, v, gamma=0.9, variant=variant,
                                      scale=sc), got)
    if sc is None:
        inplace = _unaligned_copy(j) if unaligned else j.clone()
        t_rk.fused_smw(inplace, v, gamma=0.9, variant=variant, out=inplace)
        assert torch.equal(inplace, got)


@pytest.mark.cuda
def test_cuda_block_smw_ticket_order(cuda_device):
    """The plan and the ticket order of the kernel's own library, on the
    blocks this card holds for each launch, hold the invariants of
    :func:`smw_plan_check.check_plan`."""
    for kind, b, d, rank, vec in [("bfloat16", 96, 1024, 4, 1),
                                  ("bfloat16", 24, 4096, 1, 1),
                                  ("int8", 24, 4096, 4, 1),
                                  ("float32", 7, 1001, 16, 0),
                                  ("float32", 5, 100, 2, 0)]:
        lib, resident = _launch_plan(kind, b, d, rank, vec)
        assert resident >= torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
        smw_plan_check.check_plan(lib, b, d, rank, SMW_ITEM[kind], resident)


# --------------------------------------------------------------------- #
# The chunk runner: CUDA graph replays of the whole train step
# --------------------------------------------------------------------- #
CAPTURE_CASES = {
    "kernels-rank1": dict(use_kernels=True),
    "kernels-rank2-staleness1": dict(use_kernels=True, rank=2, staleness=1),
    "kernels-int8-rank1": dict(use_kernels=True, factor_quant="int8"),
    "plain-rank1": dict(),
    "plain-rank2-staleness1": dict(rank=2, staleness=1),
    "plain-int8-rank1": dict(factor_quant="int8"),
    # the per-layer layout through the per-layer kernel entries
    "kernels-per_layer-rank1": dict(use_kernels=True, layout="per_layer"),
    "kernels-per_layer-rank2-staleness1": dict(
        use_kernels=True, layout="per_layer", rank=2, staleness=1),
    "lamb": None,
    "eva": dict(optimizer="eva"),
}


def _graph_setup(device, kw, steps):
    """The reduced bert-large on the card, mkor(lamb) at inv_freq 3 (or
    LAMB alone, or eva(lamb) for ``optimizer="eva"``), a cosine schedule
    that moves the learning rate and the bias corrections every step, and
    ``steps`` numpy batches."""
    from repro_torch.configs import bert_large
    from repro_torch.core import firstorder, schedule
    from repro_torch.core.eva import eva
    from repro_torch.core.mkor import MKORConfig, mkor
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as t_loop
    cfg = bert_large.CONFIG.reduced()
    lr = schedule.warmup_cosine(1e-2, 2, steps)
    if kw is None:
        opt = firstorder.lamb(lr)
    elif kw.get("optimizer") == "eva":
        opt = eva(firstorder.lamb(lr))
    else:
        opt = mkor(firstorder.lamb(lr), MKORConfig(inv_freq=3, **kw))
    params = model_lib.init_params(cfg, seed=0, device=device)
    ds = pipeline.make_dataset(cfg, global_batch=2, seq_len=16, seed=0)
    batches = [pipeline.make_batch(ds, i) for i in range(steps)]
    return t_loop.make_train_step(cfg, opt), params, opt.init(params), \
        batches


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _may_differ(path):
    """The leaves downstream of fused_precond's ΣΔ², whose atomics add in
    another order on every launch (``csrc/precond.cu``): the parameters,
    LAMB's moments and the update norm."""
    return path[0] == 0 or path[:3] in ((1, "backend", "m"),
                                        (1, "backend", "v")) or \
        path == (2, "update_norm")


def _replay_tol(path, want, old):
    """One bf16 ulp of fused_precond's output g' (2^-7 |g'|) carried into
    LAMB: m = 0.9·m_old + 0.1·g' moves by 2^-7 |m - 0.9·m_old|, v by
    (2^-6 + 2^-14) |v - 0.999·v_old|, a parameter by 2^-5 |p - p_old| and
    2^-6 |p|, the update norm by 2^-5 of itself; plus two fp32 ulps
    (2^-22 |want|) and 1e-6 max|want| (chip_smoke.replay_tol, PERF.md).
    ``old``: the step's input (params, state)."""
    w = want.float()
    if path[0] == 2:
        step = 2.0 ** -5 * w.abs()
    else:
        for k in path:
            old = old[k]
        o = old.float()
        if path[0] == 0:
            step = 2.0 ** -6 * w.abs() + 2.0 ** -5 * (w - o).abs()
        elif path[2] == "m":
            step = 2.0 ** -7 * (w - 0.9 * o).abs()
        else:
            step = (2.0 ** -6 + 2.0 ** -14) * (w - 0.999 * o).abs()
    return step + 2.0 ** -22 * w.abs() + 1e-6 * w.abs().max()


def _replay_vs_eager(got, want, kernels, old):
    """Every leaf bit for bit; on a kernel path the leaves of
    :func:`_may_differ` within :func:`_replay_tol` (``old``: the eager
    step's input (params, state))."""
    got, want = dict(_paths(got)), dict(_paths(want))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.device == w.device, path
        if torch.equal(g, w):
            continue
        assert kernels and _may_differ(path), path
        tol = _replay_tol(path, w, old)
        assert bool(torch.all((g.float() - w.float()).abs() <= tol)), path


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_cuda_chunk_runner_replays_equal_eager(cuda_device, case):
    """7 steps through ``train_epoch`` in chunks of 3 (a partial trailing
    chunk).  Before each replay the eager step runs from copies of the same
    state; the replay's params, whole state (banks, windows, LAMB moments,
    counts) and metrics must equal it (:func:`_replay_vs_eager`), and the
    launch counts credited to the replay must be the eager step's.  The
    first step of each residue (inv_freq 3) runs eagerly before its
    capture, so each graph replays at least once."""
    from repro_torch.training import loop as t_loop
    from repro_torch.tree import tree_map
    kw = CAPTURE_CASES[case]
    kernels = kw is not None and kw.get("use_kernels", False)
    step, params, state, batches = _graph_setup(cuda_device, kw, 7)
    runner = t_loop.make_chunk_runner(step)
    replay, replayed = runner._replay, []

    def checked_replay(g):
        p, s, b = tree_map(torch.clone, (*runner._tree_at(runner.host),
                                         runner._batch))
        mark = build.count_mark()
        ep, es, em = step(p, s, b)
        eager_counts = build.rewind_counts(mark)
        replay(g)
        assert g.counts == eager_counts
        after = [h + d for h, d in zip(runner.host, g.delta)]
        metrics = dict(zip(runner._keys, runner._metrics))
        _replay_vs_eager((*runner._tree_at(after), metrics),
                         (ep, es, {k: em[k].float() for k in runner._keys}),
                         kernels, (p, s))
        replayed.append(g)

    runner._replay = checked_replay
    t_ops.reset_launch_counts()
    _, state_out, hist = t_loop.train_epoch(step, params, state, batches,
                                            chunk=3, runner=runner)
    # one graph for LAMB and Eva (no branch of their own), one a residue
    # of inv_freq 3 for MKOR
    n_keys = 1 if kw is None or "optimizer" in kw else 3
    assert len(runner.graphs) == n_keys and len(replayed) == 7 - n_keys
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    assert int(state_out["count"]) == 7
    if kw is not None:
        assert int(state_out["backend"]["count"]) == 7
    if kernels:
        assert t_ops.launch_counts(), "no kernel launched"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["kernels-rank1", "kernels-rank2-staleness1",
                                  "lamb"])
def test_cuda_phase_marks_once_a_replay_in_order(cuda_device, case):
    """Each graph key captured by the chunk runner (warm-up, capture and a
    replay each), then three replays under ``torch.profiler``: each phase
    mark kernel once a replay, in step order (``second_order`` under MKOR
    only), and the runner's counts: one graph and one warm-up a key seen,
    host seconds and pool bytes above 0.  A trace that drops events is
    retaken (at most three times); none may show a mark too many."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import loop as t_loop
    from repro_torch.training import phases
    kw = CAPTURE_CASES[case]
    keys = 1 if kw is None else 3
    step, params, state, batches = _graph_setup(cuda_device, kw,
                                                max(2 * keys, 3))
    t_loop.reset_runner_counts()
    runner = t_loop.make_chunk_runner(step)
    params, state, _ = t_loop.train_epoch(
        step, params, state, batches[:2 * keys], chunk=2 * keys,
        runner=runner)
    order = [phases.KERNEL.format(p) for p in phases.PHASES
             if kw is not None or p != "second_order"]
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, state, _ = t_loop.train_epoch(
                step, params, state, batches[:3], chunk=3, runner=runner)
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.name) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.name.startswith("repro_mark_"))
        names = [n for _, n in events]
        assert len(names) <= 3 * len(order), names
        if names == order * 3:
            break
    assert names == order * 3
    counts = t_loop.runner_counts()
    assert counts["graphs"] == len(runner.graphs) == keys
    assert counts["warm_ups"] == keys
    assert counts["capture_s"] > 0 and counts["pool_bytes"] > 0
    assert set(t_loop.runner_counts(by_key=True)) == set(runner.graphs)


@pytest.mark.cuda
def test_cuda_capture_failure_names_the_op(cuda_device):
    """A step that reads a device value on the host cannot be captured: the
    runner raises GraphCaptureError naming the line, and the device works
    on afterwards."""
    from repro_torch.training import loop as t_loop
    step, params, state, batches = _graph_setup(cuda_device, None, 2)

    def host_read(params, state, batch, scalars=None):
        out = step(params, state, batch, scalars=scalars)
        out[2]["loss"].item()                  # a host read mid-step
        return out

    host_read.plan = step.plan
    with pytest.raises(t_loop.GraphCaptureError,
                       match=r"test_torch_cuda\.py:\d+ .*\.item\(\)"):
        t_loop.train_epoch(host_read, params, state, batches, chunk=2)
    assert float(torch.ones(4, device=cuda_device).sum()) == 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,d", [(24, 4, 1024), (6, 2, 4096), (3, 1, 300)])
def test_cuda_solve_mid_captures(cuda_device, b, r, d):
    """The plain block route's mid-matrix solve replays in a CUDA graph
    with the bits of its eager call, within fp32 rounding of
    ``torch.linalg.solve``."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    v = torch.randn((b, r, d), generator=gen, device=cuda_device)
    mid = 0.81 * torch.eye(r, device=cuda_device) + 0.729 * (v @ v.mT) / d
    u = torch.randn((b, r, d), generator=gen, device=cuda_device)
    eager = t_rk.solve_mid(mid, u)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        t_rk.solve_mid(mid, u)                  # warm-up
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = t_rk.solve_mid(mid, u)
    graph.replay()
    assert torch.equal(out, eager)
    assert _within(eager, torch.linalg.solve(mid, u), 1e-5, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [True, False])
def test_cuda_runner_between_eager_steps(cuda_device, donate):
    """Runner chunks with eager steps between them (whose states list
    their keys in the update's order, not init's) give the per-step loop's
    bits on the plain staleness-1 route; ``donate=False`` leaves the
    caller's tensors as they were."""
    from repro_torch.training import loop as t_loop
    from repro_torch.tree import tree_map
    step, params, state, batches = _graph_setup(
        cuda_device, dict(rank=2, staleness=1), 8)
    p, s = params, state
    for b in batches:
        p, s, _ = step(p, s, t_loop.batch_to_device(b, cuda_device))
    kept = tree_map(torch.clone, (params, state))
    runner = t_loop.make_chunk_runner(step, donate=donate)
    q, t, _ = runner(params, state, t_loop.stack_batches(batches[:3]))
    for b in batches[3:5]:
        q, t, _ = step(q, t, t_loop.batch_to_device(b, cuda_device))
    q, t, _ = runner(q, t, t_loop.stack_batches(batches[5:]))
    got, want = dict(_paths((q, t))), dict(_paths((p, s)))
    assert sorted(got, key=str) == sorted(want, key=str)
    assert all(torch.equal(got[k], w) for k, w in want.items())
    if not donate:
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(_paths((params, state)), _paths(kept)))


# --------------------------------------------------------------------- #
# MKOR-H captured across its flip, and checkpoints of CUDA tensors
# --------------------------------------------------------------------- #
HYBRID_CASES = {"kernels-rank1": dict(use_kernels=True),
                "plain-staleness1": dict(staleness=1)}


def _hybrid_setup(device, kw, steps):
    """The reduced bert-large on the card under mkor_h(lamb) at inv_freq 3
    with min steps 3 and threshold 1 (the switch turns off at count 4)."""
    from repro_torch.configs import bert_large
    from repro_torch.core import firstorder
    from repro_torch.core.mkor import MKORConfig, mkor_h
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as t_loop
    cfg = bert_large.CONFIG.reduced()
    opt = mkor_h(firstorder.lamb(1e-3), MKORConfig(
        inv_freq=3, hybrid_min_steps=3, hybrid_threshold=1.0, **kw))
    params = model_lib.init_params(cfg, seed=0, device=device)
    ds = pipeline.make_dataset(cfg, global_batch=2, seq_len=16, seed=0)
    batches = [pipeline.make_batch(ds, i) for i in range(steps)]
    return t_loop.make_train_step(cfg, opt), params, opt.init(params), \
        batches


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_cuda_mkor_h_replays_equal_eager_across_the_flip(cuda_device, case):
    """12 steps in chunks of 3: the switch turns off at count 4, inside
    the second chunk.  Every replay equals the eager step from the same
    state (:func:`_replay_vs_eager`; the eager step reads the switch, so
    after the flip it takes the route with no second-order work while the
    replays of that chunk take the masked one); the replays of the chunks
    after it credit no launch of the port's kernels; 4 graphs (a residue
    each while the switch may be on, one once it is off)."""
    from repro_torch.training import loop as t_loop
    from repro_torch.tree import tree_map
    kw = HYBRID_CASES[case]
    kernels = kw.get("use_kernels", False)
    step, params, state, batches = _hybrid_setup(cuda_device, kw, 12)
    runner = t_loop.make_chunk_runner(step)
    replay, credited = runner._replay, []

    def checked_replay(g):
        p, s, b = tree_map(torch.clone, (*runner._tree_at(runner.host),
                                         runner._batch))
        mark = build.count_mark()
        ep, es, em = step(p, s, b)
        build.rewind_counts(mark)
        replay(g)
        after = [h + d for h, d in zip(runner.host, g.delta)]
        metrics = dict(zip(runner._keys, runner._metrics))
        _replay_vs_eager((*runner._tree_at(after), metrics),
                         (ep, es, {k: em[k].float() for k in runner._keys}),
                         kernels, (p, s))
        credited.append((int(s["count"]), dict(g.counts[0])))

    runner._replay = checked_replay
    _, state_out, hist = t_loop.train_epoch(step, params, state, batches,
                                            chunk=3, runner=runner)
    assert len(runner.graphs) == 4 and len(credited) == 8
    assert (None, ()) in runner.graphs
    assert not bool(state_out["hybrid"]["on"])
    assert int(state_out["count"]) == 12
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    for count, c in credited:
        if count >= 6:
            assert not any(c.values()), (count, c)
        elif kernels:
            assert c.get("fused_smw", 0) and c.get("fused_precond", 0), \
                (count, c)


@pytest.mark.cuda
def test_cuda_checkpoint_restores_on_the_card_and_the_cpu(cuda_device,
                                                          tmp_path):
    """A checkpoint of CUDA tensors (an MKOR-H state after 5 steps, its
    switch off) restores equal onto the card and onto the CPU; the step
    counts come back as 0-d int32 CPU tensors."""
    from repro_torch import checkpointing
    from repro_torch.training import loop as t_loop
    from repro_torch.tree import tree_leaves, tree_map
    step, params, state, batches = _hybrid_setup(
        cuda_device, dict(use_kernels=True), 5)
    for b in batches:
        params, state, _ = step(params, state,
                                t_loop.batch_to_device(b, cuda_device))
    tree = (params, state)
    checkpointing.save(str(tmp_path), 4, tree, {"step": 4})
    on_card, meta, at = checkpointing.restore_latest_valid(str(tmp_path),
                                                           tree)
    assert at == 4 and meta == {"step": 4}
    cpu_like = tree_map(lambda t: t.cpu(), tree)
    on_cpu, _ = checkpointing.restore(str(tmp_path), 4, cpu_like)
    for a, b, c in zip(tree_leaves(on_card), tree_leaves(tree),
                       tree_leaves(on_cpu)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b) and torch.equal(c, b.cpu())
    assert on_card[1]["count"].device.type == "cpu"
    assert on_card[1]["count"].dtype == torch.int32
    assert not bool(on_card[1]["hybrid"]["on"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_cuda_first_order_chunks_equal_the_per_step_loop(cuda_device, name):
    """``sgd`` without momentum (its state's ``mu`` is ``None``) and
    ``adamw`` captured through the chunk runner, 5 steps in chunks of 2:
    the per-step loop's bits, one graph (their branch key is ``()``)."""
    from repro_torch.configs import bert_large
    from repro_torch.core import firstorder, schedule
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as t_loop
    cfg = bert_large.CONFIG.reduced()
    lr = schedule.warmup_cosine(1e-2, 2, 5)
    opt = firstorder.sgd(lr) if name == "sgd" else firstorder.adamw(lr)
    step = t_loop.make_train_step(cfg, opt)
    params = model_lib.init_params(cfg, seed=0, device=cuda_device)
    ds = pipeline.make_dataset(cfg, global_batch=2, seq_len=16, seed=0)
    batches = [pipeline.make_batch(ds, i) for i in range(5)]
    p, s = params, opt.init(params)
    for b in batches:
        p, s, _ = step(p, s, t_loop.batch_to_device(b, cuda_device))
    runner = t_loop.make_chunk_runner(step, donate=False)
    q, t, _ = t_loop.train_epoch(step, params, opt.init(params), batches,
                                 chunk=2, runner=runner)
    assert len(runner.graphs) == 1
    got, want = dict(_paths((q, t))), dict(_paths((p, s)))
    assert sorted(got, key=str) == sorted(want, key=str)
    assert all(torch.equal(got[k], w) for k, w in want.items())
    if name == "sgd":
        assert t["mu"] is None


# --------------------------------------------------------------------- #
# The health sentinel and the chaos harness on the card
# --------------------------------------------------------------------- #
HEALTH_CASES = {"kernels-rank2": dict(use_kernels=True, rank=2),
                "kernels-int8-rank1": dict(use_kernels=True,
                                           factor_quant="int8")}


def _health_setup(device, kw, steps, health=True, chaos=None):
    """The reduced bert-large on the card, mkor(lamb) at inv_freq 3 with
    ``health``, wrapped by ``chaotic`` with the injections ``chaos``
    ((site, step), ...) when given; ``steps`` numpy batches."""
    from repro_torch.configs import bert_large
    from repro_torch.core import firstorder
    from repro_torch.core.mkor import MKORConfig, mkor
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.training import chaos as t_chaos
    from repro_torch.training import loop as t_loop
    cfg = bert_large.CONFIG.reduced()
    mcfg = MKORConfig(inv_freq=3, health=health, **kw)
    opt = mkor(firstorder.lamb(1e-3), mcfg)
    if chaos:
        plan = t_chaos.ChaosPlan(tuple(t_chaos.Injection(site=s, step=i)
                                       for s, i in chaos))
        opt = t_chaos.chaotic(opt, plan, mcfg)
    params = model_lib.init_params(cfg, seed=0, device=device)
    ds = pipeline.make_dataset(cfg, global_batch=2, seq_len=16, seed=0)
    batches = [pipeline.make_batch(ds, i) for i in range(steps)]
    return t_loop.make_train_step(cfg, opt), params, opt.init(params), \
        batches


def _is_reset(bank):
    for side in ("l", "r"):
        q = bank[f"{side}_inv"]
        eye = torch.eye(q.shape[-1], device=q.device)
        eye = (eye * 127 if q.dtype == torch.int8 else eye).to(q.dtype)
        if not torch.equal(q, eye.expand(q.shape)):
            return False
        if f"{side}_scale" in bank:
            sc = bank[f"{side}_scale"]
            if not torch.equal(sc, torch.full_like(sc, 1.0 / 127)) or \
                    bank[f"{side}_ef"].any():
                return False
    return True


@pytest.mark.cuda
def test_cuda_health_signals_propagate_nan(cuda_device):
    """The sentinel's max|x| (``vector_norm(inf)``) is NaN with a NaN and
    inf with an inf on the card, in fp32 and bf16, at a size that takes a
    multi-block reduction, so it alone says whether every element is
    finite."""
    from repro_torch.core import mkor as t_mkor
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((3, 1024, 1024), device=cuda_device).to(dtype)
        assert torch.isfinite(t_mkor._absmax(x))
        for val in (float("nan"), float("inf"), float("-inf")):
            y = x.clone()
            y[2, 1000, 77] = val
            m = t_mkor._absmax(y)
            assert not torch.isfinite(m) and \
                bool(t_mkor._any_nonfinite([x, y]))
            assert bool(~(m <= 200.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_cuda_health_clean_step_and_injected_trip(cuda_device, case):
    """A clean step with health on equals the step with it off from the
    same state (banks and windows bit for bit; params and LAMB's moments
    within the replay bound, fused_precond's atomics); then grad_nan at
    count 1 (off-phase for the first bucket) trips that bucket alone,
    resets its banks to the exact identity (int8: codes 127·I, scale
    1/127, error feedback 0) and arms its cooldown."""
    kw = HEALTH_CASES[case]
    from repro_torch.training import loop as t_loop
    step_on, params, s_on, batches = _health_setup(cuda_device, kw, 3)
    step_off, _, s_init, _ = _health_setup(cuda_device, kw, 3, health=False)
    b0 = t_loop.batch_to_device(batches[0], cuda_device)
    p_on, s_on, _ = step_on(params, s_on, b0)
    p_off, s_off, _ = step_off(params, s_init, b0)
    for key in ("factor_banks", "stat_windows"):
        if key in s_off:
            got, want = dict(_paths(s_on[key])), dict(_paths(s_off[key]))
            assert all(torch.equal(got[k], w) for k, w in want.items()), key
    assert all(int(h["trips"]) == 0 for h in s_on["health"].values())
    _replay_vs_eager((p_on, {k: v for k, v in s_on.items()
                             if k != "health"}, {}),
                     (p_off, s_off, {}), True, (params, s_init))
    step, params, state, batches = _health_setup(
        cuda_device, kw, 3, chaos=(("grad_nan", 1),))
    for i, b in enumerate(batches[:2]):
        params, state, m = step(params, state,
                                t_loop.batch_to_device(b, cuda_device))
        assert torch.isfinite(m["loss"]), i
    target = sorted(state["health"])[0]
    for bid, h in state["health"].items():
        assert int(h["trips"]) == (bid == target), bid
    assert int(state["health"][target]["cooldown"]) == 2
    assert _is_reset(state["factor_banks"][target])
    if "stat_windows" in state:
        for k, t in state["stat_windows"][target].items():
            assert not t.any(), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_cuda_health_replays_through_a_trip_equal_eager(cuda_device, case):
    """grad_nan at count 4 and factor_inf at count 5 (int8: grad_nan
    twice), 9 steps in chunks of 3 through the chunk runner: every replay
    equals the eager step from the same state, the trips land on their
    steps, and one graph a residue (the hits ride plan scalars)."""
    from repro_torch.training import loop as t_loop
    from repro_torch.tree import tree_map
    kw = HEALTH_CASES[case]
    second = "grad_nan" if kw.get("factor_quant") == "int8" else \
        "factor_inf"
    step, params, state, batches = _health_setup(
        cuda_device, kw, 9, chaos=(("grad_nan", 4), (second, 5)))
    runner = t_loop.make_chunk_runner(step)
    replay, trips = runner._replay, {}

    def checked_replay(g):
        p, s, b = tree_map(torch.clone, (*runner._tree_at(runner.host),
                                         runner._batch))
        mark = build.count_mark()
        ep, es, em = step(p, s, b)
        build.rewind_counts(mark)
        replay(g)
        after = [h + d for h, d in zip(runner.host, g.delta)]
        got_p, got_s = runner._tree_at(after)
        metrics = dict(zip(runner._keys, runner._metrics))
        _replay_vs_eager((got_p, got_s, metrics),
                         (ep, es, {k: em[k].float() for k in runner._keys}),
                         True, (p, s))
        trips[int(s["count"])] = sum(int(h["trips"])
                                     for h in got_s["health"].values())

    runner._replay = checked_replay
    _, state_out, hist = t_loop.train_epoch(step, params, state, batches,
                                            chunk=3, runner=runner)
    assert len(runner.graphs) == 3 and len(trips) == 6
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    assert trips[4] == 1 and trips[5] == 2 and trips[8] == 2, trips


# ----------------------------------------------------------------------- #
# The model zoo: the SMW bodies at the widest factor dim (starcoder2's
# 24576: a bf16 row is 48 KB, over the bulk path's 32 KB tile, so the
# kernel loads it element by element), and the MoE layer's bits
# ----------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("kind", SMW_KINDS)
def test_cuda_smw_at_the_widest_zoo_dim(cuda_device, kind):
    """fused_smw and fused_block_smw (r = 4, full and empty windows) on a
    (2, 24576, 24576) bank against their plain versions, each a second
    time for the same bits."""
    b, d = 2, 24576
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    if kind == "int8":
        j, sc = _int8_bank(b, d, gen, cuda_device)
    else:
        j = torch.eye(d, device=cuda_device, dtype=getattr(torch, kind))
        j = j.expand(b, d, d).contiguous()
        noise = 0.01 * torch.randn((d, d), generator=gen,
                                   device=cuda_device)
        j[0] += noise.to(j.dtype)
        del noise
        sc = None
    rel, floor = _smw_tol(kind)
    v = torch.randn((b, d), generator=gen, device=cuda_device)
    got = t_rk.fused_smw(j, v, gamma=0.9, scale=sc)
    assert _within(got, t_rk.fused_smw_plain(j, v, gamma=0.9, scale=sc),
                   rel, floor)
    assert torch.equal(t_rk.fused_smw(j, v, gamma=0.9, scale=sc), got)
    del got
    r = 4
    n = torch.tensor([r, 0], device=cuda_device)
    sq, gm = block_weights(n, r, 0.9)
    vt = (torch.randn((b, r, d), generator=gen, device=cuda_device)
          * sq[..., None]).contiguous()
    got = t_rk.fused_block_smw(j, vt, gm, scale=sc)
    assert _within(got, t_rk.fused_block_smw_plain(j, vt, gm, scale=sc),
                   rel, floor)
    base = j[1] if sc is None else j[1].float() * sc[1]
    assert torch.equal(got[1], base)              # the empty window
    assert torch.equal(t_rk.fused_block_smw(j, vt, gm, scale=sc), got)


@pytest.mark.cuda
@pytest.mark.parametrize("per_expert", [False, True])
def test_cuda_moe_layer_repeats_bit_for_bit(cuda_device, per_expert):
    """The MoE layer's forward and backward twice from one state give the
    same bits (the dispatch's backward and the combine add in a fixed
    order: models/moe.py), at qwen2-moe's width (60 experts, top 4, 4
    shared) in bf16, with capacity drops."""
    import dataclasses
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.models import moe
    cfg = qwen2_moe_a2_7b.CONFIG
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, per_expert_factors=per_expert))
    gen = torch.Generator(device=cuda_device).manual_seed(30)
    p = moe.moe_init(gen, cfg, dtype=torch.bfloat16, device=cuda_device)
    x0 = torch.randn((4, 128, cfg.d_model), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    ct = torch.randn(x0.shape, generator=gen, device=cuda_device)
    runs = []
    for _ in range(2):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _flat_params(p).items()}
        x = x0.clone().requires_grad_(True)
        stats = {}
        y, aux = moe.moe_apply(_unflat(leaves), x, cfg, stats=stats)
        (torch.sum(y.float() * ct) + aux).backward()
        runs.append([y, aux, x.grad] + [leaves[k].grad for k in
                                        sorted(leaves)]
                    + [v for _, v in sorted(_flat_params(stats).items())])
    assert len(runs[0]) == len(runs[1]) > 10
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _flat_params(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v
    return out


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out
