"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one (the kernels have no
CPU mode).  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.mkor import block_weights
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
@pytest.mark.parametrize("d", [64, 1001])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_matvec_and_rank1_update_match_plain(cuda_device, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    j = (torch.eye(d, device=cuda_device) + 0.01 * torch.randn(
        (d, d), generator=gen, device=cuda_device)).to(dtype)
    v = torch.randn((d, 1), generator=gen, device=cuda_device)
    u = t_rk.matvec(j, v)
    # fp32 out, the same products summed in another order
    assert _within(u, t_rk.matvec_plain(j, v), 0.0, 1e-5)
    uu, s = t_rk.smw_vectors(j, v)
    assert torch.equal(uu, u)
    assert torch.allclose(s, torch.sum(v[:, 0] * u[:, 0]))
    coef = torch.full((1, 1), 0.37, device=cuda_device)
    got = t_rk.rank1_update(j, u / d ** 0.5, coef, gamma=0.9)
    want = t_rk.rank1_update_plain(j, u / d ** 0.5, coef, gamma=0.9)
    rel, floor = (2 ** -7, 1e-5) if dtype == torch.bfloat16 else \
        (1e-6, 1e-6)
    assert _within(got, want, rel, floor)


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,di,do", [(2, 64, 96), (3, 1001, 600),
                                     (2, 600, 1001)])
def test_cuda_fused_precond_int8_matches_plain(cuda_device, b, di, do):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    rq, rsc = _int8_bank(b, di, gen, cuda_device)
    lq, lsc = _int8_bank(b, do, gen, cuda_device)
    g = (0.01 * torch.randn((b, di, do), generator=gen,
                            device=cuda_device)).to(torch.bfloat16)
    for rescale in (True, False):
        t_ops.reset_launch_counts()
        got = t_pc.fused_precond(rq, g, lq, rescale=rescale, r_scale=rsc,
                                 l_scale=lsc)
        assert t_ops.launch_counts() == {"fused_precond[int8]": 1,
                                         "matmul": 1}
        want = t_pc.fused_precond_plain(rq, g, lq, rescale=rescale,
                                        r_scale=rsc, l_scale=lsc)
        # the fp32 first product rides the tensor cores as a bf16 hi/lo
        # pair, as on the bf16 route: 2e-4 of the largest entry
        assert float((got - want).abs().max()) <= \
            2e-4 * float(want.abs().max())
    # the first products alone: int8 codes enter exactly, the scale in
    # the epilogue; bf16 products are exact in fp32, only the order differs
    for a, b_, kw in ((rq, g, dict(a_scale=rsc)), (g, lq, dict(b_scale=lsc))):
        got = t_mm.matmul(a, b_, **kw)
        want = t_mm.matmul_plain(a, b_, **kw)
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


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
