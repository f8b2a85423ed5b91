"""The GEMM route and the Hopper core's arithmetic, on the CPU.

``gemm_route`` / ``precond_route`` decide, from dtypes, shape and alignment
alone, whether a product runs on the Hopper core (TMA ring + wgmma,
``csrc/wgmma_gemm.cuh``) or on the WMMA core (``csrc/gemm.cuh``);
``split_hi_lo`` states the bf16 hi/lo pair the Hopper core writes for
``fused_precond``'s fp32 intermediate; ``fused_precond_split_plain`` states
the second product's arithmetic on that pair, (T_hi @ F) + (T_lo @ F), and
is held against the JAX package's ``fused_precond`` in interpret mode (as
tests/test_torch_kernels.py runs it).  The kernels themselves run only on
a GPU (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import precond as t_pc
from repro_torch.kernels.ref import split_hi_lo

torch.set_num_threads(2)

BF, F32, I8 = torch.bfloat16, torch.float32, torch.int8

# (a dtype, b dtype, k, n, a address, b address, a / b batch strides)
# for every product at bert-large: G L⁻¹ and R⁻¹ T for the 96x1024x1024
# and 24x1024x4096 banks, R⁻¹ G and T L⁻¹ for 24x4096x1024
BERT_LARGE = [(BF, BF, 1024, 1024, 0, 256, 1024 * 1024, 1024 * 1024),
              (BF, BF, 4096, 4096, 512, 0, 1024 * 4096, 4096 * 4096),
              (BF, BF, 1024, 4096, 0, 1024, 1024 * 1024, 1024 * 4096),
              (BF, BF, 4096, 1024, 0, 0, 4096 * 4096, 4096 * 1024),
              (BF, BF, 1024, 1024, 64, 0, 4096 * 1024, 1024 * 1024)]


@pytest.mark.parametrize("case", BERT_LARGE)
def test_bert_large_products_go_to_wgmma(case):
    assert t_mm.gemm_route(*case) == "wgmma"


@pytest.mark.parametrize("case,why", [
    ((F32, BF, 1024, 1024, 0, 0, 0, 0), "fp32 A"),
    ((BF, F32, 1024, 1024, 0, 0, 0, 0), "fp32 B"),
    ((I8, BF, 1024, 1024, 0, 0, 1 << 20, 1 << 20), "int8 A"),
    ((BF, I8, 1024, 1024, 0, 0, 1 << 20, 1 << 20), "int8 B"),
    ((BF, BF, 1024, 1001, 0, 0, 0, 0), "N not a multiple of 8"),
    ((BF, BF, 1001, 1024, 0, 0, 0, 0), "K not a multiple of 8"),
    ((BF, BF, 1024, 1024, 8, 0, 0, 0), "A base not 16-byte aligned"),
    ((BF, BF, 1024, 1024, 0, 2, 0, 0), "B base not 16-byte aligned"),
    ((BF, BF, 1024, 1024, 0, 0, 1020, 0), "A batch stride"),
])
def test_other_operands_stay_on_wmma(case, why):
    assert t_mm.gemm_route(*case) == "wmma", why


@pytest.mark.parametrize("sa,sb", [(0, 96 * 136), (64 * 96, 0), (0, 0)])
def test_broadcast_operand_goes_to_wgmma(sa, sb):
    """A 2-D operand broadcast over the batch (batch stride 0) takes a 2-D
    tensor map and stays on the Hopper core."""
    assert t_mm.gemm_route(BF, BF, 96, 136, 0, 0, sa, sb) == "wgmma"


def test_route_of_tensors():
    """The route as matmul reads it from tensors: shapes, dtypes, the data
    pointers and the batch strides of its layout."""
    a = torch.zeros((3, 64, 96), dtype=BF)
    b = torch.zeros((3, 96, 136), dtype=BF)
    assert a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    assert t_mm.route_of(a, b) == "wgmma"
    assert t_mm.route_of(a[0], b) == "wgmma"           # broadcast A
    shifted = torch.zeros(3 * 64 * 96 + 1, dtype=BF)[1:].view(3, 64, 96)
    assert t_mm.route_of(shifted, b) == "wmma"         # 2-byte offset
    assert t_mm.route_of(a.float(), b) == "wmma"
    assert t_mm.route_of(a[..., :95].contiguous(), b[:, :95].contiguous()) \
        == "wmma"


@pytest.mark.parametrize("dtypes,di,do,want", [
    ((BF, BF, BF), 1024, 1024, "wgmma"),
    ((BF, BF, BF), 1024, 4096, "wgmma"),
    ((BF, BF, BF), 4096, 1024, "wgmma"),
    ((I8, BF, I8), 1024, 1024, "wmma"),
    ((BF, F32, BF), 1024, 4096, "wmma"),
    ((F32, BF, F32), 4096, 1024, "wmma"),
    ((BF, BF, BF), 1001, 600, "wmma"),
    ((BF, BF, BF), 600, 1001, "wmma"),
])
def test_precond_route(dtypes, di, do, want):
    """Both products of fused_precond on one core: the Hopper core only
    when both go there."""
    assert t_pc.precond_route(*dtypes, di, do, 0, 0, 0) == want


def test_core_argument_is_checked():
    x = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="core"):
        t_mm.matmul(x, x, core="tensor")
    with pytest.raises(ValueError, match="core"):
        t_pc.fused_precond(x, x, x, core="tensor")


def _bf16_rne_bits(x: np.ndarray) -> np.ndarray:
    """bf16 round-to-nearest-even of finite fp32 values, on their bits."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 3e4])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_hi_lo_contract(scale, seed):
    x = (np.random.default_rng(seed).standard_normal((64, 257)) * scale
         ).astype(np.float32)
    hi, lo = split_hi_lo(torch.tensor(x))
    assert hi.dtype == lo.dtype == BF
    h, lw = hi.float().numpy(), lo.float().numpy()
    np.testing.assert_array_equal(h, _bf16_rne_bits(x))
    np.testing.assert_array_equal(lw, _bf16_rne_bits(x - h))
    assert np.all(np.abs(h + lw - x) <= 2.0 ** -16 * np.abs(x))


@pytest.mark.parametrize("din,dout", [(24, 40), (40, 24), (64, 64)])
@pytest.mark.parametrize("rescale", [True, False])
def test_split_route_matches_jax_kernel(din, dout, rescale):
    """(T_hi @ F) + (T_lo @ F) in fp32, in the kernel's association, against
    the JAX package's fused_precond (interpret mode) on the same bf16
    inputs, at the kernel's bound 2e-4·max|want|."""
    rng = np.random.default_rng(din * dout + rescale)

    def bank(d):
        a = rng.standard_normal((2, d, d)) * 0.3 / np.sqrt(d)
        return np.eye(d) + a @ a.transpose(0, 2, 1)
    r, l = bank(din), bank(dout)
    g = rng.standard_normal((2, din, dout))
    jr, jl, jg = (jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                  for x in (r, l, g))
    want = np.asarray(j_ops.fused_precondition_banked(
        jl, jr, jg, rescale=rescale, interpret=True))
    tr, tl, tg = (torch.tensor(np.asarray(x, np.float32)).to(BF)
                  for x in (jr, jl, jg))
    got = t_pc.fused_precond_split_plain(tr, tg, tl, rescale=rescale)
    assert got.dtype == F32
    assert np.abs(got.numpy() - want).max() <= 2e-4 * np.abs(want).max()
    # and the split costs no more than its bound against the unsplit plain
    plain = t_pc.fused_precond_plain(tr, tg, tl, rescale=rescale).numpy()
    assert np.abs(got.numpy() - plain).max() <= 2e-4 * np.abs(plain).max()


@pytest.mark.parametrize("b,m,k,n", [(3, 24, 40, 16), (1, 130, 64, 72)])
def test_matmul_split_on_cpu_is_split_of_plain(b, m, k, n):
    rng = np.random.default_rng(m + n)
    a = torch.tensor(rng.standard_normal((b, m, k)).astype(np.float32)).to(BF)
    w = torch.tensor(rng.standard_normal((k, n)).astype(np.float32)).to(BF)
    hi, lo = t_mm.matmul_split(a, w)
    want_hi, want_lo = split_hi_lo(t_mm.matmul_plain(a, w))
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert hi.shape == (b, m, n)
