"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one (the kernels have no
CPU mode).  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import matmul as t_mm
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
