"""The kernels' plain PyTorch versions and banked entry points (what a
kernel wrapper runs on a CPU tensor) against the JAX package's kernels in
interpret mode (``repro.kernels.ops``, as tests/test_kernels.py runs them)
and against the oracles in ``repro/kernels/ref.py``.  The CUDA kernels
themselves run only on a GPU (tests/test_torch_cuda.py)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import precond as t_pc
from repro_torch.kernels import rank1_smw as t_rk
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(2)


def _bank(rng, b, d, scale=0.3):
    a = rng.standard_normal((b, d, d)).astype(np.float32) * scale / np.sqrt(d)
    return (np.eye(d, dtype=np.float32) + a @ a.transpose(0, 2, 1))


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _jnp(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("d", [16, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_fused_smw_plain_matches_jax_kernel(d, dtype, variant):
    rng = np.random.default_rng(d)
    tdt, jdt = DT[dtype]
    j = _bank(rng, 3, d)
    v = rng.standard_normal((3, d)).astype(np.float32)
    jj = _jnp(j, jdt)
    want = j_ops.smw_rank1_update_banked(jj, jnp.asarray(v), gamma=0.9,
                                         variant=variant, interpret=True)
    want_ref = j_ref.smw_rank1_update_banked_ref(jj, jnp.asarray(v), 0.9,
                                                 variant)
    tj = _t(np.asarray(jj, np.float32), tdt)
    got = t_rk.fused_smw_plain(tj, torch.tensor(v), gamma=0.9,
                               variant=variant)
    got_ops = t_ops.smw_rank1_update_banked(tj, torch.tensor(v), gamma=0.9,
                                            variant=variant)
    got_ref = t_ref.smw_rank1_update_banked_ref(tj, torch.tensor(v), 0.9,
                                                variant)
    assert got.dtype == tdt
    # bf16 banks: one bf16 ulp (2^-8 relative, entries below 2) where a
    # rounding flips; fp32: rounding in another order
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    for w in (want, want_ref):
        for g in (got, got_ops, got_ref):
            np.testing.assert_allclose(np.asarray(w, np.float32),
                                       g.float().numpy(), rtol=tol, atol=tol)


def test_smw_single_factor_matches_jax():
    """A factor with no lead dims runs as a bank of one."""
    rng = np.random.default_rng(7)
    j = _bank(rng, 1, 24)[0]
    v = rng.standard_normal(24).astype(np.float32)
    want = j_ops.smw_rank1_update(jnp.asarray(j), jnp.asarray(v), gamma=0.8,
                                  interpret=True)
    got = t_ops.smw_rank1_update_banked(torch.tensor(j), torch.tensor(v),
                                        gamma=0.8)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="stats"):     # rank-r stats
        t_ops.smw_rank1_update_banked(torch.tensor(j)[None],
                                      torch.tensor(v)[None, None], gamma=0.8)


def test_smw_in_place_out():
    rng = np.random.default_rng(8)
    j = torch.tensor(_bank(rng, 2, 8))
    v = torch.tensor(rng.standard_normal((2, 8)).astype(np.float32))
    want = t_rk.fused_smw_plain(j, v, gamma=0.9)
    jj = j.clone()
    out = t_rk.fused_smw(jj, v, gamma=0.9, out=jj)
    assert out.data_ptr() == jj.data_ptr()
    np.testing.assert_array_equal(jj.numpy(), want.numpy())


@pytest.mark.parametrize("din,dout", [(24, 40), (40, 24), (100, 64)])
@pytest.mark.parametrize("rescale", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_precond_plain_matches_jax_kernel(din, dout, rescale, dtype):
    rng = np.random.default_rng(din * dout)
    tdt, jdt = DT[dtype]
    r, l = _bank(rng, 2, din), _bank(rng, 2, dout)
    g = rng.standard_normal((2, din, dout)).astype(np.float32)
    jr, jl, jg = _jnp(r, jdt), _jnp(l, jdt), _jnp(g, jdt)
    want = j_ops.fused_precondition_banked(jl, jr, jg, rescale=rescale,
                                           interpret=True)
    want_ref = [j_ref.fused_precondition_ref(jl[i], jr[i], jg[i],
                                             rescale=rescale)
                for i in range(2)]
    tr, tl, tg = (_t(np.asarray(x, np.float32), tdt) for x in (jr, jl, jg))
    got = t_pc.fused_precond_plain(tr, tg, tl, rescale=rescale)
    got_ops = t_ops.fused_precondition_banked(tl, tr, tg, rescale=rescale)
    got_ref = torch.stack([t_ref.fused_precondition_ref(
        tl[i], tr[i], tg[i], rescale=rescale) for i in range(2)])
    assert got.dtype == torch.float32
    # fp32 math on identical (bf16-exact) inputs: rounding in another order
    for w in (np.asarray(want), np.stack([np.asarray(x) for x in want_ref])):
        for gg in (got, got_ops, got_ref):
            np.testing.assert_allclose(w, gg.numpy(), rtol=1e-4, atol=1e-5)


def test_precond_zero_gradient_slice_stays_zero():
    rng = np.random.default_rng(9)
    r, l = torch.tensor(_bank(rng, 2, 8)), torch.tensor(_bank(rng, 2, 12))
    g = torch.zeros((2, 8, 12))
    out = t_pc.fused_precond(r, g, l)
    assert torch.all(out == 0)


def test_extra_dims_fall_back_and_match_jax():
    """Expert-style extra dims take the two-matmul fallback, counted and
    warned about, and agree with the JAX fallback."""
    rng = np.random.default_rng(10)
    r, l = _bank(rng, 2, 12), _bank(rng, 2, 20)
    g = rng.standard_normal((2, 3, 12, 20)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_ops.fused_precondition_banked(
            jnp.asarray(l), jnp.asarray(r), jnp.asarray(g), interpret=True)
    t_ops.reset_fallback_counts()
    with pytest.warns(t_ops.KernelFallbackWarning):
        got = t_ops.fused_precondition_banked(
            torch.tensor(l), torch.tensor(r), torch.tensor(g))
    assert t_ops.fallback_counts() == {("fused_precond", "extra_dims"): 1}
    t_ops.reset_fallback_counts()
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-4,
                               atol=1e-5)
    two = t_ops.two_sided_precondition(torch.tensor(l[0]),
                                       torch.tensor(r[0]),
                                       torch.tensor(g[0]))
    want_two = j_ops.two_sided_precondition(jnp.asarray(l[0]),
                                            jnp.asarray(r[0]),
                                            jnp.asarray(g[0]),
                                            interpret=True)
    np.testing.assert_allclose(np.asarray(want_two), two.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (40, 24, 56), (130, 64, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_jax_kernel(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    tdt, jdt = DT[dtype]
    a = _jnp(rng.standard_normal((m, k)), jdt)
    b = _jnp(rng.standard_normal((k, n)), jdt)
    want = j_ops.pallas_matmul(a, b, interpret=True)
    ta, tb = (_t(np.asarray(x, np.float32), tdt) for x in (a, b))
    for got in (t_mm.matmul(ta, tb), t_mm.matmul_plain(ta, tb),
                t_ref.matmul_ref(ta, tb)):
        # exact bf16/fp32 inputs, fp32 accumulation in another order
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-4,
                                   atol=1e-4)
    batched = t_mm.matmul(ta[None].expand(3, -1, -1).contiguous(), tb)
    np.testing.assert_allclose(batched[2].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_port_ref_matches_jax_ref():
    rng = np.random.default_rng(11)
    j = _bank(rng, 1, 10)[0]
    v = rng.standard_normal(10).astype(np.float32)
    g = rng.standard_normal((10, 6)).astype(np.float32)
    l = _bank(rng, 1, 6)[0]
    pairs = [
        (j_ref.matvec_ref(jnp.asarray(j), jnp.asarray(v)[:, None]),
         t_ref.matvec_ref(torch.tensor(j), torch.tensor(v)[:, None])),
        (j_ref.smw_coef_ref(jnp.asarray(2.5), 0.9, "exact_smw"),
         t_ref.smw_coef_ref(torch.tensor(2.5), 0.9, "exact_smw")),
        (j_ref.smw_rank1_update_ref(jnp.asarray(j), jnp.asarray(v), 0.9),
         t_ref.smw_rank1_update_ref(torch.tensor(j), torch.tensor(v), 0.9)),
        (j_ref.two_sided_precondition_ref(jnp.asarray(l), jnp.asarray(j),
                                          jnp.asarray(g)),
         t_ref.two_sided_precondition_ref(torch.tensor(l), torch.tensor(j),
                                          torch.tensor(g))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a GPU is refused, never
    routed to the plain version."""
    j = torch.empty((2, 8, 8), device="meta")
    v = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_rk.fused_smw(j, v, gamma=0.9)
    with pytest.raises(ValueError, match="CUDA"):
        t_pc.fused_precond(j, j, j)
    with pytest.raises(ValueError, match="CUDA"):
        t_mm.matmul(j, j)

