"""The launch plan of the persistent SMW kernel (``csrc/smw_plan.cuh``,
built here with the host's C++ compiler), held to the invariants the
kernel's waits rely on, and the rank-1 update as the r = 1 instance of the
block update, against the JAX package's oracles.  The CUDA kernel itself
runs only on a GPU (tests/test_torch_cuda.py, which also holds the plan
the kernel's own library makes, on the card's block count, to the same
invariants)."""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smw_plan_check
from repro.kernels import ref as j_ref
from repro_torch.core.stats import quant_encode
from repro_torch.kernels import rank1_smw as t_rk

torch.set_num_threads(2)

PLAN_HEADER = Path(t_rk.__file__).resolve().parents[1] / "csrc" / \
    "smw_plan.cuh"


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """smw_plan.cuh alone as a shared library, with its C entries."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler (g++ or c++) builds smw_plan.cuh"
    lib = tmp_path_factory.mktemp("smw_plan") / "smw_plan.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-DMKOR_SMW_PLAN_ENTRIES", "-o", str(lib),
                    str(PLAN_HEADER)], check=True, capture_output=True)
    return smw_plan_check.bind(ctypes.CDLL(str(lib)))


# (batch, d, kernel rank, bytes an element, resident blocks): the three
# bert-large bank shapes at ranks 4 and 1 in bf16 and int8 with two blocks
# on each of an H100's 132 SMs, fp32, ragged d, a batch of 1, and few
# blocks, which interleave the two passes early
PLANS = [(96, 1024, 4, 2, 264), (24, 1024, 4, 2, 264),
         (24, 4096, 4, 2, 264), (24, 4096, 1, 2, 396),
         (96, 1024, 1, 1, 264), (20, 1024, 8, 4, 264),
         (3, 1001, 16, 4, 264), (1, 64, 2, 2, 264),
         (7, 100, 1, 1, 1), (5, 37, 4, 2, 1)]


@pytest.mark.parametrize("batch,d,rank,item,resident", PLANS)
def test_block_plan_invariants(plan_lib, batch, d, rank, item, resident):
    """The plan and the ticket order of smw_plan.cuh hold the invariants
    of :func:`smw_plan_check.check_plan`."""
    smw_plan_check.check_plan(plan_lib, batch, d, rank, item, resident)


# every factor dim of the model zoo: qwen2-moe's experts (1408), d_model
# (2048) and shared experts (5632), rwkv6's 8960, stablelm's 13824,
# gemma2's and pixtral's 14336, mixtral's 16384, starcoder2's 24576 and
# qwen2-moe's router (60 experts: ragged)
ZOO_DIMS = [1408, 2048, 5632, 8960, 13824, 14336, 16384, 24576, 60]


@pytest.mark.parametrize("d", ZOO_DIMS)
@pytest.mark.parametrize("item", [2, 1, 4])
@pytest.mark.parametrize("rank", [1, 4])
def test_block_plan_invariants_at_zoo_dims(plan_lib, d, item, rank):
    """The plan at each zoo dim, for bf16, int8 and fp32 banks, rank 1 and
    4, a stack of 2 on an H100's two blocks an SM: the invariants of
    :func:`smw_plan_check.check_plan`; a tile is whole rows within the
    32 KB buffer, or one row when a row alone is wider (a bf16 row of
    24576 is 48 KB: the kernel then loads J element by element), and the
    kernel's per-run staging (32 rows of Vt and W) holds every run."""
    p = smw_plan_check.check_plan(plan_lib, 2, d, rank, item, 264)
    if d * item > smw_plan_check.TILE_BYTES:
        assert p["rows"] == 1
    else:
        assert p["rows"] * d * item <= smw_plan_check.TILE_BYTES
    assert p["run"] * p["rows"] <= smw_plan_check.MAX_TILE_ROWS
    assert p["tiles"] * p["rows"] >= d


def test_block_plan_tiles_shrink_with_width(plan_lib):
    """Tiles hold whole rows, at most TILE_BYTES of J (the kernel's shared
    buffer): more rows at d = 1024 than at d = 4096, where a run of tiles
    makes up the rows a block loads its operands for once; the interleaved
    passes come at the bert-large 96 x 1024² bucket."""
    wide = smw_plan_check.plan(plan_lib, 24, 4096, 4, 2, 264)
    narrow = smw_plan_check.plan(plan_lib, 96, 1024, 4, 2, 264)
    assert wide["rows"] * 4096 * 2 <= smw_plan_check.TILE_BYTES
    assert narrow["rows"] > wide["rows"]
    assert wide["run"] * wide["rows"] == narrow["run"] * narrow["rows"] == 32
    assert narrow["lag"] < 96 * narrow["runs"]
    # a row longer than the buffer still gets a plan (the kernel then
    # loads it element by element)
    assert smw_plan_check.plan(plan_lib, 2, 20000, 1, 4, 264)["rows"] == 1


def test_bulk_path_needs_16_byte_rows():
    """The bulk path only where J's and the output's rows are 16-byte
    multiples on 16-byte bases and Ṽ is 16-byte aligned (else the
    kernel's element path)."""
    j = torch.zeros((2, 8, 8), dtype=torch.bfloat16)
    vt = torch.zeros((2, 1, 8))
    assert t_rk._bulk_rows(8, j, j, vt)
    j4 = torch.zeros((2, 4, 4), dtype=torch.bfloat16)
    assert not t_rk._bulk_rows(4, j4, j4, torch.zeros((2, 1, 4)))
    flat = torch.zeros(2 * 64 + 8, dtype=torch.bfloat16)
    off = flat[1:129].view(2, 8, 8)
    assert not t_rk._bulk_rows(8, off, j, vt)
    assert not t_rk._bulk_rows(8, j, off, vt)
    assert t_rk._bulk_rows(8, flat[8:136].view(2, 8, 8), j, vt)
    q = torch.zeros((2, 16, 16), dtype=torch.int8)
    assert t_rk._bulk_rows(16, q, torch.zeros((2, 16, 16)),
                           torch.zeros((2, 1, 16)))
    q8 = torch.zeros((2, 8, 8), dtype=torch.int8)
    assert not t_rk._bulk_rows(8, q8, torch.zeros((2, 8, 8)), vt)


def _bank(rng, b, d, kind):
    """A near-identity bank in fp32 holding bf16 values, or int8 codes with
    their (b,) scales; plus the fp32 values both stand for."""
    a = rng.standard_normal((b, d, d)).astype(np.float32) * 0.3 / np.sqrt(d)
    x = np.eye(d, dtype=np.float32) + a @ a.transpose(0, 2, 1)
    if kind == "bfloat16":
        j = torch.tensor(x).to(torch.bfloat16).float()
        return j, None, j.numpy()
    q, sc = quant_encode(torch.tensor(x))
    return q, sc, (q.float() * sc[:, None, None]).numpy()


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("variant", ["paper", "exact_smw"])
def test_rank1_is_the_r1_block_update(kind, variant):
    """fused_smw launches the block kernel with Ṽ = v, γ^m = γ and a row
    weight 1 − γ: fused_block_smw_plain(j, √(1−γ)·v, γ) equals
    fused_smw_plain and the JAX oracle, in fp32 (1e-5 relative, a floor of
    1e-6 of the largest entry: the same fp32 values, rounded in another
    order)."""
    b, d, gamma = 3, 48, 0.9
    rng = np.random.default_rng(7 + len(kind) + len(variant))
    j, sc, jf = _bank(rng, b, d, kind)
    v = rng.standard_normal((b, d)).astype(np.float32)
    tv = torch.tensor(v)
    block = t_rk.fused_block_smw_plain(
        j, math.sqrt(1.0 - gamma) * tv[:, None, :],
        torch.full((b,), gamma), variant=variant, scale=sc)
    rank1 = t_rk.fused_smw_plain(j, tv, gamma=gamma, variant=variant,
                                 scale=sc)
    want = np.asarray(j_ref.smw_rank1_update_banked_ref(
        jnp.asarray(jf), jnp.asarray(v), gamma, variant), np.float32)
    tol = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    for got in (block, rank1):
        assert got.dtype == torch.float32
        err = np.abs(got.numpy() - want)
        assert np.all(err <= tol), float(np.max(err / tol))
    # the rank-1 term is far above the tolerance: dropping it fails
    scale = gamma if variant == "paper" else 1.0 / gamma
    assert np.any(np.abs(scale * jf - want) > tol)
