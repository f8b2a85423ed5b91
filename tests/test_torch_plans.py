"""The port's Hopper kernel plans (``kernels/ops.py``
``bucket_kernel_plans``), read from ``csrc/smw_plan.cuh`` built by the
host compiler, against the reference's ``repro.kernels.ops`` dispatches
for every bucket of every config, against the invariants of
``smw_plan_check.check_plan``, and against the kernel entries a CPU step
of MKOR calls (the launches ``chip_smoke.py`` path s counts on the card)."""
import collections
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import pytest
import torch

import smw_plan_check
from repro.configs import registry as j_reg
from repro.core.mkor import MKORConfig as JCfg
from repro.core.mkor import manifest_for as j_manifest_for
from repro.kernels import ops as j_ops
from repro.models import model as j_model
from repro_torch.configs import registry as t_reg
from repro_torch.core import firstorder as t_fo
from repro_torch.core import stats as t_stats
from repro_torch.core.mkor import MKORConfig as TCfg
from repro_torch.core.mkor import manifest_for as t_manifest_for
from repro_torch.core.mkor import mkor as t_mkor
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import precond as t_pc
from repro_torch.kernels import rank1_smw as t_rk
from repro_torch.models import model as t_model

torch.set_num_threads(2)

CONFIGS = j_reg.ASSIGNED + ["bert-large"]
PLAN_HEADER = Path(t_rk.__file__).resolve().parents[1] / "csrc" / \
    "smw_plan.cuh"
RESIDENT = 264                 # two blocks on each of an H100's 132 SMs


@pytest.fixture(scope="module")
def buckets():
    """Per config: the (JAX, port) bucket pairs of the manifests of the
    shapes alone (``eval_shape``, ``meta``)."""
    out = {}
    for n in CONFIGS:
        j = jax.eval_shape(lambda n=n: j_model.init_params(
            jax.random.PRNGKey(0), j_reg.get_config(n)))
        t = t_model.init_params(t_reg.get_config(n), device="meta")
        jm, tm = list(j_manifest_for(j, JCfg())), list(t_manifest_for(
            t, TCfg()))
        assert [b.bucket_id for b in jm] == [b.bucket_id for b in tm]
        out[n] = list(zip(jm, tm))
    return out


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler (g++ or c++) builds smw_plan.cuh"
    lib = tmp_path_factory.mktemp("smw_plan") / "smw_plan.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-DMKOR_SMW_PLAN_ENTRIES", "-o", str(lib),
                    str(PLAN_HEADER)], check=True, capture_output=True)
    lib = smw_plan_check.bind(ctypes.CDLL(str(lib)))
    lib.mkor_block_smw_work.argtypes = [ctypes.c_int] * 4
    lib.mkor_block_smw_work.restype = ctypes.c_longlong
    lib.mkor_block_smw_bulk.argtypes = [ctypes.c_int] * 4
    return lib


def test_plans_raise_without_their_library():
    with pytest.raises(RuntimeError, match="smw_plan"):
        t_ops.bucket_kernel_plans(64, 128)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("rank,quant", [(1, "none"), (4, "none"),
                                        (1, "int8"), (4, "int8")])
def test_plans_follow_the_reference_dispatches(buckets, plan_lib, name, rank,
                                               quant):
    checked = functools.lru_cache(maxsize=None)(
        lambda *a: smw_plan_check.check_plan(plan_lib, *a))
    for jb, tb in buckets[name]:
        ref = j_ops.bucket_kernel_plans(jb.d_in, jb.d_out, rank=rank,
                                        factor_quant=quant)
        got = t_ops.bucket_kernel_plans(
            tb.d_in, tb.d_out, rank=rank, factor_quant=quant,
            batch=t_stats.bucket_slices(tb), extra=tb.extra,
            libs={"block_smw": plan_lib}, resident=RESIDENT)
        assert [p.kernel.split("[")[0] for p in got] == \
            [p.kernel for p in ref]
        assert [p.dims for p in got] == [p.dims for p in ref]
        item = 1 if quant == "int8" else 2
        for p, r in zip(got[:2], ref[:2]):
            # the reference pads the window rank to 8 rows, the card's
            # kernel to its next instance
            assert p.window_rank == rank
            assert r.rank == (-(-rank // 8) * 8 if rank > 1 else 1)
            assert p.rank == next(k for k in t_rk.BLOCK_RANKS if k >= rank)
            assert p.plan == checked(p.batch, p.dims[0], p.rank, item,
                                     RESIDENT)
            assert p.bulk == (p.plan["rows"] * p.dims[0] * item
                              <= smw_plan_check.TILE_BYTES)
            assert p.scratch_bytes == 4 * plan_lib.mkor_block_smw_work(
                p.dims[0], p.batch, p.rank, item) + 4 * (1 + 2 * p.batch)
        pre = got[2]
        if tb.extra:
            assert pre.fallback == ("fused_precond", "extra_dims")
        else:
            f = torch.int8 if quant == "int8" else torch.bfloat16
            assert pre.core == t_pc.precond_route(
                f, torch.bfloat16, f, tb.d_in, tb.d_out, 0, 0, 0)
            assert pre.scratch_bytes is None     # no precond library here


def test_starcoder2_rows_take_the_element_path(plan_lib):
    """A bf16 row of 24576 (48 KB) overfills the 32 KB tile: the element
    path, as csrc/block_smw.cu:30-33 says; int8 rows of it fit."""
    bf16 = t_ops.bucket_kernel_plans(6144, 24576, batch=2,
                                     libs={"block_smw": plan_lib},
                                     resident=RESIDENT)
    assert [p.bulk for p in bf16[:2]] == [True, False]
    int8 = t_ops.bucket_kernel_plans(6144, 24576, batch=2,
                                     factor_quant="int8",
                                     libs={"block_smw": plan_lib},
                                     resident=RESIDENT)
    assert [p.bulk for p in int8[:2]] == [True, True]


def _count_entries(monkeypatch):
    """Count the kernel entries a CPU step calls, under the names their
    launches count as (on the CPU ``fused_precond`` runs its plain version
    whole, so its first product is not a ``matmul`` call here)."""
    calls = collections.Counter()

    def wrap(mod, fn, name):
        orig = getattr(mod, fn)

        def counted(*a, **k):
            calls[name(a, k)] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    q = "[int8]"
    wrap(t_rk, "fused_smw",
         lambda a, k: "fused_smw" + q * (k.get("scale") is not None))
    wrap(t_rk, "fused_block_smw",
         lambda a, k: "fused_block_smw" + q * (k.get("scale") is not None))
    wrap(t_pc, "fused_precond",
         lambda a, k: "fused_precond" + q * (k.get("r_scale") is not None))
    wrap(t_mm, "matmul", lambda a, k: "matmul")
    return calls


@pytest.mark.parametrize("name,rank,quant,inv_freq,steps", [
    ("bert-large", 1, "none", 3, 6), ("bert-large", 4, "none", 4, 8),
    ("bert-large", 1, "int8", 3, 6), ("qwen2-moe-a2.7b", 1, "none", 3, 6)])
def test_planned_launches_equal_the_entries_called(monkeypatch, plan_lib,
                                                   name, rank, quant,
                                                   inv_freq, steps):
    """The plans' launches over a run (every step's, and each bucket's on
    its phase steps) equal the kernel entries MKOR calls, by name, on the
    reduced config: the model path s of chip_smoke.py holds against the
    card's counted launches."""
    from repro_torch.data import pipeline
    from repro_torch.training import loop
    cfg = t_reg.get_config(name).reduced()
    params = t_model.init_params(cfg, device="cpu")
    mcfg = TCfg(inv_freq=inv_freq, rank=rank, factor_quant=quant,
                use_kernels=True)
    opt = t_mkor(t_fo.lamb(1e-3), mcfg)
    step = loop.make_train_step(cfg, opt)
    ds = pipeline.make_dataset(cfg, global_batch=2, seq_len=16)
    state = opt.init(params)
    calls = _count_entries(monkeypatch)
    t_ops.reset_fallback_counts()
    for i in range(steps):
        params, state, _ = step(params, state, loop.batch_to_device(
            pipeline.make_batch(ds, i), torch.device("cpu")))
    manifest = t_manifest_for(params, mcfg)
    plans = t_ops.manifest_kernel_plans(
        manifest, mcfg, t_ops.grad_dtypes(params, manifest),
        libs={"block_smw": plan_lib}, resident=RESIDENT)
    launches, _, fallbacks = t_ops.planned_counts(
        plans, t_stats.bucket_phases(manifest, inv_freq), inv_freq, steps)
    first = "matmul[int8 operand]" if quant == "int8" else "matmul"
    pre = "fused_precond" + ("[int8]" if quant == "int8" else "")
    launches[first] -= launches.get(pre, 0)
    assert {k: v for k, v in launches.items() if v} == dict(calls)
    assert fallbacks == t_ops.fallback_counts()
