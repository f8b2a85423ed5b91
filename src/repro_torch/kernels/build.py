"""Build the CUDA kernels with ``nvcc`` at first use and bind them with
``ctypes``; count kernel launches.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so

The libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the sources and
flags, so an edited source is never served a stale build.  Missing
libraries are compiled in parallel, one ``nvcc`` process per source,
written under a temporary name and renamed into place.  Nothing here runs
at import time: the CPU tests import every module of the port on a
machine without ``nvcc``.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``;
:func:`check` raises if that is not 0.  :func:`note_launch` is the launch
counter: each wrapper calls it exactly where it launches its kernel, and
:func:`note_gemm` counts the GEMMs of ``matmul`` and ``fused_precond`` by
the core they ran on.  Both count Python calls: a CUDA graph replay calls
no wrapper, so the chunk runner credits each replay with the counts its
capture recorded (:func:`rewind_counts`, :func:`credit_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
KERNEL_SOURCES = {"rank1_smw": "rank1_smw.cu", "block_smw": "block_smw.cu",
                  "matmul": "matmul.cu", "precond": "precond.cu"}
# the train step's phase marks (``training/phases.py``): a library of their
# own, hashed alone and left out of the kernel libraries' hash
MARK_SOURCES = {"marks": "marks.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    "rank1_smw": {
        "mkor_matvec": [_P, _P, _P, _I, _I, _I, _I, _P],
        "mkor_rank1_update": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "block_smw": {
        "mkor_fused_block_smw": [_P, _P, _P, _F, _F, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _I, _I, _P, _P],
        "mkor_block_smw_work": [_I, _I, _I, _I],
        "mkor_block_smw_resident": [_I, _I, _I, _I, _I, _P],
        "mkor_block_smw_plan": [_I, _I, _I, _I, _LL, _P],
        "mkor_block_smw_ticket": [_I, _I, _I, _I, _P],
        "mkor_block_smw_bulk": [_I, _I, _I, _I],
    },
    "matmul": {
        "mkor_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _LL,
                        _LL, _LL, _I, _I, _I, _I, _I, _I, _P],
        "mkor_matmul_tma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL,
                            _I, _I, _P],
    },
    "precond": {
        "mkor_fused_precond": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _P],
        "mkor_fused_precond_tma": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _I, _I, _P],
        "mkor_fused_precond_scratch": [_I, _I, _I, _I, _I, _I],
    },
    "marks": {"repro_mark": [_I, _P]},
}

# entry points that return something other than a CUDA error code
_RESTYPES = {"mkor_block_smw_work": _LL, "mkor_fused_precond_scratch": _LL,
             "mkor_block_smw_plan": None,
             "mkor_block_smw_ticket": None}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Counter = Counter()
_GEMM_CORES: Counter = Counter()
_SMW_PATHS: Counter = Counter()
_COUNTS = (_LAUNCHES, _GEMM_CORES, _SMW_PATHS)
GEMM_CORES = ("wgmma", "wmma")


def note_launch(kernel: str) -> None:
    _LAUNCHES[kernel] += 1


def note_gemm(core: str) -> None:
    """One GEMM launched on ``core`` ("wgmma": the TMA + wgmma core of
    ``wgmma_gemm.cuh``; "wmma": ``gemm.cuh``)."""
    _GEMM_CORES[core] += 1


def note_smw_path(kernel: str, bulk: bool) -> None:
    """One SMW launch of ``kernel`` on the tile path the library reports
    it took: "bulk" (J's tiles by bulk copies) or "element"."""
    _SMW_PATHS[(kernel, "bulk" if bulk else "element")] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def gemm_core_counts() -> Dict[str, int]:
    """GEMMs launched on each core since the last reset: ``matmul`` counts
    one, ``fused_precond`` two (its first product through ``matmul``)."""
    return dict(_GEMM_CORES)


def smw_path_counts() -> Dict[Tuple[str, str], int]:
    """SMW launches since the last reset by (kernel, tile path)."""
    return dict(_SMW_PATHS)


def count_mark():
    """A copy of the launch, per-core GEMM and SMW tile-path counts, for
    :func:`rewind_counts`."""
    return tuple(Counter(c) for c in _COUNTS)


def rewind_counts(mark):
    """Set the counts back to ``mark`` and return what was counted since.
    A CUDA graph capture runs the wrappers, which count, but launches
    nothing: the chunk runner rewinds the capture's counts and credits
    them to each replay (:func:`credit_counts`)."""
    added = tuple(live - kept for live, kept in zip(_COUNTS, mark))
    for live, kept in zip(_COUNTS, mark):
        live.clear()
        live.update(kept)
    return added


def credit_counts(added) -> None:
    """Count one replay of a captured graph: the launches (GEMM cores and
    SMW tile paths) that its capture recorded."""
    for live, more in zip(_COUNTS, added):
        live.update(more)


def reset_launch_counts() -> None:
    """Set the kernel launch counts, the per-core GEMM counts and the SMW
    tile-path counts to 0."""
    for live in _COUNTS:
        live.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    if name in MARK_SOURCES:
        sources = [CSRC / MARK_SOURCES[name]]
    else:
        sources = [f for f in sorted(CSRC.glob("*.cu*"))
                   if f.name not in MARK_SOURCES.values()]
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          extra_flags: Iterable[str] = ()) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns the wall
    seconds each compile took (empty when everything was built)."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / {**KERNEL_SOURCES, **MARK_SOURCES}[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failures = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        if log.strip():
            print(f"[nvcc {n}]\n{log.rstrip()}")
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
        _LIBS[name] = lib
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer for a C entry point, or null for None."""
    return None if t is None else t.data_ptr()


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take
    it."""
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(t: torch.Tensor, name: str, kernel: str, dtypes,
                 shape=None, device=None) -> None:
    """Validate a kernel argument before its pointer goes to C."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, got "
                         f"{t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


# the C entry points' operand type codes
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def dtype_code(t: torch.Tensor) -> int:
    return DTYPE_CODES[t.dtype]


def check_scale(scale: torch.Tensor, name: str, kernel: str, batch: int,
                device) -> None:
    """An int8 operand's per-slice scales: (batch,) fp32 on ``device``."""
    check_tensor(scale, name, kernel, (torch.float32,), shape=(batch,),
                 device=device)


def rows_aligned(t: torch.Tensor, row: int) -> bool:
    """16-byte vector loads are safe: aligned base and whole rows of
    16-byte multiples."""
    vec = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and row % vec == 0
