#!/usr/bin/env python3
"""Two mutants of the persistent SMW kernel (src/repro_torch/csrc/
block_smw.cu), each an edit in a throwaway copy under build/, run through
chip_smoke.py's four SMW checks (each on its own) and the SMW GPU tests.
Each must fail.

    python3 scripts/smw_mutants.py

Needs an NVIDIA GPU and nvcc."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "src/repro_torch/csrc/block_smw.cu"
PY = "src/repro_torch/kernels/rank1_smw.py"
MUTANTS = {
    # a write tile reads M and U without waiting for the slice's flag
    "write_skips_flag": [
        (CU, "for (unsigned spins = 0; ld_acquire(ready) == 0u; ++spins) {",
         "for (unsigned spins = 0; false; ++spins) {")],
    # S summed in the order the runs arrive (atomics into one zeroed slot)
    "s_in_arrival_order": [
        (CU, "a.spart[((long long)b * a.runs + st.tile0 / a.run) * R * R + e]"
             " = s;", "atomicAdd(a.spart + (long long)b * a.runs * R * R + e,"
                      " s);"),
        (CU, "for (int p = p0; p < a.runs; p += NSUB)",
         "for (int p = p0; p < 1; p += NSUB)"),
        (PY, "    work = torch.empty(", "    work = torch.zeros(")],
}
CHECKS = ("check_fused_smw", "check_fused_block_smw", "check_fused_smw_int8",
          "check_fused_block_smw_int8")

if __name__ == "__main__":
    for name, edits in MUTANTS.items():
        d = ROOT / "build" / f"mutant_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch",
                        d / "src" / "repro_torch")
        shutil.copytree(ROOT / "tests", d / "tests")
        shutil.copy(ROOT / "chip_smoke.py", d)
        for path, old, new in edits:
            text = (d / path).read_text()
            assert text.count(old) == 1, (name, old)
            (d / path).write_text(text.replace(old, new))
        for check in CHECKS:
            run = ("import sys, torch; sys.path.insert(0, 'src'); "
                   "import chip_smoke as cs; "
                   "torch.backends.cuda.matmul.allow_tf32 = False; "
                   "rows = {n: cs.KernelRow(n) for n in cs.REPLACES}; "
                   f"cs.{check}(torch, rows)")
            r = subprocess.run([sys.executable, "-c", run], cwd=d, text=True,
                               capture_output=True, timeout=900)
            last = (r.stdout + r.stderr).strip().splitlines()[-1:]
            print(f"[{name}] {check}: rc {r.returncode} {' '.join(last)}",
                  flush=True)
        t = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
             "-q", "-p", "no:cacheprovider", "-k", "smw",
             "tests/test_torch_cuda.py"], cwd=d, capture_output=True,
            text=True, timeout=900, env={**os.environ, "PYTHONPATH": "src"})
        print(f"[{name}] SMW GPU tests rc {t.returncode}: "
              f"{t.stdout.strip().splitlines()[-1]}", flush=True)
        shutil.rmtree(d, ignore_errors=True)
