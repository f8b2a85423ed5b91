#!/usr/bin/env python3
"""Counts the memory instructions of every instance of the matvec and
rank1_update kernels (csrc/rank1_smw.cu) in the SASS of the built
rank1_smw library, and prints the registers and shared memory ptxas gives
each.

    python3 scripts/rank1_sass.py

Needs the CUDA toolkit's nvcc, cuobjdump and cu++filt."""
import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build  # noqa: E402

TOOLS = Path(build.nvcc_path()).parent
OPS = re.compile(r"\b((?:LDG|STG|LDS|STS|LDL|STL)[.\w]*)")
MODES = {"0": "aligned", "1": "per-row", "2": "scalar"}

if __name__ == "__main__":
    out = ROOT / "build" / "rank1_sass.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    ptxas = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out), str(build.CSRC / "rank1_smw.cu")],
        capture_output=True, text=True, check=True).stderr
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    sass = subprocess.run([str(TOOLS / "cuobjdump"), "-sass", str(out)],
                          capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        plain = subprocess.run([str(TOOLS / "cu++filt"), name],
                               capture_output=True, text=True).stdout
        m = re.search(r"(matvec_kernel|rank1_update_kernel)<(\w+)[^,]*, "
                      r"\(?\w*\)?(\d)>", plain)
        if m:
            counts = collections.Counter(OPS.findall(func))
            print(f"{m.group(1)}<{m.group(2)}, {MODES[m.group(3)]}>",
                  dict(sorted(counts.items())))
        else:
            print("unmatched:", plain.strip()[:120])
