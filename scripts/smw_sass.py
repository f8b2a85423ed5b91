#!/usr/bin/env python3
"""Counts the memory instructions of the SMW kernel's bert-large instances
(bf16 and int8 banks, ranks 1 and 4, bulk path) in the SASS of the built
block_smw library.

    python3 scripts/smw_sass.py

Needs the CUDA toolkit's cuobjdump and cu++filt; builds the library if it
is not built yet."""
import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build  # noqa: E402

TOOLS = Path(build.nvcc_path()).parent
WANTED = ("block_smw_kernel<__nv_bfloat16, __nv_bfloat16, 4, 1>",
          "block_smw_kernel<__nv_bfloat16, __nv_bfloat16, 1, 1>",
          "block_smw_kernel<signed char, float, 4, 1>",
          "block_smw_kernel<signed char, float, 1, 1>")
OPS = re.compile(r"\b((?:LDG|STG|LDS|STS|ATOMG|RED|UBLKCP|SYNCS)[.\w]*)")

if __name__ == "__main__":
    build.build(["block_smw"])
    lib = build._library_path("block_smw")
    sass = subprocess.run([str(TOOLS / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    names = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        plain = subprocess.run([str(TOOLS / "cu++filt"), name],
                               capture_output=True, text=True).stdout
        plain = plain.replace("(int)", "").replace("(bool)", "")
        plain = plain.replace("true", "1").replace("false", "0")
        names.append(plain.strip())
        hit = next((w for w in WANTED if w in plain), None)
        if hit:
            counts = collections.Counter(OPS.findall(func))
            print(hit, dict(sorted(counts.items())))
    if not any(w in n for w in WANTED for n in names):
        print("no instance matched; kernels:", names[:4])
