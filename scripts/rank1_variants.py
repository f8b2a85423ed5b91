#!/usr/bin/env python3
"""Times variants of the matvec and rank1_update kernels (the launch-plan
constants of csrc/rank1_smw.cu) in turns, by device time from a cold L2
(chip_smoke.DeviceTimer), at d = 1024, 4096 and 1001 (bf16 J), beside
torch.mv and torch.addr.

    python3 scripts/rank1_variants.py default WARPS=16 UNROLL=8,BLOCKS_PER_SM=2

Each argument is a variant: ``default``, or comma-separated NAME=VALUE
overrides of the constants (WARPS, UNROLL, BLOCKS_PER_SM: kWarps,
kUnroll, kBlocksPerSm).  Each variant is a copy of src/repro_torch
under build/rank1_variants/ with its constants rewritten; it is imported
in a process of its own, which first holds the variant against the plain
versions (and its second call to the same bits), then times it.  The
variants run in the order given and again in reverse.  Needs an NVIDIA
GPU."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONSTANTS = {"WARPS": "kWarps", "UNROLL": "kUnroll",
             "BLOCKS_PER_SM": "kBlocksPerSm"}

ONE_VARIANT = r"""
import sys, torch
tree, spec = sys.argv[1], sys.argv[3]
sys.path.insert(0, tree + "/src"); sys.path.insert(1, sys.argv[2])
import chip_smoke as cs
from repro_torch.kernels import rank1_smw as rk
assert rk.__file__.startswith(tree)
gen = torch.Generator(device="cuda").manual_seed(5)
inputs = {}
for d in (1024, 4096, 1001):
    j = cs.near_identity(torch, 1, d, gen, torch.bfloat16)[0]
    v = torch.randn((d, 1), generator=gen, device="cuda")
    u = (rk.matvec_plain(j, v) / d ** 0.5).contiguous()
    coef = torch.full((1, 1), 0.37, device="cuda")
    got, want = rk.matvec(j, v), rk.matvec_plain(j, v)
    cs.require(torch.equal(rk.matvec(j, v), got) and bool(
        ((got - want).abs() <= 1e-5 * want.abs().max()).all()),
        f"[{spec}] matvec {d} disagrees with its plain version")
    got = rk.rank1_update(j, u, coef, gamma=0.9).float()
    want = rk.rank1_update_plain(j, u, coef, gamma=0.9).float()
    cs.require(torch.equal(rk.rank1_update(j, u, coef, gamma=0.9).float(),
                           got) and bool(((got - want).abs() <= 2 ** -7 *
                                          want.abs() + 1e-5).all()),
               f"[{spec}] rank1_update {d} disagrees with its plain version")
    inputs[d] = (j, v, u, coef)
timer = cs.DeviceTimer(torch)
sums = {}
for d, (j, v, u, coef) in inputs.items():
    fns = {"matvec": lambda: rk.matvec(j, v),
           "rank1_update": lambda: rk.rank1_update(j, u, coef, gamma=0.9)}
    if spec == "default":
        vb, ub = v[:, 0].to(torch.bfloat16), u[:, 0].to(torch.bfloat16)
        fns["torch.mv"] = lambda: torch.mv(j, vb)
        fns["torch.addr"] = lambda: torch.addr(j, ub, ub, beta=0.9,
                                               alpha=0.37)
    for name, fn in fns.items():
        t = timer(fn, f"{spec} {name} {d}")
        print(f"[{spec}] {name} {d}: " + ", ".join(
            f"{k} {x:.4f}" for k, x in t.items()) + " ms", flush=True)
        for k, x in t.items():
            sums[(name, k)] = sums.get((name, k), 0.0) + x
print(f"[{spec}] sum: " + "; ".join(
    f"{n} {k} {x:.4f}" for (n, k), x in sums.items()) + " ms", flush=True)
"""


def make_variant(spec):
    """A copy of src/repro_torch with the constants of ``spec`` rewritten
    in csrc/rank1_smw.cu; returns the copy's root."""
    tree = ROOT / "build" / "rank1_variants" / re.sub(r"\W", "_", spec)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", tree / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = tree / "src" / "repro_torch" / "csrc" / "rank1_smw.cu"
    text = cu.read_text()
    for kv in ([] if spec == "default" else spec.split(",")):
        name, value = kv.split("=")
        text, n = re.subn(rf"(constexpr int {CONSTANTS[name]} = )\d+;",
                          rf"\g<1>{int(value)};", text)
        if n != 1:
            raise SystemExit(f"{name}: {CONSTANTS[name]} not found once in "
                             "rank1_smw.cu")
    cu.write_text(text)
    return tree


if __name__ == "__main__":
    specs = sys.argv[1:] or ["default"]
    trees = {s: make_variant(s) for s in specs}
    for spec in specs + specs[::-1]:
        subprocess.run([sys.executable, "-c", ONE_VARIANT, str(trees[spec]),
                        str(ROOT), spec], check=True)
