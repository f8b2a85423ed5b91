#!/usr/bin/env python3
"""Times the SMW kernels of the PyTorch/CUDA port from one source tree at
the three bert-large bank shapes (96 x 1024², 24 x 1024², 24 x 4096²):
fused_block_smw (bf16, rank 4), fused_smw (bf16), and both on int8 codes.

    python3 scripts/smw_turns.py TREE [TREE ...]

Each TREE is a checkout (or a copy of its src/repro_torch) whose
src/repro_torch is imported in a process of its own; give the trees in
turns (parent, change, change, parent) to compare two versions on one card.
Needs an NVIDIA GPU; the helpers (inputs, CUDA-event timing) are
chip_smoke.py's."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ONE_TREE = r"""
import sys, torch
tree = sys.argv[1]
sys.path.insert(0, tree + "/src"); sys.path.insert(1, sys.argv[2])
import chip_smoke as cs
from repro_torch.kernels import rank1_smw as rk
from repro_torch.core.mkor import block_weights
assert rk.__file__.startswith(str(__import__("pathlib").Path(tree).resolve()))
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(4)
sums = [0.0] * 4
for b, d in [(96, 1024), (24, 1024), (24, 4096)]:
    j = cs.near_identity(torch, b, d, gen, torch.bfloat16)
    v = torch.randn((b, 4, d), generator=gen, device="cuda")
    sq, gm = block_weights(torch.full((b,), 4, device="cuda"), 4, 0.9)
    vt = (v * sq[..., None]).contiguous()
    v1 = v[:, 0].contiguous()
    q, sc = cs.int8_bank(torch, b, d, gen)
    ms = [cs.time_ms(torch, fn, reps=20) for fn in (
        lambda: rk.fused_block_smw(j, vt, gm),
        lambda: rk.fused_smw(j, v1, gamma=0.9),
        lambda: rk.fused_block_smw(q, vt, gm, scale=sc),
        lambda: rk.fused_smw(q, v1, gamma=0.9, scale=sc))]
    sums = [s + m for s, m in zip(sums, ms)]
    print(f"[{tree}] {b}x{d}: block r4 {ms[0]:.4f}, smw {ms[1]:.4f}, "
          f"block[int8] r4 {ms[2]:.4f}, smw[int8] {ms[3]:.4f} ms", flush=True)
    del j, v, vt, q, sc
print(f"[{tree}] sum: block r4 {sums[0]:.4f}, smw {sums[1]:.4f}, "
      f"block[int8] r4 {sums[2]:.4f}, smw[int8] {sums[3]:.4f} ms")
"""

if __name__ == "__main__":
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, "-c", ONE_TREE,
                        str(Path(tree).resolve()), str(ROOT)], check=True)
