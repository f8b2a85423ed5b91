#!/usr/bin/env python3
"""Holds the kernel and the fp32 plain version of fused_block_smw[int8]
against a float64 evaluation of the same update rounded once to fp32
(chip_smoke.block_update_f64, the yardstick of the int8 paths' bank
checks), on the int8 rank-4 path of chip_smoke.py (full-width
bert-large), at every launch on a 4096² bank.

    python3 scripts/smw_f64_probe.py

Prints, per launch, the worst |x - x64| / (1e-5 |x64| + 1e-6 max|x64|) of
the kernel and of the plain version (the bound the path's bank check holds
the kernel route to against the plain route).  Needs an NVIDIA GPU."""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import rank1_smw as rk  # noqa: E402

KERNEL = rk.fused_block_smw


def ratio(x, want):
    tol = 1e-5 * want.abs() + 1e-6 * want.abs().max()
    return float(((x.double() - want).abs() / tol).max())


def probed(j, vt, gm, *, variant="paper", with_pivot=False, out=None,
           scale=None):
    res = KERNEL(j, vt, gm, variant=variant, with_pivot=with_pivot, out=out,
                 scale=scale)
    if scale is not None and j.shape[-1] >= 4096:
        got = res[0] if with_pivot else res
        want = cs.block_update_f64(j, vt, gm, variant=variant,
                                   scale=scale).double()
        plain = rk.fused_block_smw_plain(j, vt, gm, variant=variant,
                                         scale=scale)
        print(f"{tuple(j.shape)} r={vt.shape[1]} {variant}: kernel "
              f"{ratio(got, want):.3f}, plain {ratio(plain, want):.3f} "
              "(of the bound, against float64)", flush=True)
        del want, plain
    return res


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    rk.fused_block_smw = probed
    dev = torch.device("cuda")
    cs.train_int8_rank4(torch, dev, cs.bert_large_setup(dev))
