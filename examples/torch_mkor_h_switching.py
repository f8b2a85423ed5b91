"""MKOR-H on the PyTorch port (§3.2): watch the hybrid controller ride
second-order convergence early, then switch to the first-order backend
when the loss-improvement rate stalls -- and show the per-step cost drop.

    PYTHONPATH=src python examples/torch_mkor_h_switching.py [--device cpu]

The counterpart of ``examples/mkor_h_switching.py`` on ``repro_torch``,
with its controller settings.  Runs on the GPU unless ``--device cpu`` is
given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import firstorder
from repro_torch.core.mkor import MKORConfig, mkor_h
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.training import loop as train_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = registry.get_config("bert-large").reduced()
    params = model_lib.init_params(cfg, seed=0, device=dev)

    opt = mkor_h(firstorder.lamb(3e-3), MKORConfig(
        inv_freq=2, hybrid_min_steps=15, hybrid_threshold=0.004,
        hybrid_ema_fast=0.8, hybrid_ema_slow=0.95))
    step = train_lib.make_train_step(cfg, opt)
    state = opt.init(params)
    ds = pipeline.make_dataset(cfg, global_batch=8, seq_len=64)

    switched_at = None
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, train_lib.batch_to_device(
            pipeline.make_batch(ds, i), dev))
        so_on = bool(state["hybrid"]["on"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if switched_at is None and not so_on:
            switched_at = i
            print(f"--- step {i}: MKOR-H switched to first-order (LAMB) ---")
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(m['loss']):.4f}  "
                  f"second-order={'ON ' if so_on else 'off'}  "
                  f"{dt * 1e3:.0f} ms/step")

    assert np.isfinite(float(m["loss"]))
    if switched_at is None:
        print(f"note: no switch in {args.steps} steps (loss still "
              "improving) — raise hybrid_threshold to see the fallback "
              "earlier.")
    else:
        print(f"switched at step {switched_at}; preconditioning cost is "
              "skipped from there on (the step reads the switch and runs "
              "no second-order work).")
    return switched_at


if __name__ == "__main__":
    main()
