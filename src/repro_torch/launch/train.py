"""Training launcher of the port (counterpart of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch bert-large [--reduced] \\
        --optimizer mkor --steps N --global-batch B --seq-len S \\
        --inv-freq F [--use-kernels] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given (and raises when there is
no GPU).  ``--use-kernels`` sends MKOR's banked SMW and precondition
through the hand-written CUDA kernels; it needs a CUDA device.  Prints the
per-step loss and ``done: final loss``.  Checkpointing, the chunk runner,
``mkor_h`` and the other launcher flags arrive with their slices.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from repro_torch.configs import registry
from repro_torch.core import firstorder, schedule as sched_lib
from repro_torch.core.mkor import MKORConfig, mkor
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.training import loop as train_lib


def build_optimizer(name: str, lr, *, inv_freq: int = 10,
                    use_kernels: bool = False):
    """Returns ``(optimizer, mkor_cfg)``; ``mkor_cfg`` is None for LAMB."""
    backend = firstorder.lamb(lr)
    if name == "mkor":
        mcfg = MKORConfig(inv_freq=inv_freq, use_kernels=use_kernels)
        return mkor(backend, mcfg), mcfg
    if name == "lamb":
        return backend, None
    raise ValueError(name)


def build_schedule(kind: str, peak: float, steps: int):
    if kind == "constant":
        return sched_lib.constant(peak)
    if kind == "wsd":
        return sched_lib.wsd(peak, max(steps // 10, 1),
                             max(steps * 7 // 10, 1), max(steps // 5, 1))
    if kind == "cosine":
        return sched_lib.warmup_cosine(peak, max(steps // 10, 1), steps)
    if kind == "linear":
        return sched_lib.warmup_linear(peak, max(steps // 10, 1), steps)
    raise ValueError(kind)


def main(argv: Optional[List[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--optimizer", default="mkor", choices=["mkor", "lamb"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["constant", "wsd", "cosine", "linear"])
    ap.add_argument("--inv-freq", type=int, default=10)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant of the arch")
    ap.add_argument("--use-kernels", action="store_true",
                    help="MKOR through the hand-written CUDA kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.use_kernels and device.type != "cuda":
        raise SystemExit("--use-kernels needs a CUDA device")
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    lr = build_schedule(args.schedule, args.lr, args.steps)
    opt, _ = build_optimizer(args.optimizer, lr, inv_freq=args.inv_freq,
                             use_kernels=args.use_kernels)
    params = model_lib.init_params(cfg, seed=args.seed, device=device)
    print(f"arch={cfg.name} params={model_lib.param_count(params):,} "
          f"optimizer={args.optimizer} steps={args.steps} "
          f"batch={args.global_batch}x{args.seq_len} device={device}"
          + (" kernels=cuda" if args.use_kernels else ""))

    ds = pipeline.make_dataset(cfg, global_batch=args.global_batch,
                               seq_len=args.seq_len, seed=args.seed)
    step_fn = train_lib.make_train_step(cfg, opt)
    opt_state = opt.init(params)
    t0 = time.time()
    final = float("nan")
    for step in range(args.steps):
        batch = train_lib.batch_to_device(pipeline.make_batch(ds, step),
                                          device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            final = float(metrics["loss"])
            print(f"step {step:5d} loss={final:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)")
    print(f"done: final loss {final:.4f}")
    if not np.isfinite(final):
        raise SystemExit("training diverged")
    return final


if __name__ == "__main__":
    main()
