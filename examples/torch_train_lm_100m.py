"""End-to-end example on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps with MKOR vs LAMB, with checkpointing and a
knee-point-style report.

    PYTHONPATH=src python examples/torch_train_lm_100m.py [--steps 300] \\
        [--optimizer mkor] [--device cpu]

The counterpart of ``examples/train_lm_100m.py`` on ``repro_torch``: the
same bert-large family member (12 layers, d = 768, ~100M params, fp32),
synthetic corpus, LAMB backend, factor refresh every 10 steps, the
launcher's ``build_optimizer`` (``mkor``, ``mkor_h``, ``eva``, ``lamb``).
On the GPU (the default) MKOR runs through the hand-written CUDA kernels
(the launcher's ``--use-kernels``), and the kernel launch counts are
printed at the end; ``--device cpu`` runs the plain versions.
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch import checkpointing
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.train import build_optimizer
from repro_torch.models import model as model_lib
from repro_torch.training import loop as train_lib


def build_cfg():
    """~100M-param bert-large family member (12L, d=768)."""
    base = registry.get_config("bert-large")
    return dataclasses.replace(
        base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=30522, dtype="float32",
        scan_layers=True, remat=False, vocab_pad_multiple=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--optimizer", default="mkor",
                    choices=["mkor", "mkor_h", "eva", "lamb"])
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--inv-freq", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg()
    params = model_lib.init_params(cfg, seed=0, device=dev)
    n = model_lib.param_count(params)
    print(f"model: {cfg.name}-100m  {n / 1e6:.1f}M params  "
          f"optimizer={args.optimizer}")

    opt, _ = build_optimizer(args.optimizer, args.lr, inv_freq=args.inv_freq,
                             use_kernels=dev.type == "cuda")
    step = train_lib.make_train_step(cfg, opt)
    state = opt.init(params)
    ds = pipeline.make_dataset(cfg, global_batch=args.global_batch,
                               seq_len=args.seq_len)

    ops.reset_launch_counts()
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        params, state, metrics = step(params, state, train_lib.batch_to_device(
            pipeline.make_batch(ds, i), dev))
        losses.append(float(metrics["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"({dt:.0f}s, {dt / max(i, 1):.2f}s/step)")
        if args.ckpt_dir and i > 0 and i % args.ckpt_every == 0:
            checkpointing.save(args.ckpt_dir, i, (params, state),
                               {"step": i, "loss": losses[-1]})

    assert np.isfinite(losses).all(), "diverged"
    drop = losses[0] - min(losses)
    print(f"done: loss {losses[0]:.3f} -> {min(losses):.3f} "
          f"(drop {drop:.3f} nats) in {time.time() - t0:.0f}s")
    if dev.type == "cuda":
        print(f"kernel launches: {ops.launch_counts()}, GEMM cores "
              f"{ops.gemm_core_counts()}")
    return losses


if __name__ == "__main__":
    main()
