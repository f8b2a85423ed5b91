"""Quickstart on the PyTorch port: train a tiny LLaMA-style model with MKOR.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: config
registry -> model init -> MKOR wrapping the LAMB backend (the launcher's
``build_optimizer``, the paper's setup) -> train step over the synthetic
data pipeline.  Runs on the GPU unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.train import build_optimizer
from repro_torch.models import model as model_lib
from repro_torch.training import loop as train_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # any assigned architecture works: --arch is just a registry key.
    # .reduced() gives the same family at smoke scale (2 layers, d<=256).
    cfg = registry.get_config("minicpm-2b").reduced()

    params = model_lib.init_params(cfg, seed=0, device=dev)
    print(f"{cfg.name}: {model_lib.param_count(params):,} params")

    # MKOR (Alg. 1): rank-1 curvature refreshed every 2 steps, bf16
    # factors, norm-based stabilizer -- wrapping the paper's LAMB backend.
    opt, _ = build_optimizer("mkor", 3e-3, inv_freq=2)
    step = train_lib.make_train_step(cfg, opt)

    state = opt.init(params)
    ds = pipeline.make_dataset(cfg, global_batch=8, seq_len=64)
    losses = []
    for i in range(args.steps):
        params, state, metrics = step(params, state, train_lib.batch_to_device(
            pipeline.make_batch(ds, i), dev))
        losses.append(float(metrics["loss"]))
        if i % 5 == 0:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"grad-norm {float(metrics['grad_norm']):.3f}")
    print("done — loss should have dropped by >1 nat.")
    return losses


if __name__ == "__main__":
    main()
