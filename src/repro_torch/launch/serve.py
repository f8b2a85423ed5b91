"""Serving launcher of the port (counterpart of ``repro/launch/serve.py``):
batched greedy generation, one prefill then single-token decode steps.

    python -m repro_torch.launch.serve --arch rwkv6-3b [--reduced] \\
        [--batch B] [--prompt-len S] [--n-tokens N] [--seed K] [--device cpu]

One prefill over the prompt batch (the pipeline's synthetic tokens; a
prefix VLM's patch embeddings, an encoder-decoder model's encoder frames)
builds the ring-buffer and recurrent caches (``training/serving.py``),
then ``N - 1`` decode steps each take the greedy token of the step before;
the tokens stay on the device until the end.  Random weights from
``--seed``.  Runs on the GPU unless ``--device cpu`` is given, and raises
when there is no GPU.  Prints the parameter count, the prefill time, the
cache bytes, the decode time and tokens/s (host clock up to
``torch.cuda.synchronize()`` on the GPU), the first sequence's tokens,
and fails on non-finite logits.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.training import loop as train_lib
from repro_torch.training import serving
from repro_torch.tree import tree_bytes


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--n-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    return ap.parse_args(argv)


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int,
                 device: torch.device):
    """The prompt as the reference's launcher makes it: the pipeline's
    first batch (tokens, a VLM's patch embeddings) and an encoder-decoder
    model's frames, on ``device``."""
    ds = pipeline.make_dataset(cfg, global_batch=batch, seq_len=prompt_len,
                               seed=seed)
    host = pipeline.make_batch(ds, 0)
    prompt = {"tokens": host["tokens"]}
    if "frontend_embeds" in host:
        prompt["frontend_embeds"] = host["frontend_embeds"]
    if cfg.is_encoder_decoder:
        prompt["frontend_embeds"] = pipeline.encoder_frames(cfg, batch, 0,
                                                            seed)
    return train_lib.batch_to_device(prompt, device)


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Returns the generated tokens (B, n_tokens) on the host."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    params = model_lib.init_params(cfg, seed=args.seed, device=device)
    print(f"arch={cfg.name} params={model_lib.param_count(params):,} "
          f"device={device}")
    prompt = prompt_batch(cfg, args.batch, args.prompt_len, args.seed,
                          device)
    prefill = serving.make_prefill_step(cfg, cache_extra=args.n_tokens)
    step = serving.make_serve_step(cfg)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    sync()
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    outs = [tok]
    lg = logits
    t0 = time.perf_counter()
    for _ in range(args.n_tokens - 1):
        tok, lg, cache = step(params, cache, tok)
        outs.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    gen = torch.cat(outs, dim=1).cpu().numpy()
    n_steps = args.n_tokens - 1
    print(f"prefill {args.batch}x{prompt['tokens'].shape[1]} in "
          f"{t_prefill:.3f} s, cache {tree_bytes(cache):,} bytes; decode "
          f"{n_steps} steps in {t_decode:.3f} s "
          f"({1e3 * t_decode / max(n_steps, 1):.3f} ms a step, "
          f"{n_steps * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample:", gen[0, :24].tolist())
    if not bool(torch.isfinite(lg).all()):
        raise SystemExit("non-finite logits")
    return gen


if __name__ == "__main__":
    main()
