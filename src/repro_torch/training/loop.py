"""The train step: loss, gradients, MKOR stat plumbing, optimizer glue
(port of the per-step path of ``repro/training/loop.py``).

One step is Algorithm 1 end to end: forward (capturing E[a]) → backward
(probe gradients = E[g]) → MKOR factor update + preconditioning → backend
optimizer → parameter update.  PyTorch runs eagerly, so there is no jit;
the scan-chunked runner of the reference (``make_chunk_runner``) arrives
in a later slice (ROADMAP queue 1: the chunk runner, with CUDA-graph
capture of the step).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import firstorder
from repro_torch.core.firstorder import GradientTransformation
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy in float32.  The mean reduction is what
    makes the probe-gradient identity exact (models/layers.py)."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(labels == ignore_id, torch.zeros_like(labels), labels)
    label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - label_logit
    valid = labels != ignore_id
    return torch.sum(torch.where(valid, nll, torch.zeros_like(nll))) / \
        torch.clamp(valid.sum(), min=1).float()


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host numpy batch → tensors on ``device`` (token ids as int64)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device).long()
            for k, v in batch.items()}


def make_loss_fn(cfg: ModelConfig, *, collect_stats: bool = True) -> Callable:
    def loss_fn(params, batch):
        logits, aux = model_lib.forward(params, cfg, batch,
                                        collect_stats=collect_stats)
        loss_lm = lm_loss(logits, batch["labels"])
        loss = loss_lm + aux["moe_aux"]
        return loss, {"stats": aux["stats"], "loss_lm": loss_lm,
                      "moe_aux": aux["moe_aux"]}
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, aux), grads)`` like ``jax.value_and_grad(has_aux=True)``:
    gradients of every parameter leaf, as a tree shaped like ``params``."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    p_req = tree_map(lambda _: next(it), params)
    loss, aux = loss_fn(p_req, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(zip(grads, live))

    def fill(_):
        g, t = next(it)
        return torch.zeros_like(t) if g is None else g
    return (loss.detach(), aux), tree_map(fill, params)


def make_train_step(cfg: ModelConfig, optimizer: GradientTransformation,
                    *, collect_stats: bool = True) -> Callable:
    loss_fn = make_loss_fn(cfg, collect_stats=collect_stats)

    def train_step(params, opt_state, batch):
        # two-phase protocol: the precompute tick consumes only carried
        # state, so it runs before the gradients exist (synchronous
        # optimizers have no precompute)
        precompute = optimizer.precompute is not None
        if precompute:
            opt_state = optimizer.precompute(opt_state, params=params)
        (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        updates, opt_state = optimizer.update(
            grads, opt_state, params=params, stats=aux["stats"], loss=loss,
            precomputed=precompute)
        params = firstorder.apply_updates(params, updates)
        metrics = {
            "loss": loss,
            "loss_lm": aux["loss_lm"].detach(),
            "moe_aux": aux["moe_aux"],
            "grad_norm": firstorder.global_norm(grads),
            "update_norm": firstorder.global_norm(updates),
        }
        return params, opt_state, metrics

    return train_step

