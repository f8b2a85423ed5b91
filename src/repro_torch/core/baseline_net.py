"""Instrumented MLP / autoencoder for the optimizer comparisons (the port
of ``repro/core/baseline_net.py``): the paper's Fig. 4 autoencoder class
of workloads, with *full* per-token statistics:

* each layer's input activations A (N, d_in), returned beside the loss;
* each layer's output gradients G (N, d_out): the gradients of the loss
  with respect to zero *argument* tensors ("eps") added to each layer's
  output, taken in the same backward pass (the argument-shaped form of
  the probe parameter, which yields only the means).

KFAC and SNGD consume the full stats; MKOR and Eva only the means.
Initialisers draw from an explicit ``torch.Generator`` and do not
reproduce JAX's numbers (tests carry the JAX init across with
``interop``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.tree import tree_leaves, tree_map


def init_mlp(gen: torch.Generator, dims: List[int], *,
             dtype=torch.float32, device=None) -> Dict:
    return {"layers": [
        layers.dense_init(gen, dims[i], dims[i + 1], dtype=dtype,
                          device=device, bias=True)
        for i in range(len(dims) - 1)]}


def init_autoencoder(gen: torch.Generator, d_in: int = 768,
                     hidden: Tuple[int, ...] = (256, 64, 256), *,
                     dtype=torch.float32, device=None) -> Dict:
    return init_mlp(gen, [d_in, *hidden, d_in], dtype=dtype, device=device)


def zero_eps(params: Dict, n: int) -> List[torch.Tensor]:
    return [torch.zeros((n, p["w"].shape[-1]), dtype=torch.float32,
                        device=p["w"].device) for p in params["layers"]]


def forward(params: Dict, x: torch.Tensor,
            eps: Optional[List[torch.Tensor]] = None,
            act: str = "tanh") -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Returns (output, each layer's input activations)."""
    acts = []
    h = x
    n_layers = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        acts.append(h)
        h = torch.matmul(h, p["w"]) + p.get("b", 0.0) \
            + p["probe"].to(h.dtype)
        if eps is not None:
            h = h + eps[i]
        if i < n_layers - 1:
            h = torch.tanh(h) if act == "tanh" else torch.relu(h)
    return h, acts


def make_loss(kind: str = "mse") -> Callable:
    def loss_fn(params, eps, batch, act="tanh"):
        y, acts = forward(params, batch["x"], eps, act=act)
        if kind == "mse":
            loss = 0.5 * torch.mean(torch.sum(torch.square(y - batch["y"]),
                                              -1))
        else:                               # softmax cross-entropy
            logp = F.log_softmax(y, -1)
            loss = -torch.mean(torch.gather(
                logp, -1, batch["y"].long()[:, None]))
        return loss, acts
    return loss_fn


def grads_and_full_stats(params, batch, *, kind="mse", act="tanh"):
    """One backward pass giving (loss, grads, stats): grads shaped like
    ``params``, and per layer the mean activation ``a`` and the full
    ``A`` and ``G`` (``stats["layers"][i]``)."""
    loss_fn = make_loss(kind)
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    p_req = tree_map(lambda _: next(it), params)
    eps = [e.requires_grad_(True)
           for e in zero_eps(params, batch["x"].shape[0])]
    loss, acts = loss_fn(p_req, eps, batch, act)
    grads = torch.autograd.grad(loss, live + eps, allow_unused=True)
    g_it = iter(zip(grads[:len(live)], live))

    def fill(_):
        g, t = next(g_it)
        return torch.zeros_like(t) if g is None else g
    stats = {"layers": [
        {"a": torch.mean(acts[i].detach(), 0),           # MKOR / Eva
         "A": acts[i].detach(),                          # KFAC / SNGD
         "G": grads[len(live) + i]}
        for i in range(len(params["layers"]))]}
    return loss.detach(), tree_map(fill, params), stats
