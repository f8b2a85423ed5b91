"""Carry the JAX package's parameter and optimizer trees into the port.

The caller turns a JAX tree into numpy first (``jax.tree.map(np.asarray,
tree)``, done in the tests, never here: the port does not import JAX) and
hands the numpy tree to :func:`params_from_numpy` or
:func:`banks_from_numpy`.  The trees keep their structure exactly: dicts,
lists (``params["blocks"]``), the ``probe`` leaves and the stacked leading
layer dim of ``scan_layers=True``.

Two traps this module closes:

* JAX's bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
  ``torch.from_numpy`` rejects.  They are carried bit-exactly through a
  ``uint16`` view and reinterpreted as ``torch.bfloat16``.
* ``np.asarray`` of a CPU JAX array is a zero-copy, read-only view of JAX's
  own buffer, and ``torch.from_numpy`` would share that memory.  Every
  leaf is therefore copied, so no in-place update in the port can ever
  write into a JAX array (such as a shared test fixture).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def _leaf_from_numpy(x, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), copy=True)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def tree_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Numpy (or numpy-convertible) leaves → torch tensors on ``device``
    (``None`` means ``cuda``), copied, dtypes kept (bf16 bit-exact)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_from_numpy(x, dev), tree)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """The JAX package's parameter tree (as numpy) → the port's tree."""
    return tree_from_numpy(tree, device)


def banks_from_numpy(banks: Any, device: DeviceLike = None) -> Any:
    """MKOR factor banks ``state["factor_banks"]`` (as numpy, keyed by
    bucket id, each ``{"l_inv", "r_inv"}``) → the port's banks."""
    return tree_from_numpy(banks, device)


def tree_to_numpy(tree: Any) -> Any:
    """Torch leaves → numpy on the host.  bf16 leaves come back as exact
    float32 (numpy has no bfloat16 without ``ml_dtypes``)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)
