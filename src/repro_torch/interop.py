"""Carry the JAX package's parameter and optimizer trees into the port.

The caller turns a JAX tree into numpy first (``jax.tree.map(np.asarray,
tree)``, done in the tests, never here: the port does not import JAX) and
hands the numpy tree to :func:`params_from_numpy`, a whole optimizer
state to :func:`opt_state_from_numpy` (:func:`opt_state_to_numpy` is its
inverse), or a serving cache to :func:`cache_from_numpy` (inverse
:func:`cache_to_numpy`).  The trees keep their structure exactly: dicts,
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
    bucket id, each ``{"l_inv", "r_inv"}``, or with int8 factor state
    ``{"l_inv", "l_scale", "l_ef", "r_inv", "r_scale", "r_ef"}``: int8
    codes, fp32 scales and error feedback) → the port's banks, bit for
    bit."""
    return tree_from_numpy(banks, device)


def windows_from_numpy(windows: Any, device: DeviceLike = None) -> Any:
    """MKOR rank-r stat windows ``state["stat_windows"]`` (as numpy, keyed
    by bucket id, each ``{"a", "g", "n"}`` with ``n`` int32, plus the
    per-row fp32 ``a_scale`` / ``g_scale`` of int8 rows) → the port's
    windows.  ``pending_banks`` carry over with :func:`banks_from_numpy`."""
    return tree_from_numpy(windows, device)


def tree_to_numpy(tree: Any) -> Any:
    """Torch leaves → numpy on the host.  bf16 leaves come back as exact
    float32 (numpy has no bfloat16 without ``ml_dtypes``)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)


def opt_state_from_numpy(host_state: Any, device: DeviceLike = None) -> Any:
    """A JAX MKOR, Eva, KFAC, SNGD, LAMB, SGD or Adam optimizer state (as
    numpy; a ``chain``'s tuple of states too) → the port's state, every
    leaf copied with the reference's dtype: factor and pending banks (bf16
    or the int8 6-key sides, as :func:`banks_from_numpy`), the per-layer
    layout's ``factors`` and ``pending_factors``, stat windows
    (:func:`windows_from_numpy`; a per-layer window's count ``n`` a 0-d
    int32), ``hybrid``, the health sentinel's ``health`` counters (0-d
    int32), Eva's ``vecs`` (``seen`` a 0-d bool), KFAC's covariances and
    inverses, and the backend's moments on ``device`` (SGD's ``mu`` stays
    ``None`` without momentum); each ``count`` (the optimizer's and its
    backend's) a 0-d int32 tensor on the CPU whatever ``device`` is, as
    the port keeps it (its schedule branches on it on the host)."""
    dev = resolve_device(device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: _count_from_numpy(v) if k == "count" else walk(v)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return None if tree is None else _leaf_from_numpy(tree, dev)
    return walk(host_state)


def _count_from_numpy(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.shape != () or arr.dtype != np.int32:
        raise ValueError(f"a step count is a 0-d int32 scalar, got "
                         f"{arr.dtype} {arr.shape}")
    return torch.from_numpy(np.array(arr, copy=True))


def _tree_to_jax_numpy(tree: Any) -> Any:
    """Every leaf to numpy on the host, copied, with its dtype -- bf16
    leaves as ``ml_dtypes.bfloat16`` arrays (the numpy dtype JAX uses), bit
    for bit."""
    import ml_dtypes     # JAX's numpy dtypes: the tree goes back to JAX

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return np.array(t.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16), copy=True)
        return np.array(t.numpy(), copy=True)
    return tree_map(leaf, tree)


def opt_state_to_numpy(state: Any) -> Any:
    """The inverse of :func:`opt_state_from_numpy`: every leaf to numpy on
    the host (:func:`_tree_to_jax_numpy`), ready for
    ``jax.tree.map(jnp.asarray, ...)``."""
    return _tree_to_jax_numpy(state)


def cache_from_numpy(cache: Any, device: DeviceLike = None) -> Any:
    """A JAX serving cache (as numpy: ``{"blocks": [...], "pos"[,
    "enc_out"]}``, from the reference's prefill, decode step or
    ``init_decode_cache``) → the port's cache on ``device``, key for key,
    every leaf copied with its dtype (bf16 bit-exact); ``pos`` a 0-d int32
    tensor on ``device``, as the port's decode step keeps it."""
    pos = np.asarray(cache["pos"])
    if pos.shape != () or pos.dtype != np.int32:
        raise ValueError(f"a cache position is a 0-d int32 scalar, got "
                         f"{pos.dtype} {pos.shape}")
    return tree_from_numpy(cache, device)


def cache_to_numpy(cache: Any) -> Any:
    """The inverse of :func:`cache_from_numpy`: the port's cache as numpy
    (:func:`_tree_to_jax_numpy`), ready for ``jax.tree.map(jnp.asarray,
    ...)`` and the reference's ``decode_step``."""
    return _tree_to_jax_numpy(cache)
