"""Tree checkpointing: npz arrays + a msgpack structure manifest, in the
on-disk format of ``repro/checkpointing/checkpoint.py``, so a checkpoint
written by either package restores in the other.

Layout: ``<dir>/step_<N>/{manifest.msgpack, arrays.npz, COMMITTED}``.  The
leaves are flattened in JAX's order (dict keys sorted, sequences by index,
``None`` subtrees dropped) and named by JAX's ``keystr`` of their path
(``[0]['backend']['m']...``), whatever order the port's dicts keep.  The
arrays are ``a{i}`` in that order; bf16 is staged as its uint16 bit
pattern.  The manifest (through the port's own msgpack codec: the card's
machine has no ``msgpack``) holds the keys, shapes, dtypes, a CRC32 of
each staged array and free-form metadata.

Crash safety: every file lands via tmp + ``os.replace`` and the
``COMMITTED`` marker is written last, so a directory without the marker
is incomplete.  Corruption (missing marker, unreadable manifest, truncated
npz, CRC mismatch, missing array) raises :class:`CheckpointCorruptError`;
a structure mismatch against the restore target is a ``ValueError``.
:func:`restore_latest_valid` scans newest first and rolls back past
corrupt checkpoints.  Restore rebuilds each leaf on the device of the
target's leaf, so the step counts come back as 0-d int32 CPU tensors.
"""
from __future__ import annotations

import os
import re
import time
import zipfile
import zlib
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpointing import msgpack_codec

_MARKER = "COMMITTED"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory is incomplete or fails integrity checks."""


def _leaves_with_keys(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(JAX ``keystr``, leaf) in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_keys(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _map_with_keys(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(keystr, leaf)``, its own
    structure (and dict order) kept."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_keys(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as its staged numpy array (bf16 as the uint16 bit pattern)
    and its dtype name."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write_atomic(path: str, payload: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def save(directory: str, step: int, tree: Any,
         metadata: Optional[Dict] = None) -> str:
    out = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(out, exist_ok=True)
    # a re-save into an existing directory first demotes it to incomplete,
    # so a crash mid-rewrite leaves no committed-but-mixed directory
    marker = os.path.join(out, _MARKER)
    if os.path.exists(marker):
        os.remove(marker)
    flat = {k: _to_numpy(t) for k, t in _leaves_with_keys(tree)}
    staged = {f"a{i}": arr for i, (arr, _) in enumerate(flat.values())}
    manifest = {
        "step": step,
        "keys": list(flat),
        "shapes": {k: list(arr.shape) for k, (arr, _) in flat.items()},
        "dtypes": {k: dtype for k, (_, dtype) in flat.items()},
        # CRC32 of each STAGED array's bytes (uint16 view for bf16)
        "crc32": {k: zlib.crc32(np.ascontiguousarray(arr).tobytes())
                  for k, (arr, _) in flat.items()},
        "metadata": metadata or {},
    }
    tmp = out + ".tmp.npz"
    np.savez(tmp, **staged)
    os.replace(tmp, os.path.join(out, "arrays.npz"))
    _write_atomic(os.path.join(out, "manifest.msgpack"),
                  msgpack_codec.packb(manifest))
    # marker last: its presence asserts every file above it is complete
    _write_atomic(marker, b"ok\n")
    return out


def _load_validated(src: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Manifest and arrays of ``src``, with integrity checks only (no
    comparison with a restore target)."""
    if not os.path.isdir(src):
        raise CheckpointCorruptError(f"{src}: no such checkpoint")
    if not os.path.exists(os.path.join(src, _MARKER)):
        raise CheckpointCorruptError(
            f"{src}: missing {_MARKER} marker (incomplete save)")
    try:
        with open(os.path.join(src, "manifest.msgpack"), "rb") as f:
            manifest = msgpack_codec.unpackb(f.read())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{src}: unreadable manifest: {e}") \
            from e
    if not isinstance(manifest, dict) or "keys" not in manifest:
        raise CheckpointCorruptError(f"{src}: malformed manifest")
    try:
        with np.load(os.path.join(src, "arrays.npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
    except (OSError, ValueError, EOFError, KeyError,
            zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(f"{src}: unreadable arrays.npz: {e}") \
            from e
    crcs = manifest.get("crc32") or {}    # absent in pre-CRC checkpoints
    for i, key in enumerate(manifest["keys"]):
        name = f"a{i}"
        if name not in arrays:
            raise CheckpointCorruptError(f"{src}: array {name} ({key}) "
                                         f"missing from arrays.npz")
        arr = arrays[name]
        if list(arr.shape) != manifest["shapes"][key]:
            raise CheckpointCorruptError(
                f"{src}: shape mismatch for {key}: stored {arr.shape} vs "
                f"manifest {manifest['shapes'][key]}")
        if key in crcs and zlib.crc32(
                np.ascontiguousarray(arr).tobytes()) != crcs[key]:
            raise CheckpointCorruptError(f"{src}: CRC32 mismatch for {key}")
    return manifest, arrays


def validate(directory: str, step: int) -> bool:
    """True iff checkpoint ``step`` is complete and passes all CRCs."""
    try:
        _load_validated(os.path.join(directory, f"step_{step:08d}"))
        return True
    except CheckpointCorruptError:
        return False


def _leaf(arr: np.ndarray, dtype: str, like: torch.Tensor,
          key: str) -> torch.Tensor:
    # the arrays np.load returned are this call's own: no copy needed
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(f"checkpoint leaf {key} is {t.dtype} "
                         f"{tuple(t.shape)}, the target's {like.dtype} "
                         f"{tuple(like.shape)}")
    return t.to(like.device)


def restore(directory: str, step: int, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like``: each leaf with ``like``'s
    leaf's dtype and shape (checked) on its device.

    Raises :class:`CheckpointCorruptError` on an incomplete or damaged
    directory and ``ValueError`` when the (intact) checkpoint's structure
    does not match ``like``."""
    src = os.path.join(directory, f"step_{step:08d}")
    manifest, arrays = _load_validated(src)
    want = [k for k, _ in _leaves_with_keys(like)]
    if want != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(want)
        raise ValueError(f"checkpoint structure mismatch; differing keys: "
                         f"{sorted(missing)[:8]} ...")
    index = {k: i for i, k in enumerate(manifest["keys"])}
    tree = _map_with_keys(
        lambda key, t: _leaf(arrays[f"a{index[key]}"],
                             manifest["dtypes"][key], t, key), like)
    return tree, manifest["metadata"]


def _steps(directory: str):
    return [int(m.group(1)) for d in os.listdir(directory)
            if (m := re.fullmatch(r"step_(\d+)", d))]


def restore_latest_valid(directory: str, like: Any, *,
                         io_retries: int = 2, io_backoff_s: float = 0.05,
                         sleep=time.sleep
                         ) -> Optional[Tuple[Any, Dict, int]]:
    """Restore the newest checkpoint that passes validation: scan
    ``step_*`` newest first, skipping any that raise
    :class:`CheckpointCorruptError`.  Returns ``(tree, metadata, step)``,
    or ``None`` when no valid checkpoint exists.  A structure mismatch
    still raises ``ValueError``.  Each candidate gets ``io_retries``
    re-reads, ``io_backoff_s * 2**attempt`` apart (``sleep`` is
    injectable), before it is declared corrupt: a transient read failure
    must not skip a good checkpoint."""
    if not os.path.isdir(directory):
        return None
    for step in sorted(_steps(directory), reverse=True):
        for attempt in range(io_retries + 1):
            try:
                tree, meta = restore(directory, step, like)
                return tree, meta, step
            except CheckpointCorruptError as e:
                if attempt < io_retries:
                    sleep(io_backoff_s * (2 ** attempt))
                    continue
                print(f"checkpoint step {step} corrupt "
                      f"(after {io_retries + 1} read attempts), "
                      f"rolling back: {e}")
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None
