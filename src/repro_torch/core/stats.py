"""Layer discovery, rank-1 statistic extraction and the factor-bank bucket
manifest (port of the main-path part of ``repro/core/stats.py``).

Conventions, as in the reference:

* A "dense layer" is any params sub-dict holding both ``"w"`` (ndim >= 2,
  trailing dims ``(d_in, d_out)``) and ``"probe"`` (trailing dim d_out).
* The leading dims of ``probe`` (size-1 dims stripped) are the *stack*
  dims: the scan-over-layers repeats.
* The stats tree from ``forward(collect_stats=True)`` mirrors the params
  tree with each dense dict replaced by ``{"a": E[a]}``.
* ``grads[...]["probe"]`` is exactly ``E[g]``.

The manifest is a pure function of the tree structure and the leaf shapes,
so it can be rebuilt at every ``update`` and always agrees with ``init``.
Rank-r windows, int8 storage and the owner maps of the distributed path
arrive with their slices (ROADMAP queue 1 items 12, 15, 16).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Path = Tuple[Any, ...]


def is_dense_dict(node) -> bool:
    return isinstance(node, dict) and "w" in node and "probe" in node \
        and hasattr(node["w"], "ndim") and node["w"].ndim >= 2


def iter_dense_layers(params) -> List[Path]:
    """All paths (tuples of dict keys / sequence indices) to dense dicts."""
    out: List[Path] = []

    def walk(node, path):
        if is_dense_dict(node):
            out.append(path)
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(params, ())
    return out


def tree_get(tree, path: Path):
    node = tree
    for k in path:
        if node is None:
            return None
        try:
            node = node[k]
        except (KeyError, IndexError, TypeError):
            return None
    return node


def tree_set(tree, path: Path, value):
    """Functionally replace ``tree[path]`` (dicts/lists copied on the way)."""
    if not path:
        return value
    k = path[0]
    if isinstance(tree, dict):
        new = dict(tree)
        new[k] = tree_set(tree[k], path[1:], value)
        return new
    if isinstance(tree, list):
        new = list(tree)
        new[k] = tree_set(tree[k], path[1:], value)
        return new
    if isinstance(tree, tuple):
        lst = list(tree)
        lst[k] = tree_set(tree[k], path[1:], value)
        return tuple(lst)
    raise TypeError(f"cannot set path {path} in {type(tree)}")


def path_str(path: Path) -> str:
    return "/".join(str(p) for p in path)


def stack_shape_of(probe) -> Tuple[int, ...]:
    """Stack dims = probe leading dims with broadcast 1s stripped."""
    return tuple(d for d in probe.shape[:-1] if d != 1)


def layer_dims(dense: Dict) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                     int, int]:
    """Returns (stack_shape, extra_shape, d_in, d_out) for a dense dict."""
    w, probe = dense["w"], dense["probe"]
    d_in, d_out = w.shape[-2], w.shape[-1]
    stack = stack_shape_of(probe)
    lead = tuple(w.shape[:-2])
    if lead[:len(stack)] != stack:
        raise ValueError(f"stack dims {stack} not a prefix of w lead dims "
                         f"{lead}")
    return stack, lead[len(stack):], d_in, d_out


def get_a_vec(stats, path: Path) -> Optional[torch.Tensor]:
    node = tree_get(stats, path)
    if node is None or not isinstance(node, dict) or "a" not in node:
        return None
    return node["a"]


def get_g_vec(grads, path: Path) -> Optional[torch.Tensor]:
    node = tree_get(grads, path)
    if node is None or "probe" not in node:
        return None
    probe = node["probe"]
    return probe.reshape(stack_shape_of(probe) + probe.shape[-1:])


# ----------------------------------------------------------------------- #
# Factor-bank bucket manifest
# ----------------------------------------------------------------------- #
@dataclass(frozen=True)
class FactorBucket:
    """One shape bucket: every layer with identical (stack, extra, d_in,
    d_out) signature.  ``paths`` fixes the bank slot order; ``index`` is
    the bucket's position in the sorted bucket order (the anchor of the
    staggered inversion schedule)."""
    bucket_id: str
    stack: Tuple[int, ...]
    extra: Tuple[int, ...]
    d_in: int
    d_out: int
    paths: Tuple[Path, ...]
    index: int = 0

    def phase(self, inv_freq: int) -> int:
        """This bucket inverts on steps where ``count % inv_freq == phase``."""
        return self.index % max(inv_freq, 1)

    @property
    def n_slots(self) -> int:
        return len(self.paths)

    @property
    def path_strs(self) -> Tuple[str, ...]:
        return tuple(path_str(p) for p in self.paths)


@dataclass(frozen=True)
class BucketManifest:
    buckets: Tuple[FactorBucket, ...]

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self) -> int:
        return len(self.buckets)


def bucket_id_for(stack: Tuple[int, ...], extra: Tuple[int, ...],
                  d_in: int, d_out: int) -> str:
    """Deterministic, human-readable bucket key (e.g. ``1024x1024_s24``)."""
    bid = f"{d_in}x{d_out}"
    if stack:
        bid += "_s" + "x".join(map(str, stack))
    if extra:
        bid += "_e" + "x".join(map(str, extra))
    return bid


def build_bucket_manifest(
        tree, eligible: Optional[Callable[[Path, Dict], bool]] = None,
) -> BucketManifest:
    """Group eligible dense layers of ``tree`` by shape signature: buckets
    sorted by id, slots by path string."""
    groups: Dict[Tuple, List[Path]] = {}
    for path in iter_dense_layers(tree):
        dense = tree_get(tree, path)
        if eligible is not None and not eligible(path, dense):
            continue
        stack, extra, d_in, d_out = layer_dims(dense)
        groups.setdefault((stack, extra, d_in, d_out), []).append(path)
    buckets = [FactorBucket(bucket_id=bucket_id_for(*sig), stack=sig[0],
                            extra=sig[1], d_in=sig[2], d_out=sig[3],
                            paths=tuple(sorted(paths, key=path_str)))
               for sig, paths in groups.items()]
    buckets.sort(key=lambda b: b.bucket_id)
    return BucketManifest(tuple(dataclasses.replace(b, index=i)
                                for i, b in enumerate(buckets)))


def bucket_phases(manifest: BucketManifest, inv_freq: int,
                  stagger: bool = True) -> Dict[str, int]:
    """Per-bucket inversion phases: round-robin ``i % inv_freq`` with
    ``stagger``, all 0 (the paper's spike schedule) without."""
    if not stagger:
        return {b.bucket_id: 0 for b in manifest}
    return {b.bucket_id: b.phase(inv_freq) for b in manifest}


def layer_phases(manifest: BucketManifest, inv_freq: int,
                 stagger: bool = True) -> Dict[str, int]:
    """Per-layer view of :func:`bucket_phases`: ``{path_str: phase}``."""
    phases = bucket_phases(manifest, inv_freq, stagger)
    return {ps: phases[b.bucket_id] for b in manifest for ps in b.path_strs}


def bucket_slices(bucket: FactorBucket) -> int:
    """Flattened (slot x stack) slice count of a bucket's banks."""
    n = bucket.n_slots
    for d in bucket.stack:
        n *= d
    return n


def zero_probes(tree):
    """Zero every ``probe`` leaf (probes are statistics taps, never
    updated)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (torch.zeros_like(v) if k == "probe" else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node
    return walk(tree)
