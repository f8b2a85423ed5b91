"""The port's checkpoints (``repro_torch/checkpointing``) against
``repro/checkpointing``: a checkpoint written by either package restores
in the other with equal arrays (the same state written by both gives the
same manifest bytes); the port's msgpack codec against ``msgpack`` byte
for byte; the crash-safety cases of ``tests/test_data_checkpoint.py``
mirrored; and the data cursor against ``repro/data/pipeline.py``."""
import importlib
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpointing as j_ckpt
from repro.core import firstorder as j_fo
from repro.data import pipeline as j_pipe
from repro.training import chaos
from repro_torch import checkpointing as t_ckpt
from repro_torch import interop
from repro_torch.checkpointing import msgpack_codec
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.data import pipeline as t_pipe

# the shared parity helpers (tests/ is on sys.path, pytest's default
# "prepend" import mode)
from test_torch_state import _draw, _host

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")

CODEC_VALUES = {
    "scalars": [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
                2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
                -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -1.5,
                1e300, float("inf")],
    "strings": ["", "a" * 31, "a" * 32, "é" * 200, "x" * 70000,
                b"", b"\x00\xff" * 200, b"z" * 70000],
    "containers": [[], list(range(15)), list(range(16)), list(range(70000)),
                   {}, {f"k{i}": i for i in range(15)},
                   {f"k{i}": [i, {"x": None}] for i in range(16)},
                   {"nested": {"a": [1, [2, [3, {"b": b"c"}]]]}}],
    "manifest": [{"step": 7, "keys": ["[0]['a']", "[1][0]"],
                  "shapes": {"[0]['a']": [2, 3], "[1][0]": []},
                  "dtypes": {"[0]['a']": "float32", "[1][0]": "bfloat16"},
                  "crc32": {"[0]['a']": 3735928559, "[1][0]": 0},
                  "metadata": {"step": 7, "world": 1, "loss": 2.5,
                               "cursor": {"step": 8, "epoch": 0,
                                          "index": 8}}}],
}


@pytest.mark.parametrize("kind", sorted(CODEC_VALUES))
def test_codec_packs_msgpack_bytes_and_reads_them_back(kind):
    for value in CODEC_VALUES[kind]:
        want = msgpack.packb(value)
        got = msgpack_codec.packb(value)
        assert got == want, value if len(repr(value)) < 200 else kind
        back = msgpack_codec.unpackb(want)
        assert back == msgpack.unpackb(want)
        assert type(back) is type(msgpack.unpackb(want))


@pytest.mark.parametrize("data", [b"", b"\x92\x01", b"\xa5abc", b"\x00junk",
                                  b"\xc1", b"\x81\x01\x02",
                                  b"\x00garbage\xff"],
                         ids=["empty", "short-array", "short-str", "trailing",
                              "reserved", "int-key", "chaos-manifest"])
def test_codec_refuses_what_msgpack_refuses(data):
    with pytest.raises(ValueError):
        msgpack.unpackb(data)
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(data)


def test_codec_covers_only_the_manifest_types():
    """Outside the manifest's subset: an extension type (which msgpack
    reads as ``ExtType``) is refused, and numpy scalars are not packed."""
    with pytest.raises(ValueError, match="not supported"):
        msgpack_codec.unpackb(b"\xd4\x01\x02")
    with pytest.raises(TypeError):
        msgpack_codec.packb({"x": np.float32(1)})


STATES = {
    "mkor-bf16-rank2": dict(rank=2),
    "mkor_h-int8-staleness1": dict(factor_quant="int8", staleness=1,
                                   hybrid=True),
    # the health subtree, with trips: at a pivot tolerance of 1e30 every
    # inversion trips
    "mkor-health-rank2": dict(rank=2, health=True, health_pivot_tol=1e30),
    "sgd": None,
}


def _pair(kw):
    """(JAX optimizer, port optimizer): MKOR on LAMB, or plain SGD (its
    ``mu`` is ``None``)."""
    if kw is None:
        return j_fo.sgd(1e-2), t_fo.sgd(1e-2)
    cfg = dict(inv_freq=2, exclude=(), **kw)
    return (j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**cfg)),
            t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**cfg)))


def _jax_run(ae_params, kw, steps=3):
    """(params, state) of the JAX optimizer after ``steps`` updates."""
    j_opt, _ = _pair(kw)
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    js = j_opt.init(jp)
    j_update = jax.jit(lambda g, s, st: j_opt.update(
        g, s, params=jp, stats=st, loss=jnp.float32(3.0)))
    rng = np.random.default_rng(9)
    for _ in range(steps):
        grads, stats = _draw(rng, host)
        _, js = j_update(grads, js, stats)
    return jp, js


def _port_like(ae_params, kw):
    _, t_opt = _pair(kw)
    tp = interop.params_from_numpy(_host(ae_params), CPU)
    return tp, t_opt.init(tp)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("case", sorted(STATES))
def test_jax_checkpoint_restores_in_the_port(tmp_path, ae_params, case):
    """The JAX package saves (params, state); the port restores it into
    its own fresh tree: every leaf equal to ``interop`` of the same tree,
    bit for bit, dtype kept, the counts 0-d int32 on the CPU."""
    jp, js = _jax_run(ae_params, STATES[case])
    j_ckpt.save(str(tmp_path), 3, (jp, js), {"step": 3})
    like = _port_like(ae_params, STATES[case])
    tree, meta, step = t_ckpt.restore_latest_valid(str(tmp_path), like)
    assert step == 3 and meta == {"step": 3}
    want = (interop.params_from_numpy(_host(jp), CPU),
            interop.opt_state_from_numpy(_host(js), CPU))
    got_l, want_l = _leaves(tree), _leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert tree[1]["count"].dtype == torch.int32
    assert tree[1]["count"].device.type == "cpu"


@pytest.mark.parametrize("case", sorted(STATES))
def test_port_checkpoint_restores_in_jax(tmp_path, ae_params, case):
    """The port saves the same (params, state); the JAX package restores
    it with equal arrays and dtypes, and both packages' manifests of it
    are the same bytes."""
    jp, js = _jax_run(ae_params, STATES[case])
    tp = interop.params_from_numpy(_host(jp), CPU)
    ts = interop.opt_state_from_numpy(_host(js), CPU)
    t_dir, j_dir = tmp_path / "port", tmp_path / "jax"
    out = t_ckpt.save(str(t_dir), 3, (tp, ts), {"step": 3, "loss": 1.25})
    assert sorted(os.listdir(out)) == ["COMMITTED", "arrays.npz",
                                       "manifest.msgpack"]
    j_ckpt.save(str(j_dir), 3, (jp, js), {"step": 3, "loss": 1.25})
    manifest = (t_dir / "step_00000003" / "manifest.msgpack").read_bytes()
    assert manifest == (j_dir / "step_00000003" /
                        "manifest.msgpack").read_bytes()
    assert manifest == msgpack.packb(msgpack.unpackb(manifest))
    tree, meta = j_ckpt.restore(str(t_dir), 3, (jp, js))
    assert meta == {"step": 3, "loss": 1.25}
    assert jax.tree.structure(tree) == jax.tree.structure((jp, js))
    back = (interop.tree_to_numpy(tp), interop.opt_state_to_numpy(ts))
    for got, want_j, want_t in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves((jp, js)),
                                   jax.tree.leaves(back)):
        got = np.asarray(got)
        assert got.dtype == np.asarray(want_j).dtype
        np.testing.assert_array_equal(got, np.asarray(want_j))
        np.testing.assert_array_equal(np.asarray(got, np.float32)
                                      if got.dtype.name == "bfloat16"
                                      else got, want_t)


def test_port_round_trip_keeps_its_tree(tmp_path):
    """The port's own tree (dict order not sorted, lists, tuples, None)
    comes back with its structure, dtypes (bf16, bool, int8) and values."""
    tree = ({"z": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "a": [torch.ones(4, dtype=torch.bfloat16), None,
                   {"c": torch.tensor(3, dtype=torch.int32)}],
             "on": torch.tensor(True)},
            (torch.full((2, 2), -7, dtype=torch.int8), None))
    t_ckpt.save(str(tmp_path), 7, tree, {"step": 7, "loss": 1.5})
    got, meta = t_ckpt.restore(str(tmp_path), 7, tree)
    assert meta["loss"] == 1.5
    assert list(got[0]) == ["z", "a", "on"] and got[0]["a"][1] is None
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = msgpack.unpackb(
        (tmp_path / "step_00000007" / "manifest.msgpack").read_bytes())
    assert manifest["keys"] == ["[0]['a'][0]", "[0]['a'][2]['c']",
                                "[0]['on']", "[0]['z']", "[1][0]"]
    assert manifest["dtypes"]["[0]['a'][0]"] == "bfloat16"


def test_structure_dtype_and_shape_mismatch_raise(tmp_path):
    t_ckpt.save(str(tmp_path), 0, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="structure"):
        t_ckpt.restore(str(tmp_path), 0, {"b": torch.ones(2)})
    with pytest.raises(ValueError, match="bfloat16"):
        t_ckpt.restore(str(tmp_path), 0,
                       {"a": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match=r"\(3,\)"):
        t_ckpt.restore(str(tmp_path), 0, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="structure"):
        t_ckpt.restore_latest_valid(str(tmp_path), {"z": torch.ones(2)})


def test_latest_step(tmp_path):
    assert t_ckpt.latest_step(str(tmp_path)) is None
    t_ckpt.save(str(tmp_path), 3, {"a": torch.ones(1)})
    t_ckpt.save(str(tmp_path), 12, {"a": torch.ones(1)})
    assert t_ckpt.latest_step(str(tmp_path)) == 12


# ------------------------------------------------------------------- #
# Crash safety: the cases of tests/test_data_checkpoint.py
# ------------------------------------------------------------------- #
def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16)]}


def test_missing_marker_is_corrupt(tmp_path):
    out = t_ckpt.save(str(tmp_path), 4, _tree())
    chaos.corrupt_checkpoint(str(tmp_path), 4, mode="marker")
    assert not t_ckpt.validate(str(tmp_path), 4)
    with pytest.raises(t_ckpt.CheckpointCorruptError, match="COMMITTED"):
        t_ckpt.restore(str(tmp_path), 4, _tree())
    assert out.endswith("step_00000004")


def test_truncated_arrays_is_corrupt(tmp_path):
    t_ckpt.save(str(tmp_path), 4, _tree())
    chaos.truncate_checkpoint(str(tmp_path), 4, nbytes=40)
    with pytest.raises(t_ckpt.CheckpointCorruptError):
        t_ckpt.restore(str(tmp_path), 4, _tree())
    assert not t_ckpt.validate(str(tmp_path), 4)


def test_bitflip_fails_crc(tmp_path):
    t_ckpt.save(str(tmp_path), 4, _tree())
    assert t_ckpt.validate(str(tmp_path), 4)
    chaos.corrupt_checkpoint(str(tmp_path), 4, mode="arrays")
    with pytest.raises(t_ckpt.CheckpointCorruptError):
        t_ckpt.restore(str(tmp_path), 4, _tree())


def test_corrupt_manifest(tmp_path):
    t_ckpt.save(str(tmp_path), 4, _tree())
    chaos.corrupt_checkpoint(str(tmp_path), 4, mode="manifest")
    with pytest.raises(t_ckpt.CheckpointCorruptError, match="manifest"):
        t_ckpt.restore(str(tmp_path), 4, _tree())


@pytest.mark.parametrize("damage", ["truncate", "arrays", "manifest",
                                    "marker"])
def test_port_damage_matches_the_reference_bytes(tmp_path, damage):
    """The port's checkpoint-damage functions (``training/chaos.py``) on a
    copy of one checkpoint leave the same files, byte for byte, as the
    reference's on another copy, and return the same file name."""
    import shutil
    from repro_torch.training import chaos as t_chaos
    src = tmp_path / "src"
    t_ckpt.save(str(src), 4, _tree(), {"step": 4})
    outs = []
    for name, lib in (("jax", chaos), ("port", t_chaos)):
        d = tmp_path / name
        shutil.copytree(src, d)
        path = lib.truncate_checkpoint(str(d), 4, nbytes=40) \
            if damage == "truncate" else \
            lib.corrupt_checkpoint(str(d), 4, mode=damage)
        step_dir = d / "step_00000004"
        outs.append((os.path.relpath(path, d),
                     {f: (step_dir / f).read_bytes()
                      for f in sorted(os.listdir(step_dir))}))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="unknown corrupt mode"):
        t_chaos.corrupt_checkpoint(str(tmp_path / "port"), 4, mode="other")


def test_restore_latest_valid_rolls_back_past_corruption(tmp_path):
    t_ckpt.save(str(tmp_path), 3, _tree(), {"step": 3})
    t_ckpt.save(str(tmp_path), 9, _tree(), {"step": 9})
    t_ckpt.save(str(tmp_path), 15, _tree(), {"step": 15})
    chaos.truncate_checkpoint(str(tmp_path), 15, nbytes=16)
    chaos.corrupt_checkpoint(str(tmp_path), 9, mode="marker")
    tree, meta, step = t_ckpt.restore_latest_valid(str(tmp_path), _tree())
    assert step == 3 and meta["step"] == 3
    assert torch.equal(tree["a"], _tree()["a"])


def test_restore_latest_valid_empty_and_all_corrupt(tmp_path):
    assert t_ckpt.restore_latest_valid(str(tmp_path), _tree()) is None
    assert t_ckpt.restore_latest_valid(str(tmp_path / "none"),
                                       _tree()) is None
    t_ckpt.save(str(tmp_path), 1, _tree())
    chaos.corrupt_checkpoint(str(tmp_path), 1, mode="arrays")
    assert t_ckpt.restore_latest_valid(str(tmp_path), _tree(),
                                       sleep=lambda s: None) is None


def test_restore_latest_valid_retries_transient_io(tmp_path):
    out = t_ckpt.save(str(tmp_path), 5, _tree(), {"step": 5})
    marker = os.path.join(out, "COMMITTED")
    os.rename(marker, marker + ".inflight")      # transient: heals below
    slept = []

    def heal_then_sleep(seconds):
        slept.append(seconds)
        if len(slept) == 2:
            os.rename(marker + ".inflight", marker)

    got = t_ckpt.restore_latest_valid(str(tmp_path), _tree(), io_retries=3,
                                      io_backoff_s=0.01,
                                      sleep=heal_then_sleep)
    assert got is not None and got[2] == 5
    assert slept == [0.01, 0.02]                 # exponential backoff


def test_restore_latest_valid_bounded_attempts_on_real_corruption(tmp_path):
    t_ckpt.save(str(tmp_path), 2, _tree())
    chaos.corrupt_checkpoint(str(tmp_path), 2, mode="arrays")
    slept = []
    assert t_ckpt.restore_latest_valid(str(tmp_path), _tree(), io_retries=2,
                                       io_backoff_s=0.01,
                                       sleep=slept.append) is None
    assert len(slept) == 2                       # bounded, then rollback


def test_resave_demotes_then_commits(tmp_path):
    """A save into an existing step directory rewrites it and commits it
    again; the older arrays are gone."""
    t_ckpt.save(str(tmp_path), 4, {"a": torch.zeros(2)})
    t_ckpt.save(str(tmp_path), 4, {"a": torch.ones(2)})
    got, _ = t_ckpt.restore(str(tmp_path), 4, {"a": torch.zeros(2)})
    assert torch.equal(got["a"], torch.ones(2))
    assert not any(n.endswith(".tmp") for n in os.listdir(
        tmp_path / "step_00000004"))


# ------------------------------------------------------------------- #
# The data cursor
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("step,per_epoch", [(0, 0), (13, 0), (13, 5),
                                            (10, 5), (7, -1)])
def test_cursor_matches_reference(step, per_epoch):
    want = j_pipe.cursor_for_step(step, per_epoch)
    got = t_pipe.cursor_for_step(step, per_epoch)
    assert (got.step, got.epoch, got.index) == \
        (want.step, want.epoch, want.index)
    meta = t_pipe.cursor_metadata(got)
    assert meta == j_pipe.cursor_metadata(want)
    assert msgpack.unpackb(msgpack_codec.packb(meta)) == meta
    back = t_pipe.cursor_from_metadata({"cursor": meta})
    assert (back.step, back.epoch, back.index) == (step, got.epoch,
                                                   got.index)


@pytest.mark.parametrize("meta,fallback", [
    ({"cursor": {"step": 5}}, None), ({"step": 4}, 5), (None, None),
    ({}, 9), ({"cursor": "bad"}, 2)])
def test_cursor_from_metadata_matches_reference(meta, fallback):
    want = j_pipe.cursor_from_metadata(meta, fallback_step=fallback)
    got = t_pipe.cursor_from_metadata(meta, fallback_step=fallback)
    if want is None:
        assert got is None
    else:
        assert (got.step, got.epoch, got.index) == \
            (want.step, want.epoch, want.index)
