"""The port's collectives (``repro_torch/sharding/collectives.py``) and
owner maps (``core/stats.py``) against the JAX package's.

The port's ranks are spawned processes joined over gloo by a ``file://``
store under ``tmp_path`` (``tests/torch_dist_worker.py``: they import
only torch and the port); the JAX functions run in this process under
``shard_map`` on the conftest's fake CPU devices, on meshes of 2 and 4.
One spawn a world runs every collective scenario."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.core import baseline_net as j_net
from repro.core import stats as j_stats
from repro.launch import mesh as mesh_lib
from repro.sharding import collectives as j_coll
from repro_torch import interop
from repro_torch.core import mkor as t_mkor
from repro_torch.core import stats as t_stats
from repro_torch.sharding import collectives as t_coll

from torch_dist_worker import run_ranks

j_mkor = importlib.import_module("repro.core.mkor")
N_SLOTS = (1, 3, 8, 11)


def _dead(world):
    """Worker 1 dead."""
    return tuple(w != 1 for w in range(world))


def _smap(fn, mesh, in_specs=(P(),)):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=P(), check_rep=False))


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_jax(tmp_path, world):
    """Each rank's flat all-reduce, rank-1 stat mean (bf16 payload and
    bit-tight), owner shard/gather round trips (both recombine strategies,
    a dead worker, int8 codes with their scales) against the JAX functions
    under shard_map; ``owner_sharded_map_quant``'s TypeError; the worker
    index (row-major over ``(("pod", 2), ("data", 2))`` at world 4); and
    the transport's refusal of a device no backend takes."""
    rng = np.random.default_rng(world)
    tree = {"w": rng.standard_normal((world, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((world, 7)).astype(np.float32)}
    stats = {"a": rng.standard_normal((world, 6)).astype(np.float32),
             "A": rng.standard_normal((world, 4, 6)).astype(np.float32)}
    res = run_ranks(tmp_path, world, [{
        "name": "c", "kind": "collectives", "tree": tree, "stats": stats,
        "n_slots": N_SLOTS, "dead_mask": _dead(world)}])
    res = [r["c"] for r in res]
    mesh = mesh_lib.make_host_mesh(world)
    dist = (("data", world),)

    want = _smap(lambda t: j_coll.all_reduce_mean_tree(t, dist), mesh,
                 (P("data"),))(tree)
    for name, pd in (("stats_bf16", "bfloat16"), ("stats_fp32", None)):
        want_s = _smap(lambda s, pd=pd: j_coll.pmean_rank1_stats(
            jax.tree.map(lambda x: x[0], s), dist, payload_dtype=pd),
            mesh, (P("data"),))({"layers": [stats]})["layers"][0]
        assert set(want_s) == {"a"}
        for r in res:
            assert set(r[name]) == {"a"}            # O(d): means only
            np.testing.assert_allclose(r[name]["a"], np.asarray(want_s["a"]),
                                       rtol=1e-6, atol=1e-7)
    for rank, r in enumerate(res):
        assert r["worker_index"] == rank
        for k in tree:
            np.testing.assert_allclose(r["all_reduce_mean"][k],
                                       np.asarray(want[k])[0], rtol=1e-6,
                                       atol=1e-7)
        assert "must be int8" in r["type_error"]
        assert "no transport" in r["bad_transport"]
    # the bf16 payload is quantized: a bf16-rounded mean, not the fp32 one
    bf = torch.from_numpy(stats["a"]).bfloat16().float().mean(0).numpy()
    np.testing.assert_allclose(res[0]["stats_bf16"]["a"], bf, rtol=1e-6)

    # world 4 with one slot takes the masked sum, 3 or more slots the
    # all-gather (the static rule, (n_live - 1)·chunk ≤ 2·n_slots)
    if world == 4:
        assert (world - 1) * t_coll.owner_chunk(1, world) > 2 * 1
    assert (world - 1) * t_coll.owner_chunk(3, world) <= 2 * 3
    for live in (None, _dead(world)):
        for n_slots in N_SLOTS:
            x = jnp.arange(n_slots * 4, dtype=jnp.float32).reshape(n_slots, 4)

            def body(v, live=live, n_slots=n_slots):
                mine = j_coll.owner_shard(v, dist, live=live)
                return j_coll.gather_shards(2.0 * mine, dist, n_slots,
                                            live=live)

            def qbody(v, live=live, n_slots=n_slots):
                return j_coll.owner_sharded_map_quant(
                    lambda c: (c.astype(jnp.int8), c[:, 0] * 0.5), [v],
                    dist, n_slots, live=live)

            got_j = np.asarray(_smap(body, mesh)(x))
            np.testing.assert_array_equal(got_j, 2.0 * np.asarray(x))
            codes_j, scales_j = _smap(qbody, mesh)(x)
            for r in res:
                np.testing.assert_array_equal(r["rounds"][(live, n_slots)],
                                              got_j)
                codes, scales = r["rounds"][("quant", live, n_slots)]
                assert codes.dtype == np.int8
                np.testing.assert_array_equal(codes, np.asarray(codes_j))
                np.testing.assert_array_equal(scales, np.asarray(scales_j))
    with pytest.raises(TypeError, match="must be int8"):
        _smap(lambda v: j_coll.owner_sharded_map_quant(
            lambda c: (c, c[:, 0]), [v], dist, 3), mesh)(
                jnp.zeros((3, 4), jnp.float32))
    if world == 4:
        pmesh = mesh_lib.make_host_mesh(2, n_pod=2)
        pd = (("pod", 2), ("data", 2))
        order = np.asarray(jax.jit(shard_map(
            lambda _: jnp.stack([j_coll.worker_index(pd),
                                 lax.axis_index("pod"),
                                 lax.axis_index("data")])[None],
            mesh=pmesh, in_specs=(P(("pod", "data")),),
            out_specs=P(("pod", "data")), check_rep=False))(
                jnp.zeros((4,))))
        for rank, r in enumerate(res):
            assert r["pod_data"] == tuple(int(v) for v in order[rank])


@pytest.mark.parametrize("world,live", [
    (1, None), (2, None), (2, (False, True)), (3, None), (3, (True, False,
                                                               True)),
    (8, None), (8, tuple(w not in (3,) for w in range(8))),
    (8, tuple(w not in (0, 7) for w in range(8))),
    (8, tuple(w not in (1, 2, 3) for w in range(8)))])
def test_live_mask_and_owner_map_match_reference(world, live):
    """``live_mask`` and ``bucket_owner_map`` give the reference's values
    for the same manifest (the autoencoder 96 → 48/48/12/48, four
    buckets), world and mask; the liveness helpers of the collectives
    likewise."""
    jp = j_net.init_autoencoder(jax.random.key(0), 96, (48, 48, 12, 48))
    tp = interop.params_from_numpy(jax.tree.map(np.array, jp),
                                   torch.device("cpu"))
    j_man = j_mkor.manifest_for(jp, j_mkor.MKORConfig(exclude=()))
    t_man = t_mkor.manifest_for(tp, t_mkor.MKORConfig(exclude=()))
    assert t_stats.live_mask(world, live) == j_stats.live_mask(world, live)
    assert t_stats.bucket_owner_map(t_man, world, live) == \
        j_stats.bucket_owner_map(j_man, world, live)
    dist = (("data", world),)
    assert t_coll.normalize_live(dist, live) == \
        j_coll.normalize_live(dist, live)
    assert t_coll.n_live(dist, live) == j_coll.n_live(dist, live)
    assert t_coll.effective_live(dist, live) == \
        j_coll.effective_live(dist, live)
    for n in (1, 3, 8, 11, 96):
        assert t_coll.owner_chunk(n, world) == j_coll.owner_chunk(n, world)


@pytest.mark.parametrize("world,live,match", [
    (4, (True, False), "entries"), (2, (False, False), "dead"),
    (3, (True,) * 4, "entries")])
def test_live_mask_errors_match_reference(world, live, match):
    for fn in (t_stats.live_mask, j_stats.live_mask):
        with pytest.raises(ValueError, match=match):
            fn(world, live)
    for fn in (t_coll.normalize_live, j_coll.normalize_live):
        with pytest.raises(ValueError, match=match):
            fn((("data", world),), live)


def test_dist_spec_helpers_match_reference():
    for spec in (None, (("data", 8),), (("pod", 2), ("data", 16))):
        assert t_coll.world_size(spec) == j_coll.world_size(spec)
    assert (t_coll.RANK1_PAYLOAD_DTYPE, t_coll.ACCUM_DTYPE,
            t_coll.QUANT_WIRE_DTYPE) == (j_coll.RANK1_PAYLOAD_DTYPE,
                                         j_coll.ACCUM_DTYPE,
                                         j_coll.QUANT_WIRE_DTYPE)
