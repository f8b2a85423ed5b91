"""The port's tooling against the JAX package, from shapes alone: the meta
init and cache (``jax.eval_shape``'s counterpart), the cost model
(``core/stats.py`` ``factor_itemsize``, ``bucket_cost``,
``bucket_comm_cost``), the dry run (``launch/dryrun.py``: the factor
report, the parameter counts and the state bytes against the reference's
``eval_shape`` state, with the pinned gap of the analytic columns).  The
kernel plans are in tests/test_torch_plans.py.

``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS`` at
import.  The reference's report is composed from ``repro.core.stats`` and
``repro.core.mkor.manifest_for`` as that module composes it."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_reg
from repro.core import firstorder as j_fo
from repro.core import stats as j_stats
from repro.core.mkor import MKORConfig as JCfg
from repro.core.mkor import manifest_for as j_manifest_for
from repro.core.mkor import mkor as j_mkor
from repro.models import model as j_model
from repro_torch import interop
from repro_torch.configs import registry as t_reg
from repro_torch.core import firstorder as t_fo
from repro_torch.core import stats as t_stats
from repro_torch.core.mkor import MKORConfig as TCfg
from repro_torch.core.mkor import manifest_for as t_manifest_for
from repro_torch.core.mkor import mkor as t_mkor
from repro_torch.launch import dryrun
from repro_torch.models import model as t_model
from repro_torch.models.config import INPUT_SHAPES

torch.set_num_threads(2)

CONFIGS = j_reg.ASSIGNED + ["bert-large"]


@pytest.fixture(scope="module")
def shapes():
    """Per config: (JAX eval_shape params, port meta params)."""
    return {n: (jax.eval_shape(lambda n=n: j_model.init_params(
        jax.random.PRNGKey(0), j_reg.get_config(n))),
        t_model.init_params(t_reg.get_config(n), device="meta"))
        for n in CONFIGS}


def _leaf_specs(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _port_specs(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape),
             str(x.dtype).replace("torch.", ""))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", CONFIGS)
def test_meta_init_matches_eval_shape(shapes, name):
    j, t = shapes[name]
    assert all(x.device.type == "meta"
               for x in jax.tree_util.tree_leaves(t))
    assert _port_specs(t) == _leaf_specs(j)


def test_meta_init_draws_nothing_elsewhere():
    """The meta path leaves every other device's draws as they were."""
    cfg = t_reg.get_config("bert-large").reduced()
    a = t_model.init_params(cfg, seed=3, device="cpu")
    t_model.init_params(cfg, seed=3, device="meta")
    b = t_model.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


DECODERS = [n for n in CONFIGS if n not in ("bert-large", "whisper-base")]


@pytest.mark.parametrize("name", DECODERS)
def test_meta_cache_matches_eval_shape(name):
    s = INPUT_SHAPES["decode_32k"]
    j = jax.eval_shape(lambda: j_model.init_decode_cache(
        j_reg.get_config(name), s.global_batch, s.seq_len))
    t = t_model.init_decode_cache(t_reg.get_config(name), s.global_batch,
                                  s.seq_len, device="meta")
    assert _port_specs(t) == _leaf_specs(j)


# --------------------------------------------------------------------- #
# The cost model
# --------------------------------------------------------------------- #
def _pairs(shapes, name, **kw):
    j, t = shapes[name]
    jm = list(j_manifest_for(j, JCfg(**kw)))
    tm = list(t_manifest_for(t, TCfg(**kw)))
    assert [b.bucket_id for b in jm] == [b.bucket_id for b in tm]
    return list(zip(jm, tm))


GRID = list(itertools.product([1, 4], [0, 1], [False, True],
                              ["none", "bf16", "int8"]))


@pytest.mark.parametrize("name", CONFIGS)
def test_cost_model_equals_the_reference(shapes, name):
    for jb, tb in _pairs(shapes, name):
        for rank, st, health, quant in GRID:
            fb = t_stats.factor_itemsize("bfloat16", quant)
            assert fb == j_stats.factor_itemsize("bfloat16", quant)
            assert t_stats.bucket_cost(
                tb, fb, rank=rank, staleness=st, health=health,
                factor_quant=quant) == j_stats.bucket_cost(
                    jb, fb, rank=rank, staleness=st, health=health,
                    factor_quant=quant)
            for world in (1, 2, 16, 32):
                assert t_stats.bucket_comm_cost(
                    tb, world, fb, 2, rank=rank, factor_quant=quant) == \
                    j_stats.bucket_comm_cost(jb, world, fb, 2, rank=rank,
                                             factor_quant=quant)


def test_bucket_cost_rank_scaling():
    """tests/test_stats.py::test_bucket_cost_rank_scaling on the port."""
    b = t_stats.FactorBucket(bucket_id="64x128", stack=(), extra=(),
                             d_in=64, d_out=128, paths=(("x",),), index=0)
    c1 = t_stats.bucket_cost(b, 2, rank=1)
    c4 = t_stats.bucket_cost(b, 2, rank=4)
    assert c1["window_bytes"] == 0
    assert c4["window_bytes"] == 4 * (64 + 128) * 4
    assert c4["smw_flops_per_inv"] < 4.1 * c1["smw_flops_per_inv"]
    assert c4["smw_flops_per_inv"] > 2 * c1["smw_flops_per_inv"]
    comm = t_stats.bucket_comm_cost(b, 4, 2, 2, rank=4)
    assert comm["rank_window_bytes_per_inv"] == \
        4 * comm["rank1_stats_bytes_per_step"]


def test_bucket_comm_cost_is_linear_vs_quadratic():
    """tests/test_dist.py::test_bucket_comm_cost_is_linear_vs_quadratic."""
    b = t_stats.FactorBucket(bucket_id="1024x4096", stack=(), extra=(),
                             d_in=1024, d_out=4096,
                             paths=(("x",), ("y",)), index=0)
    c = t_stats.bucket_comm_cost(b, 8, 2, 2)
    assert c["rank1_stats_bytes_per_step"] == 2 * (1024 + 4096) * 2
    assert c["kfac_factor_bytes_per_inv"] == \
        2 * (1024 ** 2 + 4096 ** 2) * 2
    assert c["owner_gather_bytes_per_phase_step"] == \
        c["kfac_factor_bytes_per_inv"] // 2


@pytest.mark.parametrize("args,want", [
    (("bfloat16",), 2), (("float32", "none"), 4), (("float32", "bf16"), 2),
    (("bfloat16", "int8"), 1)])
def test_factor_itemsize_is_config_derived(args, want):
    """tests/test_quant.py::test_factor_itemsize_is_config_derived."""
    assert t_stats.factor_itemsize(*args) == want


def test_int8_halves_bank_hbm_and_wire_bytes(ae_params):
    """tests/test_quant.py::test_int8_halves_bank_hbm_and_wire_bytes on
    the port's manifest of the same autoencoder."""
    params = interop.params_from_numpy(jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True), ae_params), "cpu")
    manifest = t_manifest_for(params, TCfg(exclude=()))
    b = max(manifest, key=lambda bb: bb.d_in * bb.d_out)
    c16 = t_stats.bucket_cost(b, t_stats.factor_itemsize("bfloat16"))
    c8 = t_stats.bucket_cost(b, t_stats.factor_itemsize("bfloat16", "int8"),
                             factor_quant="int8")
    assert c16["factor_bytes"] == 2 * c8["factor_bytes"]
    w16 = t_stats.bucket_comm_cost(b, 8, 2, 2)
    w8 = t_stats.bucket_comm_cost(b, 8, 1, 2, factor_quant="int8")
    assert w16["owner_gather_bytes_per_phase_step"] / \
        w8["owner_gather_bytes_per_phase_step"] > 1.9
    assert w8["owner_gather_scale_bytes_per_phase_step"] > 0


# --------------------------------------------------------------------- #
# The dry run
# --------------------------------------------------------------------- #
def _j_report(params, mcfg, world):
    """The reference dry run's ``factor_bucket_report``, composed."""
    fb = j_stats.factor_itemsize(mcfg.factor_dtype, mcfg.factor_quant)
    return [{**j_stats.bucket_cost(b, fb, rank=mcfg.rank,
                                   staleness=mcfg.staleness,
                                   health=mcfg.health,
                                   factor_quant=mcfg.factor_quant),
             **j_stats.bucket_comm_cost(b, world, fb, 2, rank=mcfg.rank,
                                        factor_quant=mcfg.factor_quant)}
            for b in j_manifest_for(params, mcfg)]


def _j_state_bytes(params, mcfg):
    state = jax.eval_shape(j_mkor(j_fo.lamb(1e-3), mcfg).init, params)
    return {k: sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
                   for x in jax.tree_util.tree_leaves(v))
            for k, v in state.items()}


KW = dict(rank=1, staleness=0, factor_quant="none", health=False)


@pytest.mark.parametrize("name", CONFIGS)
def test_dryrun_rows_equal_the_reference(shapes, name):
    j, t = shapes[name]
    for world in (16, 32):
        assert dryrun.factor_bucket_report(t, TCfg(**KW), world) == \
            _j_report(j, JCfg(**KW), world)
    rec = dryrun.dry_one(t_reg.get_config(name), INPUT_SHAPES["train_4k"],
                         world_size=16)
    assert rec["state_bytes"] == _j_state_bytes(j, JCfg(**KW))
    assert rec["state_minus_analytic"] == rec["unmodelled_bytes"] == 0
    p = rec["params"]
    assert p["total"] == sum(int(np.prod(x.shape))
                             for x in jax.tree_util.tree_leaves(j))
    assert 0 < p["active_non_embed"] <= p["active"] <= p["total"]


@pytest.mark.parametrize("rank,staleness,quant,health",
                         list(itertools.product([1, 4], [0, 1],
                                                ["none", "bf16", "int8"],
                                                [False, True])))
def test_state_bytes_and_the_pinned_gap(shapes, rank, staleness, quant,
                                        health):
    """bert-large at full width: the port's meta state bytes equal the
    reference's eval_shape state bytes entry by entry, and in both
    packages the state exceeds the analytic columns by exactly the pinned
    rule (window counts; int8 at staleness 1: the pending error feedback,
    4,227,858,432 B)."""
    j, t = shapes["bert-large"]
    kw = dict(rank=rank, staleness=staleness, factor_quant=quant,
              health=health)
    rec = dryrun.dry_one(t_reg.get_config("bert-large"),
                         INPUT_SHAPES["train_4k"], mcfg=TCfg(**kw))
    want = _j_state_bytes(j, JCfg(**kw))
    assert rec["state_bytes"] == want
    j_analytic = sum(r[k] for r in _j_report(j, JCfg(**kw), 16)
                     for k in dryrun.STATE_COLUMNS)
    j_gap = sum(v for k, v in want.items() if k in dryrun.MKOR_ENTRIES) \
        - j_analytic
    assert rec["analytic_bytes"] == j_analytic
    assert rec["state_minus_analytic"] == j_gap == rec["unmodelled_bytes"]
    if quant == "int8" and staleness:
        assert j_gap == 4227858432 + 24
    elif rank > 1 or staleness:
        assert j_gap == 24                  # 6 bank slots' int32 counts


def test_int8_banks_hold_2_5x_the_bf16_bytes(shapes):
    _, t = shapes["bert-large"]
    b16 = dryrun.state_bytes(t_mkor(t_fo.lamb(1e-3), TCfg()).init(t))
    b8 = dryrun.state_bytes(t_mkor(t_fo.lamb(1e-3), TCfg(
        factor_quant="int8")).init(t))
    # codes (1 B) and fp32 error feedback (4 B) against 2 B, plus one fp32
    # scale a slice side
    slices = sum(t_stats.bucket_slices(b) for b in t_manifest_for(t, TCfg()))
    assert b8["factor_banks"] * 2 == b16["factor_banks"] * 5 + 16 * slices


def test_dryrun_cli_writes_each_shape(tmp_path, capsys):
    rows = dryrun.main(["--arch", "minicpm-2b", "--out", str(tmp_path),
                        "--quant", "int8", "--staleness", "1"])
    assert [r["shape"] for r in rows] == list(INPUT_SHAPES)
    assert "skipped" in rows[-1]                    # long_500k
    assert rows[1]["cache_bytes"] and rows[2]["cache_bytes"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"minicpm-2b_{s}_w16_int8_s1.json" for s in INPUT_SHAPES)
    out = capsys.readouterr().out
    assert "diff=" in out and "SKIP" in out


def test_dryrun_allocates_on_the_cpu():
    """``--device cpu``: the allocated state bytes equal the meta sum."""
    rec = dryrun.dry_one(t_reg.get_config("bert-large").reduced(),
                         INPUT_SHAPES["train_4k"], device="cpu",
                         mcfg=TCfg(rank=4, staleness=1))
    assert rec["allocated_bytes"] == sum(rec["state_bytes"].values())
