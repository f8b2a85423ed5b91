"""The port's int8 factor state (``factor_quant="int8"``) against
``repro/core/mkor.py``: the state's structure and identity init, and
6-step training runs at inv_freq 2 on the same weights (interop) and
batches -- rank 1 (both variants, stagger on and off), block rank 2 and
staleness 1 -- plus the kernel route's banked entries (their plain
versions on the CPU) against the plain route.

Tolerances: updates and LAMB's moments as the other 6-step runs (fp32
rounding in another order); the codes within one step (an fp32 rounding
difference can move a value across a code boundary, and the error
feedback then carries the other side); the reconstructed banks
decode(codes, scale) + error feedback, which equal the stabilized fp32
update plus the old error feedback exactly, to fp32 tolerance when each
step starts from the reference's state.  In free runs a code that went
the other way at one inversion enters the next one: the update multiplies
that one-step difference by γ^m (paper) or γ^-m (exact_smw), the error
feedback carries it by 1, so the reconstructed banks may then differ by
|γ^±m − 1|·scale < 0.25·scale (γ = 0.9, m ≤ 2) at such entries."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import firstorder as j_fo
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor

# the shared parity helpers (tests/ is on sys.path, pytest's default
# "prepend" import mode)
from test_torch_mkor_block import _max_err, run_both

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")
SIDES = (("l_inv", "l_scale", "l_ef"), ("r_inv", "r_scale", "r_ef"))


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def check_int8_banks(j_banks, t_banks, recon_tol=1e-5, flip_slack=0.0):
    """Per bank side: codes within one step, scales to fp32 rounding, and
    the reconstructed fp32 bank decode + ef to ``recon_tol`` plus
    ``flip_slack`` times the slice's scale."""
    assert sorted(j_banks) == sorted(t_banks)
    for bid, jb in j_banks.items():
        tb = t_banks[bid]
        assert set(tb) == {k for keys in SIDES for k in keys}
        for q_k, s_k, e_k in SIDES:
            jq, js, je = (np.asarray(jb[k]) for k in (q_k, s_k, e_k))
            tq, ts, te = (tb[k].numpy() for k in (q_k, s_k, e_k))
            assert tq.dtype == np.int8 and ts.dtype == te.dtype == np.float32
            assert np.abs(jq.astype(np.int32) - tq).max() <= 1, (bid, q_k)
            np.testing.assert_allclose(js, ts, rtol=1e-5)
            j_rec = jq.astype(np.float32) * js[..., None, None] + je
            t_rec = tq.astype(np.float32) * ts[..., None, None] + te
            tol = recon_tol + flip_slack * js[..., None, None]
            assert np.all(np.abs(j_rec - t_rec) <= tol), (bid, q_k)


def check_int8_windows(j_wins, t_wins):
    for bid, jw in j_wins.items():
        tw = t_wins[bid]
        assert set(tw) == {"a", "a_scale", "g", "g_scale", "n"}
        np.testing.assert_array_equal(np.asarray(jw["n"]), tw["n"].numpy())
        for k in ("a", "g"):
            # per-row encodes of the two forwards' fp32 stat vectors, which
            # agree to 1e-4 as the fp32 windows of the other runs: codes
            # within one step, so the decoded rows within 1e-4 plus one
            # step (the row's scale; windows carry no error feedback)
            assert tw[k].dtype == torch.int8
            assert np.abs(np.asarray(jw[k], np.int32)
                          - tw[k].numpy()).max() <= 1
            j_sc = np.asarray(jw[k + "_scale"])[..., None]
            j_rows = np.asarray(jw[k], np.float32) * j_sc
            t_rows = (tw[k].float() * tw[k + "_scale"][..., None]).numpy()
            assert np.all(np.abs(j_rows - t_rows) <= 1e-4 + j_sc)


@pytest.mark.parametrize("kw", [
    dict(rank=1, variant="paper", stagger=True),
    dict(rank=1, variant="exact_smw", stagger=False),
    dict(rank=2, variant="exact_smw", stagger=True),
    dict(rank=1, staleness=1, variant="paper", stagger=True)],
    ids=["rank1-paper-stagger", "rank1-exact", "rank2-exact-stagger",
         "staleness1-paper-stagger"])
def test_mkor_int8_six_steps_match(kw, tiny_model_cfg):
    (j_losses, jp, js), (t_losses, tp, ts) = run_both(
        tiny_model_cfg, dict(inv_freq=2, factor_quant="int8", **kw), 6)
    # float32 model and optimizer: float32 rounding in another order
    np.testing.assert_allclose(j_losses, t_losses, rtol=1e-5)
    assert _max_err(jp, tp) < 2e-4
    assert ts["count"] == int(js["count"]) == 6
    assert set(ts) == set(js)
    for key in ("factor_banks", "stat_windows", "pending_banks"):
        if key in js:
            assert jax.tree.structure(jax.tree.map(np.asarray, js[key])) == \
                jax.tree.structure(interop.tree_to_numpy(ts[key]))
    for key in ("factor_banks", "pending_banks"):
        if key in js:
            check_int8_banks(js[key], ts[key], recon_tol=1e-4,
                             flip_slack=0.25)
    if "stat_windows" in js:
        check_int8_windows(js["stat_windows"], ts["stat_windows"])
    # the banks left the identity
    assert any(not torch.equal(b["l_inv"][0, 0], 127 * torch.eye(
        b["l_inv"].shape[-1], dtype=torch.int8))
        for b in ts["factor_banks"].values())
    # LAMB's first moment sums 6 steps of preconditioned updates: 5e-4 of
    # its largest entry, as the other multi-step runs
    m_max = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree.leaves(js["backend"]["m"]))
    assert _max_err(js["backend"]["m"], ts["backend"]["m"]) < 5e-4 * m_max


def _port_state(js):
    """The port's optimizer state from the JAX package's (interop)."""
    return interop.opt_state_from_numpy(_host(js), CPU)


def _draw(rng, host):
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), host)
    stats = {"layers": [{"a": rng.standard_normal(
        p["w"].shape[0]).astype(np.float32)} for p in host["layers"]]}
    return grads, stats


@pytest.mark.parametrize("kw", [
    dict(rank=1, variant="exact_smw"), dict(rank=2, variant="exact_smw"),
    dict(rank=1, staleness=1, variant="paper")],
    ids=["rank1-exact", "rank2-exact", "staleness1-paper"])
def test_int8_each_step_from_the_reference_state(ae_params, kw):
    """6 steps of numpy-drawn gradients and statistics on the autoencoder;
    before each one the port takes the JAX state (interop).  Every step's
    updates match to fp32 tolerance, and so do the reconstructed banks,
    with the codes within one step."""
    kw = dict(inv_freq=2, exclude=(), factor_quant="int8", **kw)
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    js = j_opt.init(jp)
    j_update = jax.jit(lambda g, s, p, st: j_opt.update(g, s, params=p,
                                                        stats=st))
    rng = np.random.default_rng(5)
    for _ in range(6):
        grads, stats = _draw(rng, host)
        ts = _port_state(js)
        ju, js = j_update(grads, js, jp, stats)
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp,
                              stats=interop.tree_from_numpy(stats, CPU))
        assert _max_err(ju, tu) < 1e-5
        for key in ("factor_banks", "pending_banks"):
            if key in js:
                check_int8_banks(js[key], ts[key])
        if "stat_windows" in js:
            check_int8_windows(js["stat_windows"], ts["stat_windows"])


@pytest.mark.parametrize("rank,staleness", [(1, 0), (3, 1)])
def test_int8_state_structure_and_identity(ae_params, rank, staleness):
    """6-key banks, int8 windows with per-row scales, pending banks: the
    reference's tree with its exact values (codes 127·I at scale fp32(1/127),
    zero error feedback), in distinct buffers."""
    kw = dict(rank=rank, staleness=staleness, factor_quant="int8",
              exclude=())
    js = j_mkor.mkor(j_fo.lamb(1e-3), j_mkor.MKORConfig(**kw)).init(
        jax.tree.map(jnp.asarray, _host(ae_params)))
    tp = interop.params_from_numpy(_host(ae_params), CPU)
    ts = t_mkor.mkor(t_fo.lamb(1e-3), t_mkor.MKORConfig(**kw)).init(tp)
    assert set(ts) == set(js)
    for key in ("factor_banks", "stat_windows", "pending_banks"):
        if key not in js:
            assert key not in ts
            continue
        jh, th = _host(js[key]), interop.tree_to_numpy(ts[key])
        assert jax.tree.structure(jh) == jax.tree.structure(th)
        for a, b in zip(jax.tree.leaves(jh), jax.tree.leaves(th)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    for bid, bank in ts["factor_banks"].items():
        d = bank["l_inv"].shape[-1]
        assert torch.equal(bank["l_inv"][0], 127 * torch.eye(
            d, dtype=torch.int8))
        assert bool(torch.all(bank["r_scale"] == np.float32(1 / 127)))
        assert not bool(torch.any(bank["l_ef"]))
        if staleness:
            pend = ts["pending_banks"][bid]
            assert all(pend[k].data_ptr() != bank[k].data_ptr()
                       for k in bank)


def test_int8_per_layer_raises_as_the_reference():
    cfg = dict(factor_quant="int8", layout="per_layer")
    with pytest.raises(ValueError, match="layout='bank'"):
        j_mkor.mkor(j_fo.lamb(1e-3), j_mkor.MKORConfig(**cfg))
    with pytest.raises(ValueError, match="layout='bank'"):
        t_mkor.mkor(t_fo.lamb(1e-3), t_mkor.MKORConfig(**cfg))


@pytest.mark.parametrize("rank,staleness", [(1, 0), (2, 0), (1, 1)])
def test_int8_kernel_route_matches_plain_route(ae_params, rank, staleness):
    """``use_kernels=True`` on CPU tensors: the banked int8 entries (codes
    and scales flattened to one launch per bank side, the wrappers' plain
    versions) against the plain route's decode-then-compute, over 4 steps
    of numpy-drawn gradients and statistics."""
    kw = dict(rank=rank, staleness=staleness, factor_quant="int8",
              inv_freq=2, exclude=())
    host = _host(ae_params)
    params = interop.params_from_numpy(host, CPU)
    opts = [t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(
        use_kernels=k, **kw)) for k in (True, False)]
    states = [o.init(params) for o in opts]
    rng = np.random.default_rng(rank + 2 * staleness)
    for _ in range(4):
        grads, stats = _draw(rng, host)
        outs = [o.update(interop.tree_from_numpy(grads, CPU), s,
                         params=params,
                         stats=interop.tree_from_numpy(stats, CPU))
                for o, s in zip(opts, states)]
        assert _max_err(interop.tree_to_numpy(outs[1][0]), outs[0][0]) < 1e-5
        states = [o[1] for o in outs]
    for key in ("factor_banks", "pending_banks"):
        if key in states[1]:
            check_int8_banks(interop.tree_to_numpy(states[1][key]),
                             states[0][key])
    if staleness:
        # the codes moved: the pending banks hold launched updates
        bank = states[0]["pending_banks"]["48x12"]
        assert not torch.equal(bank["l_inv"][0], 127 * torch.eye(
            12, dtype=torch.int8))


def test_int8_precompute_protocol_bit_equal(ae_params):
    """Staleness 1: ``precompute`` then ``update(precomputed=True)`` equals
    ``update`` running the tick inline, bit for bit."""
    opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(
        staleness=1, inv_freq=2, exclude=(), factor_quant="int8"))
    host = _host(ae_params)
    params = interop.params_from_numpy(host, CPU)
    s1 = s2 = opt.init(params)
    rng = np.random.default_rng(11)
    for _ in range(4):
        grads, stats = (interop.tree_from_numpy(t, CPU)
                        for t in _draw(rng, host))
        u1, s1 = opt.update(grads, s1, params=params, stats=stats)
        u2, s2 = opt.update(grads, opt.precompute(s2, params=params),
                            params=params, stats=stats, precomputed=True)
        for a, b in zip(jax.tree.leaves((u1, s1)), jax.tree.leaves((u2, s2))):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) \
                else a == b
