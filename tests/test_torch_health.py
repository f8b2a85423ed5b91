"""The port's numerical-health sentinel (``MKORConfig.health``) and chaos
harness (``repro_torch/training/chaos.py``) against ``repro/core/mkor.py``
and ``repro/training/chaos.py``.

On the conftest autoencoder, numpy-drawn gradients and statistics go
through the JAX ``mkor`` (jitted) and the port, each wrapped by its own
package's ``chaotic`` with the same ``ChaosPlan`` object.  Held: the
config checks (``per_layer`` raises the reference's ``ValueError``); the
state tree; health on against health off bit for bit in the port on clean
data at (rank, staleness) (1, 0), (2, 0), (1, 1), (2, 1) and int8 rank 1;
for each injection site, the ``trips`` and ``cooldown`` of every bucket
equal to JAX's after every step, the identity resets bit for bit, and the
updates, banks, windows and pending banks at the tolerances of the other
parity tests; the pivot trip (``health_pivot_tol=1e30``: every inversion
trips, and the pivot of a gated-off bucket must not); health with MKOR-H
across the flip; int8 ``factor_inf`` and ``window_flip`` raising in both
packages; the chaotic plan (same key, one hit scalar an injection);
``parse_chaos_spec``; the signals' reductions against the reference's;
and ``train_epoch`` with ``grad_nan`` on the tiny model against the JAX
``train_epoch`` and, bit for bit, against the port's per-step loop."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import firstorder as j_fo
from repro.data import pipeline as j_pipe
from repro.models import model as j_model
from repro.training import chaos as j_chaos
from repro.training import loop as j_loop
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.training import chaos as t_chaos
from repro_torch.training import loop as t_loop

# the shared parity helpers (tests/ is on sys.path, pytest's default
# "prepend" import mode)
from test_torch_chunk import _assert_bit_equal
from test_torch_mkor_block import _max_err, _port_cfg
from test_torch_mkor_int8 import check_int8_banks, check_int8_windows
from test_torch_state import _check_tree, _draw, _host

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")

# off-phase for bucket 0 (its phase steps are the even counts at inv_freq
# 2): on a phase step of staleness 1 the promote would erase the poison
# before anything used it (tests/test_health.py)
INJECT_AT, STEPS = 5, 14
SITE_CASES = {
    "grad_nan": ("grad_nan", {}),
    "factor_inf": ("factor_inf", {}),
    "payload_corrupt-rank2": ("payload_corrupt", dict(rank=2)),
    "window_flip-staleness1": ("window_flip", dict(staleness=1)),
    "int8-grad_nan": ("grad_nan", dict(factor_quant="int8")),
}
CLEAN_CASES = {"rank1": dict(), "rank2": dict(rank=2),
               "staleness1": dict(staleness=1),
               "rank2-staleness1": dict(rank=2, staleness=1),
               "int8-rank1": dict(factor_quant="int8")}


def _plan(*items):
    return j_chaos.ChaosPlan(tuple(j_chaos.Injection(site=s, step=i)
                                   for s, i in items))


def _opts(kw, plan=None, hybrid=False):
    """The JAX and the port's ``mkor(lamb)`` with ``health=True`` (unless
    ``kw`` says otherwise), each wrapped by its package's ``chaotic`` with
    the same ``plan``."""
    cfg = dict(inv_freq=2, exclude=(), **{"health": True, **kw})
    jc, tc = j_mkor.MKORConfig(**cfg), t_mkor.MKORConfig(**cfg)
    make = (j_mkor.mkor_h, t_mkor.mkor_h) if hybrid else \
        (j_mkor.mkor, t_mkor.mkor)
    j_opt, t_opt = make[0](j_fo.lamb(1e-2), jc), make[1](t_fo.lamb(1e-2), tc)
    if plan is not None:
        j_opt = j_chaos.chaotic(j_opt, plan, jc)
        t_opt = t_chaos.chaotic(t_opt, plan, tc)
    return j_opt, t_opt


def _health(state):
    """{bucket: (trips, cooldown)} of a JAX or port state."""
    return {b: (int(h["trips"]), int(h["cooldown"]))
            for b, h in state["health"].items()}


def _identity_sides(bank, eye_of):
    """Every bank side of ``bank`` (a port bucket) is the exact reset."""
    for side in ("l", "r"):
        q = bank[f"{side}_inv"]
        eye = eye_of(q)
        if not torch.equal(q, eye):
            return False
        if f"{side}_scale" in bank and not (
                torch.equal(bank[f"{side}_scale"], torch.full_like(
                    bank[f"{side}_scale"], np.float32(1 / 127)))
                and not bank[f"{side}_ef"].any()):
            return False
    return True


def _eye_of(q):
    eye = torch.eye(q.shape[-1])
    if q.dtype == torch.int8:
        eye = eye * 127
    return eye.to(q.dtype).expand(q.shape)


def _run_both(ae_params, kw, plan, steps, hybrid_losses=None, seed=5):
    """``steps`` updates of both packages from the same draws (params
    fixed); per step the health of each, the max update error and the
    port's state.  ``hybrid_losses``: MKOR-H with these losses (the port
    takes its host view each step)."""
    hybrid = hybrid_losses is not None
    j_opt, t_opt = _opts(kw, plan, hybrid)
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_update = jax.jit(lambda g, s, p, st, loss: j_opt.update(
        g, s, params=p, stats=st, loss=loss))
    rng = np.random.default_rng(seed)
    hist = []
    for count in range(steps):
        grads, stats = _draw(rng, host)
        loss = hybrid_losses[count] if hybrid else 3.0
        ju, js = j_update(grads, js, jp, stats, jnp.float32(loss))
        view = {"view": t_opt.observe(ts)} if hybrid else {}
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                              params=tp,
                              stats=interop.tree_from_numpy(stats, CPU),
                              loss=torch.tensor(loss, dtype=torch.float32),
                              **view)
        hist.append((_health(js), _health(ts), _max_err(ju, tu),
                     jax.tree.map(torch.clone, ts)))
    return js, ts, hist


def _check_states(js, ts, kw):
    bank_keys = ["factor_banks"] + (["pending_banks"]
                                    if kw.get("staleness") else [])
    if kw.get("factor_quant") == "int8":
        for key in bank_keys:
            check_int8_banks(js[key], ts[key], recon_tol=1e-4,
                             flip_slack=0.25)
        if "stat_windows" in js:
            check_int8_windows(js["stat_windows"], ts["stat_windows"])
    else:
        for key in bank_keys:
            # bf16 banks: one bf16 ulp where the fp32 sums round apart
            assert _max_err(js[key], ts[key]) <= 2 ** -6, key
        if "stat_windows" in js:
            assert _max_err(js["stat_windows"], ts["stat_windows"]) < 1e-5


# --------------------------------------------------------------------- #
# Config and state
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("overrides,match", [
    (dict(health=True, layout="per_layer"), "layout='bank'"),
    (dict(health=True, health_cooldown=0), "health_cooldown"),
    (dict(health=True, health_cooldown=-1, layout="per_layer"),
     "layout='bank'")],
    ids=["per_layer", "cooldown0", "both"])
def test_health_config_errors_match_reference(overrides, match):
    """The reference's ValueError, checked before the port's
    NotImplementedError for ``per_layer``."""
    with pytest.raises(ValueError, match=match):
        j_mkor.mkor(j_fo.lamb(1e-3), j_mkor.MKORConfig(**overrides))
    with pytest.raises(ValueError, match=match):
        t_mkor.mkor(t_fo.lamb(1e-3), t_mkor.MKORConfig(**overrides))


@pytest.mark.parametrize("kw", [dict(), dict(rank=2, staleness=1),
                                dict(factor_quant="int8", staleness=1)],
                         ids=["rank1", "rank2-staleness1", "int8-staleness1"])
def test_health_state_tree_matches_reference(ae_params, kw):
    """``health`` holds one ``{cooldown, trips}`` of 0-d int32 a bucket, on
    the parameters' device, with the reference's key paths; the whole
    tree too, at init and after steps."""
    j_opt, t_opt = _opts(kw)
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    _check_tree(js, ts)
    assert sorted(ts["health"]) == sorted(js["health"])
    for h in ts["health"].values():
        for leaf in h.values():
            assert leaf.dtype == torch.int32 and leaf.shape == ()
            assert leaf.device == tp["layers"][0]["w"].device
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads, stats = _draw(rng, host)
        _, ts = t_opt.update(interop.tree_from_numpy(grads, CPU), ts,
                             params=tp,
                             stats=interop.tree_from_numpy(stats, CPU))
    _check_tree(js, ts)
    assert _health(ts) == {b: (0, 0) for b in js["health"]}


# --------------------------------------------------------------------- #
# Clean data: the sentinel changes nothing
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", sorted(CLEAN_CASES))
def test_health_on_clean_data_is_bit_equal_to_off(ae_params, case):
    """Six steps from the same draws with health on and off: the updates
    and every state leaf but ``health`` bit for bit, and no trip.  The
    staleness-1 runs use the two-phase protocol (precompute, then
    update)."""
    kw = CLEAN_CASES[case]
    _, on = _opts(kw)
    _, off = _opts({**kw, "health": False})
    host = _host(ae_params)
    tp = interop.params_from_numpy(host, CPU)
    s_on, s_off = on.init(tp), off.init(tp)
    rng = np.random.default_rng(4)
    for _ in range(6):
        grads, stats = (interop.tree_from_numpy(x, CPU)
                        for x in _draw(rng, host))
        outs = []
        for opt, st in ((on, s_on), (off, s_off)):
            pre = opt.precompute(st, params=tp) if opt.precompute else st
            outs.append(opt.update(grads, pre, params=tp, stats=stats,
                                   precomputed=opt.precompute is not None))
        (u_on, s_on), (u_off, s_off) = outs
        _assert_bit_equal(u_on, u_off)
        _assert_bit_equal({k: v for k, v in s_on.items() if k != "health"},
                          s_off)
    assert _health(s_on) == {b: (0, 0) for b in s_on["health"]}


# --------------------------------------------------------------------- #
# Injections: the reference's trips, cooldowns and resets
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", sorted(SITE_CASES))
def test_injection_matches_reference(ae_params, case):
    """One injection at count 5 (off-phase for bucket 0), 14 steps: both
    packages' ``trips`` and ``cooldown`` after every step are equal; the
    target trips once at count 5 and no other bucket trips; at the trip
    the target's banks (and pending banks) are the exact identity reset
    (int8: codes 127·I, scale 1/127, error feedback 0), its windows and
    counts zero; the cooldown runs out and the bucket inverts again;
    updates, banks and windows at the parity tolerances throughout."""
    site, kw = SITE_CASES[case]
    js, ts, hist = _run_both(ae_params, kw, _plan((site, INJECT_AT)),
                             STEPS)
    target = sorted(hist[0][1])[0]
    for count, (jh, th, err, _) in enumerate(hist):
        assert jh == th, (count, jh, th)
        assert err < 1e-5, (count, err)
    trips = [h[1][target][0] for h in hist]
    assert trips == [0] * INJECT_AT + [1] * (STEPS - INJECT_AT)
    assert all(t == 0 for h in hist for b, (t, _) in h[1].items()
               if b != target)
    at = hist[INJECT_AT][3]
    assert hist[INJECT_AT][1][target][1] == t_mkor.MKORConfig().health_cooldown
    for key in ("factor_banks", "pending_banks"):
        if key in at:
            assert _identity_sides(at[key][target], _eye_of), key
    if "stat_windows" in at:
        for k, t in at["stat_windows"][target].items():
            assert not t.any(), k
    # recovery: the cooldown ran out and the bucket left the identity
    assert hist[-1][1][target][1] == 0
    assert not _identity_sides(ts["factor_banks"][target], _eye_of)
    _check_states(js, ts, kw)


def test_pivot_trip_matches_reference(ae_params):
    """``health_pivot_tol=1e30`` at rank 2: every inversion's pivot is
    below it, so each bucket trips on each phase step it inverts, sits out
    its cooldown and trips again on re-entry.  The histories equal JAX's,
    so the pivot of a gated-off phase step (cooldown running) is masked
    as the reference, which never computes it, has it."""
    _, ts, hist = _run_both(ae_params, dict(rank=2, health_pivot_tol=1e30),
                            None, 12)
    for count, (jh, th, err, _) in enumerate(hist):
        assert jh == th, (count, jh, th)
        assert err < 1e-5, (count, err)
    # with cooldown 2 at inv_freq 2 a bucket inverts every third phase step
    assert all(t == 2 for t, _ in hist[-1][1].values()), hist[-1][1]


@pytest.mark.parametrize("kw", [dict(), dict(staleness=1)],
                         ids=["rank1", "staleness1"])
def test_health_with_mkor_h_matches_reference(ae_params, kw):
    """MKOR-H with the sentinel: the switch turns off at count 6 (the
    losses of tests/test_torch_hybrid.py); grad_nan before the flip and
    factor_inf after it.  The switch state, trips and cooldowns equal the
    reference's every step (the cooldown counts only the steps the switch
    lets invert), the port taking its host view each step (after the
    flip: no inversion, but the sentinel and the precondition still
    run), updates and banks at the parity tolerances."""
    from test_torch_hybrid import FLIP, HYBRID, LOSSES
    js, ts, hist = _run_both(ae_params, {**kw, **HYBRID},
                             _plan(("grad_nan", 3), ("factor_inf", 9)),
                             len(LOSSES), hybrid_losses=LOSSES)
    for count, (jh, th, err, st) in enumerate(hist):
        assert jh == th, (count, jh, th)
        assert err < 1e-5, (count, err)
        assert bool(st["hybrid"]["on"]) == (count < FLIP), count
    assert sum(t for t, _ in hist[-1][1].values()) == 2
    assert bool(js["hybrid"]["on"]) == bool(ts["hybrid"]["on"]) is False
    _check_states(js, ts, kw)


@pytest.mark.parametrize("site,kw,exc", [
    ("factor_inf", dict(), OverflowError),
    ("window_flip", dict(rank=2), ValueError),
    ("window_flip", dict(staleness=1), ValueError)],
    ids=["factor_inf", "window_flip-rank2", "window_flip-staleness1"])
def test_int8_code_poison_raises_in_both(ae_params, site, kw, exc):
    """Inf or NaN into int8 codes: JAX raises converting the value (at
    trace time), and so does the port; neither invents a meaning."""
    j_opt, t_opt = _opts({**kw, "factor_quant": "int8"},
                         _plan((site, 1)))
    host = _host(ae_params)
    jp = jax.tree.map(jnp.asarray, host)
    tp = interop.params_from_numpy(host, CPU)
    grads, stats = _draw(np.random.default_rng(0), host)
    with pytest.raises(exc):
        j_opt.update(grads, j_opt.init(jp), params=jp, stats=stats)
    with pytest.raises(exc):
        t_opt.update(interop.tree_from_numpy(grads, CPU), t_opt.init(tp),
                     params=tp, stats=interop.tree_from_numpy(stats, CPU))


# --------------------------------------------------------------------- #
# The harness
# --------------------------------------------------------------------- #
def test_chaotic_plan_keeps_the_key_and_adds_hit_scalars():
    """``plan``: the wrapped optimizer's key, its scalars, and one 0/1
    float32 ``chaos_hit_<i>`` an injection (1 on its step); the wrapper
    forwards ``precompute`` and ``observe``; no injection, no wrapper."""
    cfg = t_mkor.MKORConfig(inv_freq=3, staleness=1, hybrid=True)
    opt = t_mkor.mkor(t_fo.lamb(1e-2), cfg)
    plan = _plan(("grad_nan", 4), ("factor_inf", 7))
    wrapped = t_chaos.chaotic(opt, plan, cfg)
    assert wrapped.precompute is opt.precompute
    assert wrapped.observe is opt.observe
    for count in (0, 4, 7):
        state = {"count": t_fo.step_count(count),
                 "backend": {"count": t_fo.step_count(count)}}
        key, scalars = wrapped.plan(state, view=True)
        want_key, want = opt.plan(state, view=True)
        assert key == want_key
        assert sorted(scalars) == sorted(
            list(want) + ["chaos_hit_0", "chaos_hit_1"])
        for k, v in want.items():
            assert scalars[k] == v
        assert scalars["chaos_hit_0"] == np.float32(count == 4)
        assert scalars["chaos_hit_1"] == np.float32(count == 7)
        assert all(isinstance(scalars[f"chaos_hit_{i}"], np.float32)
                   for i in range(2))
    host_only = j_chaos.ChaosPlan((), (j_chaos.HostFault("kill_shard", 3),))
    assert t_chaos.chaotic(opt, host_only, cfg) is opt


def test_poison_copies_and_never_writes_the_input():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    keep = x.clone()
    hit, miss = torch.ones(()), torch.zeros(())
    out = t_chaos._poison_elem(x, hit, float("nan"))
    assert torch.isnan(out[0, 0]) and torch.equal(out[1:], x[1:])
    assert torch.equal(t_chaos._poison_elem(x, miss, float("nan")), x)
    assert torch.equal(x, keep)


@pytest.mark.parametrize("spec", [
    "grad_nan@4, factor_inf@7:12x48", "", "window_flip@0,payload_corrupt@3",
    "kill_shard@4:3,delay_shard@2,drop_collective@9:1,grad_nan@1"])
def test_parse_chaos_spec_matches_reference(spec):
    j, t = j_chaos.parse_chaos_spec(spec), t_chaos.parse_chaos_spec(spec)
    assert bool(j) == bool(t)
    assert [vars(i) for i in j.injections] == \
        [vars(i) for i in t.injections]
    assert [vars(f) for f in j.host_faults] == \
        [vars(f) for f in t.host_faults]
    assert [vars(f) for f in j.host_events(0, 10)] == \
        [vars(f) for f in t.host_events(0, 10)]
    np.testing.assert_array_equal([i.poison() for i in t.injections],
                                  [i.poison() for i in j.injections])


@pytest.mark.parametrize("spec", ["gamma_ray@3", "grad_nan", "grad_nan@x",
                                  "kill_shard@2:y"])
def test_parse_chaos_spec_errors_match_reference(spec):
    with pytest.raises(ValueError) as j_err:
        j_chaos.parse_chaos_spec(spec)
    with pytest.raises(ValueError) as t_err:
        t_chaos.parse_chaos_spec(spec)
    assert str(t_err.value) == str(j_err.value)


# --------------------------------------------------------------------- #
# The signals' reductions against the reference's
# --------------------------------------------------------------------- #
def _arrays():
    rng = np.random.default_rng(11)
    base = rng.standard_normal((3, 4, 5)).astype(np.float32)
    out = {"clean": base, "hot": base * 100.0, "zero": base * 0.0,
           "tiny": np.full((3, 4, 5), 1e-30, np.float32)}
    for name, val in (("nan", np.nan), ("inf", np.inf), ("-inf", -np.inf)):
        x = base.copy()
        x[1, 2, 3] = val
        out[name] = x
    return out


@pytest.mark.parametrize("name", sorted(_arrays()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_signals_equal_the_reference_booleans(name, dtype):
    """max|x| alone gives the reference's ``_any_nonfinite`` and, against
    the hot threshold, its ``_any_nonfinite | norm_hot``; the per-slice
    norm is zero where its ``_slice_sumsq`` is; ``_finite_or_zero`` bit
    for bit."""
    x = _arrays()[name]
    jx = jnp.asarray(x, dtype=dtype)
    tx = interop.tree_from_numpy(np.asarray(jx), CPU) \
        if dtype == "float32" else torch.from_numpy(x).to(torch.bfloat16)
    hot = 4.0 * 50.0
    want_bad = bool(j_mkor._any_nonfinite([jx]))
    assert bool(t_mkor._any_nonfinite([tx])) == want_bad
    want_hot = want_bad | bool(jnp.max(jnp.abs(jx.astype(jnp.float32)))
                               > hot)
    assert bool(~(t_mkor._absmax(tx) <= hot)) == want_hot
    clean_j = j_mkor._finite_or_zero(jx)
    clean_t = t_mkor._finite_or_zero(tx)
    np.testing.assert_array_equal(
        np.asarray(clean_j, np.float32), clean_t.float().numpy())
    np.testing.assert_array_equal(
        np.asarray(j_mkor._slice_sumsq(clean_j)) == 0.0,
        (t_mkor._slice_norm(clean_t) == 0.0).numpy())


def test_quant_side_maxabs_matches_reference():
    rng = np.random.default_rng(12)
    q = rng.integers(-127, 128, (3, 2, 6, 6)).astype(np.int8)
    sc = rng.uniform(0.001, 3.0, (3, 2)).astype(np.float32)
    ef = np.zeros((3, 2, 6, 6), np.float32)
    want = j_mkor._quant_side_maxabs((jnp.asarray(q), jnp.asarray(sc),
                                      jnp.asarray(ef)))
    got = t_mkor._quant_side_maxabs(tuple(map(torch.from_numpy,
                                              (q, sc, ef))))
    assert got.item() == float(want)


# --------------------------------------------------------------------- #
# Through the chunk runner
# --------------------------------------------------------------------- #
def test_train_epoch_with_grad_nan_matches_jax_and_per_step_loop(
        tiny_model_cfg):
    """The tiny model, 8 steps in chunks of 4 with grad_nan at count 3:
    the JAX ``train_epoch`` and the port's give the same trips and
    cooldowns, losses and params at the MKOR parity tolerances; the
    port's ``train_epoch`` equals its per-step loop bit for bit (the hit
    rides a plan scalar, so the runner's steps take it as the eager step
    does)."""
    cfg = tiny_model_cfg
    j_opt, t_opt = _opts(dict(rank=2), _plan(("grad_nan", 3)))
    jp = j_model.init_params(jax.random.key(0), cfg)
    tp = interop.params_from_numpy(_host(jp), CPU)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    batches = [j_pipe.make_batch(ds, i) for i in range(8)]
    jp2, js, j_hist = j_loop.train_epoch(
        j_loop.make_train_step(cfg, j_opt), jp, j_opt.init(jp), batches,
        chunk=4, donate=False)
    step = t_loop.make_train_step(_port_cfg(cfg), t_opt)
    assert step.plan is t_opt.plan
    pe, se, t_hist = t_loop.train_epoch(step, tp, t_opt.init(tp), batches,
                                        chunk=4)
    np.testing.assert_allclose([h["loss"] for h in j_hist],
                               [h["loss"] for h in t_hist], rtol=1e-5)
    assert np.isfinite([h["loss"] for h in t_hist]).all()
    assert _max_err(jp2, pe) < 2e-4
    assert _health(js) == _health(se)
    assert sum(t for t, _ in _health(se).values()) == 1
    p, s, losses = tp, t_opt.init(tp), []
    for batch in batches:
        p, s, m = step(p, s, t_loop.batch_to_device(batch, CPU))
        losses.append(float(m["loss"]))
    assert [h["loss"] for h in t_hist] == losses
    _assert_bit_equal((pe, se), (p, s))
