"""The port's data-parallel MKOR with int8 state, the health sentinel and
a dead worker, at world 4, and the launcher's ``--dist``, against the JAX
package (the workload, spawned ranks and tolerances of
``tests/test_torch_dist.py``)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.launch import train as t_train

from test_torch_dist import (SCENARIOS, _close, _jax_run,
                             check_ranks_identical, spawn_runs)

WORLD_SCENARIOS = {4: ("int8_rank4_stale1", "health_chaos", "static",
                       "remap")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_runs(tmp_path_factory, WORLD_SCENARIOS)


def test_dist_ranks_hold_bit_identical_state(runs):
    """Each rank's losses, params and whole state (int8 codes, scales and
    error feedback, windows, health counters) are rank 0's bits."""
    check_ranks_identical(runs[4])


def test_dist_int8_rank4_staleness1_matches_jax_dist(runs):
    """int8 state at rank 4, staleness 1, world 4: every rank's error
    feedback zero (the owner encodes its chunk at the wire), the codes
    within one step of JAX's dist step and the scales, losses and params
    at its tolerances."""
    kw = SCENARIOS["int8_rank4_stale1"]["mkor"]
    pd, sd, ld, _ = _jax_run(kw, 4)
    for r in runs[4]:
        got = r["int8_rank4_stale1"]
        np.testing.assert_allclose(got["losses"], ld, rtol=1e-5)
        _close(got["params"], pd)
        for key in ("factor_banks", "pending_banks"):
            for bid, bank in got["state"][key].items():
                want = sd[key][bid]
                for side in ("l", "r"):
                    assert not bank[f"{side}_ef"].any(), (key, bid)
                    assert not np.asarray(want[f"{side}_ef"]).any()
                    codes = bank[f"{side}_inv"].astype(np.int32)
                    assert np.abs(codes - np.asarray(
                        want[f"{side}_inv"], np.int32)).max() <= 1
                    np.testing.assert_allclose(
                        bank[f"{side}_scale"], np.asarray(
                            want[f"{side}_scale"]), rtol=1e-4, atol=1e-7)
        _close(got["state"]["stat_windows"], sd["stat_windows"])


def test_dist_health_chaos_trips_match_jax_dist(runs):
    """The sentinel with a NaN gradient injected at count 3, world 4: each
    bucket's (trips, cooldown) after every step on every rank equal JAX's
    dist step's, and the injection tripped once."""
    kw = SCENARIOS["health_chaos"]["mkor"]
    _, _, ld, hd = _jax_run(kw, 4, chaos="grad_nan@3")
    assert sum(t for t, _ in hd[-1].values()) == 1
    for r in runs[4]:
        got = r["health_chaos"]
        assert got["health"] == hd
        np.testing.assert_allclose(got["losses"], ld, rtol=1e-5)


def test_dist_dead_worker_matches_fully_live(runs):
    """One worker dead (the owners re-split over three survivors) computes
    the update of the fully live owner map (reference
    ``test_dist_remap_step_matches_fully_live``), staleness 1, world 4."""
    for r in runs[4]:
        for key in ("params", "state"):
            _close(r["remap"][key], jax.tree.map(jnp.asarray,
                                                 r["static"][key]))
        assert r["remap"]["losses"] == pytest.approx(r["static"]["losses"],
                                                     rel=1e-6)


LAUNCH = ["--arch", "bert-large", "--reduced", "--steps", "3",
          "--global-batch", "4", "--seq-len", "16", "--inv-freq", "2",
          "--log-every", "1", "--device", "cpu", "--chunk", "2"]


def test_launcher_dist_cpu(capfd):
    """``--dist --dist-devices 2 --device cpu``: two spawned gloo ranks
    through the chunk runner; rank 0 alone prints; the losses close to the
    single-device run's (the bf16 stat payload)."""
    single = t_train.main(LAUNCH)
    out_single = capfd.readouterr().out
    final = t_train.main(LAUNCH + ["--dist", "--dist-devices", "2"])
    out = capfd.readouterr().out
    assert "dist=2x data-parallel backend=gloo" in out
    assert out.count("done: final loss") == 1
    assert out.count("step     0 loss=") == 1
    assert np.isfinite(final)
    losses = [float(x) for x in
              re.findall(r"loss=([0-9.]+)", out)]
    want = [float(x) for x in
            re.findall(r"loss=([0-9.]+)", out_single)]
    np.testing.assert_allclose(losses, want, rtol=2e-3)
    assert final == pytest.approx(single, rel=2e-3)


@pytest.mark.parametrize("extra,match", [
    (["--global-batch", "3"], "multiple"),
    (["--dist-backend", "nccl"], "nccl needs CUDA")])
def test_launcher_dist_exits(extra, match):
    with pytest.raises(SystemExit, match=match):
        t_train.main(LAUNCH + ["--dist", "--dist-devices", "2"] + extra)
