"""The port's wire accounting (``sharding/collectives.py`` ``wire_log``) and
its run-time contract checks (``analysis/contracts.py``, the reference's
``repro/analysis/checkers.py`` names and codes) on two gloo ranks of the
reduced bert-large: every twin of the lint is silent when sound, and each
fault planted through a wrapped transport (``tests/torch_wire_faults.py``)
trips its checker's code.  The per-step bytes equal the analytic count at
the port's wire width, and the reference's bf16 budget is half of it."""
import pytest
import torch

import torch_wire_faults
from repro.core import stats as j_stats
from repro_torch.analysis import contracts, lint
from repro_torch.analysis.diagnostics import Severity
from repro_torch.core import stats as t_stats
from repro_torch.sharding import collectives

torch.set_num_threads(2)

PLANTED = tuple(torch_wire_faults.PLANTED)
STEPS = 3


@pytest.fixture(scope="module")
def targets():
    """Every sound twin and every planted one, 3 steps each, on one spawn
    of two gloo ranks."""
    job = lint.LintJob("bert-large", True, "cpu",
                       twins=lint.TWINS + PLANTED, steps=STEPS,
                       wrap=torch_wire_faults.planted)
    return {t.name: t for t in lint.targets_of("bert-large",
                                               lint.run_ranks(job, 2))}


def _report(targets, twin):
    return contracts.run_checkers([targets[f"bert-large/{twin}/rank{r}"]
                                   for r in range(2)])


@pytest.mark.parametrize("twin", lint.TWINS)
def test_sound_twins_are_silent(targets, twin):
    report = _report(targets, twin)
    assert report.diagnostics == [], report.render()


@pytest.mark.parametrize("twin", lint.TWINS)
def test_step_bytes_equal_the_analytic_count(targets, twin):
    """Each step after the first moves the analytic ungated bytes (the
    first adds the 4-byte warm-up mean); the stats go at 4 bytes an
    element, twice the reference's bf16 budget of the same vectors."""
    for r in range(2):
        t = targets[f"bert-large/{twin}/rank{r}"]
        want = t.meta["analytic_step_bytes"]
        assert len(t.steps) == STEPS
        for i, step in enumerate(t.steps):
            got = contracts.bytes_by_what(contracts.ungated(step))
            assert got == {**want, "mean": want["mean"] + 4 * (i == 0)}
        stats = [r_ for r_ in t.steps[1] if r_.what == "stats"]
        assert stats and all(x.dtype == "float32" for x in stats)
        assert t.meta["inexact_stats"] == 0
        # the phase-step owner gathers: only on phase steps (inv_freq 2)
        assert all(any(x.phase for x in s) for s in t.steps)


def test_stats_wire_width_is_twice_the_reference_budget(targets):
    t = targets["bert-large/base/rank0"]
    for bid, c in t.meta["bucket_comm"].items():
        assert c["rank1_stats_bytes_per_step"] % 4 == 0
        b = next(b for b in lint_manifest() if b.bucket_id == bid)
        ref = j_stats.bucket_comm_cost(_j_bucket(b), 2, 2, 2)
        assert c["rank1_stats_bytes_per_step"] == \
            2 * ref["rank1_stats_bytes_per_step"]


def lint_manifest():
    from repro_torch.configs import registry
    from repro_torch.core.mkor import MKORConfig, manifest_for
    from repro_torch.models import model as model_lib
    cfg = registry.get_config("bert-large").reduced()
    return manifest_for(model_lib.init_params(cfg, device="meta"),
                        MKORConfig())


def _j_bucket(b):
    return j_stats.FactorBucket(bucket_id=b.bucket_id, stack=b.stack,
                                extra=b.extra, d_in=b.d_in, d_out=b.d_out,
                                paths=b.paths, index=b.index)


# planted twin -> (checker, code, severity) each must raise
TRIPS = [
    ("base@planted", "dtype-discipline", "dtype.stats-payload-not-bf16",
     Severity.WARNING),
    ("stale@planted", "staleness-bound", "staleness.extra-step-bytes",
     Severity.ERROR),
    ("health@planted", "health-gating", "health.extra-step-collectives",
     Severity.ERROR),
    ("remap@planted", "elastic-remap", "elastic.extra-step-collectives",
     Severity.ERROR),
    ("int8@planted", "comm-linearity", "comm.factor-payload-per-step",
     Severity.ERROR),
    ("int8@planted", "quant-discipline", "quant.wire-not-int8-origin",
     Severity.ERROR),
]


@pytest.mark.parametrize("twin,checker,code,severity", TRIPS)
def test_planted_fault_trips_its_code(targets, twin, checker, code,
                                      severity):
    found = _report(targets, twin).by_code(code)
    assert found and all(d.checker == checker and d.severity == severity
                         for d in found)
    assert not _report(targets, twin.split("@")[0]).by_code(code)


def test_dequantized_gather_trips_on_phase_steps(targets):
    """The int8 twin's dequantized owner gather trips on its phase-step
    payloads too, not only on the bank sent every step."""
    found = _report(targets, "int8@planted").by_code(
        "quant.wire-not-int8-origin")
    assert {d.context["op"] for d in found} >= {"all_gather"}
    t = targets["bert-large/int8@planted/rank0"]
    assert any(r.phase and r.dtype == "float32" and r.what == "owner_gather"
               for s in t.steps for r in s)


def test_f64_state_and_wire_trip_dtype_discipline():
    rec = collectives.WireRecord("all_reduce", "float64", (4,), 4, 32,
                                 "mean")
    t = contracts.Target("planted", [[rec]],
                         {"f64_paths": ["factor_banks/x/l_inv"]})
    found = contracts.check_dtype_discipline(t)
    assert [d.code for d in found] == ["dtype.f64-promotion"] * 2
    half = collectives.WireRecord("all_reduce", "bfloat16", (4, 8), 32, 64,
                                  "stats")
    found = contracts.check_dtype_discipline(
        contracts.Target("planted", [[half]], {}))
    assert [d.code for d in found] == ["dtype.stats-accum-not-f32"]


def test_wire_log_marks_rewinds_and_credits():
    """The chunk runner's protocol: a capture's records come off the log
    and each replay puts them back."""
    with collectives.wire_log() as log:
        collectives.note_step()
        mark = collectives.wire_mark()
        collectives.note_step()
        captured = collectives.wire_rewind(mark)
        assert len(log.records) == 1 and len(captured[0]) == 1
        collectives.wire_credit(captured)
        collectives.wire_credit(captured)
        assert len(log.steps()) == 3
    collectives.note_step()            # no open log: nothing recorded
    assert len(log.records) == 3


def test_lint_without_dist_checks_the_state(capsys):
    assert lint.main(["--config", "bert-large", "--reduced", "--device",
                      "cpu", "--steps", "1"]) == 0
    assert "0 error(s)" in capsys.readouterr().out


def test_cost_model_columns_at_either_stat_width():
    b = t_stats.FactorBucket("64x128", (), (), 64, 128, (("x",),), 0)
    assert t_stats.bucket_comm_cost(b, 2, 2, 4)[
        "rank1_stats_bytes_per_step"] == 2 * t_stats.bucket_comm_cost(
            b, 2, 2, 2)["rank1_stats_bytes_per_step"]
