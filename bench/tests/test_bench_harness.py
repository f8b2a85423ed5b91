"""The harness on the CPU: every file found by name, the allowed
characters, the result line's keys, no JAX in the process, a reference
independent of the program and equal to the program's plain route."""
import json
import re
import subprocess
import sys
import time

import pytest

from conftest import BENCH, CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files_by_name(bench):
    import harness
    for cell in bench["workloads"]:
        spec = harness.load_spec(cell["name"])
        assert (BENCH / "traffic" / f"{cell['traffic']}.json").exists()
        assert spec.limits, f"{cell['name']} has no limits file"
        for name in spec.per_layer:
            assert callable(harness.load_reader(name))
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).exists()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_names_and_units_use_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [w["traffic"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]] + \
        [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_check_steps_cover_the_warmup_and_replays():
    import harness
    import reference
    star = json.loads((BENCH / "configs" /
                       "starcoder2-15b.l2.json").read_text())
    mkor = {"name": "mkor", "inv_freq": 10}
    # 10 keys: each eager once, captured once, then 3 replays; whole chunks
    assert harness.warmup_steps(mkor) == 20
    assert harness.check_steps(mkor, 8) == 24
    assert harness.check_steps({"name": "lamb"}, 8) == 8
    # every factor group inverts in the warm-up (one group a step)
    import torch
    groups = reference.factor_groups({
        k: torch.empty(shape, device="meta") for k, shape in
        reference.flatten(reference.param_shapes(star)).items()})
    assert len(groups) == 4 <= mkor["inv_freq"]
    for cell in CELLS:
        spec = harness.load_spec(cell)
        opt = spec.traffic["optimizer"]
        assert spec.traffic["pool_batches"] >= harness.check_steps(
            opt, spec.traffic["chunk"])


def test_result_line_keys(spec_factory):
    import harness
    res = harness.run(spec_factory(), 2 ** 31 + 17, 0.2, False,
                      time.perf_counter(), device="cpu",
                      say=lambda *a: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert set(res["metrics"]) == {"tokens_per_s", "peak_reserved_gib",
                                   "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert {"loss_gap", "grad_gap", "grad_dir_gap", "change_gap",
            "factor_gap"} <= set(res["check"])


_PROBE = """
import sys, time
sys.path[:0] = [{bench!r}, {src!r}]
{body}
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(",".join(top))
"""


def _modules(body: str):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(bench=str(BENCH),
                                             src=str(ROOT / "src"),
                                             body=body)],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_no_jax_in_a_run():
    body = ("sys.path.insert(0, {t!r})\nimport conftest, harness\n"
            "harness.run(conftest.tiny_spec(), 5, 0.1, False, "
            "time.perf_counter(), device='cpu', say=lambda *a: None)"
            ).format(t=str(BENCH / "tests"))
    top = _modules(body)
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top


def test_reference_imports_nothing_of_the_program():
    top = _modules("import reference, datagen, flops, devtrace")
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, top


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_programs_plain_route(spec_factory, cell):
    """In float32 the program's plain route (no kernels, eager chunks)
    and the reference agree to float32 rounding on every number."""
    import harness
    res = harness.run(spec_factory(cell), 31, 0.1, False,
                      time.perf_counter(), device="cpu",
                      say=lambda *a: None)
    for name, c in res["check"].items():
        assert c["value"] < 1e-4, (name, c["value"])
