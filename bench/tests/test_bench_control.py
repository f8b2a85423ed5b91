"""The control, on the card at each cell's own size: the plain reference
computed with float8 e4m3 dense operands, put in the program's place,
fails the cell's limits on every seed.  Run on the card with
``python -m pytest -m cuda bench/tests/test_bench_control.py``."""
import json

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    import calibrate
    import harness
    spec = harness.load_spec(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        numbers = calibrate.readings(spec, seed, names=("control",))[
            "control"]
        assert any(numbers[k] > limit for k, limit in spec.limits.items()), \
            (seed, numbers, spec.limits)
