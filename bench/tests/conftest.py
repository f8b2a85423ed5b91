"""Shared set-up of the benchmark's own tests: ``bench/`` and ``src/`` on
the path, and a tiny cell (bert-large's layout at toy widths) that runs on
the CPU in seconds.  Run them with ``python -m pytest bench/tests`` from
the root of the repository; the card's tests with ``-m cuda``."""
import copy
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=500,
            vocab_pad_multiple=64)
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def tiny_spec(cell: str = CELLS[0], dtype: str = "float32",
              limits=None) -> SimpleNamespace:
    """Cell ``cell`` at toy widths (its layout, attention kind and
    optimizer; grouped KV heads where it has them), 4 × 16 tokens a step,
    on the CPU."""
    w = {c["name"]: c for c in BENCHMARK["workloads"]}[cell]
    cfg_file = {c["name"]: c["file"] for c in BENCHMARK["configs"]}[
        w["config"]]
    cfg = json.loads((ROOT / cfg_file).read_text())
    grouped = cfg["n_kv_heads"] < cfg["n_heads"]
    cfg.update(TINY, n_kv_heads=1 if grouped else TINY["n_heads"],
               dtype=dtype)
    tr = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    tr.update(seq_len=16, batch=4)
    return SimpleNamespace(name=cell, chips=1, cfg=cfg, traffic=tr,
                           limits=copy.deepcopy(limits or {}), per_layer=[],
                           end_to_end=BENCHMARK["end_to_end"])


@pytest.fixture
def spec_factory():
    return tiny_spec
