"""``examples/torch_train_lm_100m.py`` with each of its other optimizers
(MKOR-H, Eva, LAMB) for one step on the CPU at a tiny batch (MKOR and the
checkpoints: tests/test_torch_examples.py)."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "torch_train_lm_100m.py"


@pytest.mark.parametrize("optimizer", ["mkor_h", "eva", "lamb"])
def test_train_lm_100m_optimizers(capsys, optimizer):
    spec = importlib.util.spec_from_file_location("torch_train_lm_100m",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--device", "cpu", "--steps", "1", "--global-batch",
                       "2", "--seq-len", "16", "--optimizer", optimizer])
    assert len(losses) == 1 and math.isfinite(losses[0])
    out = capsys.readouterr().out
    assert f"optimizer={optimizer}" in out and "done: loss" in out
