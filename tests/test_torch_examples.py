"""The three examples of the PyTorch port (``examples/torch_quickstart.py``,
``torch_mkor_h_switching.py``, ``torch_train_lm_100m.py``) on the CPU at a
tiny number of steps: they run, print the reference examples' lines,
save checkpoints that restore, and import nothing of JAX or of the JAX
package.  ``chip_smoke.py`` path s runs them on the card."""
import ast
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch import checkpointing

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_mkor_h_switching", "torch_train_lm_100m")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_examples_import_no_jax(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names] + [n.module for n in ast.walk(tree)
                                 if isinstance(n, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]


def test_quickstart(capsys):
    losses = _load("torch_quickstart").main(["--device", "cpu", "--steps",
                                             "6"])
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    out = capsys.readouterr().out
    assert out.startswith("minicpm-2b: ") and "step   5  loss " in out
    assert "done" in out


def test_mkor_h_switching(capsys):
    """The controller's lines; with 20 steps and hybrid_min_steps 15 it
    may or may not switch, and says which."""
    switched = _load("torch_mkor_h_switching").main(
        ["--device", "cpu", "--steps", "20"])
    out = capsys.readouterr().out
    assert "step  10  loss " in out and "second-order=" in out
    assert (f"switched at step {switched}" in out) if switched is not None \
        else "no switch in 20 steps" in out


def test_train_lm_100m_with_checkpoints(tmp_path, capsys):
    """MKOR over LAMB, two steps, a checkpoint after step 1 (the other
    optimizers: tests/test_torch_examples_100m.py)."""
    mod = _load("torch_train_lm_100m")
    ckpt = tmp_path / "ckpt"
    losses = mod.main(["--device", "cpu", "--steps", "2", "--global-batch",
                       "2", "--seq-len", "16", "--ckpt-dir", str(ckpt),
                       "--ckpt-every", "1"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    out = capsys.readouterr().out
    assert "optimizer=mkor" in out and "done: loss" in out
    assert checkpointing.latest_step(str(ckpt)) == 1
    assert checkpointing.validate(str(ckpt), 1)
