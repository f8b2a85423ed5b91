"""The port end to end on the CPU: the train launcher in-process, the
GPU-by-default rule of the entry points, and the isolation of the port
from JAX and from the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import bert_large
from repro_torch.launch import train as t_train
from repro_torch.models import model as t_model

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def test_train_launcher_reduced_cpu(capsys):
    final = t_train.main(["--arch", "bert-large", "--reduced", "--steps",
                          "2", "--global-batch", "2", "--seq-len", "16",
                          "--inv-freq", "1", "--log-every", "1",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "step     1 loss=" in out
    assert "done: final loss" in out
    assert final == final and abs(final) < 1e3          # finite


def test_train_launcher_rank_and_staleness_cpu(capsys):
    final = t_train.main(["--arch", "bert-large", "--reduced", "--steps",
                          "3", "--global-batch", "2", "--seq-len", "16",
                          "--inv-freq", "2", "--rank", "2", "--staleness",
                          "1", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "rank=2 staleness=1" in out and "step     2 loss=" in out
    assert final == final and abs(final) < 1e3          # finite


@pytest.mark.parametrize("rank,staleness", [(1, 0), (2, 1)])
def test_train_launcher_quant_int8_cpu(capsys, rank, staleness):
    final = t_train.main(["--arch", "bert-large", "--reduced", "--steps",
                          "3", "--global-batch", "2", "--seq-len", "16",
                          "--inv-freq", "2", "--rank", str(rank),
                          "--staleness", str(staleness), "--quant", "int8",
                          "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"rank={rank} staleness={staleness} quant=int8" in out
    assert "step     2 loss=" in out and "done: final loss" in out
    assert final == final and abs(final) < 1e3          # finite


def test_train_launcher_lamb_only_cpu(capsys):
    t_train.main(["--arch", "bert-large", "--reduced", "--optimizer", "lamb",
                  "--steps", "1", "--global-batch", "1", "--seq-len", "8",
                  "--device", "cpu"])
    assert "done: final loss" in capsys.readouterr().out


def test_entry_points_ask_for_cuda_by_default():
    """Without a GPU, an entry point that was not asked for the CPU raises;
    it never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-GPU error path cannot run here")
    cfg = bert_large.CONFIG.reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_model.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--arch", "bert-large", "--reduced", "--steps", "1"])
    with pytest.raises(SystemExit, match="CUDA"):
        t_train.main(["--arch", "bert-large", "--reduced", "--steps", "1",
                      "--device", "cpu", "--use-kernels"])


def test_port_imports_no_jax_and_nothing_of_repro():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter without pulling in jax or the JAX package."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert "repro_torch.core.mkor" in modules and len(modules) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or m.startswith('jax'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_chip_smoke_without_cuda_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    env = dict(os.environ)
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
