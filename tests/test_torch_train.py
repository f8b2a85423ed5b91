"""The port end to end on the CPU: the train launcher in-process (its
optimizers, and a run split by a checkpoint and resumed, bit-equal to an
unbroken one), the GPU-by-default rule of the entry points, and the
isolation of the port from JAX, the JAX package and msgpack."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
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


@pytest.mark.parametrize("optimizer", ["mkor_h", "sgd", "adamw", "eva"])
def test_train_launcher_optimizers_cpu(capsys, optimizer):
    final = t_train.main(["--arch", "bert-large", "--reduced", "--optimizer",
                          optimizer, "--steps", "3", "--global-batch", "2",
                          "--seq-len", "16", "--inv-freq", "2",
                          "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"optimizer={optimizer} " in out and "step     2 loss=" in out
    assert final == final and abs(final) < 1e3          # finite


def _health_lines(capsys, chunk):
    final = t_train.main(["--arch", "bert-large", "--reduced", "--steps",
                          "6", "--global-batch", "2", "--seq-len", "16",
                          "--inv-freq", "2", "--rank", "2", "--health",
                          "--chaos", "grad_nan@2", "--log-every", "1",
                          "--chunk", str(chunk), "--device", "cpu"])
    out = capsys.readouterr().out
    # the wall-clock column is all that may differ
    return final, [re.sub(r" \([0-9.]+s\)$", "", line)
                   for line in out.splitlines()]


def test_train_launcher_health_and_chaos_cpu(capsys):
    """``--health --chaos grad_nan@2``: finite losses, the same lines at
    ``--chunk 1`` and ``--chunk 4`` (the chunk crossing the injection)."""
    final, per_step = _health_lines(capsys, 1)
    final4, chunked = _health_lines(capsys, 4)
    assert "health chaos=grad_nan@2" in per_step[0]
    assert chunked == per_step and final4 == final
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in per_step
              if ln.startswith("step")]
    assert len(losses) == 6 and np.isfinite(losses).all()


@pytest.mark.parametrize("argv,match", [
    (["--chaos", "kill_shard@2"], "need --elastic"),
    (["--chaos", "grad_nan@2:0,drop_collective@3"], "need --elastic"),
    (["--optimizer", "lamb", "--chaos", "grad_nan@1"],
     "--chaos needs an MKOR optimizer"),
    (["--optimizer", "sgd", "--health"], "--health needs an MKOR optimizer"),
    (["--chaos", "gamma_ray@1"], "unknown chaos site"),
    (["--optimizer", "lamb", "--elastic"],
     "--elastic needs an MKOR optimizer")],
    ids=["host-site", "host-site-mixed", "chaos-lamb", "health-sgd",
         "unknown-site", "elastic-lamb"])
def test_train_launcher_health_and_chaos_exits(argv, match):
    with pytest.raises((SystemExit, ValueError), match=match):
        t_train.main(["--arch", "bert-large", "--reduced", "--steps", "1",
                      "--device", "cpu"] + argv)


def test_train_launcher_elastic_log_json_cpu(tmp_path, capsys):
    """``--elastic --log-json F --chaos drop_collective@2``: the dropped
    span is retried, the losses are the plain launcher's, and F holds
    every logged step with the reference's keys."""
    argv = ["--arch", "bert-large", "--reduced", "--steps", "4",
            "--global-batch", "2", "--seq-len", "16", "--inv-freq", "2",
            "--log-every", "1", "--chunk", "2", "--device", "cpu"]
    plain = t_train.main(argv + ["--log-json", str(tmp_path / "plain.json")])
    capsys.readouterr()
    final = t_train.main(argv + ["--elastic", "--chaos", "drop_collective@2",
                                 "--log-json", str(tmp_path / "el.json")])
    out = capsys.readouterr().out
    assert "elastic" in out.splitlines()[0]
    assert "[elastic] step 2: dispatch failed (chaos: collective dropped " \
        "at step 2); retry 1/2" in out
    hist = json.loads((tmp_path / "el.json").read_text())
    want = json.loads((tmp_path / "plain.json").read_text())
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    for h in hist:
        assert {"loss", "grad_norm", "step", "wall_s"} <= set(h)
    assert [h["loss"] for h in hist] == [h["loss"] for h in want]
    assert final == plain == hist[-1]["loss"]


def _resume_args(chunk, steps, ckpt_dir, every=0):
    return ["--arch", "bert-large", "--reduced", "--optimizer", "mkor_h",
            "--rank", "2", "--staleness", "1", "--schedule", "constant",
            "--steps", str(steps), "--global-batch", "2", "--seq-len", "16",
            "--inv-freq", "2", "--log-every", "1", "--chunk", str(chunk),
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(every),
            "--device", "cpu"]


@pytest.mark.parametrize("chunk", [1, 3])
def test_train_launcher_resume_is_bit_equal(tmp_path, capsys, chunk):
    """7 steps straight against 4 steps, a checkpoint, and a fresh
    ``main`` on the same ``--ckpt-dir`` for the other 3: the same final
    loss, and the final checkpoints (params and the whole MKOR-H state)
    the same arrays bit for bit.  The straight run saves at the chunk
    boundaries past every 3 steps and at the end."""
    straight, split = tmp_path / "straight", tmp_path / "split"
    final = t_train.main(_resume_args(chunk, 7, straight, every=3))
    assert sorted(os.listdir(straight)) == [
        "step_00000002", "step_00000005", "step_00000006"]
    t_train.main(_resume_args(chunk, 4, split))
    capsys.readouterr()
    resumed = t_train.main(_resume_args(chunk, 7, split))
    out = capsys.readouterr().out
    assert "restored checkpoint step 3 (data cursor 4)" in out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step")] == ["4", "5", "6"]
    assert resumed == final
    arrays = []
    for d in (straight, split):
        with np.load(d / "step_00000006" / "arrays.npz") as npz:
            arrays.append({k: npz[k] for k in npz.files})
    assert sorted(arrays[0]) == sorted(arrays[1]) and len(arrays[0]) > 50
    for k, a in arrays[0].items():
        b = arrays[1][k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    manifests = [(d / "step_00000006" / "manifest.msgpack").read_bytes()
                 for d in (straight, split)]
    assert manifests[0] == manifests[1]


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
    interpreter without pulling in jax, the JAX package or msgpack (the
    card's machine has none: the checkpoints use the port's codec)."""
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
        "('jax', 'jaxlib', 'repro', 'msgpack') or m.startswith('jax'))\n"
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
