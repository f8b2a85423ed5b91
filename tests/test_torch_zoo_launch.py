"""The launcher on the model zoo, ``--arch X --reduced --device cpu``, for
whisper-base (encoder frames with each batch), pixtral-12b (the patch
prefix), qwen2-moe-a2.7b and jamba-v0.1-52b (MoE, Mamba): finite losses,
MoE's aux loss in the metrics, and the chunk runner's metrics equal to
the per-step loop's float for float."""
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import train as t_train

torch.set_num_threads(2)


def _launch(tmp_path, name, chunk):
    log = tmp_path / f"{name}-{chunk}.json"
    final = t_train.main(["--arch", name, "--reduced", "--steps", "4",
                          "--global-batch", "2", "--seq-len", "16",
                          "--inv-freq", "2", "--log-every", "1", "--chunk",
                          str(chunk), "--device", "cpu", "--log-json",
                          str(log)])
    hist = json.loads(log.read_text())
    for m in hist:
        m.pop("wall_s")
    return final, hist


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "pixtral-12b",
                                  "qwen2-moe-a2.7b", "whisper-base"])
def test_launcher_trains_the_arch(tmp_path, capsys, name):
    final, per_step = _launch(tmp_path, name, 1)
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith(f"arch={name} ")
    assert "done: final loss" in out
    assert np.isfinite(final) and len(per_step) == 4
    assert all(np.isfinite(m["loss"]) for m in per_step)
    if "moe" in name or "jamba" in name:
        assert all(m["moe_aux"] > 0 for m in per_step)
    _, chunked = _launch(tmp_path, name, 3)
    assert chunked == per_step          # every metric, float for float
