"""The port's chunk runner (``training/loop.py``) on the CPU: its schedule
and batch stacking against the JAX package's, ``train_epoch`` against the
port's per-step loop bit for bit (losses, params, the whole state with its
counts) and against the JAX ``train_epoch``, its hooks and ``donate``, the
launcher's ``--chunk``, and the plain block route's solve.  On the CPU the
runner runs the steps eagerly; its CUDA graphs are held to the eager step
on the card (``tests/test_torch_cuda.py``)."""
import importlib
import itertools
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import firstorder as j_fo
from repro.data import pipeline as j_pipe
from repro.models import model as j_model
from repro.training import loop as j_loop
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.core import schedule as t_sched
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels import rank1_smw as t_rk
from repro_torch.launch import train as t_train
from repro_torch.models import model as t_model
from repro_torch.training import loop as t_loop

# the shared parity helpers (tests/ is on sys.path, pytest's default
# "prepend" import mode)
from test_torch_mkor_block import _max_err, _port_cfg

j_mkor = importlib.import_module("repro.core.mkor")
torch.set_num_threads(2)
CPU = torch.device("cpu")

# the cases of tests/test_analysis.py::test_chunk_schedule
SCHEDULE_CASES = [(100, 8), (7, 10), (0, 4), (5, 0)] + list(
    itertools.product((1, 2, 7, 50, 99, 100, 1000), (1, 2, 3, 8, 64)))

EPOCH_CASES = {
    "rank1-stagger": dict(inv_freq=3),
    "rank2-staleness1": dict(inv_freq=3, rank=2, staleness=1),
    "int8-rank1": dict(inv_freq=3, factor_quant="int8"),
    "lamb": None,
}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _assert_bit_equal(got, want):
    """Same key paths, and every leaf the same dtype, shape and bits."""
    got, want = dict(_paths(got)), dict(_paths(want))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert torch.equal(got[path], w), path


@pytest.mark.parametrize("steps,chunk", SCHEDULE_CASES)
def test_chunk_schedule_matches_reference(steps, chunk):
    got = t_loop.chunk_schedule(steps, chunk)
    assert got == j_loop.chunk_schedule(steps, chunk)
    assert sum(got) == steps and len(set(got)) <= 2


def test_stack_batches_matches_reference(tiny_model_cfg):
    ds = j_pipe.make_dataset(tiny_model_cfg, global_batch=2, seq_len=16)
    batches = [j_pipe.make_batch(ds, i) for i in range(3)]
    want = j_loop.stack_batches(batches)
    got = t_loop.stack_batches(batches)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def _tiny_run(tiny_model_cfg, kw, steps):
    """The tiny model through the port: a fresh state, the train step of
    mkor(lamb) (or LAMB alone) on a cosine schedule, and numpy batches."""
    cfg = _port_cfg(tiny_model_cfg)
    lr = t_sched.warmup_cosine(1e-2, 2, steps)
    opt = t_fo.lamb(lr) if kw is None else \
        t_mkor.mkor(t_fo.lamb(lr), t_mkor.MKORConfig(**kw))
    params = t_model.init_params(cfg, seed=0, device=CPU)
    ds = t_pipe.make_dataset(cfg, global_batch=2, seq_len=16, seed=0)
    return (t_loop.make_train_step(cfg, opt), params, opt.init(params),
            [t_pipe.make_batch(ds, i) for i in range(steps)])


@pytest.mark.parametrize("case", sorted(EPOCH_CASES))
def test_train_epoch_equals_per_step_loop(case, tiny_model_cfg):
    """7 steps in chunks of 3 (a trailing partial chunk) against the
    per-step loop: losses, params and the whole state, counts included,
    bit for bit; the hooks fire once per step, in order."""
    step, params, state, batches = _tiny_run(tiny_model_cfg,
                                             EPOCH_CASES[case], 7)
    p, s, losses = params, state, []
    for batch in batches:
        p, s, m = step(p, s, t_loop.batch_to_device(batch, CPU))
        losses.append(m["loss"])
    seen = []
    pe, se, hist = t_loop.train_epoch(
        step, params, state, batches, chunk=3,
        hooks=lambda i, m: seen.append((i, m["loss"])))
    assert [h["loss"] for h in hist] == [float(x) for x in losses]
    assert seen == [(i, float(x)) for i, x in enumerate(losses)]
    _assert_bit_equal((pe, se), (p, s))
    assert int(se["count"]) == 7 and se["count"].device.type == "cpu"


def test_train_epoch_matches_jax_train_epoch(tiny_model_cfg):
    """6 steps of mkor(lamb) in chunks of 4 through the port's and the
    JAX ``train_epoch`` from the same weights: the tolerances of the MKOR
    parity tests (tests/test_torch_mkor.py), fp32 state at fp32 tolerance
    and the bf16 factor banks at bf16's."""
    cfg = tiny_model_cfg
    kw = dict(inv_freq=2)
    j_opt = j_mkor.mkor(j_fo.lamb(1e-2), j_mkor.MKORConfig(**kw))
    t_opt = t_mkor.mkor(t_fo.lamb(1e-2), t_mkor.MKORConfig(**kw))
    jp = j_model.init_params(jax.random.key(0), cfg)
    tp = interop.params_from_numpy(jax.tree.map(np.array, jp), CPU)
    ds = j_pipe.make_dataset(cfg, global_batch=2, seq_len=16)
    batches = [j_pipe.make_batch(ds, i) for i in range(6)]
    jp, js, j_hist = j_loop.train_epoch(
        j_loop.make_train_step(cfg, j_opt), jp, j_opt.init(jp), batches,
        chunk=4, donate=False)
    tp, ts, t_hist = t_loop.train_epoch(
        t_loop.make_train_step(_port_cfg(cfg), t_opt), tp, t_opt.init(tp),
        batches, chunk=4)
    # float32 model and optimizer: float32 rounding in another order
    np.testing.assert_allclose([h["loss"] for h in j_hist],
                               [h["loss"] for h in t_hist], rtol=1e-5)
    assert _max_err(jp, tp) < 2e-4
    assert int(ts["count"]) == int(js["count"]) == 6
    assert int(ts["backend"]["count"]) == int(js["backend"]["count"]) == 6
    # bf16 banks: a rounding flip moves an entry by one bf16 ulp
    assert _max_err(js["factor_banks"], ts["factor_banks"]) <= 2 ** -6
    assert _max_err(js["backend"]["m"], ts["backend"]["m"]) < 1e-4


def _ae_step(opt):
    """A train step of the conftest autoencoder (tanh MLP, MSE against its
    input), the stats of each layer's input and its probe gradient feeding
    ``opt`` as the model's do."""
    def loss_fn(params, batch):
        h, stats = batch["x"], []
        layers = params["layers"]
        for i, layer in enumerate(layers):
            stats.append({"a": h.detach().mean(dim=0)})
            h = h @ layer["w"] + layer["b"] + layer["probe"]
            if i < len(layers) - 1:
                h = torch.tanh(h)
        return torch.mean(torch.square(h - batch["x"])), \
            {"stats": {"layers": stats}}

    def step(params, state, batch, scalars=None):
        (loss, aux), grads = t_loop.value_and_grad(loss_fn, params, batch)
        updates, state = opt.update(grads, state, params=params,
                                    stats=aux["stats"], scalars=scalars)
        return t_fo.apply_updates(params, updates), state, {"loss": loss}

    step.plan = opt.plan
    return step


def _ae_batches(n):
    rng = np.random.default_rng(0)
    basis = rng.standard_normal((8, 96)) / 3
    return [{"x": (rng.standard_normal((32, 8)) @ basis).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("donate", [True, False])
def test_autoencoder_epoch_hooks_and_donate(ae_params, donate):
    """The conftest autoencoder under mkor(lamb), 5 steps in chunks of 2
    through one runner over two epochs: each epoch equals the per-step
    loop bit for bit, the hooks fire once per step in order (the trailing
    chunk is partial), and the caller's tensors are left as they were."""
    opt = t_mkor.mkor(t_fo.lamb(1e-2),
                      t_mkor.MKORConfig(exclude=(), inv_freq=2))
    step = _ae_step(opt)
    params = interop.params_from_numpy(
        jax.tree.map(lambda x: np.array(x, copy=True), ae_params), CPU)
    state = opt.init(params)
    batches = _ae_batches(5)
    kept = [t.clone() for _, t in _paths((params, state))]
    runner = t_loop.make_chunk_runner(step, donate=donate)
    p, s = params, state
    for epoch in range(2):
        seen = []
        pe, se, hist = t_loop.train_epoch(
            step, p, s, batches, chunk=2, runner=runner,
            hooks=lambda i, m: seen.append(i))
        assert seen == list(range(5)) and len(hist) == 5
        for batch in batches:
            p, s, _ = step(p, s, t_loop.batch_to_device(batch, CPU))
        _assert_bit_equal((pe, se), (p, s))
    assert int(s["count"]) == 10
    for (path, t), k in zip(_paths((params, state)), kept):
        assert torch.equal(t, k), path


def _launch_lines(capsys, chunk):
    t_train.main(["--arch", "bert-large", "--reduced", "--steps", "7",
                  "--global-batch", "2", "--seq-len", "16", "--inv-freq",
                  "2", "--log-every", "2", "--chunk", str(chunk),
                  "--device", "cpu"])
    out = capsys.readouterr().out
    # the wall-clock column is all that may differ
    return [re.sub(r" \([0-9.]+s\)$", "", line)
            for line in out.splitlines()]


def test_launcher_chunk_prints_the_per_step_lines(capsys):
    per_step = _launch_lines(capsys, 1)
    chunked = _launch_lines(capsys, 3)
    assert chunked == per_step
    assert [ln.split()[1] for ln in per_step if ln.startswith("step")] == \
        ["0", "2", "4", "6"]


@pytest.mark.parametrize("b,r,d", [(6, 4, 1024), (3, 2, 64), (2, 1, 100),
                                   (1, 3, 33)])
def test_solve_mid_is_linalg_solve_on_cpu(b, r, d):
    """The plain block route's solve is ``torch.linalg.solve`` bit for bit
    on the CPU."""
    rng = np.random.default_rng(b * 100 + r)
    v = torch.from_numpy(rng.standard_normal((b, r, d)).astype(np.float32))
    mid = 0.81 * torch.eye(r) + 0.729 * (v @ v.mT) / d
    u = torch.from_numpy(rng.standard_normal((b, r, d)).astype(np.float32))
    assert torch.equal(t_rk.solve_mid(mid, u), torch.linalg.solve(mid, u))


def test_plans_give_the_branch_key_and_scalars():
    """LAMB's plan: its learning rate and bias corrections for the next
    step in float32; MKOR's: the count's residue mod inv_freq."""
    lr = t_sched.warmup_cosine(1e-2, 2, 10)
    lamb = t_fo.lamb(lr)
    state = {"count": t_fo.step_count(4)}
    key, scalars = lamb.plan(state)
    assert key == () and sorted(scalars) == ["bc1", "bc2", "lr"]
    assert all(isinstance(v, np.float32) for v in scalars.values())
    assert scalars["lr"] == np.float32(lr(4))
    assert scalars["bc1"] == np.float32(1) - np.float32(0.9) ** np.float32(5)
    opt = t_mkor.mkor(lamb, t_mkor.MKORConfig(inv_freq=3))
    mkey, mscalars = opt.plan({"count": t_fo.step_count(7),
                               "backend": state})
    assert mkey == (1, ()) and mscalars == scalars


def test_capture_failure_names_the_first_failing_line():
    """The runner's capture error names the line of the first exception of
    the chain, not the capture's own end."""
    def failing_op():
        raise RuntimeError("operation not permitted when stream is capturing")
    try:
        try:
            failing_op()
        except RuntimeError as first:
            raise RuntimeError("capture invalidated") from first
    except RuntimeError as exc:
        msg = t_loop._capture_failure(exc)
    assert re.search(r"test_torch_chunk\.py:\d+ `raise RuntimeError", msg)
    assert msg.endswith("RuntimeError: operation not permitted when stream "
                        "is capturing")
