"""The port's forward pass against ``repro/models/model.py`` on the same
weights (carried over with interop): logits, the ā statistics, the loss,
and the gradients — the probe gradients being exactly ḡ."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import bert_large as j_bert
from repro.core import stats as j_stats
from repro.models import model as j_model
from repro.training import loop as j_loop
from repro_torch import interop
from repro_torch.models import config as t_config
from repro_torch.models import model as t_model
from repro_torch.training import loop as t_loop

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _port_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["pattern"] = tuple(t_config.LayerSpec(**dataclasses.asdict(s))
                          for s in cfg.pattern)
    return t_config.ModelConfig(**kw)


def _configs(tiny_model_cfg):
    return {
        "tiny": tiny_model_cfg,
        "bert_reduced": j_bert.CONFIG.reduced(
            n_layers=3, d_model=64, head_dim=16, d_ff=128, vocab_size=100,
            vocab_pad_multiple=32),
        "bert_reduced_scan": j_bert.CONFIG.reduced(
            n_layers=2, d_model=32, head_dim=8, d_ff=64, vocab_size=64,
            scan_layers=True),
    }


def _flat(tree, pre=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{pre}/{i}"))
    else:
        out[pre] = np.asarray(tree, np.float32)
    return out


@pytest.mark.parametrize("which", ["tiny", "bert_reduced",
                                   "bert_reduced_scan"])
def test_forward_stats_and_grads_match(which, tiny_model_cfg):
    cfg = _configs(tiny_model_cfg)[which]
    params = j_model.init_params(jax.random.key(3), cfg)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 12)).astype(
                 np.int32)}
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        j_loop.make_loss_fn(cfg), has_aux=True))(params, batch)
    j_logits, _ = jax.jit(lambda p, b: j_model.forward(p, cfg, b))(
        params, batch)

    tcfg = _port_cfg(cfg)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    tb = t_loop.batch_to_device(batch, CPU)
    (t_loss, t_aux), t_grads = t_loop.value_and_grad(
        t_loop.make_loss_fn(tcfg), tp, tb)
    t_logits, _ = t_model.forward(tp, tcfg, tb)

    # float32 model: agreement to float32 rounding of sums taken in
    # another order
    np.testing.assert_allclose(np.asarray(j_logits),
                               t_logits.detach().numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(j_loss), float(t_loss), rtol=1e-6)
    js, ts = _flat(j_aux["stats"]), _flat(interop.tree_to_numpy(
        t_aux["stats"]))
    assert sorted(js) == sorted(ts) and js
    for k in js:
        np.testing.assert_allclose(js[k], ts[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    jg, tg = _flat(j_grads), _flat(interop.tree_to_numpy(t_grads))
    assert sorted(jg) == sorted(tg)
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-6)
        np.testing.assert_allclose(jg[k], tg[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    # the probe gradients are the ḡ statistics the optimizer reads
    for path in j_stats.iter_dense_layers(params):
        g_vec = j_stats.get_g_vec(j_grads, path)
        t_vec = j_stats.get_g_vec(t_grads, path)
        np.testing.assert_allclose(np.asarray(g_vec), t_vec.numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_probe_gradient_is_mean_output_gradient():
    """dL/dprobe == E_t[dℓ_t/dy_t] for a mean-reduced loss, in the port."""
    from repro_torch.models import layers
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(0)
    p = layers.dense_init(gen, 6, 4, dtype=torch.float32, device=CPU)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x = torch.tensor(rng.standard_normal((32, 6)), dtype=torch.float32)
    tgt = torch.tensor(rng.standard_normal((32, 4)), dtype=torch.float32)
    stats = {}
    y = layers.dense(p, x, stats=stats, name="d")
    loss = torch.mean(torch.sum((y - tgt) ** 2, -1) / 2)
    loss.backward()
    per_tok = (y.detach() - tgt) / x.shape[0]
    np.testing.assert_allclose(p["probe"].grad.numpy(),
                               per_tok.sum(0).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stats["d"]["a"].numpy(),
                               x.mean(0).numpy(), rtol=1e-6)


def test_bf16_forward_close():
    """bf16 weights and activations: agreement at bf16 resolution."""
    cfg = j_bert.CONFIG.reduced(n_layers=2, d_model=32, head_dim=8, d_ff=64,
                                vocab_size=64, dtype="bfloat16")
    params = j_model.init_params(jax.random.key(6), cfg)
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, 64, (2, 8)).astype(np.int32)}
    j_logits, _ = jax.jit(lambda p, b: j_model.forward(p, cfg, b))(
        params, batch)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    t_logits, _ = t_model.forward(tp, _port_cfg(cfg),
                                  t_loop.batch_to_device(batch, CPU))
    j = np.asarray(j_logits, np.float32)
    # bf16 rounds at other places in the two frameworks: a few bf16 ulps
    np.testing.assert_allclose(j, t_logits.float().numpy(), rtol=0,
                               atol=4 * 2 ** -8 * float(np.abs(j).max()))


def test_unsupported_blocks_raise():
    """A Mamba block (once refused here, before the model zoo was ported)
    builds, and its forward, stats and gradients match JAX's at
    tests/test_torch_zoo_check.py's tolerances."""
    import test_torch_zoo_check as zoo
    from repro.models import config as j_config
    cfg = t_config.ModelConfig(
        name="m", arch_type="ssm", n_layers=2, d_model=16, n_heads=2,
        n_kv_heads=2, d_ff=32, vocab_size=32,
        pattern=(t_config.LayerSpec(kind="mamba"),))
    params = t_model.init_params(cfg, device="cpu")
    assert params["blocks"][0]["mixer"]["A_log"].shape == (2, 32, 16)
    jcfg = j_config.ModelConfig(
        name="m", arch_type="ssm", n_layers=2, d_model=16, n_heads=2,
        n_kv_heads=2, d_ff=32, vocab_size=32,
        pattern=(j_config.LayerSpec(kind="mamba"),), dtype="float32",
        vocab_pad_multiple=1)
    assert zoo.port_cfg(jcfg).pattern == cfg.pattern
    zoo.forward_matches(jcfg)
