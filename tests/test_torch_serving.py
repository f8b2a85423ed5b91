"""The port's serving (``repro_torch/training/serving.py``, the caches and
``decode_step`` of ``models/model.py``, ``decode_attention``) against the
JAX package's on tiny float32 configs of the attention families: full
attention (MHA, qkv bias), a sliding window shorter than the prompt (the
ring wraps), gemma2-like (local and global layers, GQA, both softcaps,
post-block norms, ``embed_scale``, tied embeddings), the prefix VLM
(pixtral) and the encoder-decoder (whisper, the cross-attention's static
cache).  For each: the prefill cache leaf by leaf, one decode step from
JAX's cache carried across, ``generate``'s tokens, and the port's decode
against its own full forward.  Also the window-bounded ring, the cache's
trip through interop, and ``launch/serve.py`` against ``generate``.  The
other block families are in tests/test_torch_serving_ssm.py;
tests/test_torch_serving_check.py states the tolerance."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.models import model as j_model
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as t_model
from repro_torch.training import serving as t_serving

import test_torch_serving_check as chk
import test_torch_zoo_check as zoo

torch.set_num_threads(2)

FAMILIES = ["full", "swa", "gemma2", "prefix", "encdec"]


@pytest.fixture(scope="module")
def results():
    """JAX's results, computed once a family (shared by the tests)."""
    done = {}

    def get(family):
        if family not in done:
            done[family] = chk.jax_results(family)
        return done[family]
    return get


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_cache_matches_jax(results, family):
    chk.check_prefill(results(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_step_from_jax_cache(results, family):
    chk.check_decode_step(results(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_matches_jax(results, family):
    chk.check_generate(results(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_matches_full_forward(results, family):
    chk.check_decode_matches_full_forward(results(family))


def test_sliding_window_cache_is_bounded():
    """A windowed layer's decode cache holds the window, not seq_len; a
    global layer seq_len slots (as the reference)."""
    jc = chk.family_config("gemma2")
    cache = chk.check_cache_shapes(jc, 2, 4096)
    assert cache["blocks"][0]["k"].shape[-3] == 6
    assert cache["blocks"][1]["k"].shape[-3] == 4096
    assert cache["blocks"][0]["k"].shape[0] == jc.n_repeats
    cache = t_model.init_decode_cache(zoo.port_cfg(jc), 2, 4096,
                                      device="cpu")
    assert int(cache["pos"]) == 4096 and cache["pos"].dtype == torch.int32
    assert torch.all(cache["blocks"][0]["slot_pos"] == -1)


def test_cache_round_trip_through_interop():
    """A bf16 JAX cache into the port and back, bit for bit, key for key,
    ``pos`` a 0-d int32 tensor; a position of another dtype refuses."""
    jc = chk.family_config("gemma2")
    jc = dataclasses.replace(jc, dtype="bfloat16")
    cache = chk.to_host(j_model.init_decode_cache(jc, 2, 16))
    rng = np.random.default_rng(0)
    k = cache["blocks"][0]["k"]
    cache["blocks"][0]["k"] = rng.standard_normal(k.shape).astype(k.dtype)
    cache["blocks"][0]["slot_pos"][:] = np.arange(6, dtype=np.int32)
    port = interop.cache_from_numpy(cache, "cpu")
    assert port["blocks"][0]["k"].dtype == torch.bfloat16
    assert port["pos"].shape == () and port["pos"].dtype == torch.int32
    back = interop.cache_to_numpy(port)
    for (ka, a), (kb, b) in zip(chk.leaves(cache), chk.leaves(back)):
        assert ka == kb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))
    with pytest.raises(ValueError):
        interop.cache_from_numpy(dict(cache, pos=np.int64(16)), "cpu")


def test_serve_launcher_matches_generate(capsys):
    """``launch/serve.py --device cpu`` on reduced minicpm-2b: its timing
    lines, and its tokens equal to ``generate`` on the same prompt and
    weights; without ``--device cpu`` it refuses (no GPU here)."""
    argv = ["--device", "cpu", "--arch", "minicpm-2b", "--reduced",
            "--batch", "2", "--prompt-len", "8", "--n-tokens", "4"]
    gen = t_serve.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=minicpm-2b ") and "device=cpu" in out[0]
    assert out[1].startswith("prefill 2x8 in ") and "tok/s" in out[1]
    assert out[2] == f"sample: {gen[0].tolist()}"
    cfg = t_registry.get_config("minicpm-2b").reduced()
    params = t_model.init_params(cfg, seed=0, device="cpu")
    prompt = t_serve.prompt_batch(cfg, 2, 8, 0, torch.device("cpu"))
    want = t_serving.generate(params, cfg, prompt["tokens"], 4)
    assert gen.shape == (2, 4)
    np.testing.assert_array_equal(gen, want.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            t_serve.main(argv[2:])
