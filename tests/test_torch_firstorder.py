"""The port's functional first-order backends and schedules against
``repro/core/firstorder.py`` and ``repro/core/schedule.py``: same inputs
(numpy, seeded), same steps, float32 tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import firstorder as j_fo
from repro.core import schedule as j_sched
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import schedule as t_sched

torch.set_num_threads(2)
RTOL, ATOL = 2e-5, 1e-6          # float32 arithmetic in another order


def _tree(rng, dtype=np.float32):
    return {"a": {"w": rng.standard_normal((5, 3)).astype(dtype),
                  "probe": np.zeros(3, dtype)},
            "blocks": [{"scale": rng.standard_normal((2, 4)).astype(dtype)}],
            "zero": np.zeros((2, 2), dtype)}


def _close(jtree, ttree, rtol=RTOL, atol=ATOL):
    for a, b in zip(jax.tree.leaves(jtree),
                    jax.tree.leaves(interop.tree_to_numpy(ttree))):
        np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("lr", [1e-2, "cosine"])
@pytest.mark.parametrize("trust_clip", [10.0, None])
def test_lamb_k_steps_match(lr, trust_clip):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    j_lr = j_sched.warmup_cosine(1e-2, 2, 6) if lr == "cosine" else lr
    t_lr = t_sched.warmup_cosine(1e-2, 2, 6) if lr == "cosine" else lr
    j_opt = j_fo.lamb(j_lr, trust_clip=trust_clip)
    t_opt = t_fo.lamb(t_lr, trust_clip=trust_clip)
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.tree_from_numpy(params, "cpu")
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for _ in range(5):
        grads = _tree(rng)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, grads), js,
                              params=jp)
        tu, ts = t_opt.update(interop.tree_from_numpy(grads, "cpu"), ts,
                              params=tp)
        _close(ju, tu)
        jp, tp = j_fo.apply_updates(jp, ju), t_fo.apply_updates(tp, tu)
    _close(jp, tp)
    _close(js["m"], ts["m"])
    _close(js["v"], ts["v"])
    assert int(js["count"]) == ts["count"] == 5


def test_lamb_bf16_params_match():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    j_opt, t_opt = j_fo.lamb(1e-2), t_fo.lamb(1e-2)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                             _tree(rng))
        ju, js = j_opt.update(grads, js, params=jp)
        tu, ts = t_opt.update(
            interop.tree_from_numpy(jax.tree.map(np.asarray, grads), "cpu"),
            ts, params=tp)
        jp, tp = j_fo.apply_updates(jp, ju), t_fo.apply_updates(tp, tu)
    # bf16 parameters: one bf16 ulp (2^-8 relative) where a rounding flips
    _close(jp, tp, rtol=2 ** -7, atol=1e-6)


def test_global_norm_clip_chain_apply():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = interop.tree_from_numpy(tree, "cpu")
    np.testing.assert_allclose(float(j_fo.global_norm(jt)),
                               float(t_fo.global_norm(tt)), rtol=1e-6)
    j_opt = j_fo.chain(j_fo.clip_by_global_norm(0.5), j_fo.lamb(1e-2))
    t_opt = t_fo.chain(t_fo.clip_by_global_norm(0.5), t_fo.lamb(1e-2))
    ju, _ = j_opt.update(jt, j_opt.init(jt), params=jt)
    tu, _ = t_opt.update(tt, t_opt.init(tt), params=tt)
    _close(ju, tu)
    _close(j_fo.apply_updates(jt, ju), t_fo.apply_updates(tt, tu))


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)),
    ("warmup_linear", (1e-3, 5, 40, 1e-5)),
    ("warmup_cosine", (1e-3, 5, 40)),
    ("wsd", (1e-3, 4, 20, 10)),
    ("step_decay", (1e-1, (3, 7), 0.5)),
])
def test_schedules_match(name, args):
    jf, tf = getattr(j_sched, name)(*args), getattr(t_sched, name)(*args)
    for step in range(0, 45, 3):
        np.testing.assert_allclose(
            float(jf(jnp.asarray(step, jnp.int32))), tf(step), rtol=1e-6,
            atol=1e-12)
