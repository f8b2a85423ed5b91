"""The plain reference of a training cell: the model's loss and gradients,
MKOR's rank-1 factor updates and LAMB, in plain PyTorch.

It imports nothing of the program under test.  It works out again, from
the same initial weights and the same token batches, what the program is
meant to compute:

* the model: a stack of pre-norm transformer blocks (LayerNorm, attention
  with RoPE, a GELU MLP) under a vocabulary projection and a mean
  next-token cross-entropy.  Every dense layer is ``y = x W (+ b) +
  probe`` with a zero ``probe``, so that the probe's gradient is ḡ, the
  token mean of the output gradient, and its input's token mean is ā.
  The attention scores are (Σ_d q)(Σ_d k) per head and not q·k: that is
  what the model the program ports computes (its score einsum sums the q
  and k head dims apart), and the benchmark holds the program to it.
* MKOR (rank 1, staleness 0, paper variant, factors stored in bfloat16;
  γ, ζ and ε are the constants below): every eligible dense layer
  keeps L⁻¹ (d_out²) and R⁻¹ (d_in²).  Layers of one shape form a group
  whose inversions fall on the steps where ``count % inv_freq`` equals the
  group's index in the sorted group names (the staggered schedule).  On
  those steps each factor is stabilized (ε, ζ) and takes the rank-1
  update of Eq. 5/6 with ḡ (L) or ā (R); every step the weight gradient
  becomes R⁻¹ G L⁻¹, rescaled to the gradient's Frobenius norm per layer.
  Factors are held in the storage dtype (bfloat16): each update is
  worked out in float32 from the held value and rounded to it, after the
  stabilizer and after the SMW.
* LAMB (Adam moments, decoupled weight decay, per-leaf trust ratio
  clipped at 10) over the whole tree.  Under MKOR the probes' gradients
  and updates are zeroed (they are the stat taps); LAMB alone steps them
  like any bias.

The parameters are held in the configuration's dtype (bfloat16): each
step's new value is the float32 sum rounded to it.  Everything else runs
in float32 with TF32 off.  ``precision="fp8"`` is the control: every
value the program holds in bfloat16 is held in float8 e4m3 instead
(per-tensor scales), forward and back.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NEG_INF = -2.0 ** 30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# MKOR's constants, frozen from the defaults of the port's ``MKORConfig``
# (``core/mkor.py``), which the launcher's ``build_optimizer`` keeps
GAMMA = 0.9                      # factor momentum (Eqs. 3-6)
ZETA = 0.95                      # blend toward I (lines 5-6)
STABILIZER_THRESHOLD = 50.0      # ε, the ‖J‖∞ trigger
# the factors' storage dtype by the traffic's ``factor_quant``; the int8
# codes with their error feedback have no plain version here
FACTOR_DTYPE = {"none": torch.bfloat16, "bf16": torch.bfloat16}
PROJECTIONS = 4                  # random directions a leaf's moment is read in
PROJECTION_BLOCK = 1 << 24       # elements a generator call draws


# --------------------------------------------------------------------- #
# The parameter tree: nested dicts and lists, leaves stacked over layers
# --------------------------------------------------------------------- #
def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def padded_vocab(cfg: Dict) -> int:
    m = max(cfg.get("vocab_pad_multiple", 2048), 1)
    return -(-cfg["vocab_size"] // m) * m


def _dense_shapes(n: int, d_in: int, d_out: int, bias: bool) -> Dict:
    p = {"w": (n, d_in, d_out), "probe": (n, d_out)}
    if bias:
        p["b"] = (n, d_out)
    return p


def param_shapes(cfg: Dict) -> Dict:
    """The tree of leaf shapes, in the layout of the program's parameters
    (one pattern position of attention + dense MLP blocks)."""
    n, d, f = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    h, hk, dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    bias = bool(cfg.get("use_qkv_bias", False))
    v = padded_vocab(cfg)
    norm = {"scale": (n, d), "bias": (n, d)}
    block = {
        "pre_norm": dict(norm),
        "mixer": {"q": _dense_shapes(n, d, h * dh, bias),
                  "k": _dense_shapes(n, d, hk * dh, bias),
                  "v": _dense_shapes(n, d, hk * dh, bias),
                  "o": _dense_shapes(n, h * dh, d, False)},
        "mlp_norm": dict(norm),
        "mlp": {"in": _dense_shapes(n, d, f, False),
                "out": _dense_shapes(n, f, d, False)},
    }
    return {"embed": {"table": (v, d)},
            "final_norm": {"scale": (d,), "bias": (d,)},
            "blocks": [block],
            "lm_head": {"w": (d, v), "probe": (v,)}}


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """``{path: leaf}`` with ``/``-joined dict keys and list indices."""
    out: Dict[str, object] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and tree and not isinstance(
            tree[0], int):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_like(shapes, flat: Dict[str, object], prefix: str = ""):
    if isinstance(shapes, dict):
        return {k: unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                  else str(k)) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [unflatten_like(v, flat, f"{prefix}/{i}" if prefix
                               else str(i)) for i, v in enumerate(shapes)]
    return flat[prefix]


def leaf_init(path: str, shape) -> Tuple[str, float]:
    """How a leaf starts: ("normal", std) or ("const", value)."""
    name = path.rsplit("/", 1)[-1]
    if name == "w":
        return "normal", 1.0 / math.sqrt(shape[-2])
    if name == "table":
        return "normal", 0.02
    if name == "scale":
        return "const", 1.0
    return "const", 0.0                      # biases and probes


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` (in sorted path order): each
    leaf has its own stream, so one leaf can be drawn again alone."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63)


def leaf_dtype(path: str, dtype):
    """Norm parameters and probes are float32; weights, biases and the
    embedding are in the configuration's dtype."""
    last, parent = path.rsplit("/", 2)[-1], path.split("/")[-2]
    if last == "probe" or parent.endswith("norm"):
        return torch.float32
    return dtype


def init_leaf(cfg: Dict, seed: int, path: str, device) -> torch.Tensor:
    """One leaf of :func:`init_weights`, drawn alone from its own
    generator on ``device``."""
    shapes = flatten(param_shapes(cfg))
    kind, value = leaf_init(path, shapes[path])
    dt = leaf_dtype(path, DTYPES[cfg.get("dtype", "bfloat16")])
    if kind == "const":
        return torch.full(shapes[path], value, dtype=dt, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, sorted(shapes).index(path)))
    x = torch.randn(shapes[path], generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(value).to(dt)


def init_weights(cfg: Dict, seed: int, device) -> Dict:
    """The initial parameters from ``seed``: one generator call a leaf,
    on ``device``."""
    shapes = param_shapes(cfg)
    return unflatten_like(shapes, {path: init_leaf(cfg, seed, path, device)
                                   for path in flatten(shapes)})


# --------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------- #
def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (max |x| → 448),
    back in float32."""
    scale = 448.0 / x.abs().max().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8(torch.autograd.Function):
    """A value held in float8 e4m3: rounded going forward, its gradient
    rounded going back."""

    @staticmethod
    def forward(ctx, x):
        return _e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


class Model:
    """The forward pass in float32 over float32 copies of the weights.
    ``precision="fp8"`` (the control) holds in float8 e4m3, forward and
    back, every value the program holds in its working dtype: the
    weights as the products read them, the embeddings, the residual
    stream, the norms' outputs, q, k and v, the attention output, every
    dense output, the GELU's and the logits."""

    def __init__(self, cfg: Dict, precision: str = "fp32"):
        self.cfg, self.precision = cfg, precision
        self.hold = _Fp8.apply if precision == "fp8" else (lambda x: x)

    def dense(self, p: Dict, x: torch.Tensor, stats: Dict, name: str):
        stats[name] = x.detach().reshape(-1, x.shape[-1]).mean(dim=0)
        y = x @ self.hold(p["w"])
        if "b" in p:
            y = y + p["b"]
        return self.hold(y + p["probe"])

    def norm(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.get("norm_eps", 1e-6)
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return self.hold((x - mu) * torch.rsqrt(var + eps) * p["scale"]
                         + p["bias"])

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, H, dh): the halves rotated by position · θ^(-i/half)."""
        half = x.shape[-1] // 2
        idx = torch.arange(half, dtype=torch.float32, device=x.device)
        freq = self.cfg.get("rope_theta", 10000.0) ** (-idx / half)
        pos = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
        ang = pos[:, None] * freq                              # (S, half)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, p: Dict, x: torch.Tensor, stats: Dict):
        cfg = self.cfg
        h, hk, dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
        b, s, _ = x.shape
        q = self.dense(p["q"], x, stats, "q").reshape(b, s, h, dh)
        k = self.dense(p["k"], x, stats, "k").reshape(b, s, hk, dh)
        v = self.dense(p["v"], x, stats, "v").reshape(b, s, hk, dh)
        q, k = self.hold(self.rope(q)), self.hold(self.rope(k))
        scale = cfg.get("attn_scale") or 1.0 / math.sqrt(dh)
        # (Σ_d q)(Σ_d k): the scores of the model the program ports
        q_sum = (q * scale).reshape(b, s, hk, h // hk, dh).sum(dim=-1)
        k_sum = k.sum(dim=-1)
        scores = torch.einsum("bshg,bth->bhgst", q_sum, k_sum)
        pos = torch.arange(s, device=x.device)
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if cfg.get("causal", True):
            mask = mask & (pos[None, :] <= pos[:, None])
        window = cfg["pattern"][0].get("window")
        if window is not None:
            mask = mask & (pos[None, :] > pos[:, None] - window)
        scores = scores + torch.where(mask, 0.0, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = self.hold(torch.einsum("bhgst,bthd->bshgd", probs, v)
                        .reshape(b, s, -1))
        return self.dense(p["o"], out, stats, "o")

    def mlp(self, p: Dict, x: torch.Tensor, stats: Dict):
        hid = self.dense(p["in"], x, stats, "in")
        hid = self.hold(torch.nn.functional.gelu(hid, approximate="tanh"))
        return self.dense(p["out"], hid, stats, "out")

    def loss(self, params: Dict, tokens: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy and ā of every dense layer
        (``{path: (n_layers, d_in)}``, lm_head's ``(d_in,)``)."""
        cfg = self.cfg
        x = self.hold(params["embed"]["table"][tokens.long()])
        blk = params["blocks"][0]
        per_layer: List[Dict] = []
        for layer in range(cfg["n_layers"]):
            p = _index(blk, layer)
            st = {"mixer": {}, "mlp": {}}
            x = self.hold(x + self.attention(
                p["mixer"], self.norm(p["pre_norm"], x), st["mixer"]))
            x = self.hold(x + self.mlp(p["mlp"], self.norm(p["mlp_norm"], x),
                                       st["mlp"]))
            per_layer.append(st)
        st_head: Dict = {}
        logits = self.dense(params["lm_head"],
                            self.norm(params["final_norm"], x), st_head,
                            "lm_head")
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= cfg["vocab_size"], NEG_INF)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.long().reshape(-1))
        stats = {}
        for part, names in (("mixer", "qkvo"), ("mlp", ("in", "out"))):
            for name in names:
                stats[f"blocks/0/{part}/{name}"] = torch.stack(
                    [st[part][name] for st in per_layer])
        stats["lm_head"] = st_head["lm_head"]
        return loss, stats


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------- #
# MKOR (rank 1, staleness 0) and LAMB
# --------------------------------------------------------------------- #
def stabilize(j: torch.Tensor, eps: float, zeta: float) -> torch.Tensor:
    """Lines 5-6: blend toward I where max |J| > ε, then cap max |J| at ε,
    per (d, d) slice."""
    eye = torch.eye(j.shape[-1], dtype=j.dtype, device=j.device)
    norm = j.abs().amax(dim=(-2, -1), keepdim=True)
    j = torch.where(norm > eps, zeta * j + (1.0 - zeta) * eye, j)
    n2 = j.abs().amax(dim=(-2, -1), keepdim=True)
    return torch.where(n2 > eps, j * (eps / n2.clamp(min=1e-30)), j)


def smw_rank1(j: torch.Tensor, v: torch.Tensor, gamma: float):
    """Eq. 5/6: J ← γJ + (1−γ)/(γ²(1 + γ(1−γ) vᵀJv)) (Jv)(Jv)ᵀ, per
    slice of the leading dims."""
    u = (j @ v[..., None])[..., 0]
    s = (v * u).sum(dim=-1)[..., None, None]
    coef = (1.0 - gamma) / (gamma ** 2 * (1.0 + gamma * (1.0 - gamma) * s))
    return gamma * j + coef * (u[..., :, None] * u[..., None, :])


def factor_groups(flat: Dict[str, torch.Tensor], lo: int = 4,
                  hi: int = 32768) -> Dict[str, List[str]]:
    """MKOR's layers by shape: ``{"<d_in>x<d_out>_s<stack>": [layer
    paths, sorted]}``; a layer is a dense ``w`` outside the embedding and
    lm_head with both dims in [lo, hi]."""
    groups: Dict[str, List[str]] = {}
    for key, w in flat.items():
        layer = key[:-2]
        if not key.endswith("/w") or any(
                part in ("embed", "lm_head") for part in layer.split("/")):
            continue
        d_in, d_out = w.shape[-2], w.shape[-1]
        if not (lo <= d_in <= hi and lo <= d_out <= hi):
            continue
        stack = tuple(w.shape[:-2])
        gid = f"{d_in}x{d_out}" + ("_s" + "x".join(map(str, stack))
                                   if stack else "")
        groups.setdefault(gid, []).append(layer)
    return {gid: sorted(layers) for gid, layers in groups.items()}


class Optimizer:
    """LAMB, under MKOR where the traffic's optimizer (``opt``) names it.
    ``identity_factors`` is a fault: the precondition skipped, as if
    both factors were I."""

    def __init__(self, params_flat: Dict[str, torch.Tensor],
                 opt: Dict, identity_factors: bool = False):
        self.opt, self.count = opt, 0
        self.identity_factors = identity_factors
        self.m = {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params_flat.items()}
        self.v = {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params_flat.items()}
        self.factors: Dict[str, Dict[str, torch.Tensor]] = {}
        self.phase: Dict[str, int] = {}
        if opt["name"] == "mkor":
            quant = opt.get("factor_quant", "none")
            if opt.get("rank", 1) != 1 or opt.get("staleness", 0) != 0 \
                    or quant not in FACTOR_DTYPE:
                raise ValueError("the reference's MKOR is rank 1, staleness "
                                 f"0, factors {sorted(FACTOR_DTYPE)}: {opt}")
            self.factor_dtype = FACTOR_DTYPE[quant]
            self._init_factors(params_flat)

    def _init_factors(self, flat: Dict[str, torch.Tensor]) -> None:
        for index, (gid, layers) in enumerate(
                sorted(factor_groups(flat).items())):
            for layer in layers:
                w = flat[layer + "/w"]
                stack, (d_in, d_out) = tuple(w.shape[:-2]), w.shape[-2:]
                self.factors[layer] = {
                    side: torch.eye(d, dtype=self.factor_dtype,
                                    device=w.device).expand(
                        stack + (d, d)).clone()
                    for side, d in (("l_inv", d_out), ("r_inv", d_in))}
                self.phase[layer] = index % self.opt["inv_freq"]

    def precondition(self, grads: Dict[str, torch.Tensor],
                     stats_a: Dict[str, torch.Tensor]) -> Dict:
        """The gradients as LAMB takes them: MKOR's rescaled R⁻¹ G L⁻¹ for
        the eligible layers (after this step's inversions), the rest as
        they are, the probes zeroed."""
        o = self.opt
        out = dict(grads)
        for layer, fac in self.factors.items():
            if self.count % o["inv_freq"] == self.phase[layer]:
                for side, v in (("l_inv", grads[layer + "/probe"]),
                                ("r_inv", stats_a[layer])):
                    j = stabilize(fac[side].float(), STABILIZER_THRESHOLD,
                                  ZETA)
                    j = j.to(self.factor_dtype).float()
                    fac[side] = smw_rank1(j, v, GAMMA).to(self.factor_dtype)
            g = grads[layer + "/w"]
            delta = g if self.identity_factors else \
                fac["r_inv"].float() @ g @ fac["l_inv"].float()
            gn = g.square().sum(dim=(-2, -1), keepdim=True).sqrt()
            dn = delta.square().sum(dim=(-2, -1), keepdim=True).sqrt()
            out[layer + "/w"] = delta * (gn / dn.clamp(min=1e-30))
        for key in out:
            if key.endswith("/probe"):
                out[key] = torch.zeros_like(out[key])
        return out

    def lamb(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One LAMB step: the new parameters, each rounded to its dtype."""
        o = self.opt
        b1, b2, eps, wd = 0.9, 0.999, 1e-6, 0.01
        t = self.count + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        new = {}
        for key, p in params.items():
            g = grads[key].float()
            self.m[key] = b1 * self.m[key] + (1 - b1) * g
            self.v[key] = b2 * self.v[key] + (1 - b2) * g.square()
            pf = p.float()
            r = (self.m[key] / bc1) / ((self.v[key] / bc2).sqrt() + eps) \
                + wd * pf
            pn, rn = pf.norm(), r.norm()
            trust = torch.where((pn > 0) & (rn > 0),
                                pn / rn.clamp(min=1e-12),
                                torch.ones_like(pn)).clamp(max=10.0)
            upd = -o["lr"] * trust * r
            if self.factors and key.endswith("/probe"):
                upd = torch.zeros_like(upd)     # MKOR's stat taps stay 0
            new[key] = (pf + upd).to(p.dtype)
        return new


def leaf_norms(flat: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in flat.items()}


def moment_projections(moments: Dict[str, torch.Tensor], seed: int
                       ) -> Dict[str, List[float]]:
    """⟨m, z_k⟩ for each leaf's first moment m and ``PROJECTIONS`` standard
    normal directions z_k drawn from the seed (by leaf, in sorted path
    order of the parameter tree, and by block of the flattened leaf), on
    the leaf's device.  The same call on the program's moments and the
    reference's reads both in the same directions; the root mean square of
    the differences estimates ‖m_program − m_reference‖, which sees the
    direction the norms leave out."""
    order = sorted(moments)
    out = {}
    for path, m in moments.items():
        flat = m.detach().reshape(-1)
        base = leaf_seed(seed, order.index(path))
        dots = []
        for k in range(PROJECTIONS):
            total = 0.0
            for b0 in range(0, flat.numel(), PROJECTION_BLOCK):
                blk = flat[b0:b0 + PROJECTION_BLOCK].float()
                gen = torch.Generator(device=flat.device)
                gen.manual_seed((base + 104_729 * (k + 1)
                                 + 15_485_863 * (b0 // PROJECTION_BLOCK))
                                % (2 ** 63))
                z = torch.randn(blk.numel(), generator=gen,
                                dtype=torch.float32, device=flat.device)
                total += float(torch.dot(blk, z))
            dots.append(total)
        out[path] = dots
    return out


def offdiag_norms(factors: Dict[str, Dict[str, torch.Tensor]]
                  ) -> Dict[str, List[float]]:
    """Per factor (``<layer>/l_inv``, ``<layer>/r_inv``) the Frobenius norm
    of each stacked slice's off-diagonal part."""
    out = {}
    for layer, fac in factors.items():
        for side, j in fac.items():
            eye = torch.eye(j.shape[-1], dtype=torch.bool, device=j.device)
            off = j.float().masked_fill(eye, 0.0)
            out[f"{layer}/{side}"] = off.norm(dim=(-2, -1)).reshape(
                -1).tolist()
    return out


def run(cfg: Dict, opt: Dict, params: Dict, batches: List[Dict], seed: int,
        *, precision: str = "fp32", half_batch: bool = False,
        identity_factors: bool = False, stale_keys: int = 0) -> Dict:
    """Train ``len(batches)`` steps from ``params`` (the tree of
    :func:`init_weights` from ``seed``, on the device the run uses).
    Returns each step's loss, the per-leaf norms of the first step's
    gradients as LAMB takes them and of the change of each leaf over the
    steps, LAMB's first moment after the first step in seeded directions
    (:func:`moment_projections`: the first gradient, times 1 − β₁) and,
    under MKOR, the factors' off-diagonal norms (:func:`offdiag_norms`).  Faults: ``half_batch``, each step
    sees only the first half of its rows; ``identity_factors``, the
    precondition skipped; ``stale_keys``, of a run whose steps cycle over
    that many graphs, each first eager, then captured: each later step
    takes the batch its graph was captured with (a replay whose bound
    batch is never refreshed)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = Model(cfg, precision)
        start = flatten(params)
        flat = dict(start)
        optim = Optimizer(flat, opt, identity_factors)
        losses, first = [], None
        for i in range(len(batches)):
            stale = stale_keys and i >= 2 * stale_keys
            batch = batches[stale_keys + i % stale_keys if stale else i]
            tokens, labels = batch["tokens"], batch["labels"]
            if half_batch:
                tokens = tokens[: len(tokens) // 2]
                labels = labels[: len(labels) // 2]
            live = {k: p.detach().to(torch.float32, copy=True)
                    .requires_grad_(True)
                    for k, p in flat.items()}
            loss, stats = model.loss(unflatten_like(params, live), tokens,
                                     labels)
            keys = list(live)
            grads = torch.autograd.grad(loss, [live[k] for k in keys],
                                        allow_unused=True)
            grads = {k: torch.zeros_like(live[k]) if g is None else g
                     for k, g in zip(keys, grads)}
            del live
            if opt["name"] == "mkor":
                taken = optim.precondition(grads, stats)
            else:
                taken = grads
            if first is None:
                first = leaf_norms(taken)
            del grads, stats
            flat = optim.lamb(flat, taken)
            if optim.count == 0:
                grad_proj = moment_projections(optim.m, seed)
            optim.count += 1
            losses.append(float(loss.detach()))
            del taken, loss
        change = {k: float((flat[k].float() - start[k].float()).norm())
                  for k in flat}
        return {"losses": losses, "grad_norms": first,
                "change_norms": change, "grad_proj": grad_proj,
                "offdiag": offdiag_norms(optim.factors)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
