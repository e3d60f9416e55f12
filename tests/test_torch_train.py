"""The port's single-card LM training (`repro_torch.models` under autograd,
`.optim.adamw`, `.data.pipeline`, `.checkpoint`, `.launch.steps`
`make_train_step` and `.launch.train`) against the reference's, on the
CPU, from numpy inputs made from a seed.

Both packages get the same weights: the reference's `init_model` tree,
carried across by `convert.lm_params_from_reference(..., train=True)`,
and the port's gradients go back into the reference's tree layout
through `convert.lm_tree_from_port`.  Tolerances, each per leaf as the
largest |port - reference| over the leaf's largest |reference|:

  * float32 (`dataclasses.replace(cfg, dtype="float32")`, all ten archs):
    1e-4 (measured at most 3e-6: XLA's and torch's float32 sums, exp and
    log round differently in the last bit).  Two leaves take another
    limit.  jamba holds its leaves in bf16 (its `param_dtype`), so its
    gradients are rounded to bf16 on both sides: one bf16 step, 2^-8.
    The mLSTM input-gate bias `bi` is a cancellation: the mixer's output
    is invariant to one shift of all input-gate logits wherever |n.q|
    binds the normaliser, so its gradient (1e-7 to 1e-3) is a sum of
    per-token terms of its gate weight `wi`'s size (~1), and float32
    rounding of those terms moves it by a few percent: at xlstm-350m
    reduced, seeds 1-6, the port against the jitted reference read up to
    4.1% of `bi`'s own largest |g| (seed 1, the one used here), the
    reference's eager gradient against its jitted one up to 2.2%.  `bi`
    is held at 0.1 of its own largest |g| (`BI_RTOL`): a zeroed
    gradient reads 1, a sign-flipped one 2.
  * bf16: yi-9b and qwen2-moe-a2.7b at 0.05 (measured 0.010 and 0.017),
    under the MoE routing rule of tests/test_torch_lm.py (a flipped
    top-k is cleared only at a one-bf16-step tie); xlstm-350m at 0.25,
    since its gates amplify bf16 rounding: the reference's own jitted and
    eager gradients differ by up to 0.19.  In bf16 `bi`'s gradient is
    below the terms' rounding (the reference's jitted and eager forms
    differ by about its own size), so it is held at `wi`'s scale there;
    the float32 test holds it at its own.  The loss within 1e-3 (xlstm:
    0.01) of its size.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.checkpoint import checkpoint as r_ckpt
from repro.core import interp as r_interp
from repro.core import ky as r_ky
from repro.data import pipeline as r_pipeline
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import transformer as r_tfm
from repro.optim import adamw as r_adamw
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.core import interp as t_interp
from repro_torch.core import ky as t_ky
from repro_torch.data import pipeline as t_pipeline
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tfm
from repro_torch.optim import adamw as t_adamw

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(r_configs.list_archs())
B, S = 2, 16
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_RTOL_BY_ARCH = {("xlstm-350m", "bfloat16"): 0.25}
BF16_STEP = 2.0 ** -8
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 1e-3}
LOSS_RTOL_BY_ARCH = {("xlstm-350m", "bfloat16"): 1e-2}
BI_RTOL = 0.1


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(autouse=True)
def _no_reference_moe_mesh(monkeypatch):
    """The reference's MoE reads its sharding axes from a module global
    that its mesh step factories set and never clear; a test in the same
    process that built a meshed step would leave them set, and the
    unmeshed reference calls here would then ask for a mesh."""
    monkeypatch.setattr(r_moe, "_MESH_CTX",
                        {"dp": None, "tp": None, "tp_size": 1})


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("win,dtype", [(0, "float32"), (32, "float32"),
                                       (0, "bfloat16")])
def test_flash_backward_matches_jax_grad(win, dtype):
    """dq, dk, dv of sum(flash(q, k, v)^2) against `jax.grad` of the
    reference's `flash_attention` (its `custom_vjp`) at
    tests/test_flash_attention.py's shapes (GQA 4/2, 64 positions in KV
    chunks of 32, so the causal mask crosses chunks): float32 within 1e-5
    of each gradient's largest |g|; bf16 within one bf16 step, 2^-8."""
    rng = np.random.default_rng(win + 3)
    q, k, v = (rng.normal(0, 1, s).astype(np.float32)
               for s in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    jdt = jnp.dtype(dtype)

    def loss(q, k, v):
        o = r_layers.flash_attention(q, k, v, 0, win, 32, 32)
        return (o.astype(jnp.float32) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (_t(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    out = t_layers.flash_attention(tq, tk, tv, 0, win, 32, 32)
    (out.float() ** 2).sum().backward()
    rtol = 1e-5 if dtype == "float32" else BF16_STEP
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == tdt
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(got.float().numpy() - w).max()
        assert err <= rtol * np.abs(w).max(), (err, np.abs(w).max())


def test_flash_backward_saves_no_chunk_loop():
    """Autograd records the flash attention as one node whose residuals
    are q, k, v, the output and the log-sum-exp (the chunk loop's carries
    are not kept), and with no gradient wanted it records nothing."""
    q = torch.randn(1, 64, 4, 8, requires_grad=True)
    k = torch.randn(1, 64, 2, 8, requires_grad=True)
    v = torch.randn(1, 64, 2, 8, requires_grad=True)
    out = t_layers.flash_attention(q, k, v, 0, 0, 16, 16)
    node = out.grad_fn
    assert type(node).__name__ == "_FlashAttentionBackward"
    assert [t.shape for t in node.saved_tensors] == [
        q.shape, k.shape, v.shape, out.shape, (1, 4, 16, 2, 2)]
    with torch.no_grad():
        assert t_layers.flash_attention(q, k, v).grad_fn is None


# ---------------------------------------------------------------------------
# the training loss and its gradients
# ---------------------------------------------------------------------------


def _setup(arch: str, dtype: str, seed: int = 1):
    """Both configs, the reference's weights and the port's training model
    holding them, and a batch (labels over the frontend positions too)."""
    r_cfg = dataclasses.replace(r_configs.get_config(arch).reduced(),
                                dtype=dtype)
    t_cfg = dataclasses.replace(t_configs.get_config(arch).reduced(),
                                dtype=dtype)
    params = r_tfm.init_model(jax.random.PRNGKey(seed), r_cfg)
    tree = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_reference(tree, t_cfg, "cpu", train=True)
    rng = np.random.default_rng(seed)
    front = r_cfg.frontend_len if r_cfg.frontend else 0
    batch = {"tokens": rng.integers(0, r_cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, r_cfg.vocab,
                                    (B, S + front)).astype(np.int32)}
    if r_cfg.frontend:
        batch["features"] = rng.normal(
            0, 1, (B, front, t_tfm.FRONTEND_DIM)).astype(np.float32)
    return r_cfg, t_cfg, params, tree, model, batch


def _leaf_rtol(arch, dtype, path):
    if arch.startswith("jamba"):
        return BF16_STEP
    if path[-1] == "bi" and dtype == "float32":
        return BI_RTOL
    return GRAD_RTOL_BY_ARCH.get((arch, dtype), GRAD_RTOL[dtype])


def _hold_grads(arch, dtype, got: dict, want: dict):
    """Every reference leaf's gradient against the port's, per leaf, at
    the leaf's own largest |g| (bf16 `bi` at its gate weight's)."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        keys = [p.key for p in path]
        g, node = got, want
        for key in keys:
            g = g[key]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (keys, g.shape, w.shape)
        scale = np.abs(w).max()
        if keys[-1] == "bi" and dtype != "float32":
            for key in keys[:-1]:
                node = node[key]
            scale = np.abs(np.asarray(node["wi"], np.float32)).max()
        err = np.abs(g - w).max()
        assert err <= _leaf_rtol(arch, dtype, keys) * scale, (
            keys, err, scale)


def _record_routing(monkeypatch):
    """Both packages' top-k expert sets and router logits at every MoE call
    of the loss, in call order (the reference's sent out of its jitted
    step by a debug callback)."""
    ref, port = [], []
    orig_r, orig_t = r_moe.moe_apply, t_moe.moe_apply

    def ref_wrap(p, x, cfg, moe):
        logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(
            cfg.act_dtype))
        jax.debug.callback(lambda lg: ref.append(np.asarray(
            lg, np.float32)), logits, ordered=True)
        return orig_r(p, x, cfg, moe)

    def port_wrap(p, x, cfg, moe, **kw):
        port.append((x @ p["router"].to(x.dtype)).detach().float().numpy())
        return orig_t(p, x, cfg, moe, **kw)

    monkeypatch.setattr(r_moe, "moe_apply", ref_wrap)
    monkeypatch.setattr(t_moe, "moe_apply", port_wrap)
    return ref, port


def _routing_flips(ref, port, k: int) -> int:
    """Tokens whose top-k expert set differs between the two sides; each
    must sit at a one-bf16-step tie of the reference's k-th and (k+1)-th
    router logits (tests/test_torch_lm.py's rule)."""
    jax.effects_barrier()
    flips = 0
    # the port's remat recomputes each superblock in the backward: its
    # first len(ref) calls are the forward's
    for lr, lt in zip(ref, port[:len(ref)]):
        pick = lambda lg: np.sort(np.argsort(-lg, -1, kind="stable")[
            ..., :k], -1)
        differ = (pick(lr) != pick(lt)).any(-1)
        srt = -np.sort(-lr, -1)
        step = 2.0 ** (np.floor(np.log2(np.abs(srt[..., k - 1]))) - 7)
        tie = srt[..., k - 1] - srt[..., k] <= step
        assert tie[differ].all(), np.nonzero(differ)
        flips += int(differ.sum())
    return flips


def _loss_and_grads(arch, dtype, monkeypatch=None, seed: int = 1):
    r_cfg, t_cfg, params, _, model, batch = _setup(arch, dtype, seed)
    rec = (_record_routing(monkeypatch)
           if r_cfg.moe is not None and monkeypatch is not None else None)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_tfm.train_loss(p, r_cfg, {
            k: jnp.asarray(v) for k, v in batch.items()})))(params)
    leaves = t_tfm.train_leaves(model, t_cfg)
    t_loss = t_tfm.train_loss(model, t_cfg, {k: _t(v) for k, v in
                                             batch.items()})
    grads = torch.autograd.grad(t_loss, list(leaves.values()))
    flips = (_routing_flips(*rec, r_cfg.moe.top_k)
             if rec is not None else 0)
    return (float(r_loss), float(t_loss), jax.tree.map(np.asarray, r_grads),
            convert.lm_tree_from_port(dict(zip(leaves, grads)), t_cfg),
            flips)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_float32(arch):
    """`train_loss` (mean cross-entropy plus the MoE switch losses) and
    the gradient of every leaf against `jax.jit(jax.value_and_grad(
    train_loss))`, float32 activations, on the same weights and batch."""
    r_loss, t_loss, want, got, _ = _loss_and_grads(arch, "float32")
    assert abs(t_loss - r_loss) <= LOSS_RTOL["float32"] * abs(r_loss)
    _hold_grads(arch, "float32", got, want)


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-moe-a2.7b", "xlstm-350m"])
def test_train_loss_and_grads_match_reference_bfloat16(arch, monkeypatch):
    """The same in bf16 activations (float32 leaves), at the tolerances of
    the module docstring; an MoE token whose routing flips is cleared
    only at a one-bf16-step tie (and none flips at this seed)."""
    r_loss, t_loss, want, got, flips = _loss_and_grads(arch, "bfloat16",
                                                       monkeypatch)
    rtol = LOSS_RTOL_BY_ARCH.get((arch, "bfloat16"), LOSS_RTOL["bfloat16"])
    assert abs(t_loss - r_loss) <= rtol * abs(r_loss)
    assert flips == 0
    _hold_grads(arch, "bfloat16", got, want)


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-moe-a2.7b"])
def test_remat_dots_equals_nothing(arch):
    """The "dots" policy (projections kept, the rest recomputed) and
    "nothing" (each superblock recomputed) give one loss and one gradient,
    bit for bit: remat changes what is stored, not what is computed.
    What "dots" keeps: its backward runs no product without a batch axis
    but the gradients' two for each of the forward's (`aten.mm`), where
    "nothing" recomputes the projections too; the batched products (the
    attention's) are recomputed under both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for name in self.n:
                self.n[name] += func is getattr(torch.ops.aten, name).default
            return func(*args, **(kwargs or {}))

    _, t_cfg, _, _, model, batch = _setup(arch, "float32")
    tb = {k: _t(v) for k, v in batch.items()}
    leaves = list(t_tfm.train_leaves(model, t_cfg).values())
    out, fwd, bwd = [], {}, {}
    for policy in ("nothing", "dots"):
        with Products() as f:
            loss = t_tfm.train_loss(model, t_cfg, tb, remat_policy=policy)
        with Products() as b:
            out.append((loss, torch.autograd.grad(loss, leaves)))
        fwd[policy], bwd[policy] = f.n, b.n
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert fwd["dots"] == fwd["nothing"] and fwd["dots"]["mm"] > 0
    assert bwd["dots"]["mm"] == 2 * fwd["dots"]["mm"]
    assert bwd["nothing"]["mm"] > bwd["dots"]["mm"]
    assert bwd["nothing"]["bmm"] == bwd["dots"]["bmm"] > 0
    with pytest.raises(ValueError, match="remat"):
        t_tfm.train_loss(model, t_cfg, tb, remat_policy="everything")


@pytest.mark.parametrize("s", [16, 1])
def test_moe_aux_loss_matches_reference(s):
    """The switch loss `moe_apply(..., aux=True)` returns, in float32 over
    the routed groups' axes, against the reference's `moe_apply` aux: per
    row (S = 16) and for a decode group of the batch's 4 tokens (S = 1);
    within 1e-6 of it.  Without `aux` the output alone, unchanged."""
    r_cfg = dataclasses.replace(
        r_configs.get_config("qwen2-moe-a2.7b").reduced(), dtype="float32")
    t_cfg = dataclasses.replace(
        t_configs.get_config("qwen2-moe-a2.7b").reduced(), dtype="float32")
    p = r_moe.init_moe(jax.random.PRNGKey(2), r_cfg, r_cfg.moe)
    tp = t_layers.Params(**{
        k: (t_layers.Params(**{n: _t(w) for n, w in v.items()})
            if isinstance(v, dict) else _t(v)) for k, v in p.items()})
    b = 2 if s > 1 else 4
    x = np.random.default_rng(s).normal(0, 1, (b, s, r_cfg.d_model)
                                        ).astype(np.float32)
    want_y, want_aux = jax.jit(lambda p, x: r_moe.moe_apply(
        p, x, r_cfg, r_cfg.moe))(p, jnp.asarray(x))
    y, aux = t_moe.moe_apply(tp, _t(x), t_cfg, t_cfg.moe, aux=True)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    assert torch.equal(t_moe.moe_apply(tp, _t(x), t_cfg, t_cfg.moe), y)


# ---------------------------------------------------------------------------
# the training model and its tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-1.5-large-398b",
                                  "xlstm-350m"])
def test_training_model_holds_the_reference_leaves(arch):
    """A training model holds every leaf in the parameter type (Mamba's
    `a_log` and `d_skip` float32), trainable; `init_model(train=True)`
    and the converter give the same names, shapes and types, the
    converter the reference's values, and `lm_tree_from_port` carries
    them back into the reference's tree; `train_leaves` runs in the
    reference's leaf order."""
    r_cfg, t_cfg, _, tree, model, _ = _setup(arch, "bfloat16")
    fresh = t_tfm.init_model(t_cfg, seed=0, device="cpu", train=True)
    kinds = lambda m: {n: (tuple(p.shape), p.dtype, p.requires_grad)
                       for n, p in m.named_parameters()}
    assert kinds(fresh) == kinds(model)
    pdt = getattr(torch, t_cfg.param_dtype)
    for n, p in model.named_parameters():
        want = torch.float32 if n.endswith(("a_log", "d_skip")) else pdt
        assert p.dtype == want and p.requires_grad, n
    back = convert.lm_tree_from_port(dict(model.named_parameters()), t_cfg)
    want_flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got_flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in got_flat] == [k for k, _ in want_flat]
    for (_, g), (_, w) in zip(got_flat, want_flat):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    order = [t_tfm.reference_path(n, t_cfg)[:-1] if n.startswith("blocks")
             else (n,) for n in t_tfm.train_leaves(model, t_cfg)]
    ref_order = [tuple(p.key for p in path) for path, _ in want_flat]
    n_super = t_cfg.n_super
    assert order == [p for p in ref_order for _ in range(
        n_super if p[0] == "super" else 1)]


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-moe-a2.7b", "xlstm-350m",
                                  "jamba-1.5-large-398b"])
def test_serving_never_casts_a_weight(arch):
    """A serving model stays frozen in the activation type, and its prefill
    and decode cast no weight to it: of every op dispatched, none copies a
    tensor sharing a weight's storage into the activation type (the casts
    at each use that a training model needs are the tensor itself here;
    the float32 reads of bf16 gate biases are the reference's, and
    unchanged); no autograd graph is recorded."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = t_configs.get_config(arch).reduced()
    model = t_tfm.init_model(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    weights = {p.untyped_storage().data_ptr() for p in model.parameters()}
    copies = []

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            src = args[0] if args else None
            if (func is torch.ops.aten._to_copy.default
                    and (kwargs or {}).get("dtype") == cfg.act_dtype
                    and src.untyped_storage().data_ptr() in weights):
                copies.append(str(func))
            return func(*args, **(kwargs or {}))

    toks = torch.zeros((2, 8), dtype=torch.int32)
    with Copies():
        logits, caches = t_tfm.prefill(model, cfg, {"tokens": toks})
        caches = t_tfm.grow_attn_caches(caches, cfg, 1)
        t_tfm.decode_step(model, cfg, toks[:, :1], caches, 8)
    assert copies == []
    assert logits.grad_fn is None


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


SHAPES = {"blocks.0.w": (3, 40), "blocks.0.b": (40,), "final_norm": (40,),
          "head": (2, 5, 7)}


def _ndim_decays(name: str, leaf: torch.Tensor) -> bool:
    """The reference's decay rule on leaves laid out as its own."""
    return leaf.ndim >= 2


@pytest.mark.parametrize("grad_scale", [1e-3, 3.0])  # unclipped, clipped
def test_adamw_update_matches_reference(grad_scale):
    """One `update` from step 5 (warmup 10 of 200): params, moments, step,
    `grad_norm` and `lr` against the reference's `update` on the same
    numbers.  Bit for bit against the reference run op by op (every op is
    correctly rounded there); against its jitted form within one ulp on
    params and v, and m within one rounding of its operands (XLA contracts
    b1 * m + (1 - b1) * g into a fused multiply-add).  The decay rule is
    the reference's on these leaves: two or more axes (`final_norm` and
    `blocks.0.b`, of one axis, are not decayed)."""
    rng = np.random.default_rng(int(grad_scale * 10))
    draw = lambda sd, pos=False: {
        n: (np.abs if pos else np.asarray)(rng.normal(0, sd, s)).astype(
            np.float32) for n, s in SHAPES.items()}
    p, g, m, v = draw(1.0), draw(grad_scale), draw(0.01), draw(0.01, True)
    r_cfg = r_adamw.AdamWConfig(warmup_steps=10, total_steps=200)
    t_cfg = t_adamw.AdamWConfig(warmup_steps=10, total_steps=200)
    j = lambda d: {n: jnp.asarray(a) for n, a in d.items()}
    r_state = {"m": j(m), "v": j(v), "step": jnp.asarray(5, jnp.int32)}
    eager = r_adamw.update(j(p), j(g), r_state, r_cfg)
    jitted = jax.jit(lambda *a: r_adamw.update(*a, r_cfg))(j(p), j(g),
                                                           r_state)
    tt = lambda d: {n: _t(a.copy()) for n, a in d.items()}
    tp = tt(p)
    t_state = {"m": tt(m), "v": tt(v),
               "step": torch.tensor(5, dtype=torch.int32)}
    out_p, out_s, metrics = t_adamw.update(tp, tt(g), t_state, t_cfg,
                                           decays=_ndim_decays)
    assert out_p is tp and out_s is t_state and int(out_s["step"]) == 6
    bits = lambda a: np.asarray(a, np.float32).view(np.int32).astype(
        np.int64)
    for (rp, rs, rm), exact in ((eager, True), (jitted, False)):
        assert int(rs["step"]) == 6
        for name in ("grad_norm", "lr"):
            assert bits(rm[name]) == bits(metrics[name].numpy()), name
        for n in SHAPES:
            for want, got, part in ((rp[n], tp[n], "p"),
                                    (rs["v"][n], t_state["v"][n], "v"),
                                    (rs["m"][n], t_state["m"][n], "m")):
                d = np.abs(bits(want) - bits(got.numpy()))
                if exact:
                    assert d.max() == 0, (n, part)
                elif part != "m":
                    assert d.max() <= 1, (n, part)
                else:  # scale <= 1: |g| bounds the scaled gradient
                    ops = (r_cfg.beta1 * np.abs(m[n])
                           + (1 - r_cfg.beta1) * np.abs(g[n]))
                    err = np.abs(np.asarray(want) - got.numpy())
                    assert (err <= 2.0 ** -22 * ops).all(), (n, part)


def test_adamw_schedule_and_defaults_match_reference():
    """`schedule` at steps 0, 5, 10, 55 and 100 (warmup 10 of 100, then
    the cosine, then its floor) within 4 ulps of the reference's jitted
    one (cos rounds differently in the last bits; measured 0); the config
    and `default_opt_cfg` are the reference's."""
    r_cfg = r_adamw.AdamWConfig(warmup_steps=10, total_steps=100)
    t_cfg = t_adamw.AdamWConfig(warmup_steps=10, total_steps=100)
    assert dataclasses.asdict(r_cfg) == dataclasses.asdict(t_cfg)
    sched = jax.jit(lambda s: r_adamw.schedule(r_cfg, s))
    for step in (0, 5, 10, 55, 100):
        want = np.float32(sched(jnp.asarray(step, jnp.int32)))
        got = t_adamw.schedule(t_cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(int(want.view(np.int32))
                   - int(got.numpy().view(np.int32))) <= 4, step
    for arch in ("yi-9b", "jamba-1.5-large-398b"):
        from repro.launch import steps as r_steps

        assert dataclasses.asdict(t_steps.default_opt_cfg(
            t_configs.get_config(arch))) == dataclasses.asdict(
                r_steps.default_opt_cfg(r_configs.get_config(arch)))


def test_adamw_bf16_moments_round_as_the_reference():
    """Moments held in bf16 (`moment_dtype`, the >2e11-parameter default)
    and a bf16 leaf: updated in float32, rounded back, as the reference's
    op-by-op update rounds them."""
    rng = np.random.default_rng(4)
    p = rng.normal(0, 1, (8, 16)).astype(np.float32)
    g = rng.normal(0, 0.1, (8, 16)).astype(np.float32)
    cfg = dict(warmup_steps=2, total_steps=10, moment_dtype="bfloat16")
    r_cfg, t_cfg = r_adamw.AdamWConfig(**cfg), t_adamw.AdamWConfig(**cfg)
    rp = {"w": jnp.asarray(p, jnp.bfloat16)}
    rs = r_adamw.init(rp, r_cfg)
    tp = {"w": _t(p).to(torch.bfloat16)}
    ts = t_adamw.init(tp, t_cfg)
    for _ in range(3):
        rp, rs, _ = r_adamw.update(rp, {"w": jnp.asarray(g, jnp.bfloat16)},
                                   rs, r_cfg)
        t_adamw.update(tp, {"w": _t(g).to(torch.bfloat16)}, ts, t_cfg,
                       decays=_ndim_decays)
    for want, got in ((rp["w"], tp["w"]), (rs["m"]["w"], ts["m"]["w"]),
                      (rs["v"]["w"], ts["v"]["w"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


def test_synthetic_and_bin_corpus_batches_are_the_references(tmp_path):
    """`SyntheticLM` and `BinCorpus` (over a token file written here) give
    the reference's arrays for the same (seed, step), and `to_device`
    keeps them."""
    for seed in (0, 3):
        r = r_pipeline.SyntheticLM(256, 32, 4, seed=seed)
        t = t_pipeline.SyntheticLM(256, 32, 4, seed=seed)
        for step in (0, 1, 7):
            want, got = r.batch(step), t.batch(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == np.int32
    path = tmp_path / "corpus.bin"
    np.random.default_rng(5).integers(0, 60_000, 4096).astype(
        np.uint16).tofile(path)
    r = r_pipeline.BinCorpus(str(path), 1000, 16, 3, seed=2)
    t = t_pipeline.BinCorpus(str(path), 1000, 16, 3, seed=2)
    for step in (0, 4):
        want, got = r.batch(step), t.batch(step)
        dev = t_pipeline.to_device(got, "cpu")
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
            assert dev[k].dtype == torch.int32
            np.testing.assert_array_equal(dev[k].numpy(), want[k])
    with pytest.raises(ValueError, match="too small"):
        t_pipeline.BinCorpus(str(path), 1000, 5000, 3)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"blocks.0.core.wq": torch.randn(4, 6, generator=g),
                       "blocks.0.norm1": torch.randn(6, generator=g).to(
                           torch.bfloat16),
                       "embed": torch.randn(10, 6, generator=g)},
            "opt": {"m": {"embed": torch.randn(10, 6, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_round_trip_rotation_and_atomic_rename(tmp_path):
    """`save` writes `ckpt_<step:010d>` (manifest and npz) by renaming its
    `tmp.<step>`; `restore` gives back every leaf bit for bit in its type
    (bf16 stored widened to float32, the manifest keeping "bfloat16");
    `latest_step` skips a directory without a manifest (a write cut
    short); `rotate` keeps the last ones; a shape mismatch raises."""
    base = str(tmp_path / "ck")
    tree = _tree()
    for step in (2, 4, 6):
        final = t_ckpt.save(base, step, tree, extra={"arch": "x"})
        assert final.endswith(f"ckpt_{step:010d}")
    assert not any(d.startswith("tmp.") for d in os.listdir(base))
    os.makedirs(os.path.join(base, f"ckpt_{9:010d}"))  # no manifest
    os.makedirs(os.path.join(base, "tmp.8"))  # a write cut short
    assert t_ckpt.latest_step(base) == 6
    manifest, back = t_ckpt.restore(base, 6, like=tree)
    assert manifest["step"] == 6 and manifest["extra"] == {"arch": "x"}
    dtypes = {rec["path"]: rec["dtype"] for rec in manifest["leaves"]}
    assert dtypes["params/blocks.0.norm1"] == "bfloat16"
    _, stored = t_ckpt.restore(base, 6)
    assert stored["params/blocks.0.norm1"].dtype == np.float32
    for part in ("params", "opt"):
        flat = t_ckpt._flatten(tree[part])
        got = dict(t_ckpt._flatten(back[part]))
        for path, leaf in flat:
            assert got[path].dtype == leaf.dtype
            assert torch.equal(got[path], leaf), path
    t_ckpt.rotate(base, keep_last=2)
    assert t_ckpt.latest_step(base) == 6
    assert sorted(d for d in os.listdir(base) if d.startswith("ckpt_")) == [
        f"ckpt_{s:010d}" for s in (6, 9)]
    bad = {"params": {**tree["params"], "embed": torch.zeros(3, 6)},
           "opt": tree["opt"]}
    with pytest.raises(ValueError, match="embed"):
        t_ckpt.restore(base, 6, like=bad)
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None


def test_reference_restore_reads_a_port_checkpoint(tmp_path):
    """The reference's `restore(like=None)` reads a port checkpoint: the
    same paths (keys joined by "/", sorted as its pytree flattening sorts
    them) and the same arrays; and the port reads the reference's."""
    base = str(tmp_path / "ck")
    tree = _tree()
    t_ckpt.save(base, 3, tree)
    manifest, by_path = r_ckpt.restore(base, 3)
    _, port = t_ckpt.restore(base, 3)
    assert list(by_path) == list(port)
    assert list(by_path) == [
        "opt/m/embed", "opt/step", "params/blocks.0.core.wq",
        "params/blocks.0.norm1", "params/embed"]
    for path, arr in by_path.items():
        np.testing.assert_array_equal(arr, port[path])
    np.testing.assert_array_equal(
        by_path["params/embed"], tree["params"]["embed"].numpy())
    ref_tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)},
                "step": np.asarray(4, np.int32)}
    r_ckpt.save(base, 5, ref_tree)
    like = {"a": {"b": torch.zeros(2, 3)},
            "step": torch.tensor(0, dtype=torch.int32)}
    _, got = t_ckpt.restore(base, 5, like=like)
    np.testing.assert_array_equal(got["a"]["b"].numpy(), ref_tree["a"]["b"])
    assert int(got["step"]) == 4


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------


def test_train_step_matches_reference_step():
    """`make_train_step`'s step against the reference's jitted
    `make_train_step` (float32, yi-9b reduced; AdamW warmup 10): the loss
    within 1e-6 and `grad_norm` within 1e-5 of their sizes, `lr` bit for
    bit, and every updated leaf within 2e-6 of its largest |value| plus
    1% of lr (an element moves by lr * g / (|g| + eps) in a first step,
    which amplifies the relative error of a gradient element near eps).
    The decay rule is the reference's: it decays leaves of two or more
    axes, and it stacks every block leaf over the superblocks, so the
    norms (one axis a layer here) decay too."""
    from repro.launch import steps as r_steps

    r_cfg, t_cfg, params, _, model, batch = _setup("yi-9b", "float32")
    r_opt = r_adamw.AdamWConfig(warmup_steps=10, total_steps=50)
    t_opt = t_adamw.AdamWConfig(warmup_steps=10, total_steps=50)
    r_step, _ = r_steps.make_train_step(r_cfg, None, r_opt)
    new, _, r_metrics = r_step(params, r_adamw.init(params, r_opt),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    step = t_steps.make_train_step(t_cfg, None, t_opt)
    leaves = t_tfm.train_leaves(model, t_cfg)
    state = t_adamw.init(leaves, t_opt)
    out, state, metrics = step(model, state, {k: _t(v) for k, v in
                                              batch.items()})
    assert out is model and int(state["step"]) == 1
    for name, rtol in (("loss", 1e-6), ("grad_norm", 1e-5)):
        want = float(r_metrics[name])
        assert abs(float(metrics[name]) - want) <= rtol * abs(want), name
    assert float(metrics["lr"]) == float(r_metrics["lr"])
    got = convert.lm_tree_from_port(dict(model.named_parameters()), t_cfg)
    lr = float(r_metrics["lr"])
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(new)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= 2e-6 * np.abs(w).max() + 0.01 * lr, \
            path
    ref_ndim = {tuple(p.key for p in path): np.ndim(w) for path, w in
                jax.tree_util.tree_flatten_with_path(params)[0]}
    for name, leaf in leaves.items():
        path = t_tfm.reference_path(name, t_cfg)
        path = path[:-1] if path[0] == "super" else path
        assert t_tfm.decays(name, leaf) == (ref_ndim[path] >= 2), name


def test_resumed_train_run_equals_uninterrupted(tmp_path):
    """`launch.train` on the CPU: 4 steps with a checkpoint every 2, then
    `--resume` to 6, gives the losses, grad norms and learning rates of an
    uninterrupted 6-step run, bit for bit, and the same final weights."""
    common = ["--arch", "yi-9b", "--reduced", "--device", "cpu",
              "--seq", "32", "--global-batch", "2", "--log-every", "1"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first = t_train.main([*common, "--steps", "4", "--ckpt-every", "2",
                          "--ckpt-dir", a, "--metrics-out", a + ".jsonl"])
    assert t_ckpt.latest_step(a) == 4 and len(first) == 4
    rest = t_train.main([*common, "--steps", "6", "--resume", "--ckpt-dir",
                         a, "--metrics-out", a + ".jsonl"])
    whole = t_train.main([*common, "--steps", "6", "--ckpt-dir", b,
                          "--metrics-out", b + ".jsonl"])
    assert first + rest == whole
    read = lambda p: [json.loads(ln) for ln in open(p)]
    assert read(a + ".jsonl") == read(b + ".jsonl")
    _, pa = t_ckpt.restore(a, 6)
    _, pb = t_ckpt.restore(b, 6)
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])


def test_train_cli_exits_zero_on_the_cpu(tmp_path):
    """`python -m repro_torch.launch.train` as a user runs it, an MoE arch
    with a frontend-free reduced config: exit 0, the reference's log
    lines."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-moe-a2.7b", "--reduced", "--device", "cpu", "--steps", "3",
         "--seq", "32", "--global-batch", "2", "--ckpt-dir",
         str(tmp_path / "ck"), "--ckpt-every", "2", "--mesh", "1x1"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] step     0 loss" in out.stdout
    assert "[train] done: first/last logged loss" in out.stdout
    assert t_ckpt.latest_step(str(tmp_path / "ck")) == 3


def test_a_mesh_raises(monkeypatch):
    """What is not a mesh, a --mesh spec that is not DxM, a mesh of
    several ranks outside a world, and a mesh whose size differs from the
    world raise ValueError before any rank joins (training over a mesh:
    test_torch_lm_mesh.py)."""
    cfg = t_configs.get_config("yi-9b").reduced()
    with pytest.raises(ValueError, match="not a mesh"):
        t_steps.make_train_step(cfg, object())
    common = ["--arch", "yi-9b", "--reduced", "--device", "cpu"]
    for spec in ("2by4", "2x4x1", "0x4", "x4"):
        with pytest.raises(ValueError, match="DxM"):
            t_train.main(common + ["--mesh", spec])
    with pytest.raises(ValueError, match="world of 8 ranks"):
        t_train.main(common + ["--mesh", "2x4"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="holds 8 ranks; the world has 4"):
        t_train.main(common + ["--mesh", "2x4"])


def test_train_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    cfg = t_configs.get_config("yi-9b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tfm.init_model(cfg, train=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["--arch", "yi-9b", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# the reference's surface: build_log_lut, ddg_matrix
# ---------------------------------------------------------------------------


def test_build_log_lut_matches_reference():
    """The log table and its spec, bit for bit, at the default size and at
    32 (tests/test_interp.py's)."""
    for size in (16, 32):
        want_tab, want_spec = r_interp.build_log_lut(size=size)
        tab, spec = t_interp.build_log_lut(size=size, device="cpu")
        np.testing.assert_array_equal(tab.numpy(), np.asarray(want_tab))
        assert (spec.x0, spec.dx, spec.size) == (
            want_spec.x0, want_spec.dx, want_spec.size)


def test_ddg_matrix_matches_reference():
    """The DDG matrix of extended weights, integer only, bit for bit at
    precisions 16 and 30; its rows rebuild the weights."""
    rng = np.random.default_rng(0)
    for precision in (16, 30):
        m = rng.integers(1, 99, size=(50, 7)).astype(np.int32)
        ext = r_ky.prepare(jnp.asarray(m), precision=precision)
        want = np.asarray(r_ky.ddg_matrix(ext, precision))
        got = t_ky.ddg_matrix(_t(np.asarray(ext)), precision)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        recon = (got.long() * (2 ** (precision - 1 - torch.arange(
            precision)))).sum(-1)
        np.testing.assert_array_equal(recon.numpy(), np.asarray(ext))


# ---------------------------------------------------------------------------
# the readings the gradient limits above were set from
# ---------------------------------------------------------------------------


def readings(arch: str, dtype: str, seeds) -> list[dict]:
    """Per seed, the port's gradients and the reference's eager ones
    against the jitted reference's: the largest per-leaf gap over the
    leaf's own largest |g|, `bi` apart.  Run from the repository root:

        PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py \
            --arch xlstm-350m --dtype float32 --seeds 6
    """
    rows = []
    for seed in seeds:
        r_cfg, _, params, _, _, batch = _setup(arch, dtype, seed)
        _, _, want, got, _ = _loss_and_grads(arch, dtype, seed=seed)
        with jax.disable_jit():
            eager = jax.grad(lambda p: r_tfm.train_loss(p, r_cfg, {
                k: jnp.asarray(v) for k, v in batch.items()}))(params)
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        row = {"arch": arch, "dtype": dtype, "seed": seed}
        for side, tree in (("port", got), ("reference_eager", eager)):
            gaps = {}
            for (path, w), g in zip(flat, jax.tree.leaves(tree)):
                w = np.asarray(w, np.float32)
                gaps["/".join(str(p.key) for p in path)] = float(
                    np.abs(np.asarray(g, np.float32) - w).max()
                    / np.abs(w).max())
            rest = {k: v for k, v in gaps.items() if not k.endswith("bi")}
            worst = max(rest, key=rest.get)
            row[side] = {"worst_leaf": worst, "worst": rest[worst],
                         "bi": max((v for k, v in gaps.items()
                                    if k.endswith("bi")), default=None)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=readings.__doc__.split(
        "\n")[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    readings(args.arch, args.dtype, range(1, args.seeds + 1))


def test_embedding_gradient_sums_repeats_in_the_leaf_type():
    """A float32 table read in bf16 activations (`layers.embed_rows`): a
    token repeated 4,096 times gets its gradient summed in float32, within
    float32 rounding of the exact sum (a bf16 running sum of the same
    terms stalls far below it); a bf16 table's rows are read as before."""
    cfg = t_configs.get_config("yi-9b").reduced()
    assert cfg.act_dtype == torch.bfloat16
    w = torch.zeros((4, 8), dtype=torch.float32, requires_grad=True)
    tokens = torch.ones(4096, dtype=torch.long)
    step = torch.full((4096, 8), 1e-2, dtype=torch.bfloat16)
    rows = t_layers.embed_rows(w, tokens, cfg)
    assert rows.dtype == torch.bfloat16
    rows.backward(step)
    exact = 4096 * float(step[0, 0])
    assert abs(float(w.grad[1, 0]) - exact) <= 1e-6 * exact
    stalled = torch.zeros((), dtype=torch.bfloat16)
    for g in step[:, 0]:
        stalled = stalled + g
    assert float(stalled) < 0.9 * exact
    table = torch.randn((4, 8)).to(torch.bfloat16)
    assert torch.equal(t_layers.embed_rows(table, tokens[:3], cfg),
                       table[tokens[:3]])
