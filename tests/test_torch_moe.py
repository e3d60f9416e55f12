"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
jitted `moe_apply`, at `reduced()` qwen2-moe-a2.7b (4 experts top-2 and a
shared expert) and llama4-scout-17b-a16e (top-1 and a shared expert).

Both sides get the reference's weights and the same inputs, in the three
dispatch modes: prefill (each row a group), decode at B > 1 (the batch as
one group) and decode at B = 1 (the row).  The inputs lean towards two
experts, so that capacity drops assignments in the prefill and batch
groups.  The reference's routing is its own lines (moe.py:117-142),
jitted here, since `moe_apply` returns only its output.

  * float32: the experts, their probabilities (1e-5), the sorted slots and
    which assignments are kept equal the reference's; outputs within 1e-4;
  * bfloat16: routing first.  A differing choice is allowed only where the
    reference's k-th and (k+1)-th router logits (a bf16 product) are at
    most one bf16 step apart, so that the smallest rounding difference
    swaps them, and the test checks that margin; outputs within 1e-2 on
    the tokens routed alike (the same experts, the same ones kept).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import moe as r_moe
from repro_torch import configs as t_configs
from repro_torch.models import moe as t_moe
from repro_torch.models.layers import Params

ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]
# (B, S): prefill rows; decode as one group of 16 tokens; decode of one row
SHAPES = {"prefill": (2, 16), "decode_group": (16, 1), "decode_row": (1, 1)}


@pytest.fixture(autouse=True)
def _no_reference_moe_mesh(monkeypatch):
    """The reference's MoE reads its sharding axes from a module global
    that its mesh step factories set and never clear; a test in the same
    process that built a meshed step would leave them set, and the
    unmeshed reference calls here would then ask for a mesh."""
    monkeypatch.setattr(r_moe, "_MESH_CTX",
                        {"dp": None, "tp": None, "tp_size": 1})


def _cfgs(arch, dtype):
    return (dataclasses.replace(r_configs.get_config(arch).reduced(),
                                dtype=dtype),
            dataclasses.replace(t_configs.get_config(arch).reduced(),
                                dtype=dtype))


def _port_params(tree, dt) -> Params:
    return Params(**{k: _port_params(v, dt) if isinstance(v, dict)
                     else torch.tensor(np.asarray(v, np.float32)).to(dt)
                     for k, v in tree.items()})


def _setup(arch, dtype, mode, seed=0):
    r_cfg, t_cfg = _cfgs(arch, dtype)
    tree = jax.tree.map(np.asarray, r_moe.init_moe(
        jax.random.PRNGKey(seed), r_cfg, r_cfg.moe))
    b, s = SHAPES[mode]
    rng = np.random.default_rng(seed + 1)
    # lean every token towards experts 0 and 1, so that they overflow
    lean = tree["router"][:, 0] + tree["router"][:, 1]
    lean = lean / np.linalg.norm(lean) * 2.0 * np.sqrt(r_cfg.d_model)
    x = (rng.normal(0, 1, (b, s, r_cfg.d_model)) + lean).astype(np.float32)
    rx = jnp.asarray(x, r_cfg.act_dtype)
    tx = torch.from_numpy(x).to(t_cfg.act_dtype)
    return r_cfg, t_cfg, tree, _port_params(tree, t_cfg.act_dtype), rx, tx


@jax.jit
def _ref_logits(x, router):
    return jnp.einsum("bsd,de->bse", x, router.astype(x.dtype))


def _ref_route(x, router, moe):
    """The reference's routing lines (moe.py:117-142), jitted, over groups
    of x's rows: (logits, top_p, top_i, slot, keep, stok)."""

    @jax.jit
    def route(x, router):
        b, s, _ = x.shape
        e, k = moe.n_experts, moe.top_k
        logits = _ref_logits(x, router)
        probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        top_p, top_i = jax.lax.top_k(probs, k)
        top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
        n_assign = s * k
        cap = int(-(-s * k // e) * moe.capacity_factor)
        cap = max(4, -(-cap // 4) * 4)
        flat_e = top_i.reshape(b, n_assign)
        flat_tok = jnp.tile(jnp.repeat(jnp.arange(s), k)[None], (b, 1))
        order = jnp.argsort(flat_e, axis=-1)
        se = jnp.take_along_axis(flat_e, order, axis=-1)
        stok = jnp.take_along_axis(flat_tok, order, axis=-1)
        first = jax.vmap(lambda row: jnp.searchsorted(row, row,
                                                      side="left"))(se)
        pos = jnp.arange(n_assign)[None] - first
        keep = pos < cap
        slot = jnp.where(keep, se * cap + pos, e * cap)
        return logits.astype(jnp.float32), top_p, top_i, slot, keep, stok

    return [np.asarray(a) for a in route(x, router)]


def _groups(mode, x):
    """The groups `moe_apply` routes: the batch as one group in a decode
    step over several rows."""
    return x.transpose(0, 1) if mode == "decode_group" else x


@pytest.mark.parametrize("mode", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_the_reference_float32(arch, mode):
    r_cfg, t_cfg, tree, p, rx, tx = _setup(arch, "float32", mode)
    moe = t_cfg.moe
    rg = rx.transpose(1, 0, 2) if mode == "decode_group" else rx
    _, top_p, top_i, slot, keep, stok = _ref_route(rg, tree["router"], moe)
    r = t_moe.route(_groups(mode, tx), p["router"], moe)
    np.testing.assert_array_equal(r.top_i.numpy(), top_i)
    np.testing.assert_allclose(r.top_p.numpy(), top_p, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.stok.numpy(), stok)
    if mode != "decode_row":  # one token never overflows its experts
        assert not keep.all(), "the inputs drop no assignment"
    assert r.cap == t_moe.capacity(rg.shape[1], moe)

    want, _ = jax.jit(lambda p, x: r_moe.moe_apply(p, x, r_cfg, r_cfg.moe))(
        tree, rx)
    got = t_moe.moe_apply(p, tx, t_cfg, moe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _bf16_tie(logits: np.ndarray, k: int) -> np.ndarray:
    """Whether each token's k-th and (k+1)-th router logits (bf16 numbers)
    are at most one bf16 step apart at the k-th: the smallest rounding
    difference in the logits can swap them."""
    srt = -np.sort(-logits, -1)
    step = 2.0 ** (np.floor(np.log2(np.abs(srt[..., k - 1]))) - 7)
    return srt[..., k - 1] - srt[..., k] <= step


def _kept(slot, keep, stok, cap, shape, e):
    """(G, S, E): which experts each token's kept assignments reach."""
    out = np.zeros(shape + (e,), bool)
    g, j = np.nonzero(keep)
    out[g, stok[g, j], slot[g, j] // cap] = True
    return out


@pytest.mark.parametrize("mode", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routing_and_output_bfloat16(arch, mode):
    r_cfg, t_cfg, tree, p, rx, tx = _setup(arch, "bfloat16", mode, seed=2)
    moe = t_cfg.moe
    k, e = moe.top_k, moe.n_experts
    rg = rx.transpose(1, 0, 2) if mode == "decode_group" else rx
    logits, _, top_i, slot, keep, stok = _ref_route(rg, tree["router"], moe)
    r = t_moe.route(_groups(mode, tx), p["router"], moe)
    differ = (np.sort(r.top_i.numpy(), -1) != np.sort(top_i, -1)).any(-1)
    assert _bf16_tie(logits, k)[differ].all()
    if mode != "decode_row":
        assert not keep.all(), "the inputs drop no assignment"

    want, _ = jax.jit(lambda p, x: r_moe.moe_apply(p, x, r_cfg, r_cfg.moe))(
        tree, rx)
    got = _groups(mode, t_moe.moe_apply(p, tx, t_cfg, moe)).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    want = want.swapaxes(0, 1) if mode == "decode_group" else want
    alike = ~differ & (_kept(slot, keep, stok, r.cap, differ.shape, e)
                       == _kept(r.slot.numpy(), r.keep.numpy(),
                                r.stok.numpy(), r.cap, differ.shape, e)
                       ).all(-1)
    # a flip changes its token's routing, and can move one other token in
    # or out of capacity at each of the two experts it leaves and joins
    assert alike.sum() >= alike.size - 3 * differ.sum()
    np.testing.assert_allclose(got[alike], want[alike], atol=1e-2, rtol=0)


def test_top_k_puts_the_lower_index_first_on_ties():
    """`jax.lax.top_k` returns the lower index first among equal values;
    `torch.topk` promises no order, so the port sorts stably."""
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], np.float32)
    vals, idx = t_moe.top_k(torch.from_numpy(probs), 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert idx.tolist() == [[1, 2, 4]]


@pytest.mark.parametrize("tokens,want", [(128, 12), (8, 4), (1, 4),
                                         (512, 44)])
def test_capacity_is_the_references_arithmetic(tokens, want):
    """qwen2-moe at full width (60 experts, top-4): a 128-token prefill row
    takes 12 slots an expert, a decode group of 8 tokens 4."""
    moe = t_configs.get_config("qwen2-moe-a2.7b").moe
    assert t_moe.capacity(tokens, moe) == want
