"""The port's xLSTM mixers (`repro_torch.models.xlstm`) against the
reference's jitted ones, at `reduced()` xlstm-350m (d 64, 4 heads of 16).

Both sides get the reference's weights and the same inputs (float32:
outputs within 1e-4, states within 1e-4 relative to their scale):

  * `mlstm_apply` over S = 64 (one chunk), 192 (three chunks of 64) and
    100 (not a multiple of 64: chunks of 4), from a zero and a carried-in
    state; `mlstm_decode` (the exact step) from the prefill's state;
  * `slstm_apply` and `slstm_decode`;
  * the port's chunkwise mLSTM against its own step loop, the equivalence
    the reference's docstring promises;
  * one bfloat16 pass of each mixer, within 1/64 (one bf16 step at 2-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import xlstm as r_xlstm
from repro_torch import configs as t_configs
from repro_torch.models import xlstm as t_xlstm
from repro_torch.models.layers import Params

ARCH = "xlstm-350m"
B = 2
ATOL = {"float32": 1e-4, "bfloat16": 1 / 64}
FLAT = {"wq", "wk", "wv", "w_in"}


def _setup(kind, dtype, seed=0):
    r_cfg = dataclasses.replace(r_configs.get_config(ARCH).reduced(),
                                dtype=dtype)
    t_cfg = dataclasses.replace(t_configs.get_config(ARCH).reduced(),
                                dtype=dtype)
    init = r_xlstm.init_mlstm if kind == "mlstm" else r_xlstm.init_slstm
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), r_cfg))
    d = r_cfg.d_model

    def leaf(name, v):
        t = torch.tensor(np.asarray(v, np.float32))
        if name in FLAT:
            t = t.reshape(d, -1)
        elif name == "b":
            t = t.reshape(-1)
        return t if name == "r" else t.to(t_cfg.act_dtype)

    return r_cfg, t_cfg, tree, Params(**{k: leaf(k, v)
                                         for k, v in tree.items()})


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _close_state(got: dict, want: dict, atol: float):
    assert set(got) == set(want)
    for name, w in want.items():
        w = _np(w)
        scale = max(1.0, float(np.abs(w[np.abs(w) < 1e29]).max()))
        assert got[name].dtype == torch.float32
        _close(got[name], w, atol * scale)


def _x(rng, b, s, d):
    return rng.normal(0, 1, (b, s, d)).astype(np.float32)


@pytest.mark.parametrize("s", [64, 192, 100])
def test_mlstm_prefill_and_decode_match_the_reference(s):
    r_cfg, t_cfg, tree, p = _setup("mlstm", "float32")
    rng = np.random.default_rng(s)
    x = _x(rng, B, s, r_cfg.d_model)
    assert t_xlstm.chunk_len(s) == {64: 64, 192: 64, 100: 4}[s]
    want, r_state = jax.jit(lambda p, x: r_xlstm.mlstm_apply(p, x, r_cfg))(
        tree, jnp.asarray(x))
    got, t_state = t_xlstm.mlstm_apply(p, torch.from_numpy(x), t_cfg)
    _close(got, want, 1e-4)
    _close_state(t_state, r_state, 1e-4)
    decode = jax.jit(lambda p, x, st: r_xlstm.mlstm_decode(p, x, st, r_cfg))
    for _ in range(3):
        xt = _x(rng, B, 1, r_cfg.d_model)
        want, r_state = decode(tree, jnp.asarray(xt), r_state)
        c_before = t_state["C"]
        got, t_state = t_xlstm.mlstm_decode(p, torch.from_numpy(xt),
                                            t_state, t_cfg)
        assert t_state["C"] is c_before  # updated in place
        _close(got, want, 1e-4)
        _close_state(t_state, r_state, 1e-4)


def test_mlstm_prefill_carries_a_state_in():
    r_cfg, t_cfg, tree, p = _setup("mlstm", "float32", seed=1)
    rng = np.random.default_rng(1)
    x0, x1 = _x(rng, B, 32, r_cfg.d_model), _x(rng, B, 24, r_cfg.d_model)
    apply = jax.jit(lambda p, x, st: r_xlstm.mlstm_apply(p, x, r_cfg, st))
    _, r_state = apply(tree, jnp.asarray(x0),
                       r_xlstm.init_mlstm_state(r_cfg, B))
    want, r_state = apply(tree, jnp.asarray(x1), r_state)
    _, t_state = t_xlstm.mlstm_apply(p, torch.from_numpy(x0), t_cfg)
    got, t_state = t_xlstm.mlstm_apply(p, torch.from_numpy(x1), t_cfg,
                                       t_state)
    _close(got, want, 1e-4)
    _close_state(t_state, r_state, 1e-4)


@pytest.mark.parametrize("s", [16, 100])
def test_mlstm_chunkwise_equals_its_step_loop(s):
    """The chunkwise form over S positions (and its end state) equals the
    exact step run position by position, in the port alone."""
    _, t_cfg, _, p = _setup("mlstm", "float32", seed=2)
    x = torch.from_numpy(_x(np.random.default_rng(2), B, s, t_cfg.d_model))
    q, k, v, li, lf = t_xlstm._mlstm_qkv_gates(p, x, t_cfg)
    state = t_xlstm.init_mlstm_state(t_cfg, B, "cpu")
    h_chunk, end = t_xlstm.mlstm_chunk(state, q, k, v, li, lf)
    hs = []
    for t in range(s):
        h_t, state = t_xlstm.mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                        li[:, :, t], lf[:, :, t], state)
        hs.append(h_t)
    _close(h_chunk, torch.stack(hs, dim=2), 1e-4)
    _close_state(end, state, 1e-4)


def test_slstm_prefill_and_decode_match_the_reference():
    r_cfg, t_cfg, tree, p = _setup("slstm", "float32")
    assert p["r"].dtype == torch.float32
    rng = np.random.default_rng(3)
    x = _x(rng, B, 24, r_cfg.d_model)
    want, r_state = jax.jit(lambda p, x: r_xlstm.slstm_apply(p, x, r_cfg))(
        tree, jnp.asarray(x))
    got, t_state = t_xlstm.slstm_apply(p, torch.from_numpy(x), t_cfg)
    _close(got, want, 1e-4)
    _close_state(t_state, r_state, 1e-4)
    decode = jax.jit(lambda p, x, st: r_xlstm.slstm_decode(p, x, st, r_cfg))
    for _ in range(3):
        xt = _x(rng, B, 1, r_cfg.d_model)
        want, r_state = decode(tree, jnp.asarray(xt), r_state)
        got, t_state = t_xlstm.slstm_decode(p, torch.from_numpy(xt),
                                            t_state, t_cfg)
        _close(got, want, 1e-4)
        _close_state(t_state, r_state, 1e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_bfloat16_matches_the_reference(kind):
    """At bf16 the gate pre-activations' bias adds stay unrounded (XLA
    removes their round trip through bf16 before the float32 gate math),
    the output gate's logistic is rounded op by op; then prefill and a
    decode step agree within one bf16 step."""
    r_cfg, t_cfg, tree, p = _setup(kind, "bfloat16", seed=4)
    rng = np.random.default_rng(4)
    x, xt = _x(rng, B, 16, r_cfg.d_model), _x(rng, B, 1, r_cfg.d_model)
    mod = {"mlstm": (r_xlstm.mlstm_apply, r_xlstm.mlstm_decode,
                     t_xlstm.mlstm_apply, t_xlstm.mlstm_decode),
           "slstm": (r_xlstm.slstm_apply, r_xlstm.slstm_decode,
                     t_xlstm.slstm_apply, t_xlstm.slstm_decode)}[kind]
    want, r_state = jax.jit(lambda p, x: mod[0](p, x, r_cfg))(
        tree, jnp.asarray(x, jnp.bfloat16))
    got, t_state = mod[2](p, torch.from_numpy(x).to(torch.bfloat16), t_cfg)
    _close(got, want, ATOL["bfloat16"])
    want, _ = jax.jit(lambda p, x, st: mod[1](p, x, st, r_cfg))(
        tree, jnp.asarray(xt, jnp.bfloat16), r_state)
    got, _ = mod[3](p, torch.from_numpy(xt).to(torch.bfloat16), t_state,
                    t_cfg)
    _close(got, want, ATOL["bfloat16"])
