"""The port's Mamba mixer (`repro_torch.models.ssm`) against the
reference's jitted `mamba_apply` and `mamba_decode`, at `reduced()`
jamba-1.5-large-398b (d 64, d_inner 128, 8 states, dt rank 4, conv 4;
its parameters in bf16, as at full width).

Both sides get the reference's weights and the same inputs.  Prefill over
S = 16 (one reference chunk) and S = 80 (chunks of 16), then three decode
steps from its state: float32 outputs within 1e-4 and states within
1e-5; bfloat16 outputs and states within 1/64, one bf16 step at 2-4 (the
port follows XLA's roundings, the logistic in the activation type and
silu's last product unrounded into the float32 skip term, so all but a
few elements are bit-equal; exp and softplus differ in the last float32
bit).  And the port's own decode continues its prefill."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import ssm as r_ssm
from repro_torch import configs as t_configs
from repro_torch.models import ssm as t_ssm
from repro_torch.models.layers import Params

ARCH = "jamba-1.5-large-398b"
B = 2
ATOL = {"float32": 1e-4, "bfloat16": 1 / 64}


def _setup(dtype, seed=0):
    r_cfg = dataclasses.replace(r_configs.get_config(ARCH).reduced(),
                                dtype=dtype)
    t_cfg = dataclasses.replace(t_configs.get_config(ARCH).reduced(),
                                dtype=dtype)
    tree = jax.tree.map(np.asarray, r_ssm.init_mamba(
        jax.random.PRNGKey(seed), r_cfg))
    keep = {"a_log": torch.float32, "d_skip": torch.float32,
            "dt_bias": getattr(torch, t_cfg.param_dtype)}
    p = Params(**{k: torch.tensor(np.asarray(v, np.float32)).to(
        keep.get(k, t_cfg.act_dtype)) for k, v in tree.items()})
    # dt_bias is held in the parameter type: -4.6 rounds to -4.59375
    assert p["dt_bias"].dtype == torch.bfloat16
    return r_cfg, t_cfg, tree, p


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def _close_state(got: dict, want: dict, atol: float):
    for name in ("conv", "ssm"):
        assert got[name].dtype == (torch.float32 if name == "ssm"
                                   else got["conv"].dtype)
        np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("s", [16, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_and_decode_match_the_reference(dtype, s):
    r_cfg, t_cfg, tree, p = _setup(dtype)
    rng = np.random.default_rng(s)
    x = rng.normal(0, 1, (B, s, r_cfg.d_model)).astype(np.float32)
    apply = jax.jit(lambda p, x: r_ssm.mamba_apply(p, x, r_cfg))
    want, r_state = apply(tree, jnp.asarray(x, r_cfg.act_dtype))
    got, t_state = t_ssm.mamba_apply(p, torch.from_numpy(x).to(
        t_cfg.act_dtype), t_cfg)
    atol = ATOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
    _close_state(t_state, r_state, max(atol, 1e-5))
    decode = jax.jit(lambda p, x, st: r_ssm.mamba_decode(p, x, st, r_cfg))
    for _ in range(3):
        xt = rng.normal(0, 1, (B, 1, r_cfg.d_model)).astype(np.float32)
        want, r_state = decode(tree, jnp.asarray(xt, r_cfg.act_dtype),
                               r_state)
        state_before = t_state["ssm"]
        got, t_state = t_ssm.mamba_decode(p, torch.from_numpy(xt).to(
            t_cfg.act_dtype), t_state, t_cfg)
        assert t_state["ssm"] is state_before  # updated in place
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
        _close_state(t_state, r_state, max(atol, 1e-5))


def test_mamba_prefill_carries_a_state_in():
    """A prefill from a carried-in state (the conv tail and the SSM state
    of an earlier prefill) equals the reference's from the same state."""
    r_cfg, t_cfg, tree, p = _setup("float32", seed=1)
    rng = np.random.default_rng(3)
    x0, x1 = (rng.normal(0, 1, (B, 8, r_cfg.d_model)).astype(np.float32)
              for _ in range(2))
    apply = jax.jit(lambda p, x, st: r_ssm.mamba_apply(p, x, r_cfg, st))
    _, r_state = apply(tree, jnp.asarray(x0), r_ssm.init_mamba_state(
        r_cfg, B))
    want, r_state = apply(tree, jnp.asarray(x1), r_state)
    _, t_state = t_ssm.mamba_apply(p, torch.from_numpy(x0), t_cfg)
    got, t_state = t_ssm.mamba_apply(p, torch.from_numpy(x1), t_cfg,
                                     t_state)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    _close_state(t_state, r_state, 1e-5)


def test_mamba_decode_continues_prefill():
    """Decode step t from a prefill over S positions equals the prefill
    over S + t + 1 positions at its last one (float32, 1e-5)."""
    _, t_cfg, _, p = _setup("float32", seed=2)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (B, 12, t_cfg.d_model)).astype(np.float32))
    _, state = t_ssm.mamba_apply(p, x[:, :8], t_cfg)
    for t in range(8, 12):
        got, state = t_ssm.mamba_decode(p, x[:, t:t + 1], state, t_cfg)
        whole, _ = t_ssm.mamba_apply(p, x[:, :t + 1], t_cfg)
        np.testing.assert_allclose(got.numpy(), whole[:, -1:].numpy(),
                                   atol=1e-5, rtol=0)
