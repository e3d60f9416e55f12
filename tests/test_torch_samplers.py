"""The port's samplers against the reference on shared inputs: the LUT
lerp (`interp_ref`, the K2 twin, `ops.interp`/`lut_exp_weights`), the KY
walk (`ky_sample_ref`/`ky_sample_fast`, the K1 twin, `ops.ky_sample`) and
`draw_from_logits`.  Inputs come from numpy with a fixed seed; the
reference's Pallas kernels run in interpret mode, and its plain functions
under `jax.jit`, as its engines run them (XLA then multiplies by the LUT
step's reciprocal and fuses the lerp's multiply-add, which the port
follows).  Tolerance: bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import draws as r_draws
from repro.core import interp as r_interp
from repro.core import ky as r_ky
from repro.kernels import ops as r_ops
from repro_torch import convert, prng
from repro_torch.core import draws as t_draws
from repro_torch.core import interp as t_interp
from repro_torch.core import ky as t_ky
from repro_torch.kernels import interp_lut as t_interp_lut
from repro_torch.kernels import ky_sampler as t_ky_sampler
from repro_torch.kernels import ops as t_ops


def _x(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10.0, 1.0, n).astype(np.float32)
    # grid points, cell edges and the saturating ends
    x[:6] = [-8.0, 0.0, -10.0, 1.0, -8.0 + 8.0 / 15, -4.0]
    return x


def _tables():
    r_tab, r_spec = r_interp.build_exp_weight_lut()
    t_tab, t_spec = t_interp.build_exp_weight_lut(device="cpu")
    np.testing.assert_array_equal(np.asarray(r_tab), t_tab.numpy())
    assert (r_spec.x0, r_spec.dx, r_spec.size) == (
        t_spec.x0, t_spec.dx, t_spec.size)
    return r_tab, r_spec, t_tab, t_spec


def test_interp_ref_and_k2_twin_match_reference():
    r_tab, r_spec, t_tab, t_spec = _tables()
    x = _x(200_000)
    want = np.asarray(jax.jit(
        lambda v: r_interp.interp_ref(v, r_tab, r_spec))(jnp.asarray(x)))
    got = t_interp.interp_ref(torch.from_numpy(x), t_tab, t_spec).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    twin = t_interp_lut.interp_kernel(torch.from_numpy(x), t_tab, t_spec)
    np.testing.assert_array_equal(twin.numpy().view(np.int32),
                                  want.view(np.int32))


def test_ops_interp_and_lut_weights_match_reference_kernel():
    r_tab, r_spec, t_tab, t_spec = _tables()
    x = _x(7 * 431, seed=1).reshape(-1, 7)
    want = np.asarray(r_ops.interp(jnp.asarray(x), r_tab, r_spec,
                                   interpret=True))
    got = t_ops.interp(torch.from_numpy(x), t_tab, t_spec).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    w_ref = r_ops.lut_exp_weights(jnp.asarray(x), r_tab, r_spec,
                                  interpret=True)
    w = t_ops.lut_exp_weights(torch.from_numpy(x), t_tab, t_spec)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))


def _weights_and_words(v, rows=96, seed=0, n_words=4):
    rng = np.random.default_rng(seed + v)
    w = rng.integers(0, 256, (rows, v)).astype(np.int32)
    w[0] = 0  # all-zero row: uniform fallback of prepare
    w[1, :] = 0
    w[1, v - 1] = 255  # one-hot row
    words = rng.integers(0, 2**32, (rows, n_words), dtype=np.uint64)
    return w, words.astype(np.uint32)


@pytest.mark.parametrize("v", [2, 3, 11, 127])
def test_ky_walks_match_reference_on_shared_words(v):
    w, words = _weights_and_words(v)
    lab_r, st_r = r_ky.ky_sample_ref(jnp.asarray(w), jnp.asarray(words),
                                     n_bins=v)
    tw, twords = torch.from_numpy(w), torch.from_numpy(words.view(np.int32))
    for fn in (t_ky.ky_sample_ref, t_ky.ky_sample_fast,
               t_ky_sampler.ky_sample_kernel):
        lab, st = fn(tw, twords, n_bins=v)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_r))
        for name in ("bits_used", "rejections", "fallback"):
            np.testing.assert_array_equal(st[name].numpy(),
                                          np.asarray(st_r[name]))


@pytest.mark.parametrize("v", [3, 11])
def test_k1_twin_matches_reference_kernel_through_ops(v):
    """`ops.ky_sample` on both sides: same key -> same words -> same draw
    and stats, the reference running its Pallas kernel interpreted."""
    w, _ = _weights_and_words(v, rows=64, seed=5)
    jk = jax.random.key(31)
    lab_r, st_r = r_ops.ky_sample(jnp.asarray(w), jk, interpret=True,
                                  return_stats=True)
    key = convert.key_from_reference(np.asarray(jax.random.key_data(jk)))
    lab, st = t_ops.ky_sample(torch.from_numpy(w), key, return_stats=True)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_r))
    for name in ("bits_used", "rejections", "fallback"):
        np.testing.assert_array_equal(st[name].numpy(),
                                      np.asarray(st_r[name]))


def test_k1_fallback_when_bits_run_out():
    """max_retries=1 with a tiny distribution forces bit exhaustion on some
    rows; the argmax fallback (and its counts) must agree."""
    v = 5
    rng = np.random.default_rng(3)
    w = rng.integers(0, 3, (256, v)).astype(np.int32)
    words = rng.integers(0, 2**32, (256, 1), dtype=np.uint64).astype(
        np.uint32)
    lab_r, st_r = r_ky.ky_sample_ref(jnp.asarray(w), jnp.asarray(words),
                                     n_bins=v, precision=16, max_retries=1)
    lab, st = t_ky_sampler.ky_sample_kernel(
        torch.from_numpy(w), torch.from_numpy(words.view(np.int32)),
        n_bins=v, precision=16, max_retries=1)
    assert bool(np.asarray(st_r["fallback"]).any())
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_r))
    np.testing.assert_array_equal(st["fallback"].numpy(),
                                  np.asarray(st_r["fallback"]))


@pytest.mark.parametrize("v", [3, 11])
def test_draw_from_logits_lut_ky_matches_reference(v):
    r_tab, r_spec, t_tab, t_spec = _tables()
    rng = np.random.default_rng(v)
    logp = np.log(rng.uniform(0.01, 1.0, (40, 6, v))).astype(np.float32)
    logp[0, 0, 1:] = -1e30  # a masked, card-1 row
    jk = jax.random.key(8)
    want = r_draws.draw_from_logits(jnp.asarray(logp), jk, "lut_ky", r_tab,
                                    r_spec)
    got = t_draws.draw_from_logits(
        torch.from_numpy(logp),
        convert.key_from_reference(np.asarray(jax.random.key_data(jk))),
        "lut_ky", t_tab, t_spec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_samplers_raise():
    """Every sampler of the reference is ported; a name outside them, or
    lut_ky without its exp-weight table, raises."""
    logp = torch.zeros(4, 3)
    assert set(t_draws.SAMPLERS) == set(r_draws.SAMPLERS)
    with pytest.raises(ValueError):
        t_draws.draw_from_logits(logp, prng.key(0), "softmax")
    with pytest.raises(ValueError):
        t_draws.draw_from_logits(logp, prng.key(0), "lut_ky")
    for sampler in ("cdf", "gumbel"):
        labels = t_draws.draw_from_logits(logp, prng.key(0), sampler)
        assert labels.dtype == torch.int32 and tuple(labels.shape) == (4,)
