"""Public entry points for the kernels (port of `repro/kernels/ops.py`).

These wrappers own the layout plumbing (flattening, the random words'
key) so callers see clean shapes.  They run where their input tensors live: the
CUDA kernels for tensors on the card, the plain torch twins for CPU
tensors, which only a caller that made CPU tensors gets.
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.core.interp import LUTSpec
from repro_torch.kernels import _lib
from repro_torch.kernels import interp_lut as _interp_lut
from repro_torch.kernels import ky_sampler as _ky

LANES = _ky.LANES


def ky_sample(
    weights: torch.Tensor,
    key: prng.Key,
    *,
    precision: int = 16,
    max_retries: int = 8,
    return_stats: bool = False,
):
    """Draw one exact sample per row from unnormalized int32 weights
    (B, N), N <= 128, with the reference's random words for `key`
    (`random_words(key, (B,), n_words)`), which K1 hashes itself on the
    card (`ky_sample_keyed`).  Returns labels (B,) int32 [, stats].  The
    reference's Pallas K1 takes N < 128; at N = 128 this is the draw of
    its plain `ky_sample_ref`."""
    n_bins = weights.shape[1]
    if n_bins > LANES:  # raised, not asserted: must hold under `python -O`
        raise ValueError(f"KY kernel handles <={LANES} bins, got {n_bins}")
    labels, stats = _ky.ky_sample_keyed(
        weights.to(torch.int32).contiguous(), key, n_bins=n_bins,
        precision=precision, max_retries=max_retries,
    )
    if return_stats:
        return labels, stats
    return labels


def interp(
    x: torch.Tensor, table: torch.Tensor, spec: LUTSpec
) -> torch.Tensor:
    """Vectorized LUT lerp over an arbitrary-shaped float32 tensor."""
    flat = x.to(torch.float32).contiguous().reshape(-1)
    tab = table.to(torch.float32).contiguous().reshape(-1)
    return _interp_lut.interp_kernel(flat, tab, spec).reshape(x.shape)


def lut_exp_weights(
    log_potentials: torch.Tensor,
    exp_table: torch.Tensor,
    exp_spec: LUTSpec,
) -> torch.Tensor:
    """Fused C2 stage of the sampling pipeline: max-subtracted
    log-potentials -> LUT-exp -> integer KY weights (no softmax)."""
    z = log_potentials - log_potentials.amax(-1, keepdim=True)
    w = interp(z, exp_table, exp_spec)
    return torch.clamp(torch.round(w), min=0.0).to(torch.int32)


def device_bits(
    key: prng.Key, n: int, start: int = 0, device="cuda"
) -> torch.Tensor:
    """Words start .. start + n - 1 of the stream `prng.bits(key, ...)`
    (int32 bit patterns) as the kernels hash them: `aia::jax_word`
    (csrc/aia_common.cuh), the device function from which K3 and K4 make
    their random words, through its test entry `aia_threefry_words`.  Used
    by no sampling path.  On the CPU: `prng.bits` from counter `start`."""
    dev = device_mod.resolve(device)
    if start < 0 or n < 0:
        raise ValueError(f"counters [{start}, {start + n}) are not uint64")
    if dev.type == "cpu":
        return prng.bits(key, (n,), dev, start=start)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = _lib.function(
        "bn_gibbs", "aia_threefry_words",
        [_lib.UINT, _lib.UINT, _lib.ULONG, _lib.ULONG, _lib.PTR, _lib.PTR],
    )
    with torch.cuda.device(dev):
        code = fn(key.k1, key.k2, start, n, out.data_ptr(),
                  _lib.stream_of(out))
    _lib.check("bn_gibbs", code, "device_bits")
    return out
