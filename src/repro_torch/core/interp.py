"""LUT-based linear interpolation of nonlinear functions (paper C2, Sec. III-D).

Port of `repro/core/interp.py`.  AIA evaluates exp/log/... in one cycle from
a 16-entry, 8-bit lookup table; here the unit is a plain torch reference
(`interp_ref`) and a CUDA kernel (`kernels/interp_lut.py`).

The lerp's output feeds `round()` in the lut_ky sampler, so one flipped low
bit can change a draw.  The float expressions therefore follow the
reference as XLA compiles it (under `jit`, and in the Pallas kernels): the
division by the constant `dx` becomes a multiplication by its float32
reciprocal, and `y0 + frac * (y1 - y0)` becomes one fused multiply-add.
(Run op by op, outside `jit`, the reference divides and rounds the product
separately; that differs in about 1 of 10^5 rounded weights.)  The plain
torch version evaluates the multiply-add in float64, where the product of
two float32 values is exact, and rounds once to float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import device as device_mod

# Paper defaults (Sec. III-D "Accuracy Impact"): 16 entries, 8-bit values.
DEFAULT_SIZE = 16
DEFAULT_BITS = 8


@dataclasses.dataclass(frozen=True)
class LUTSpec:
    x0: float
    dx: float
    size: int

    @property
    def x1(self) -> float:
        return self.x0 + self.dx * (self.size - 1)


def build_lut(
    fn: Callable[[np.ndarray], np.ndarray],
    x0: float,
    x1: float,
    size: int = DEFAULT_SIZE,
    device="cuda",
) -> tuple[torch.Tensor, LUTSpec]:
    spec = LUTSpec(x0=float(x0), dx=float(x1 - x0) / (size - 1), size=size)
    xs = np.asarray(x0 + spec.dx * np.arange(size), np.float64)
    table = torch.tensor(
        np.asarray(fn(xs), np.float32), device=device_mod.resolve(device)
    )
    return table, spec


def build_exp_weight_lut(
    bits: int = DEFAULT_BITS, x_min: float = -8.0, size: int = DEFAULT_SIZE,
    device="cuda",
):
    """exp() table emitting integer sampling weights in [0, 2^bits - 1].

    Inputs are max-subtracted log-potentials (<= 0).  exp(x_min) ~ 3e-4 maps
    to weight 0 — bins that improbable are dropped, matching the paper's 8-bit
    quantization with "negligible accuracy loss"."""
    top = float((1 << bits) - 1)
    return build_lut(
        lambda x: np.rint(np.exp(x) * top), x_min, 0.0, size, device=device
    )


def build_log_lut(size: int = DEFAULT_SIZE, x0: float = 1.0,
                  x1: float = 2.0, device="cuda"
                  ) -> tuple[torch.Tensor, LUTSpec]:
    """log() over one octave; range-reduced callers handle the exponent."""
    return build_lut(np.log, x0, x1, size, device)


def inv_dx(spec: LUTSpec) -> float:
    """The float32 reciprocal of the grid step, as XLA folds `x / dx`."""
    return float(np.float32(1.0) / np.float32(spec.dx))


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-dim tensor of `like`'s dtype and device, so an op
    with it is one IEEE float32 op on any device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def interp_ref(
    x: torch.Tensor, table: torch.Tensor, spec: LUTSpec
) -> torch.Tensor:
    """Plain oracle: y = Y[i] + frac * (Y[i+1] - Y[i])   (paper Sec. III-D),
    with u = clip((x - x0) * fl32(1/dx), 0, size - 1) and the lerp as one
    multiply-add, evaluated in float64 (the product of two float32 values
    is exact there) and rounded once to float32."""
    u = torch.clamp(
        (x - scalar(spec.x0, x)) * scalar(inv_dx(spec), x), 0.0,
        float(spec.size - 1),
    )
    idx = torch.clamp(torch.floor(u), 0, spec.size - 2).long()
    frac = u - idx.to(u.dtype)
    y0, y1 = table[idx], table[idx + 1]
    return (y0.double() + frac.double() * (y1 - y0).double()).to(x.dtype)
