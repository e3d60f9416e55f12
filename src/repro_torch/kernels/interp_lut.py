"""K2: the LUT linear-interpolation unit (paper C2) as a CUDA kernel.

Replaces the reference's Pallas kernel `interp_kernel`
(src/repro/kernels/interp_lut.py:50, body `interp_eval` :25).  The CUDA
source is `csrc/interp_lut.cu`; its device function `aia::lut_interp`
(`csrc/aia_common.cuh`) is the same lerp K3 inlines.

Bound on the H100: bytes (one f32 read and one written per element).  The
table sits in shared memory and each thread gathers its two entries
directly, where the TPU unrolled the gather into lane selects.

`interp_kernel` launches the kernel for a CUDA tensor and counts the launch
in `interp_kernel.launches`; for a CPU tensor it runs the plain twin
`interp_kernel_ref`, which keeps the reference's float ops (see
`core/interp.py`: reciprocal multiply, one fused multiply-add).
"""

from __future__ import annotations

import torch

from repro_torch.core.interp import LUTSpec, interp_ref, inv_dx
from repro_torch.kernels import _lib

MAX_TABLE = 1024  # the table is staged in shared memory


def interp_kernel_ref(
    x: torch.Tensor, table: torch.Tensor, spec: LUTSpec
) -> torch.Tensor:
    """Plain torch twin of K2 (any shape, f32): `core.interp.interp_ref`,
    whose cell index equals the reference kernel's truncation since u >= 0."""
    return interp_ref(x, table.reshape(-1), spec)


def interp_kernel(
    x: torch.Tensor, table: torch.Tensor, spec: LUTSpec
) -> torch.Tensor:
    """y = LUT lerp of x: the CUDA kernel for a CUDA tensor, the twin for a
    CPU tensor.  x is f32 of any shape; table is the (size,) f32 table."""
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise ValueError("interp_kernel takes float32 inputs and table")
    if not 2 <= spec.size <= MAX_TABLE or table.numel() < spec.size:
        raise ValueError(f"table of {spec.size} entries not supported")
    if x.device.type == "cpu":
        return interp_kernel_ref(x, table, spec)
    table = table.reshape(-1)
    _lib.require_cuda("interp_kernel", x, table)
    y = torch.empty_like(x)
    fn = _lib.function(
        "interp_lut", "aia_interp",
        [_lib.PTR, _lib.PTR, _lib.LONG, _lib.PTR, _lib.INT, _lib.FLOAT,
         _lib.FLOAT, _lib.PTR],
    )
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), y.data_ptr(), x.numel(), table.data_ptr(),
                  spec.size, spec.x0, inv_dx(spec), _lib.stream_of(x))
    _lib.check("interp_lut", code, "interp_kernel")
    interp_kernel.launches += 1
    return y


interp_kernel.launches = 0
