"""Roofline terms on one NVIDIA H100 SXM (port of `repro/launch/roofline.py`).

    compute term    = max(flops / float32 peak, threefry calls / hash rate)
    memory term     = hbm_bytes / HBM bandwidth
    collective term = collective_bytes / link bandwidth

The reference reads its three inputs from XLA's optimized HLO on a TPU; the
port counts them from launch shapes (`launch/kernel_cost.py`), so the HLO
parsing (`parse_collectives`, `_body_trip_counts`) and the LM stack's
`model_flops` have no counterpart here.

The compute term takes the larger of the float32 time and the time the
kernels' in-kernel threefry hash needs (`aia::jax_word`, one call per
32-bit word): its 41 bit operations run only on the 64 INT32 lanes of an
SM, and its 41 + 31 integer instructions issue on at most 128 lanes, at
the SM clock.  `chip_smoke.py` reads those counts from the SASS of the
built kernel and holds its kernels' bounds to this model.

Mesh positions of the port all lie on one card (`core/distributed.py`),
so their collective bytes move through device memory and are priced at
HBM bandwidth.  `NVLINK_BW` is the rate for positions on different
cards, which no mesh has yet (meshes over several cards, ROADMAP §1).
"""

from __future__ import annotations

import dataclasses

# H100 SXM, NVIDIA data sheet, dense, at the 700 W limit
HBM_BW = 3.35e12  # bytes/s
PEAK_FLOPS = 67e12  # float32 op/s
SMS = 132
SM_CLOCK_HZ = 1.98e9  # nvidia-smi clocks.max.sm
ALU_LANES = 64  # INT32 lanes per SM: LOP3, SHF, PRMT run only here
ISSUE_LANES = 128  # lanes per SM one integer instruction can issue on
# instructions per threefry call (chip_smoke's threefry phase, from the
# SASS of `threefry_words_kernel`)
HASH_BIT_OPS = 41
HASH_ADD_OPS = 31
NVLINK_BW = 450e9  # bytes/s per direction, NVLink 4, between two cards


def hash_seconds(calls: float, bit_ops: float = HASH_BIT_OPS,
                 add_ops: float = HASH_ADD_OPS,
                 clock_hz: float = SM_CLOCK_HZ) -> float:
    """Least seconds for `calls` threefry calls on one card: their bit
    operations on the ALU lanes, and all their integer instructions at the
    issue rate."""
    bit = calls * bit_ops / (SMS * ALU_LANES * clock_hz)
    every = calls * (bit_ops + add_ops) / (SMS * ISSUE_LANES * clock_hz)
    return max(bit, every)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    hash_calls: float = 0.0

    @property
    def t_compute(self) -> float:
        return max(self.flops / PEAK_FLOPS, hash_seconds(self.hash_calls))

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / HBM_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "hash_calls": self.hash_calls,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }
