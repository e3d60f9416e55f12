"""Roofline terms on one NVIDIA H100 SXM (port of `repro/launch/roofline.py`).

    compute term    = max(flops / float32 peak, threefry calls / hash rate)
    memory term     = hbm_bytes / HBM bandwidth
    collective term = collective_bytes / link bandwidth

The reference reads its three inputs from XLA's optimized HLO on a TPU; the
port counts them from launch shapes (`launch/kernel_cost.py`), so the HLO
parsing (`parse_collectives`, `_body_trip_counts`) has no counterpart
here.  The LM stack's dry run (`launch/dryrun.py`) counts its step's
operations and bytes on meta tensors and its collectives through
`launch/collectives.py` (`CollectiveStats`), and prices them with
`LMRoofline`: bf16 operations at the tensor cores' peak, and each
collective at the rate of the link its group crosses.

The compute term takes the larger of the float32 time and the time the
kernels' in-kernel threefry hash needs (`aia::jax_word`, one call per
32-bit word): its 41 bit operations run only on the 64 INT32 lanes of an
SM, and its 41 + 31 integer instructions issue on at most 128 lanes, at
the SM clock.  `chip_smoke.py` reads those counts from the SASS of the
built kernel and holds its kernels' bounds to this model.

The sampler's mesh positions in one process all lie on one card
(`core/distributed.py`), so their collective bytes move through device
memory and are priced at HBM bandwidth.  The LM mesh puts a rank on a
card: a group within a host of 8 cards crosses NVLink (`NVLINK_BW`), a
group across hosts the network (`NETWORK_BW`).
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
BF16_FLOPS = 989e12  # dense bf16 tensor-core op/s, NVIDIA data sheet
# bytes/s per direction a card sends to other hosts: NVIDIA's DGX H100
# data sheet, eight ConnectX-7 400 Gb/s InfiniBand adapters, one a card
NETWORK_BW = 400e9 / 8
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


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


@dataclasses.dataclass
class CollectiveStats:
    """A step's collectives: result bytes and counts by op (all-gather,
    all-reduce), and bytes by the link their groups cross."""
    bytes_by_op: dict[str, int]
    count_by_op: dict[str, int]
    bytes_by_link: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


@dataclasses.dataclass
class LMRoofline:
    """One rank's step of the LM mesh on one H100 SXM: its operations at
    the bf16 tensor-core peak (the LM's products run in bf16), the bytes
    its ops read and write at HBM bandwidth, and its collectives' result
    bytes at the rate of each one's link.  `model_flops` is the analytic
    work a rank owes (`model_flops / n_chips`)."""
    flops: float
    hbm_bytes: float
    collectives: CollectiveStats
    model_flops: float = 0.0
    extra_seconds: float = 0.0  # the token draw's K1/K2, by shape

    @property
    def t_compute(self) -> float:
        return self.flops / BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW + self.extra_seconds

    @property
    def t_collective(self) -> float:
        return sum(b / LINK_BW[link]
                   for link, b in self.collectives.bytes_by_link.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collectives.total_bytes,
            "collective_bytes_by_link": self.collectives.bytes_by_link,
            "n_chips": 1, "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops(cfg, cell_kind: str, seq: int, batch: int) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D prefill,
    2·N per token decode; N = active params (MoE-aware)."""
    n = cfg.n_active_params()
    if cell_kind == "train":
        return 6.0 * n * seq * batch
    if cell_kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch  # decode: one token per sequence
