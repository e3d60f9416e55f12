"""Architecture config system: one frozen dataclass per assigned arch
(port of `repro/configs/base.py`; `act_dtype` is a `torch.dtype`).

Every config is selectable by ``--arch <id>`` in the launchers.  ``reduced()``
derives the CPU smoke-test variant (same family/block pattern, tiny dims).

Block patterns: a layer stack is ``n_layers / len(pattern)`` repetitions of
``pattern`` (the scan unit), e.g. Jamba's 1:7 attention:Mamba interleave is a
period-8 pattern.  Kinds: ``attn`` | ``attn_chunked`` | ``mamba`` | ``mlstm``
| ``slstm``.  ``moe_mask`` marks which pattern slots use the MoE FFN.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    n_shared: int = 0  # shared ("always-on") experts
    d_shared: int = 0  # hidden dim of the fused shared expert (0 = none)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...] = ("attn",)
    moe: MoEConfig | None = None
    moe_mask: tuple[bool, ...] = ()  # per pattern slot; () = all-dense
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    chunk_size: int = 8192  # window for attn_chunked
    rope_on_global: bool = True  # iRoPE: global-attn layers skip RoPE
    # pad attention heads up to this count (0 = none) so the head axis
    # divides the 16-way TP mesh; pad heads are hard-masked to zero output,
    # keeping the math identical to the unpadded architecture (the standard
    # head-padding trade: a little extra FLOPs for clean sharding)
    attn_pad_heads: int = 0
    # SSM (mamba) geometry
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    # modality frontend stub: None | "vision" | "audio"
    frontend: str | None = None
    frontend_len: int = 1024  # patches/frames contributed by the stub
    # sub-quadratic long-context support (SSM/hybrid/chunked-attention):
    # gates the long_500k dry-run cell (pure full-attention archs skip it)
    long_context: bool = False
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ---- derived ----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_super(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not a multiple of "
            f"pattern period {len(self.pattern)}"
        )
        return self.n_layers // len(self.pattern)

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def moe_for(self, slot: int) -> MoEConfig | None:
        if self.moe is None:
            return None
        if not self.moe_mask:
            return self.moe
        return self.moe if self.moe_mask[slot % len(self.pattern)] else None

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for slot, kind in enumerate(self.pattern):
            n_rep = self.n_super
            if kind in ("attn", "attn_chunked"):
                qkv = d * hd * (self.n_heads + 2 * self.n_kv_heads)
                out = self.n_heads * hd * d
                blk = qkv + out
            elif kind == "mamba":
                di, st, r = self.d_inner, self.ssm_state, self.dt_rank
                blk = (
                    d * 2 * di + self.ssm_conv * di + di * (r + 2 * st)
                    + r * di + di * st + di + di * d
                )
            elif kind in ("mlstm", "slstm"):
                di = self.d_model
                blk = 4 * d * di + 3 * di + di * d  # qkv+gates+out (approx)
            else:
                raise ValueError(kind)
            moe = self.moe_for(slot)
            if moe is None:
                ffn = 3 * d * self.d_ff
            else:
                ffn = moe.n_experts * 3 * d * moe.d_expert + d * moe.n_experts
                if moe.d_shared:
                    ffn += 3 * d * moe.d_shared
            total += n_rep * (blk + ffn + 2 * d)
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameters — the MoE-aware N of 6·N·D."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        total = self.n_params()
        for slot in range(len(self.pattern)):
            moe = self.moe_for(slot)
            if moe is None:
                continue
            dense_all = moe.n_experts * 3 * d * moe.d_expert
            dense_active = moe.top_k * 3 * d * moe.d_expert
            total -= self.n_super * (dense_all - dense_active)
        return total

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        period = len(self.pattern)
        moe = None
        moe_mask = self.moe_mask
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k), d_expert=64,
                d_shared=64 if self.moe.d_shared else 0,
                n_shared=min(1, self.moe.n_shared),
            )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=period * (2 if period <= 4 else 1),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2)
            if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            moe=moe,
            chunk_size=32,
            attn_pad_heads=0,
            ssm_state=8,
            frontend_len=8 if self.frontend else 1024,
        )


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _pkg  # ensure arch modules imported

    _pkg.load_all()
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch import configs as _pkg

    _pkg.load_all()
    return sorted(_REGISTRY)
