"""Pluggable discrete-draw pipelines (port of `repro/core/draws.py`).

  lut_ky   : LUT-exp int8 weights + rejection-KY      (AIA, paper C1+C2)
  exact_ky : exact exp, 15-bit weights + rejection-KY (ablates C2)
  cdf      : normalized softmax + inverse-CDF search  (PULP/CPU baseline)
  gumbel   : Gumbel-max argmax                        (the reference's
             accelerator-native alternative)

All take (..., V) unnormalized log-potentials and return (...) int32 labels.
The KY paths are normalization-free end to end.  This is the unfused
engine's draw: plain torch, no kernel, as in the reference.  The KY paths
and the uniform/Gumbel noise consume the reference's random streams bit for
bit; softmax, cumsum and the logs are torch's, whose last bits may differ
from XLA's, so `cdf` and `gumbel` are held to the reference in
distribution.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import ky as ky_core
from repro_torch.core.interp import LUTSpec, interp_ref

SAMPLERS = ("lut_ky", "exact_ky", "cdf", "gumbel")


def draw_from_logits(
    logp: torch.Tensor,
    key: prng.Key,
    sampler: str,
    exp_table: torch.Tensor | None = None,
    exp_spec: LUTSpec | None = None,
    precision: int = 16,
    max_retries: int = 8,
) -> torch.Tensor:
    shape = logp.shape[:-1]
    v = logp.shape[-1]
    flat = logp.reshape(-1, v)
    if sampler == "gumbel":
        gum = prng.gumbel(key, flat.shape, flat.device)
        return torch.argmax(flat + gum, dim=-1).to(torch.int32).reshape(shape)
    if sampler == "cdf":
        c = torch.cumsum(torch.softmax(flat, dim=-1), dim=-1)
        u = prng.uniform(key, (flat.shape[0], 1), device=flat.device)
        lab = torch.clamp((c < u).sum(-1), max=v - 1)
        return lab.to(torch.int32).reshape(shape)
    z = flat - flat.amax(-1, keepdim=True)
    if sampler == "lut_ky":
        if exp_table is None or exp_spec is None:
            raise ValueError("lut_ky needs the exp-weight table and spec")
        w = torch.clamp(torch.round(interp_ref(z, exp_table, exp_spec)),
                        min=0.0).to(torch.int32)
        weight_bits = 8
    elif sampler == "exact_ky":
        weight_bits = 15
        w = ky_core.quantize_probs(torch.exp(z), bits=weight_bits)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    # sum(m) <= V * 2^weight_bits must fit in 2^precision or the rejection
    # bin would go negative and corrupt the DDG tree
    precision = max(precision, weight_bits + (v - 1).bit_length() + 1)
    n_words = -(-precision * max_retries // 32)
    words = ky_core.random_words(key, (flat.shape[0],), n_words, flat.device)
    labels, _ = ky_core.ky_sample_fast(
        w, words, n_bins=v, precision=precision, max_retries=max_retries
    )
    return labels.reshape(shape)
