"""Where the port runs: the card by default, the CPU only on request."""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device: str | torch.device = DEFAULT) -> torch.device:
    """`device` as a `torch.device`; raises when it names CUDA and no card
    is present.  There is no fallback to the CPU: a caller that wants the
    plain torch path on the CPU passes device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain torch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report an indexed device; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
