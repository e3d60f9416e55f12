"""`repro_torch` — the PyTorch/CUDA port of the `repro` sampling system.

The JAX package `repro` is the reference; this package computes the same
functions with PyTorch on an NVIDIA H100, module for module
(`repro_torch/core/bayesnet.py` <-> `repro/core/bayesnet.py`).  The numpy
front end (graphs, coloring, mapping, IR, passes, schedule, verifier) is
copied; the device path is torch, and the Pallas kernels of the reference
are CUDA C++ kernels under `kernels/csrc/`, each with a plain torch twin.

Entry points that build device state take `device=` and default to
"cuda"; without a card they raise (`device.resolve`).  The CPU runs the
plain torch twins only when the caller asks for it with `device="cpu"`.
"""
