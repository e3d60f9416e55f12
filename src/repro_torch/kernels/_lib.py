"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source in `csrc/` (one per kernel, all including `aia_common.cuh`)
becomes its own shared library with a plain C interface, built at first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `build/repro_torch_kernels/` of the checkout (the root `.gitignore`
lists `build/`).  A library's file name carries a hash of its source, the
shared header and the flags, so an edited source is rebuilt and never
mistaken for a stale build.  `build()` starts one nvcc per missing library,
all at once, and waits for them; ptxas' register and spill report is kept
beside each library as `<name>.log`.

Nothing here runs at import: the CPU tests import every module, and this
host may have no nvcc at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
HEADER = CSRC / "aia_common.cuh"
SOURCES = ("interp_lut", "ky_sampler", "bn_gibbs", "mrf_gibbs")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# src/repro_torch/kernels/_lib.py -> the checkout's root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from source at first use"
        )
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(HEADER.read_bytes())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Build every named library that is missing, one nvcc each, all in
    parallel.  Returns seconds per library built (0.0 when it existed);
    raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `fn_name` of library `lib_name`, building and
    loading the library on first use.  Every entry point returns the
    cudaError_t of its launch as an int."""
    lib = _LOADED.get(lib_name)
    if lib is None:
        build([lib_name])
        lib = ctypes.CDLL(str(library_path(lib_name)))
        lib.aia_error_string.argtypes = [ctypes.c_int]
        lib.aia_error_string.restype = ctypes.c_char_p
        _LOADED[lib_name] = lib
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg = _LOADED[lib_name].aia_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The launch path takes CUDA tensors of one device only; the CPU path
    (the plain twin) is chosen by the caller before this check."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"{name}: every tensor must be on the same CUDA device, got "
                f"{t.device} and {dev}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


PTR = ctypes.c_void_p
INT = ctypes.c_int
UINT = ctypes.c_uint
LONG = ctypes.c_longlong
ULONG = ctypes.c_ulonglong
FLOAT = ctypes.c_float
