"""The port's four examples (`examples/torch_*.py`, the counterparts of the
reference's `quickstart.py`, `mrf_denoise.py`, `serve_lm.py` and
`train_lm.py`), each run as a subprocess with `--device cpu` at its
smallest arguments: it exits 0 and prints its own check (quickstart: the
total variation distance under 0.05; mrf_denoise: the denoised error
below the noisy error, once on one device and once over 2 gloo ranks;
serve_lm: every sampler's line; train_lm: the loss fell by 0.3), and it
imports neither JAX nor the reference package (read from `python -X
importtime`; torch itself probes for Triton, whose module-level import
the port's lint refuses)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}

CASES = {
    "quickstart": [],
    "mrf_denoise": ["--size", "16", "--iters", "10"],
    "mrf_denoise_ranks": ["--size", "16", "--iters", "10", "--devices", "2"],
    "serve_lm": ["--batch", "2", "--prompt-len", "8", "--gen", "3"],
    "train_lm": ["--size", "2m", "--steps", "10"],
}


def _run(name: str, args: list, tmp_path) -> subprocess.CompletedProcess:
    script = ROOT / "examples" / f"torch_{name.removesuffix('_ranks')}.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    return subprocess.run(
        [sys.executable, "-X", "importtime", str(script), "--device", "cpu",
         *args], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args = CASES[name]
    if name == "train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    res = _run(name, args, tmp_path)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    out = res.stdout
    imported = {line.rsplit("|", 1)[1].strip().split(".")[0]
                for line in res.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "torch" in imported and not imported & FORBIDDEN, (
        imported & FORBIDDEN)
    if name == "quickstart":
        tvd = float(re.search(r"total variation distance: ([0-9.]+)",
                              out).group(1))
        assert tvd < 0.05 and "bit-exact with the baked compile" in out
    elif name.startswith("mrf_denoise"):
        noisy, denoised = map(float, re.search(
            r"noisy error ([0-9.]+) -> denoised error ([0-9.]+)",
            out).groups())
        assert denoised < noisy
        assert ("distributed {'data': 2, 'model': 1}" in out) == (
            name == "mrf_denoise_ranks")
    elif name == "serve_lm":
        for sampler in ("ky", "gumbel", "greedy"):
            assert f"[serve_lm] {sampler:7s}:" in out
    else:
        assert "[train_lm] loss decreased — OK" in out
    assert out.rstrip().endswith("OK")


def test_examples_need_a_card_by_default(tmp_path):
    """Without `--device`, an example runs on the card, and raises where
    there is none (this host): no fallback to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    script = ROOT / "examples" / "torch_serve_lm.py"
    res = subprocess.run(
        [sys.executable, str(script), "--batch", "2", "--prompt-len", "8",
         "--gen", "3"], cwd=tmp_path, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert res.returncode != 0
    assert "runs on a CUDA device by default" in res.stderr
