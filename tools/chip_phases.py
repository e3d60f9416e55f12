#!/usr/bin/env python3
"""Run chosen phases of `chip_smoke.py` alone on the card, in the order
given, each printing its JSON lines; exits 1 if one fails.  A quick
check on the card of a change to those phases, from the repository root:

    python3 tools/chip_phases.py phase_train_block phase_train_lm

The phases that take arguments from earlier phases (`timing`, the serve
phases' `per_call`) cannot run alone; `PHASES` lists those that can, the
LM mesh's among them (`phase_serve_lm_mesh`, `phase_train_lm_mesh`).
"""

import importlib.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke's phases that take nothing from an earlier phase
PHASES = ("phase_build", "phase_threefry", "phase_k2", "phase_k1",
          "phase_k3", "phase_k4", "phase_serve", "phase_serve_mrf",
          "phase_k5", "phase_k6", "phase_serve_ranks", "phase_lanes",
          "phase_serve_runtime", "phase_profile", "phase_mamba_block",
          "phase_moe_block", "phase_train_lm", "phase_train_block",
          "phase_serve_lm_mesh", "phase_train_lm_mesh")


def main(argv=None) -> int:
    names = sys.argv[1:] if argv is None else argv
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"chip_phases: {unknown} cannot run alone; one of {PHASES}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))  # spawned ranks import chip_smoke by name
    import torch

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    rc = 0
    for name in names:
        t0 = time.perf_counter()
        try:
            getattr(cs, name)(torch)
        except SystemExit as e:  # chip_smoke's `fail`
            print(f"chip_phases: {name}: {e}", flush=True)
            rc = 1
        cs.emit({"phase_seconds": name, "s": time.perf_counter() - t0})
    return rc


if __name__ == "__main__":
    sys.exit(main())
