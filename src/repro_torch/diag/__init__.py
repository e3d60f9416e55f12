"""`repro_torch.diag` — streaming sampling-quality observability (port of
`repro/diag`).

  * `diag.accum`  — chain-axis-vectorized streaming accumulators
    (Welford mean/variance over per-node one-hot marginals, split-chain
    R-hat, batch-means ESS) that ride inside the Gibbs loops on the
    chain state: no extra randomness, carry-over safe under slicing.
  * `diag.oracle` — total-variation / max-abs marginal audits against
    `core/exact.py` variable elimination where the elimination cost
    permits (declared "n/a" where it does not), plus the per-node
    KY-quantization TV floor that attributes error to quantization vs
    mixing.
  * `python -m repro_torch.diag` — the quality CLI: sweeps the bench zoo
    on both variants, audits against the oracle, and exits nonzero on an
    R-hat/ESS/TV threshold breach (`diag-*` rule ids).

Entry point elsewhere: `CompiledProgram.run(diagnostics=True)`.
"""

from __future__ import annotations

from repro_torch.diag.accum import (  # noqa: F401
    DEFAULT_BATCH_LEN,
    QualityAccum,
    QualitySnapshot,
    kept_count,
    make_accum,
    summarize,
    update,
)
from repro_torch.diag.oracle import (  # noqa: F401
    DEFAULT_VE_LIMIT,
    ky_quantization_tv,
    oracle_audit,
    quantized_pmf,
    ve_cost_estimate,
    ve_tractable,
)
