"""`repro_torch.runtime` — batched posterior-query serving over compiled
programs (port of the reference's `repro.runtime`).

The serving layer: many users, many models, one box.  A query names a
registered model plus its runtime observations (BN evidence clamps / MRF
images and pinned pixels); the engine canonicalizes models *structure-only*
so every query on a model shares one compiled program, buckets compatible
queries, and answers each bucket in one pass: with `fused=True`, one K3
launch per BN sweep or one K4 launch per MRF half-step over every query of
the bucket (`batcher`).

Dispatches land on a pool of simulated workers (`executor.WorkerPool`;
large MRF buckets shard over a mesh slice through the fused sharded engine,
K6), long queries execute in bit-exact slices so short queries interleave
(`slice_iters`), service times come from measured-time calibration
(`calibrate.Calibrator`, line model cold), and saturating traffic meets
token-bucket admission + bounded queues (`admission.AdmissionConfig`).

    from repro_torch.runtime import Engine, zipf_trace

    models, queries = zipf_trace(60, quick=True)
    eng = Engine(models, n_workers=4, slice_iters=16)   # device="cuda"
    eng.submit(queries)
    eng.calibrate()                 # optional measured-time warmup
    results = eng.run()             # {qid: QueryResult}
    print(eng.metrics.table())

`python -m repro_torch.runtime --trace zipf --quick [--device cpu]`
replays the synthetic Zipf trace from the CLI.
"""

from repro_torch.runtime.admission import (
    AdmissionConfig,
    AdmissionController,
)
from repro_torch.runtime.batcher import (
    BucketKey,
    Query,
    QueryResult,
    bucket_key,
    execute_bucket,
    pad_size,
)
from repro_torch.runtime.calibrate import Calibrator, ServiceSig, sig_of
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.executor import Executor, ExecutorConfig, WorkerPool
from repro_torch.runtime.metrics import BatchRecord, RuntimeMetrics
from repro_torch.runtime.trace import (
    TRACES,
    bursty_trace,
    zipf_models,
    zipf_trace,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "BucketKey",
    "Query",
    "QueryResult",
    "bucket_key",
    "execute_bucket",
    "pad_size",
    "Calibrator",
    "ServiceSig",
    "sig_of",
    "Engine",
    "EngineConfig",
    "Executor",
    "ExecutorConfig",
    "WorkerPool",
    "BatchRecord",
    "RuntimeMetrics",
    "TRACES",
    "bursty_trace",
    "zipf_models",
    "zipf_trace",
]
