"""`repro_torch.obs` — structured tracing for the port (a copy of the
reference's `repro.obs`, minus its XLA-HLO profiler).

Spans and counters from the compile chain, the serving runtime (flush,
admission and dispatch on the deterministic simulated clock, one lane per
executor worker), the batcher and calibration warmup are recorded into an
in-memory ring buffer and exported two ways:

  * a deterministic JSONL event log (wall fields stripped; same-seed runs
    are byte-identical), and
  * a Chrome/Perfetto `trace_event` timeline.

Tracing is off by default and costs one attribute check on every
instrumented path; enable with `REPRO_TRACE=1` or:

    from repro_torch import obs

    obs.enable()
    ...                                  # run the engine / compile chain
    obs.export.write_perfetto("trace.json", obs.get().events)
    obs.export.write_jsonl("trace.jsonl", obs.get().events)
    rows, gaps = obs.attrib.attribution(
        obs.export.events_as_dicts(obs.get().events))

`python -m repro_torch.runtime --trace-out trace.json` wires all of that
into the serving CLI.  `obs.timeseries` holds the deterministic sim-clock
metrics series the engine always records into `metrics.series`.  The
reference's `obs.profile` (static HLO costs per bucket executable) has no
port yet (ROADMAP.md).
"""

from repro_torch.obs import attrib, export, timeseries, tracer
from repro_torch.obs.tracer import (
    DEFAULT_CAPACITY,
    Event,
    Tracer,
    counter,
    disable,
    enable,
    enabled,
    get,
    instant,
    sim_span,
    span,
)

__all__ = [
    "attrib",
    "export",
    "timeseries",
    "tracer",
    "DEFAULT_CAPACITY",
    "Event",
    "Tracer",
    "counter",
    "disable",
    "enable",
    "enabled",
    "get",
    "instant",
    "sim_span",
    "span",
]
