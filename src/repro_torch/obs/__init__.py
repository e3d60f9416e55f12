"""Observability hooks of the port.  Only the span API the compile chain
calls exists so far (`tracer.span`, a no-op); the tracer, exporters and
profiler of the reference's `repro.obs` are queued in ROADMAP.md."""
