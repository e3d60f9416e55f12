"""No-op stand-in for the reference's `repro.obs.tracer`.

The compile chain (`compile/passes.py`, `compile/program.py`) wraps its
stages in `tracer.span(...)`; this module keeps that call site identical to
the reference while recording nothing.  The real tracer is a later part of
the port (ROADMAP.md, "Modules still to port", item 9)."""

from __future__ import annotations

import contextlib


class _NullSpan(contextlib.AbstractContextManager):
    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "host", track: str | None = None, **args):
    """Same signature as the reference's `tracer.span`; returns the shared
    no-op context manager."""
    return NULL_SPAN
