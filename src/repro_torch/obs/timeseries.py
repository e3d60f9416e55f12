"""Deterministic metrics time-series: typed counters, gauges, histograms
(a copy of `repro/obs/timeseries.py`).

The runtime engine is a deterministic simulation, so its metrics can be
*series*, not just end-of-run scalars — every sample is stamped with the
sim clock, and two same-seed runs emit byte-identical JSONL.  Three
series types:

  * ``Counter`` — monotone cumulative count; ``inc(t, v)`` records the
    new running total at sim time ``t``.
  * ``Gauge`` — instantaneous value; ``sample(t, v)`` records ``v``.
  * ``Histogram`` — fixed bucket boundaries chosen at creation (an
    exponential ladder by default, via :func:`exp_boundaries`);
    ``observe(t, v)`` increments the bucket whose upper bound first
    covers ``v``.  Quantiles come from bucket upper bounds, so they are
    conservative (an upper bound on the true quantile) and — like
    ``runtime.metrics.percentile`` — refuse to answer with fewer than
    two observations.

Everything here is pure Python on purpose: no torch, no wall clock, no
randomness.  Determinism rests on (a) callers stamping samples with the
sim clock, (b) a registry-global emission sequence number ordering the
exported lines, and (c) ``json.dumps(..., sort_keys=True)``.
"""

from __future__ import annotations

import json
import pathlib


def exp_boundaries(start: float, growth: float, n: int) -> tuple:
    """``n`` exponential bucket upper bounds: start, start*growth, ..."""
    if start <= 0 or growth <= 1 or n < 1:
        raise ValueError("need start > 0, growth > 1, n >= 1")
    return tuple(start * growth ** i for i in range(n))


# 100us .. ~7min in x2 steps: covers calibrated bucket service times and
# end-to-end sim latencies for every committed trace.
DEFAULT_LATENCY_BOUNDARIES = exp_boundaries(1e-4, 2.0, 23)

# pad efficiency lives in (0, 1]: sixteen linear buckets
PAD_EFF_BOUNDARIES = tuple((i + 1) / 16 for i in range(16))


class _Series:
    kind = "series"

    def __init__(self, name: str, registry: "SeriesRegistry"):
        self.name = name
        self._registry = registry
        self.samples: list = []  # (seq, t, value)

    def _record(self, t: float, value) -> None:
        self.samples.append((self._registry._next_seq(), float(t), value))

    def __len__(self) -> int:
        return len(self.samples)


class Counter(_Series):
    kind = "counter"

    def __init__(self, name, registry):
        super().__init__(name, registry)
        self.total = 0

    def inc(self, t: float, v: int = 1) -> None:
        self.total += v
        self._record(t, self.total)


class Gauge(_Series):
    kind = "gauge"

    def __init__(self, name, registry):
        super().__init__(name, registry)
        self.last = None

    def sample(self, t: float, v) -> None:
        self.last = v
        self._record(t, v)


class Histogram(_Series):
    kind = "histogram"

    def __init__(self, name, registry, boundaries=DEFAULT_LATENCY_BOUNDARIES):
        super().__init__(name, registry)
        if list(boundaries) != sorted(boundaries) or len(boundaries) < 2:
            raise ValueError("boundaries must be sorted, length >= 2")
        self.boundaries = tuple(float(b) for b in boundaries)
        # one count per boundary + one overflow bucket
        self.bucket_counts = [0] * (len(self.boundaries) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def _bucket(self, v: float) -> int:
        for i, b in enumerate(self.boundaries):
            if v <= b:
                return i
        return len(self.boundaries)

    def observe(self, t: float, v: float) -> None:
        v = float(v)
        i = self._bucket(v)
        self.bucket_counts[i] += 1
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self._record(t, i)  # samples store the bucket index, not the value

    def quantile(self, q: float):
        """Upper bound on the q-th percentile (q in 0..100).

        ``None`` with fewer than two observations — same refusal as
        ``runtime.metrics.percentile``: one sample has no distribution.
        Overflow-bucket hits report the observed max (the only honest
        upper bound available there).
        """
        if self.count < 2:
            return None
        rank = max(1, min(self.count, round(q / 100 * (self.count - 1)) + 1))
        seen = 0
        for i, c in enumerate(self.bucket_counts):
            seen += c
            if seen >= rank:
                if i < len(self.boundaries):
                    return self.boundaries[i]
                return self.vmax
        return self.vmax

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "total": round(self.total, 9),
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.quantile(50),
            "p95": self.quantile(95),
            "p99": self.quantile(99),
        }


class SeriesRegistry:
    """Named series with a global emission order for deterministic export."""

    def __init__(self):
        self.series: dict = {}
        self._seq = 0

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _get(self, name: str, cls, **kw):
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = cls(name, self, **kw)
        elif not isinstance(s, cls):
            raise TypeError(
                f"series {name!r} already registered as {s.kind}"
            )
        return s

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  boundaries=DEFAULT_LATENCY_BOUNDARIES) -> Histogram:
        return self._get(name, Histogram, boundaries=boundaries)

    def snapshot(self) -> dict:
        """Deterministic end-of-run summary keyed by series name."""
        out = {}
        for name in sorted(self.series):
            s = self.series[name]
            rec = {"kind": s.kind, "n_samples": len(s)}
            if isinstance(s, Histogram):
                rec.update(s.snapshot())
            elif isinstance(s, Counter):
                rec["total"] = s.total
            else:
                rec["last"] = s.last
            out[name] = rec
        return out

    def to_jsonl(self) -> str:
        """One line per sample, in global emission (seq) order.

        Sample values are sim-clock-stamped and derived from the
        deterministic event loop, so same-seed runs produce the same
        bytes — asserted by ``tests/test_profile.py``.
        """
        rows = []
        for name in sorted(self.series):
            s = self.series[name]
            for seq, t, v in s.samples:
                rows.append((seq, {
                    "seq": seq, "series": name, "kind": s.kind,
                    "t": round(t, 9), "value": v,
                }))
        rows.sort(key=lambda r: r[0])
        return "".join(
            json.dumps(rec, sort_keys=True) + "\n" for _, rec in rows
        )

    def write_jsonl(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(self.to_jsonl())
        return path
