"""Metrics registry: counters, gauges, histograms; Prometheus text and
JSONL (port of ``src/repro/obs/metrics.py``).

A small registry in the Prometheus data model: every metric has a name,
help text and optional label names.  The latency histograms use the
port's log-2 bin edges (``wire.latency.LATENCY_BIN_EDGES_US``), so the
device-side digests feed in through :meth:`Histogram.add_binned`.

Two exports: :func:`prometheus_text` (the text exposition format, read
back by :func:`parse_prometheus`), and :meth:`Registry.snapshot` /
:func:`write_jsonl` (one JSON object per sample, a run directory's
``metrics.jsonl``).

Feeders of the port's stat records: :func:`export_link_stats`
(``LinkStats`` totals) and :func:`export_tenant_digests` (the serving
engine's per-tenant digests).  They take CPU or CUDA tensors or numpy
arrays; a tensor is copied to the host once, when it is summed.
"""
from __future__ import annotations

import json
import math
import re
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.wire import latency as wire_latency

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _label_key(labels: Sequence[str], kw: dict) -> tuple:
    if set(kw) != set(labels):
        raise ValueError(f"labels {sorted(kw)} != declared {sorted(labels)}")
    return tuple(str(kw[name]) for name in labels)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._values: dict[tuple, float] = {}

    def _fmt_labels(self, key: tuple) -> str:
        if not self.labels:
            return ""
        pairs = ",".join(f'{n}="{v}"' for n, v in zip(self.labels, key))
        return "{" + pairs + "}"

    def samples(self) -> Iterable[tuple[str, str, float]]:
        for key, v in sorted(self._values.items()):
            yield self.name, self._fmt_labels(key), v

    def value(self, **kw) -> float:
        return self._values.get(_label_key(self.labels, kw), 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **kw) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(self.labels, kw)
        self._values[key] = self._values.get(key, 0.0) + float(amount)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **kw) -> None:
        self._values[_label_key(self.labels, kw)] = float(value)


class Histogram(_Metric):
    """Pre-binned histogram (the device already bins latencies).

    ``edges`` are the inclusive upper bin edges; one overflow (+Inf) bin
    is implicit.  ``_sum`` is exact when the caller passes ``sum_value``,
    else estimated from the upper bin edges.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str],
                 edges: Sequence[float]):
        super().__init__(name, help, labels)
        self.edges = tuple(float(e) for e in edges)
        self._buckets: dict[tuple, np.ndarray] = {}
        self._sums: dict[tuple, float] = {}
        self._sum_exact: dict[tuple, bool] = {}

    def add_binned(self, counts, sum_value: float | None = None,
                   **kw) -> None:
        """Merge per-bin event counts (``len(edges)`` bins, or one more
        with an explicit overflow bin)."""
        counts = _np(counts, np.int64).reshape(-1)
        if counts.shape[0] == len(self.edges):
            counts = np.concatenate([counts, [0]])
        if counts.shape[0] != len(self.edges) + 1:
            raise ValueError(
                f"{self.name}: got {counts.shape[0]} bins, want "
                f"{len(self.edges)} (+1 overflow)")
        key = _label_key(self.labels, kw)
        self._buckets[key] = self._buckets.get(
            key, np.zeros(len(self.edges) + 1, np.int64)) + counts
        if sum_value is not None:
            self._sums[key] = self._sums.get(key, 0.0) + float(sum_value)
            self._sum_exact.setdefault(key, True)
        else:
            est = float(np.sum(counts[:-1] * np.asarray(self.edges)))
            self._sums[key] = self._sums.get(key, 0.0) + est
            self._sum_exact[key] = False

    def observe(self, value: float, **kw) -> None:
        idx = int(np.searchsorted(self.edges, value, side="left"))
        counts = np.zeros(len(self.edges) + 1, np.int64)
        counts[min(idx, len(self.edges))] = 1
        self.add_binned(counts, sum_value=value, **kw)

    def samples(self) -> Iterable[tuple[str, str, float]]:
        for key in sorted(self._buckets):
            counts = self._buckets[key]
            cum = 0
            for edge, c in zip(self.edges, counts[:-1]):
                cum += int(c)
                yield (self.name + "_bucket",
                       self._with_extra(key, ("le", self._fmt_le(edge))),
                       float(cum))
            cum += int(counts[-1])
            yield (self.name + "_bucket",
                   self._with_extra(key, ("le", "+Inf")), float(cum))
            yield self.name + "_count", self._fmt_labels(key), float(cum)
            yield (self.name + "_sum", self._fmt_labels(key),
                   float(self._sums.get(key, 0.0)))

    @staticmethod
    def _fmt_le(edge: float) -> str:
        return repr(edge) if not math.isinf(edge) else "+Inf"

    def _with_extra(self, key: tuple, extra: tuple[str, str]) -> str:
        pairs = [f'{n}="{v}"' for n, v in zip(self.labels, key)]
        pairs.append(f'{extra[0]}="{extra[1]}"')
        return "{" + ",".join(pairs) + "}"

    def percentile(self, q: float, **kw) -> float:
        """Upper-edge quantile estimate, as
        ``wire.latency.percentile_from_hist``: the upper edge of the bin
        holding the ceil(q * total)-th event; the open overflow bin
        reports twice the last edge; an empty histogram 0."""
        key = _label_key(self.labels, kw)
        counts = self._buckets.get(key)
        if counts is None:
            return 0.0
        total = int(counts.sum())
        if total == 0:
            return 0.0
        thresh = max(int(math.ceil(q * total)), 1)
        b = int(np.argmax(np.cumsum(counts) >= thresh))
        return (self.edges[b] if b < len(self.edges)
                else self.edges[-1] * 2)


class Registry:
    """Holds a run's metrics; one per process or run directory."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _add(self, m: _Metric) -> _Metric:
        prev = self._metrics.get(m.name)
        if prev is not None:
            if type(prev) is not type(m) or prev.labels != m.labels:
                raise ValueError(f"metric {m.name!r} re-registered with a "
                                 f"different type/labels")
            return prev
        self._metrics[m.name] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._add(Counter(name, help, labels))  # type: ignore

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._add(Gauge(name, help, labels))    # type: ignore

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  edges: Sequence[float] = wire_latency.LATENCY_BIN_EDGES_US
                  ) -> Histogram:
        return self._add(Histogram(name, help, labels, edges))  # type: ignore

    def metrics(self) -> list[_Metric]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self, ts: float | None = None) -> list[dict]:
        """One dict per sample (a ``metrics.jsonl`` row)."""
        ts = time.time() if ts is None else ts
        out = []
        for m in self.metrics():
            for name, labels, value in m.samples():
                out.append({"ts": ts, "metric": name, "kind": m.kind,
                            "labels": labels, "value": value})
        return out


def prometheus_text(reg: Registry) -> str:
    """Prometheus text exposition format, rev 0.0.4."""
    lines = []
    for m in reg.metrics():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for name, labels, value in m.samples():
            lines.append(f"{name}{labels} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> dict[str, dict[frozenset, float]]:
    """Parse the text exposition back: name -> {frozenset(label pairs):
    value}.  Raises ValueError on a malformed sample line or a sample
    without a ``# TYPE`` line."""
    out: dict[str, dict[frozenset, float]] = {}
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed sample line: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        key = frozenset(_LABEL_RE.findall(labels))
        out.setdefault(name, {})[key] = float(value)
    for name in out:
        base = name
        for suffix in ("_bucket", "_count", "_sum"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                base = name[: -len(suffix)]
        if base not in types:
            raise ValueError(f"sample {name!r} has no # TYPE line")
    return out


def write_jsonl(path: str, reg: Registry, ts: float | None = None) -> None:
    with open(path, "w") as f:
        for row in reg.snapshot(ts):
            f.write(json.dumps(row) + "\n")


# -- feeders of the port's stat records ---------------------------------------

def export_link_stats(reg: Registry, link_stats, *, backend: str) -> None:
    """Fold ``LinkStats`` totals (one window's or a run's stacked stats,
    any leading axes) into the registry: every field is summed."""
    fields = ("offered_events", "sent_events", "deferred_events",
              "delivered_events", "parked_events", "unparked_events",
              "rerouted", "credit_stalls", "hops", "bytes_on_wire")
    for f in fields:
        v = getattr(link_stats, f, None)
        if v is None:
            continue
        c = reg.counter(f"fabric_{f}_total",
                        f"sum of LinkStats.{f} over the run",
                        labels=("backend",))
        c.inc(float(_np(v, np.float64).sum()), backend=backend)
    dw = getattr(link_stats, "queue_dwell_us", None)
    if dw is not None:
        reg.counter("fabric_queue_dwell_us_total",
                    "total queueing dwell charged to delivered rows (us)",
                    labels=("backend",)).inc(
            float(_np(dw, np.float64).sum()), backend=backend)


def export_tenant_digests(reg: Registry, digests) -> None:
    """Per-tenant delivered counts and latency histograms from the serving
    engine's ledger digests (``serve.tenancy.TenantDigest``)."""
    c = reg.counter("tenant_delivered_events_total",
                    "events delivered to each tenant", labels=("tenant",))
    g99 = reg.gauge("tenant_latency_p99_us",
                    "per-tenant p99 event latency (us, log-bin estimate)",
                    labels=("tenant",))
    h = reg.histogram("tenant_latency_us",
                      "per-tenant event latency (us)", labels=("tenant",))
    for d in digests:
        c.inc(float(d.delivered), tenant=d.name)
        g99.set(float(d.p99_us), tenant=d.name)
        h.add_binned(_np(d.hist, np.int64),
                     sum_value=float(d.mean_us) * float(d.delivered),
                     tenant=d.name)
