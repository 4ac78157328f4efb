"""Multi-tenant QoS policy: tenant specs -> partitioned fabric + digests
(port of ``src/repro/serve/tenancy.py``).

N concurrent experiments share one fabric.  Isolation comes from per-tenant
credit partitioning (``core.flow_control.CreditPartition``) enforced inside
the torus admission (``transport.torus.TenantTorusTransport``): each tenant
owns a guaranteed credit slice per link plus access to a shared best-effort
pool, and the admission round-robins over (tenant, source), so priority is
starvation-bounded in both axes.

What a ``reserve`` buys:

* per link and window, tenant ``t`` can always admit up to ``reserve[t]``
  events from its own slice, which no co-tenant can draw;
* a spent credit returns ``notify_latency`` windows later, so the sustained
  guaranteed rate is ``reserve[t] / max(notify_latency, 1)`` events per link
  per window (:func:`guaranteed_epw`); bursts above it borrow from the
  shared pool, first come first served;
* the coupling that remains is physical and bounded: a saturating co-tenant
  can fill the transit buffers, adding queueing dwell of at most one link
  credit budget per crossed link, never whole deferred windows.

The ledger is host numpy, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.core import flow_control as fc
from repro_torch.transport.torus import TenantTorusTransport, default_shape3d
from repro_torch.wire import latency as wire_latency


class TenantSpec(NamedTuple):
    """One tenant's QoS contract on the shared fabric.

    reserve:  guaranteed credits per link (its slice of every link's
              budget; 0 = pure best-effort tenant)
    rate_epw: nominal offered load in events per window (advisory: read
              by load generators and capacity checks, not enforced)
    """

    name: str
    reserve: int
    rate_epw: float = 0.0


def credit_partition(tenants: Sequence[TenantSpec],
                     link_credits: int) -> fc.CreditPartition:
    """Partition each link's ``link_credits`` by the tenants' reserves;
    the remainder becomes the shared best-effort pool."""
    return fc.make_partition(link_credits, [t.reserve for t in tenants])


def guaranteed_epw(spec: TenantSpec, notify_latency: int) -> float:
    """Sustained guaranteed admission, events per link per window."""
    return spec.reserve / max(notify_latency, 1)


def build_fabric(n_shards: int, tenants: Sequence[TenantSpec], *,
                 link_credits: int, notify_latency: int = 2,
                 nx: int = 0, ny: int = 0, nz: int = 0,
                 max_row_events: int = 0,
                 wire_format: str = "extoll",
                 stall_attribution: bool = False) -> TenantTorusTransport:
    """The shared 3-D torus with per-tenant credit partitioning.

    Dimensions default to the most-cubic factorization of ``n_shards``.
    ``stall_attribution`` adds the per-link table of deferred events
    (``LinkStats.stalled_by_link``, kernel F's stall lane) to every
    credited window: the flight recorder's congestion lane.
    """
    dims = (nx, ny, nz)
    if not all(dims):
        if any(dims):
            raise ValueError(
                "pass all of nx/ny/nz or none; partial specs are ambiguous "
                f"for the tenant fabric (got {dims})")
        dims = default_shape3d(n_shards)
    return TenantTorusTransport(
        n_shards, dims,
        partition=credit_partition(tenants, link_credits),
        notify_latency=notify_latency,
        max_row_events=max_row_events,
        wire_format=wire_format,
        stall_attribution=stall_attribution)


class TenantDigest(NamedTuple):
    """Run-level per-tenant latency/throughput attribution.

    p50/p99 come from the merged log-bin histogram (upper bin edge, a
    conservative over-estimate); max/mean are exact.
    """

    name: str
    delivered: int
    p50_us: float
    p99_us: float
    max_us: float
    mean_us: float
    hist: np.ndarray           # (N_LATENCY_BINS,) merged event histogram


class TenantLedger:
    """Per-tenant conservation + latency accounting across windows.

    Fed the per-window stats of the serve engine; answers whether every
    event landed somewhere accountable (``check_conservation``: injected
    == delivered + shed after the drain, per tenant) and what latency each
    tenant saw (``digests``).
    """

    def __init__(self, names: Sequence[str]):
        self.names = tuple(names)
        T = len(self.names)
        self.injected = np.zeros((T,), np.int64)
        self.clipped = np.zeros((T,), np.int64)
        self.delivered = np.zeros((T,), np.int64)
        self.shed = np.zeros((T,), np.int64)
        self.hist = np.zeros((T, wire_latency.N_LATENCY_BINS), np.int64)
        self.max_us = np.zeros((T,), np.float64)
        self._lat_weighted = np.zeros((T,), np.float64)

    def add_injected(self, counts: np.ndarray, clipped=None) -> None:
        self.injected += np.asarray(counts, np.int64)
        if clipped is not None:
            self.clipped += np.asarray(clipped, np.int64)

    def add_windows(self, delivered, shed, hist, max_us, mean_us) -> None:
        """Absorb stacked per-window per-tenant stats (any number of
        leading axes before the tenant axis; ``hist`` has one more, the
        bins)."""
        delivered = np.asarray(delivered, np.int64)
        lead = tuple(range(delivered.ndim - 1))
        self.delivered += delivered.sum(axis=lead)
        self.shed += np.asarray(shed, np.int64).sum(axis=lead)
        self.hist += np.asarray(hist, np.int64).sum(axis=lead)
        mx = np.asarray(max_us, np.float64)
        self.max_us = np.maximum(self.max_us,
                                 mx.max(axis=lead) if lead else mx)
        self._lat_weighted += (np.asarray(mean_us, np.float64)
                               * delivered).sum(axis=lead)

    def check_conservation(self) -> None:
        total = self.delivered + self.shed
        if not np.array_equal(self.injected, total):
            raise AssertionError(
                f"per-tenant event conservation violated: injected "
                f"{self.injected.tolist()} != delivered+shed "
                f"{total.tolist()}")

    def digests(self) -> list[TenantDigest]:
        out = []
        for t, name in enumerate(self.names):
            d = int(self.delivered[t])
            out.append(TenantDigest(
                name=name,
                delivered=d,
                p50_us=wire_latency.percentile_from_hist(self.hist[t], .5),
                p99_us=wire_latency.percentile_from_hist(self.hist[t], .99),
                max_us=float(self.max_us[t]),
                mean_us=float(self._lat_weighted[t] / d) if d else 0.0,
                hist=self.hist[t].copy(),
            ))
        return out

    def export_metrics(self, registry) -> None:
        """Feed the run-level per-tenant ledger into an
        ``obs.metrics.Registry``: delivered, injected and shed counters,
        the latency histogram and a p99 gauge per tenant."""
        from repro_torch.obs import metrics as obs_metrics
        obs_metrics.export_tenant_digests(registry, self.digests())
        inj = registry.counter(
            "tenant_injected_events_total",
            "Events staged to the device, per tenant.",
            labels=("tenant",))
        shed = registry.counter(
            "tenant_shed_events_total",
            "Fresh events dropped beyond the backlog bound, per tenant.",
            labels=("tenant",))
        for t, name in enumerate(self.names):
            inj.inc(int(self.injected[t]), tenant=name)
            shed.inc(int(self.shed[t]), tenant=name)


def tenant_rows(specs: Sequence[TenantSpec], ledger: TenantLedger,
                notify_latency: int) -> list[dict]:
    """JSON-serializable per-tenant rows (a run directory's
    ``tenants.jsonl``): QoS contract, conservation ledger and latency
    digest side by side."""
    rows = []
    for spec, d in zip(specs, ledger.digests()):
        t = ledger.names.index(spec.name)
        rows.append({
            "tenant": spec.name,
            "reserve": int(spec.reserve),
            "rate_epw": float(spec.rate_epw),
            "guaranteed_epw": guaranteed_epw(spec, notify_latency),
            "injected": int(ledger.injected[t]),
            "delivered": d.delivered,
            "shed": int(ledger.shed[t]),
            "clipped": int(ledger.clipped[t]),
            "p50_us": d.p50_us,
            "p99_us": d.p99_us,
            "max_us": d.max_us,
            "mean_us": d.mean_us,
            "hist": d.hist.astype(int).tolist(),
        })
    return rows
