"""Observability (port of ``src/repro/obs``): flight recorder, span
tracing, metrics, the run-directory report and logging.

* ``recorder`` -- the device-side flight recorder: a fixed-depth
  per-window telemetry ring carried by the simulator and the spike
  serving engine (off by default);
* ``spans`` -- Chrome-trace / Perfetto span tracing of host threads and
  device segments, correlated with the ring by absolute window index;
* ``metrics`` -- a counter / gauge / histogram registry with Prometheus
  text and JSONL snapshots, fed from ``LinkStats`` and the engines'
  ledgers;
* ``report`` -- ``python -m repro_torch.obs.report <run-dir>``: the most
  congested links, per-tenant latency and SLO burn, and fault events on
  one window timeline;
* ``log`` -- logging setup (stderr only).
"""
from repro_torch.obs.log import get_logger, setup_logging
from repro_torch.obs.metrics import Registry, parse_prometheus, prometheus_text
from repro_torch.obs.recorder import (COUNTER_FIELDS, RecorderConfig,
                                      TelemetryRing, counter_totals,
                                      global_rows, record, ring_init,
                                      ring_rows, ring_shard)
from repro_torch.obs.spans import Tracer, validate_trace

__all__ = [
    "COUNTER_FIELDS", "RecorderConfig", "Registry", "TelemetryRing",
    "Tracer", "counter_totals", "get_logger", "global_rows",
    "parse_prometheus", "prometheus_text", "record", "ring_init",
    "ring_rows", "ring_shard", "setup_logging", "validate_trace",
]
