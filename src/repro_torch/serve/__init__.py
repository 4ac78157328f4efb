"""Serving (port of ``src/repro/serve``).

* :mod:`repro_torch.serve.engine` -- batched request/response engine for
  the LM stack (Mamba-2);
* :mod:`repro_torch.serve.spike_engine` -- streaming multi-tenant spike
  serving over one credit-partitioned fabric (ingest thread, pinned
  staging slots, windowed device segments, graceful drain);
* :mod:`repro_torch.serve.tenancy` -- tenant QoS specs, credit
  partitioning and per-tenant conservation / latency ledgers;
* :mod:`repro_torch.serve.loadgen` -- seeded open-loop Poisson traffic.
"""
from repro_torch.serve import engine  # noqa: F401
from repro_torch.serve import loadgen  # noqa: F401
from repro_torch.serve import spike_engine  # noqa: F401
from repro_torch.serve import tenancy  # noqa: F401
