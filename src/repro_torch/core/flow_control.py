"""Credit bank of the link flow control (port of the ``CreditBank`` part of
``src/repro/core/flow_control.py``).

Only the state type and its constructor are ported: the crossbar transport
carries a zero-link bank so that ``FabricState`` keeps one structure across
backends.  ``credit_tick``, the tenant partitions and the ring-buffer model
come with the torus transports.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import dispatch


class CreditBank(NamedTuple):
    """Producer-visible credits for K links + their notification delay lines.

    credits: (K,) int32 units the producer may still inject per link
    pending: (K, L) int32 spent units travelling back as notifications
    epoch:   () int32 count of past ticks on which anything was spent
    """

    credits: torch.Tensor
    pending: torch.Tensor
    epoch: torch.Tensor


def init_credits(n_links: int, limit: int, notify_latency: int, *,
                 device=None) -> CreditBank:
    """Fresh bank: ``limit`` credits on each of ``n_links`` links."""
    device = dispatch.resolve_device(device)
    return CreditBank(
        credits=torch.full((n_links,), limit, dtype=torch.int32,
                           device=device),
        pending=torch.zeros((n_links, max(notify_latency, 0)),
                            dtype=torch.int32, device=device),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )
