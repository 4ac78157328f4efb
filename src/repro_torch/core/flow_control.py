"""Credit bank of the link flow control (port of the ``CreditBank`` part of
``src/repro/core/flow_control.py``, paper §2.1).

Every directed egress link holds ``limit`` credits.  Spending is
synchronous and never overdraws; a spent credit enters a delay line of
``notify_latency`` windows and returns to the producer when the consumer's
notification lands (``notify_latency=0``: within the same tick).  Credits
never exceed their limit, and ``credits + pending.sum(-1)`` (plus the units
a caller holds in transit buffers) is conserved by every tick.

The tenant partitions (``CreditPartition``, ``make_partition``, ...) come
with the multi-tenant engine (ROADMAP queue 1, item 9), the ring-buffer
model (``RingState``, ``producer_step``, ...) with item 11.
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


def credit_tick(bank: CreditBank, spent: torch.Tensor,
                notify: torch.Tensor | None = None) -> CreditBank:
    """One window: spend ``spent`` (K,) units and advance the delay lines.

    ``notify`` (default ``spent``) enters the delay line this window.  A
    transit-buffer caller passes ``spent - newly_held + released``: a unit
    spent by a row that parks downstream is held (not notified) until the
    row departs, so ``credits + pending.sum(-1) + held == limit``.  The
    epoch counts ticks on which anything was spent.
    """
    spent = spent.to(torch.int32)
    notify = spent if notify is None else notify.to(torch.int32)
    epoch = bank.epoch + (spent.sum() > 0).to(torch.int32)
    if bank.pending.shape[-1] == 0:      # notify_latency == 0: refund now
        return bank._replace(credits=bank.credits - spent + notify,
                             epoch=epoch)
    arrived = bank.pending[:, 0]
    pending = torch.cat([bank.pending[:, 1:], notify[:, None]], dim=1)
    return CreditBank(credits=bank.credits - spent + arrived,
                      pending=pending, epoch=epoch)
