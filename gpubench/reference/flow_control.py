"""Credit-based flow control (frozen from the port's
``core/flow_control.py``, paper §2.1): the credit bank of the link flow
control.

Every directed egress link holds ``limit`` credits.  Spending is
synchronous and never overdraws; a spent credit enters a delay line of
``notify_latency`` windows and returns to the producer when the consumer's
notification lands (``notify_latency=0``: within the same tick).  Credits
never exceed their limit, and ``credits + pending.sum(-1)`` (plus the units
a caller holds in transit buffers) is conserved by every tick.

Tenant partitions (``CreditPartition``, ``make_partition``, ...) split
every link's budget into one guaranteed slice per tenant plus a shared
best-effort pool, as an ordinary bank of ``(T + 1) * K`` slots: slot
``t * K + l`` is tenant ``t``'s slice of link ``l``, slot ``T * K + l``
link ``l``'s shared pool.  ``credit_tick`` and the conservation identity
apply per slot unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .dispatch import resolve_device


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
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# Per-tenant credit partitions (multi-tenant QoS on top of CreditBank).
# ---------------------------------------------------------------------------

class CreditPartition(NamedTuple):
    """Static QoS split of each link's credit budget across tenants.

    reserve: per-tenant guaranteed credits per link (len T tuple)
    shared:  best-effort credits per link, drawn by any tenant after its
             own slice is exhausted
    """

    reserve: tuple[int, ...]
    shared: int

    @property
    def n_tenants(self) -> int:
        return len(self.reserve)

    @property
    def limit(self) -> int:
        """Total credits per physical link (the unpartitioned limit)."""
        return sum(self.reserve) + self.shared

    @property
    def n_slots_per_link(self) -> int:
        return self.n_tenants + 1


def make_partition(link_credits: int, reserve) -> CreditPartition:
    """Partition ``link_credits`` by the per-tenant ``reserve``; what is
    left becomes the shared pool.  Refuses oversubscription: a guarantee
    needs its slice to exist."""
    reserve = tuple(int(r) for r in reserve)
    if not reserve:
        raise ValueError("need at least one tenant")
    if any(r < 0 for r in reserve):
        raise ValueError(f"negative reserve: {reserve}")
    total = sum(reserve)
    if total > link_credits:
        raise ValueError(
            f"oversubscribed: sum(reserve)={total} > link_credits={link_credits}")
    return CreditPartition(reserve=reserve, shared=link_credits - total)


def partition_limits(part: CreditPartition, n_links: int, *,
                     device=None) -> torch.Tensor:
    """Per-slot initial credits, ((T+1)*K,) int32, tenant slices first."""
    per_link = torch.tensor(list(part.reserve) + [part.shared],
                            dtype=torch.int32,
                            device=resolve_device(device))
    return per_link[:, None].expand(part.n_slots_per_link,
                                    n_links).reshape(-1).contiguous()


def init_credits_from_limits(limits: torch.Tensor,
                             notify_latency: int) -> CreditBank:
    """Fresh bank with per-slot (non-uniform) initial credits, on the
    device of ``limits``."""
    limits = limits.to(torch.int32)
    return CreditBank(
        credits=limits.clone(),
        pending=torch.zeros((limits.shape[0], max(notify_latency, 0)),
                            dtype=torch.int32, device=limits.device),
        epoch=torch.zeros((), dtype=torch.int32, device=limits.device),
    )


def init_partitioned_credits(part: CreditPartition, n_links: int,
                             notify_latency: int, *,
                             device=None) -> CreditBank:
    """Partitioned bank over ``n_links`` physical links: ``(T+1)*n_links``
    slots, tenant slices first, the shared pool last."""
    return init_credits_from_limits(
        partition_limits(part, n_links, device=device), notify_latency)


# ---------------------------------------------------------------------------
# The ring-buffer model.
# ---------------------------------------------------------------------------
