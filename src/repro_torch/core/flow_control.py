"""Credit-based flow control (port of ``src/repro/core/flow_control.py``,
paper §2.1): the credit bank of the link flow control and the ring-buffer
model.

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

The ring-buffer model (reference ``:54-121`` and ``:282-301``): FPGAs
write into a pre-registered ring in host memory and track its free space
in a space register that the consumer's notifications replenish
``notify_latency`` steps later.  :func:`run` is the closed loop of
Bernoulli producer, fixed-rate consumer and delay line.  The reference
draws the producer's ``want`` with ``jax.random`` inside its scan, which
torch cannot reproduce: ``run`` takes ``want`` as input (a test injects
the reference's draws) and otherwise draws from a ``torch.Generator``
seeded with ``seed``.  On CUDA it replays the loop in one launch of kernel
G's ring form (``kernels/cycle_models.py:ring_run``), on the CPU it runs
:func:`run_plain`.  A zero-length delay line (``notify_latency=0``) raises
``IndexError``, as the reference's ``pending.at[-1]`` and ``pending[0]``
do.
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
                            device=dispatch.resolve_device(device))
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

class RingConfig(NamedTuple):
    size: int = 64              # ring slots
    notify_latency: int = 8     # steps before consumed slots return as credit
    notify_batch: int = 1       # consumer notifies every k processed slots


class RingState(NamedTuple):
    wr: torch.Tensor           # () int32 producer write pointer (monotonic)
    rd: torch.Tensor           # () int32 consumer read pointer (monotonic)
    credits: torch.Tensor      # () int32 slots the producer may still write
    pending: torch.Tensor      # (L,) int32 credit notifications in flight
    unnotified: torch.Tensor   # () int32 consumed but not yet notified
    data: torch.Tensor         # (size,) payload (slot contents)


def init_ring(cfg: RingConfig, *, device=None) -> RingState:
    """An empty ring (``device=None`` is CUDA); the reference's ``uint32``
    payload is an int32 bit pattern here."""
    device = dispatch.resolve_device(device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return RingState(
        wr=zero, rd=zero.clone(),
        credits=torch.full((), cfg.size, dtype=torch.int32, device=device),
        pending=torch.zeros((cfg.notify_latency,), dtype=torch.int32,
                            device=device),
        unnotified=zero.clone(),
        data=torch.zeros((cfg.size,), dtype=torch.int32, device=device))


def producer_step(state: RingState, want, payload, cfg: RingConfig):
    """Try to write ``want`` (0/1 here; slot-granular) items.  Returns
    (state, written): writes stall when credits are 0."""
    can = torch.minimum(torch.as_tensor(want, device=state.wr.device)
                        .to(torch.int32), state.credits)
    slot = state.wr % cfg.size
    data = state.data.clone()
    data[slot] = torch.as_tensor(payload, dtype=data.dtype,
                                 device=data.device)
    data = torch.where(can > 0, data, state.data)
    return state._replace(wr=state.wr + can, credits=state.credits - can,
                          data=data), can


def consumer_step(state: RingState, rate, cfg: RingConfig):
    """Consume up to ``rate`` available items; the notification of every
    whole batch enters the tail of the delay line.  Returns (state,
    consumed)."""
    avail = state.wr - state.rd
    take = torch.minimum(torch.as_tensor(rate, device=avail.device)
                         .to(torch.int32), avail)
    unnot = state.unnotified + take
    notify = torch.div(unnot, cfg.notify_batch,
                       rounding_mode="floor") * cfg.notify_batch
    pending = state.pending.clone()
    pending[-1] += notify
    return state._replace(rd=state.rd + take, unnotified=unnot - notify,
                          pending=pending), take


def tick(state: RingState) -> RingState:
    """Advance the notification delay line one step; deliver head
    credits."""
    arrived = state.pending[0]
    pending = torch.cat([state.pending[1:], torch.zeros_like(
        state.pending[:1])])
    return state._replace(credits=state.credits + arrived, pending=pending)


class RunStats(NamedTuple):
    produced: torch.Tensor
    consumed: torch.Tensor
    stalls: torch.Tensor       # producer steps blocked on credits


def run_plain(cfg: RingConfig, want: torch.Tensor, consume_rate: int = 1):
    """The plain version of kernel G's ring form: producer, consumer and
    tick for each step of ``want`` ((steps,) int32), on its device.
    Returns (final state, :class:`RunStats` sums)."""
    state = init_ring(cfg, device=want.device)
    one = torch.ones((), dtype=torch.int32, device=want.device)
    wrote, took = [], []
    for w in want:
        state, can = producer_step(state, w, one, cfg)
        state, take = consumer_step(state, consume_rate, cfg)
        state = tick(state)
        wrote.append(can)
        took.append(take)
    zero = torch.zeros((), dtype=torch.int32, device=want.device)
    produced = torch.stack(wrote).sum(dtype=torch.int32) if wrote else zero
    consumed = torch.stack(took).sum(dtype=torch.int32) if took else zero
    stalls = want.sum(dtype=torch.int32) - produced
    return state, RunStats(produced, consumed, stalls)


def run(cfg: RingConfig, steps: int, produce_rate: float = 1.0,
        consume_rate: int = 1, seed: int = 0, *,
        want: torch.Tensor | None = None, device=None):
    """Closed-loop simulation: Bernoulli producer vs fixed-rate consumer.

    ``want``: optional (steps,) int tensor of the producer's wishes (the
    reference draws them with ``jax.random``); without it they are drawn
    from a ``torch.Generator`` seeded with ``seed`` (at ``produce_rate >=
    1`` every step wants).  Returns (final :class:`RingState`,
    :class:`RunStats` sums); one launch of kernel G on the card.
    """
    device = dispatch.resolve_device(device)
    if want is None:
        gen = torch.Generator().manual_seed(seed)
        want = (torch.rand((steps,), generator=gen) < produce_rate)
    want = want.to(device=device, dtype=torch.int32).contiguous()
    if want.shape != (steps,):
        raise ValueError(f"run: want must have shape ({steps},), got "
                         f"{tuple(want.shape)}")
    from repro_torch.kernels import cycle_models
    return cycle_models.ring_run(cfg, want, consume_rate)
