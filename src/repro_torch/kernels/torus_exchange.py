"""The healthy torus exchange after admission: kernel H and the ring
rotation it shares (``csrc/torus_exchange.cu``).

No TPU kernel corresponds to it: the reference computes the window with a
chain of array operations (``src/repro/transport/torus.py``: the ring
phases, the ``LinkStats`` sums and the row delivery), and so does the
port's plain version, the eager chain of ``transport/torus.py``
(``TorusTransport._rotate`` and ``TenantTorusTransport.exchange``).  The
transport picks the path from its inputs: CUDA tensors without a dead-link
mask take these kernels, CPU tensors and a masked window (whose ring
phases flip bundles) the eager chain.  The wrappers here take CUDA tensors
only and refuse others.

* :func:`rotate` (entry ``repro_torus_rotate``, one launch): the
  dimension-ordered ring phases over (S, S, *E) [src, dst, ...] counts, E
  count columns (1 for the plain transport, T for the tenant one) ->
  :class:`Rotation`, every field the eager ``_rotate`` gives.
* :func:`tenant_exchange` (entry ``repro_tenant_exchange``, one launch,
  kernel H): after kernel F's tenant form, from F's packed output blocks,
  the rows shipped and delivered, the new transit buffer and credit bank,
  the custody masks, the dwell tables and every per-shard ``LinkStats``
  field, with the rotation of the shipped counts -> :class:`TenantExchange`,
  views of one allocation.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import dispatch

# rows of kernel H's (13, S, T) block of per-shard sums (the kernel's
# enum), under their LinkStats names
SHARD_FIELDS = ("offered_events", "sent_events", "deferred_events",
                "delivered_events", "credit_stalls", "hops",
                "forwarded_bytes", "bytes_on_wire", "max_in_flight",
                "parked_events", "unparked_events", "in_fabric_events",
                "rerouted")


class Rotation(NamedTuple):
    """One window's ring phases, per holder shard (S,), int32."""

    bytes: torch.Tensor            # forwarded bytes (packet model)
    owire: torch.Tensor            # frame bytes of every hop
    hops: torch.Tensor             # hops of all phases
    in_flight: torch.Tensor        # peak occupancy after an absorption
    in_flight_phase: torch.Tensor  # (S, ndim) the same per phase
    delivered: torch.Tensor        # (S, *E) events delivered to each shard


class TenantBlocks(NamedTuple):
    """Kernel H's output blocks, views of one int32 allocation, in the
    order of the entry point's output pointers."""

    recv: torch.Tensor        # (S, T, S, W + 1) [dst, tenant, src], count last
    ppay: torch.Tensor        # (S, T, S, W) the new transit buffer
    unparked: torch.Tensor    # (S, T, S)
    shard: torch.Tensor       # (13, S, T), rows SHARD_FIELDS
    hists: torch.Tensor       # (2, S, T, H) stalled_by_hop, parked_by_hop
    phase: torch.Tensor       # (S, T, ndim)
    credits: torch.Tensor     # ((T+1) K,)
    pending: torch.Tensor     # ((T+1) K, L)
    epoch: torch.Tensor       # ()
    us: torch.Tensor          # (2, T, S, S) f32 queue_us, park_wait_us
    dwell: torch.Tensor       # (S, T) f32
    masks: torch.Tensor       # (2, S, T, S) bool sent_mask, sent_now


class TenantExchange(NamedTuple):
    """Kernel H's result: ``TransportOut`` / ``LinkStats`` fields of a
    healthy credited tenant window and the new bank (shapes as
    ``TenantTorusTransport.exchange`` gives them)."""

    recv_payload: torch.Tensor
    recv_counts: torch.Tensor
    parked_payload: torch.Tensor
    credits: torch.Tensor
    pending: torch.Tensor
    epoch: torch.Tensor
    sent_mask: torch.Tensor
    sent_now: torch.Tensor
    queue_us: torch.Tensor
    park_wait_us: torch.Tensor
    unparked_now: torch.Tensor
    stalled_by_hop: torch.Tensor
    parked_by_hop: torch.Tensor
    max_in_flight_by_phase: torch.Tensor
    queue_dwell_us: torch.Tensor
    offered_events: torch.Tensor
    sent_events: torch.Tensor
    deferred_events: torch.Tensor
    delivered_events: torch.Tensor
    credit_stalls: torch.Tensor
    hops: torch.Tensor
    forwarded_bytes: torch.Tensor
    bytes_on_wire: torch.Tensor
    max_in_flight: torch.Tensor
    parked_events: torch.Tensor
    unparked_events: torch.Tensor
    in_fabric_events: torch.Tensor
    rerouted: torch.Tensor


@functools.lru_cache(maxsize=None)
def wire_args(fmt) -> tuple:
    """A ``WireFormat``'s framing geometry as the kernels take it."""
    return (fmt.events_per_frame, fmt.mtu_payload, fmt.cell_bytes,
            fmt.header_bytes, fmt.crc_bytes, fmt.min_frame_bytes,
            fmt.gap_bytes, fmt.word_bytes)


@functools.lru_cache(maxsize=None)
def reciprocal(bytes_per_us: float) -> float:
    """``1 / bytes_per_us`` in f32: PyTorch divides a CUDA f32 tensor by a
    host scalar as a product with the scalar's f32 reciprocal."""
    return float(np.float32(1.0) / np.float32(bytes_per_us))


def _dims3(dims) -> tuple:
    return (len(dims), *dims, *(1,) * (3 - len(dims)))


def _require(name: str, t: torch.Tensor, shape: tuple, dtype=torch.int32):
    """Refuse an operand that is not a contiguous ``dtype`` tensor of
    ``shape``."""
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"torus_exchange: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape}, got a "
                         f"{'' if t.is_contiguous() else 'strided '}"
                         f"{t.dtype} {tuple(t.shape)}")


def rotation_outputs(n: int, extra: tuple, ndim: int,
                     device) -> Rotation:
    """The rotation's outputs, views of one int32 allocation."""
    E = math.prod(extra)
    parts = torch.empty(4 * n + n * ndim + n * E, dtype=torch.int32,
                        device=device).split((n, n, n, n, n * ndim, n * E))
    return Rotation(*parts[:4], parts[4].view(n, ndim),
                    parts[5].view(n, *extra))


def rotate(cnt: torch.Tensor, dims: tuple, fmt) -> Rotation:
    """The healthy ring phases of a ``dims`` torus over (S, S) or (S, S, E)
    int32 counts [src, dst, (column)] of any strides, one launch."""
    if not dispatch.on_cuda(cnt):
        raise ValueError("torus_exchange.rotate takes CUDA tensors; the "
                         "plain version is TorusTransport._rotate")
    n = math.prod(dims)
    extra = tuple(cnt.shape[2:])
    if cnt.dtype != torch.int32 or tuple(cnt.shape[:2]) != (n, n) or len(
            extra) > 1 or not 1 <= len(dims) <= 3:
        raise ValueError(f"torus_exchange.rotate: int32 (S, S) or (S, S, E) "
                         f"counts of a 1-3 axis torus {dims} (S = {n}), got "
                         f"{cnt.dtype} {tuple(cnt.shape)}")
    out = rotation_outputs(n, extra, len(dims), cnt.device)
    dispatch.launch(
        "torus_exchange", "repro_torus_rotate", cnt.data_ptr(),
        cnt.stride(0), cnt.stride(1), cnt.stride(2) if extra else 0,
        extra[0] if extra else 1, *_dims3(dims), *wire_args(fmt),
        *(x.data_ptr() for x in out))
    return out


def tenant_blocks(S: int, T: int, W: int, H: int, ndim: int, L: int,
                  device) -> TenantBlocks:
    """Kernel H's output blocks for S shards, T tenants, rows of W words,
    ``max_hops`` H and a delay line of L windows."""
    R3, TK = S * T * S, (T + 1) * S * 2 * ndim
    sizes = (R3 * (W + 1), R3 * W, R3, len(SHARD_FIELDS) * S * T,
             2 * S * T * H, S * T * ndim, TK, TK * L, 1, 2 * R3, S * T,
             -(-2 * R3 // 4))
    p = torch.empty(sum(sizes), dtype=torch.int32, device=device).split(
        sizes)
    return TenantBlocks(
        recv=p[0].view(S, T, S, W + 1), ppay=p[1].view(S, T, S, W),
        unparked=p[2].view(S, T, S), shard=p[3].view(-1, S, T),
        hists=p[4].view(2, S, T, H), phase=p[5].view(S, T, ndim),
        credits=p[6], pending=p[7].view(TK, L), epoch=p[8].view(()),
        us=p[9].view(torch.float32).view(2, T, S, S),
        dwell=p[10].view(torch.float32).view(S, T),
        masks=p[11].view(torch.bool)[:2 * R3].view(2, S, T, S))


def tenant_views(b: TenantBlocks) -> TenantExchange:
    """The blocks as the fields of a :class:`TenantExchange`."""
    masks, us, hists = b.masks.unbind(0), b.us.unbind(0), b.hists.unbind(0)
    return TenantExchange(
        b.recv[..., :-1], b.recv[..., -1], b.ppay, b.credits, b.pending,
        b.epoch, masks[0], masks[1], us[0], us[1], b.unparked, hists[0],
        hists[1], b.phase, b.dwell, *b.shard.unbind(0))


def tenant_exchange(counts, payload, state, f_blocks, *, dims: tuple, fmt,
                    link_credits: int, max_hops: int) -> TenantExchange:
    """Kernel H, one launch after kernel F's tenant form.

    ``counts`` (S, T, S) and ``payload`` (S, T, S, W) int32 [src, tenant,
    dst] offered this window; ``state`` the window's partitioned
    ``FabricState`` (its transit tables and bank before F);
    ``f_blocks`` F's packed (i32, bools, links) output blocks of this
    window (``admission.admission_tenants_blocks``)."""
    f_i32, f_bool, f_links = f_blocks[:3]
    bank = state.bank
    if not dispatch.on_cuda(counts, payload, state.parked_count,
                            state.parked_payload, bank.credits,
                            bank.pending, bank.epoch, f_i32, f_bool,
                            f_links):
        raise ValueError("torus_exchange.tenant_exchange takes CUDA "
                         "tensors; the plain version is "
                         "TenantTorusTransport.exchange")
    S, T = counts.shape[0], counts.shape[1]
    W, ndim, L = payload.shape[-1], len(dims), bank.pending.shape[-1]
    TK = (T + 1) * S * 2 * ndim
    for name, t, shape in (("counts", counts, (S, T, S)),
                           ("payload", payload, (S, T, S, W)),
                           ("parked_count", state.parked_count, (T, S, S)),
                           ("parked_payload", state.parked_payload,
                            (S, T, S, W)),
                           ("credits", bank.credits, (TK,)),
                           ("pending", bank.pending, (TK, L)),
                           ("epoch", bank.epoch, ()),
                           ("f_i32", f_i32, (10, T, S, S)),
                           ("f_links", f_links, (3, TK))):
        _require(name, t, shape)
    _require("f_bool", f_bool, (3, T, S, S), torch.bool)
    b = tenant_blocks(S, T, W, max_hops, ndim, L, counts.device)
    dispatch.launch(
        "torus_exchange", "repro_tenant_exchange", counts.data_ptr(),
        payload.data_ptr(), state.parked_count.data_ptr(),
        state.parked_payload.data_ptr(), bank.credits.data_ptr(),
        bank.pending.data_ptr(), bank.epoch.data_ptr(), f_i32.data_ptr(),
        f_bool.data_ptr(), f_links.data_ptr(),
        *(x.data_ptr() for x in b), T, W, max_hops, L, link_credits,
        reciprocal(fmt.bytes_per_us), *_dims3(dims), *wire_args(fmt))
    return tenant_views(b)
