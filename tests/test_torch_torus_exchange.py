"""Kernel H and the shared ring rotation (``csrc/torus_exchange.cu``) on the
CPU, where the kernels cannot run.

A Python emulation of the kernels' decomposition (one holder's closed-form
sums per phase, direction and hop; per row, per word and per credit slot,
then per (shard, tenant)) fills the wrapper's own output views, and is held
bit for bit against the eager chain it replaces on the card:
``TorusTransport._rotate`` (E = 1 and E = T count columns, strided) and
``TenantTorusTransport.exchange`` (every ``TransportOut``, ``LinkStats``
and ``FabricState`` field, through ``_exchange_card``'s own assembly), on
threaded windows of 1-D rings of 3, 4 and 5, 2x4, 2x2x2 and 2x2x4 with 1-3
tenants, parked rows, deferrals, an uncredited window and the drain.  The
card test at the end holds the kernels against the eager chain on the
card.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.core import aggregator
from repro_torch.core import events as ev
from repro_torch.core import flow_control as fc
from repro_torch.kernels import admission, dispatch
from repro_torch.kernels import torus_exchange as tx
from repro_torch.transport import torus as tt
from repro_torch.wire import framing, profiles

# -- csrc/torus_exchange.cu, line for line ------------------------------------

PACKET_MAX_EVENTS, DESERIAL_GROUP, EVENT_BYTES, PACKET_HEADER_BYTES = (
    124, 4, 4, 16)


def packet_bytes(n):
    if n <= 0:
        return 0
    return ((n + DESERIAL_GROUP - 1) // DESERIAL_GROUP * DESERIAL_GROUP
            * EVENT_BYTES + PACKET_HEADER_BYTES)


def window_bytes(c):
    return (c // PACKET_MAX_EVENTS * packet_bytes(PACKET_MAX_EVENTS)
            + packet_bytes(c % PACKET_MAX_EVENTS))


def frame_wire_bytes(w, payload):
    _, _, cell, header, crc, min_frame, gap, _ = w
    cells = (payload + cell - 1) // cell * cell
    return max(cells + header + crc, min_frame) + gap


def frame_bytes(w, n):
    epf, mtu, word = w[0], w[1], w[7]
    rem = n % epf
    return (n // epf * frame_wire_bytes(w, mtu)
            + (frame_wire_bytes(w, rem * word) if rem > 0 else 0))


class Torus:
    def __init__(self, dims):
        self.dims, self.ndim, self.n = tuple(dims), len(dims), math.prod(dims)
        self.stride = [math.prod(dims[:a]) for a in range(self.ndim)]

    def coord(self, x, a):
        return x // self.stride[a] % self.dims[a]

    def ring(self, p, a, j):
        n, c = self.dims[a], self.coord(p, a)
        return p + ((c + j) % n - c) * self.stride[a]


def bundle_entry(t, cnt, E, w, a, o, f):
    """Origin o's phase-a entries at ring distance f -> (bytes, frame
    bytes, events)."""
    n, st = t.dims[a], t.stride[a]
    k = (t.coord(o, a) + f) % n
    s = [0, 0, 0]
    for b in range(t.n // n):
        r = b % st + b // st * st * n + k * st
        src = dst = 0
        for i in range(t.ndim):
            done = i < a
            src += t.coord(r if done else o, i) * t.stride[i]
            dst += t.coord(o if done else r, i) * t.stride[i]
        for e in range(E):
            v = cnt(src, dst, e)
            s[0] += window_bytes(v)
            s[1] += frame_bytes(w, v)
            s[2] += v
    return s


def rotate_holder(t, cnt, E, w, p):
    bytes_, owire, in_flight, phase = 0, 0, 0, [0] * t.ndim
    for a in range(t.ndim):
        n = t.dims[a]
        for hops, sgn in ((n // 2, 1), ((n - 1) // 2, -1)):
            for h in range(1, hops + 1):
                o_send = t.ring(p, a, -sgn * (h - 1))
                for g in range(h, hops + 1):
                    s = bundle_entry(t, cnt, E, w, a, o_send, sgn * g)
                    bytes_ += s[0]
                    owire += s[1]
                o_recv = t.ring(p, a, -sgn * h)
                occ = sum(bundle_entry(t, cnt, E, w, a, o_recv, sgn * g)[2]
                          for g in range(h + 1, hops + 1))
                in_flight = max(in_flight, occ)
                phase[a] = max(phase[a], occ)
    return bytes_, owire, in_flight, phase


def total_hops(t):
    return sum(d // 2 + (d - 1) // 2 for d in t.dims)


def emulate_rotate(cnt: torch.Tensor, dims, fmt) -> tx.Rotation:
    """``torus_rotate_kernel`` into ``rotation_outputs``."""
    t, w = Torus(dims), tx.wire_args(fmt)
    extra = tuple(cnt.shape[2:])
    E = extra[0] if extra else 1
    c = cnt.reshape(t.n, t.n, E).numpy()
    at = lambda s, d, e: int(c[s, d, e])
    out = tx.rotation_outputs(t.n, extra, t.ndim, "cpu")
    for p in range(t.n):
        b, o, f, ph = rotate_holder(t, at, E, w, p)
        out.bytes[p], out.owire[p], out.in_flight[p] = b, o, f
        out.hops[p] = total_hops(t)
        out.in_flight_phase[p] = torch.tensor(ph, dtype=torch.int32)
    dv = out.delivered.reshape(t.n, E)
    for i in range(t.n * E):
        d, e = divmod(i, E)
        dv[d, e] = sum(at(s, d, e) for s in range(t.n))
    return out


def f32_us(fb: int, bytes_per_us: float, card: bool):
    """queue_us / park_wait_us of ``fb`` frame bytes: the card multiplies
    by the f32 reciprocal (PyTorch's CUDA division by a host scalar, and
    the kernel's), the CPU divides."""
    if card:
        return np.float32(fb) * np.float32(tx.reciprocal(bytes_per_us))
    return np.float32(fb) / np.float32(bytes_per_us)


def emulate_tenant_exchange(counts, payload, state, f_blocks, *, dims, fmt,
                            link_credits, max_hops, card=False):
    """``tenant_exchange_kernel`` into ``tenant_blocks``."""
    t, w = Torus(dims), tx.wire_args(fmt)
    S, T, W = counts.shape[0], counts.shape[1], payload.shape[-1]
    H, L = max_hops, state.bank.pending.shape[-1]
    R3, TK = T * S * S, (T + 1) * S * 2 * t.ndim
    cnt, pay = counts.reshape(-1).numpy(), payload.reshape(R3, W).numpy()
    pc0 = state.parked_count.reshape(-1).numpy()
    ppay0 = state.parked_payload.reshape(R3, W).numpy()
    fi = f_blocks[0].reshape(10, -1).numpy()
    fb_ = f_blocks[1].reshape(3, -1).numpy()
    fl = f_blocks[2].numpy()
    credits, pending = state.bank.credits.numpy(), state.bank.pending.numpy()
    b = tx.tenant_blocks(S, T, W, H, t.ndim, L, "cpu")
    recv = b.recv.reshape(R3, W + 1)
    masks, unparked = b.masks.reshape(2, R3), b.unparked.reshape(-1)
    us = b.us.reshape(2, R3)
    # 1. rows, words, credit slots
    for i in range(R3):
        s, tt_, d = i // (T * S), i // S % T, i % S
        f = (tt_ * S + s) * S + d
        c = int(cnt[i])
        fcm, fp, rs = (bool(fb_[k, f]) for k in range(3))
        local, pc = s == d, int(pc0[f])
        ship = fcm or (local and c > 0)
        row = (d * T + tt_) * S + s
        recv[row, W] = (c if ship else 0) + (pc if rs else 0)
        masks[0, i] = fcm or fp or local or c == 0
        masks[1, i] = fcm or local or c == 0
        unparked[i] = pc if rs else 0
        us[0, f] = float(f32_us(frame_bytes(w, int(fi[6, f])),
                                fmt.bytes_per_us, card))
        us[1, f] = float(f32_us(frame_bytes(w, int(fi[0, f]) * link_credits),
                                fmt.bytes_per_us, card))
        # the words of the row (one thread each in the kernel)
        recv[row, :W] = torch.from_numpy(
            ppay0[i] if rs else (pay[i] if ship else np.zeros_like(pay[i])))
        b.ppay.reshape(R3, W)[i] = torch.from_numpy(pay[i] if fp
                                                    else ppay0[i])
    spent_sum = 0
    for k in range(TK):
        spent, notify = int(fl[0, k]), int(fl[1, k])
        arrived = int(pending[k, 0]) if L > 0 else notify
        b.credits[k] = int(credits[k]) - spent + arrived
        for j in range(L):
            b.pending[k, j] = int(pending[k, j + 1]) if j + 1 < L else notify
        spent_sum += spent
    # 2. per-shard sums, the rotation, delivered events
    b.epoch.fill_(int(state.bank.epoch) + (1 if spent_sum > 0 else 0))
    sh = b.shard.reshape(len(tx.SHARD_FIELDS), S * T)
    F = {n: i for i, n in enumerate(tx.SHARD_FIELDS)}
    for q in range(S * T):
        s, tt_ = divmod(q, T)
        acc = dict.fromkeys(("offered", "sent", "parked", "stalls",
                             "unparked", "owire", "in_fabric", "rerouted"), 0)
        stall_h, park_h = [0] * H, [0] * H
        dwell = np.float32(0)
        for d in range(S):
            i, f = (s * T + tt_) * S + d, (tt_ * S + s) * S + d
            c = int(cnt[i])
            fcm, fp, rs = (bool(fb_[k, f]) for k in range(3))
            stall = int(fi[1, f])
            acc["offered"] += c
            acc["sent"] += c if bool(masks[1, i]) else 0
            acc["parked"] += c if fp else 0
            acc["stalls"] += 1 if stall >= 0 else 0
            acc["unparked"] += int(unparked[i])
            stall_h[min(max(stall, 0), H - 1)] += c if stall >= 0 else 0
            park_h[min(max(int(fi[3, f]), 0), H - 1)] += int(fi[2, f])
            acc["owire"] += (frame_bytes(w, int(pc0[f]) if rs else c)
                             * int(fi[5, f]))
            v = (np.float32(us[0, f].item()) + np.float32(us[1, f].item())
                 if (fcm or rs) else np.float32(0))
            dwell = v if d == 0 else np.float32(dwell + v)
            acc["in_fabric"] += int(fi[2, f])
            acc["rerouted"] += int(fi[7, f])
        for name, key in (("offered_events", "offered"),
                          ("sent_events", "sent"),
                          ("credit_stalls", "stalls"),
                          ("bytes_on_wire", "owire"),
                          ("parked_events", "parked"),
                          ("unparked_events", "unparked"),
                          ("in_fabric_events", "in_fabric"),
                          ("rerouted", "rerouted")):
            sh[F[name], q] = acc[key]
        sh[F["deferred_events"], q] = (acc["offered"] - acc["sent"]
                                       - acc["parked"])
        b.hists[0].reshape(S * T, H)[q] = torch.tensor(stall_h)
        b.hists[1].reshape(S * T, H)[q] = torch.tensor(park_h)
        b.dwell.reshape(-1)[q] = float(dwell)
    cin = lambda s, d, e: int(recv[(d * T + e) * S + s, W])
    for p in range(S):
        bytes_, _, in_flight, phase = rotate_holder(t, cin, T, w, p)
        for tt_ in range(T):
            q, t0 = p * T + tt_, tt_ == 0
            sh[F["hops"], q] = total_hops(t) if t0 else 0
            sh[F["forwarded_bytes"], q] = bytes_ if t0 else 0
            sh[F["max_in_flight"], q] = in_flight if t0 else 0
            b.phase.reshape(S * T, t.ndim)[q] = torch.tensor(
                phase if t0 else [0] * t.ndim)
    for q in range(S * T):
        d, tt_ = divmod(q, T)
        sh[F["delivered_events"], q] = sum(cin(s, d, tt_) for s in range(S))
    return tx.tenant_views(b)


def blocks_plain(counts, state, tables, link_down=None, *,
                 stall_lane=False) -> admission.TenantAdmissionBlocks:
    """Kernel F's packed blocks from the plain tenant replay."""
    adm = admission.admission_tenants(counts, state, tables, link_down,
                                      stall_lane=stall_lane)
    pack = lambda names: torch.stack([getattr(adm, f) for f in names])
    return admission.TenantAdmissionBlocks(
        pack(admission._TENANT_I32_FIELDS), pack(admission._BOOL_FIELDS),
        pack(admission._LINK_FIELDS), adm.stalled_by_link)


# -- comparison ---------------------------------------------------------------

def assert_same(got, want, what):
    """Every field of two (nested) NamedTuples: same dtype, shape and
    values bit for bit (floats compared by their bits)."""
    if want is None or got is None:
        assert got is None and want is None, what
        return
    if isinstance(want, tuple):
        assert type(got) is type(want) or got._fields == want._fields, what
        for name in want._fields:
            assert_same(getattr(got, name), getattr(want, name),
                        f"{what}.{name}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (
        what, got.dtype, want.dtype, got.shape, want.shape)
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), what


def assert_rotation(tr, cnt, what):
    want = tr._rotate(cnt)
    got = emulate_rotate(cnt, tr.dims, tr.wire_fmt)
    assert_same(got, want, what)


# -- the decomposition against the eager chain --------------------------------

DIMS = [(3,), (4,), (5,), (2, 4), (2, 2, 2), (2, 2, 4)]
N_WIN = 5


@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_kernel_decomposition_matches_eager_chain(dims, T, monkeypatch):
    """Threaded credited windows through ``_exchange_card`` with the
    emulated kernels (F's blocks from the plain replay) against the eager
    chain, every field bit for bit; the rotation of every window's shipped
    counts (E = T, strided), of each tenant's alone (E = 1) and of an
    uncredited window and the drain; parks, resumes and deferrals seen."""
    S = math.prod(dims)
    reserve = (4, 2, 0)[:T]
    notify = (2, 0, 1)[T - 1]
    fmt = "ethernet" if len(dims) == 3 else "extoll"
    tr = tt.TenantTorusTransport(
        S, dims, partition=fc.make_partition(16, reserve),
        notify_latency=notify, max_row_events=10, wire_format=fmt)
    monkeypatch.setattr(admission, "admission_tenants_blocks", blocks_plain)
    monkeypatch.setattr(tx, "tenant_exchange", emulate_tenant_exchange)
    rng = np.random.default_rng(1000 * S + 10 * T + len(dims))
    W = 3
    state = tr.init_state(W, device="cpu")
    seen = dict(parked=0, unparked=0, deferred=0)
    for win in range(N_WIN):
        counts = torch.from_numpy(rng.integers(0, 11, (S, T, S)).astype(
            np.int32))
        payload = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, (S, T, S, W), dtype=np.int64).astype(
                np.int32))
        want = tr.exchange(state, payload, counts)
        got = tr._exchange_card(state, payload, counts)
        assert_same(got, want, f"{dims} T{T} window {win}")
        cin = want.recv_counts.permute(2, 0, 1)          # [src, dst, tenant]
        assert_rotation(tr, cin, f"window {win} rotation, E = T")
        assert_rotation(tr, cin[..., 0], f"window {win} rotation, E = 1")
        seen["parked"] += int(want.stats.parked_events.sum())
        seen["unparked"] += int(want.stats.unparked_events.sum())
        seen["deferred"] += int(want.stats.deferred_events.sum())
        state = want.state
    assert seen["deferred"] > 0, seen
    if tr.max_hops >= 2:      # a row parks at a transit hop
        assert seen["parked"] > 0 and seen["unparked"] > 0, seen
    # the uncredited window and the drain run the shared rotation
    counts = torch.from_numpy(rng.integers(0, 11, (S, T, S)).astype(np.int32))
    assert_rotation(tr, counts.permute(0, 2, 1), "uncredited window")
    out = tr.exchange(state, torch.zeros((S, T, S, W), dtype=torch.int32),
                      counts, enforce_credits=False)
    assert_rotation(tr, out.state.parked_count.permute(1, 2, 0), "drain")


@pytest.mark.parametrize("dims", [(4,), (2, 4), (2, 2, 2)],
                         ids=lambda d: "x".join(map(str, d)))
def test_rotation_of_the_single_tenant_torus(dims):
    """E = 1 (the plain transport's credited window and drain): the
    emulated rotation equals the eager replay on random counts, on counts
    above a packet's and a frame's capacity, and on empty ones."""
    S = math.prod(dims)
    tr = tt.TorusTransport(S, dims, link_credits=0)
    rng = np.random.default_rng(S)
    for hi in (13, 400):
        cnt = torch.from_numpy(rng.integers(0, hi, (S, S)).astype(np.int32))
        assert_rotation(tr, cnt, f"{dims} hi {hi}")
    assert_rotation(tr, torch.zeros((S, S), dtype=torch.int32), "empty")


def test_kernel_constants_and_wire_arguments():
    """The kernel's packet model is core.events'; the wire arguments are
    each profile's geometry; queue_us on the card is frame bytes times the
    f32 reciprocal, which is what the kernel is given."""
    assert (PACKET_MAX_EVENTS, DESERIAL_GROUP, EVENT_BYTES,
            PACKET_HEADER_BYTES) == (ev.PACKET_MAX_EVENTS, ev.DESERIAL_GROUP,
                                     ev.EVENT_BYTES, ev.PACKET_HEADER_BYTES)
    for c in (0, 1, 3, 4, 5, 123, 124, 125, 400):
        assert window_bytes(c) == int(aggregator.window_cost(
            torch.tensor([c])).bytes)
    for name, fmt in profiles.PROFILES.items():
        w = tx.wire_args(fmt)
        assert w[0] == fmt.events_per_frame and w[7] == fmt.word_bytes
        for n in (0, 1, 63, 64, 65, 181, 182, 183, 1000):
            assert frame_bytes(w, n) == int(framing.frame_bytes(fmt, n)), (
                name, n)
    assert tx.reciprocal(12500.0) == float(np.float32(1) / np.float32(12500))
    # the rule the kernel follows differs from a division in some ulps
    fb = np.arange(1, 4000, dtype=np.float32)
    assert (fb * np.float32(tx.reciprocal(12500.0))
            != fb / np.float32(12500.0)).any()


def test_tenant_blocks_layout():
    """Kernel H's blocks tile one allocation without overlap, and the
    views have the eager chain's shapes, dtypes and strides."""
    S, T, W, H, ndim, L = 8, 2, 64, 3, 3, 2
    b = tx.tenant_blocks(S, T, W, H, ndim, L, "cpu")
    base_ptr = b.recv.data_ptr()
    spans = sorted((x.data_ptr() - base_ptr,
                    x.data_ptr() - base_ptr + x.numel() * x.element_size())
                   for x in b)
    assert spans[0][0] == 0
    assert all(a[1] <= c[0] for a, c in zip(spans, spans[1:]))
    v = tx.tenant_views(b)
    assert v.recv_payload.shape == (S, T, S, W)
    assert v.recv_payload.stride() == (T * S * (W + 1), S * (W + 1), W + 1, 1)
    assert v.recv_counts.shape == (S, T, S) and v.sent_mask.dtype == torch.bool
    assert v.queue_us.shape == (T, S, S) and v.queue_us.dtype == torch.float32
    assert v.queue_dwell_us.shape == (S, T) and v.epoch.shape == ()
    assert v.pending.shape == ((T + 1) * S * 2 * ndim, L)
    assert v.stalled_by_hop.shape == (S, T, H)
    assert v.max_in_flight_by_phase.shape == (S, T, ndim)


def test_wrappers_refuse_cpu_tensors():
    """The kernels take CUDA tensors only; the CPU runs the eager chain."""
    tr = tt.TenantTorusTransport(8, (2, 2, 2), partition=fc.make_partition(
        16, (4, 2)), max_row_events=12)
    state = tr.init_state(4, device="cpu")
    counts = torch.zeros((8, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tx.rotate(counts.permute(0, 2, 1), tr.dims, tr.wire_fmt)
    routes = tr._dev(torch.device("cpu"))["routes"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        admission.admission_tenants_blocks(counts.transpose(0, 1).contiguous(),
                                           state, routes)
    blocks = blocks_plain(counts.transpose(0, 1).contiguous(), state, routes)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tx.tenant_exchange(counts, torch.zeros((8, 2, 8, 4),
                                               dtype=torch.int32), state,
                           blocks, dims=tr.dims, fmt=tr.wire_fmt,
                           link_credits=16, max_hops=tr.max_hops)
    dispatch.reset_launches()
    tr.exchange(state, torch.zeros((8, 2, 8, 4), dtype=torch.int32), counts)
    assert dispatch.LAUNCHES == {}             # CPU tensors: plain version


# -- on the card --------------------------------------------------------------

def _serve_states(device, n_win):
    """``n_win`` threaded windows of the serving cells' fabric (8 shards,
    torus3d 2x2x2, 64 credits split 32 / 8, notify 2, rows of 64 words)
    with a saturating hot tenant -> [(state, payload, counts)]."""
    tr = tt.TenantTorusTransport(8, (2, 2, 2), partition=fc.make_partition(
        64, (32, 8)), notify_latency=2, max_row_events=32)
    g = torch.Generator(device="cpu").manual_seed(7)
    state = tr.init_state(64, device=device)
    out = []
    for _ in range(n_win):
        hot = torch.randint(0, 33, (8, 1, 8), generator=g)
        quiet = torch.randint(0, 6, (8, 1, 8), generator=g)
        counts = torch.cat([quiet, hot], 1).to(torch.int32).to(device)
        payload = torch.randint(-(1 << 31), (1 << 31) - 1, (8, 2, 8, 64),
                                generator=g, dtype=torch.int64).to(
            torch.int32).to(device)
        out.append((state, payload, counts))
        state = tr.exchange(state, payload, counts).state
    return tr, out


@pytest.mark.card
def test_kernels_match_the_eager_chain_on_the_card():
    """On the card: kernel H (after F) against the eager chain (the same
    F, the replayed rotation) on threaded serving windows, every field bit
    for bit, one H launch a window; the rotation kernel against the replay
    at the serving (E = T) and microcircuit (E = 1) shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel H has no CPU build")
    tr, windows = _serve_states("cuda", 24)
    plain = tt.TenantTorusTransport(8, (2, 2, 2),
                                    partition=tr.partition,
                                    notify_latency=2, max_row_events=32)
    plain._rotate = plain._rotate_plain
    parked = 0
    for i, (state, payload, counts) in enumerate(windows):
        dispatch.reset_launches()
        got = tr.exchange(state, payload, counts)
        assert dispatch.ENTRY_LAUNCHES == {"repro_admission_tenants": 1,
                                           "repro_tenant_exchange": 1}
        want = tt.TorusTransport.exchange(plain, state, payload, counts)
        assert_same(got, want, f"window {i}")
        parked += int(want.stats.parked_events.sum())
        cin = want.recv_counts.permute(2, 0, 1)
        assert_same(tr._rotate(cin), tr._rotate_plain(cin), f"rot {i}")
    assert parked > 0
    mc = tt.Torus3DTransport(8, link_credits=124, max_row_events=124)
    cnt = torch.randint(0, 300, (8, 8), dtype=torch.int32, device="cuda")
    assert_same(mc._rotate(cnt), mc._rotate_plain(cnt), "E = 1")
    torch.cuda.synchronize()
