"""The full-scale microcircuit's port path at a small scale (0.004): the
sparse draw of the connectivity rule, the sparse partition and its source
address layout, delivery in event order, the 14-bit layout checks, and
the delivery kernel against its plain version on the card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import events as ev
from repro_torch.kernels import fused_route_bucket as frb
from repro_torch.kernels import synapse_deliver as sd
from repro_torch.snn import microcircuit as mc, network, simulator as sim

SCALE = 0.004
S = 8


@pytest.fixture(scope="module")
def dense():
    spec = mc.MicrocircuitSpec(scale=SCALE)
    w, is_inh = spec.weight_matrix()
    return spec, network.build_partition(w, is_inh, n_shards=S)


def sparse_from_dense(p: network.Partition) -> network.SparsePartition:
    """The sparse partition of a dense one's synapses, with its delays:
    the same network in the source layout."""
    tgt, src = np.nonzero(p.weights)
    sp = network.build_sparse_partition(
        torch.from_numpy(src.astype(np.int32)),
        torch.from_numpy(tgt.astype(np.int32)),
        torch.from_numpy(p.weights[tgt, src]), p.is_inh, p.n_shards)
    sp.delays_steps = p.delays_steps.copy()
    return sp


def _drive(spec, per, n_windows, window=8, seed=1):
    bg = np.zeros(S * per, np.float32)
    bg[:spec.n_neurons] = spec.bg_rates()
    lam = torch.from_numpy(bg.reshape(S, per) * 1e-4)
    g = torch.Generator().manual_seed(seed)
    return torch.poisson(lam.expand(n_windows, window, S, per),
                         generator=g) * 87.8


def _cfg(p, capacity=16, transport="torus3d", credits=16, e_max=256,
         residue=64):
    return sim.SimConfig(n_shards=S, per_shard=p.per_shard,
                         max_fan=p.fanout.shape[1], capacity=capacity,
                         e_max=e_max, residue=residue, transport=transport,
                         torus_nx=2, torus_ny=2, torus_nz=2,
                         link_credits=credits, notify_latency=2)


def test_sparse_draw_has_the_dense_rule_distribution():
    """Per population pair: the synapse count within binomial limits of
    n_tgt x n_src x p (none where p is 0), at most one per pair, the
    weight mean within 5 standard errors of the rule's and its sign the
    source's."""
    spec = mc.MicrocircuitSpec(scale=0.02, seed=7)
    src, tgt, w, is_inh = spec.synapses(chunk_rows=64)
    assert src.dtype == tgt.dtype == np.int32 and w.dtype == np.float32
    assert len(np.unique(tgt.astype(np.int64) * spec.n_neurons + src)) \
        == len(src)
    pop = spec.population_of()
    assert (is_inh == np.array([p.endswith("I") for p in
                                mc.POPULATIONS])[pop]).all()
    sizes = spec.sizes
    for i in range(8):
        for j in range(8):
            sel = (pop[tgt] == i) & (pop[src] == j)
            p = mc.CONN_PROB[i, j]
            n = sizes[i] * sizes[j]
            k = int(sel.sum())
            assert abs(k - n * p) <= 5 * np.sqrt(n * p * (1 - p)) + 1, (i, j)
            if not k:
                continue
            base = mc.W_EXC_PA * (mc.G_INH if j % 2 else 1.0) * (
                mc.W_L4E_L23E if (i, j) == (0, 2) else 1.0)
            sd_mean = abs(base) * mc.W_REL_SD / np.sqrt(k)
            assert abs(w[sel].mean() - base) <= 5 * sd_mean + 1e-3, (i, j)
            assert (np.sign(w[sel]) == np.sign(base)).all()


def test_sparse_partition_of_a_dense_matrix(dense):
    """The lists hold exactly the dense matrix's nonzeros, sorted by
    target, and the fan-out is the dense partition's."""
    _, p = dense
    sp = sparse_from_dense(p)
    assert sp.per_shard == p.per_shard and sp.n_neurons == p.n_neurons
    assert (sp.fanout.numpy() == p.fanout).all()
    assert sp.n_synapses == int((p.weights != 0).sum())
    assert (sp.delays_steps == p.delays_steps).all()
    st, per = sp.store, p.per_shard
    for s in range(S):
        for g in range(0, p.n_neurons, 7):
            lo, hi = int(st.row_ptr[s, g]), int(st.row_ptr[s, g + 1])
            col = p.weights[s * per:(s + 1) * per, g]
            want = np.nonzero(col)[0]
            assert (st.targets[lo:hi].numpy() == want).all(), (s, g)
            assert (st.weights[lo:hi].numpy() == col[want]).all()


def test_sparse_delivery_matches_the_dense_product(dense):
    """Delivery through the store of a dense matrix's synapses gives the
    ring input of that matrix's columns (float64 sums, within f32
    rounding), the dense deadline misses, and counts its adds."""
    _, p = dense
    sp = sparse_from_dense(p)
    per, C, L, t = p.per_shard, 12, 32, 4096
    g = torch.Generator().manual_seed(3)
    addr = torch.randint(0, per, (S, S, C), generator=g)
    ts = (t + torch.randint(-3, 16, (S, S, C), generator=g)) & ev.TS_MASK
    words = ev.pack(addr, ts)
    counts = torch.randint(0, C + 1, (S, S), generator=g).to(torch.int32)
    inh = torch.from_numpy(p.is_inh)
    rings = [torch.randn((L, S, per), generator=g) * 100 for _ in range(2)]
    got = [r.clone() for r in rings]
    miss = sd.synapse_deliver(*got, words, counts.T.contiguous().T, t,
                              sp.store, inh, per)
    want = [r.double() for r in rings]
    slack = ev.ts_slack(ts, t & ev.TS_MASK)
    n_adds = 0
    for s in range(S):
        for src in range(S):
            for k in range(int(counts[s, src])):
                gid = src * per + int(addr[s, src, k])
                col = torch.from_numpy(
                    p.weights[s * per:(s + 1) * per, gid]).double()
                slot = (t + max(int(slack[s, src, k]), 0)) % L
                want[int(p.is_inh[gid])][slot, s] += col
                n_adds += int((col != 0).sum())
    for a, b in zip(got, want):
        assert torch.allclose(a.double(), b, rtol=1e-6, atol=1e-3)
    live = torch.arange(C) < counts[..., None]
    assert torch.equal(miss, (live & (slack < 0)).sum((1, 2)).int())
    assert int(sp.store.count) == n_adds


def test_sparse_and_dense_simulators_agree(dense):
    """Over 10 credited torus windows the sparse path's every integer
    statistic equals the dense path's, and the rings and potentials agree
    within f32 rounding."""
    spec, p = dense
    sp = sparse_from_dense(p)
    out = []
    for part in (p, sp):
        init, run_segment, _ = sim.build_sharded_segments(
            _cfg(p), part, spec.bg_rates(), device="cpu")
        out.append(run_segment(init(0), 10,
                               drive=_drive(spec, p.per_shard, 10)))
    (ca, sa), (cb, sb) = out
    assert int(sa.spikes.sum()) > 0 and int(sa.deferred.sum()) > 0
    flat = lambda st: dict(zip(sim.WindowStats._fields, st))
    for name, a in flat(sa).items():
        b = flat(sb)[name]
        if name in ("link", "latency"):
            for x, y in zip(a, b):
                assert x is y is None or (
                    torch.allclose(x, y) if x.is_floating_point()
                    else torch.equal(x, y)), name
        else:
            assert torch.equal(a, b), name
    for a, b in ((ca.state.ring_exc, cb.state.ring_exc),
                 (ca.state.ring_inh, cb.state.ring_inh),
                 (ca.state.neuron.v, cb.state.neuron.v)):
        assert torch.allclose(a, b, rtol=2e-5, atol=1e-3)


def _direct_flush(words, dest, meta, C, R):
    """One window's flush written out: buckets in window order, the rest
    destination-major into the residue, with destinations."""
    rows = [[] for _ in range(S)]
    over = [[] for _ in range(S)]
    for w, d, m in zip(words.tolist(), dest.tolist(), meta.tolist()):
        if not (w >> 29) & 1 or not 0 <= d < S:
            continue
        (rows[d] if len(rows[d]) < C else over[d]).append((w, m, d))
    residue = [e for d in range(S) for e in over[d]][:R]
    return rows, residue


def test_source_layout_words_destinations_and_residue(dense, monkeypatch):
    """One sparse window on a crossbar at capacity 4: the flush's input
    (the compacted spikes, each replica's word ``pack(id, ts)`` and
    destination ``fanout[id, k]``) and its buckets, residue and residue
    destinations equal a direct construction from the raster."""
    spec, p = dense
    sp = sparse_from_dense(p)
    C, R, per, F = 4, 48, p.per_shard, p.fanout.shape[1]
    cfg = _cfg(p, capacity=C, transport="alltoall", credits=0, residue=R)
    raster = []
    real = sim.lif_window

    def spy(*a):
        out = real(*a)
        raster.append(out[1].clone())
        return out
    monkeypatch.setattr(sim, "lif_window", spy)
    init, run_segment, _ = sim.build_sharded_segments(
        cfg, sp, spec.bg_rates(), device="cpu")
    c, _ = run_segment(init(0), 3, drive=_drive(spec, per, 3))
    spikes, t0 = raster[-1], 16
    pend = c.pending
    assert int(spikes.sum()) > 0 and int(pend.residue.ne(0).sum()) > 0
    for s in range(S):
        words, dests, metas = [], [], []
        for step, i in zip(*np.nonzero(spikes[s].numpy())):
            ts = (t0 + step + int(p.delays_steps[s * per + i])) & ev.TS_MASK
            for k in range(F):
                words.append(int(ev.pack(torch.tensor(i), torch.tensor(ts))))
                dests.append(int(p.fanout[s * per + i, k]))
                metas.append(t0 + int(step))
        rows, residue = _direct_flush(torch.tensor(words),
                                      torch.tensor(dests),
                                      torch.tensor(metas), C, R)
        for d in range(S):
            n = len(rows[d])
            assert int(pend.counts[s, d]) == n
            assert pend.data[s, d, :n].tolist() == [e[0] for e in rows[d]]
            assert pend.meta[s, d, :n].tolist() == [e[1] for e in rows[d]]
        n = len(residue)
        assert pend.residue[s, :n].tolist() == [e[0] for e in residue]
        assert pend.residue_meta[s, :n].tolist() == [e[1] for e in residue]
        assert pend.residue_dest[s, :n].tolist() == [e[2] for e in residue]
        assert not pend.residue[s, n:].any()
        assert not pend.residue_dest[s, n:].any()


def test_flush_window_residue_destinations():
    """``with_residue_dest`` returns each deferred event's destination,
    destination-major, 0 past the deferred ones; the rest unchanged."""
    g = torch.Generator().manual_seed(5)
    n, C, R = 200, 6, 40
    words = ev.pack(torch.randint(0, 1 << 14, (3, n), generator=g),
                    torch.randint(0, 1 << 15, (3, n), generator=g),
                    valid=torch.rand((3, n), generator=g) < 0.9)
    dest = torch.randint(-1, S + 1, (3, n), generator=g).to(torch.int32)
    meta = torch.randint(0, 1000, (3, n), generator=g).to(torch.int32)
    fw = frb.flush_window(words, S, C, dest=dest, meta=meta, residue_len=R,
                          with_residue_meta=True, with_residue_dest=True)
    plain = frb.flush_window(words, S, C, dest=dest, meta=meta,
                             residue_len=R, with_residue_meta=True)
    assert plain.residue_dest is None
    assert torch.equal(fw.residue, plain.residue)
    for b in range(3):
        _, residue = _direct_flush(words[b], dest[b], meta[b], C, R)
        k = len(residue)
        assert int(fw.deferred[b]) == k
        assert fw.residue_dest[b, :k].tolist() == [e[2] for e in residue]
        assert not fw.residue_dest[b, k:].any()


def test_layouts_past_the_14_bit_field_raise():
    """``events.pack`` masks an address past 14 bits (it would alias a
    source); every layout that needs more addresses raises, naming the
    sizes: the replica layout at 2,049 neurons a shard x fan-out 8, the
    source layout at 16,385, the full-scale network over 4 shards."""
    assert int(ev.address(ev.pack(torch.tensor((1 << 14) + 5), 0))) == 5
    network.check_address_layout("replica", 2048, 8)
    with pytest.raises(ValueError, match=r"16392 addresses .*2049 neurons "
                                         r"a shard x fan-out 8.*16384"):
        network.check_address_layout("replica", 2049, 8)
    n = 2049 * S
    with pytest.raises(ValueError, match="replica address layout"):
        network.Partition(S, n, 2049, np.zeros((n, 8), np.int32),
                          np.zeros((1, 1), np.float32),
                          np.zeros(n, bool), np.zeros(n, np.int32))
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="16385 addresses"):
        network.build_sparse_partition(one, one, one.float(),
                                       np.zeros(16385, bool), 1)
    with pytest.raises(ValueError, match="19293 neurons a shard"):
        network.check_address_layout(
            "source", -(-mc.MicrocircuitSpec(1.0).n_neurons // 4))


def test_full_scale_example_refuses_four_shards():
    from repro_torch.examples import multiwafer_microcircuit as mw
    with pytest.raises(ValueError, match="14-bit"):
        mw.main(scale=1.0, n_shards=4, device="cpu")


@pytest.mark.card
def test_delivery_kernel_matches_plain_on_the_card(dense):
    """On the card: the delivery kernel against its plain version on
    random received windows over the small network's store and over a
    synthetic store with lists longer than a tile, bit for bit (rings,
    misses, counter), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the delivery kernel has no CPU build")
    from repro_torch.kernels import dispatch
    _, p = dense
    g = torch.Generator().manual_seed(11)
    stores = [(sparse_from_dense(p), p.per_shard,
               torch.from_numpy(p.is_inh))]
    per = 700                                   # ~3 tiles a shard
    n = S * per
    src = torch.randint(0, n, (200_000,), generator=g)
    tgt = torch.randint(0, n, (200_000,), generator=g)
    key = torch.unique(src * n + tgt)
    inh = torch.rand(n, generator=g) < 0.2
    big = network.build_sparse_partition(
        (key // n).int(), (key % n).int(),
        torch.randn(key.numel(), generator=g) * 80, inh.numpy(), S)
    stores.append((big, per, inh))
    for sp, per, inh in stores:
        for C, L, t in ((16, 32, 4096), (124, 32, 7), (300, 64, 40000)):
            addr = torch.randint(0, per + 3, (S, S, C), generator=g)
            ts = (t + torch.randint(-4, 20, (S, S, C), generator=g)) \
                & ev.TS_MASK
            words = ev.pack(addr, ts)
            counts = torch.randint(0, C + 1, (S, S), generator=g).to(
                torch.int32).T
            rings = [torch.randn((L, S, per), generator=g) for _ in range(2)]
            cpu = [r.clone() for r in rings]
            miss_p = sd.synapse_deliver(*cpu, words, counts, t, sp.store,
                                        inh, per)
            store = network.SynapseStore(*(x.cuda() for x in sp.store))
            store.count.zero_()
            card = [r.cuda() for r in rings]
            dispatch.reset_launches()
            miss_k = sd.synapse_deliver(*card, words.cuda(), counts.cuda(),
                                        t, store, inh.cuda(), per)
            assert dispatch.LAUNCHES == {"synapse_deliver": 1}
            assert torch.equal(miss_k.cpu(), miss_p)
            for a, b in zip(card, cpu):
                assert torch.equal(a.cpu(), b), (per, C, L, t)
            assert int(store.count) == int(sp.store.count)
            sp.store.count.zero_()


@pytest.mark.card
def test_flush_window_residue_destinations_on_the_card():
    """On the card: kernel A with per-event destinations against its plain
    version, with and without the residue's destinations, every field bit
    for bit; the destination table's launch unchanged (no lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel A has no CPU build")
    g = torch.Generator().manual_seed(13)
    for b, n, C, R in ((8, 9440, 124, 256), (8, 600, 16, 64),
                       (3, 5000, 40, 4096)):
        words = ev.pack(torch.randint(0, 1 << 14, (b, n), generator=g),
                        torch.randint(0, 1 << 15, (b, n), generator=g),
                        valid=torch.rand((b, n), generator=g) < 0.8)
        dest = torch.randint(-1, S + 1, (b, n), generator=g).to(torch.int32)
        meta = torch.randint(0, 1 << 20, (b, n), generator=g).to(torch.int32)
        lut = torch.randint(-1, S, (b, 1 << 14), generator=g).to(torch.int32)
        for with_dest in (False, True):
            kw = dict(meta=meta, residue_len=R, with_residue_meta=True,
                      with_residue_dest=with_dest,
                      wire_fmt=frb.codec.DEFAULT_WORD)
            for route in (dict(dest=dest), dict(dest_lut=lut)):
                want = frb.flush_window(words, S, C, **route, **kw)
                got = frb.flush_window(
                    words.cuda(), S, C,
                    **{k: v.cuda() for k, v in route.items()},
                    **{**kw, "meta": meta.cuda()})
                for name, x, y in zip(frb.FusedWindow._fields, got, want):
                    if name == "buckets":
                        assert all(torch.equal(u.cpu(), v)
                                   for u, v in zip(x, y)), name
                    else:
                        assert x is y is None or torch.equal(x.cpu(), y), \
                            (name, b, n, with_dest)
