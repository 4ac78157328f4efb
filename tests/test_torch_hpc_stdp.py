"""NEST's HPC benchmark network on the port: the alpha-current neuron, the
plasticity rule, multapses, the partition, and the simulator with
plasticity on, against the benchmark's plain reference
(``gpubench/reference/stdp_simulator.py``) bit for bit at a tiny size;
the exponential form's types and the static delivery unchanged.  Its
`card` tests hold kernel C's alpha form and kernel S's plastic form to
their plain versions at the cell's load.  About 15 s on one worker (the
card tests skip here)."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench.harness import compare  # noqa: E402
from gpubench.reference import stdp_simulator as rstdp  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.kernels import lif_step as kl  # noqa: E402
from repro_torch.kernels import synapse_deliver as sd  # noqa: E402
from repro_torch.snn import hpc_benchmark as hb  # noqa: E402
from repro_torch.snn import lif, network, simulator as sim, stdp  # noqa: E402

S = 8
SP = hb.STDP
P = hb.PARAMS


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run many small ops, which a
    thread pool shared with the suite's other workers only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_alpha_psp_peaks_at_je_after_its_rise_time():
    """One input of JE_pA at rest: the PSP peaks at 0.14 mV, 1.70 ms (17
    steps) after the step that took it, as the script's conversion
    says."""
    spec = hb.HpcSpec(scale=1.0)
    assert abs(spec.je_pa - 45.6096) < 1e-3
    assert abs(hb.t_rise() - 1.7007587) < 1e-6
    assert abs(spec.drive_rate_hz() - 20856.04) < 0.01
    st = lif.init_alpha_state(torch.zeros(1))
    vs = []
    for k in range(60):
        inp = torch.tensor([spec.je_pa if k == 0 else 0.0])
        st, _ = lif.alpha_step(st, P, inp, torch.zeros(1))
        vs.append(float(st.v[0]))
    assert int(np.argmax(vs)) == 17
    assert abs(max(vs) - 0.14) < 1e-6


def _f(x):
    return float(np.float32(x))


def test_rule_gives_the_formulas_weight_changes():
    """A hand-worked sequence: a source's previous spike at step 100
    (K+ 1.5 before this one), this spike at 300, d = 15.  Post spikes of
    the target at 80 (at or before t_last - d = 85: out of the range), 120
    and 285 = t_spike - d (in
    (t_last - d, t_spike - d], so both facilitate, oldest first) and 290
    (after it).  The newest post spike strictly before 285 is 120, so 285
    facilitates but does not depress."""
    plus = lif.decay_table(0.1, SP.tau_plus)
    minus = lif.decay_table(0.1, SP.tau_minus)
    steps = torch.tensor([[80, 120, 285, 290] + [0] * (SP.history - 4)],
                         dtype=torch.int32)
    kms = torch.tensor([[1.0, 1.3, 1.1, 2.0] + [0.0] * (SP.history - 4)])
    w0, kp, tl, ts, d = 40.0, 1.5, 100, 300, 15
    w, c = stdp.rule(torch.tensor([w0]), torch.tensor([ts]),
                     torch.tensor([kp]), torch.tensor([tl]), steps, kms,
                     torch.tensor([4]), SP, plus, minus)
    lam, la = SP.f32()
    e = lambda k, tau: _f(np.exp(np.float64(k) * (-0.1 / tau)))
    want = np.float32(w0)
    for tk in (120, 285):
        kt = np.float32(kp) * np.float32(e(tk + d - tl, SP.tau_plus))
        pw = np.float32(np.float64(want) ** SP.mu)
        want = np.float32(want + np.float32(np.float32(lam) * pw) * kt)
    km = np.float32(1.3) * np.float32(e(ts - d - 120, SP.tau_minus))
    want = np.float32(want - np.float32(np.float32(la) * want) * km)
    assert float(w[0]) == float(want)
    assert c[0].tolist() == [1, 2, 0, 0, 4]        # 4 entries read: to 80
    # the formulas, in float64: the change within float32 rounding
    w64 = w0
    for tk in (120, 285):
        w64 += 0.1 * w64 ** 0.4 * kp * np.exp((tl - tk - d) * 0.1 / 15.0)
    w64 -= 0.1 * 0.0513 * w64 * 1.3 * np.exp(-(ts - d - 120) * 0.1 / 30.0)
    assert abs(float(w[0]) - w64) < 1e-4
    # a first event (no earlier spike) facilitates nothing, depresses
    w1, c1 = stdp.rule(torch.tensor([w0]), torch.tensor([ts]),
                       torch.tensor([0.0]), torch.tensor([-1]), steps, kms,
                       torch.tensor([4]), SP, plus, minus)
    assert c1[0].tolist() == [1, 0, 0, 0, 3] and float(w1[0]) < w0


def test_rule_counts_a_walk_past_the_archive():
    """Entries overwritten (count > H) and the range reaching past the
    oldest kept one: history_short; depression clipped at 0 counts."""
    plus = lif.decay_table(0.1, SP.tau_plus)
    minus = lif.decay_table(0.1, SP.tau_minus)
    H = 4
    sp = SP._replace(history=H)
    steps = torch.tensor([[200, 210, 220, 230]], dtype=torch.int32)
    kms = torch.tensor([[1e6, 1e6, 1e6, 1e6]])
    w, c = stdp.rule(torch.tensor([5.0]), torch.tensor([300]),
                     torch.tensor([1.0]), torch.tensor([100]), steps, kms,
                     torch.tensor([9]), sp, plus, minus)
    assert c[0].tolist() == [1, 4, 1, 1, 4] and float(w[0]) == 0.0


def _one_list_store(targets, weights):
    """One shard's store whose source 0 lists ``targets``."""
    n = len(targets)
    row_ptr = torch.zeros((1, 3), dtype=torch.int64)
    row_ptr[0, 1:] = n
    return network.MultapseStore(
        row_ptr, torch.tensor(targets, dtype=torch.int32),
        torch.tensor(weights, dtype=torch.float32),
        torch.zeros(1, dtype=torch.int64))


def test_multapses_add_twice_in_order():
    """A list repeating a target adds each of its synapses, in list
    order, after what was there: (r + a) + b, not r + (a + b)."""
    r0, a, b = 1.0, 2.0 ** -24, 2.0 ** -24
    store = _one_list_store([0, 0, 1], [a, b, 3.0])
    rings = [torch.zeros((4, 1, 2)) for _ in range(2)]
    rings[0][:] = r0
    words = ev.pack(torch.tensor([[[0]]]), torch.tensor([[[2]]]))
    counts = torch.tensor([[1]], dtype=torch.int32)
    sd.synapse_deliver(*rings, words, counts, 0, store,
                       torch.zeros(2, dtype=torch.bool), 2)
    want = np.float32(np.float32(np.float32(r0) + np.float32(a))
                      + np.float32(b))
    assert float(rings[0][2, 0, 0]) == float(want) != float(
        np.float32(r0) + np.float32(a + b))
    assert float(rings[0][2, 0, 1]) == 4.0 and int(store.count) == 3


def _tiny(seed=3, je_scale=20.0):
    spec = hb.HpcSpec(scale=400 / 11250)
    g = torch.Generator().manual_seed(seed)
    src = spec.draw_sources(g, ce=80, ci=20)
    je, ji = spec.je_pa * je_scale, spec.ji_pa * je_scale
    return spec, src, je, ji, g


def _cfg(part, transport):
    kw = dict(transport="alltoall", capacity=48) if transport == "alltoall" \
        else dict(transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
                  capacity=16, link_credits=24, notify_latency=2)
    return sim.SimConfig(n_shards=S, per_shard=part.per_shard,
                         max_fan=part.fanout.shape[1], window=8, ring_len=32,
                         e_max=128, residue=64, params=P, **kw)


def test_partition_keeps_draw_order_and_multapses():
    """Every synapse of the draw is in the store once: per target, the
    static and plastic lists together hold its sources as drawn, each
    (source, target) pair as often as drawn; the plastic ones are the
    E->E ones and start at JE."""
    spec, src, je, ji, _ = _tiny()
    part = network.build_indegree_partition(src, spec.is_inh(), S, je, ji,
                                            SP.delay_steps)
    per = part.per_shard
    assert part.store.multapses
    got = {}
    for lists, w in ((part.store, part.store.weights),
                     (part.plastic, part.plastic_weights)):
        for s in range(S):
            for gsrc in range(S * per):
                lo, hi = lists.row_ptr[s, gsrc], lists.row_ptr[s, gsrc + 1]
                tg = lists.targets[lo:hi]
                assert bool((tg[1:] >= tg[:-1]).all())
                for x, wx in zip(tg.tolist(), w[lo:hi].tolist()):
                    got.setdefault(s * per + x, []).append((gsrc, wx))
    inh = spec.is_inh()
    for i in range(spec.n_neurons):
        want = sorted(src[i].tolist())
        assert sorted(g for g, _ in got[i]) == want
        for g, wx in got[i]:
            assert wx == pytest.approx(ji if inh[g] else je, rel=1e-6)
    assert int(part.plastic.targets.numel()) == int(
        (~torch.from_numpy(inh))[src[:spec.n_exc].long()].sum())


@pytest.mark.parametrize("transport", ["torus3d", "alltoall"])
def test_port_matches_the_reference_bit_for_bit(transport):
    """Three segments of 8 windows with plasticity on: every WindowStats
    field and the end carry (alpha state, rings, plastic weights, traces,
    archive, counters) equal to the reference's, bit for bit, from the
    same start; facilitations and depressions happen."""
    spec, src, je, ji, g = _tiny()
    part = network.build_indegree_partition(src, spec.is_inh(), S, je, ji,
                                            SP.delay_steps)
    cfg = _cfg(part, transport)
    per = part.per_shard
    rate = np.full(spec.n_neurons, spec.drive_rate_hz(), np.float32)
    init, run_segment, _ = sim.build_sharded_segments(
        cfg, part, rate, je / 20.0, device="cpu", stdp=SP)
    v0 = torch.randn((S, per), generator=g) * 7.2 + 5.7
    c = init(5)
    c = c._replace(state=c.state._replace(
        neuron=c.state.neuron._replace(v=v0.clone()), generator=None))
    net = rstdp.partition(src, torch.from_numpy(spec.is_inh()), S, je, ji,
                          15)
    fields = {k: getattr(cfg, k) for k in (
        "n_shards", "window", "ring_len", "e_max", "capacity", "residue",
        "transport", "torus_nx", "torus_ny", "torus_nz", "link_credits",
        "notify_latency", "wire_format", "step_us")}
    ref = rstdp.StdpWindow(fields, net, rstdp.AlphaParams(*P),
                           rstdp.StdpParams(*SP))
    tally = compare.Tally()
    r = ref.init(v0)
    tally.tree(c, r)
    from gpubench.kinds import hpc_stdp
    lam = (torch.full((8, 8, S, per), spec.drive_rate_hz() * 1e-4))
    for k in range(3):
        drive = torch.poisson(lam, generator=g) * (je / 20.0)
        start = hpc_stdp.to_reference(c)
        c, st = run_segment(c, 8, drive=drive)
        r, rows = ref.segment(start, drive)
        for i in range(8):
            tally.tree(compare.window_of(st, i), rows[i])
        tally.tree(c, r)
    assert tally.mismatched == 0 and tally.float_gap == 0.0
    counts = c.plastic.counts.sum(0).tolist()
    assert counts[0] > 0 and counts[1] > 0 and counts[3] == 0
    assert not torch.equal(c.plastic.weights, part.plastic_weights)


def test_exponential_form_and_static_delivery_unchanged():
    """The exponential neuron's carry types keep their fields (the
    benchmark's dense and sparse kinds unpack them); a store without
    multapses delivers the same through either instance."""
    assert lif.LIFState._fields == ("v", "i_exc", "i_inh", "refrac")
    assert sim.ShardState._fields == ("neuron", "ring_exc", "ring_inh", "t",
                                      "generator")
    assert sim.SimCarry._fields[:4] == ("state", "pending", "link", "ring")
    g = torch.Generator().manual_seed(9)
    per, n = 40, S * 40
    key = torch.unique(torch.randint(0, n * n, (3000,), generator=g))
    sp = network.build_sparse_partition(
        (key // n).int(), (key % n).int(),
        torch.randn(key.numel(), generator=g) * 80,
        (torch.rand(n, generator=g) < 0.2).numpy(), S)
    assert not sp.store.multapses
    inh = torch.from_numpy(sp.is_inh)
    words = ev.pack(torch.randint(0, per + 2, (S, S, 16), generator=g),
                    (100 + torch.randint(-3, 20, (S, S, 16), generator=g)))
    counts = torch.randint(0, 17, (S, S), generator=g).to(torch.int32)
    out = []
    for store in (sp.store, network.MultapseStore(*sp.store)):
        rings = [torch.zeros((32, S, per)) for _ in range(2)]
        miss = sd.synapse_deliver(*rings, words, counts, 100, store, inh,
                                  per)
        out.append((rings, miss))
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    assert torch.equal(out[0][1], out[1][1])


def _archive(per, H, t, g, dev):
    """A plausible archive at step t: counts 0-400 (some past H), steps
    ascending to before t, K- in [1, 4)."""
    count = torch.randint(0, 400, (S, per), generator=g).to(torch.int32)
    gaps = torch.randint(1, 60, (S, per, 400), generator=g)
    ends = t - 1 - torch.randint(0, 40, (S, per, 1), generator=g)
    back = torch.flip(torch.cumsum(gaps, -1), [-1]) - gaps[..., -1:]
    k = torch.arange(400)
    # the n-th spike (n < count) at ends - back[count - 1 - n]
    n_idx = torch.clamp(count[..., None] - 1 - k, min=0)
    steps_by_n = ends - torch.gather(torch.flip(back, [-1]), -1, n_idx)
    step = torch.zeros((S, per, H), dtype=torch.int32)
    for n in range(max(0, 400 - H), 400):
        sel = n < count
        slot = n % H
        step[..., slot] = torch.where(sel, steps_by_n[..., n].int(),
                                      step[..., slot])
    km = 1 + 3 * torch.rand((S, per, H), generator=g)
    return lif.PostArchive(step.to(dev), km.to(dev), count.to(dev))


@pytest.mark.card
def test_alpha_window_kernel_matches_plain_on_the_card():
    """On the card: kernel C's alpha form against its plain version at the
    cell's shape (8 x 11,250 neurons, 8 steps, ring 32), with and without
    the archive, by value and through the step pointer, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the alpha window has no CPU build")
    from repro_torch.kernels import dispatch
    g = torch.Generator().manual_seed(21)
    per, H, t = 11250, 256, 4000
    st = lif.AlphaState(torch.randn((S, per), generator=g) * 8 + 10,
                        *(torch.randn((S, per), generator=g) * 50
                          for _ in range(4)),
                        torch.randint(0, 3, (S, per), generator=g).to(
                            torch.int32))
    rings = [torch.randn((32, S, per), generator=g) * 100 for _ in range(2)]
    drive = torch.poisson(torch.full((8, S, per), 2.0), generator=g) * 45.6
    minus = lif.decay_table(0.1, 30.0)
    for with_archive in (False, True):
        for by_pointer in (False, True):
            ar = _archive(per, H, t, g, "cpu") if with_archive else None
            card_ar = None if ar is None else lif.PostArchive(
                *(x.cuda() for x in ar))          # before the plain run
            cpu = [r.clone() for r in rings]
            want, wsp = kl.lif_alpha_window(st, P, *cpu, t, drive,
                                            archive=ar, minus_table=minus)
            card = [r.cuda() for r in rings]
            t0 = torch.tensor([t], dtype=torch.int32, device="cuda") \
                if by_pointer else t
            dispatch.reset_launches()
            got, gsp = kl.lif_alpha_window(
                lif.AlphaState(*(x.cuda() for x in st)), P, *card, t0,
                drive.cuda(), archive=card_ar,
                minus_table=None if ar is None else minus.cuda())
            assert dispatch.LAUNCHES == {"lif_alpha": 1}
            assert torch.equal(gsp.cpu(), wsp)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
            for a, b in zip(card, cpu):
                assert torch.equal(a.cpu(), b)
            if ar is not None:
                for a, b in zip(card_ar, ar):
                    assert torch.equal(a.cpu(), b)


@pytest.mark.card
def test_plastic_delivery_kernel_matches_plain_on_the_card():
    """On the card: kernel S's plastic form (plan, update, walk) after its
    multapse walk against the plain versions at the cell's load (the
    scale-8 network drawn on the card, 124-event rows from 8 shards,
    repeated sources, missed events, archives past H), bit for bit:
    rings, misses, weights, traces, counters; then a second window on
    the state the first left."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel S has no CPU build")
    from repro_torch.kernels import dispatch
    spec = hb.HpcSpec(scale=8)
    gen = torch.Generator(device="cuda").manual_seed(5)
    src = spec.draw_sources(gen)
    part = network.build_indegree_partition(
        src, spec.is_inh(), S, spec.je_pa, spec.ji_pa, SP.delay_steps)
    del src
    per, C, L = part.per_shard, 124, 32
    g = torch.Generator().manual_seed(17)
    store = part.store
    lists = part.plastic
    inh = torch.from_numpy(part.is_inh).cuda()
    tables = tuple(lif.decay_table(0.1, tau, "cuda")
                   for tau in (SP.tau_plus, SP.tau_minus))
    state = stdp.init_plastic(part.plastic_weights, S, per, SP)
    state = state._replace(
        archive=lif.PostArchive(*(x.cuda() for x in _archive(
            per, SP.history, 4000, g, "cpu"))),
        kplus=torch.rand(state.kplus.shape, device="cuda") * 3,
        t_last=torch.randint(-1, 3990, state.t_last.shape,
                             device="cuda").to(torch.int32))
    plain_state = stdp.clone(state)
    for t in (4000, 4008):
        addr = torch.randint(0, per, (S, S, C), generator=g)
        addr[:, :, ::7] = addr[:, :, :1]                  # repeated sources
        ts = (t + torch.randint(-2, 16, (S, S, C), generator=g)) & ev.TS_MASK
        words = ev.pack(addr, ts).cuda()
        counts = torch.randint(60, C + 1, (S, S), generator=g).to(
            torch.int32).cuda()
        rings = [torch.randn((L, S, per), generator=g).cuda()
                 for _ in range(2)]
        plain = [r.clone() for r in rings]
        dispatch.reset_launches()
        miss_k = sd.synapse_deliver(*rings, words, counts, t, store, inh,
                                    per)
        sd.stdp_deliver(*rings, words, counts, t, lists, state, inh, per,
                        SP, tables)
        assert dispatch.LAUNCHES == {"synapse_deliver": 1, "stdp_deliver": 1}
        miss_p = sd.synapse_deliver_plain(*plain, words, counts, t, store,
                                          inh, per)
        sd.stdp_deliver_plain(*plain, words, counts, t, lists, plain_state,
                              inh, per, SP, tables)
        assert torch.equal(miss_k, miss_p)
        for a, b in zip(rings, plain):
            assert torch.equal(a, b), t
        for name, a, b in zip(stdp.PlasticState._fields, state,
                              plain_state):
            if name == "archive":
                continue
            assert torch.equal(a, b), (name, t)
        c = state.counts.sum(0).tolist()
        assert c[0] > 1e6 and c[1] > 0 and c[3] > 0
