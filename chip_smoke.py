"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc`` under ``$CUDA_HOME``, default ``/usr/local/cuda``):

    python3 chip_smoke.py

Phases, each raising on failure (exit code != 0, no result line):

1. device  -- the card's name and power limit, as nvidia-smi reports them;
2. build   -- the kernel library from ``src/repro_torch/csrc`` (sm_90a);
3. kernels -- each hand-written kernel against its plain PyTorch version on
   the card, at the main path's full-width shapes and on edge cases, bit
   for bit; median times (CUDA events) of the kernel and the plain version;
4. slice   -- a small microcircuit (scale 0.004, 4 shards, 8 windows) on
   the card against the same run of the plain versions on the CPU, with
   the same initial potentials and background drive;
5. main path -- the Potjans-Diesmann microcircuit at scale 0.2 (15,431
   neurons, the largest round scale whose addresses fit the 14-bit event
   field) on 4 wafer shards, transport alltoall, wire format extoll, for
   25 windows (20 ms biological) with launch counts, deadline, residue and
   link-conservation checks, and the summary of
   ``examples/multiwafer_microcircuit.py``; then a torch.profiler pass
   over 5 more windows for the device busy share;
6. the ``kernels`` lines (a summary, then one JSON object) and, last, the
   device JSON line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
FP32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores

SCALE = 0.2
N_SHARDS = 4
N_WINDOWS = 25


def banner(title: str) -> None:
    print(f"\n== {title}", flush=True)


def time_ms(fn, calls: int = 10, reps: int = 20) -> tuple[float, float]:
    """(device ms, eager ms) per call of ``fn``, medians over ``reps``.

    Device time: ``calls`` calls captured in one CUDA graph and replayed,
    CUDA events around each replay, so the host's launch overhead is not
    in it.  Eager time: events around ``calls`` back-to-back calls from
    Python, which for a microsecond kernel measures the host.
    """
    def per_call(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    def eager():
        for _ in range(calls):
            fn()

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    eager_ms = statistics.median(per_call(eager) for _ in range(reps))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    graph.replay()
    torch.cuda.synchronize()
    device_ms = statistics.median(per_call(graph.replay)
                                  for _ in range(reps))
    return device_ms, eager_ms


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        if a.dtype == torch.bool:
            a, b = a.to(torch.int32), b.to(torch.int32)
        d = (a.to(torch.float64) - b.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def require_equal(what: str, pairs) -> None:
    for i, (a, b) in enumerate(pairs):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 f"version (shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}, max abs err "
                                 f"{max_abs_err([(a, b)])})")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _words(gen, shape, n_addr=1 << 14, p_valid=0.9):
    from repro_torch.core import events as ev
    dev = gen.device
    addr = torch.randint(0, n_addr, shape, generator=gen, device=dev)
    ts = torch.randint(0, 1 << 15, shape, generator=gen, device=dev)
    valid = torch.rand(shape, generator=gen, device=dev) < p_valid
    return ev.pack(addr, ts, valid=valid)


def check_placement(gen, cfg, n_lut):
    """Kernel A at the main path's shapes (S windows of residue + e_max *
    max_fan events, D = S destinations, C = capacity), then ragged edge
    cases; both variants; plus the whole fused window on the card against
    the CPU."""
    from repro_torch.kernels import fused_route_bucket as frb
    dev = gen.device

    def operands(b, n, d, c, routed, biased):
        words = _words(gen, (b, n))
        if biased:      # most traffic to destination 0: its row overflows
            probs = torch.tensor([0.05, 0.45, 0.25, 0.15, 0.05, 0.05][:d + 2],
                                 device=dev)
            dest = torch.multinomial(probs.expand(b, -1).contiguous(), n,
                                     True, generator=gen) - 1
        else:
            dest = torch.randint(-1, d + 1, (b, n), generator=gen, device=dev)
        dest = dest.to(torch.int32)          # -1 and d are out of range
        if routed:
            lut = torch.randint(-5, 1 << 20, (b, n_lut if biased else 96),
                                generator=gen, device=dev,
                                dtype=torch.int32)
            skey, swords = frb.sort_by_destination(words, dest, d)
            return frb.placement_operands(skey, swords, lut, d, c,
                                          routed=True)
        meta = torch.randint(-2**31, 2**31 - 1, (b, n), generator=gen,
                             device=dev, dtype=torch.int32)
        skey, swords, smeta = frb.sort_by_destination(words, dest, d, meta)
        return frb.placement_operands(skey, swords, smeta, d, c,
                                      routed=False)

    S, C = cfg.n_shards, cfg.capacity
    n_main = cfg.residue + cfg.e_max * cfg.max_fan
    err = 0.0
    cases = [(S, n_main, S, C, True), (3, 1000, 7, 33, False),
             (2, 63, 7, 1, False), (1, 257, 13, 19, False),
             (5, 300, 4, 16, False)]
    for routed in (False, True):
        for b, n, d, c, biased in cases:
            ops = operands(b, n, d, c, routed, biased)
            got = frb.placement(*ops, c, routed=routed)
            want = frb.placement_plain(*ops, c, routed=routed)
            require_equal(f"placement routed={routed} {(b, n, d, c)}",
                          list(zip(got, want)))
            err = max(err, max_abs_err(zip(got, want)))
            if biased and int(ops[1].max()) <= c:
                raise AssertionError("placement: no overflowing row tested")
    # the whole fused window (sort + kernel) on the card vs the CPU
    words = _words(gen, (S, n_main))
    probs = torch.tensor([1, 8, 2, 1, 1, 1.0], device=dev)
    dest = (torch.multinomial(probs.expand(S, -1).contiguous(), n_main, True,
                              generator=gen) - 1).to(torch.int32)
    meta = torch.randint(-2**31, 2**31 - 1, (S, n_main), generator=gen,
                         device=dev, dtype=torch.int32)
    fw_gpu = frb.fused_aggregate(words, dest, meta, S, C,
                                 residue_len=cfg.residue,
                                 with_residue_meta=True)
    fw_cpu = frb.fused_aggregate(words.cpu(), dest.cpu(), meta.cpu(), S, C,
                                 residue_len=cfg.residue,
                                 with_residue_meta=True)
    require_equal("fused_aggregate card vs CPU", [
        (a.cpu(), b) for a, b in zip(
            list(fw_gpu.buckets) + list(fw_gpu[1:]),
            list(fw_cpu.buckets) + list(fw_cpu[1:]))])

    ops = operands(S, n_main, S, C, False, True)
    first, counts, swords_pad, aux = ops
    ms, eager_ms = time_ms(lambda: frb.placement(*ops, C, routed=False))
    plain_ms, plain_eager_ms = time_ms(
        lambda: frb.placement_plain(*ops, C, routed=False))
    live = int(torch.clamp(counts, max=C).sum())
    n_bytes = first.numel() * 8 + live * 8 + first.numel() * C * 8
    bms, by = bound_ms(n_bytes, first.numel() * C * 4)
    return dict(name="placement", route="cuda",
                source="src/repro_torch/csrc/placement.cu",
                replaces="src/repro/kernels/fused_route_bucket.py:122",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms,
                parity="bit-exact (both variants, 5 shapes)")


def check_codec(gen, cfg):
    """Kernel B on one exchange's (S, S, C) words: encode, then decode of
    the payload columns of the packed (S, S, 2C + 1) buffer."""
    from repro_torch.core import events as ev
    from repro_torch.transport import base as tb
    from repro_torch.wire import codec
    dev = gen.device
    S, C = cfg.n_shards, cfg.capacity
    shape = (S, S, C)
    words = _words(gen, shape)
    meta = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev,
                         dtype=torch.int32)
    flat_w, flat_m = words.view(-1), meta.view(-1)
    flat_m[:4] = torch.tensor([-1, 2**31 - 1, -2**31, 0], device=dev)
    flat_w[:4] = ev.pack(torch.full((4,), ev.ADDR_MASK, device=dev),
                         torch.full((4,), ev.TS_MASK, device=dev))
    flat_w[4] = 0                                        # INVALID word
    err = 0.0
    for fmt in (codec.DEFAULT_WORD, codec.WireWordFormat(16, 14, 20),
                codec.WireWordFormat(15, 14, 0)):
        buf = codec.encode_planar(words, meta, fmt)
        want = torch.cat(codec.encode_plain(words, meta, fmt), dim=-1)
        require_equal(f"wire encode {tuple(fmt)}", [(buf, want)])
        counts = torch.randint(0, C, (S, S), generator=gen, device=dev,
                               dtype=torch.int32)
        rows, _ = tb.unpack_payload(tb.pack_payload(buf, counts))
        got = codec.decode_planar(rows, fmt)
        want = codec.decode_plain(rows[..., :C], rows[..., C:], fmt)
        require_equal(f"wire decode {tuple(fmt)}", list(zip(got, want)))
        err = max(err, max_abs_err(zip(got, want)))
        if fmt == codec.DEFAULT_WORD:
            require_equal("wire round trip", [(got[0], words),
                                              (got[1], meta)])
    ms, eager_ms = time_ms(lambda: codec.decode_planar(
        codec.encode_planar(words, meta)))
    plain_ms, plain_eager_ms = time_ms(lambda: codec.decode_plain(
        *codec.encode_plain(words, meta)))
    n = words.numel()
    bms, by = bound_ms(2 * n * 16, 2 * n * 20)
    return dict(name="wire_codec", route="cuda",
                source="src/repro_torch/csrc/wire_codec.cu",
                replaces="src/repro/wire/codec.py:172",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms,
                parity="bit-exact (encode+decode, 3 formats)")


def check_lif(gen, cfg):
    """Kernel C on the (S, per) neurons of the main path, 20 chained steps
    with refractory neurons and neurons at and near threshold."""
    from repro_torch.kernels import lif_step as ls
    from repro_torch.snn import lif
    dev = gen.device
    p = cfg.params
    shape = (cfg.n_shards, cfg.per_shard)
    u = lambda: torch.rand(shape, generator=gen, device=dev)
    state = lif.LIFState(
        v=p.e_l + (p.v_th - p.e_l + 2.0) * u(),
        i_exc=u() * 500.0, i_inh=-u() * 200.0,
        refrac=torch.randint(-1, 25, shape, generator=gen, device=dev,
                             dtype=torch.int32))
    state.v.view(-1)[:64] = p.v_th             # exactly at threshold
    err, spikes = 0.0, 0
    for step in range(20):
        exc, inh = u() * 2000.0, -u() * 300.0
        got_st, got_spk = ls.lif_step(state, p, exc, inh)
        want_st, want_spk = ls.lif_step_plain(state, p, exc, inh)
        pairs = list(zip(got_st, want_st)) + [(got_spk, want_spk)]
        require_equal(f"lif step {step}", pairs)
        err = max(err, max_abs_err(pairs))
        spikes += int(got_spk.sum())
        state = got_st
    if spikes == 0 or int((state.refrac > 0).sum()) == 0:
        raise AssertionError("lif: threshold or refractory path unexercised")
    exc, inh = u(), u()
    ms, eager_ms = time_ms(lambda: ls.lif_step(state, p, exc, inh))
    plain_ms, plain_eager_ms = time_ms(
        lambda: ls.lif_step_plain(state, p, exc, inh))
    n = state.v.numel()
    bms, by = bound_ms(n * (6 * 4 + 4 * 4 + 1), n * 15)
    return dict(name="lif_step", route="cuda",
                source="src/repro_torch/csrc/lif_step.cu",
                replaces="src/repro/kernels/lif_step.py:78",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms,
                parity=f"bit-exact (20 steps, {spikes} spikes)")


# ---------------------------------------------------------------------------
# Phases 4 and 5: the whole slice.
# ---------------------------------------------------------------------------

def sim_config(part, **kw):
    from repro_torch.configs import brainscales
    from repro_torch.snn import simulator as sim
    return sim.SimConfig(n_shards=part.n_shards, per_shard=part.per_shard,
                         max_fan=part.fanout.shape[1], window=8, ring_len=32,
                         **kw, **brainscales.CONFIG.transport_fields())


def check_slice_small():
    """Card vs CPU for the whole window loop at a small size, with the same
    initial potentials and drive: integer stats exact, floats within the
    LIF tolerances (sums over events run in another order)."""
    from repro_torch.snn import microcircuit as mc, network
    from repro_torch.snn import simulator as sim
    spec = mc.MicrocircuitSpec(scale=0.004)
    part = network.build_partition(*spec.weight_matrix(), n_shards=N_SHARDS)
    cfg = sim_config(part, e_max=256, capacity=4, residue=64)
    n_win = 8
    rng = np.random.default_rng(0)
    drive = torch.from_numpy(rng.poisson(
        1.3, (n_win, cfg.window, N_SHARDS, cfg.per_shard)).astype(
            np.float32) * np.float32(87.8))
    out = {}
    for device in ("cpu", "cuda"):
        init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                          device=device)
        st = init(0)
        if device == "cpu":
            v0 = st.neuron.v
        st = st._replace(neuron=st.neuron._replace(v=v0.to(device)),
                         generator=None)
        out[device] = run(st, n_win, drive=drive)
    from repro_torch.convert import flatten
    s_cpu, s_gpu = flatten(out["cpu"][1]), flatten(out["cuda"][1])
    for key, a in s_cpu.items():
        b = s_gpu[key]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        elif not (a == b).all():
            raise AssertionError(f"slice card vs CPU: {key} differs")
    st_cpu, st_gpu = out["cpu"][0], out["cuda"][0]
    np.testing.assert_allclose(st_gpu.neuron.v.cpu(), st_cpu.neuron.v,
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(st_gpu.ring_exc.cpu(), st_cpu.ring_exc,
                               rtol=1e-5, atol=1e-3)
    if not torch.equal(st_gpu.neuron.refrac.cpu(), st_cpu.neuron.refrac):
        raise AssertionError("slice card vs CPU: refrac differs")
    spikes = int(s_cpu["spikes"].sum())
    deferred = int(s_cpu["deferred"].sum())
    if spikes == 0 or deferred == 0:
        raise AssertionError("slice check: no spikes or no residue traffic")
    print(f"slice check (scale 0.004, {n_win} windows): card == CPU on every "
          f"integer stat; {spikes} spikes, {deferred} deferred events")


def run_main_path():
    from repro_torch.core import aggregator, events as ev
    from repro_torch.kernels import dispatch
    from repro_torch.snn import microcircuit as mc, network
    from repro_torch.snn import simulator as sim
    from repro_torch.wire import get_profile

    t0 = time.perf_counter()
    spec = mc.MicrocircuitSpec(scale=SCALE)
    w, is_inh = spec.weight_matrix()
    print(f"microcircuit: {spec.n_neurons} neurons, {int((w != 0).sum())} "
          f"synapses (scale={spec.scale})")
    part = network.build_partition(w, is_inh, n_shards=N_SHARDS)
    del w
    print(f"partition: {N_SHARDS} wafer shards x {part.per_shard} neurons, "
          f"max fan-out {part.fanout.shape[1]} shards/source")
    if part.per_shard * part.fanout.shape[1] > ev.ADDR_MASK + 1:
        raise AssertionError("event addresses exceed the 14-bit field")
    cfg = sim_config(part, e_max=1024, capacity=1024, residue=256)
    init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                      device="cuda")
    state = init(seed=0)
    run(state, 1)                     # warm-up (library handles, caches)
    torch.cuda.synchronize()
    print(f"set-up (network on the host, upload, warm-up): "
          f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, stats = run(state, N_WINDOWS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(dispatch.LAUNCHES)

    s = {k: v.cpu().numpy() for k, v in (
        ("spikes", stats.spikes), ("sent", stats.events_sent),
        ("wire", stats.wire_bytes), ("miss", stats.deadline_miss),
        ("ovf", stats.overflow), ("off", stats.offered),
        ("defr", stats.deferred))}
    link = {k: getattr(stats.link, k).cpu().numpy() for k in (
        "offered_events", "sent_events", "delivered_events",
        "bytes_on_wire")}
    bio_ms = N_WINDOWS * cfg.window * cfg.params.dt
    total_spikes = int(s["spikes"].sum())
    sent, wire_b = int(s["sent"].sum()), int(s["wire"].sum())
    print(f"\nsimulated {bio_ms:.1f} ms: {total_spikes} spikes, mean rate "
          f"{total_spikes / (spec.n_neurons * bio_ms * 1e-3):.1f} Hz")
    print(f"events shipped (incl. fan-out replicas): {sent}")
    print(f"Extoll wire bytes: {wire_b} ({wire_b / max(sent, 1):.1f} "
          f"B/event effective)")
    naive = int(aggregator.unaggregated_cost(sent).bytes)
    print(f"without aggregation: {naive} bytes -> bucket aggregation saves "
          f"{naive / max(wire_b, 1):.1f}x")
    print(f"deadline misses: {int(s['miss'].sum())}   bucket overflows: "
          f"{int(s['ovf'].sum())}")
    fmt = get_profile(cfg.wire_format)
    lat = stats.latency
    p50 = float(lat.p50_us[:, 1:].mean())
    print(f"wire profile '{fmt.name}': {int(link['bytes_on_wire'].sum())} "
          f"bytes on wire (frame-exact; {fmt.header_bytes + fmt.crc_bytes} "
          f"B/frame tax, {fmt.gap_bytes} B gap, {fmt.cell_bytes} B cells)")
    print(f"event latency: p50 {p50:.2f} us (mean over windows), p99 "
          f"{float(lat.p99_us.max()):.2f} us, max "
          f"{float(lat.max_us.max()):.2f} us")
    ms_window = wall * 1e3 / N_WINDOWS
    print(f"{N_WINDOWS} windows in {wall * 1e3:.1f} ms: {ms_window:.3f} ms "
          f"per window, {ms_window / (cfg.window * cfg.params.dt):.2f}x "
          f"slower than biological time; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # --- checks ---------------------------------------------------------
    if total_spikes <= 0:
        raise AssertionError("network is silent")
    if int(s["miss"].sum()) != 0:
        raise AssertionError("deadline misses on the main path")
    if not np.isfinite(state.neuron.v.cpu().numpy()).all():
        raise AssertionError("non-finite membrane potentials")
    off, snt, defr, drop = s["off"], s["sent"], s["defr"], s["ovf"]
    if not (off == snt + defr + drop).all():
        raise AssertionError("residue identity: offered != sent + deferred "
                             "+ dropped")
    new = off - np.concatenate([np.zeros((N_SHARDS, 1), off.dtype),
                                defr[:, :-1]], axis=1)
    if not ((new >= 0).all() and (new.sum(1) == snt.sum(1) + drop.sum(1)
                                  + defr[:, -1]).all()):
        raise AssertionError("residue identity across windows broken")
    if not (link["offered_events"] == link["sent_events"]).all():
        raise AssertionError("link conservation: offered != sent")
    if not (link["sent_events"].sum(0) == link["delivered_events"].sum(0)
            ).all():
        raise AssertionError("link conservation: sum(sent) != sum(delivered)")
    want = {"placement": N_WINDOWS, "wire_codec": 2 * (N_WINDOWS + 1),
            "lif_step": cfg.window * N_WINDOWS}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    print(f"launches on the main path: {launches}")
    profile_windows(run, state, 5)
    return launches


def profile_windows(run, state, n_windows: int) -> None:
    """Device busy share and the costliest device functions over a few
    windows (torch.profiler); prints "not measured" when the profiler sees
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state, n_windows)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():   # device-side rows only: kernels, copies
        if e.device_type == DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("profile: device time not measured (no device activity seen)")
        return
    launches = sum(r[1] for r in rows)
    print(f"profile of {n_windows} windows + drain: wall {wall_us:.0f} us, "
          f"device busy {busy:.0f} us ({100 * busy / wall_us:.1f}%), "
          f"{launches} device functions ({launches / (n_windows + 1):.0f} "
          f"per window)")
    for dev, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev:9.1f} us {count:5d}x  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from repro_torch.kernels import _build

    banner("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    # f32 products on the main path stay IEEE f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    banner("build")
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"kernel library {path.name} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    from repro_torch.snn import lif
    from repro_torch.snn import simulator as sim
    gen = torch.Generator(device="cuda").manual_seed(1234)
    per = -(-15431 // N_SHARDS)
    cfg = sim.SimConfig(n_shards=N_SHARDS, per_shard=per, max_fan=4,
                        e_max=1024, capacity=1024, residue=256,
                        params=lif.LIFParams())

    banner("kernels against their plain versions")
    records = [check_placement(gen, cfg, per * cfg.max_fan),
               check_codec(gen, cfg), check_lif(gen, cfg)]
    for r in records:
        print(f"{r['name']}: {r['parity']}; device time per call (CUDA "
              f"graph): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}); eager "
              f"call from Python: kernel {r['eager_ms']:.4f} ms, plain "
              f"{r['plain_eager_ms']:.4f} ms")

    banner("whole slice, card vs CPU")
    check_slice_small()

    banner("main path")
    launches = run_main_path()

    for r in records:
        r["launches"] = launches[r["name"]]
    print("\nkernels: " + ", ".join(
        f"{r['name']} launches={r['launches']} parity={r['parity']}"
        for r in records))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
