"""Port vs reference for the cycle-level models, on the CPU (where kernel
G's wrappers run their plain versions):

* ``core.bucket``: ``run_trace`` bit for bit against
  ``repro.core.bucket.run_trace`` on every ``CycleOut`` field of every
  cycle and every field of the final ``BucketState``, on the
  configurations of ``tests/test_core.py``'s bucket tests, the clipped
  append (E = 2, capacity 16: ``fill`` reaches capacity + 1), renaming
  pressure (2 buckets, 32 destinations), all-urgent deadlines, invalid
  words and ``dest = -1``, and timestamps wrapping the 15-bit ring;
  ``cycle`` step by step with and without ``force_flush``;
* ``core.flow_control``'s ring model: ``run`` with the producer's wishes
  injected from the reference's own ``jax.random`` draws, every
  ``RingState`` field and the ``RunStats`` sums, latencies 1-16, batches
  1 / 4 / 16; the zero-length delay line raises as the reference's does.

Traces are made with numpy from a seed; the reference runs jitted and
vmapped over a batch of traces, so each configuration compiles once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucket as r_bk
from repro.core import flow_control as r_fc
from repro_torch.core import bucket as bk
from repro_torch.core import events as ev
from repro_torch.core import flow_control as fc
from repro_torch.kernels import cycle_models

TS_MASK = (1 << 15) - 1
VALID = 1 << 29


def _pack(addr, ts, valid=True):
    w = ((np.asarray(addr, np.int64) & ((1 << 14) - 1)) << 15) | \
        (np.asarray(ts, np.int64) & TS_MASK)
    w = np.where(valid, w | VALID, 0)
    return w.astype(np.uint32)


def _trace(seed, T, E, n_dest, *, rate=1.0, ts_base=100, ts_spread=50,
           dest_lo=0):
    """The shape of ``tests/test_core.py:_trace``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, 1 << 12, (T, E))
    ts = np.arange(T)[:, None] + ts_base + rng.integers(0, ts_spread, (T, E))
    valid = rng.random((T, E)) < rate
    dests = rng.integers(dest_lo, n_dest, (T, E)).astype(np.int32)
    return _pack(addr, ts, valid), dests


def _ref_runs(cfg, traces):
    """The reference's run_trace over a batch of (words, dests), one jit."""
    fn = jax.jit(jax.vmap(lambda w, d: r_bk.run_trace(cfg, w, d)))
    words = jnp.asarray(np.stack([w for w, _ in traces]))
    dests = jnp.asarray(np.stack([d for _, d in traces]))
    st, out = fn(words, dests)
    to_np = lambda tree: {k: np.asarray(v) for k, v in tree._asdict().items()}
    st, out = to_np(st), to_np(out)
    return [({k: v[i] for k, v in st.items()},
             {k: v[i] for k, v in out.items()}) for i in range(len(traces))]


def _as_i32(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def _hold(cfg, traces):
    """Port run_trace == reference run_trace on every field; returns the
    port's outputs."""
    outs = []
    for (words, dests), (r_st, r_out) in zip(traces, _ref_runs(cfg, traces)):
        st, out = bk.run_trace(cfg, torch.from_numpy(words.view(np.int32)),
                               torch.from_numpy(dests))
        for name, want in r_out.items():
            got = getattr(out, name).numpy()
            np.testing.assert_array_equal(got, _as_i32(want), err_msg=name)
        for name, want in r_st.items():
            got = getattr(st, name).numpy()
            np.testing.assert_array_equal(got, _as_i32(want), err_msg=name)
        outs.append((st, out))
    return outs


@pytest.mark.parametrize("n_buckets,n_dest", [(4, 4), (4, 16), (8, 64)])
def test_run_trace_conservation_configs(n_buckets, n_dest):
    cfg = bk.BucketConfig(n_buckets=n_buckets, capacity=16, n_dest=n_dest,
                          flush_margin=8)
    outs = _hold(cfg, [_trace(s, 80, 2, n_dest) for s in range(3)])
    for (st, out), (words, _) in zip(outs, [_trace(s, 80, 2, n_dest)
                                            for s in range(3)]):
        n_in = int((words & VALID != 0).sum())
        assert int(out.sent_count.sum() + st.q_count.sum() + st.fill.sum()
                   + out.stalled.sum()) == n_in


def test_run_trace_renaming_pressure():
    """2 buckets against 32 destinations (and the test_core config)."""
    cfg = bk.BucketConfig(n_buckets=2, capacity=8, n_dest=32, flush_margin=4)
    outs = _hold(cfg, [_trace(s, 60, 1, 32) for s in range(4)])
    assert sum(int(o.stalled.sum()) for _, o in outs) > 0
    assert all(int((o.sent_dest >= 0).sum()) > 10 for _, o in outs)


def test_run_trace_sent_events_match_destination():
    cfg = bk.BucketConfig(n_buckets=4, capacity=8, n_dest=8, flush_margin=8)
    rng = np.random.default_rng(3)
    addr = rng.integers(0, 64, (50, 2))
    ts = np.broadcast_to((np.arange(50)[:, None] + 60) & TS_MASK, (50, 2))
    _hold(cfg, [(_pack(addr, ts), (addr % 8).astype(np.int32))])


def test_run_trace_paper_claims():
    """The two §3.1 configurations of test_core: un-aggregated single
    events (already-urgent deadlines, one destination each) and one
    aggregated stream."""
    single = bk.BucketConfig(n_buckets=8, capacity=124, n_dest=256,
                             flush_margin=10_000)
    addr = np.arange(400).reshape(400, 1) % 256
    (st, out), = _hold(single, [(_pack(addr, np.ones((400, 1))),
                                 addr.astype(np.int32))])
    assert 0.3 <= int(out.sent_count.sum()) / 400 <= 0.55
    agg = bk.BucketConfig(n_buckets=4, capacity=124, n_dest=4,
                          flush_margin=4, queue=8)
    ts = (np.arange(600).reshape(600, 1) + 200) & TS_MASK
    (st, out), = _hold(agg, [(_pack(np.zeros((600, 1)), ts),
                              np.zeros((600, 1), np.int32))])
    assert int(out.stalled.sum()) == 0
    assert int(out.sent_count.sum() + st.q_count.sum() + st.fill.sum()) == 600


def test_run_trace_clipped_append():
    """E = 2, capacity 16, two destinations, relaxed deadlines: a second
    arrival to a bucket that just filled overwrites its last slot, so
    ``fill`` and the queued / sent counts reach capacity + 1 (a caveat of
    the reference, reproduced bit for bit)."""
    cfg = bk.BucketConfig(n_buckets=4, capacity=16, n_dest=2, flush_margin=2,
                          queue=4)
    traces = [_trace(s, 120, 2, 2, ts_base=3000, ts_spread=4)
              for s in range(3)]
    outs = _hold(cfg, traces)
    assert max(int(o.sent_count.max()) for _, o in outs) == cfg.capacity + 1


def test_run_trace_all_urgent_deadlines():
    """Every event already past its deadline: deadline flushes every
    cycle, the port saturates, misses counted, the queue refuses steals."""
    cfg = bk.BucketConfig(n_buckets=4, capacity=32, n_dest=16,
                          flush_margin=16, queue=2)
    traces = []
    for s in range(3):
        rng = np.random.default_rng(10 + s)
        ts = np.arange(100)[:, None] - rng.integers(0, 40, (100, 3))
        traces.append((_pack(rng.integers(0, 4096, (100, 3)), ts),
                       rng.integers(0, 16, (100, 3)).astype(np.int32)))
    outs = _hold(cfg, traces)
    assert sum(int(o.deadline_miss.sum()) for _, o in outs) > 0
    assert sum(int(o.stalled.sum()) for _, o in outs) > 0


def test_run_trace_invalid_words_and_negative_dests():
    cfg = bk.BucketConfig(n_buckets=4, capacity=8, n_dest=8, flush_margin=8)
    traces = []
    for s in range(3):
        words, dests = _trace(20 + s, 70, 3, 12, rate=0.6, dest_lo=-3)
        traces.append((words, dests))          # dests >= n_dest are clipped
    outs = _hold(cfg, traces)
    for (st, out), (words, dests) in zip(outs, traces):
        live = ((words & VALID) != 0) & (dests >= 0)
        assert int(out.sent_count.sum() + st.q_count.sum() + st.fill.sum()
                   + out.stalled.sum()) == int(live.sum())


def test_run_trace_timestamps_wrap():
    """Timestamps crossing 2^15 - 1 -> 0 while the clock runs through the
    wrap: slack, ``ts_before`` and the miss count on the ring."""
    cfg = bk.BucketConfig(n_buckets=4, capacity=16, n_dest=8, flush_margin=6)
    traces = []
    for s in range(3):
        rng = np.random.default_rng(30 + s)
        ts = (TS_MASK - 40 + np.arange(90)[:, None]
              + rng.integers(-20, 30, (90, 2)))
        traces.append((_pack(rng.integers(0, 4096, (90, 2)), ts),
                       rng.integers(0, 8, (90, 2)).astype(np.int32)))
    _hold(cfg, traces)


def test_cycle_steps_with_force_flush():
    """``cycle`` one clock at a time, with the external trigger on some
    clocks, against the reference's ``cycle``; the input state is left
    as it was."""
    cfg = bk.BucketConfig(n_buckets=3, capacity=6, n_dest=10, flush_margin=3,
                          queue=2)
    words, dests = _trace(40, 30, 2, 10, rate=0.8)
    r_cycle = jax.jit(lambda s, w, d, f: r_bk.cycle(s, w, d, cfg, f))
    r_state = r_bk.init_state(cfg)
    state = bk.init_state(cfg, device="cpu")
    for t in range(30):
        force = t % 4 == 1
        r_state, r_out = r_cycle(r_state, jnp.asarray(words[t]),
                                 jnp.asarray(dests[t]), jnp.bool_(force))
        before = [x.clone() for x in state]
        new, out = bk.cycle(state, torch.from_numpy(words[t].view(np.int32)),
                            torch.from_numpy(dests[t]), cfg,
                            force_flush=force if t % 8 else None)
        assert all(torch.equal(a, b) for a, b in zip(before, state))
        if t % 8 == 0:      # force_flush=None: the reference ran force=False
            assert not force
        for name in r_bk.CycleOut._fields:
            np.testing.assert_array_equal(
                getattr(out, name).numpy(),
                _as_i32(getattr(r_out, name)), err_msg=f"{t} {name}")
        for name in r_bk.BucketState._fields:
            np.testing.assert_array_equal(
                getattr(new, name).numpy(),
                _as_i32(getattr(r_state, name)), err_msg=f"{t} {name}")
        state = new


def test_bucket_trace_operand_checks():
    cfg = bk.BucketConfig()
    w = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        cycle_models.bucket_trace(cfg, w.long(), w)
    with pytest.raises(ValueError, match="arrivals"):
        cycle_models.bucket_trace(cfg, torch.zeros((4, 33), dtype=torch.int32),
                                  torch.zeros((4, 33), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        cycle_models.bucket_trace(cfg, w, w[:, :1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bk.init_state(cfg)


# ---------------------------------------------------------------------------
# The ring-buffer model
# ---------------------------------------------------------------------------

RING_CASES = [  # (size, notify_latency, notify_batch, produce, consume)
    (2, 1, 1, 1.0, 1), (8, 1, 1, 0.6, 1), (4, 3, 1, 1.0, 1),
    (4, 8, 1, 1.0, 1), (32, 8, 1, 1.0, 1), (16, 16, 1, 0.8, 2),
    (64, 16, 1, 1.0, 1), (32, 8, 4, 1.0, 1), (32, 8, 16, 1.0, 1),
    (8, 5, 4, 0.7, 3), (24, 12, 16, 0.9, 1),
]
RING_STEPS = 300
RING_SEEDS = (0, 1, 2)


def _ref_want(steps, rate, seed):
    """The reference's own draws (``run``'s keys and ``uniform``)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)
    return np.asarray(jax.vmap(
        lambda k: (jax.random.uniform(k) < rate).astype(jnp.int32))(keys))


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_run_with_injected_draws(case):
    size, lat, batch, rate, crate = case
    cfg = fc.RingConfig(size=size, notify_latency=lat, notify_batch=batch)
    r_cfg = r_fc.RingConfig(size=size, notify_latency=lat,
                            notify_batch=batch)
    ref = jax.jit(jax.vmap(lambda sd: r_fc.run(r_cfg, RING_STEPS, rate,
                                               crate, sd)))
    r_st, r_stats = ref(jnp.asarray(RING_SEEDS))
    for i, seed in enumerate(RING_SEEDS):
        want = torch.from_numpy(np.array(_ref_want(RING_STEPS, rate, seed)))
        st, stats = fc.run(cfg, RING_STEPS, rate, crate, seed, want=want,
                           device="cpu")
        for name in r_fc.RingState._fields:
            np.testing.assert_array_equal(
                getattr(st, name).numpy(),
                _as_i32(np.asarray(getattr(r_st, name))[i]), err_msg=name)
        for name in r_fc.RunStats._fields:
            assert int(getattr(stats, name)) == \
                int(np.asarray(getattr(r_stats, name))[i]), name
        assert int(stats.produced) == int(stats.consumed) + \
            int(st.wr - st.rd)


def test_ring_run_full_rate_draws_do_not_matter():
    """At produce_rate 1 every step wants: the port's own draws give the
    reference's run (test_core's credit-limit configurations)."""
    for size, lat in ((32, 8), (4, 8)):
        st, stats = fc.run(fc.RingConfig(size=size, notify_latency=lat),
                           1000, device="cpu")
        r_st, r_stats = r_fc.run(r_fc.RingConfig(size=size,
                                                 notify_latency=lat), 1000)
        for name in r_fc.RunStats._fields:
            assert int(getattr(stats, name)) == int(getattr(r_stats, name))
        assert int(st.credits) == int(r_st.credits)
    a = fc.run(fc.RingConfig(), 200, 0.5, seed=4, device="cpu")[1]
    b = fc.run(fc.RingConfig(), 200, 0.5, seed=4, device="cpu")[1]
    assert [int(x) for x in a] == [int(x) for x in b]


def test_ring_steps_match_reference():
    """producer_step, consumer_step and tick one at a time."""
    cfg = fc.RingConfig(size=4, notify_latency=3, notify_batch=2)
    r_cfg = r_fc.RingConfig(size=4, notify_latency=3, notify_batch=2)
    st, r_st = fc.init_ring(cfg, device="cpu"), r_fc.init_ring(r_cfg)
    for t in range(12):
        want, rate = (t * 7) % 3 > 0, 1 + t % 2
        st, w = fc.producer_step(st, int(want), 5 + t, cfg)
        r_st, r_w = r_fc.producer_step(r_st, jnp.int32(want),
                                       jnp.uint32(5 + t), r_cfg)
        st, c = fc.consumer_step(st, rate, cfg)
        r_st, r_c = r_fc.consumer_step(r_st, jnp.int32(rate), r_cfg)
        st, r_st = fc.tick(st), r_fc.tick(r_st)
        assert (int(w), int(c)) == (int(r_w), int(r_c))
        for name in r_fc.RingState._fields:
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          _as_i32(getattr(r_st, name)))


def test_ring_zero_latency_raises_as_the_reference():
    with pytest.raises(IndexError):
        r_fc.run(r_fc.RingConfig(size=4, notify_latency=0), 10)
    with pytest.raises(IndexError):
        fc.run(fc.RingConfig(size=4, notify_latency=0), 10, device="cpu")
    st = fc.init_ring(fc.RingConfig(size=4, notify_latency=0), device="cpu")
    with pytest.raises(IndexError):
        fc.consumer_step(st, 1, fc.RingConfig(size=4, notify_latency=0))
    with pytest.raises(IndexError):
        fc.tick(st)
    with pytest.raises(ValueError, match="shape"):
        fc.run(fc.RingConfig(), 10, want=torch.ones(9, dtype=torch.int32),
               device="cpu")
    assert ev.TS_MASK == TS_MASK
