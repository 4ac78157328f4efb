"""The flush window (kernel A's stage in one launch) on the CPU, where
``flush_window`` runs its plain version.

* ``flush_window_plain`` against the reference's ``fused_aggregate`` /
  ``fused_route_aggregate`` with the Pallas placement in interpret mode,
  bit for bit on every ``FusedWindow`` field, and its payload against the
  reference's ``encode_planar`` of the reference's buckets (Pallas in
  interpret mode): n 0 and 1, C 1, D 13, residue 0, residue longer than
  the window, a residue shorter than the overflow, several overflowing
  destinations, all events to one destination, destinations -1 and D,
  words with the valid bit clear; three word formats and none; per-event
  destinations, the destination table with per-event meta (the
  simulator's call) and both tables (the exchange's);
* a batch equals its rows, with per-row and shared tables;
* a plain emulation of the kernel's cluster decomposition
  (``csrc/dest_rank.cuh``): the window split into k chunks, counts per
  chunk, bases from the lower chunks, ranks within a chunk by tiles,
  warps (peers below a lane) and a warps x D table, equals the one-pass
  ranks for k = 1..8 and chunk edges inside one destination's run, and
  gives the reference's residue and ``bucket_scatter_ref``'s rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as r_ev
from repro.core import routing as r_rt
from repro.kernels import fused_route_bucket as r_frb, ref as r_ref
from repro.wire import codec as r_codec
from repro_torch.kernels import dispatch
from repro_torch.kernels import fused_route_bucket as t_frb
from repro_torch.wire import codec as t_codec

FORMATS = [None, (15, 14, 32), (16, 14, 20), (15, 14, 0)]


def _words(rng, shape, addr_hi=1 << 14, p_valid=0.9):
    return np.array(r_ev.pack(jnp.asarray(rng.integers(0, addr_hi, shape)),
                              jnp.asarray(rng.integers(0, 1 << 15, shape)),
                              valid=jnp.asarray(rng.random(shape) < p_valid)))


def _dests(rng, shape, d, how):
    """Destinations -1 .. d (both ends out of range): ``uniform``,
    ``biased`` (most to 0 and 1: several rows overflow) or ``one`` (every
    event to destination d // 2)."""
    if how == "one":
        return np.full(shape, d // 2, np.int32)
    p = np.ones(d + 2)
    if how == "biased":
        p[1:3] += 4 * d
    return (rng.choice(d + 2, shape, p=p / p.sum()) - 1).astype(np.int32)


def _meta(rng, shape):
    meta = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    meta[..., ::3] = -1
    return meta


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _fmt(fmt):
    return None if fmt is None else t_codec.WireWordFormat(*fmt).validate()


def _assert_equals_reference(got, want, fmt, with_meta):
    assert (_u32(got.buckets.data) == np.asarray(want.buckets.data)).all()
    assert (got.buckets.guids.numpy() == np.asarray(want.buckets.guids)).all()
    assert (got.buckets.counts.numpy()
            == np.asarray(want.buckets.counts)).all()
    assert int(got.buckets.overflow) == int(want.buckets.overflow)
    for field in ("deferred", "dropped", "offered"):
        assert int(getattr(got, field)) == int(getattr(want, field)), field
    assert got.residue.shape == np.asarray(want.residue).shape
    assert (_u32(got.residue) == np.asarray(want.residue)).all()
    if with_meta:
        assert (got.residue_meta.numpy()
                == np.asarray(want.residue_meta)).all()
    else:
        assert got.residue_meta is None
    if fmt is None:
        assert got.payload is None
    else:
        ref = np.asarray(r_codec.encode_planar(
            want.buckets.data, want.buckets.guids,
            r_codec.WireWordFormat(*fmt).validate(), use_pallas=True,
            interpret=True))
        assert (_u32(got.payload) == ref).all()


# (n, D, C, residue_len, destinations)
CASES = [
    (1000, 7, 33, 128, "uniform"),
    (0, 4, 8, 5, "uniform"),           # an empty window
    (1, 4, 8, 5, "uniform"),
    (63, 7, 1, 16, "biased"),          # C 1
    (257, 13, 19, 300, "biased"),      # D 13, residue longer than n
    (300, 4, 16, 0, "biased"),         # no residue
    (600, 3, 8, 20, "biased"),         # residue shorter than the overflow
    (400, 5, 30, 64, "one"),           # every event to one destination
]


@pytest.mark.parametrize("k", range(len(CASES)))
def test_flush_window_plain_matches_reference(k):
    n, d, c, r, how = CASES[k]
    fmt = FORMATS[k % len(FORMATS)]
    rng = np.random.default_rng(100 + k)
    words, dest, meta = _words(rng, n), _dests(rng, n, d, how), _meta(rng, n)
    want = r_frb.fused_aggregate(
        jnp.asarray(words), jnp.asarray(dest), jnp.asarray(meta), d, c,
        residue_len=r, use_pallas=True, interpret=True,
        with_residue_meta=True)
    got = t_frb.flush_window_plain(_t(words), d, c, dest=_t(dest),
                                   meta=_t(meta), residue_len=r,
                                   with_residue_meta=True,
                                   wire_fmt=_fmt(fmt))
    _assert_equals_reference(got, want, fmt, with_meta=True)
    if how != "uniform" and c < n:
        assert int(want.buckets.overflow) > 0
    if k == 6:           # two destinations overflow, the residue clips
        assert (np.asarray(want.buckets.counts) == c).sum() >= 2
        assert int(want.dropped) > 0


def _tables(rng, n_addr, d):
    """Routing tables of ``n_addr`` addresses, half of them unrouted (dest
    -1); GUIDs from the reference's ``build_tables``."""
    projs = [r_rt.Projection(a, a + 1, dest_node=int(rng.integers(0, d)),
                             dest_links=[a % 3]) for a in range(0, n_addr, 2)]
    return r_rt.build_tables(n_addr, projs, n_guid=64)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,d,c,r", [(1000, 7, 33, 64), (200, 13, 1, 0)])
def test_flush_window_plain_routed_matches_reference(n, d, c, r, fmt):
    """Both tables (the exchange's call): the destination and the GUID
    looked up from the word's address, clamped to each table."""
    rng = np.random.default_rng(n + c + sum(fmt or ()))
    tabs = _tables(rng, 96, d)
    words = _words(rng, n, addr_hi=96 + 16)
    want = r_frb.fused_route_aggregate(
        jnp.asarray(words), tabs.dest_of_addr, tabs.guid_of_addr, d, c,
        residue_len=r, use_pallas=True, interpret=True)
    got = t_frb.flush_window_plain(
        _t(words), d, c, dest_lut=_t(np.asarray(tabs.dest_of_addr)),
        guid_lut=_t(np.asarray(tabs.guid_of_addr)), residue_len=r,
        wire_fmt=_fmt(fmt))
    _assert_equals_reference(got, want, fmt, with_meta=False)


@pytest.mark.parametrize("n_lut", [50, 300])
def test_flush_window_plain_dest_table_with_meta(n_lut):
    """The simulator's call: destinations from ``dest_of_addr``
    (addresses past the table clamp to its last entry), per-event meta
    carried into the residue."""
    rng = np.random.default_rng(n_lut)
    n, d, c, r = 700, 4, 24, 96
    lut = _dests(rng, n_lut, d, "biased")
    words, meta = _words(rng, n, addr_hi=n_lut + 40), _meta(rng, n)
    addr = np.minimum(np.asarray(r_ev.address(jnp.asarray(words))),
                      n_lut - 1)
    want = r_frb.fused_aggregate(
        jnp.asarray(words), jnp.asarray(lut[addr]), jnp.asarray(meta), d, c,
        residue_len=r, use_pallas=True, interpret=True,
        with_residue_meta=True)
    got = t_frb.flush_window_plain(_t(words), d, c, dest_lut=_t(lut),
                                   meta=_t(meta), residue_len=r,
                                   with_residue_meta=True,
                                   wire_fmt=t_codec.DEFAULT_WORD)
    _assert_equals_reference(got, want, (15, 14, 32), with_meta=True)
    assert int(want.deferred) > 0


def _fields(fw):
    return list(fw.buckets) + [f for f in fw[1:] if f is not None]


def test_flush_window_batch_equals_rows():
    """A (B, n) batch gives each row's window: per-row and shared tables,
    per-event operands; the wrapper takes the plain version on CPU
    tensors and launches nothing."""
    rng = np.random.default_rng(5)
    b, n, d, c, r = 3, 500, 6, 20, 64
    words = _words(rng, (b, n), addr_hi=120)
    dest, meta = _dests(rng, (b, n), d, "biased"), _meta(rng, (b, n))
    luts = _dests(rng, (b, 100), d, "biased")
    guids = rng.integers(-9, 1 << 20, (b, 90)).astype(np.int32)
    calls = [
        dict(dest=_t(dest), meta=_t(meta), with_residue_meta=True),
        dict(dest_lut=_t(luts), meta=_t(meta), with_residue_meta=True),
        dict(dest_lut=_t(luts), guid_lut=_t(guids)),
        dict(dest_lut=_t(luts[0]), guid_lut=_t(guids[1])),
    ]
    dispatch.reset_launches()
    for kw in calls:
        batch = t_frb.flush_window(_t(words), d, c, residue_len=r,
                                   wire_fmt=t_codec.DEFAULT_WORD, **kw)
        assert batch.payload.shape == (b, d, 2 * c)
        for row in range(b):
            one = {k: v if isinstance(v, bool) or v.dim() == 1 else v[row]
                   for k, v in kw.items()}
            single = t_frb.flush_window(_t(words[row]), d, c, residue_len=r,
                                        wire_fmt=t_codec.DEFAULT_WORD,
                                        **one)
            for x, y in zip(_fields(batch), _fields(single)):
                assert torch.equal(x[row], y)
        assert int(batch.buckets.overflow.sum()) > 0
    assert dispatch.LAUNCHES == {}             # CPU tensors: plain version


def test_flush_window_equals_the_sort_chain():
    """The plain version against the port's own sort-based chain (the
    sequence the kernel replaces on the card) in the chain's two operand
    combinations."""
    rng = np.random.default_rng(9)
    b, n, d, c, r = 2, 800, 5, 40, 128
    words = _t(_words(rng, (b, n), addr_hi=300))
    dest, meta = _t(_dests(rng, (b, n), d, "biased")), _t(_meta(rng, (b, n)))
    lut = _t(_dests(rng, (b, 256), d, "biased"))
    glut = _t(rng.integers(-9, 1 << 20, (b, 200)).astype(np.int32))
    fmt = t_codec.DEFAULT_WORD
    pairs = [
        (t_frb.flush_window(words, d, c, dest=dest, meta=meta,
                            residue_len=r, with_residue_meta=True,
                            wire_fmt=fmt),
         t_frb.fused_aggregate(words, dest, meta, d, c, residue_len=r,
                               with_residue_meta=True, wire_fmt=fmt)),
        (t_frb.flush_window(words, d, c, dest_lut=lut, guid_lut=glut,
                            residue_len=r, wire_fmt=fmt),
         t_frb.fused_route_aggregate(words, lut, glut, d, c, residue_len=r,
                                     wire_fmt=fmt)),
    ]
    for got, want in pairs:
        assert int(want.dropped.sum()) > 0
        for x, y in zip(_fields(got), _fields(want)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_flush_window_checks_its_operands():
    w = torch.zeros(4, 10, dtype=torch.int32)
    z = torch.zeros(4, 10, dtype=torch.int32)
    lut = torch.zeros(7, dtype=torch.int32)
    with pytest.raises(ValueError, match="dest and dest_lut"):
        t_frb.flush_window(w, 3, 4, dest=z, dest_lut=lut, meta=z)
    with pytest.raises(ValueError, match="meta and guid_lut"):
        t_frb.flush_window(w, 3, 4, dest=z)
    with pytest.raises(ValueError, match="with_residue_meta"):
        t_frb.flush_window(w, 3, 4, dest=z, guid_lut=lut, residue_len=4,
                           with_residue_meta=True)
    with pytest.raises(ValueError, match="n_dest"):
        t_frb.flush_window(w, 0, 4, dest=z, meta=z)
    with pytest.raises(ValueError, match="does not match"):
        t_frb.flush_window(w, 3, 4, dest=z[:2], meta=z)
    with pytest.raises(ValueError, match="n_table"):
        t_frb.flush_window(w, 3, 4, dest_lut=torch.zeros(3, 7,
                                                        dtype=torch.int32),
                           meta=z)


# ---------------------------------------------------------------------------
# The cluster decomposition of csrc/dest_rank.cuh, emulated.
# ---------------------------------------------------------------------------

def _cluster_ranks(dest, n_dest, k, tile=512, warp=32):
    """Ranks and totals as the kernel computes them, for one window
    ``dest`` (n,) with -1 for an event of no row, over a cluster of ``k``
    blocks.  Each block takes the chunk [r * chunk, (r + 1) * chunk); inside
    it, tile by tile, a lane's rank is the count of lower lanes of its warp
    with the same destination (``__popc(peers & lanes_below)``) plus its
    warp's entry of the warps x D table, scanned across warps from the
    chunk's running count; then the block's base for d is the count of d
    in the lower blocks' chunks, and the totals are the sum over blocks."""
    n = len(dest)
    chunk = -(-n // k) if n else 0
    local = np.full(n, -1, np.int64)
    counts = np.zeros((k, n_dest), np.int64)
    for r in range(k):
        lo, hi = min(n, r * chunk), min(n, (r + 1) * chunk)
        for t0 in range(lo, hi, tile):
            ds = dest[t0:min(hi, t0 + tile)]
            warps = -(-len(ds) // warp)
            table = np.zeros((warps, n_dest), np.int64)
            lane_rank = np.zeros(len(ds), np.int64)
            for w in range(warps):
                for lane in range(warp * w, min(len(ds), warp * (w + 1))):
                    d = ds[lane]
                    if d >= 0:
                        lane_rank[lane] = (ds[warp * w:lane] == d).sum()
                        table[w, d] += 1
            pre = counts[r] + np.cumsum(table, 0) - table    # exclusive
            for i, d in enumerate(ds):
                if d >= 0:
                    local[t0 + i] = pre[i // warp, d] + lane_rank[i]
            counts[r] += table.sum(0)
    base = np.cumsum(counts, 0) - counts                     # lower blocks
    ranks = np.full(n, -1, np.int64)
    for r in range(k):
        lo, hi = min(n, r * chunk), min(n, (r + 1) * chunk)
        for i in range(lo, hi):
            if dest[i] >= 0:
                ranks[i] = base[r, dest[i]] + local[i]
    return ranks, counts.sum(0)


def _one_pass_ranks(dest, n_dest):
    ranks = np.full(len(dest), -1, np.int64)
    seen = np.zeros(n_dest, np.int64)
    for i, d in enumerate(dest):
        if d >= 0:
            ranks[i], seen[d] = seen[d], seen[d] + 1
    return ranks, seen


def _runs(rng, n, n_dest):
    """Destinations in long runs (-1 runs too), so chunk and tile edges fall
    inside one destination's run."""
    out, filled = [], 0
    while filled < n:
        length = int(rng.integers(1, 300))
        out.append(np.full(length, rng.integers(-1, n_dest), np.int32))
        filled += length
    return np.concatenate(out)[:n]


@pytest.mark.parametrize("k", range(1, 9))
def test_cluster_ranks_equal_one_pass_ranks(k):
    rng = np.random.default_rng(k)
    for n, d, tile, how in ((1500, 5, 512, "runs"), (997, 13, 64, "runs"),
                            (700, 3, 64, "uniform"), (37, 4, 64, "runs")):
        dest = _runs(rng, n, d) if how == "runs" else \
            rng.integers(-1, d, n).astype(np.int32)
        got, tot = _cluster_ranks(dest, d, k, tile=tile)
        want, want_tot = _one_pass_ranks(dest, d)
        assert (got == want).all() and (tot == want_tot).all()
    # a chunk edge inside one destination's run
    dest = np.full(1000, 2, np.int32)
    dest[::7] = -1
    got, _ = _cluster_ranks(dest, 4, k, tile=64)
    assert (got == _one_pass_ranks(dest, 4)[0]).all()


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_cluster_emulation_gives_reference_residue_and_rows(k):
    """Slots and residue positions from the emulated ranks (rank k < C:
    slot k; else ``ovf_base[d] + k - C``) against the reference's
    ``fused_aggregate`` (Pallas in interpret mode), and D's rows and raw
    counts against ``repro.kernels.ref.bucket_scatter_ref``."""
    rng = np.random.default_rng(40 + k)
    n, d, c, r = 900, 4, 60, 150
    words, meta = _words(rng, n), _meta(rng, n)
    dest = _runs(rng, n, d + 1)               # destination d: out of range
    valid = (np.asarray(r_ev.is_valid(jnp.asarray(words)))
             & (dest >= 0) & (dest < d))
    masked = np.where(valid, dest, -1).astype(np.int32)
    ranks, tot = _cluster_ranks(masked, d, k, tile=64)

    data = np.zeros((d, c), np.uint32)
    gmeta = np.zeros((d, c), np.int32)
    excess = np.maximum(tot - c, 0)
    ovf_base = np.cumsum(excess) - excess
    rlen = min(r, n)
    residue = np.zeros(r, np.uint32)
    res_meta = np.zeros(r, np.int32)
    for i in np.flatnonzero(masked >= 0):
        di, ki = masked[i], ranks[i]
        if ki < c:
            data[di, ki], gmeta[di, ki] = words[i], meta[i]
        elif ovf_base[di] + ki - c < rlen:
            pos = ovf_base[di] + ki - c
            residue[pos], res_meta[pos] = words[i], meta[i]
    want = r_frb.fused_aggregate(
        jnp.asarray(words), jnp.asarray(dest), jnp.asarray(meta), d, c,
        residue_len=r, use_pallas=True, interpret=True,
        with_residue_meta=True)
    assert int(want.buckets.overflow) > 0 and (excess > 0).sum() >= 2
    assert (data == np.asarray(want.buckets.data)).all()
    assert (gmeta == np.asarray(want.buckets.guids)).all()
    assert (np.minimum(tot, c) == np.asarray(want.buckets.counts)).all()
    assert (residue == np.asarray(want.residue)).all()
    assert (res_meta == np.asarray(want.residue_meta)).all()

    oracle = r_ref.bucket_scatter_ref(
        jnp.asarray(np.where(valid, words, 0).astype(np.uint32)),
        jnp.asarray(masked), jnp.asarray(meta), d, c)
    assert (data == np.asarray(oracle[0])).all()
    assert (gmeta == np.asarray(oracle[1])).all()
    assert (tot == np.asarray(oracle[2])).all()
