"""Port vs reference for the wire subsystem: the codec's plain version
against the reference's Pallas codec body (interpret mode) bit for bit,
frame accounting for both profiles, and the latency digest (hist exact,
p50/p99/max/mean at rtol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import wire as r_wire
from repro.core import events as r_ev
from repro.wire import codec as r_codec
from repro_torch import wire as t_wire
from repro_torch.transport import base as t_base
from repro_torch.wire import codec as t_codec


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _events_and_meta(n, seed):
    """Random words (INVALID included), random i32 meta with -1 and the
    field maxima forced into the first slots."""
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, 1 << 14, n)
    ts = rng.integers(0, 1 << 15, n)
    valid = rng.random(n) < 0.85
    meta = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    edge = [(r_ev.ADDR_MASK, r_ev.TS_MASK, True, -1),
            (r_ev.ADDR_MASK, r_ev.TS_MASK, True, 2**31 - 1),
            (0, 0, True, -2**31), (5, 7, False, -1), (0, 0, False, 0)]
    for i, (a, t, v, m) in enumerate(edge[:n]):
        addr[i], ts[i], valid[i], meta[i] = a, t, v, m
    words = np.array(r_ev.pack(jnp.asarray(addr), jnp.asarray(ts),
                               valid=jnp.asarray(valid)))
    return words, meta


@pytest.mark.parametrize("n", [1, 7, 100, 1000])
def test_codec_matches_reference_pallas_body(n):
    """The plain version against ``encode_words`` / ``decode_words`` with
    the Pallas body in interpret mode: identical wire lanes, identical
    decoded words and meta."""
    words, meta = _events_and_meta(n, n)
    r_lo, r_hi = r_wire.encode_words(jnp.asarray(words), jnp.asarray(meta),
                                     use_pallas=True, interpret=True)
    t_lo, t_hi = t_wire.encode_words(torch.from_numpy(words.view(np.int32)),
                                     torch.from_numpy(meta))
    assert (_u32(t_lo) == np.asarray(r_lo)).all()
    assert (_u32(t_hi) == np.asarray(r_hi)).all()
    r_w, r_m = r_wire.decode_words(r_lo, r_hi, use_pallas=True,
                                   interpret=True)
    t_w, t_m = t_wire.decode_words(t_lo, t_hi)
    assert (_u32(t_w) == np.asarray(r_w)).all()
    assert (t_m.numpy() == np.asarray(r_m)).all()
    assert (t_m.numpy() == meta).all() and (_u32(t_w) == words).all()


@pytest.mark.parametrize("fmt", [(15, 14, 32), (16, 14, 20), (20, 18, 0),
                                 (15, 14, 16)])
def test_codec_custom_widths_match_reference(fmt):
    words, meta = _events_and_meta(300, sum(fmt))
    r_fmt = r_codec.WireWordFormat(*fmt).validate()
    t_fmt = t_codec.WireWordFormat(*fmt).validate()
    r_lo, r_hi = r_wire.encode_words(jnp.asarray(words), jnp.asarray(meta),
                                     r_fmt, use_pallas=False)
    t_lo, t_hi = t_wire.encode_words(torch.from_numpy(words.view(np.int32)),
                                     torch.from_numpy(meta), t_fmt)
    assert (_u32(t_lo) == np.asarray(r_lo)).all()
    assert (_u32(t_hi) == np.asarray(r_hi)).all()
    r_w, r_m = r_wire.decode_words(r_lo, r_hi, r_fmt, use_pallas=False)
    t_w, t_m = t_wire.decode_words(t_lo, t_hi, t_fmt)
    assert (_u32(t_w) == np.asarray(r_w)).all()
    assert (t_m.numpy() == np.asarray(r_m)).all()


def test_codec_planar_layout_and_packed_rows():
    """``encode_planar`` matches the reference's (..., 2C) layout; decoding
    the payload columns of a packed (S, S, 2C + 1) exchange buffer (a
    last-axis slice) gives the rows back."""
    words, meta = _events_and_meta(4 * 4 * 16, 3)
    words, meta = words.reshape(4, 4, 16), meta.reshape(4, 4, 16)
    r_buf = r_wire.encode_planar(jnp.asarray(words), jnp.asarray(meta),
                                 use_pallas=False)
    t_buf = t_wire.encode_planar(torch.from_numpy(words.view(np.int32)),
                                 torch.from_numpy(meta))
    assert t_buf.shape == (4, 4, 32)
    assert (_u32(t_buf) == np.asarray(r_buf)).all()
    counts = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    recv, recv_counts = t_base.unpack_payload(
        t_base.pack_payload(t_buf, counts))
    assert not recv.is_contiguous()
    w2, m2 = t_wire.decode_planar(recv)
    assert (_u32(w2) == words).all() and (m2.numpy() == meta).all()
    assert (recv_counts == counts).all()


@pytest.mark.parametrize("profile", ["extoll", "ethernet"])
def test_frame_accounting_matches_reference(profile):
    n = np.concatenate([np.arange(0, 3000), [4095, 4096, 65536]]).astype(
        np.int32)
    r_fmt, t_fmt = r_wire.get_profile(profile), t_wire.get_profile(profile)
    assert tuple(t_fmt) == tuple(r_fmt)
    for name in ("frame_bytes", "frame_count", "frame_overhead_bytes",
                 "wire_efficiency"):
        got = getattr(t_wire, name)(t_fmt, torch.from_numpy(n)).numpy()
        want = np.asarray(getattr(r_wire, name)(r_fmt, jnp.asarray(n)))
        assert got.dtype == want.dtype and (got == want).all(), name


@pytest.mark.parametrize("seed", range(4))
def test_latency_digest_matches_reference(seed):
    """hist exact; p50/p99/max/mean at rtol 1e-6, per row of a batch."""
    rng = np.random.default_rng(seed)
    rows, r = 5, int(rng.integers(1, 200))
    lat = rng.uniform(0.01, 5000.0, (rows, r)).astype(np.float32)
    lat[:, : r // 3] = np.float32(0.8)          # ties, as in a real window
    w = rng.integers(0, 40, (rows, r)).astype(np.int32)
    w[0] = 0                                    # an empty row
    got = t_wire.summarize_latency(torch.from_numpy(lat),
                                   torch.from_numpy(w), batch_dims=1)
    for row in range(rows):
        want = r_wire.summarize_latency(jnp.asarray(lat[row]),
                                        jnp.asarray(w[row]))
        assert (got.hist[row].numpy() == np.asarray(want.hist)).all()
        for field in ("p50_us", "p99_us", "max_us", "mean_us"):
            np.testing.assert_allclose(getattr(got, field)[row].item(),
                                       float(getattr(want, field)),
                                       rtol=1e-6, err_msg=field)
        assert t_wire.percentile_from_hist(got.hist[row].numpy(), 0.99) == \
            r_wire.percentile_from_hist(np.asarray(want.hist), 0.99)


@pytest.mark.parametrize("profile", ["extoll", "ethernet"])
def test_hop_and_queueing_latency_match_reference(profile):
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 2000, (4, 4)).astype(np.int32)
    hops = rng.integers(0, 5, (4, 4)).astype(np.int32)
    r_fmt, t_fmt = r_wire.get_profile(profile), t_wire.get_profile(profile)
    got = t_wire.hop_latency_us(t_fmt, torch.from_numpy(counts),
                                torch.from_numpy(hops)).numpy()
    want = np.asarray(r_wire.hop_latency_us(r_fmt, jnp.asarray(counts),
                                            jnp.asarray(hops)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got = t_wire.queueing_latency_us(t_fmt, torch.from_numpy(counts)).numpy()
    want = np.asarray(r_wire.queueing_latency_us(r_fmt, jnp.asarray(counts)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
