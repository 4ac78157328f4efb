"""Placement's encode epilogue (kernel A with the wire codec's encode) on
the CPU, where the wrapper runs its plain version.

``FusedWindow.payload`` must equal, bit for bit, the reference's
``repro.wire.codec.encode_planar`` of the reference's own buckets, with
both the reference's Pallas placement and its Pallas codec in interpret
mode; both variants, ragged shapes, custom word formats and meta -1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as r_ev, routing as r_rt
from repro.kernels import fused_route_bucket as r_frb
from repro.wire import codec as r_codec
from repro_torch.kernels import dispatch
from repro_torch.kernels import fused_route_bucket as t_frb
from repro_torch.wire import codec as t_codec

FORMATS = [(15, 14, 32), (16, 14, 20), (15, 14, 0)]


def _window(batch, n, d, seed, addr_hi=1 << 14):
    """(batch, n) words, destinations -1 .. d and meta with -1 forced into
    every third event."""
    rng = np.random.default_rng(seed)
    shape = (batch, n)
    words = np.array(r_ev.pack(jnp.asarray(rng.integers(0, addr_hi, shape)),
                               jnp.asarray(rng.integers(0, 1 << 15, shape)),
                               valid=jnp.asarray(rng.random(shape) < 0.9)))
    dest = rng.integers(-1, d + 1, shape).astype(np.int32)
    meta = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    meta[:, ::3] = -1
    return words, dest, meta


def _reference_payload(buckets, fmt):
    return np.asarray(r_codec.encode_planar(
        buckets.data, buckets.guids, r_codec.WireWordFormat(*fmt).validate(),
        use_pallas=True, interpret=True))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,d,c,r", [(1000, 7, 33, 64), (257, 13, 19, 0)])
def test_fused_aggregate_payload_matches_reference(n, d, c, r, fmt):
    words, dest, meta = _window(1, n, d, n + d + sum(fmt))
    want = r_frb.fused_aggregate(
        jnp.asarray(words[0]), jnp.asarray(dest[0]), jnp.asarray(meta[0]),
        d, c, residue_len=r, use_pallas=True, interpret=True,
        with_residue_meta=True)
    got = t_frb.fused_aggregate(
        torch.from_numpy(words[0].view(np.int32)), torch.from_numpy(dest[0]),
        torch.from_numpy(meta[0]), d, c, residue_len=r,
        with_residue_meta=True,
        wire_fmt=t_codec.WireWordFormat(*fmt).validate())
    assert tuple(got.payload.shape) == (d, 2 * c)
    assert (_u32(got.payload) == _reference_payload(want.buckets, fmt)).all()
    assert (_u32(got.buckets.data) == np.asarray(want.buckets.data)).all()
    assert (got.buckets.guids.numpy() == np.asarray(want.buckets.guids)).all()
    assert (got.buckets.guids.numpy() == -1).any(), "meta -1 unexercised"


@pytest.mark.parametrize("fmt", FORMATS)
def test_fused_route_aggregate_payload_matches_reference(fmt):
    """The LUT-routed variant (the exchange's), GUIDs looked up inside
    placement, addresses past the table clamped."""
    n, d, c, n_addr = 1000, 7, 33, 96
    projs = [r_rt.Projection(a, a + 1, dest_node=a % d, dest_links=[a % 3])
             for a in range(0, n_addr, 2)]
    tabs = r_rt.build_tables(n_addr, projs, n_guid=64)
    words, _, _ = _window(1, n, d, sum(fmt), addr_hi=n_addr + 16)
    want = r_frb.fused_route_aggregate(
        jnp.asarray(words[0]), tabs.dest_of_addr, tabs.guid_of_addr, d, c,
        residue_len=32, use_pallas=True, interpret=True)
    got = t_frb.fused_route_aggregate(
        torch.from_numpy(words[0].view(np.int32)),
        torch.from_numpy(np.array(tabs.dest_of_addr)),
        torch.from_numpy(np.array(tabs.guid_of_addr)), d, c, residue_len=32,
        wire_fmt=t_codec.WireWordFormat(*fmt).validate())
    assert (_u32(got.payload) == _reference_payload(want.buckets, fmt)).all()


def test_payload_of_a_batch_and_without_a_format():
    """A (B, n) batch (the simulator's shards) carries each row's payload,
    which decodes to the row's buckets; without ``wire_fmt`` there is no
    payload and nothing changes."""
    words, dest, meta = _window(3, 300, 4, 11)
    t = lambda a: torch.from_numpy(a.view(np.int32))
    fmt = t_codec.DEFAULT_WORD
    dispatch.reset_launches()
    got = t_frb.fused_aggregate(t(words), t(dest), t(meta), 4, 16,
                                residue_len=32, with_residue_meta=True,
                                wire_fmt=fmt)
    plain = t_frb.fused_aggregate(t(words), t(dest), t(meta), 4, 16,
                                  residue_len=32, with_residue_meta=True)
    assert dispatch.LAUNCHES == {}             # CPU tensors: plain version
    assert plain.payload is None
    rest = ("residue", "deferred", "dropped", "offered", "residue_meta")
    for a, b in zip(list(got.buckets) + [getattr(got, f) for f in rest],
                    list(plain.buckets) + [getattr(plain, f) for f in rest]):
        assert torch.equal(a, b)
    assert tuple(got.payload.shape) == (3, 4, 32)
    w, m = t_codec.decode_planar(got.payload, fmt)
    assert torch.equal(w, got.buckets.data)
    assert torch.equal(m, got.buckets.guids)
    for b in range(3):
        one = t_frb.fused_aggregate(t(words[b]), t(dest[b]), t(meta[b]), 4,
                                    16, residue_len=32, wire_fmt=fmt)
        assert torch.equal(got.payload[b], one.payload)
