"""The benchmark's copies (load generator, connectivity rule) against the
port's originals, and the kernel byte counters against the bytes the
kernels' tables give."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench.harness import manifest
from gpubench.inputs import loadgen, pd_connectivity as pd
from gpubench.reference import codec, flush


@pytest.mark.parametrize("seed", [7, 2**31 + 5, 123456789012])
def test_loadgen_copy_gives_the_ports_windows(seed):
    from repro_torch.serve import loadgen as port
    args = [("quiet", 40.0), ("hot", 600.0, 3.0, 0.25)]
    ours = loadgen.PoissonLoadGen(seed, [loadgen.TenantProfile(*a)
                                         for a in args], 8, 32)
    theirs = port.PoissonLoadGen(seed, [port.TenantProfile(*a)
                                        for a in args], 8, 32)
    for w in (0, 1, 17, 1000):
        a, b = ours.next_window(w), theirs.next_window(w)
        for f in ("counts", "words", "clipped"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_connectivity_rule_matches_the_ports_spec():
    from repro_torch.snn import microcircuit as port
    for scale in (0.004, 0.2, 1.0):
        spec = port.MicrocircuitSpec(scale=scale)
        np.testing.assert_array_equal(pd.sizes(scale), spec.sizes)
        np.testing.assert_array_equal(pd.bg_rates(scale), spec.bg_rates())
        np.testing.assert_array_equal(pd.population_of(scale),
                                      spec.population_of())
    assert int(pd.sizes(0.2).sum()) == 15431


def test_connectivity_draws_follow_the_published_rule():
    scale = 0.02
    gen = torch.Generator().manual_seed(3)
    w = pd.weights(scale, gen).numpy()
    again = pd.weights(scale, torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(w, again)       # the seed decides them
    off = np.concatenate([[0], np.cumsum(pd.sizes(scale))])
    for i in range(8):
        for j in range(8):
            block = w[off[i]:off[i + 1], off[j]:off[j + 1]]
            p, n = pd.CONN_PROB[i, j], block.size
            frac = (block != 0).mean()
            assert abs(frac - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12
            if p > 0.02:
                base = pd.W_EXC_PA * (pd.G_INH if j % 2 else 1.0) * (
                    pd.W_L4E_L23E if (i, j) == (0, 2) else 1.0)
                mean = block[block != 0].mean()
                assert abs(mean - base) < 0.05 * abs(base)


def test_kernel_byte_counters_match_the_kernel_tables():
    count = lambda kernel: manifest.roofline(kernel).count
    # PERF.md's kernel table: C 3,086,400 B per 8-step window of 15,432
    # neurons; F 5,508 B on torus3d 2x2x2 (8 shards, 48 links, 3-hop
    # routes), its tenant form 11,972 B with 2 tenants
    assert count("lif_window")(dict(n_shards=8, per_shard=1929,
                                    window=8))[0] == 3086400
    assert count("admission")(dict(n_shards=8, torus=[2, 2, 2]))[0] == 5508
    assert count("admission_tenants")(dict(n_shards=8, torus=[2, 2, 2],
                                           n_tenants=2))[0] == 11972


def test_flush_and_codec_counters_are_their_operands_and_results():
    gen = torch.Generator().manual_seed(0)
    # 5 shards, each offering the residue (24) and 16 spikes x 11 fan-out
    b, c, r, e_max, max_fan, n_lut = 5, 16, 24, 16, 11, 64
    d, n = b, r + e_max * max_fan
    addr = torch.randint(0, n_lut, (b, n), generator=gen)
    valid = torch.rand((b, n), generator=gen) < 0.8
    words = ((addr << 15) | (1 << 29)) * valid
    lut = torch.randint(0, d, (b, n_lut), generator=gen, dtype=torch.int32)
    meta = torch.randint(0, 1000, (b, n), generator=gen, dtype=torch.int32)
    fw = flush.flush_window_plain(words.to(torch.int32), d, c, dest_lut=lut,
                                  meta=meta, residue_len=r,
                                  with_residue_meta=True,
                                  wire_fmt=codec.DEFAULT_WORD)
    entries = sum(int(torch.unique(addr[i][valid[i]]).numel())
                  for i in range(b))
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    want = (nbytes(words.to(torch.int32), meta) + 4 * entries
            + nbytes(fw.buckets.data, fw.buckets.guids, fw.payload,
                     fw.buckets.counts, fw.residue, fw.residue_meta)
            + 4 * 4 * b)
    sizes = dict(n_shards=b, capacity=c, residue=r, e_max=e_max,
                 max_fan=max_fan, credited=False, offered_per_window=entries)
    got, _ = manifest.roofline("flush_window").count(sizes)
    assert got == want
    buf = codec.encode_planar(fw.buckets.data, fw.buckets.guids)
    word, m = codec.decode_planar(buf)
    for k in ("wire_decode", "wire_codec"):
        assert word.numel() == b * b * c
        assert manifest.roofline(k).count(sizes)[0] == nbytes(buf, word, m)
