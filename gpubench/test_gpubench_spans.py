"""The readers of the spike engine's stage spans (the host issue time of a
served window's exchange and latency attribution), on synthetic spans
through ``readers.Context``, and on a traced run of the small serving cell
on the CPU."""
from __future__ import annotations

import time

import pytest

from gpubench.harness import manifest, readers, runner

NEW = ("serve.exchange_ms_per_window", "serve.attribute_ms_per_window")


def X(name, ts, dur, track, **args):
    return {"ph": "X", "name": name, "ts": float(ts), "dur": float(dur),
            "track": track, "args": args}


def served_spans():
    """Two served segments of two windows on the device thread, between a
    warm-up window before them and a drain window after them on the
    caller's thread."""
    dev, main = "spike-device", "MainThread"
    return [
        # warm-up: a window outside any dispatch
        X("window/exchange", 0, 50, main, window=0),
        X("window/attribute", 50, 20, main, window=0),
        # segment 0: [100, 200]
        X("device/staged_wait", 90, 5, dev),
        X("device/h2d", 95, 5, dev),
        X("device/dispatch", 100, 100, dev, win0=0),
        X("window/exchange", 110, 10, dev, window=0),
        X("window/attribute", 125, 5, dev, window=0),
        X("window/exchange", 140, 20, dev, window=1),
        X("window/attribute", 165, 5, dev, window=1),
        # segment 1: [300, 420]; segment 0's stats wait
        X("device/staged_wait", 200, 95, dev),
        X("device/h2d", 295, 5, dev),
        X("device/dispatch", 300, 120, dev, win0=2),
        X("window/exchange", 310, 30, dev, window=2),
        X("window/attribute", 345, 5, dev, window=2),
        X("window/exchange", 360, 40, dev, window=3),
        X("window/attribute", 405, 5, dev, window=3),
        X("device/stats_wait", 420, 30, dev, win0=0),
        # a stage that outlasts its dispatch is not a served window's
        X("window/exchange", 410, 100, dev, window=4),
        # the drain, on the caller's thread
        X("window/exchange", 500, 1000, main, window=4),
        X("window/attribute", 1500, 500, main, window=4),
        X("device/stats_wait", 2000, 700, main, win0=4),
        X("drain/walk", 2700, 10, dev),
        X("ingest/slot_wait", 0, 80, "spike-ingest", slot=0),
    ]


def read(name, spans):
    return manifest.metric_reader(manifest.BENCH.parent, name)(
        readers.Context(None, {}, spans))


def test_readers_count_served_windows_only():
    spans = served_spans()
    assert read("serve.exchange_ms_per_window", spans) == pytest.approx(
        (10 + 20 + 30 + 40) / 4 * 1e-3)
    assert read("serve.attribute_ms_per_window", spans) == pytest.approx(
        5e-3)


def test_readers_read_nothing_where_the_program_records_nothing():
    """A program without the stage spans (its stats wait was a
    ``device/segment`` on the ``device`` track) gives None, and so does a
    run without spans."""
    old = [e for e in served_spans()
           if not e["name"].startswith("window/")
           and e["name"] != "device/stats_wait"]
    old.append(X("device/segment", 420, 30, "device", win0=0))
    for name in NEW:
        assert read(name, old) is None, name
    for name in NEW:
        assert read(name, None) is None and read(name, []) is None


def test_manifest_lists_the_readers_in_both_serving_cells():
    for cell in ("serve2t_contended", "serve2t_quiet_solo"):
        names = {m["name"] for m in manifest.load(manifest.BENCH.parent,
                                                  cell).per_layer}
        assert set(NEW) <= names
    for cell in ("mc8_torus3d_c124", "mc8_alltoall"):
        names = {m["name"] for m in manifest.load(manifest.BENCH.parent,
                                                  cell).per_layer}
        assert not set(NEW) & names


def test_traced_small_serving_cell_reads_every_span_metric(tiny_root):
    """A traced run of the small contended cell on the CPU: every span
    metric reads, and the two stages fit in the dispatch they lie in."""
    line = runner.run_cell(tiny_root, "tiny_contended", seed=2**33 + 3,
                           seconds=6.0, trace=True, device="cpu",
                           t_start=time.perf_counter())
    assert line["correct"], line["compared"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) | {"serve.dispatch_ms_per_window",
                       "serve.staged_wait_pct"} <= set(got)
    assert got["serve.exchange_ms_per_window"] + got[
        "serve.attribute_ms_per_window"] <= got[
        "serve.dispatch_ms_per_window"]
    assert min(got[name] for name in NEW) > 0.0
