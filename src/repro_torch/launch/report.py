"""Markdown tables from dry-run report JSONs (port of
``src/repro/launch/report.py``).

The tables take the reference's report dicts and the port's alike: on a
reference dict they give the reference's strings.  What the port's
reports lack (the compile time, the collective bytes and term: no XLA
program behind them) prints as ``—``.  Usage:
``python -m repro_torch.launch.report report.json ...``.
"""
from __future__ import annotations

import json
import sys

NA = "—"


def fmt_s(x):
    if x is None:
        return NA
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def _gb(c, kind):
    return NA if c is None else f"{c[kind] / 1e9:.1f}"


def roofline_table(reports):
    hdr = ("| arch | shape | mesh | t_compute | t_memory | t_collective | "
           "bottleneck | useful(6ND/HLO) | roofline frac | GB/chip |")
    sep = "|" + "---|" * 10
    rows = [hdr, sep]
    for r in reports:
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"— | — | — | skipped¹ | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR | | | | | | |")
            continue
        t = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt_s(t['t_compute'])} | {fmt_s(t['t_memory'])} | "
            f"{fmt_s(t['t_collective'])} | {t['bottleneck']} | "
            f"{t['useful_ratio']:.2f} | {t['roofline_fraction']:.3f} | "
            f"{r['per_chip_state_bytes'] / 1e9:.2f} |")
    return "\n".join(rows)


def dryrun_table(reports):
    hdr = ("| arch | shape | mesh | compile | GB/chip state | fits HBM | "
           "AG GB | AR GB | A2A GB | CP GB |")
    sep = "|" + "---|" * 10
    rows = [hdr, sep]
    for r in reports:
        if r["status"] != "ok":
            continue
        c = r.get("collectives", {}).get("bytes_by_kind")
        compile_s = f"{r['compile_s']}s" if "compile_s" in r else NA
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{compile_s} | {r['per_chip_state_bytes'] / 1e9:.2f} | "
            f"{'yes' if r['fits_hbm'] else 'NO'} | "
            f"{_gb(c, 'all-gather')} | {_gb(c, 'all-reduce')} | "
            f"{_gb(c, 'all-to-all')} | {_gb(c, 'collective-permute')} |")
    return "\n".join(rows)


def main(argv=None):
    out = []
    for path in (sys.argv[1:] if argv is None else argv):
        with open(path) as f:
            reports = json.load(f)
        out.append(f"### {path}\n")
        out.append(roofline_table(reports))
        out.append("")
    print("\n".join(out))


if __name__ == "__main__":
    main()
