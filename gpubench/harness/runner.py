"""One run of one cell, as a dict shaped like the result line.

``run_cell`` is what ``gpubench/run.py`` calls on the card; tests call it
on the CPU with small configurations (never with a result printed)."""
from __future__ import annotations

from pathlib import Path

from gpubench.harness import manifest


def run_cell(root: Path, workload: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             control: bool = False) -> dict:
    import torch
    cell = manifest.load(root, workload)
    kind = manifest.kind_module(cell)
    out = kind.run(cell, seed=seed, seconds=seconds, trace=trace,
                   device=device, t_start=t_start, control=control)
    compared = {name: {"value": v, "limit": lim}
                for name, (v, lim) in out["compared"].items()}
    correct = all(v <= lim for v, lim in out["compared"].values())
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": {}, "device": info}
    if trace:
        ctx = out["ctx"]
        for m in cell.per_layer:
            value = manifest.metric_reader(root, m["name"])(ctx)
            if value is not None:
                line["metrics"][m["name"]] = {"value": float(value),
                                              "unit": m["unit"]}
        info["busy_s"] = ctx.trace.busy_s
        info["window_s"] = ctx.trace.window_s
        line["breakdown"] = ctx.trace.breakdown()
    else:
        for m in cell.end_to_end:
            line["metrics"][m["name"]] = {"value": float(out["e2e"][m["name"]]),
                                          "unit": m["unit"]}
    line["checked_windows"] = int(out["checked_windows"])
    line["check_s"] = float(out["check_s"])
    if "segment_ms" in out:
        line["segment_ms"] = out["segment_ms"]
    line["compared"] = compared
    return line
