"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel counter sits in a file of its own, found by name:

* a cell is an entry of ``workloads``; its ``config`` names an entry of
  ``configs`` whose ``file`` holds the configuration (its ``"kind"`` names
  ``gpubench/kinds/<kind>.py``, the code that runs that kind of cell);
* its ``traffic`` is ``gpubench/traffic/<traffic>.json``;
* a per-layer metric ``<name>`` is read by ``gpubench/metrics/<name>.py``
  (a function ``read(ctx) -> float | None``);
* a kernel's device function and its bytes and operations per launch are
  in ``gpubench/rooflines/<kernel>.py`` (``PATTERN``, a regular expression
  that matches the function's name in a trace, and ``count(shapes) ->
  (bytes, ops)``).

So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none:

* a new kind is ``gpubench/kinds/<kind>.py`` with ``run(cell, *, seed,
  seconds, trace, device, t_start, control)`` returning what
  ``harness.runner.run_cell`` reads, and ``DRIVES``, the program that the
  planted faults of ``test_gpubench_faults.py`` break (``"simulator"`` or
  ``"engine"``);
* a network kind hands its four parts (inputs, program, reference, the
  carry's translation) to ``gpubench.kinds.microcircuit.run_network``,
  which holds the set-up, the timed window and the check, and passes the
  program's tracer spans in the profiled segments to the readers;
* a new reference is a new file under ``gpubench/reference/`` that
  imports nothing of the program (``test_gpubench_harness.py`` holds it);
* a new cell joins an existing metric by appending its own name to that
  metric's ``workloads`` list in ``BENCHMARK.json`` (as the tests'
  ``make_tiny_root`` does).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with what it names."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list      # the manifest's end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports
    root: Path            # the checkout (BENCHMARK.json's directory)

    @property
    def kind(self) -> str:
        return self.config["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises
    ``KeyError`` for an unknown name."""
    root = Path(root)
    man = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "gpubench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in man["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, workload)
                 and m["moves"] in reported]
    return Cell(workload, int(w["chips"]), w["config"], w["traffic"], config,
                traffic, e2e, per_layer, root)


def kind_module(cell: Cell):
    return importlib.import_module(f"gpubench.kinds.{cell.kind}")


def _load_file(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """``read(ctx)`` of the per-layer metric ``name``."""
    return _load_file(Path(root) / "gpubench" / "metrics" / f"{name}.py").read


def roofline(kernel: str, root: Path = BENCH.parent):
    """The counter file of ``kernel``: its ``PATTERN`` and ``count(shapes)
    -> (bytes, operations)`` of one launch."""
    return _load_file(Path(root) / "gpubench" / "rooflines"
                      / f"{kernel}.py")
