"""The users' entry points of the port, counterparts of the reference's
``examples/`` scripts.

* ``multiwafer_microcircuit`` -- the paper's workload: the microcircuit on
  4 wafer shards through the bucket-aggregated fabric;
* ``quickstart`` -- aggregation, the cycle model, LUT routing and a tiny
  LM trained for 10 steps;
* ``serve_lm`` -- a reduced gemma2 served through the slot engine;
* ``train_100m`` -- a ~100M-parameter MiniCPM-family model trained with
  the production stack.

Each runs as ``python -m repro_torch.examples.<name>`` with the reference
script's arguments plus ``--device`` (default ``cuda``, which raises when
there is no card), and is built from a ``main(...)`` that other code can
call.  Times are printed beside the device's name (and, on a card, the
power limit that ``nvidia-smi`` reports).
"""
from __future__ import annotations

import subprocess

import torch


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op off the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device: torch.device) -> str:
    """``"<name>, <power limit>"`` as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them for a card (its
    PyTorch name where nvidia-smi is missing), ``"CPU"`` otherwise."""
    if device.type != "cuda":
        return "CPU"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        rows = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()
        return rows[index].strip()
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(index)
