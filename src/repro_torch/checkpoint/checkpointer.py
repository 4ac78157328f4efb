"""Fault-tolerant checkpointing: atomic, with retention (port of
``src/repro/checkpoint/checkpointer.py``), in the reference's on-disk
format, so either package restores the other's checkpoints.

* **Atomicity** -- write into ``step_<N>.tmp/``, then ``os.rename`` to
  ``step_<N>/`` (``%010d``); a crash mid-write never corrupts the latest
  checkpoint, and ``latest_step`` reads committed directories only.
* **Contents** -- the whole tree (params, optimizer moments, step),
  flattened to path-keyed ``.npy`` files (``a/b/c`` -> ``a__b__c.npy``)
  and ``manifest.json`` (``{"step", "arrays": {key: {"file", "shape",
  "dtype"}}}``).  Leaves are turned into numpy on save and restored onto a
  device.
* **bf16** -- numpy has no bfloat16; the reference's ``np.save`` of an
  ``ml_dtypes`` bfloat16 array writes raw 2-byte records (``'<V2'``) and
  its manifest says ``"bfloat16"``.  The port writes the same file and, on
  restore, reads such a leaf back as ``torch.bfloat16`` bit for bit from
  the manifest's dtype (no ``ml_dtypes`` needed).
* **Retention** -- keep the last ``keep`` checkpoints, delete older ones.

* **Elastic restore** -- ``restore(..., shardings=)`` places the state
  in another (virtual) mesh's layout: it raises where the reference's
  ``device_put`` would (a dimension the mesh does not divide) and
  changes no value.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.distributed.sharding import check_layout
from repro_torch.kernels import dispatch

BF16_DESCR = "<V2"           # what np.save writes for ml_dtypes' bfloat16


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    if hasattr(tree, "_fields"):                    # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
        return out
    out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten_into(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields))
    if isinstance(template, (tuple, list)):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        return type(template)(vals)
    return flat[prefix.rstrip("/")]


def _save_leaf(path: str, v) -> dict:
    """Write one leaf as ``.npy``; return its manifest entry's shape and
    dtype."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            shape = tuple(v.shape)
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": BF16_DESCR, "fortran_order": False,
                        "shape": shape})
                f.write(v.contiguous().view(torch.int16).numpy().tobytes())
            return {"shape": list(shape), "dtype": "bfloat16"}
        v = v.numpy()
    arr = np.asarray(v)
    np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def _load_leaf(path: str, dtype: str, device) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, step: int, state) -> str:
        """Write ``state`` (a tree of tensors or numpy arrays) as step
        ``step``, atomically; returns the committed directory."""
        flat = _flatten(state)
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for k, v in flat.items():
            fname = k.replace("/", "__") + ".npy"
            manifest[k] = {"file": fname,
                           **_save_leaf(os.path.join(tmp, fname), v)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "arrays": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic commit
        self._gc()
        return final

    # -- restore -------------------------------------------------------------
    def _steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, device=None,
                shardings=None):
        """Restore step ``step`` (default: the latest; None if there is
        none) into ``template``'s structure (its leaves are not read: meta
        tensors will do), every leaf on ``device`` (``None`` is CUDA), in
        the layout ``shardings`` (a Sharding tree like the state) if
        given."""
        device = dispatch.resolve_device(device)
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["arrays"]
        flat = {k: _load_leaf(os.path.join(path, m["file"]), m["dtype"],
                              device)
                for k, m in manifest.items()}
        state = _unflatten_into(template, flat)
        if shardings is not None:
            check_layout(state, shardings)
        return state

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)
