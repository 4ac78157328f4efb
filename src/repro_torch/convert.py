"""Carry state between the reference (``src/repro``) and the port.

The reference's arrays arrive as numpy (turn JAX arrays into numpy before
any per-shard indexing: jax 0.9 meshes refuse host indexing of a
shard-axis result).  Nothing here imports JAX or the reference: a
reference pytree is read through its NamedTuple fields, so :func:`flatten`
works on ``SimCarry``, ``ShardState``, ``WindowStats`` and the like.

Layouts:

* event words and wire lanes: reference ``uint32``, port ``int32`` bit
  patterns (``view``, no conversion);
* delay rings: reference ``(S, ring_len, per)``, port ``(ring_len, S,
  per)``;
* the reference's per-shard PRNG key has no port counterpart (the port
  draws from a ``torch.Generator`` or takes its drive as input);
* the port's ``PendingWindow.payload`` (the pending buckets as wire words,
  which its flush-window kernel writes) has no reference counterpart: it is
  encoded from ``data`` and ``meta`` on the way in and dropped on the way
  out;
* LM parameters: the same nested dicts, block parameters stacked along a
  leading layer axis in both; ``bfloat16`` numpy arrays (``ml_dtypes``)
  become ``torch.bfloat16`` bit for bit;
* LM caches: the same NamedTuples with the same fields and layouts in
  both, stacked over layers: the transformers' ``{"blocks": KVCache}``
  (and deepseek's ``"dense"``) with ``k`` / ``v`` ``(n_layers, B, T, Hkv,
  D)`` and ``length`` ``(n_layers,)``; Mamba-2's ``SSMCache``;
  RecurrentGemma's ``RGCaches`` (``RGLRUCache`` per recurrent stack, the
  ring ``KVCache``, a tuple of tail ``RGLRUCache``); Whisper's
  ``WhisperCaches``;
* train states: ``{"params", "opt", "step"}`` in both, the optimizer state
  the AdamW or Adafactor NamedTuple of the same fields (told apart by
  them), ``count`` and ``step`` 0-d ``int32``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import wire
from repro_torch.core.routing import RoutingTables
from repro_torch.kernels import dispatch
from repro_torch.models.attention import KVCache
from repro_torch.models.encdec import WhisperCaches
from repro_torch.models.hybrid import RGCaches
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.ssm import SSMCache
from repro_torch.snn import lif, network
from repro_torch.snn.simulator import PendingWindow, ShardState, SimCarry
from repro_torch.train.optimizer import AdafactorState, AdamWState


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a tree of NamedTuples into ``{"a.b.c": numpy array}``
    (``None`` leaves are skipped)."""
    if tree is None:
        return {}
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(flatten(getattr(tree, name), f"{prefix}{name}."))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def _t(a, device: torch.device, dtype=None) -> torch.Tensor:
    a = np.array(a, order="C")      # a copy: never aliases the caller's
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch interop
        out = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        out = torch.from_numpy(a)
    out = out.to(device)
    return out if dtype is None else out.to(dtype)


def partition_from_reference(part) -> network.Partition:
    """The port's partition of the same network (weights, fan-out and
    delays copied from a reference ``Partition``)."""
    return network.Partition(
        n_shards=int(part.n_shards), n_neurons=int(part.n_neurons),
        per_shard=int(part.per_shard), fanout=np.asarray(part.fanout),
        weights=np.asarray(part.weights), is_inh=np.asarray(part.is_inh),
        delays_steps=np.asarray(part.delays_steps))


def tables_from_reference(dest_of_addr, guid_of_addr, mcast_of_guid, *,
                          device=None) -> RoutingTables:
    """Routing tables (one shard's or stacked) from reference arrays
    (``device=None`` is CUDA, as everywhere in the port)."""
    device = dispatch.resolve_device(device)
    return RoutingTables(_t(dest_of_addr, device), _t(guid_of_addr, device),
                         _t(np.asarray(mcast_of_guid, np.uint32), device))


def tables_to_reference(tables: RoutingTables) -> dict[str, np.ndarray]:
    return {"dest_of_addr": tables.dest_of_addr.cpu().numpy(),
            "guid_of_addr": tables.guid_of_addr.cpu().numpy(),
            "mcast_of_guid": tables.mcast_of_guid.cpu().numpy().view(
                np.uint32)}


def state_from_reference(flat: dict, *, prefix: str = "",
                         device=None) -> ShardState:
    """Port ``ShardState`` from a flattened reference ``ShardState``
    (keys ``neuron.v`` ... ``t``, after ``prefix``).  It carries no
    generator: run it with an explicit drive."""
    device = dispatch.resolve_device(device)
    g = lambda k: flat[prefix + k]
    neuron = lif.LIFState(_t(g("neuron.v"), device),
                          _t(g("neuron.i_exc"), device),
                          _t(g("neuron.i_inh"), device),
                          _t(g("neuron.refrac"), device, torch.int32))
    ring = lambda k: _t(np.swapaxes(g(k), 0, 1), device)
    return ShardState(neuron, ring("ring_exc"), ring("ring_inh"),
                      _t(g("t"), device, torch.int32))


def carry_from_reference(flat: dict, link, *, device=None) -> SimCarry:
    """Port ``SimCarry`` from a flattened reference ``SimCarry``: state and
    pending buckets/residue converted, the buckets' wire payload encoded;
    ``link`` is the port's fabric state (the crossbar's is empty, so
    nothing is carried over)."""
    device = dispatch.resolve_device(device)
    g = lambda k: flat["pending." + k]
    data, meta = _t(g("data"), device), _t(g("meta"), device)
    pending = PendingWindow(data, meta, _t(g("counts"), device),
                            _t(g("residue"), device),
                            _t(g("residue_meta"), device),
                            wire.encode_planar(data, meta))
    return SimCarry(state_from_reference(flat, prefix="state.",
                                         device=device), pending, link)


def carry_to_reference(carry: SimCarry) -> dict[str, np.ndarray]:
    """Inverse of :func:`carry_from_reference`: the reference's keys,
    layouts and dtypes (rings ``(S, ring_len, per)``, words ``uint32``)."""
    out = {}
    st, pend = carry.state, carry.pending
    for name, x in zip(lif.LIFState._fields, st.neuron):
        out[f"state.neuron.{name}"] = x.cpu().numpy()
    out["state.ring_exc"] = np.swapaxes(st.ring_exc.cpu().numpy(), 0, 1)
    out["state.ring_inh"] = np.swapaxes(st.ring_inh.cpu().numpy(), 0, 1)
    out["state.t"] = st.t.cpu().numpy()
    for name in PendingWindow._fields:
        if name == "payload":                  # the port's alone
            continue
        a = getattr(pend, name).cpu().numpy()
        out[f"pending.{name}"] = (a.view(np.uint32)
                                  if name in ("data", "residue") else a)
    return out


def params_from_reference(tree, device=None) -> dict:
    """The port's parameters from a reference LM parameter tree given as
    numpy arrays (e.g. ``jax.tree_util.tree_map(np.asarray, params)``);
    dtypes are kept."""
    device = dispatch.resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return _t(tree, device)


_CACHES = {c._fields: c for c in (KVCache, SSMCache, RGLRUCache, RGCaches,
                                   WhisperCaches)}


def caches_from_reference(cache, device=None):
    """The port's LM caches from the reference's (numpy or JAX arrays):
    each cache NamedTuple becomes the port's type of the same fields
    (``KVCache``, ``SSMCache``, ``RGLRUCache``, ``RGCaches``,
    ``WhisperCaches``), dicts and tuples keep their structure."""
    device = dispatch.resolve_device(device)

    def rec(tree):
        if isinstance(tree, dict):
            return {name: rec(c) for name, c in tree.items()}
        fields = getattr(tree, "_fields", None)
        if fields is not None:
            if fields not in _CACHES:
                raise TypeError(f"no port cache with the fields {fields} "
                                f"of {type(tree).__name__}")
            return _CACHES[fields](*(rec(getattr(tree, f)) for f in fields))
        if isinstance(tree, (tuple, list)):
            return tuple(rec(c) for c in tree)
        return _t(tree, device)

    return rec(cache)


_OPT_STATES = {c._fields: c for c in (AdamWState, AdafactorState)}


def train_state_from_reference(state, device=None) -> dict:
    """The port's train state from the reference's (numpy or JAX arrays):
    params, the AdamW or Adafactor state (bf16 momentum bit for bit) and
    the step."""
    device = dispatch.resolve_device(device)
    opt = state["opt"]
    if opt._fields not in _OPT_STATES:
        raise TypeError(f"no port optimizer state with the fields "
                        f"{opt._fields}")
    return {"params": params_from_reference(state["params"], device),
            "opt": _OPT_STATES[opt._fields](*(
                params_from_reference(getattr(opt, f), device)
                for f in opt._fields)),
            "step": _t(state["step"], device)}


def _to_numpy(tree):
    """Tensors to numpy, bf16 as ``ml_dtypes.bfloat16`` (the reference's
    own type; imported only for such a leaf)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def train_state_to_reference(state) -> dict:
    """Inverse of :func:`train_state_from_reference`: numpy leaves, the
    optimizer state as the port's NamedTuple of the reference's fields
    (``RefState(*opt)`` makes the reference's type)."""
    opt = state["opt"]
    return {"params": _to_numpy(state["params"]),
            "opt": type(opt)(*(_to_numpy(v) for v in opt)),
            "step": _to_numpy(state["step"])}
