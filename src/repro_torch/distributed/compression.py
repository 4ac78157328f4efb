"""Gradient compression: int8 error-feedback all-reduce (port of
``src/repro/distributed/compression.py``), the parties a leading tensor
dimension.

Each party quantizes its gradient (plus the residual it kept from the
last step) to int8 with a per-tensor scale; the int8 payloads are summed
as int32 and the scales summed; the mean gradient is the int32 sum times
the mean scale over the party count, and each party keeps its own
quantization residual as error feedback for the next step (Karimireddy
et al., 2019).  The reference sums with ``psum`` inside ``shard_map``;
here the parties are reduced one after another, so that one party's f32
temporaries are alive at a time.  ``torch.round`` rounds half to even,
as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd


def quantize(g, err):
    """(g + err) -> int8 payload, scale, new residual, per party:
    g, err: (n, ...); the scale is (n,) (each party's max |g + err| /
    127, plus 1e-12)."""
    g32 = g.float() + err
    amax = g32.abs().reshape(g32.shape[0], -1).amax(dim=1)
    scale = amax / 127.0 + 1e-12
    s = scale.view(-1, *([1] * (g32.dim() - 1)))
    q = torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8)
    deq = q.float() * s
    return q, scale, g32 - deq


def dequantize(q_sum, scale_sum, n_parties: int):
    """The mean of the parties' dequantized tensors: the int32 sum times
    the mean scale, over the party count."""
    return q_sum.float() * (scale_sum / n_parties) / n_parties


def _reduce(parties, n: int, keep_all: bool = True):
    """Quantize the parties' (g, err) pairs one at a time, summing the
    int8 payloads as int32 and the scales.  Returns (the mean, the
    residuals: every party's, or only the first's)."""
    q_sum = s_sum = None
    errs = []
    for g, e in parties:
        q, scale, new_err = quantize(g[None], e[None])
        q = q[0].to(torch.int32)
        q_sum = q if q_sum is None else q_sum + q
        s_sum = scale[0] if s_sum is None else s_sum + scale[0]
        if keep_all or not errs:
            errs.append(new_err[0])
    return dequantize(q_sum, s_sum, n), errs


def compressed_psum(g, err):
    """Error-feedback int8 all-reduce over the parties.  g, err: (n, ...).
    Returns (the mean gradient (...), in g's dtype, the same for every
    party; the new residuals (n, ...))."""
    mean, errs = _reduce(zip(g, err), g.shape[0])
    return mean.to(g.dtype), torch.stack(errs)


def make_compressed_allreduce(mesh, axis_names=("pod",)):
    """Tree-level wrapper: (grads, err_tree) -> (grads, err_tree), for the
    gradient sync over ``axis_names`` of ``mesh`` (the reference's
    cross-pod sync).  Every party holds the same gradients and residuals
    (the reference's replicated ``P()`` inputs), so each leaf is reduced
    over ``n`` copies of itself and the first party's residual returned
    (``out_specs=P()`` returns one party's)."""
    n = mesh.axis_size(tuple(axis_names))

    def one(g, e):
        mean, errs = _reduce(((g, e) for _ in range(n)), n, keep_all=False)
        return mean.to(g.dtype), errs[0]

    def apply(grads, errs):
        out = shd.tree_map(one, grads, errs)
        return _pick(out, 0), _pick(out, 1)

    return apply


def _pick(tree, i: int):
    """Item ``i`` of every (mean, residual) pair of a nested dict."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def init_error_feedback(params):
    """Zero f32 residuals like ``params``."""
    return shd.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
