"""One Mamba-2 SSD chunk (port of ``src/repro/kernels/ssd_chunk.py``).

:func:`ssd_chunk` picks its route by the dtype of x, B and C and nothing
else (:func:`route`): on CUDA, bf16 (the serving path) launches the
tensor-core kernel ``csrc/ssd_chunk_tc.cu`` and f32 the FMA kernel
``csrc/ssd_chunk.cu``; CPU tensors run :func:`ssd_chunk_plain` (the port
of ``kernels/ref.py:ssd_chunk_ref``).  All compute in f32 and return f32
outputs.  A shape the chosen kernel cannot take raises; nothing falls back
to another kernel or to the plain version.

Training: :func:`ssd_chunk_grad` is :func:`ssd_chunk` under autograd (a
``torch.autograd.Function``).  Its forward is the same route (the kernel on
the card, the plain version on the CPU); its backward recomputes
:func:`ssd_chunk_plain` from the saved inputs and returns that version's
vjp, in plain PyTorch by design: the reference differentiates its ``jnp``
scan and has no backward kernel to port.  The kernel's outputs carry no
``grad_fn`` of their own (they are filled through ctypes), so a caller that
needs gradients goes through this function.

Groups: ``B`` and ``C`` may hold one row block per group instead of one
per pair (``BH % BG == 0``); pair ``g`` then reads row block
``g // (BH // BG)``, which is the head -> group map of ``models/ssm.py``
when pairs are laid out batch-major, head-minor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

MAX_CHUNK = 16384      # shared memory holds dt and cum of one chunk
TC_MAX_WIDTH = 128     # P and N of the tensor-core kernel: 2 tiles of 64
# route -> (launch counter, C entry point)
KERNELS = {"ssd_chunk_tc": ("ssd_chunk", "repro_ssd_chunk_tc"),
           "ssd_chunk_f32": ("ssd_chunk_f32", "repro_ssd_chunk")}


def ssd_chunk_plain(x, dt, A, B, C, s_prev):
    """Plain PyTorch version: x (BH, c, P); dt (BH, c); A (BH,) negative;
    B, C (BG, c, N); s_prev (BH, P, N) -> (y (BH, c, P), s_new (BH, P, N)),
    f32."""
    x, dt, A, B, C, s_prev = (t.float() for t in (x, dt, A, B, C, s_prev))
    rep = x.shape[0] // B.shape[0]
    if rep > 1:
        B = B.repeat_interleave(rep, dim=0)
        C = C.repeat_interleave(rep, dim=0)
    cum = torch.cumsum(dt * A[:, None], dim=1)                 # (BH, c)
    seg = cum[:, -1]
    c_len = x.shape[1]
    causal = torch.ones(c_len, c_len, dtype=torch.bool,
                        device=x.device).tril()
    diff = cum[:, :, None] - cum[:, None, :]
    # the exponent is masked, not its result: above the diagonal diff
    # grows with the chunk (past f32's exp range at c = 256), and the vjp
    # of where(causal, exp(diff), 0) there is 0 * inf = NaN
    decay = torch.exp(torch.where(causal[None], diff, -torch.inf))
    scores = C @ B.transpose(1, 2)                             # (BH, c, c)
    y = (scores * decay * dt[:, None, :]) @ x
    y = y + (C * torch.exp(cum)[:, :, None]) @ s_prev.transpose(1, 2)
    w = torch.exp(seg[:, None] - cum) * dt
    s_loc = x.transpose(1, 2) @ (B * w[:, :, None])            # (BH, P, N)
    s_new = s_prev * torch.exp(seg)[:, None, None] + s_loc
    return y, s_new


def _check(x, dt, A, B, C, s_prev) -> int:
    """Validate the kernel's operands; return the group repeat."""
    bh, c, p = x.shape
    bg, n = B.shape[0], B.shape[2]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_chunk: x must be f32 or bf16, got {x.dtype}")
    if not 1 <= c <= MAX_CHUNK or p < 1 or n < 1:
        raise ValueError(f"ssd_chunk: chunk {c} outside 1..{MAX_CHUNK}, or "
                         f"an empty head ({p}) or state ({n})")
    if bg == 0 or bh % bg:
        raise ValueError(f"ssd_chunk: {bh} pairs do not split into {bg} "
                         f"groups")
    for name, t, shape, dtype in (
            ("x", x, (bh, c, p), x.dtype), ("dt", dt, (bh, c), torch.float32),
            ("A", A, (bh,), torch.float32), ("B", B, (bg, c, n), x.dtype),
            ("C", C, (bg, c, n), x.dtype),
            ("s_prev", s_prev, (bh, p, n), torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return bh // bg


def route(x_dtype, b_dtype, c_dtype) -> str:
    """The kernel that takes these operands on the card, by dtype alone:
    bf16 x, B, C -> ``ssd_chunk_tc``, f32 -> ``ssd_chunk_f32``; raises on
    a mix or on any other dtype."""
    dtypes = {x_dtype, b_dtype, c_dtype}
    if dtypes == {torch.bfloat16}:
        return "ssd_chunk_tc"
    if dtypes == {torch.float32}:
        return "ssd_chunk_f32"
    raise ValueError(f"ssd_chunk: x, B and C must all be bf16 or all f32, "
                     f"got {x_dtype}, {b_dtype}, {c_dtype}")


def _check_tc(x, B, C, s_prev) -> None:
    """Raise on what the tensor-core kernel cannot take: P and N outside
    8..TC_MAX_WIDTH or not multiples of 8 (TMA's 16-byte row stride), or
    operands that are not 16-byte aligned."""
    p, n = x.shape[2], B.shape[2]
    for name, v in (("P", p), ("N", n)):
        if not 8 <= v <= TC_MAX_WIDTH or v % 8:
            raise ValueError(f"ssd_chunk_tc: {name} = {v} must be a "
                             f"multiple of 8 in 8..{TC_MAX_WIDTH}")
    for name, t in (("x", x), ("B", B), ("C", C), ("s_prev", s_prev)):
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_chunk_tc: {name} is not 16-byte aligned")


def _launch(kernel, rep, x, dt, A, B, C, s_prev, *extra):
    bh, c, p = x.shape
    n = B.shape[2]
    y = torch.empty((bh, c, p), dtype=torch.float32, device=x.device)
    s_new = torch.empty((bh, p, n), dtype=torch.float32, device=x.device)
    if bh == 0:
        return y, s_new
    counter, symbol = KERNELS[kernel]
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), s_prev.data_ptr(), y.data_ptr(), s_new.data_ptr(),
            bh, rep, c, p, n, *extra)
    dispatch.launch(counter, symbol, *args)
    return y, s_new


def ssd_chunk_tc(x, dt, A, B, C, s_prev):
    """The tensor-core kernel (bf16 x, B, C) on CUDA tensors; the plain
    version on CPU tensors."""
    if not dispatch.on_cuda(x, dt, A, B, C, s_prev):
        return ssd_chunk_plain(x, dt, A, B, C, s_prev)
    rep = _check(x, dt, A, B, C, s_prev)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ssd_chunk_tc: x, B and C must be bf16, got "
                         f"{x.dtype}")
    _check_tc(x, B, C, s_prev)
    return _launch("ssd_chunk_tc", rep, x, dt, A, B, C, s_prev)


def ssd_chunk_fma(x, dt, A, B, C, s_prev):
    """The f32 FMA kernel (f32 or bf16 x, B, C) on CUDA tensors; the plain
    version on CPU tensors."""
    if not dispatch.on_cuda(x, dt, A, B, C, s_prev):
        return ssd_chunk_plain(x, dt, A, B, C, s_prev)
    rep = _check(x, dt, A, B, C, s_prev)
    return _launch("ssd_chunk_f32", rep, x, dt, A, B, C, s_prev,
                   int(x.dtype == torch.bfloat16))


def ssd_chunk(x, dt, A, B, C, s_prev):
    """One chunk for all (batch, head) pairs -> (y, s_new), both f32.

    On CUDA: x, B, C contiguous, all bf16 (the tensor-core kernel) or all
    f32 (the FMA kernel); dt, A, s_prev contiguous f32; one kernel launch.
    On the CPU: the plain version.
    """
    if not dispatch.on_cuda(x, dt, A, B, C, s_prev):
        return ssd_chunk_plain(x, dt, A, B, C, s_prev)
    kernel = route(x.dtype, B.dtype, C.dtype)
    return (ssd_chunk_tc if kernel == "ssd_chunk_tc" else ssd_chunk_fma)(
        x, dt, A, B, C, s_prev)


class _SSDChunk(torch.autograd.Function):
    """Kernel E forward, the plain version's vjp backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, s_prev):
        ctx.save_for_backward(x, dt, A, B, C, s_prev)
        return ssd_chunk(x, dt, A, B, C, s_prev)

    @staticmethod
    def backward(ctx, g_y, g_s):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = ssd_chunk_plain(*inputs)
        grads = iter(torch.autograd.grad(
            outs, [t for t in inputs if t.requires_grad], (g_y, g_s)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def ssd_chunk_grad(x, dt, A, B, C, s_prev):
    """:func:`ssd_chunk` with a gradient: the kernel (or, on the CPU, the
    plain version) forward; the backward is the plain version's vjp from
    the saved inputs, each input's gradient in its own dtype."""
    return _SSDChunk.apply(x, dt, A, B, C, s_prev)
