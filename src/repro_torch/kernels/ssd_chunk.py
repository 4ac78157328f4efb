"""One Mamba-2 SSD chunk (port of ``src/repro/kernels/ssd_chunk.py``).

:func:`ssd_chunk` launches the hand-written kernel ``csrc/ssd_chunk.cu`` on
CUDA tensors and runs :func:`ssd_chunk_plain` (the port of
``kernels/ref.py:ssd_chunk_ref``) on CPU tensors.  Both compute in f32
whatever the inputs' dtype and return f32 outputs.

Groups: ``B`` and ``C`` may hold one row block per group instead of one
per pair (``BH % BG == 0``); pair ``g`` then reads row block
``g // (BH // BG)``, which is the head -> group map of ``models/ssm.py``
when pairs are laid out batch-major, head-minor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

MAX_CHUNK = 16384      # shared memory holds dt and cum of one chunk


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
    decay = torch.where(causal[None], torch.exp(diff), 0.0)
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


def ssd_chunk(x, dt, A, B, C, s_prev):
    """One chunk for all (batch, head) pairs -> (y, s_new), both f32.

    On CUDA: x, B, C contiguous f32 or bf16 (one dtype); dt, A, s_prev
    contiguous f32; one kernel launch.  On the CPU: the plain version.
    """
    if not dispatch.on_cuda(x, dt, A, B, C, s_prev):
        return ssd_chunk_plain(x, dt, A, B, C, s_prev)
    rep = _check(x, dt, A, B, C, s_prev)
    bh, c, p = x.shape
    n = B.shape[2]
    y = torch.empty((bh, c, p), dtype=torch.float32, device=x.device)
    s_new = torch.empty((bh, p, n), dtype=torch.float32, device=x.device)
    if bh == 0:
        return y, s_new
    dispatch.launch("ssd_chunk", "repro_ssd_chunk", x.data_ptr(),
                    dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                    s_prev.data_ptr(), y.data_ptr(), s_new.data_ptr(), bh,
                    rep, c, p, n, int(x.dtype == torch.bfloat16))
    return y, s_new
