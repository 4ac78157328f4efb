"""The precision design of the tensor-core SSD-chunk kernel
(``src/repro_torch/csrc/ssd_chunk_tc.cu``), on the CPU.

The kernel multiplies bf16 operands on the tensor cores with f32
accumulation.  x, B and C arrive in bf16 and are exact there; the three f32
operands (the masked, decayed scores M, s_prev and B * w) are split into
hi = bf16(v) and lo = bf16(v - hi) and multiplied in two passes.
:func:`emulate_tc` repeats those roundings in plain torch: hi + lo is
exact in f32 and its products with a bf16 partner are exact too, so f32
products of the rounded operands are what the tensor cores sum.

* the split emulation holds ``ssd_chunk_plain`` and the JAX package's
  ``ref.ssd_chunk_ref`` (and its Pallas kernel in interpret mode) at
  rtol/atol 2e-4, the kernel's tolerance on the card, at the serving
  path's per-pair shape (c 256, P 64, N 128) and at two ragged shapes;
* one rounding of the same operands, to bf16 or to TF32, misses 2e-4:
  the reason for the split;
* the wrapper picks its kernel by dtype alone (``route``), and refuses
  shapes the tensor-core kernel cannot take.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops, ref as r_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels import ssd_chunk as t_ssd

TOL = 2e-4


def _inputs(bh, c, P, N, seed, bg=None):
    """bf16 x / B / C (the serving path's dtype) and f32 dt / A / s_prev,
    drawn with numpy as the kernel check on the card draws them."""
    rng = np.random.default_rng(seed)
    bg = bh if bg is None else bg
    bf = lambda a: a.astype(ml_dtypes.bfloat16)
    x = bf(rng.standard_normal((bh, c, P), dtype=np.float32))
    dt = np.log1p(np.exp(rng.standard_normal((bh, c)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(bh) * 0.3)).astype(np.float32)
    B = bf((rng.standard_normal((bg, c, N)) * 0.3).astype(np.float32))
    C = bf((rng.standard_normal((bg, c, N)) * 0.3).astype(np.float32))
    S = (rng.standard_normal((bh, P, N)) * 0.1).astype(np.float32)
    return x, dt, A, B, C, S


def _torch(ins):
    return [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a)
            for a in ins]


def _tf32(v):
    """``v`` rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = v.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _round(v, mode):
    """What the tensor cores see of f32 operand ``v``: "split" hi + lo
    (the kernel), "bf16" hi alone, "tf32" one TF32 rounding."""
    if mode == "tf32":
        return _tf32(v)
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float() if mode == "split" \
        else hi


def emulate_tc(x, dt, A, B, C, s_prev, mode="split"):
    """The kernel's arithmetic in plain torch: exact bf16 x / B / C, f32
    operands rounded by :func:`_round`, f32 products and sums."""
    x, B, C = x.float(), B.float(), C.float()
    rep = x.shape[0] // B.shape[0]
    B = B.repeat_interleave(rep, dim=0)
    C = C.repeat_interleave(rep, dim=0)
    cum = torch.cumsum(dt * A[:, None], dim=1)
    seg = cum[:, -1]
    c = x.shape[1]
    causal = torch.ones(c, c, dtype=torch.bool).tril()
    decay = torch.where(causal[None], torch.exp(cum[:, :, None]
                                                - cum[:, None, :]), 0.0)
    M = (C @ B.transpose(1, 2)) * decay * dt[:, None, :]
    y = _round(M, mode) @ x
    y = y + torch.exp(cum)[:, :, None] * (
        C @ _round(s_prev, mode).transpose(1, 2))
    w = torch.exp(seg[:, None] - cum) * dt
    s_loc = x.transpose(1, 2) @ _round(B * w[:, :, None], mode)
    return y, s_prev * torch.exp(seg)[:, None, None] + s_loc


def _rel(got, want):
    """max |got - want| / (1 + |want|): within TOL iff rtol = atol = TOL
    holds."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


@pytest.mark.parametrize("bh,c,P,N,bg", [
    (16, 256, 64, 128, None),       # the serving path's per-pair shape
    (6, 100, 80, 72, 2),            # ragged rows, P over one tile
    (4, 320, 48, 40, 2),            # ragged rows, P and N inside one tile
])
def test_split_emulation_holds_plain_and_reference_at_2e4(bh, c, P, N, bg):
    ins = _inputs(bh, c, P, N, seed=bh * c + P, bg=bg)
    t_ins = _torch(ins)
    got = emulate_tc(*t_ins)
    want_plain = t_ssd.ssd_chunk_plain(*t_ins)
    rep = lambda a: np.repeat(np.asarray(a, np.float32), bh // a.shape[0], 0)
    j_ins = [jnp.asarray(a) for a in (ins[0], ins[1], ins[2], rep(ins[3]),
                                      rep(ins[4]), ins[5])]
    want_ref = r_ref.ssd_chunk_ref(*j_ins)
    for g, wp, wr, name in zip(got, want_plain, want_ref, ("y", "s_new")):
        assert _rel(g, wp) <= TOL, (name, _rel(g, wp))
        assert _rel(g, wr) <= TOL, (name, _rel(g, wr))


def test_split_emulation_holds_reference_pallas_kernel():
    """The JAX package's own kernel, in interpret mode as its tests run it,
    at the path's per-pair shape."""
    ins = _inputs(2, 256, 64, 128, seed=7)
    got = emulate_tc(*_torch(ins))
    want = r_ops.ssd_chunk(*map(jnp.asarray, ins))
    for g, w, name in zip(got, want, ("y", "s_new")):
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize("mode,y_over", [("bf16", 10), ("tf32", 2)])
def test_single_rounding_misses_2e4(mode, y_over):
    """Rounding the three f32 operands once, to bf16 or to TF32, with the
    same exact partners, is outside the kernel's tolerance (y by more than
    ``y_over`` times): the split is needed."""
    t_ins = _torch(_inputs(16, 256, 64, 128, seed=16 * 256 + 64))
    want = t_ssd.ssd_chunk_plain(*t_ins)
    single = emulate_tc(*t_ins, mode=mode)
    split = emulate_tc(*t_ins)
    assert _rel(single[0], want[0]) > y_over * TOL
    assert _rel(single[1], want[1]) > TOL
    for s, w in zip(split, want):
        assert _rel(s, w) <= TOL / 4


def test_route_by_dtype_alone():
    bf16, f32 = torch.bfloat16, torch.float32
    assert t_ssd.route(bf16, bf16, bf16) == "ssd_chunk_tc"
    assert t_ssd.route(f32, f32, f32) == "ssd_chunk_f32"
    assert t_ssd.KERNELS["ssd_chunk_tc"] == ("ssd_chunk",
                                             "repro_ssd_chunk_tc")
    assert t_ssd.KERNELS["ssd_chunk_f32"] == ("ssd_chunk_f32",
                                              "repro_ssd_chunk")
    for mixed in ((bf16, f32, f32), (f32, bf16, f32), (f32, f32, bf16),
                  (torch.float16,) * 3, (torch.float64,) * 3):
        with pytest.raises(ValueError, match="ssd_chunk"):
            t_ssd.route(*mixed)


def test_wrapper_on_cpu_runs_plain_for_either_dtype_and_launches_nothing():
    t_ins = _torch(_inputs(4, 40, 16, 24, seed=3, bg=2))
    f_ins = [t.float() if t.dtype == torch.bfloat16 else t for t in t_ins]
    dispatch.reset_launches()
    for ins in (t_ins, f_ins):
        for fn in (t_ssd.ssd_chunk, t_ssd.ssd_chunk_tc, t_ssd.ssd_chunk_fma):
            got = fn(*ins)
            want = t_ssd.ssd_chunk_plain(*ins)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dispatch.LAUNCHES == {}


@pytest.mark.parametrize("P,N,ok", [
    (64, 128, True), (8, 16, True), (128, 128, True), (80, 72, True),
    (4, 16, False), (64, 4, False), (60, 128, False), (64, 136, False),
    (136, 64, False),
])
def test_tensor_core_shape_limits(P, N, ok):
    x, dt, A, B, C, S = _torch(_inputs(2, 8, P, N, seed=P * N))
    if ok:
        t_ssd._check_tc(x, B, C, S)
    else:
        with pytest.raises(ValueError, match="ssd_chunk_tc"):
            t_ssd._check_tc(x, B, C, S)


def test_tensor_core_kernel_refuses_misaligned_operands():
    x, dt, A, B, C, S = _torch(_inputs(2, 8, 64, 128, seed=1))
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
    shifted = flat.view(x.shape).copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="x is not 16-byte aligned"):
        t_ssd._check_tc(shifted, B, C, S)
