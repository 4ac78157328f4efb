"""64-bit spike wire-word codec, plain PyTorch (frozen from the port's
``wire/codec.py``).

``WireWordFormat`` lays fields LSB-first into a 64-bit word::

    [0, ts_bits)                         timestamp
    [ts_bits, +label_bits)               label (routable pulse address)
    [.., +meta_bits)                     meta (guid OR injection step)
    [ts_bits+label_bits+meta_bits]       valid flag

A word travels as two u32 lanes ``(lo, hi)``, held as ``int32`` bit
patterns; with the default widths meta straddles the lane boundary at
bit 29.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import events as ev

_U32 = 0xFFFFFFFF


class WireWordFormat(NamedTuple):
    """Field widths of the 64-bit wire word (LSB-first, see module doc)."""

    ts_bits: int = ev.TS_BITS          # 15
    label_bits: int = ev.ADDR_BITS     # 14
    meta_bits: int = 32

    @property
    def valid_bit(self) -> int:
        return self.ts_bits + self.label_bits + self.meta_bits

    @property
    def word_bytes(self) -> int:
        return 8

    def validate(self) -> "WireWordFormat":
        if not (1 <= self.ts_bits <= 32 and 1 <= self.label_bits <= 32
                and 0 <= self.meta_bits <= 32):
            raise ValueError(f"field widths out of range: {self}")
        if self.valid_bit > 63:
            raise ValueError(
                f"wire word overflows 64 bits: ts {self.ts_bits} + label "
                f"{self.label_bits} + meta {self.meta_bits} + valid > 64")
        return self


DEFAULT_WORD = WireWordFormat().validate()


def _mask(width: int) -> int:
    return ((1 << width) - 1) & _U32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its u32 value in int64."""
    return x.to(torch.int64) & _U32


def _bits(x: torch.Tensor) -> torch.Tensor:
    """u32 value in int64 -> int32 bit pattern."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain version: the reference's _deposit / _extract on int64 lanes.
# ---------------------------------------------------------------------------

def _deposit(lo, hi, v, offset: int, width: int):
    if width == 0:
        return lo, hi
    if offset < 32:
        lo = lo | ((v << offset) & _U32)
        if offset + width > 32:
            hi = hi | (v >> (32 - offset))
    else:
        hi = hi | ((v << (offset - 32)) & _U32)
    return lo, hi


def _extract(lo, hi, offset: int, width: int):
    if width == 0:
        return torch.zeros_like(lo)
    if offset < 32:
        v = lo >> offset
        if offset + width > 32:
            v = v | ((hi << (32 - offset)) & _U32)
    else:
        v = hi >> (offset - 32)
    return v & _mask(width)


def encode_plain(word: torch.Tensor, meta: torch.Tensor,
                 fmt: WireWordFormat = DEFAULT_WORD):
    """int32 event words + int32 meta -> (lo, hi) int32 lanes."""
    word, meta = _u32(word), _u32(meta)
    ts = word & (ev.TS_MASK & _mask(fmt.ts_bits))
    label = (word >> ev.TS_BITS) & (ev.ADDR_MASK & _mask(fmt.label_bits))
    valid = (word >> (ev.TS_BITS + ev.ADDR_BITS)) & 1
    meta = meta & _mask(fmt.meta_bits)
    lo = torch.zeros_like(word)
    hi = torch.zeros_like(word)
    lo, hi = _deposit(lo, hi, ts, 0, fmt.ts_bits)
    lo, hi = _deposit(lo, hi, label, fmt.ts_bits, fmt.label_bits)
    lo, hi = _deposit(lo, hi, meta, fmt.ts_bits + fmt.label_bits,
                      fmt.meta_bits)
    lo, hi = _deposit(lo, hi, valid, fmt.valid_bit, 1)
    return _bits(lo), _bits(hi)


def decode_plain(lo: torch.Tensor, hi: torch.Tensor,
                 fmt: WireWordFormat = DEFAULT_WORD):
    """(lo, hi) int32 lanes -> (int32 event words, int32 meta)."""
    lo, hi = _u32(lo), _u32(hi)
    ts = _extract(lo, hi, 0, fmt.ts_bits) & ev.TS_MASK
    label = _extract(lo, hi, fmt.ts_bits, fmt.label_bits) & ev.ADDR_MASK
    meta = _extract(lo, hi, fmt.ts_bits + fmt.label_bits, fmt.meta_bits)
    valid = _extract(lo, hi, fmt.valid_bit, 1)
    word = ts | (label << ev.TS_BITS) | (valid << (ev.TS_BITS
                                                   + ev.ADDR_BITS))
    return _bits(word), _bits(meta)


def encode_planar(events: torch.Tensor, meta: torch.Tensor,
                  fmt: WireWordFormat = DEFAULT_WORD) -> torch.Tensor:
    """(..., C) int32 events + meta -> one (..., 2C) int32 wire buffer:
    ``buf[..., :C]`` are the lo lanes, ``buf[..., C:]`` the hi lanes."""
    if events.shape != meta.shape:
        raise ValueError(f"events {tuple(events.shape)} != meta "
                         f"{tuple(meta.shape)}")
    return torch.cat(encode_plain(events, meta, fmt), dim=-1)


def decode_planar(buf: torch.Tensor, fmt: WireWordFormat = DEFAULT_WORD):
    """Inverse of :func:`encode_planar` -> (int32 events, int32 meta)."""
    cols = buf.shape[-1] // 2
    return decode_plain(buf[..., :cols], buf[..., cols:], fmt)
