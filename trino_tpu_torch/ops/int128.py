"""Int128 arithmetic on two int64 limbs: the port's counterpart of
``trino_tpu.ops.int128`` (ref: spi/type/Int128.java:23 and Int128Math.java),
the long-decimal representation behind DECIMAL(p>18).

A column's data carries the two limbs on a trailing axis, shape (cap, 2) =
[hi, lo], so every row operation is elementwise int64 work and the
permutation, slice and concatenation machinery runs unchanged on axis 0.

Conventions, as in the reference: hi is signed (the top half of the
two's-complement value), lo the raw low 64 bits in int64 storage (unsigned
semantics through xor-MIN compares). int64 multiplies and adds wrap mod
2**64 in torch as in XLA. The division helpers need a divisor below 2**31,
so schoolbook division over 32-bit digits stays inside exact int64; powers
of ten chain in steps of 10**9.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MIN64 = int(np.iinfo(np.int64).min)
_MASK32 = 0xFFFFFFFF


def hi(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0]


def lo(x: torch.Tensor) -> torch.Tensor:
    return x[..., 1]


def make(hi_: torch.Tensor, lo_: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi_.to(torch.int64), lo_.to(torch.int64)], dim=-1)


def from_int64(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    return make(x >> 63, x)  # arithmetic shift sign-extends


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned < over int64 storage."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    l = lo(a) + lo(b)  # wraps mod 2**64
    carry = _ult(l, lo(a)).to(torch.int64)
    return make(hi(a) + hi(b) + carry, l)


def negate(a: torch.Tensor) -> torch.Tensor:
    borrow = (lo(a) != 0).to(torch.int64)
    return make(-hi(a) - borrow, -lo(a))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return add(a, negate(b))


def is_negative(a: torch.Tensor) -> torch.Tensor:
    return hi(a) < 0


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return make(torch.where(cond, hi(a), hi(b)), torch.where(cond, lo(a), lo(b)))


def abs_(a: torch.Tensor) -> torch.Tensor:
    return _select(is_negative(a), negate(a), a)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (hi(a) == hi(b)) & (lo(a) == lo(b))


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (hi(a) < hi(b)) | ((hi(a) == hi(b)) & _ult(lo(a), lo(b)))


def lte(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lt(a, b) | eq(a, b)


def _shr32(x: torch.Tensor) -> torch.Tensor:
    """Logical right shift by 32 (torch's ``>>`` is arithmetic: the partial
    products wrap negative and would smear the sign bit)."""
    return (x >> 32) & _MASK32


def _mul_64x64(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned 64x64 -> (hi, lo) by four 32x32 partial products."""
    x0, x1 = x & _MASK32, _shr32(x)
    y0, y1 = y & _MASK32, _shr32(y)
    p00 = x0 * y0
    p01 = x0 * y1
    p10 = x1 * y0
    p11 = x1 * y1
    mid = _shr32(p00) + (p01 & _MASK32) + (p10 & _MASK32)
    lo_ = (p00 & _MASK32) | ((mid & _MASK32) << 32)
    hi_ = p11 + _shr32(p01) + _shr32(p10) + _shr32(mid)
    return hi_, lo_


def mul_int64(a: torch.Tensor, k) -> torch.Tensor:
    """int128 * int64 keeping the low 128 bits (results fit p <= 38)."""
    k = torch.as_tensor(k, dtype=torch.int64, device=a.device)
    ph, pl = _mul_64x64(lo(a), k)
    # k < 0 read as unsigned overcounts by 2**64 * lo(a): take it back
    h = ph + hi(a) * k - torch.where(k < 0, lo(a), torch.zeros_like(lo(a)))
    return make(h, pl)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int128 * int128 keeping the low 128 bits."""
    ph, pl = _mul_64x64(lo(a), lo(b))
    return make(ph + hi(a) * lo(b) + lo(a) * hi(b), pl)


def _digits(a: torch.Tensor):
    return [(hi(a) >> 32) & _MASK32, hi(a) & _MASK32, (lo(a) >> 32) & _MASK32,
            lo(a) & _MASK32]


def _long_divide(a: torch.Tensor, d):
    """Non-negative int128 // d over four 32-bit digits, d < 2**31 (a scalar
    or a tensor): (quotient, remainder)."""
    r = torch.zeros_like(hi(a))
    qs = []
    for dig in _digits(a):
        cur = (r << 32) | dig
        qs.append(torch.div(cur, d, rounding_mode="floor"))
        r = cur - qs[-1] * d
    return make((qs[0] << 32) | qs[1], (qs[2] << 32) | qs[3]), r


def divmod_u32(a: torch.Tensor, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-negative int128 // d and remainder, d < 2**31."""
    assert 0 < d < (1 << 31), d
    return _long_divide(a, d)


def div_round_pow10(a: torch.Tensor, k: int) -> torch.Tensor:
    """a / 10**k, round-half-up on the magnitude (Int128Math.rescale)."""
    if k == 0:
        return a
    neg = is_negative(a)
    m = abs_(a)
    left = k
    while left > 0:
        step = min(left, 9)
        d = 10**step
        m, r = divmod_u32(m, d)
        if left - step == 0:
            m = add(m, from_int64((2 * r >= d).to(torch.int64)))
        left -= step
    return _select(neg, negate(m), m)


def div_int(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """a / d (round-half-up on the magnitude) for positive tensor divisors
    below 2**31: the decimal AVG denominator."""
    dd = d.to(torch.int64).clamp(min=1)
    neg = is_negative(a)
    q, r = _long_divide(abs_(a), dd)
    q = add(q, from_int64((2 * r >= dd).to(torch.int64)))
    return _select(neg, negate(q), q)


def scale_up_pow10(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * 10**k, chained in exact steps."""
    out = a
    left = k
    while left > 0:
        step = min(left, 18)
        out = mul_int64(out, 10**step)
        left -= step
    return out


def to_float64(a: torch.Tensor) -> torch.Tensor:
    """Sign and magnitude, so values near zero do not cancel."""
    neg = is_negative(a)
    m = abs_(a)
    ulo = lo(m).to(torch.float64) + torch.where(lo(m) < 0, 2.0**64, 0.0).to(torch.float64)
    f = hi(m).to(torch.float64) * (2.0**64) + ulo
    return torch.where(neg, -f, f)


def fits_int64(a: torch.Tensor) -> torch.Tensor:
    """Where the value is representable as int64 (hi is lo's sign)."""
    return hi(a) == (lo(a) >> 63)


def order_key_pair(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(primary, secondary) int64 sort keys: signed hi, then lo in signed
    order."""
    return hi(a), lo(a) ^ _MIN64


# ------------------------------------------------------------------ host side


def np_from_ints(vals) -> np.ndarray:
    """Host: python ints -> (n, 2) int64 limbs."""

    def signed(x: int) -> int:
        return (x + 2**63) % 2**64 - 2**63

    hi_ = np.array([signed(int(v) >> 64) for v in vals], dtype=np.int64)
    lo_ = np.array([signed(int(v) & ((1 << 64) - 1)) for v in vals], dtype=np.int64)
    return np.stack([hi_, lo_], axis=-1)


def np_to_ints(limbs: np.ndarray) -> list:
    """Host: (n, 2) limbs -> python ints."""
    return [(int(h) << 64) | (int(l) & ((1 << 64) - 1)) for h, l in limbs]
