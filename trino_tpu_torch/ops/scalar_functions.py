"""The scalar function table: plain torch functions of column tensors.

The port's counterpart of ``trino_tpu.ops.compiler``'s ``_SIMPLE_FUNCS``
and its helpers (operator/scalar/MathFunctions.java, BitwiseFunctions.java,
DateTimeFunctions.java). Every entry is ``fn(datas, arg_types, out_type)``
over full-capacity data tensors; the compiler ANDs the arguments'
validities and casts the result to the output type's storage dtype, as the
reference does. The reference's semantics are kept where they differ from
Trino (ROADMAP Queue 3): ``round`` ties go to even, integral division and
modulus by zero give 0, DOUBLE ``%`` is a floor modulus.

Dates are days since the epoch (int32), TIMESTAMP is microseconds (int64),
TIME is microseconds of the day, and the two zoned types pack the UTC
instant above a 12-bit zone key (``offset minutes + 841``): TIMESTAMP WITH
TIME ZONE as ``utc_millis << 12 | key``, TIME WITH TIME ZONE as
``utc_micros_of_day << 12 | key``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..spi.types import (
    DATE,
    INTERVAL_DAY_TIME,
    INTERVAL_YEAR_MONTH,
    DecimalType,
    TimestampWithTimeZoneType,
    TimeType,
    TimeWithTimeZoneType,
    Type,
    is_integral,
)
from .kernels import _shift_right_logical

DAY_MICROS = 86_400_000_000


class CompileError(ValueError):
    """An expression the compiler cannot lower (raised at compile time, or
    at run time by an entry that has no lowering for its inputs)."""


# --------------------------------------------------------------------------- #
# arithmetic and comparison
# --------------------------------------------------------------------------- #


def _true_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` in the reference's promotion: floats keep their width,
    integers divide in float64 (torch alone would pick float32)."""
    if not (a.dtype.is_floating_point and b.dtype.is_floating_point):
        a, b = a.to(torch.float64), b.to(torch.float64)
    return a / b


def _arith(name: str):
    """``+ - * / %`` over numbers, and the DATE +- INTERVAL DAY TO SECOND and
    DATE - DATE forms. Integral division truncates toward zero over ``|b|``
    clipped to 1 (a zero divisor gives 0); integral and decimal ``%`` takes
    the dividend's sign; floating ``%`` is the floor modulus."""

    def impl(d, t, o):
        a, b = d
        at, bt = t
        if at == DATE and bt == INTERVAL_DAY_TIME:
            days = torch.div(b, DAY_MICROS, rounding_mode="floor")
            return (a + days if name == "$add" else a - days).to(torch.int32)
        if at == DATE and bt == DATE and name == "$subtract":
            return (a.to(torch.int64) - b.to(torch.int64)) * DAY_MICROS
        if at == DATE and bt == INTERVAL_YEAR_MONTH:
            raise CompileError(
                "date +/- year-month interval over columns not supported yet "
                "(constant-folded when both sides are literals)"
            )
        if name == "$add":
            return a + b
        if name == "$subtract":
            return a - b
        if name == "$multiply":
            return a * b
        if name == "$divide":
            if is_integral(o):
                q = torch.div(a.abs(), b.abs().clamp(min=1), rounding_mode="floor")
                return q * (a.sign() * b.sign())
            return _true_divide(a, b)
        if isinstance(o, DecimalType) or is_integral(o):
            return torch.remainder(a.abs(), b.abs().clamp(min=1)) * a.sign()
        return torch.remainder(a, b)

    return impl


def _cmp_norm(x: torch.Tensor, t: Type) -> torch.Tensor:
    """Comparison key: the zoned types compare by instant, so the zone key
    is shifted out."""
    if isinstance(t, (TimestampWithTimeZoneType, TimeWithTimeZoneType)):
        return x >> 12
    return x


_COMPARE = {
    "$eq": lambda a, b: a == b,
    "$ne": lambda a, b: a != b,
    "$lt": lambda a, b: a < b,
    "$lte": lambda a, b: a <= b,
    "$gt": lambda a, b: a > b,
    "$gte": lambda a, b: a >= b,
}


def _cmp_op(name: str):
    op = _COMPARE[name]
    return lambda d, t, o: op(_cmp_norm(d[0], t[0]), _cmp_norm(d[1], t[1]))


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _to_f64(x: torch.Tensor, t: Type) -> torch.Tensor:
    """A numeric argument as DOUBLE (a decimal divided by its scale)."""
    x = x.to(torch.float64)
    return x / float(10**t.scale) if isinstance(t, DecimalType) else x


def _civil_from_days(z: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day), int64; Howard Hinnant's
    integer-only algorithm (floor division throughout)."""
    z = z.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> days since 1970-01-01 (the inverse of
    :func:`_civil_from_days`)."""
    y = y - (m <= 2).to(y.dtype)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _days_of(x: torch.Tensor, t: Type) -> torch.Tensor:
    """Days since the epoch of a DATE, a TIMESTAMP, or a TIMESTAMP WITH TIME
    ZONE read in the value's own zone."""
    if t == DATE:
        return x
    if isinstance(t, TimestampWithTimeZoneType):
        local_millis = (x >> 12) + ((x & 0xFFF) - 841) * 60_000
        return torch.div(local_millis, 86_400_000, rounding_mode="floor")
    return torch.div(x, DAY_MICROS, rounding_mode="floor")


def _micros_of_day(x: torch.Tensor, t: Type) -> torch.Tensor:
    """Local microseconds of the day of a TIME, TIME WITH TIME ZONE,
    TIMESTAMP or TIMESTAMP WITH TIME ZONE."""
    if isinstance(t, TimeType):
        return x
    if isinstance(t, TimeWithTimeZoneType):
        local = (x >> 12) + ((x & 0xFFF) - 841) * 60_000_000
        return torch.remainder(local, DAY_MICROS)
    if isinstance(t, TimestampWithTimeZoneType):
        local_millis = (x >> 12) + ((x & 0xFFF) - 841) * 60_000
        return torch.remainder(local_millis, 86_400_000) * 1000
    return torch.remainder(x, DAY_MICROS)


def _day_of_week(days: torch.Tensor) -> torch.Tensor:
    """ISO day of the week, Monday 1 .. Sunday 7 (the epoch was a Thursday)."""
    return torch.remainder(days.to(torch.int64) + 3, 7) + 1


def _day_of_year(days: torch.Tensor) -> torch.Tensor:
    y, _, _ = _civil_from_days(days)
    one = torch.ones_like(y)
    return days.to(torch.int64) - _days_from_civil(y, one, one) + 1


def _iso_week_year(days: torch.Tensor):
    """ISO-8601 week number and week-based year."""
    y, _, _ = _civil_from_days(days)
    doy = _day_of_year(days)
    w = (doy - _day_of_week(days) + 10) // 7

    def weeks_in(yy):
        one = torch.ones_like(yy)
        jd = _day_of_week(_days_from_civil(yy, one, one))
        leap = ((yy % 4 == 0) & (yy % 100 != 0)) | (yy % 400 == 0)
        return 52 + ((jd == 4) | (leap & (jd == 3))).to(torch.int64)

    last = weeks_in(y)
    week = torch.where(w < 1, weeks_in(y - 1), torch.where(w > last, 1, w))
    wyear = torch.where(w < 1, y - 1, torch.where(w > last, y + 1, y))
    return week, wyear


def _last_day_of_month(days: torch.Tensor) -> torch.Tensor:
    y, m, _ = _civil_from_days(days)
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, 1, m + 1)
    return (_days_from_civil(ny, nm, torch.ones_like(nm)) - 1).to(torch.int32)


def _decimal_ceil(x: torch.Tensor, t: DecimalType) -> torch.Tensor:
    f = 10**t.scale
    return torch.where(x >= 0, (x + f - 1) // f, -((-x) // f)) * f


def _decimal_floor(x: torch.Tensor, t: DecimalType) -> torch.Tensor:
    f = 10**t.scale
    return torch.where(x >= 0, x // f, -((-x + f - 1) // f)) * f


def _round_n(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    # ties to even, as the reference's jnp.round
    p = torch.pow(10.0, n.to(torch.float64))
    return torch.round(x * p) / p


def _truncate_n(x: torch.Tensor, n: torch.Tensor, t: Type) -> torch.Tensor:
    scale = torch.pow(10.0, n.to(torch.float64))
    return torch.trunc(_to_f64(x, t) * scale) / scale


def _width_bucket(x, lo, hi, n):
    nb = n.to(torch.int64).clamp(min=1)
    frac = (x - lo) / torch.where(hi != lo, hi - lo, 1.0)
    b = torch.floor(frac * nb.to(torch.float64)).to(torch.int64) + 1
    return torch.minimum(b.clamp(min=0), nb + 1)


def _shift_right_logical_by(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bits by a per-row count in [0, 63]."""
    mask = torch.where(s == 0, -1, (1 << (64 - s).clamp(max=63)) - 1)
    return (x >> s) & mask


def _bit_count(x: torch.Tensor, bits) -> torch.Tensor:
    """Popcount by the SWAR ladder, of the low ``bits`` bits when given."""
    v = x
    if bits is not None:
        width = bits.to(torch.int64).clamp(2, 64)
        mask = torch.where(width >= 64, -1, (1 << width.clamp(max=63)) - 1)
        v = v & mask
    c = v - (_shift_right_logical(v, 1) & 0x5555555555555555)
    c = (c & 0x3333333333333333) + (_shift_right_logical(c, 2) & 0x3333333333333333)
    c = (c + _shift_right_logical(c, 4)) & 0x0F0F0F0F0F0F0F0F
    return _shift_right_logical(c * 0x0101010101010101, 56)


def _as_signed(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def _hash64_combine(datas) -> torch.Tensor:
    """The reference's 64-bit mix of its arguments (wrapping int64
    multiplies and logical shifts carry the uint64 arithmetic)."""
    c1, c2 = _as_signed(0xFF51AFD7ED558CCD), _as_signed(0xC4CEB9FE1A85EC53)
    fnv = 0x100000001B3
    acc = None
    for d in datas:
        x = d.to(torch.int64)
        x = (x ^ _shift_right_logical(x, 33)) * c1
        x = (x ^ _shift_right_logical(x, 33)) * c2
        x = x ^ _shift_right_logical(x, 33)
        acc = (torch.full_like(x, _as_signed(0x9E3779B97F4A7C15)) if acc is None else acc)
        acc = (acc ^ x) * fnv
    return acc


def _nary(op, datas):
    out = datas[0]
    for d in datas[1:]:
        out = op(out, d)
    return out


def _wilson(d, lower: bool):
    """Wilson score interval bound (scalar/WilsonInterval.java)."""
    n_s, n, z = d
    nn = n.clamp(min=1.0)
    p = n_s / nn
    z2 = z * z
    denom = 1.0 + z2 / nn
    center = p + z2 / (2.0 * nn)
    spread = z * torch.sqrt((p * (1.0 - p) + z2 / (4.0 * nn)) / nn)
    return (center - spread if lower else center + spread) / denom


# --------------------------------------------------------------------------- #
# distributions
# --------------------------------------------------------------------------- #

BETAINC_ITERATIONS = 300
_TINY = 1e-300


def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Regularized incomplete beta ``I_x(a, b)`` in float64 (torch has no
    betainc): the continued fraction by the modified Lentz method, a fixed
    ``BETAINC_ITERATIONS`` terms, evaluated where it converges fast
    (``x < (a+1)/(a+b+2)``) and through ``I_x(a, b) = 1 - I_{1-x}(b, a)``
    elsewhere. NaN for ``a <= 0``, ``b <= 0`` or ``x`` outside [0, 1], as
    scipy's."""
    a, b, x = torch.broadcast_tensors(
        a.to(torch.float64), b.to(torch.float64), x.to(torch.float64))
    flip = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(flip, b, a)
    bb = torch.where(flip, a, b)
    xx = torch.where(flip, 1.0 - x, x)
    # the fraction's interior: x = 0 and x = 1 are set below
    xs = xx.clamp(min=_TINY, max=1.0 - 1e-16)

    def nz(v):
        return torch.where(v.abs() < _TINY, _TINY, v)

    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = torch.ones_like(xs)
    d = 1.0 / nz(1.0 - qab * xs / qap)
    h = d
    for m in range(1, BETAINC_ITERATIONS + 1):
        m2 = 2.0 * m
        num = m * (bb - m) * xs / ((qam + m2) * (aa + m2))
        d = 1.0 / nz(1.0 + num * d)
        c = nz(1.0 + num / c)
        h = h * d * c
        num = -(aa + m) * (qab + m) * xs / ((aa + m2) * (qap + m2))
        d = 1.0 / nz(1.0 + num * d)
        c = nz(1.0 + num / c)
        h = h * d * c
    lbeta = torch.lgamma(aa) + torch.lgamma(bb) - torch.lgamma(aa + bb)
    front = torch.exp(aa * torch.log(xs) + bb * torch.log1p(-xs) - lbeta) / aa
    val = front * h
    val = torch.where(xx <= 0.0, 0.0, torch.where(xx >= 1.0, 1.0, val))
    out = torch.where(flip, 1.0 - val, val)
    bad = (a <= 0) | (b <= 0) | (x < 0) | (x > 1) | torch.isnan(a + b + x)
    return torch.where(bad, math.nan, out)


def _binomial_cdf(trials, p, k):
    # P(X <= k) = I_{1-p}(n - k, k + 1)
    n = trials.to(torch.float64)
    kk = torch.minimum(torch.floor(k.to(torch.float64)).clamp(min=-1.0), n)
    out = betainc((n - kk).clamp(min=1e-12), kk + 1.0, 1.0 - p)
    return torch.where(kk < 0, 0.0, torch.where(kk >= n, 1.0, out))


def _f_cdf(df1, df2, x):
    return betainc(df1 / 2.0, df2 / 2.0, df1 * x / (df1 * x + df2))


def _laplace_cdf(mean, scale, x):
    z = (x - mean) / scale
    return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))


def _inverse_laplace_cdf(mean, scale, p):
    return torch.where(p < 0.5, mean + scale * torch.log(2.0 * p),
                       mean - scale * torch.log(2.0 - 2.0 * p))


def _t_cdf(df, x):
    ib = betainc(df / 2.0, torch.full_like(df, 0.5), df / (df + x * x))
    return torch.where(x < 0, 0.5 * ib, 1.0 - 0.5 * ib)


def _t_pdf(df, x):
    logc = (torch.lgamma((df + 1.0) / 2.0) - torch.lgamma(df / 2.0)
            - 0.5 * torch.log(df * math.pi))
    return torch.exp(logc - ((df + 1.0) / 2.0) * torch.log1p(x * x / df))


def _inverse_beta_cdf(a, b, p):
    # the reference's installed JAX has no betaincinv, so it raises this
    # error; the port keeps the same outcome (ROADMAP Queue 3)
    raise CompileError(
        "inverse_beta_cdf needs jax.scipy.special.betaincinv "
        "(unavailable in this jax build)"
    )


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _f(i: int, fn: Callable):
    """An entry of ``i`` DOUBLE arguments (decimals divided by their scale)."""
    return lambda d, t, o: fn(*(_to_f64(x, tt) for x, tt in zip(d[:i], t[:i])))


def _days(fn: Callable):
    """An entry of the days of a DATE / TIMESTAMP / TIMESTAMP W/ TZ."""
    return lambda d, t, o: fn(_days_of(d[0], t[0]))


# name -> fn(datas, arg_types, out_type): the reference's _SIMPLE_FUNCS
_SIMPLE_FUNCS: Dict[str, Callable] = {
    "$add": _arith("$add"),
    "$subtract": _arith("$subtract"),
    "$multiply": _arith("$multiply"),
    "$divide": _arith("$divide"),
    "$modulus": _arith("$modulus"),
    "$negate": lambda d, t, o: -d[0],
    **{name: _cmp_op(name) for name in _COMPARE},
    "abs": lambda d, t, o: d[0].abs(),
    "log": lambda d, t, o: torch.log(_to_f64(d[1], t[1])) / torch.log(_to_f64(d[0], t[0])),
    "normal_cdf": _f(3, lambda mean, sd, x: 0.5 * (
        1.0 + torch.special.erf((x - mean) / (sd * math.sqrt(2.0))))),
    "inverse_normal_cdf": _f(3, lambda mean, sd, p: mean + sd * torch.special.ndtri(p)),
    "beta_cdf": _f(3, betainc),
    "wilson_interval_lower": lambda d, t, o: _wilson(
        [_to_f64(x, tt) for x, tt in zip(d, t)], lower=True),
    "wilson_interval_upper": lambda d, t, o: _wilson(
        [_to_f64(x, tt) for x, tt in zip(d, t)], lower=False),
    "timezone_hour": lambda d, t, o: torch.div(
        (d[0] & 0xFFF) - 841, 60, rounding_mode="trunc"),
    "timezone_minute": lambda d, t, o: torch.fmod((d[0] & 0xFFF) - 841, 60),
    "ceiling": lambda d, t, o: (
        _decimal_ceil(d[0], t[0]) if isinstance(t[0], DecimalType) else torch.ceil(d[0])),
    "ceil": lambda d, t, o: (
        _decimal_ceil(d[0], t[0]) if isinstance(t[0], DecimalType) else torch.ceil(d[0])),
    "floor": lambda d, t, o: (
        _decimal_floor(d[0], t[0]) if isinstance(t[0], DecimalType) else torch.floor(d[0])),
    "round": lambda d, t, o: torch.round(d[0]) if len(d) == 1 else _round_n(d[0], d[1]),
    "sqrt": _f(1, torch.sqrt),
    "cbrt": _f(1, _cbrt),
    "exp": _f(1, torch.exp),
    "ln": _f(1, torch.log),
    "log2": _f(1, torch.log2),
    "log10": _f(1, torch.log10),
    "power": _f(2, torch.pow),
    "pow": _f(2, torch.pow),
    "mod": _arith("$modulus"),
    "sign": lambda d, t, o: torch.sign(d[0]),
    "sin": _f(1, torch.sin),
    "cos": _f(1, torch.cos),
    "tan": _f(1, torch.tan),
    "asin": _f(1, torch.asin),
    "acos": _f(1, torch.acos),
    "atan": _f(1, torch.atan),
    "atan2": _f(2, torch.atan2),
    "greatest": lambda d, t, o: _nary(torch.maximum, d),
    "least": lambda d, t, o: _nary(torch.minimum, d),
    "year": _days(lambda days: _civil_from_days(days)[0]),
    "month": _days(lambda days: _civil_from_days(days)[1]),
    "day": _days(lambda days: _civil_from_days(days)[2]),
    "quarter": _days(lambda days: (_civil_from_days(days)[1] + 2) // 3),
    "day_of_week": _days(_day_of_week),
    "day_of_year": _days(_day_of_year),
    "hour": lambda d, t, o: _micros_of_day(d[0], t[0]) // 3_600_000_000,
    "minute": lambda d, t, o: (_micros_of_day(d[0], t[0]) // 60_000_000) % 60,
    "second": lambda d, t, o: (_micros_of_day(d[0], t[0]) // 1_000_000) % 60,
    "millisecond": lambda d, t, o: (_micros_of_day(d[0], t[0]) // 1000) % 1000,
    "hash64": lambda d, t, o: _hash64_combine(d),
    "cot": _f(1, lambda x: 1.0 / torch.tan(x)),
    "bitwise_right_shift_arithmetic": lambda d, t, o: d[0].to(torch.int64) >> d[1].to(
        torch.int64).clamp(0, 63),
    "to_milliseconds": lambda d, t, o: torch.div(
        d[0].to(torch.int64), 1000, rounding_mode="floor"),
    "date": lambda d, t, o: _days_of(d[0], t[0]).to(torch.int32),
    "from_unixtime_nanos": lambda d, t, o: torch.div(
        d[0].to(torch.int64), 1000, rounding_mode="floor"),
    # try: the engine's error channel is already NULL on failure
    "try": lambda d, t, o: d[0],
    "binomial_cdf": lambda d, t, o: _binomial_cdf(d[0], _to_f64(d[1], t[1]), d[2]),
    "cauchy_cdf": _f(3, lambda med, sc, x: 0.5 + torch.atan((x - med) / sc) / math.pi),
    "inverse_cauchy_cdf": _f(3, lambda med, sc, p: med + sc * torch.tan(math.pi * (p - 0.5))),
    "chi_squared_cdf": _f(2, lambda df, x: torch.special.gammainc(df / 2.0, x / 2.0)),
    "f_cdf": _f(3, _f_cdf),
    "gamma_cdf": _f(3, lambda shape, scale, x: torch.special.gammainc(shape, x / scale)),
    "laplace_cdf": _f(3, _laplace_cdf),
    "inverse_laplace_cdf": _f(3, _inverse_laplace_cdf),
    "poisson_cdf": _f(2, lambda lam, k: torch.special.gammaincc(k + 1.0, lam)),
    "weibull_cdf": _f(3, lambda a, b, x: 1.0 - torch.exp(-torch.pow(x / b, a))),
    "inverse_weibull_cdf": _f(3, lambda a, b, p: b * torch.pow(-torch.log1p(-p), 1.0 / a)),
    "t_cdf": _f(2, _t_cdf),
    "t_pdf": _f(2, _t_pdf),
    "inverse_beta_cdf": _f(3, _inverse_beta_cdf),
    "degrees": _f(1, torch.rad2deg),
    "radians": _f(1, torch.deg2rad),
    "cosh": _f(1, torch.cosh),
    "sinh": _f(1, torch.sinh),
    "tanh": _f(1, torch.tanh),
    "is_nan": _f(1, torch.isnan),
    "is_finite": _f(1, torch.isfinite),
    "is_infinite": _f(1, torch.isinf),
    "truncate": lambda d, t, o: (
        torch.trunc(_to_f64(d[0], t[0])) if len(d) == 1 else _truncate_n(d[0], d[1], t[0])),
    "width_bucket": lambda d, t, o: _width_bucket(
        _to_f64(d[0], t[0]), _to_f64(d[1], t[1]), _to_f64(d[2], t[2]), d[3]),
    "bitwise_and": lambda d, t, o: d[0].to(torch.int64) & d[1].to(torch.int64),
    "bitwise_or": lambda d, t, o: d[0].to(torch.int64) | d[1].to(torch.int64),
    "bitwise_xor": lambda d, t, o: d[0].to(torch.int64) ^ d[1].to(torch.int64),
    "bitwise_not": lambda d, t, o: ~d[0].to(torch.int64),
    "bitwise_left_shift": lambda d, t, o: d[0].to(torch.int64) << d[1].to(
        torch.int64).clamp(0, 63),
    "bitwise_right_shift": lambda d, t, o: _shift_right_logical_by(
        d[0].to(torch.int64), d[1].to(torch.int64).clamp(0, 63)),
    "bit_count": lambda d, t, o: _bit_count(
        d[0].to(torch.int64), d[1] if len(d) > 1 else None),
    "day_of_month": _days(lambda days: _civil_from_days(days)[2]),
    "dow": _days(_day_of_week),
    "doy": _days(_day_of_year),
    "week": _days(lambda days: _iso_week_year(days)[0]),
    "week_of_year": _days(lambda days: _iso_week_year(days)[0]),
    "year_of_week": _days(lambda days: _iso_week_year(days)[1]),
    "yow": _days(lambda days: _iso_week_year(days)[1]),
    "last_day_of_month": _days(_last_day_of_month),
}
