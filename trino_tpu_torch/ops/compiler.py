"""Expression compiler: IR -> torch closures.

The port's counterpart of ``trino_tpu.ops.compiler`` for the expressions
this slice runs. A compiled expression is a host closure ``fn(env) -> CVal``
where ``env`` maps plan symbols to :class:`CVal` (data tensor, validity
tensor); closures are cached per (expression, input layout, capacity,
device), as the reference caches them per (expression, layout). PyTorch runs
eagerly, so a closure is the program: there is no trace.

Null semantics are the reference's mask-based three-valued logic:
arithmetic and comparisons are valid where every input is; AND/OR follow
Kleene logic. String semantics ride the sorted-dictionary invariant:
``col <op> 'literal'`` compares int32 codes, and IN lists over a dictionary
column arrive as host-built boolean LUTs (``InLut``) indexed by code.

Lowered here: references and constants; comparisons; ``$and``, ``$or``,
``$not``, IS [NOT] NULL; searched CASE (simple CASE arrives lowered to it);
``coalesce``; integer, short-decimal and DOUBLE ``+ - * / %`` and negation
(integral division truncates toward zero over a divisor clipped to 1, as
the reference computes it); CASTs among integers, short decimals (with
round-half-up rescale), DOUBLE/REAL and BOOLEAN; ``year`` of a DATE or
TIMESTAMP; dictionary-coded ``=``/``<>``/ranges, ``InLut`` and LIKE (a host
LUT over the dictionary's values, gathered by code); ``substr``/``substring``
(a host transform of the dictionary plus a device remap of codes). Anything
else raises :class:`CompileError` naming the function.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..spi.page import Dictionary
from . import int128 as i128
from ..spi.types import (
    BOOLEAN,
    DATE,
    UNKNOWN,
    DecimalType,
    TimestampType,
    Type,
    is_floating,
    is_integral,
    is_long_decimal,
    is_numeric,
    is_string,
)
from ..sql.ir import Call, Case, CastExpr, Constant, InLut, IrExpr, Reference


@dataclass
class CVal:
    """A compiled column value: device data + validity (both full capacity)."""

    data: torch.Tensor
    valid: torch.Tensor
    dictionary: Optional[Dictionary] = None


@dataclass(frozen=True)
class ColumnLayout:
    """Static per-symbol input description — part of the compilation cache
    key. (The reference's ``child_dicts`` describe nested columns, which this
    slice does not carry.)"""

    type: Type
    dictionary: Optional[Dictionary] = None


class CompileError(ValueError):
    pass


Env = Dict[str, CVal]
Compiled = Callable[[Env], CVal]

_CACHE: Dict[tuple, Tuple[Compiled, Optional[Dictionary]]] = {}


def compile_expression(
    expr: IrExpr, layout: Dict[str, ColumnLayout], capacity: int, device
) -> Tuple[Compiled, Optional[Dictionary]]:
    """Compile IR to a closure over an environment of CVals.

    Returns (fn, output_dictionary); output_dictionary is set when the result
    is a dictionary-coded string column."""
    device = torch.device(device)
    key = (expr, tuple(sorted(layout.items(), key=lambda kv: kv[0])), capacity, device)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    fn, out_dict = _Compiler(layout, capacity, device).compile(expr)
    _CACHE[key] = (fn, out_dict)
    return fn, out_dict


def _div_round(x: torch.Tensor, divisor: int) -> torch.Tensor:
    """Round-half-up integer division (Trino decimal rescale semantics)."""
    half = divisor // 2
    return torch.where(x >= 0, (x + half) // divisor, -((-x + half) // divisor))


_COMPARE = {
    "$eq": lambda a, b: a == b,
    "$ne": lambda a, b: a != b,
    "$lt": lambda a, b: a < b,
    "$lte": lambda a, b: a <= b,
    "$gt": lambda a, b: a > b,
    "$gte": lambda a, b: a >= b,
}

def _true_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` in the reference's promotion: floats keep their width,
    integers divide in float64 (torch alone would pick float32)."""
    if not (a.dtype.is_floating_point and b.dtype.is_floating_point):
        a, b = a.to(torch.float64), b.to(torch.float64)
    return a / b


def _divide(a, b, out_type: Type):
    """Integral division truncates toward zero over ``|b|`` clipped to 1
    (a zero divisor gives 0, as in the reference); any other result type
    divides in IEEE."""
    if is_integral(out_type):
        q = torch.div(a.abs(), b.abs().clamp(min=1), rounding_mode="floor")
        return q * (a.sign() * b.sign())
    return _true_divide(a, b)


def _modulus(a, b, out_type: Type):
    """Integral and decimal ``%`` takes the dividend's sign over ``|b|``
    clipped to 1; floating ``%`` is the reference's floor modulus (the
    divisor's sign)."""
    if isinstance(out_type, DecimalType) or is_integral(out_type):
        return torch.remainder(a.abs(), b.abs().clamp(min=1)) * a.sign()
    return torch.remainder(a, b)


# name -> fn(a, b, out_type); the arguments arrive in one numeric type (the
# planner casts mixed operands), except decimal x decimal, whose scales add
_ARITH = {
    "$add": lambda a, b, o: a + b,
    "$subtract": lambda a, b, o: a - b,
    "$multiply": lambda a, b, o: a * b,
    "$divide": _divide,
    "$modulus": _modulus,
}


def _to_f64(x: torch.Tensor, t: Type) -> torch.Tensor:
    """A numeric argument as DOUBLE (a decimal divided by its scale)."""
    x = x.to(torch.float64)
    return x / float(10**t.scale) if isinstance(t, DecimalType) else x


# name -> torch function of DOUBLE arguments (the reference's math table,
# operator/scalar/MathFunctions.java, for the functions the port lowers)
_FLOAT_FUNCS = {
    "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log, "log2": torch.log2,
    "log10": torch.log10, "power": torch.pow, "pow": torch.pow, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "atan2": torch.atan2,
}


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


def _has_days(t: Type) -> bool:
    return t == DATE or isinstance(t, TimestampType)


def _days_of(x: torch.Tensor, t: Type) -> torch.Tensor:
    """Days since the epoch of a DATE (days) or TIMESTAMP (microseconds)."""
    if t == DATE:
        return x
    return torch.div(x, 86_400_000_000, rounding_mode="floor")


def _like_to_regex(pattern: str, escape: Optional[str] = None) -> "re.Pattern":
    """SQL LIKE -> a compiled regex: ``%`` any run, ``_`` one character,
    ``escape`` makes the next character literal. It runs on the host over
    dictionary values."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("".join(out), re.DOTALL)


def _substr(s: str, start, length=None) -> str:
    # the reference's slice: 1-based start, optional length
    b = int(start) - 1
    return s[b:] if length is None else s[b:b + int(length)]


# dictionary transforms: name -> fn(value, *constant args)
_STRING_FUNCS: Dict[str, Callable] = {"substr": _substr, "substring": _substr}


def _build_code_lut(new_values):
    """Transformed dictionary values -> (output Dictionary, old code -> new
    code int32 LUT, -1 for a SQL NULL result)."""
    uniq = sorted({s for s in new_values if s is not None})
    out_dict = Dictionary(np.asarray(uniq, dtype=object))
    code_map = {s: i for i, s in enumerate(uniq)}
    lut = np.array([-1 if s is None else code_map[s] for s in new_values], dtype=np.int32)
    return out_dict, lut


def _merge_dicts(dicts) -> Dictionary:
    """One dictionary over several string inputs' values (the first when
    they all hold the same values; an empty one for no inputs)."""
    if len({d.fingerprint() for d in dicts}) == 1:
        return dicts[0]
    merged = sorted(set().union(*[list(d.values) for d in dicts]))
    return Dictionary(np.asarray(merged, dtype=object))


def _remap_lut(from_dict: Optional[Dictionary], to_dict: Dictionary, device):
    """Host LUT translating codes of ``from_dict`` into ``to_dict`` (absent
    -> -1), or None where the codes already agree."""
    if from_dict is None or from_dict is to_dict:
        return None
    if from_dict.fingerprint() == to_dict.fingerprint():
        return None
    lut = np.array([to_dict.code_of(s) for s in from_dict.values], dtype=np.int32)
    if len(lut) == 0:
        lut = np.full(1, -1, dtype=np.int32)
    return torch.as_tensor(lut, device=device)


def _gather_codes(lut: Optional[torch.Tensor], codes: torch.Tensor) -> torch.Tensor:
    if lut is None:
        return codes
    return lut[codes.to(torch.int64).clamp(0, lut.shape[0] - 1)]


class _Compiler:
    def __init__(self, layout: Dict[str, ColumnLayout], capacity: int, device):
        self.layout = layout
        self.capacity = capacity
        self.device = device
        self._memo: Dict[int, Tuple[Compiled, Optional[Dictionary]]] = {}

    def _full(self, value, dtype: torch.dtype) -> torch.Tensor:
        return torch.full((self.capacity,), value, dtype=dtype, device=self.device)

    def compile(self, expr: IrExpr) -> Tuple[Compiled, Optional[Dictionary]]:
        key = id(expr)
        hit = self._memo.get(key)
        if hit is None:
            hit = self._compile_uncached(expr)
            self._memo[key] = hit
        return hit

    def _compile_uncached(self, expr: IrExpr) -> Tuple[Compiled, Optional[Dictionary]]:
        if isinstance(expr, Reference):
            sym = expr.symbol
            lay = self.layout.get(sym)
            d = lay.dictionary if lay else None

            def ref_fn(env: Env, sym=sym, d=d) -> CVal:
                v = env[sym]
                return CVal(v.data, v.valid, v.dictionary or d)

            return ref_fn, d

        if isinstance(expr, Constant):
            type_, value = expr.type, expr.value
            if is_string(type_) and isinstance(value, str):
                # a free-standing string constant is a 1-entry dictionary column
                d = Dictionary(np.asarray([value], dtype=object))

                def sconst_fn(env: Env, d=d) -> CVal:
                    return CVal(
                        self._full(0, torch.int32), self._full(True, torch.bool), d
                    )

                return sconst_fn, d
            if is_long_decimal(type_):
                limbs = torch.as_tensor(
                    i128.np_from_ints([int(value) if value is not None else 0])[0],
                    device=self.device,
                )

                def lconst_fn(env: Env, limbs=limbs, ok=value is not None) -> CVal:
                    return CVal(limbs.repeat(self.capacity, 1), self._full(ok, torch.bool))

                return lconst_fn, None
            if type_.storage_lanes is not None:
                raise CompileError(f"constant of type {type_.display()} not supported")
            dt = type_.torch_dtype

            def const_fn(env: Env, value=value, dt=dt) -> CVal:
                return CVal(
                    self._full(value if value is not None else 0, dt),
                    self._full(value is not None, torch.bool),
                )

            return const_fn, None

        if isinstance(expr, CastExpr):
            return self._compile_cast(expr)

        if isinstance(expr, Case):
            return self._compile_case(expr)

        if isinstance(expr, InLut):
            inner, _ = self.compile(expr.value)
            lut = torch.as_tensor(
                np.asarray(expr.lut, dtype=np.bool_), device=self.device
            )

            def lut_fn(env: Env) -> CVal:
                v = inner(env)
                codes = v.data.to(torch.int64).clamp(0, lut.shape[0] - 1)
                return CVal(lut[codes], v.valid)

            return lut_fn, None

        if isinstance(expr, Call):
            return self._compile_call(expr)

        raise CompileError(f"cannot compile {type(expr).__name__}")

    # ------------------------------------------------------------------ casts

    def _compile_cast(self, expr: CastExpr) -> Tuple[Compiled, Optional[Dictionary]]:
        inner, in_dict = self.compile(expr.value)
        src, dst = expr.value.type, expr.type
        if src == dst or (is_string(src) and is_string(dst)):
            return inner, in_dict
        if src == UNKNOWN:

            def null_fn(env: Env) -> CVal:
                return CVal(self._full(0, dst.torch_dtype), self._full(False, torch.bool))

            return null_fn, None
        if is_long_decimal(src) or is_long_decimal(dst):
            return self._compile_long_cast(inner, src, dst), None
        src_int = is_integral(src) or src == BOOLEAN
        dst_int = is_integral(dst)
        out_dt = dst.torch_dtype
        if isinstance(src, DecimalType) and isinstance(dst, DecimalType):
            diff = dst.scale - src.scale

            def dec_fn(env: Env) -> CVal:
                v = inner(env)
                data = v.data.to(torch.int64)
                if diff > 0:
                    data = data * (10**diff)
                elif diff < 0:
                    data = _div_round(data, 10**-diff)
                return CVal(data, v.valid)

            return dec_fn, None
        if isinstance(dst, DecimalType) and src_int:

            def to_dec_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(v.data.to(torch.int64) * (10**dst.scale), v.valid)

            return to_dec_fn, None
        if isinstance(src, DecimalType) and dst_int:

            def from_dec_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(_div_round(v.data, 10**src.scale).to(out_dt), v.valid)

            return from_dec_fn, None
        if isinstance(src, DecimalType) and is_floating(dst):

            def dec_to_float_fn(env: Env) -> CVal:
                v = inner(env)
                data = v.data.to(torch.float64) / float(10**src.scale)
                return CVal(data.to(out_dt), v.valid)

            return dec_to_float_fn, None
        if is_floating(src) and isinstance(dst, DecimalType):

            def float_to_dec_fn(env: Env) -> CVal:
                # round half to even, as the reference's jnp.round
                v = inner(env)
                return CVal(torch.round(v.data * float(10**dst.scale)).to(torch.int64), v.valid)

            return float_to_dec_fn, None
        if is_floating(src) and dst_int:

            def float_to_int_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(torch.round(v.data).to(out_dt), v.valid)

            return float_to_int_fn, None
        if (src_int or is_floating(src)) and (dst_int or is_floating(dst)):

            def numeric_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(v.data.to(out_dt), v.valid)

            return numeric_fn, None
        if is_numeric(src) and dst == BOOLEAN:

            def bool_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(v.data != 0, v.valid)

            return bool_fn, None
        raise CompileError(f"unsupported cast {src.display()} -> {dst.display()}")

    def _compile_long_cast(self, inner: Compiled, src: Type, dst: Type) -> Compiled:
        """Casts to and from DECIMAL(p>18), the reference's: rescales round
        half up; long to short or integral marks an out-of-range row NULL."""
        out_dt = dst.torch_dtype

        def convert(v: CVal) -> CVal:
            data = v.data
            if isinstance(src, DecimalType) and isinstance(dst, DecimalType):
                x = data if is_long_decimal(src) else i128.from_int64(data)
                diff = dst.scale - src.scale
                if diff > 0:
                    x = i128.scale_up_pow10(x, diff)
                elif diff < 0:
                    x = i128.div_round_pow10(x, -diff)
                if is_long_decimal(dst):
                    return CVal(x, v.valid)
                return CVal(i128.lo(x), v.valid & i128.fits_int64(x))
            if is_long_decimal(dst) and (is_integral(src) or src == BOOLEAN):
                return CVal(i128.scale_up_pow10(i128.from_int64(data), dst.scale), v.valid)
            if is_long_decimal(src) and is_floating(dst):
                return CVal((i128.to_float64(data) / float(10**src.scale)).to(out_dt), v.valid)
            if is_long_decimal(src) and is_integral(dst):
                x = i128.div_round_pow10(data, src.scale)
                return CVal(i128.lo(x).to(out_dt), v.valid & i128.fits_int64(x))
            raise CompileError(f"cast {src.display()} -> {dst.display()} not supported")

        return lambda env: convert(inner(env))

    def _compile_long_call(self, expr: Call, arg_fns) -> Compiled:
        """Comparisons, ``+ - *`` and negation where an operand or the
        result is DECIMAL(p>18): limb arithmetic (``ops/int128.py``); a
        short operand is sign-extended (the planner gives both the same
        scale)."""
        name = expr.name
        longs = [is_long_decimal(a.type) for a in expr.args]

        def widen(v: CVal, is_long: bool) -> torch.Tensor:
            return v.data if is_long else i128.from_int64(v.data)

        if name == "$negate":

            def negate_fn(env: Env) -> CVal:
                v = arg_fns[0](env)
                return CVal(i128.negate(widen(v, longs[0])), v.valid)

            return negate_fn
        ops = {
            "$eq": i128.eq, "$ne": lambda a, b: ~i128.eq(a, b), "$lt": i128.lt,
            "$lte": i128.lte, "$gt": lambda a, b: i128.lt(b, a),
            "$gte": lambda a, b: i128.lte(b, a), "$add": i128.add,
            "$subtract": i128.sub, "$multiply": i128.mul,
        }
        if name not in ops:
            raise CompileError(f"{name} on DECIMAL(p>18) not supported")
        op = ops[name]

        def long_fn(env: Env) -> CVal:
            a, b = arg_fns[0](env), arg_fns[1](env)
            return CVal(op(widen(a, longs[0]), widen(b, longs[1])), a.valid & b.valid)

        return long_fn

    def _compile_limb_call(self, expr: Call, arg_fns) -> Compiled:
        """The long-decimal aggregation's decomposition
        (``rules.decompose_long_decimal_aggregates``): ``$dec_limb`` splits a
        value into four 32-bit limbs (the top one signed), whose int64 sums
        ``$i128_recombine`` adds back (``$i128_avg`` then divides by the
        count, round half up)."""
        if expr.name == "$dec_limb":
            idx, long_arg = expr.args[1].value, is_long_decimal(expr.args[0].type)

            def limb_fn(env: Env) -> CVal:
                v = arg_fns[0](env)
                x = v.data if long_arg else i128.from_int64(v.data)
                h, l = i128.hi(x), i128.lo(x)
                out = (l & 0xFFFFFFFF, (l >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF, h >> 32)[idx]
                return CVal(out, v.valid)

            return limb_fn
        avg = expr.name == "$i128_avg"

        def recombine_fn(env: Env) -> CVal:
            vs = [f(env) for f in arg_fns]
            acc = i128.from_int64(vs[0].data)
            valid = vs[0].valid
            for i in range(1, 4):
                term = i128.from_int64(vs[i].data)
                for _ in range(i):
                    term = i128.mul_int64(term, 1 << 32)
                acc = i128.add(acc, term)
                valid = valid & vs[i].valid
            if avg:
                cnt = vs[4]
                acc = i128.div_int(acc, cnt.data.clamp(min=1))
                valid = valid & cnt.valid & (cnt.data > 0)
            return CVal(acc, valid)

        return recombine_fn

    # ------------------------------------------------------------------ calls

    def _dict_of(self, expr: IrExpr) -> Optional[Dictionary]:
        if isinstance(expr, Reference):
            lay = self.layout.get(expr.symbol)
            return lay.dictionary if lay else None
        if isinstance(expr, CastExpr):
            return self._dict_of(expr.value)
        if isinstance(expr, (Call, Case, Constant)) and is_string(expr.type):
            return self.compile(expr)[1]
        return None

    # ------------------------------------------------------------------- case

    def _compile_case(self, expr: Case) -> Tuple[Compiled, Optional[Dictionary]]:
        """Searched CASE: the first WHEN whose condition is TRUE (a NULL
        condition is not) picks its result, else the ELSE, else NULL. A
        string CASE merges its branches' dictionaries and remaps each
        branch's codes onto the merged one."""
        whens = [(self.compile(c)[0],) + self.compile(r) for c, r in expr.whens]
        default_fn, default_dict = (
            self.compile(expr.default) if expr.default is not None else (None, None)
        )
        dt = expr.type.torch_dtype
        out_dict = None
        if is_string(expr.type):
            real = [d for *_, d in whens if d is not None]
            if default_dict is not None:
                real.append(default_dict)
            if real:
                out_dict = _merge_dicts(real)
        luts = [_remap_lut(d, out_dict, self.device) if out_dict else None
                for *_, d in whens]
        default_lut = _remap_lut(default_dict, out_dict, self.device) if out_dict else None

        def case_fn(env: Env) -> CVal:
            if default_fn is not None:
                acc = default_fn(env)
                data, valid = _gather_codes(default_lut, acc.data).to(dt), acc.valid
            else:
                data, valid = self._full(0, dt), self._full(False, torch.bool)
            # in reverse: an earlier WHEN overrides a later one
            for (cond_fn, res_fn, _), lut in zip(reversed(whens), reversed(luts)):
                c, r = cond_fn(env), res_fn(env)
                fire = c.valid & c.data.to(torch.bool)
                data = torch.where(fire, _gather_codes(lut, r.data).to(dt), data)
                valid = torch.where(fire, r.valid, valid)
            return CVal(data, valid, out_dict)

        return case_fn, out_dict

    def _compile_avg_combine(self, expr: Call, arg_fns) -> Compiled:
        """avg from its partial/final split (``fragmenter.split_aggregation``):
        sum / count, NULL when no row was aggregated; decimal by decimal
        rounds half up, as the single-step avg does."""
        out_type, sum_type = expr.type, expr.args[0].type
        out_dt = out_type.torch_dtype

        def avgc_fn(env: Env) -> CVal:
            s, c = arg_fns[0](env), arg_fns[1](env)
            cnt = c.data.clamp(min=1)
            if isinstance(out_type, DecimalType) and isinstance(sum_type, DecimalType):
                half = cnt // 2
                data = torch.where(s.data >= 0, (s.data + half) // cnt,
                                   -((-s.data + half) // cnt))
            else:
                data = s.data.to(torch.float64) / cnt
                if isinstance(sum_type, DecimalType):
                    data = data / float(10 ** sum_type.scale)
            return CVal(data.to(out_dt), s.valid & c.valid & (c.data > 0))

        return avgc_fn

    def _compile_call(self, expr: Call) -> Tuple[Compiled, Optional[Dictionary]]:
        name = expr.name
        if name in _COMPARE and any(is_string(a.type) for a in expr.args):
            return self._compile_string_comparison(expr)
        if name == "$like":
            return self._compile_like(expr)
        if name in _STRING_FUNCS:
            return self._compile_string_function(expr)
        arg_fns = [self.compile(a)[0] for a in expr.args]

        if name == "$and":

            def and_fn(env: Env) -> CVal:
                a, b = arg_fns[0](env), arg_fns[1](env)
                ad, bd = a.data.to(torch.bool), b.data.to(torch.bool)
                res_false = (a.valid & ~ad) | (b.valid & ~bd)
                res_true = (a.valid & ad) & (b.valid & bd)
                return CVal(res_true, res_false | res_true)

            return and_fn, None
        if name == "$or":

            def or_fn(env: Env) -> CVal:
                a, b = arg_fns[0](env), arg_fns[1](env)
                ad, bd = a.data.to(torch.bool), b.data.to(torch.bool)
                res_true = (a.valid & ad) | (b.valid & bd)
                res_false = (a.valid & ~ad) & (b.valid & ~bd)
                return CVal(res_true, res_false | res_true)

            return or_fn, None
        if name == "$not":

            def not_fn(env: Env) -> CVal:
                a = arg_fns[0](env)
                return CVal(~a.data.to(torch.bool), a.valid)

            return not_fn, None
        if name in ("$is_null", "$not_null"):
            negate = name == "$is_null"

            def null_test_fn(env: Env) -> CVal:
                a = arg_fns[0](env)
                return CVal(~a.valid if negate else a.valid, self._full(True, torch.bool))

            return null_test_fn, None

        if name == "coalesce":
            return self._compile_coalesce(expr, arg_fns)
        if name == "$avg_combine":
            return self._compile_avg_combine(expr, arg_fns), None

        if name in ("$dec_limb", "$i128_recombine", "$i128_avg"):
            return self._compile_limb_call(expr, arg_fns), None
        if any(is_long_decimal(a.type) for a in expr.args) or is_long_decimal(expr.type):
            return self._compile_long_call(expr, arg_fns), None
        out_type = expr.type
        if name in _COMPARE:
            op = _COMPARE[name]
        elif name in _ARITH and all(is_numeric(a.type) for a in expr.args):
            arith = _ARITH[name]
            op = lambda a, b: arith(a, b, out_type)  # noqa: E731
        elif name == "$negate" and is_numeric(out_type):
            op = torch.neg
        elif name in _FLOAT_FUNCS and all(is_numeric(a.type) for a in expr.args):
            fn, arg_types = _FLOAT_FUNCS[name], [a.type for a in expr.args]
            op = lambda *d: fn(*(_to_f64(x, t) for x, t in zip(d, arg_types)))  # noqa: E731
        elif name == "year" and _has_days(expr.args[0].type):
            arg_type = expr.args[0].type
            op = lambda d: _civil_from_days(_days_of(d, arg_type))[0]  # noqa: E731
        else:
            raise CompileError(f"no device lowering for function {name}")
        out_dt = out_type.torch_dtype

        def call_fn(env: Env) -> CVal:
            vals = [f(env) for f in arg_fns]
            data = op(*(v.data for v in vals))
            valid = vals[0].valid
            for v in vals[1:]:
                valid = valid & v.valid
            return CVal(data if data.dtype == out_dt else data.to(out_dt), valid)

        return call_fn, None

    def _compile_coalesce(self, expr: Call, arg_fns) -> Tuple[Compiled, Optional[Dictionary]]:
        """The first non-NULL argument; strings from several dictionaries
        are remapped onto their merged dictionary first."""
        out_dt = expr.type.torch_dtype
        merged, luts = None, [None] * len(arg_fns)
        if is_string(expr.type):
            dicts = [self._dict_of(a) for a in expr.args]
            merged = _merge_dicts([d for d in dicts if d is not None])
            luts = [_remap_lut(d, merged, self.device) for d in dicts]

        def coalesce_fn(env: Env) -> CVal:
            vals = [f(env) for f in arg_fns]
            datas = [_gather_codes(lut, v.data).to(out_dt) for v, lut in zip(vals, luts)]
            data, valid = datas[-1], vals[-1].valid
            for v, d in zip(reversed(vals[:-1]), reversed(datas[:-1])):
                data = torch.where(v.valid, d, data)
                valid = valid | v.valid
            return CVal(data, valid, merged)

        return coalesce_fn, merged

    def _compile_like(self, expr: Call) -> Tuple[Compiled, Optional[Dictionary]]:
        """LIKE against a constant pattern (with an optional ESCAPE): one
        host pass over the value's dictionary builds a boolean LUT, which
        the device gathers by code."""
        value, pattern = expr.args[0], expr.args[1]
        escape = expr.args[2].value if len(expr.args) > 2 else None
        if not isinstance(pattern, Constant):
            raise CompileError("LIKE pattern must be constant")
        d = self._dict_of(value)
        if d is None:
            raise CompileError("LIKE requires a dictionary column")
        inner, _ = self.compile(value)
        rx = _like_to_regex(pattern.value, escape)
        lut = torch.as_tensor(
            np.fromiter((rx.fullmatch(s) is not None for s in d.values),
                        dtype=np.bool_, count=len(d)),
            device=self.device,
        )

        def like_fn(env: Env) -> CVal:
            v = inner(env)
            return CVal(_gather_codes(lut, v.data), v.valid)

        return like_fn, None

    def _compile_string_function(self, expr: Call) -> Tuple[Compiled, Optional[Dictionary]]:
        """A string function of a dictionary column and constant arguments:
        the host applies it once per dictionary value, the output
        dictionary is the sorted set of results, and the device remaps
        codes through an old-code -> new-code LUT."""
        name, value = expr.name, expr.args[0]
        d = self._dict_of(value)
        if d is None:
            raise CompileError(f"{name} requires a dictionary column")
        args = []
        for a in expr.args[1:]:
            if not isinstance(a, Constant):
                raise CompileError(f"{name}: non-leading arguments must be constant")
            args.append(a.value)
        if any(v is None for v in args):
            return self.compile(Constant(expr.type, None))  # a SQL NULL argument
        out_dict, lut_np = _build_code_lut([_STRING_FUNCS[name](s, *args) for s in d.values])
        lut = torch.as_tensor(lut_np, device=self.device)
        inner, _ = self.compile(value)

        def transform_fn(env: Env) -> CVal:
            v = inner(env)
            codes = _gather_codes(lut, v.data)
            return CVal(codes.clamp(min=0), v.valid & (codes >= 0), out_dict)

        return transform_fn, out_dict

    def _compile_string_comparison(self, expr: Call) -> Tuple[Compiled, Optional[Dictionary]]:
        name = expr.name
        a, b = expr.args
        # normalize: column <op> constant
        if isinstance(a, Constant) and not isinstance(b, Constant):
            flip = {"$lt": "$gt", "$lte": "$gte", "$gt": "$lt", "$gte": "$lte"}
            name = flip.get(name, name)
            a, b = b, a
        if isinstance(b, Constant):
            d = self._dict_of(a)
            if d is None:
                raise CompileError("string comparison requires a dictionary column")
            inner, _ = self.compile(a)
            s = b.value
            if name in ("$eq", "$ne"):
                code = d.code_of(s) if s is not None else -1

                def eq_fn(env: Env) -> CVal:
                    v = inner(env)
                    if s is None:
                        no = self._full(False, torch.bool)
                        return CVal(no, no)
                    res = v.data == code
                    return CVal(~res if name == "$ne" else res, v.valid)

                return eq_fn, None
            # ranges on codes: the dictionary is sorted
            lo_left = d.searchsorted(s, "left")
            lo_right = d.searchsorted(s, "right")
            bound, op = {
                "$lt": (lo_left, _COMPARE["$lt"]),
                "$lte": (lo_right, _COMPARE["$lt"]),
                "$gt": (lo_right, _COMPARE["$gte"]),
                "$gte": (lo_left, _COMPARE["$gte"]),
            }[name]

            def range_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(op(v.data, bound), v.valid)

            return range_fn, None

        da, db = self._dict_of(a), self._dict_of(b)
        fa, _ = self.compile(a)
        fb, _ = self.compile(b)
        if da is None or db is None:
            raise CompileError("string comparison requires dictionary columns")
        if da is db:
            op = _COMPARE[name]

            def samecmp_fn(env: Env) -> CVal:
                va, vb = fa(env), fb(env)
                return CVal(op(va.data, vb.data), va.valid & vb.valid)

            return samecmp_fn, None
        if name in ("$eq", "$ne"):
            # translate codes of A into codes of B (exact-match LUT, -1 = none)
            lut = torch.as_tensor(
                np.array([db.code_of(s) for s in da.values], dtype=np.int32),
                device=self.device,
            )

            def xdict_eq_fn(env: Env) -> CVal:
                va, vb = fa(env), fb(env)
                mapped = lut[va.data.to(torch.int64).clamp(0, lut.shape[0] - 1)]
                res = (mapped == vb.data) & (mapped >= 0)
                return CVal(~res if name == "$ne" else res, va.valid & vb.valid)

            return xdict_eq_fn, None
        raise CompileError(
            "ordering comparison across different dictionaries not supported yet"
        )


# --------------------------------------------------------------------------- #
# megakernel shape recognition (ops/megakernels.py)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MegakernelSpec:
    """A join shape the fused hash-join path accepts, from
    :func:`plan_megakernel`. The executor layers the aggregation spec on
    top; this spec answers only whether the JOIN runs as the hash-probe
    kernels."""

    left_outer: bool


def plan_megakernel(kind, criteria, has_filter: bool,
                    probe_page, build_page) -> Tuple[Optional[MegakernelSpec], str]:
    """Recognize a join for the fused hash-join path. Returns ``(spec,
    "ok")``, or ``(None, reason)`` with the reference's fallback label:

    - ``cross_join``: no equi criterion to bucket on;
    - ``join_kind``: not INNER or LEFT after the RIGHT-swap (FULL needs the
      unmatched-build tail the kernels do not carry);
    - ``residual_filter``: a non-equi residual, which the serial path owns;
    - ``empty_layout``: a side without rows of capacity.
    """
    from ..planner.plan import JoinKind as _JK

    if not criteria:
        return None, "cross_join"
    if kind not in (_JK.INNER, _JK.LEFT):
        return None, "join_kind"
    if has_filter:
        return None, "residual_filter"
    for page in (probe_page, build_page):
        if page.capacity < 1:
            return None, "empty_layout"
    return MegakernelSpec(left_outer=(kind == _JK.LEFT)), "ok"


def megakernel_key_check(key_cols) -> Tuple[bool, str]:
    """Physical key-column check: every join key must be a single-lane
    column (``data.ndim == 1``); multi-lane keys fall back as ``key_ndim``."""
    for d, _v in key_cols:
        if d.ndim != 1:
            return False, "key_ndim"
    return True, "ok"
