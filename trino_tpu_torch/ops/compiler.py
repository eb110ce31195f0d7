"""Expression compiler: IR -> torch closures.

The port's counterpart of ``trino_tpu.ops.compiler``. A compiled expression
is a host closure ``fn(env) -> CVal`` where ``env`` maps plan symbols to
:class:`CVal` (data tensor, validity tensor); closures are cached per
(expression, input layout, capacity, device), as the reference caches them
per (expression, layout). PyTorch runs eagerly, so a closure is the
program: there is no trace.

Null semantics are the reference's mask-based three-valued logic:
arithmetic and comparisons are valid where every input is; AND/OR follow
Kleene logic. String semantics ride the sorted-dictionary invariant:
``col <op> 'literal'`` compares int32 codes, and IN lists over a dictionary
column arrive as host-built boolean LUTs (``InLut``) indexed by code.

Lowered here: references and constants; comparisons (the zoned temporal
types by instant); ``$and``, ``$or``, ``$not``, IS [NOT] NULL; searched
CASE; ``coalesce``, ``nullif``; the scalar function table of
``ops/scalar_functions.py`` (arithmetic, math, the CDFs, bitwise and date
parts); ``date_trunc``/``date_add``/``date_diff`` with a constant unit;
``random``; CASTs among the numeric, temporal and boolean types and from
VARCHAR; the long-decimal limb forms; the string functions of
``ops/string_functions.py``, each a host transform of the dictionary's
values gathered on the device by code (JSON and URL functions among them;
``split`` and its kin gather array lanes); and the ARRAY, MAP and ROW
functions and lambdas of ``ops/nested.py``. Anything else raises
:class:`CompileError` naming the function.
"""

from __future__ import annotations

import gc
import math
import random
import re
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..spi.page import Dictionary
from . import int128 as i128
from . import kernels as K
from ..spi.types import (
    BOOLEAN,
    DATE,
    UNKNOWN,
    DecimalType,
    TimestampWithTimeZoneType,
    TimeType,
    TimeWithTimeZoneType,
    Type,
    is_floating,
    is_integral,
    is_long_decimal,
    is_nested,
    is_numeric,
    is_string,
)
from ..sql.functions import HIGHER_ORDER_FUNCTIONS
from ..sql.ir import Call, Case, CastExpr, Constant, InLut, IrExpr, Reference
from .nested import NESTED_FUNCS, compile_higher_order, compile_nested, null_cval
from .scalar_functions import (
    _COMPARE,
    _SIMPLE_FUNCS,
    DAY_MICROS,
    CompileError,
    _civil_from_days,
    _days_from_civil,
    _days_of,
    _micros_of_day,
)
from .string_functions import (
    _DISTANCE_FUNCS,
    _JSON_LUTS,
    _STRING_ARRAY_LUTS,
    _STRING_FUNCS,
    _STRING_INT_LUTS,
    _STRING_LENGTH_FUNCS,
    STRING_FUNCTIONS,
    json_lut_value,
    _like_to_regex,
    _string_cast_lut,
)


@dataclass
class CVal:
    """A compiled column value: device data + validity (both full capacity).
    A nested value mirrors ``spi.page.Column``'s layout: an array carries
    ``data[cap, W]``, ``elem_valid`` and ``lengths``; a map or row its
    child values in ``children``."""

    data: torch.Tensor
    valid: torch.Tensor
    dictionary: Optional[Dictionary] = None
    lengths: Optional[torch.Tensor] = None
    elem_valid: Optional[torch.Tensor] = None
    children: tuple = ()


@dataclass(frozen=True)
class ColumnLayout:
    """Static per-symbol input description — part of the compilation cache
    key. ``child_dicts`` mirrors a nested column's children: per child a
    Dictionary/None (a scalar or array child) or a nested tuple (a map or
    row child), so accessors can name the dictionary their result carries."""

    type: Type
    dictionary: Optional[Dictionary] = None
    child_dicts: tuple = ()


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


def clear_cache() -> None:
    """Drop every cached closure. DROP TABLE calls it: a closure keyed by a
    dropped table's dictionaries, or by one derived from them (a string
    function's output), can never be hit again, and its LUTs would hold
    device memory for good; the others rebuild on their next use. A
    closure refers to its compiler, which holds it in its memo: the cycle,
    and the LUTs with it, goes only when the cyclic collector runs, so it
    runs here."""
    _CACHE.clear()
    gc.collect()


def _div_round(x: torch.Tensor, divisor: int) -> torch.Tensor:
    """Round-half-up integer division (Trino decimal rescale semantics)."""
    half = divisor // 2
    return torch.where(x >= 0, (x + half) // divisor, -((-x + half) // divisor))


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


def _stat_combine(stat: str, s1: CVal, s2: CVal, cn: CVal) -> CVal:
    """stddev/variance from their partial sums (``fragmenter``'s split into
    ``$fsum``/``$fsumsq``/count), the reference's one-pass formula."""
    n = cn.data.clamp(min=1).to(torch.float64)
    mean = s1.data / n
    var_pop = (s2.data / n - mean * mean).clamp(min=0.0)
    if stat in ("var_pop", "stddev_pop"):
        var, valid = var_pop, cn.data > 0
    else:
        var, valid = var_pop * n / (n - 1).clamp(min=1), cn.data > 1
    data = torch.sqrt(var) if stat.startswith("stddev") else var
    return CVal(data, s1.valid & s2.valid & valid)


def _temporal_cast(src: Type, dst: Type) -> Optional[Callable]:
    """The data conversion of a cast among DATE, TIMESTAMP, TIME and their
    zoned forms, or None. A value without a zone takes UTC, the session
    zone; a zoned value converts to its wall time in its own zone."""
    ttz, twtz = TimestampWithTimeZoneType, TimeWithTimeZoneType
    src_ts = src.name.startswith("timestamp")
    if isinstance(src, twtz) and isinstance(dst, TimeType):
        return lambda x: torch.remainder(
            (x >> 12) + ((x & 0xFFF) - 841) * 60_000_000, DAY_MICROS)
    if isinstance(src, TimeType) and isinstance(dst, twtz):
        return lambda x: (x.to(torch.int64) << 12) | 841
    if isinstance(src, ttz) and dst.name == "timestamp":
        return lambda x: ((x >> 12) + ((x & 0xFFF) - 841) * 60_000) * 1000
    if src.name == "timestamp" and isinstance(dst, ttz):
        return lambda x: (torch.div(x, 1000, rounding_mode="floor") << 12) | 841
    if isinstance(src, ttz) and dst == DATE:
        return lambda x: _days_of(x, src).to(torch.int32)
    if src_ts and isinstance(dst, TimeType):
        return lambda x: _micros_of_day(x, src)
    if isinstance(src, TimeType) and isinstance(dst, TimeType):
        return lambda x: x
    if src == DATE and isinstance(dst, ttz):
        return lambda x: ((x.to(torch.int64) * 86_400_000) << 12) | 841
    if src == DATE and dst.name.startswith("timestamp"):
        return lambda x: x.to(torch.int64) * DAY_MICROS
    if src_ts and dst == DATE:
        return lambda x: torch.div(x, DAY_MICROS, rounding_mode="floor").to(torch.int32)
    return None


_NULLARY_CONSTANTS = {"pi": math.pi, "e": math.e, "nan": math.nan, "infinity": math.inf}


class _Compiler:
    def __init__(self, layout: Dict[str, ColumnLayout], capacity: int, device):
        self.layout = layout
        self.capacity = capacity
        self.device = device
        self._memo: Dict[int, Tuple[Compiled, Optional[Dictionary]]] = {}
        # the salt source of random(): each compilation draws its own
        self.rng = random.Random()

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
                return CVal(v.data, v.valid, v.dictionary or d, v.lengths, v.elem_valid,
                            v.children)

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
            if is_nested(type_):
                if value is not None:
                    raise CompileError(f"non-null {type_.display()} constants are not foldable")
                return (lambda env: null_cval(type_, self.capacity, self.device)), None
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
        if src == UNKNOWN and is_nested(dst):
            return (lambda env: null_cval(dst, self.capacity, self.device)), None
        if src == UNKNOWN:

            def null_fn(env: Env) -> CVal:
                return CVal(self._full(0, dst.torch_dtype), self._full(False, torch.bool))

            return null_fn, None
        if is_string(src) and in_dict is not None:
            # one host parse per dictionary value; a malformed value is NULL
            # for its rows
            lut_np, ok_np = _string_cast_lut(in_dict.values, dst)
            if lut_np is not None:
                lut = torch.as_tensor(lut_np, device=self.device)
                ok = torch.as_tensor(ok_np, device=self.device)

                def dictcast_fn(env: Env) -> CVal:
                    v = inner(env)
                    idx = v.data.to(torch.int64).clamp(0, lut.shape[0] - 1)
                    return CVal(lut[idx], v.valid & ok[idx])

                return dictcast_fn, None
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
        temporal = _temporal_cast(src, dst)
        if temporal is not None:

            def temporal_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(temporal(v.data), v.valid)

            return temporal_fn, None
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
        if is_nested(expr.type):
            raise CompileError("CASE over array/map/row values not supported yet")
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
        if name in HIGHER_ORDER_FUNCTIONS:
            return compile_higher_order(self, expr)
        if name in NESTED_FUNCS:
            return compile_nested(self, expr)
        if name in _COMPARE and any(is_string(a.type) for a in expr.args):
            return self._compile_string_comparison(expr)
        if name == "$like":
            return self._compile_like(expr)
        if name in STRING_FUNCTIONS:
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
        if name == "nullif":

            def nullif_fn(env: Env) -> CVal:
                a, b = arg_fns[0](env), arg_fns[1](env)
                same = (a.data == b.data).all(-1) if a.data.ndim == 2 else a.data == b.data
                return CVal(a.data, a.valid & ~(same & a.valid & b.valid))

            return nullif_fn, None
        if name == "$avg_combine":
            return self._compile_avg_combine(expr, arg_fns), None
        if name.startswith("$") and name.endswith("_combine"):
            # $<stddev|variance...>_combine(s1, s2, n)
            stat = name[1:].rsplit("_combine", 1)[0]
            return (lambda env: _stat_combine(stat, *(f(env) for f in arg_fns))), None

        if name in ("$dec_limb", "$i128_recombine", "$i128_avg"):
            return self._compile_limb_call(expr, arg_fns), None
        if any(is_long_decimal(a.type) for a in expr.args) or is_long_decimal(expr.type):
            return self._compile_long_call(expr, arg_fns), None
        if name in ("date_trunc", "date_add", "date_diff"):
            return self._compile_datetime_fn(expr)
        if name in _NULLARY_CONSTANTS and not expr.args:
            value = _NULLARY_CONSTANTS[name]
            return (lambda env: CVal(self._full(value, torch.float64),
                                     self._full(True, torch.bool))), None
        if name in ("random", "rand"):
            return self._compile_random(arg_fns), None

        impl = _SIMPLE_FUNCS.get(name)
        if impl is None:
            raise CompileError(f"no device lowering for function {name}")
        arg_types = [a.type for a in expr.args]
        out_type = expr.type
        out_dt = out_type.torch_dtype

        def call_fn(env: Env) -> CVal:
            vals = [f(env) for f in arg_fns]
            data = impl([v.data for v in vals], arg_types, out_type)
            valid = vals[0].valid if vals else self._full(True, torch.bool)
            for v in vals[1:]:
                valid = valid & v.valid
            return CVal(data if data.dtype == out_dt else data.to(out_dt), valid)

        return call_fn, None

    def _compile_random(self, arg_fns) -> Compiled:
        """random() in [0, 1) and random(n) in [0, n): SplitMix64 of the row
        index plus a salt drawn once per compilation (as in the reference, a
        cached closure replays its sequence)."""
        salt = self.rng.getrandbits(63)
        bound = arg_fns[0] if arg_fns else None

        def random_fn(env: Env) -> CVal:
            idx = torch.arange(self.capacity, dtype=torch.int64, device=self.device) + salt
            u = K._shift_right_logical(K.splitmix64(idx), 11).to(torch.float64) / float(1 << 53)
            if bound is None:
                return CVal(u, self._full(True, torch.bool))
            b = bound(env)
            n = b.data.clamp(min=1).to(torch.float64)
            return CVal(torch.floor(u * n).to(torch.int64), b.valid & (b.data > 0))

        return random_fn

    def _compile_datetime_fn(self, expr: Call) -> Tuple[Compiled, Optional[Dictionary]]:
        """date_trunc/date_add/date_diff with a constant unit
        (DateTimeFunctions.java): calendar math on the device through the
        civil-date conversions; date_add of months clamps the day to the
        target month's length."""
        name = expr.name
        unit_arg = expr.args[0]
        if not isinstance(unit_arg, Constant) or not isinstance(unit_arg.value, str):
            raise CompileError(f"{name}: unit must be a string literal")
        unit = unit_arg.value.lower().rstrip("s")
        if unit not in ("day", "week", "month", "quarter", "year"):
            raise CompileError(f"{name} unit {unit!r} not supported")
        out_dt = expr.type.torch_dtype
        months = {"month": 1, "quarter": 3, "year": 12}.get(unit)

        def from_days(out_days, src_t, valid):
            if src_t == DATE:
                return CVal(out_days.to(out_dt), valid)
            return CVal((out_days * DAY_MICROS).to(out_dt), valid)

        if name == "date_trunc":
            inner, _ = self.compile(expr.args[1])
            src_t = expr.args[1].type

            def trunc_fn(env: Env) -> CVal:
                v = inner(env)
                days = _days_of(v.data, src_t).to(torch.int64)
                if unit == "day":
                    out_days = days
                elif unit == "week":  # ISO weeks start on Monday
                    out_days = days - torch.remainder(days + 3, 7)
                else:
                    y, m, _ = _civil_from_days(days)
                    if unit == "quarter":
                        m = ((m - 1) // 3) * 3 + 1
                    elif unit == "year":
                        m = torch.ones_like(m)
                    out_days = _days_from_civil(y, m, torch.ones_like(m))
                return from_days(out_days, src_t, v.valid)

            return trunc_fn, None

        if name == "date_add":
            amount_fn, _ = self.compile(expr.args[1])
            inner, _ = self.compile(expr.args[2])
            src_t = expr.args[2].type

            def add_fn(env: Env) -> CVal:
                amt, v = amount_fn(env), inner(env)
                days = _days_of(v.data, src_t).to(torch.int64)
                n = amt.data.to(torch.int64)
                if unit == "day":
                    out_days = days + n
                elif unit == "week":
                    out_days = days + 7 * n
                else:
                    y, m, d = _civil_from_days(days)
                    total = y * 12 + (m - 1) + n * months
                    ny = torch.div(total, 12, rounding_mode="floor")
                    nm = torch.remainder(total, 12) + 1
                    one = torch.ones_like(nm)
                    month_start = _days_from_civil(ny, nm, one)
                    next_start = _days_from_civil(
                        ny + (nm == 12).to(ny.dtype), torch.where(nm == 12, 1, nm + 1), one)
                    out_days = month_start + torch.minimum(d, next_start - month_start) - 1
                return from_days(out_days, src_t, v.valid & amt.valid)

            return add_fn, None

        # date_diff(unit, a, b): the unit boundaries from a to b
        a_fn, _ = self.compile(expr.args[1])
        b_fn, _ = self.compile(expr.args[2])
        at, bt = expr.args[1].type, expr.args[2].type

        def diff_fn(env: Env) -> CVal:
            va, vb = a_fn(env), b_fn(env)
            da = _days_of(va.data, at).to(torch.int64)
            db = _days_of(vb.data, bt).to(torch.int64)
            if unit == "day":
                out = db - da
            elif unit == "week":
                out = torch.div(db - da, 7, rounding_mode="floor")
            else:
                ya, ma, _ = _civil_from_days(da)
                yb, mb, _ = _civil_from_days(db)
                out = torch.div((yb * 12 + mb) - (ya * 12 + ma), months, rounding_mode="floor")
            return CVal(out.to(out_dt), va.valid & vb.valid)

        return diff_fn, None

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

    def _const_args(self, expr: Call, what: str = "non-leading arguments") -> list:
        args = []
        for a in expr.args[1:]:
            if not isinstance(a, Constant):
                raise CompileError(f"{expr.name}: {what} must be constant")
            args.append(a.value)
        return args

    def _lut_fn(self, value: IrExpr, lut_np: np.ndarray, ok_np=None) -> Compiled:
        """A closure gathering a host LUT over ``value``'s dictionary codes
        (``ok_np`` False marks a NULL result)."""
        inner, _ = self.compile(value)
        lut = torch.as_tensor(lut_np, device=self.device)
        ok = None if ok_np is None else torch.as_tensor(ok_np, device=self.device)

        def lut_fn(env: Env) -> CVal:
            v = inner(env)
            codes = v.data.to(torch.int64).clamp(0, lut.shape[0] - 1)
            valid = v.valid if ok is None else v.valid & ok[codes]
            return CVal(lut[codes], valid)

        return lut_fn

    def _compile_concat(self, expr: Call) -> Tuple[Compiled, Optional[Dictionary]]:
        """concat over constants and up to two dictionary columns: the output
        dictionary is the product of the inputs' values, built on the host
        once; the device maps a pair of codes through an int LUT."""
        dyn = [i for i, a in enumerate(expr.args) if not isinstance(a, Constant)]
        consts = {i: a.value for i, a in enumerate(expr.args) if isinstance(a, Constant)}
        if not dyn:
            if any(v is None for v in consts.values()):
                return self.compile(Constant(expr.type, None))
            return self.compile(Constant(
                expr.type, "".join(str(consts[i]) for i in range(len(expr.args)))))
        dicts = {i: self._dict_of(expr.args[i]) for i in dyn}
        if any(d is None for d in dicts.values()):
            raise CompileError("concat requires dictionary-coded string columns")
        if len(dyn) > 2:
            raise CompileError("concat over 3+ non-constant strings not supported yet")
        sizes = [len(dicts[i]) for i in dyn]
        if len(dyn) == 2 and sizes[0] * sizes[1] > 1 << 16:
            raise CompileError(f"concat product vocabulary too large ({sizes[0]}x{sizes[1]})")

        def render(vals):  # argument index -> string value
            parts = []
            for i in range(len(expr.args)):
                v = vals.get(i) if i in dicts else consts.get(i)
                if v is None:
                    return None
                parts.append(str(v))
            return "".join(parts)

        if len(dyn) == 1:
            new_values = [render({dyn[0]: s}) for s in dicts[dyn[0]].values]
        else:
            i0, i1 = dyn
            new_values = [render({i0: s0, i1: s1})
                          for s0 in dicts[i0].values for s1 in dicts[i1].values]
        out_dict, lut_np = _build_code_lut(new_values)
        lut = torch.as_tensor(lut_np, device=self.device)
        fns = [self.compile(expr.args[i])[0] for i in dyn]
        n1 = sizes[1] if len(dyn) == 2 else 1

        def concat_fn(env: Env) -> CVal:
            vals = [f(env) for f in fns]
            pair = vals[0].data.to(torch.int64)
            valid = vals[0].valid
            if len(vals) == 2:
                pair = pair * n1 + vals[1].data
                valid = valid & vals[1].valid
            codes = lut[pair.clamp(0, lut.shape[0] - 1)]
            return CVal(codes.clamp(min=0), valid & (codes >= 0), out_dict)

        return concat_fn, out_dict

    def _compile_string_function(self, expr: Call) -> Tuple[Compiled, Optional[Dictionary]]:
        """A string function of a dictionary column and constant arguments:
        the host applies it once per dictionary value. A string result's
        dictionary is the sorted set of results and the device remaps codes
        through an old-code -> new-code LUT; a number or boolean result is
        a LUT gathered by code."""
        name = expr.name
        if name == "concat":
            return self._compile_concat(expr)
        value = expr.args[0]
        d = self._dict_of(value)
        if d is None:
            raise CompileError(f"{name} requires a dictionary column")
        vals = list(d.values)
        if name in _STRING_LENGTH_FUNCS:
            return self._lut_fn(value, np.array([len(s) for s in vals], dtype=np.int64)), None
        if name == "codepoint":
            return self._lut_fn(
                value, np.array([ord(s[0]) if s else 0 for s in vals], dtype=np.int64)), None
        if name in _STRING_ARRAY_LUTS:
            return self._compile_string_array(expr, d)
        if name in _STRING_INT_LUTS:
            fn, dtype = _STRING_INT_LUTS[name]
            args = self._const_args(expr)
            results = []
            for s in vals:
                try:
                    results.append(fn(s, *args))
                except Exception:  # noqa: BLE001 - a per-value failure is NULL
                    results.append(None)
            lut_np = np.array([(-1 if r is None else r) for r in results],
                              dtype=np.int64 if dtype != np.bool_ else np.bool_)
            ok_np = np.array([r is not None for r in results], dtype=np.bool_)
            return self._lut_fn(value, lut_np, ok_np), None
        if name in _JSON_LUTS:
            # a decimal argument compares as its value
            args = [a.value / 10**a.type.scale
                    if isinstance(a.type, DecimalType) and a.value is not None else a.value
                    for a in expr.args[1:] if isinstance(a, Constant)]
            if len(args) != len(expr.args) - 1:
                raise CompileError(f"{name}: arguments must be constant")
            if any(v is None for v in args):
                return self.compile(Constant(expr.type, None))  # a SQL NULL argument
            results = [json_lut_value(name, s, args) for s in vals]
            lut_np = np.array([0 if r is None else r for r in results],
                              dtype=np.bool_ if name == "json_array_contains" else np.int64)
            ok_np = np.array([r is not None for r in results], dtype=np.bool_)
            return self._lut_fn(value, lut_np, ok_np), None
        if name in _DISTANCE_FUNCS:
            other = expr.args[1]
            if not isinstance(other, Constant):
                raise CompileError(f"{name}: second argument must be constant")
            dist = _DISTANCE_FUNCS[name]
            lut_np = np.array([dist(s, other.value or "") for s in vals], dtype=np.int64)
            return self._lut_fn(value, lut_np, lut_np >= 0), None
        if name == "strpos":
            if not isinstance(expr.args[1], Constant):
                raise CompileError("strpos needle must be constant")
            needle = expr.args[1].value
            return self._lut_fn(
                value, np.array([s.find(needle) + 1 for s in vals], dtype=np.int64)), None
        if name == "starts_with":
            if not isinstance(expr.args[1], Constant):
                raise CompileError("starts_with prefix must be constant")
            # a prefix is one code range of the sorted dictionary
            prefix = expr.args[1].value
            lo = d.searchsorted(prefix, "left")
            hi = d.searchsorted(prefix + "￿", "right")
            inner, _ = self.compile(value)

            def starts_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal((v.data >= lo) & (v.data < hi), v.valid)

            return starts_fn, None
        if name == "regexp_like":
            if not isinstance(expr.args[1], Constant):
                raise CompileError("regexp_like pattern must be constant")
            rx = re.compile(expr.args[1].value)
            lut_np = np.fromiter((rx.search(s) is not None for s in vals),
                                 dtype=np.bool_, count=len(vals))
            return self._lut_fn(value, lut_np), None

        args = self._const_args(expr)
        if any(v is None for v in args):
            return self.compile(Constant(expr.type, None))  # a SQL NULL argument
        transform = _STRING_FUNCS[name]
        out_dict, lut_np = _build_code_lut([transform(s, *args) for s in vals])
        lut = torch.as_tensor(lut_np, device=self.device)
        inner, _ = self.compile(value)

        def transform_fn(env: Env) -> CVal:
            v = inner(env)
            codes = _gather_codes(lut, v.data)
            return CVal(codes.clamp(min=0), v.valid & (codes >= 0), out_dict)

        return transform_fn, out_dict

    def _compile_string_array(self, expr: Call, d: Dictionary):
        """``split``, ``regexp_split`` and ``regexp_extract_all``: the parts
        of every dictionary value are computed once on the host; their union
        is the element dictionary, and each row gathers its value's
        ``[W]`` code lanes from a ``[vocabulary, W]`` LUT."""
        name = expr.name
        fn = _STRING_ARRAY_LUTS[name]
        cargs = self._const_args(expr, "arguments")
        parts = []
        for s in d.values:
            try:
                parts.append(list(fn(s, *cargs)))
            except Exception:  # noqa: BLE001 - a per-value failure is NULL
                parts.append(None)
        w = max((len(p) for p in parts if p is not None), default=1) or 1
        vocab = sorted({p for ps in parts if ps is not None for p in ps})
        child = Dictionary(np.asarray(vocab, dtype=object))
        code_of = {s: i for i, s in enumerate(vocab)}
        codes_np = np.zeros((len(parts), w), dtype=np.int32)
        len_np = np.zeros(len(parts), dtype=np.int32)
        ok_np = np.zeros(len(parts), dtype=np.bool_)
        for i, ps in enumerate(parts):
            if ps is None:
                continue
            ok_np[i] = True
            len_np[i] = len(ps)
            codes_np[i, :len(ps)] = [code_of[p] for p in ps]
        codes, lens, ok = (torch.as_tensor(x, device=self.device)
                           for x in (codes_np, len_np, ok_np))
        inner, _ = self.compile(expr.args[0])
        lane = torch.arange(w, device=self.device)[None, :]

        def split_fn(env: Env) -> CVal:
            v = inner(env)
            idx = v.data.to(torch.int64).clamp(0, len(parts) - 1)
            lengths = lens[idx]
            return CVal(codes[idx], v.valid & ok[idx], child, lengths, lane < lengths[:, None])

        return split_fn, child

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
