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
``$not``, IS [NOT] NULL; integer and short-decimal ``+ - *`` and negation;
CAST between integers and short decimals (with round-half-up rescale);
dictionary-coded ``=``/``<>``/ranges and ``InLut``. Anything else raises
:class:`CompileError` naming the function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..spi.page import Dictionary
from ..spi.types import (
    BOOLEAN,
    UNKNOWN,
    DecimalType,
    Type,
    is_integral,
    is_long_decimal,
    is_string,
)
from ..sql.ir import Call, CastExpr, Constant, InLut, IrExpr, Reference


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

_ARITH = {
    "$add": lambda a, b: a + b,
    "$subtract": lambda a, b: a - b,
    # decimal x decimal: the scales add, which is the product's type
    "$multiply": lambda a, b: a * b,
}


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
            if is_long_decimal(type_) or type_.storage_lanes is not None:
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
            raise CompileError(f"cast {src.display()} -> {dst.display()} not supported")
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
        if src_int and dst_int:

            def int_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(v.data.to(out_dt), v.valid)

            return int_fn, None
        if is_integral(src) and dst == BOOLEAN:

            def bool_fn(env: Env) -> CVal:
                v = inner(env)
                return CVal(v.data != 0, v.valid)

            return bool_fn, None
        raise CompileError(f"unsupported cast {src.display()} -> {dst.display()}")

    # ------------------------------------------------------------------ calls

    def _dict_of(self, expr: IrExpr) -> Optional[Dictionary]:
        if isinstance(expr, Reference):
            lay = self.layout.get(expr.symbol)
            return lay.dictionary if lay else None
        if isinstance(expr, CastExpr):
            return self._dict_of(expr.value)
        if isinstance(expr, (Call, Constant)) and is_string(expr.type):
            return self.compile(expr)[1]
        return None

    def _compile_call(self, expr: Call) -> Tuple[Compiled, Optional[Dictionary]]:
        name = expr.name
        if name in _COMPARE and any(is_string(a.type) for a in expr.args):
            return self._compile_string_comparison(expr)
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

        if any(is_long_decimal(a.type) for a in expr.args) or is_long_decimal(expr.type):
            raise CompileError(f"{name} on DECIMAL(p>18) not supported")
        if name in _COMPARE:
            op = _COMPARE[name]
        elif name in _ARITH and all(
            is_integral(a.type) or isinstance(a.type, DecimalType) for a in expr.args
        ):
            op = _ARITH[name]
        elif name == "$negate" and (
            is_integral(expr.type) or isinstance(expr.type, DecimalType)
        ):
            op = torch.neg
        else:
            raise CompileError(f"no device lowering for function {name}")
        out_dt = expr.type.torch_dtype

        def call_fn(env: Env) -> CVal:
            vals = [f(env) for f in arg_fns]
            data = op(*(v.data for v in vals))
            valid = vals[0].valid
            for v in vals[1:]:
                valid = valid & v.valid
            return CVal(data if data.dtype == out_dt else data.to(out_dt), valid)

        return call_fn, None

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
