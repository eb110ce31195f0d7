"""Expression programs: a fused projection lowered for one kernel launch.

Trino generates JVM bytecode for an expression; the reference traces its
compiled closures into the one Pallas launch of ``expand_phase``. The port
lowers each assignment of the fused projection to a short straight-line
**program** over a register file of 64-bit values, each with a validity
bit, which ``hopper_kernels.expr_program`` interprets for every row of the
joined page in one launch (``csrc/expr_program.cu``), reading each input
column once and writing each output once. Its plain version,
:func:`run_plain`, runs the same instructions as torch operations over
whole columns, through the helpers the closures use, so on the CPU it
gives the closures' values bit for bit.

What lowers (the expression's shape decides, when the program is built):
references (integers, booleans, dates, doubles, short decimals, dictionary
codes), non-string constants and NULL, the numeric casts (short-decimal
rescale, integer to decimal, decimal to integer, decimal or integer to
double, integer widening and narrowing, a number to boolean), ``+ - * / %``
and negation on integers, short decimals and doubles, the comparisons on
numbers and dates and of a dictionary string against a constant, ``$and``,
``$or``, ``$not``, ``$is_null``, ``$not_null``, ``coalesce``, ``InLut``, a
searched CASE with a non-string result, and ``year``/``month``/``day`` of a
DATE. Everything else (string-valued results, long decimals, nested
values, other functions) is not lowered: the assignment keeps its closure,
and the executor ticks ``megakernels.STAGES["project_torch"]`` each time
it runs. A bare reference is a rename and needs no program. A projection
past one of the program's limits (``hopper_kernels.EXPR_MAX_*``) keeps the
assignments that do not fit on their closures.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..spi.types import (
    BOOLEAN,
    DATE,
    UNKNOWN,
    DecimalType,
    DoubleType,
    IntegralType,
    is_integral,
    is_long_decimal,
    is_nested,
    is_numeric,
    is_string,
)
from ..sql.ir import Call, Case, CastExpr, Constant, InLut, Reference
from . import compiler as C
from . import hopper_kernels as HK
from .scalar_functions import _COMPARE, _civil_from_days

# opcodes (ExprOp in csrc/expr_program.cu)
OPS = {
    "load": 0, "const": 1, "add": 2, "sub": 3, "mul": 4, "neg": 5, "idiv": 6, "imod": 7,
    "fadd": 8, "fsub": 9, "fmul": 10, "fdiv": 11, "fmod": 12, "fneg": 13, "divs": 14,
    "i2f": 15, "wrap": 16, "tobool": 17, "ftobool": 18, "cmp": 19, "fcmp": 20, "and": 21,
    "or": 22, "not": 23, "is_null": 24, "not_null": 25, "select": 26, "coalesce": 27,
    "lut": 28, "date_part": 29, "div_round": 30, "store": 31,
}
# register and column dtypes (KeyType in csrc/join_keys.cuh)
_T = {torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3, torch.bool: 4,
      torch.float64: 5}
_CMP = ("$eq", "$ne", "$lt", "$lte", "$gt", "$gte")
_ARITH = {"$add": ("add", "fadd"), "$subtract": ("sub", "fsub"),
          "$multiply": ("mul", "fmul")}
_DATE_PARTS = ("year", "month", "day")
F64 = torch.float64


class NotLowered(Exception):
    """An expression the program does not lower (it keeps its closure)."""


@dataclass
class _Op:
    """One SSA instruction: ``args`` are value ids (earlier ops), ``dt`` the
    torch dtype of its value, ``aux`` its small immediate and ``extra``
    what the plain version needs besides (a constant's value, a divisor,
    a comparison's name, a LUT)."""

    op: str
    args: Tuple[int, ...]
    dt: Optional[torch.dtype]
    aux: int = 0
    extra: object = None


@dataclass
class ExprProgram:
    """A lowered projection. ``code``: the kernel's instructions ``(op, dst,
    a, b, c, t, aux)`` over physical registers; ``plain``: the same as
    ``(op, dst, args, dt, aux, extra)`` for :func:`run_plain`; ``consts``:
    int64 bits; ``luts``: bool tensors on the program's device;
    ``input_symbols``/``input_dtypes``: the columns it reads;
    ``output_dtypes``: one per lowered assignment; ``assign_out``: per
    assignment its output index, ``RENAME`` or ``CLOSURE``."""

    code: List[tuple] = field(default_factory=list)
    plain: List[tuple] = field(default_factory=list)
    consts: List[int] = field(default_factory=list)
    luts: List[torch.Tensor] = field(default_factory=list)
    input_symbols: Tuple[str, ...] = ()
    input_dtypes: Tuple[torch.dtype, ...] = ()
    output_dtypes: Tuple[torch.dtype, ...] = ()
    assign_out: Tuple[int, ...] = ()
    n_regs: int = 0


RENAME, CLOSURE = -2, -1


def _dtype_of(t) -> torch.dtype:
    """The storage dtype of a flat column of type ``t`` a register holds."""
    if is_nested(t) or is_long_decimal(t) or getattr(t, "storage_lanes", None) is not None:
        raise NotLowered(f"{t.display()} values")
    dt = t.torch_dtype
    if dt not in _T:
        raise NotLowered(f"{dt} storage")
    return dt


def _number(t) -> bool:
    """Integers, short decimals and doubles: the arithmetic's operands."""
    return (isinstance(t, (IntegralType, DoubleType))
            or (isinstance(t, DecimalType) and not is_long_decimal(t)))


def _comparable(t) -> bool:
    return _number(t) or t == BOOLEAN or t == DATE


def _bits(value, dt: torch.dtype) -> int:
    """A constant's int64 register bits, converted as torch.full converts
    it."""
    x = torch.full((1,), value, dtype=dt)[0].item()
    if dt == F64:
        return struct.unpack("<q", struct.pack("<d", x))[0]
    return int(x)


class _Builder:
    """Lowers assignments into one SSA op list, with common subexpressions
    shared (every op is a pure function of its inputs)."""

    def __init__(self, layout, device):
        self.layout = layout
        self.device = device
        self.ops: List[_Op] = []
        self.memo: Dict[object, int] = {}
        self.inputs: Dict[str, int] = {}
        self.input_dtypes: List[torch.dtype] = []
        self.consts: Dict[int, int] = {}
        self.luts: Dict[tuple, int] = {}
        self.lut_tensors: List[torch.Tensor] = []
        self.outputs: List[torch.dtype] = []

    # -------------------------------------------------------------- helpers

    def emit(self, op: str, args=(), dt=None, aux: int = 0, extra=None) -> int:
        self.ops.append(_Op(op, tuple(args), dt, aux, extra))
        return len(self.ops) - 1

    def dt(self, v: int) -> torch.dtype:
        return self.ops[v].dt

    def const_index(self, bits: int) -> int:
        if bits not in self.consts:
            self.consts[bits] = len(self.consts)
        return self.consts[bits]

    def const(self, value, dt: torch.dtype, valid: bool = True) -> int:
        # keyed by bits: 0.0 and -0.0 (and 1 and True) are equal Python keys
        bits = _bits(value, dt)
        key = ("const", bits, dt, valid)
        if key not in self.memo:
            self.memo[key] = self.emit("const", (), dt, self.const_index(bits), (value, valid))
        return self.memo[key]

    def cvt(self, v: int, dt: torch.dtype) -> int:
        """``.to(dt)`` of a value."""
        src = self.dt(v)
        if src == dt:
            return v
        if src == F64:
            if dt == torch.bool:
                return self.emit("ftobool", (v,), dt)
            raise NotLowered("a double converted to an integer")
        if dt == F64:
            return self.emit("i2f", (v,), dt)
        if dt == torch.bool:
            return self.emit("tobool", (v,), dt)
        return self.emit("wrap", (v,), dt)

    def truth(self, v: int) -> int:
        """A value as a condition (``.to(torch.bool)``)."""
        return self.cvt(v, torch.bool) if self.dt(v) == F64 else v

    # ------------------------------------------------------------- lowering

    def lower(self, expr) -> int:
        if isinstance(expr, Constant):
            return self._lower(expr)  # memoized by its bits in const()
        try:
            hit = self.memo.get(expr)
        except TypeError:
            raise NotLowered("an unhashable expression") from None
        if hit is None:
            hit = self._lower(expr)
            self.memo[expr] = hit
        return hit

    def _lower(self, expr) -> int:
        if isinstance(expr, Reference):
            lay = self.layout.get(expr.symbol)
            if lay is None:
                raise NotLowered(f"unknown symbol {expr.symbol}")
            dt = _dtype_of(lay.type)
            if expr.symbol not in self.inputs:
                self.inputs[expr.symbol] = len(self.inputs)
                self.input_dtypes.append(dt)
            return self.emit("load", (), dt, self.inputs[expr.symbol])
        if isinstance(expr, Constant):
            if is_string(expr.type):
                raise NotLowered("a string constant")
            value = expr.value
            return self.const(value if value is not None else 0, _dtype_of(expr.type),
                              value is not None)
        if isinstance(expr, CastExpr):
            return self._cast(expr)
        if isinstance(expr, Case):
            return self._case(expr)
        if isinstance(expr, InLut):
            v = self.lower(expr.value)
            if self.dt(v) == F64:
                raise NotLowered("a LUT indexed by a double")
            key = tuple(bool(x) for x in expr.lut)
            if key not in self.luts:
                self.luts[key] = len(self.lut_tensors)
                self.lut_tensors.append(torch.as_tensor(
                    np.asarray(expr.lut, dtype=np.bool_), device=self.device))
            k = self.luts[key]
            return self.emit("lut", (v,), torch.bool, k, self.lut_tensors[k])
        if isinstance(expr, Call):
            return self._call(expr)
        raise NotLowered(type(expr).__name__)

    def _cast(self, expr: CastExpr) -> int:
        src, dst = expr.value.type, expr.type
        if src == dst or (is_string(src) and is_string(dst)):
            return self.lower(expr.value)
        if src == UNKNOWN:
            return self.const(0, _dtype_of(dst), False)
        if is_string(src) or is_long_decimal(src) or is_long_decimal(dst):
            raise NotLowered(f"cast {src.display()} -> {dst.display()}")
        src_int = is_integral(src) or src == BOOLEAN
        if isinstance(src, DecimalType) and isinstance(dst, DecimalType):
            v = self.cvt(self.lower(expr.value), torch.int64)
            diff = dst.scale - src.scale
            if diff > 0:
                return self.emit("mul", (v, self.const(10**diff, torch.int64)), torch.int64)
            if diff < 0:
                return self._div_round(v, 10**-diff)
            return v
        if isinstance(dst, DecimalType) and src_int:
            v = self.cvt(self.lower(expr.value), torch.int64)
            return self.emit("mul", (v, self.const(10**dst.scale, torch.int64)), torch.int64)
        out = _dtype_of(dst)
        if isinstance(src, DecimalType) and is_integral(dst):
            return self.cvt(self._div_round(self.lower(expr.value), 10**src.scale), out)
        if isinstance(src, DecimalType) and isinstance(dst, DoubleType):
            v = self.cvt(self.lower(expr.value), F64)
            return self.emit("divs", (v,), F64, self.const_index(_bits(1.0 / float(10**src.scale),
                                                                    F64)),
                             float(10**src.scale))
        if (src_int or isinstance(src, DoubleType)) and (is_integral(dst)
                                                         or isinstance(dst, DoubleType)):
            return self.cvt(self.lower(expr.value), out)
        if is_numeric(src) and dst == BOOLEAN:
            v = self.lower(expr.value)
            return self.emit("ftobool" if self.dt(v) == F64 else "tobool", (v,), torch.bool)
        raise NotLowered(f"cast {src.display()} -> {dst.display()}")

    def _div_round(self, v: int, divisor: int) -> int:
        if self.dt(v) != torch.int64:
            raise NotLowered("a rescale of a narrow value")
        return self.emit("div_round", (v,), torch.int64,
                         self.const_index(_bits(divisor, torch.int64)), divisor)

    def _case(self, expr: Case) -> int:
        if is_string(expr.type) or is_nested(expr.type):
            raise NotLowered("a string or nested CASE")
        dt = _dtype_of(expr.type)
        whens = [(self.truth(self.lower(c)), self.cvt(self.lower(r), dt)) for c, r in expr.whens]
        acc = (self.cvt(self.lower(expr.default), dt) if expr.default is not None
               else self.const(0, dt, False))
        for cond, res in reversed(whens):
            acc = self.emit("select", (cond, res, acc), dt)
        return acc

    def _call(self, expr: Call) -> int:
        name, args = expr.name, expr.args
        if name in _CMP and any(is_string(a.type) for a in args):
            return self._string_compare(expr)
        if name in ("$and", "$or"):
            a, b = (self.truth(self.lower(x)) for x in args)
            return self.emit(name[1:], (a, b), torch.bool)
        if name == "$not":
            return self.emit("not", (self.truth(self.lower(args[0])),), torch.bool)
        if name in ("$is_null", "$not_null"):
            return self.emit(name[1:], (self.lower(args[0]),), torch.bool)
        if name == "coalesce":
            if is_string(expr.type):
                raise NotLowered("a string coalesce")
            dt = _dtype_of(expr.type)
            vals = [self.cvt(self.lower(a), dt) for a in args]
            acc = vals[-1]
            for v in reversed(vals[:-1]):
                acc = self.emit("coalesce", (v, acc), dt)
            return acc
        if any(is_long_decimal(a.type) for a in args) or is_long_decimal(expr.type):
            raise NotLowered("long decimals")
        out = _dtype_of(expr.type)
        if name in _DATE_PARTS:
            if len(args) != 1 or args[0].type != DATE:
                raise NotLowered(f"{name} of {args[0].type.display()}")
            v = self.lower(args[0])
            return self.cvt(self.emit("date_part", (v,), torch.int64,
                                      _DATE_PARTS.index(name)), out)
        if name in _CMP:
            if not all(_comparable(a.type) for a in args):
                raise NotLowered(f"{name} of {[a.type.display() for a in args]}")
            a, b = (self.lower(x) for x in args)
            k = _CMP.index(name)
            if torch.promote_types(self.dt(a), self.dt(b)) == F64:
                res = self.emit("fcmp", (self.cvt(a, F64), self.cvt(b, F64)), torch.bool, k, name)
            else:
                res = self.emit("cmp", (a, b), torch.bool, k, name)
            return self.cvt(res, out)
        if name == "$negate":
            if not _number(args[0].type):
                raise NotLowered(f"negation of {args[0].type.display()}")
            v = self.lower(args[0])
            dt = self.dt(v)
            return self.cvt(self.emit("fneg" if dt == F64 else "neg", (v,), dt), out)
        if name in _ARITH or name in ("$divide", "$modulus"):
            if not all(_number(a.type) for a in args):
                raise NotLowered(f"{name} of {[a.type.display() for a in args]}")
            a, b = (self.lower(x) for x in args)
            ta, tb = self.dt(a), self.dt(b)
            dt = torch.promote_types(ta, tb)
            o = expr.type
            if name in _ARITH:
                iop, fop = _ARITH[name]
                if dt == F64:
                    return self.cvt(self.emit(fop, (self.cvt(a, F64), self.cvt(b, F64)), F64), out)
                return self.cvt(self.emit(iop, (a, b), dt), out)
            integral_result = is_integral(o) or (name == "$modulus" and isinstance(o, DecimalType))
            if integral_result:
                if dt == F64:
                    raise NotLowered(f"{name} of doubles into {o.display()}")
                op = "idiv" if name == "$divide" else "imod"
                return self.cvt(self.emit(op, (a, b), dt, _T[ta] * 8 + _T[tb]), out)
            if name == "$divide":
                return self.cvt(self.emit("fdiv", (self.cvt(a, F64), self.cvt(b, F64)), F64), out)
            if dt != F64:
                raise NotLowered(f"{name} of integers into {o.display()}")
            return self.cvt(self.emit("fmod", (self.cvt(a, F64), self.cvt(b, F64)), F64), out)
        raise NotLowered(f"function {name}")

    def _dict_of(self, expr):
        if isinstance(expr, Reference):
            lay = self.layout.get(expr.symbol)
            return lay.dictionary if lay else None
        if isinstance(expr, CastExpr) and is_string(expr.value.type):
            return self._dict_of(expr.value)
        return None

    def _string_compare(self, expr: Call) -> int:
        """``column <op> 'constant'`` on dictionary codes, as
        ``compiler._compile_string_comparison``: equality against the
        constant's code (-1 where absent), ranges against its sorted
        position."""
        name = expr.name
        a, b = expr.args
        if isinstance(a, Constant) and not isinstance(b, Constant):
            name = {"$lt": "$gt", "$lte": "$gte", "$gt": "$lt", "$gte": "$lte"}.get(name, name)
            a, b = b, a
        d = self._dict_of(a)
        if not isinstance(b, Constant) or d is None:
            raise NotLowered("a string comparison of two columns")
        s = b.value
        if name in ("$eq", "$ne") and s is None:
            return self.const(False, torch.bool, False)
        if s is None:
            raise NotLowered("a range against NULL")
        v = self.lower(a)
        if self.dt(v) == F64:
            raise NotLowered("string codes as doubles")
        if name in ("$eq", "$ne"):
            code = self.const(d.code_of(s), torch.int64)
            return self.emit("cmp", (v, code), torch.bool, _CMP.index(name), name)
        left, right = d.searchsorted(s, "left"), d.searchsorted(s, "right")
        bound, op = {"$lt": (left, "$lt"), "$lte": (right, "$lt"), "$gt": (right, "$gte"),
                     "$gte": (left, "$gte")}[name]
        return self.emit("cmp", (v, self.const(bound, torch.int64)), torch.bool,
                         _CMP.index(op), op)

    def assign(self, expr, out_type) -> None:
        """One assignment, lowered and stored as the next output."""
        if is_string(out_type) or is_string(expr.type):
            raise NotLowered("a string-valued result")
        v = self.cvt(self.lower(expr), _dtype_of(out_type))
        self.emit("store", (v,), None, len(self.outputs))
        self.outputs.append(_dtype_of(out_type))


def _allocate(ops: List[_Op]):
    """Physical registers by linear scan: each op's operands are read before
    its result is written, so a value's register is free after its last
    use. Returns (dst register per op, registers used)."""
    last = {}
    for k, o in enumerate(ops):
        for a in o.args:
            last[a] = k
    free: List[int] = []
    used = 0
    reg: Dict[int, int] = {}
    for k, o in enumerate(ops):
        for a in set(o.args):
            if last[a] == k:
                free.append(reg[a])
        if o.op == "store":
            continue
        if free:
            free.sort()
            reg[k] = free.pop(0)
        else:
            reg[k] = used
            used += 1
    return reg, used


def _within_limits(b: _Builder) -> bool:
    _, regs = _allocate(b.ops)
    return (len(b.ops) <= HK.EXPR_MAX_INSTRS and regs <= HK.EXPR_MAX_REGS
            and len(b.consts) <= HK.EXPR_MAX_CONSTS and len(b.inputs) <= HK.EXPR_MAX_INPUTS
            and len(b.outputs) <= HK.EXPR_MAX_OUTPUTS
            and len(b.lut_tensors) <= HK.EXPR_MAX_LUTS)


def _snapshot(b: _Builder):
    return (len(b.ops), dict(b.memo), dict(b.inputs), len(b.input_dtypes), dict(b.consts),
            dict(b.luts), len(b.lut_tensors), len(b.outputs))


def _restore(b: _Builder, snap) -> None:
    n_ops, memo, inputs, n_in, consts, luts, n_luts, n_out = snap
    del b.ops[n_ops:]
    b.memo, b.inputs, b.consts, b.luts = memo, inputs, consts, luts
    del b.input_dtypes[n_in:]
    del b.lut_tensors[n_luts:]
    del b.outputs[n_out:]


def build_program(assignments, out_types, layout, device) -> ExprProgram:
    """The program of a projection's ``assignments`` ((symbol, expr) pairs,
    their column types ``out_types``) over input ``layout``
    (``compiler.ColumnLayout`` by symbol): every assignment that lowers and
    fits the limits, in order; cached as the compiler caches closures
    (``compiler.clear_cache`` drops it)."""
    device = torch.device(device)
    key = (tuple(assignments), tuple(out_types),
           tuple(sorted(layout.items(), key=lambda kv: kv[0])), device)
    hit = C.PROGRAM_CACHE.get(key)
    if hit is not None:
        return hit
    b = _Builder(layout, device)
    assign_out = []
    for (_, expr), out_type in zip(assignments, out_types):
        if isinstance(expr, Reference):
            assign_out.append(RENAME)
            continue
        snap = _snapshot(b)
        try:
            b.assign(expr, out_type)
        except NotLowered:
            _restore(b, snap)
            assign_out.append(CLOSURE)
            continue
        if not _within_limits(b):
            _restore(b, snap)
            assign_out.append(CLOSURE)
            continue
        assign_out.append(len(b.outputs) - 1)
    reg, used = _allocate(b.ops)
    code, plain = [], []
    for k, o in enumerate(b.ops):
        regs = [reg[a] for a in o.args]
        a, bb, c = (regs + [0, 0, 0])[:3]
        if o.op == "const":
            a = int(o.extra[1])  # the kernel reads a constant's validity from its a field
        dst = reg.get(k, 0)
        t = _T[o.dt] if o.dt is not None else 0
        code.append((OPS[o.op], dst, a, bb, c, t, o.aux))
        plain.append((o.op, dst, tuple(regs), o.dt, o.aux, o.extra))
    prog = ExprProgram(
        code=code, plain=plain, consts=sorted(b.consts, key=b.consts.get),
        luts=list(b.lut_tensors), input_symbols=tuple(sorted(b.inputs, key=b.inputs.get)),
        input_dtypes=tuple(b.input_dtypes), output_dtypes=tuple(b.outputs),
        assign_out=tuple(assign_out), n_regs=used,
    )
    C.PROGRAM_CACHE[key] = prog
    return prog


def _idiv(a, b):
    q = torch.div(a.abs(), b.abs().clamp(min=1), rounding_mode="floor")
    return q * (a.sign() * b.sign())


def _imod(a, b):
    return torch.remainder(a.abs(), b.abs().clamp(min=1)) * a.sign()


_PLAIN_BINARY = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b, "mul": lambda a, b: a * b,
    "fadd": lambda a, b: a + b, "fsub": lambda a, b: a - b, "fmul": lambda a, b: a * b,
    "fdiv": lambda a, b: a / b, "fmod": torch.remainder, "idiv": _idiv, "imod": _imod,
}


def run_plain(program: ExprProgram, inputs, rows=None):
    """The program's instructions in order as torch operations over whole
    columns (the closures' own operations, on the same registers the
    kernel uses); ``rows`` (a column of the page) gives the row count and
    device where it reads no input. Returns each output's (data, valid)."""
    rows = inputs[0][1] if inputs else rows
    n, dev = rows.shape[0], rows.device
    regs: List = [None] * max(program.n_regs, 1)
    outs: List = [None] * len(program.output_dtypes)
    for op, dst, args, dt, aux, extra in program.plain:
        x = [regs[a] for a in args]
        if op == "load":
            res = inputs[aux]
        elif op == "const":
            value, ok = extra
            res = (torch.full((n,), value, dtype=dt, device=dev),
                   torch.full((n,), ok, dtype=torch.bool, device=dev))
        elif op in _PLAIN_BINARY:
            res = (_PLAIN_BINARY[op](x[0][0], x[1][0]), x[0][1] & x[1][1])
        elif op in ("neg", "fneg"):
            res = (-x[0][0], x[0][1])
        elif op == "divs":
            res = (x[0][0] / extra, x[0][1])
        elif op in ("i2f", "wrap"):
            res = (x[0][0].to(dt), x[0][1])
        elif op in ("tobool", "ftobool"):
            res = (x[0][0] != 0, x[0][1])
        elif op in ("cmp", "fcmp"):
            res = (_COMPARE[extra](x[0][0], x[1][0]), x[0][1] & x[1][1])
        elif op in ("and", "or"):
            (a, va), (b, vb) = x
            ad, bd = a.to(torch.bool), b.to(torch.bool)
            if op == "and":
                yes, no = (va & ad) & (vb & bd), (va & ~ad) | (vb & ~bd)
            else:
                yes, no = (va & ad) | (vb & bd), (va & ~ad) & (vb & ~bd)
            res = (yes, no | yes)
        elif op == "not":
            res = (~x[0][0].to(torch.bool), x[0][1])
        elif op in ("is_null", "not_null"):
            v = x[0][1]
            res = (~v if op == "is_null" else v, torch.ones(n, dtype=torch.bool, device=dev))
        elif op == "select":
            (c, vc), (r, vr), (acc, vacc) = x
            fire = vc & c.to(torch.bool)
            res = (torch.where(fire, r, acc), torch.where(fire, vr, vacc))
        elif op == "coalesce":
            (a, va), (b, vb) = x
            res = (torch.where(va, a, b), vb | va)
        elif op == "lut":
            res = (extra[x[0][0].to(torch.int64).clamp(0, extra.shape[0] - 1)], x[0][1])
        elif op == "date_part":
            res = (_civil_from_days(x[0][0])[aux], x[0][1])
        elif op == "div_round":
            res = (C._div_round(x[0][0], extra), x[0][1])
        elif op == "store":
            outs[aux] = x[0]
            continue
        else:
            raise ValueError(f"expr_program: unknown instruction {op!r}")
        regs[dst] = res
    return outs
