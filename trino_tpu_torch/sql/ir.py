"""Planner IR — the typed expression language the optimizer and compiler consume.

Reference blueprint: core/trino-main/src/main/java/io/trino/sql/ir/ (Expression,
Call, Case, Cast, Constant, Reference, Logical...; SURVEY.md §2.2 "IR — planner
expression language (distinct from AST)"). Every node carries its resolved SQL type.
The expression compiler (trino_tpu.ops.compiler) lowers this IR to XLA, playing the
role of io.trino.sql.gen.PageFunctionCompiler (SURVEY.md §2.4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from ..spi.types import BOOLEAN, Type


class IrExpr:
    """Base IR expression; every node has a .type."""

    __slots__ = ()

    @property
    def type(self) -> Type:
        raise NotImplementedError


@dataclass(frozen=True)
class Reference(IrExpr):
    """Reference to a plan symbol (ref: sql/ir/Reference.java)."""

    symbol: str
    _type: Type = None

    @property
    def type(self) -> Type:
        return self._type

    def __str__(self):
        return self.symbol


@dataclass(frozen=True)
class Constant(IrExpr):
    """Typed literal; value is a host Python value in *storage* representation
    (e.g. decimal -> scaled int, varchar -> the string itself — the compiler maps
    strings to dictionary codes per input column). ref: sql/ir/Constant.java."""

    _type: Type = None
    value: Any = None

    @property
    def type(self) -> Type:
        return self._type

    def __str__(self):
        return f"{self.value!r}"


@dataclass(frozen=True)
class Call(IrExpr):
    """Function invocation; operators are functions ($add, $eq, ...) exactly as in
    Trino IR. ref: sql/ir/Call.java."""

    name: str = ""
    args: Tuple[IrExpr, ...] = ()
    _type: Type = None

    @property
    def type(self) -> Type:
        return self._type

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class Lambda(IrExpr):
    """Typed lambda for higher-order functions (ref: sql/ir/Lambda.java).
    ``params`` are fresh plan symbols (never colliding with columns);
    ``type`` is the body's result type."""

    params: Tuple[str, ...] = ()
    param_types: Tuple[Type, ...] = ()
    body: "IrExpr" = None

    @property
    def type(self) -> Type:
        return self.body.type

    def __str__(self):
        return f"({', '.join(self.params)}) -> {self.body}"


@dataclass(frozen=True)
class Case(IrExpr):
    """Searched CASE (simple CASE is lowered to searched at analysis).
    ref: sql/ir/Case.java."""

    whens: Tuple[Tuple[IrExpr, IrExpr], ...] = ()
    default: Optional[IrExpr] = None
    _type: Type = None

    @property
    def type(self) -> Type:
        return self._type

    def __str__(self):
        parts = " ".join(f"WHEN {c} THEN {r}" for c, r in self.whens)
        return f"CASE {parts} ELSE {self.default} END"


@dataclass(frozen=True)
class CastExpr(IrExpr):
    value: IrExpr = None
    _type: Type = None
    safe: bool = False

    @property
    def type(self) -> Type:
        return self._type

    def __str__(self):
        return f"CAST({self.value} AS {self._type.display()})"


@dataclass(frozen=True)
class InLut(IrExpr):
    """Dictionary-LUT predicate: value's dict code indexes a host-computed boolean
    table (used for LIKE / IN over VARCHAR; see SURVEY.md §7 strings strategy)."""

    value: IrExpr = None
    lut: Tuple[bool, ...] = ()  # indexed by dictionary code
    description: str = ""

    @property
    def type(self) -> Type:
        return BOOLEAN

    def __str__(self):
        return f"in_lut({self.value}, {self.description})"


def references(expr: IrExpr) -> set:
    """All symbols referenced by an IR expression."""
    out: set = set()

    def walk(e: IrExpr):
        if isinstance(e, Reference):
            out.add(e.symbol)
        elif isinstance(e, Call):
            for a in e.args:
                walk(a)
        elif isinstance(e, Case):
            for c, r in e.whens:
                walk(c)
                walk(r)
            if e.default is not None:
                walk(e.default)
        elif isinstance(e, CastExpr):
            walk(e.value)
        elif isinstance(e, InLut):
            walk(e.value)
        elif isinstance(e, Lambda):
            inner = references(e.body)
            out.update(inner - set(e.params))

    walk(expr)
    return out


# per-row nondeterministic functions (ref: io.trino.metadata.FunctionManager
# isDeterministic; current_timestamp et al are constant-per-query and thus
# deterministic for plan rewrites)
_NONDETERMINISTIC = frozenset({"random", "rand", "uuid", "shuffle"})


def is_deterministic(expr: IrExpr) -> bool:
    """True when the expression yields the same value for the same inputs —
    rewrites that duplicate or re-site an expression (equality inference,
    predicate mirroring) must skip nondeterministic ones."""
    ok = True

    def walk(e: IrExpr):
        nonlocal ok
        if isinstance(e, Call):
            if e.name in _NONDETERMINISTIC:
                ok = False
            for a in e.args:
                walk(a)
        elif isinstance(e, Case):
            for c, r in e.whens:
                walk(c)
                walk(r)
            if e.default is not None:
                walk(e.default)
        elif isinstance(e, CastExpr):
            walk(e.value)
        elif isinstance(e, InLut):
            walk(e.value)
        elif isinstance(e, Lambda):
            walk(e.body)

    walk(expr)
    return ok


def substitute(expr: IrExpr, mapping: dict) -> IrExpr:
    """Replace Reference(symbol) per ``mapping`` (symbol -> IrExpr)."""
    if isinstance(expr, Reference):
        return mapping.get(expr.symbol, expr)
    if isinstance(expr, Call):
        return Call(expr.name, tuple(substitute(a, mapping) for a in expr.args), expr._type)
    if isinstance(expr, Case):
        return Case(
            tuple((substitute(c, mapping), substitute(r, mapping)) for c, r in expr.whens),
            substitute(expr.default, mapping) if expr.default is not None else None,
            expr._type,
        )
    if isinstance(expr, CastExpr):
        return CastExpr(substitute(expr.value, mapping), expr._type, expr.safe)
    if isinstance(expr, InLut):
        return InLut(substitute(expr.value, mapping), expr.lut, expr.description)
    if isinstance(expr, Lambda):
        # params shadow outer symbols
        inner = {k: v for k, v in mapping.items() if k not in expr.params}
        return Lambda(expr.params, expr.param_types, substitute(expr.body, inner))
    return expr
