"""The port's expression compiler against ``trino_tpu.ops.compiler`` on the
slice's expressions. The same IR is built in both packages over the same
numpy columns (made from a seed, with NULLs); outputs must agree bit for bit
in validity and, where valid, in data."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import trino_tpu.sql.ir as rir
import trino_tpu.spi.types as rtypes
from trino_tpu.ops import compiler as rc
from trino_tpu.spi.page import Dictionary as RefDictionary

import trino_tpu_torch.sql.ir as pir
import trino_tpu_torch.spi.types as ptypes
from trino_tpu_torch.ops import compiler as pc
from trino_tpu_torch.spi.page import Dictionary

N = 257
VOCAB = np.asarray(["AIR", "FOB", "MAIL", "RAIL", "SHIP"], dtype=object)
COLUMNS = {  # symbol -> (type name, values)
    "a": ("bigint", lambda r: r.integers(-(10**9), 10**9, N)),
    "b": ("bigint", lambda r: r.integers(-(10**9), 10**9, N)),
    "i": ("integer", lambda r: r.integers(-50, 50, N).astype(np.int32)),
    "d1": ("decimal(12,2)", lambda r: r.integers(-(10**7), 10**7, N)),
    "d2": ("decimal(15,4)", lambda r: r.integers(-(10**9), 10**9, N)),
    "s": ("varchar", lambda r: r.integers(0, len(VOCAB), N).astype(np.int32)),
    "f": ("boolean", lambda r: r.random(N) < 0.5),
}


class NS:
    """One package's IR constructors and types, so each entry of EXPRESSIONS
    makes the same expression in either package."""

    def __init__(self, ir, types):
        self.ir, self.t = ir, types

    def ref(self, sym):
        return self.ir.Reference(sym, self.t.parse_type(COLUMNS[sym][0]))

    def const(self, type_name, value):
        return self.ir.Constant(self.t.parse_type(type_name), value)

    def call(self, name, args, type_name):
        return self.ir.Call(name, tuple(args), self.t.parse_type(type_name))

    def cast(self, value, type_name):
        return self.ir.CastExpr(value, self.t.parse_type(type_name))


EXPRESSIONS = {
    "add": lambda n: n.call("$add", [n.ref("a"), n.ref("b")], "bigint"),
    "subtract_int_const": lambda n: n.call(
        "$subtract", [n.ref("i"), n.const("integer", 7)], "integer"),
    "decimal_rescale_subtract": lambda n: n.call(
        "$subtract", [n.const("decimal(13,2)", 100), n.cast(n.ref("d1"), "decimal(13,2)")],
        "decimal(13,2)"),
    "decimal_multiply": lambda n: n.call(
        "$multiply", [n.ref("d1"), n.ref("d2")], "decimal(18,6)"),
    "negate": lambda n: n.call("$negate", [n.ref("d2")], "decimal(15,4)"),
    "cast_decimal_down": lambda n: n.cast(n.ref("d2"), "decimal(12,2)"),
    "cast_decimal_up": lambda n: n.cast(n.ref("d1"), "decimal(15,4)"),
    "cast_decimal_to_bigint": lambda n: n.cast(n.ref("d1"), "bigint"),
    "cast_bigint_to_decimal": lambda n: n.cast(n.ref("i"), "decimal(12,2)"),
    "cast_int_widen": lambda n: n.cast(n.ref("i"), "bigint"),
    "cast_bigint_to_integer": lambda n: n.cast(n.ref("a"), "integer"),
    "lt": lambda n: n.call("$lt", [n.ref("a"), n.ref("b")], "boolean"),
    "gte_decimal_const": lambda n: n.call(
        "$gte", [n.ref("d1"), n.const("decimal(12,2)", 500)], "boolean"),
    "eq_int": lambda n: n.call("$eq", [n.ref("i"), n.const("integer", 3)], "boolean"),
    "ne_null_const": lambda n: n.call(
        "$ne", [n.ref("a"), n.const("bigint", None)], "boolean"),
    "and_kleene": lambda n: n.call("$and", [
        n.call("$lt", [n.ref("a"), n.ref("b")], "boolean"),
        n.call("$gt", [n.ref("i"), n.const("integer", 2)], "boolean")], "boolean"),
    "or_kleene": lambda n: n.call("$or", [
        n.call("$lt", [n.ref("a"), n.ref("b")], "boolean"), n.ref("f")], "boolean"),
    "not": lambda n: n.call("$not", [n.ref("f")], "boolean"),
    "is_null": lambda n: n.call("$is_null", [n.ref("a")], "boolean"),
    "not_null": lambda n: n.call("$not_null", [n.ref("s")], "boolean"),
    "string_eq": lambda n: n.call("$eq", [n.ref("s"), n.const("varchar", "MAIL")], "boolean"),
    "string_ne_absent": lambda n: n.call(
        "$ne", [n.ref("s"), n.const("varchar", "TRUCK")], "boolean"),
    "string_lt": lambda n: n.call("$lt", [n.ref("s"), n.const("varchar", "MAIL")], "boolean"),
    "string_range_flipped": lambda n: n.call(
        "$gte", [n.const("varchar", "MB"), n.ref("s")], "boolean"),
    "string_in_lut": lambda n: n.ir.InLut(n.ref("s"), (True, False, True, False, True)),
    "string_in_or": lambda n: n.call("$or", [
        n.call("$eq", [n.ref("s"), n.const("varchar", "AIR")], "boolean"),
        n.call("$eq", [n.ref("s"), n.const("varchar", "SHIP")], "boolean")], "boolean"),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return {
        sym: (values(rng), rng.random(N) < 0.85) for sym, (_, values) in COLUMNS.items()
    }


def _ref_eval(expr, data):
    rd = RefDictionary(VOCAB)
    layout, env = {}, {}
    for sym, (tname, _) in COLUMNS.items():
        d = rd if sym == "s" else None
        layout[sym] = rc.ColumnLayout(rtypes.parse_type(tname), d)
        vals, valid = data[sym]
        env[sym] = rc.CVal(jnp.asarray(vals), jnp.asarray(valid), d)
    fn, _ = rc.compile_expression(expr, layout, N)
    v = fn(env)
    return np.asarray(v.data), np.asarray(v.valid)


def _port_eval(expr, data):
    pd = Dictionary(VOCAB)
    layout, env = {}, {}
    for sym, (tname, _) in COLUMNS.items():
        d = pd if sym == "s" else None
        layout[sym] = pc.ColumnLayout(ptypes.parse_type(tname), d)
        vals, valid = data[sym]
        env[sym] = pc.CVal(torch.from_numpy(vals), torch.from_numpy(valid), d)
    fn, _ = pc.compile_expression(expr, layout, N, "cpu")
    v = fn(env)
    return v.data.numpy(), v.valid.numpy()


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_expression_matches_reference(name, data):
    build = EXPRESSIONS[name]
    want_data, want_valid = _ref_eval(build(NS(rir, rtypes)), data)
    got_data, got_valid = _port_eval(build(NS(pir, ptypes)), data)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got_data.dtype == want_data.dtype
    np.testing.assert_array_equal(got_data[got_valid], want_data[want_valid])


def test_compiled_closures_are_cached():
    n = NS(pir, ptypes)
    expr = EXPRESSIONS["add"](n)
    layout = {s: pc.ColumnLayout(ptypes.parse_type(t)) for s, (t, _) in COLUMNS.items()}
    first = pc.compile_expression(expr, layout, N, "cpu")
    assert pc.compile_expression(expr, layout, N, "cpu")[0] is first[0]


@pytest.mark.parametrize("fn_name", ["$divide", "upper", "$like"])
def test_unsupported_functions_raise_naming_the_function(fn_name):
    n = NS(pir, ptypes)
    args = [n.ref("a"), n.ref("b")] if fn_name == "$divide" else [n.ref("s")]
    out = "bigint" if fn_name == "$divide" else "varchar"
    expr = n.call(fn_name, args, out)
    layout = {s: pc.ColumnLayout(ptypes.parse_type(t)) for s, (t, _) in COLUMNS.items()}
    with pytest.raises(pc.CompileError, match=f"function {fn_name.replace('$', '[$]')}"):
        pc.compile_expression(expr, layout, N, "cpu")
