"""The port's expression compiler against ``trino_tpu.ops.compiler`` on the
slice's expressions. The same IR is built in both packages over the same
numpy columns (made from a seed, with NULLs); outputs must agree bit for bit
in validity and, where valid, in data. DOUBLE results are held to the same
bit-exact rule (IEEE operations in the same order; NaN equals NaN), which
is tighter than the 1e-9 relative the comparison contract allows."""

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
# a second dictionary: LIKE's metacharacters as data, an empty string, and
# values shared with VOCAB (so cross-dictionary merges overlap)
VOCAB_T = np.asarray(
    ["", "10%_off", "A_B", "AB", "MAIL", "PROMO BRUSHED", "PROMO_X", "SHIP", "a%b"],
    dtype=object,
)
VOCAB_U = np.asarray(
    ["", " 42 ", "-7", "1.5", "1995-03-31", "2024-02-29", "NaN", "false", "t", "x12"],
    dtype=object,
)
DICTS = {"s": VOCAB, "t": VOCAB_T, "u": VOCAB_U}
# 1968-02-29, 1970-01-01, 2000-02-29, 2020-12-31 (ISO week 53), 2021-01-01,
# 2023-01-31, 2024-02-29, 2024-12-30 (ISO week 1 of 2025), 2025-12-31,
# 2026-01-01 (ISO week 1), 1900-02-28
EDGE_DAYS = [-672, 0, 11016, 18627, 18628, 19388, 19782, 20087, 20453, 20454, -25509]
INT64_EDGES = [np.iinfo(np.int64).min, np.iinfo(np.int64).min + 1, -1, 0, 1,
               np.iinfo(np.int64).max, np.iinfo(np.int64).max - 1]
P_EDGES = [0.0, 1e-300, 1e-12, 1e-6, 0.5, 1 - 1e-6, 1 - 1e-12, 1.0]
COLUMNS = {  # symbol -> (type name, values)
    "a": ("bigint", lambda r: r.integers(-(10**9), 10**9, N)),
    "b": ("bigint", lambda r: r.integers(-(10**9), 10**9, N)),
    "i": ("integer", lambda r: r.integers(-50, 50, N).astype(np.int32)),
    "d1": ("decimal(12,2)", lambda r: r.integers(-(10**7), 10**7, N)),
    "d2": ("decimal(15,4)", lambda r: r.integers(-(10**9), 10**9, N)),
    "s": ("varchar", lambda r: r.integers(0, len(VOCAB), N).astype(np.int32)),
    "f": ("boolean", lambda r: r.random(N) < 0.5),
    # new columns go last, so the earlier columns' draws stay as they were
    "x": ("double", lambda r: np.where(
        r.random(N) < 0.1, 0.0, r.normal(0, 1000, N)).round(3)),
    "y": ("double", lambda r: np.where(
        r.random(N) < 0.15, 0.0, r.normal(0, 30, N)).round(1)),
    "j": ("integer", lambda r: r.integers(-7, 8, N).astype(np.int32)),
    # 1700-01-01 .. 2200-12-31, with 29 February of 1896, 1904, 1968, 1972,
    # 2000 and 2024 and the days either side of each
    "dt": ("date", lambda r: np.where(
        r.random(N) < 0.3,
        r.choice([-26969, -24048, -672, 789, 11016, 19782], N) + r.integers(-1, 2, N),
        r.integers(-98615, 84371, N)).astype(np.int32)),
    "t": ("varchar", lambda r: r.integers(0, len(VOCAB_T), N).astype(np.int32)),
    # leap days, month ends, and ISO week 1 and week 53 days
    "dm": ("date", lambda r: np.where(
        r.random(N) < 0.5, r.choice(EDGE_DAYS, N), r.integers(-40000, 40000, N)).astype(np.int32)),
    # int64 extremes and their neighbours
    "bi": ("bigint", lambda r: np.where(r.random(N) < 0.4, r.choice(INT64_EDGES, N),
                                        r.integers(-(2**62), 2**62, N))),
    # shift and bit counts past both ends of [0, 63]
    "sh": ("bigint", lambda r: r.integers(-3, 70, N)),
    # x.5 ties, negative and positive
    "hv": ("double", lambda r: r.integers(-41, 42, N) / 2.0),
    # probabilities near 0 and 1
    "p": ("double", lambda r: np.where(r.random(N) < 0.5, r.choice(P_EDGES, N), r.random(N))),
    "ts": ("timestamp", lambda r: r.integers(-(2**50), 2**50, N)),
    "tm": ("time(3)", lambda r: r.integers(0, 86_400_000_000, N)),
    "ttz": ("timestamp(3) with time zone", lambda r: (
        r.integers(-(2**40), 2**40, N) << 12) | r.integers(1, 1682, N)),
    "twtz": ("time(3) with time zone", lambda r: (
        r.integers(-(2**36), 2**36, N) << 12) | r.integers(1, 1682, N)),
    # strings that parse as numbers, dates and booleans, and some that do not
    "u": ("varchar", lambda r: r.integers(0, len(VOCAB_U), N).astype(np.int32)),
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

    def case(self, whens, default, type_name):
        return self.ir.Case(tuple(whens), default, self.t.parse_type(type_name))

    def like(self, sym, pattern, escape=None):
        args = [self.ref(sym), self.const("varchar", pattern)]
        if escape is not None:
            args.append(self.const("varchar", escape))
        return self.call("$like", args, "boolean")

    def simple_case(self, sym, type_name, pairs, default):
        """CASE sym WHEN v THEN r ... END, as analysis lowers it: searched,
        one equality per WHEN (NULL when ``sym`` is NULL)."""
        col = COLUMNS[sym][0]
        return self.case(
            [(self.call("$eq", [self.ref(sym), self.const(col, v)], "boolean"), r)
             for v, r in pairs],
            default, type_name)


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
    # LIKE: %, _, ESCAPE, and NULL rows (the column's validity)
    "like_suffix": lambda n: n.like("s", "%IL"),
    "like_prefix": lambda n: n.like("t", "PROMO%"),
    "like_underscore": lambda n: n.like("s", "_A__"),
    "like_escape_percent": lambda n: n.like("t", "%!%%", "!"),
    "like_escape_underscore": lambda n: n.like("t", "A!_B", "!"),
    "like_empty": lambda n: n.like("t", ""),
    "not_like": lambda n: n.call("$not", [n.like("t", "%_%")], "boolean"),
    # CASE: searched and simple, NULL conditions, no ELSE, string results
    "case_searched": lambda n: n.case([
        (n.call("$lt", [n.ref("a"), n.ref("b")], "boolean"), n.ref("d1")),
        (n.ref("f"), n.const("decimal(12,2)", 7))], n.const("decimal(12,2)", -1),
        "decimal(12,2)"),
    "case_no_else": lambda n: n.case([
        (n.call("$gt", [n.ref("i"), n.const("integer", 0)], "boolean"), n.ref("a"))],
        None, "bigint"),
    "case_simple": lambda n: n.simple_case(
        "i", "bigint", [(3, n.const("bigint", 30)), (-4, n.ref("b"))], n.ref("a")),
    "case_like_then_arith": lambda n: n.case([
        (n.like("t", "PROMO%"), n.call("$multiply", [n.ref("d1"), n.ref("d2")],
                                       "decimal(18,6)"))],
        n.const("decimal(18,6)", 0), "decimal(18,6)"),
    "case_string_two_dicts": lambda n: n.case([
        (n.ref("f"), n.ref("s")),
        (n.call("$lt", [n.ref("a"), n.const("bigint", 0)], "boolean"), n.ref("t"))],
        n.const("varchar", "ZZZ"), "varchar"),
    "case_string_no_else_null_branch": lambda n: n.simple_case(
        "j", "varchar", [(1, n.ref("t")), (2, n.const("varchar", None)),
                         (3, n.const("varchar", "MAIL"))], None),
    # DOUBLE arithmetic: zeros and negative operands throughout
    "double_add": lambda n: n.call("$add", [n.ref("x"), n.ref("y")], "double"),
    "double_subtract": lambda n: n.call("$subtract", [n.ref("x"), n.ref("y")], "double"),
    "double_multiply": lambda n: n.call("$multiply", [n.ref("x"), n.ref("y")], "double"),
    "double_divide": lambda n: n.call("$divide", [n.ref("x"), n.ref("y")], "double"),
    "double_modulus": lambda n: n.call("$modulus", [n.ref("x"), n.ref("y")], "double"),
    "double_negate": lambda n: n.call("$negate", [n.ref("x")], "double"),
    "double_compare": lambda n: n.call("$gte", [n.ref("x"), n.const("double", -2.5)],
                                       "boolean"),
    "double_divide_constant": lambda n: n.call(
        "$divide", [n.cast(n.ref("d1"), "double"), n.const("double", 7.0)], "double"),
    # integral and decimal division and modulus on negative operands
    "integer_divide": lambda n: n.call("$divide", [n.ref("i"), n.ref("j")], "integer"),
    "bigint_divide": lambda n: n.call("$divide", [n.ref("a"), n.cast(n.ref("j"), "bigint")],
                                      "bigint"),
    "integer_modulus": lambda n: n.call("$modulus", [n.ref("i"), n.ref("j")], "integer"),
    "decimal_divide_as_double": lambda n: n.call("$divide", [
        n.cast(n.ref("d1"), "double"), n.cast(n.ref("d2"), "double")], "double"),
    "decimal_divide_typed": lambda n: n.call(
        "$divide", [n.ref("d2"), n.ref("d1")], "decimal(18,4)"),
    "decimal_modulus": lambda n: n.call(
        "$modulus", [n.ref("d1"), n.cast(n.ref("j"), "decimal(12,2)")], "decimal(18,2)"),
    # the new casts
    "cast_decimal_to_double": lambda n: n.cast(n.ref("d2"), "double"),
    "cast_decimal_to_real": lambda n: n.cast(n.ref("d1"), "real"),
    "cast_integer_to_double": lambda n: n.cast(n.ref("i"), "double"),
    "cast_bigint_to_double": lambda n: n.cast(n.ref("a"), "double"),
    "cast_double_to_decimal": lambda n: n.cast(n.ref("x"), "decimal(12,2)"),
    "cast_double_to_decimal_half_even": lambda n: n.cast(
        n.call("$divide", [n.ref("y"), n.const("double", 4.0)], "double"), "decimal(10,1)"),
    "cast_double_to_integer": lambda n: n.cast(n.ref("y"), "integer"),
    "cast_double_to_bigint": lambda n: n.cast(n.ref("x"), "bigint"),
    "cast_boolean_to_double": lambda n: n.cast(n.ref("f"), "double"),
    "cast_double_to_boolean": lambda n: n.cast(n.ref("y"), "boolean"),
    # year: dates before 1970 and on 29 February
    "year_of_date": lambda n: n.call("year", [n.ref("dt")], "bigint"),
    "year_compare": lambda n: n.call(
        "$eq", [n.call("year", [n.ref("dt")], "bigint"), n.const("bigint", 1968)], "boolean"),
    # coalesce: 2 and 3 arguments, numeric and strings of two dictionaries
    "coalesce_two": lambda n: n.call("coalesce", [n.ref("a"), n.ref("b")], "bigint"),
    "coalesce_three": lambda n: n.call(
        "coalesce", [n.ref("x"), n.ref("y"), n.const("double", -1.0)], "double"),
    "coalesce_widen": lambda n: n.call(
        "coalesce", [n.cast(n.ref("i"), "bigint"), n.ref("a")], "bigint"),
    "coalesce_strings": lambda n: n.call("coalesce", [n.ref("s"), n.ref("t")], "varchar"),
    "coalesce_strings_three": lambda n: n.call(
        "coalesce", [n.ref("t"), n.ref("s"), n.const("varchar", "NONE")], "varchar"),
    "coalesce_strings_compared": lambda n: n.call("$eq", [
        n.call("coalesce", [n.ref("s"), n.ref("t")], "varchar"),
        n.const("varchar", "MAIL")], "boolean"),
    # substr: start past the end, with and without a length
    "substr_from_2": lambda n: n.call("substr", [n.ref("t"), n.const("bigint", 2)], "varchar"),
    "substr_with_length": lambda n: n.call(
        "substr", [n.ref("t"), n.const("bigint", 1), n.const("bigint", 2)], "varchar"),
    "substr_past_end": lambda n: n.call(
        "substr", [n.ref("s"), n.const("bigint", 6), n.const("bigint", 2)], "varchar"),
    "substring_null_start": lambda n: n.call(
        "substring", [n.ref("t"), n.const("bigint", None)], "varchar"),
    # a start <= 0 slices from the end (the reference's deviation from Trino)
    "substr_start_zero": lambda n: n.call("substr", [n.ref("t"), n.const("bigint", 0)],
                                          "varchar"),
    "substr_start_negative": lambda n: n.call(
        "substr", [n.ref("t"), n.const("bigint", -2)], "varchar"),
    "substr_start_negative_with_length": lambda n: n.call(
        "substr", [n.ref("t"), n.const("bigint", -3), n.const("bigint", 2)], "varchar"),
    "substr_in_comparison": lambda n: n.call("$eq", [
        n.call("substr", [n.ref("t"), n.const("bigint", 1), n.const("bigint", 2)], "varchar"),
        n.const("varchar", "PR")], "boolean"),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return {
        sym: (values(rng), rng.random(N) < 0.85) for sym, (_, values) in COLUMNS.items()
    }


def _ref_eval(expr, data):
    dicts = {sym: RefDictionary(v) for sym, v in DICTS.items()}
    layout, env = {}, {}
    for sym, (tname, _) in COLUMNS.items():
        d = dicts.get(sym)
        layout[sym] = rc.ColumnLayout(rtypes.parse_type(tname), d)
        vals, valid = data[sym]
        env[sym] = rc.CVal(jnp.asarray(vals), jnp.asarray(valid), d)
    fn, out_dict = rc.compile_expression(expr, layout, N)
    v = fn(env)
    return np.asarray(v.data), np.asarray(v.valid), _values_of(out_dict or v.dictionary)


def _port_eval(expr, data):
    dicts = {sym: Dictionary(v) for sym, v in DICTS.items()}
    layout, env = {}, {}
    for sym, (tname, _) in COLUMNS.items():
        d = dicts.get(sym)
        layout[sym] = pc.ColumnLayout(ptypes.parse_type(tname), d)
        vals, valid = data[sym]
        env[sym] = pc.CVal(torch.from_numpy(vals), torch.from_numpy(valid), d)
    fn, out_dict = pc.compile_expression(expr, layout, N, "cpu")
    v = fn(env)
    return v.data.numpy(), v.valid.numpy(), _values_of(out_dict or v.dictionary)


def _values_of(d):
    return None if d is None else list(d.values)


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_expression_matches_reference(name, data):
    """Validity, dtype and valid data bit for bit; a string result's
    dictionary holds the same values (so its codes mean the same strings)."""
    build = EXPRESSIONS[name]
    want_data, want_valid, want_dict = _ref_eval(build(NS(rir, rtypes)), data)
    got_data, got_valid, got_dict = _port_eval(build(NS(pir, ptypes)), data)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got_data.dtype == want_data.dtype
    np.testing.assert_array_equal(got_data[got_valid], want_data[want_valid])
    assert got_dict == want_dict


# DOUBLE math functions: the same IEEE inputs, but each library's own exp,
# log and trigonometry may round the last bit differently, so these hold
# at 1e-12 relative (inside the contract's 1e-9), NaN equal to NaN
MATH_EXPRESSIONS = {
    "exp": lambda n: n.call("exp", [n.call("$divide", [n.ref("x"), n.const("double", 300.0)],
                                            "double")], "double"),
    "ln_decimal": lambda n: n.call("ln", [n.ref("d1")], "double"),
    "sqrt_integer": lambda n: n.call("sqrt", [n.ref("i")], "double"),
    "log10": lambda n: n.call("log10", [n.ref("x")], "double"),
    "log2_bigint": lambda n: n.call("log2", [n.ref("a")], "double"),
    "power": lambda n: n.call("power", [n.ref("y"), n.ref("j")], "double"),
    "sin_cos_tan": lambda n: n.call("$add", [
        n.call("sin", [n.ref("x")], "double"),
        n.call("$multiply", [n.call("cos", [n.ref("y")], "double"),
                             n.call("tan", [n.ref("d2")], "double")], "double")], "double"),
    "asin_acos_atan": lambda n: n.call("$add", [
        n.call("asin", [n.call("$divide", [n.ref("y"), n.const("double", 100.0)], "double")],
               "double"),
        n.call("$add", [n.call("acos", [n.call("$divide", [n.ref("y"),
                                                           n.const("double", 90.0)],
                                               "double")], "double"),
                        n.call("atan", [n.ref("x")], "double")], "double")], "double"),
    "atan2": lambda n: n.call("atan2", [n.ref("x"), n.ref("d1")], "double"),
}


@pytest.mark.parametrize("name", sorted(MATH_EXPRESSIONS))
def test_math_function_matches_reference(name, data):
    build = MATH_EXPRESSIONS[name]
    want_data, want_valid, _ = _ref_eval(build(NS(rir, rtypes)), data)
    got_data, got_valid, _ = _port_eval(build(NS(pir, ptypes)), data)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got_data.dtype == want_data.dtype
    np.testing.assert_allclose(got_data[got_valid], want_data[want_valid], rtol=1e-12,
                               atol=0, equal_nan=True)


def test_compiled_closures_are_cached():
    n = NS(pir, ptypes)
    expr = EXPRESSIONS["add"](n)
    layout = {s: pc.ColumnLayout(ptypes.parse_type(t)) for s, (t, _) in COLUMNS.items()}
    first = pc.compile_expression(expr, layout, N, "cpu")
    assert pc.compile_expression(expr, layout, N, "cpu")[0] is first[0]


@pytest.mark.parametrize("fn_name", ["$array", "cardinality", "element_at"])
def test_unsupported_functions_raise_naming_the_function(fn_name, nested_data):
    """Once raising by name, these now lower: each against the reference's
    compiler on array layouts (``$array`` of scalar columns, then
    ``cardinality`` and ``element_at`` of an array column)."""
    from tests.test_torch_nested import same_value

    build = {
        "$array": _nest("$array", "k", "k", out="array(bigint)"),
        "cardinality": _nest("cardinality", "arr", out="bigint"),
        "element_at": _nest("element_at", "arr", "k", out="bigint"),
    }[fn_name]
    want = _nested_eval(True, build(NS(rir, rtypes)), nested_data)
    got = _nested_eval(False, build(NS(pir, ptypes)), nested_data)
    assert same_value(got, want), f"{got} != {want}"


def _fn(name, *args, out="double"):
    """A function call over column symbols (str) and constants
    ((type, value) pairs)."""
    def build(n):
        built = [n.ref(a) if isinstance(a, str) else n.const(*a) for a in args]
        return n.call(name, built, out)
    return build


def _cast(sym, type_name):
    return lambda n: n.cast(n.ref(sym), type_name)


# one case per function family: every expression of a family is held
# against the reference; integers, booleans, dates and strings bit for bit,
# DOUBLE at 1e-12 relative, the CDFs at 1e-9 relative or 1e-12 absolute
FAMILIES = {
    "rounding": [
        _fn("round", "x"), _fn("round", "hv"), _fn("round", "hv", ("integer", 0)),
        _fn("round", "x", ("integer", 2)), _fn("round", "a", ("integer", -3), out="bigint"),
        _fn("truncate", "x"), _fn("truncate", "hv"), _fn("truncate", "x", ("integer", 1)),
        _fn("ceil", "x"), _fn("floor", "hv"), _fn("ceiling", "d1", out="decimal(12,2)"),
        _fn("floor", "d1", out="decimal(12,2)"), _fn("sign", "x"), _fn("sign", "a", out="bigint"),
        _fn("mod", "i", "j", out="integer"), _fn("mod", "x", "y"),
        _fn("mod", "a", "bi", out="bigint"),
        _fn("abs", "a", out="bigint"), _fn("abs", "hv"), _fn("abs", "d2", out="decimal(15,4)"),
    ],
    "math": [
        _fn("cbrt", "x"), _fn("degrees", "x"), _fn("radians", "y"), _fn("cosh", "hv"),
        _fn("sinh", "hv"), _fn("tanh", "y"), _fn("cot", "y"), _fn("log", "y", "x"),
        _fn("is_nan", "x", out="boolean"), _fn("is_finite", "x", out="boolean"),
        _fn("is_infinite", "y", out="boolean"), _fn("greatest", "x", "y", "hv"),
        _fn("least", "a", "b", out="bigint"),
        _fn("width_bucket", "x", ("double", -500.0), ("double", 500.0), "sh", out="bigint"),
        _fn("pi"), _fn("e"), _fn("nan"), _fn("infinity"),
    ],
    "bitwise": [
        _fn(name, "bi", "a", out="bigint")
        for name in ("bitwise_and", "bitwise_or", "bitwise_xor")
    ] + [
        _fn("bitwise_not", "bi", out="bigint"),
        _fn("bitwise_left_shift", "bi", "sh", out="bigint"),
        _fn("bitwise_right_shift", "bi", "sh", out="bigint"),
        _fn("bitwise_right_shift_arithmetic", "bi", "sh", out="bigint"),
        _fn("bit_count", "bi", out="bigint"), _fn("bit_count", "bi", "sh", out="bigint"),
        _fn("hash64", "bi", "i", out="bigint"),
    ],
    "cdf": [
        _fn("normal_cdf", ("double", 0.0), ("double", 1.0), "hv"),
        _fn("inverse_normal_cdf", ("double", 1.0), ("double", 2.0), "p"),
        _fn("beta_cdf", ("double", 2.0), ("double", 3.0), "p"),
        _fn("beta_cdf", ("double", 0.5), ("double", 40.0), "p"),
        _fn("binomial_cdf", ("integer", 20), "p", "j"),
        _fn("f_cdf", ("double", 4.0), ("double", 9.0), "hv"),
        _fn("t_cdf", ("double", 7.0), "hv"), _fn("t_pdf", ("double", 7.0), "hv"),
        _fn("chi_squared_cdf", ("double", 3.0), "hv"),
        _fn("gamma_cdf", ("double", 2.0), ("double", 1.5), "hv"),
        _fn("poisson_cdf", ("double", 4.0), "j"),
        _fn("laplace_cdf", ("double", 1.0), ("double", 2.0), "hv"),
        _fn("inverse_laplace_cdf", ("double", 1.0), ("double", 2.0), "p"),
        _fn("cauchy_cdf", ("double", 1.0), ("double", 2.0), "hv"),
        _fn("inverse_cauchy_cdf", ("double", 1.0), ("double", 2.0), "p"),
        _fn("weibull_cdf", ("double", 2.0), ("double", 3.0), "hv"),
        _fn("inverse_weibull_cdf", ("double", 2.0), ("double", 3.0), "p"),
        _fn("wilson_interval_lower", "j", ("integer", 20), ("double", 1.96)),
        _fn("wilson_interval_upper", "j", ("integer", 20), ("double", 1.96)),
    ],
    "date_parts": [
        _fn(name, "dm", out="bigint") for name in (
            "year", "month", "day", "quarter", "day_of_week", "day_of_year", "week",
            "year_of_week", "dow", "doy", "week_of_year", "yow", "day_of_month")
    ] + [
        _fn("last_day_of_month", "dm", out="date"), _fn("last_day_of_month", "ts", out="date"),
        _fn("date", "ts", out="date"), _fn("month", "ts", out="bigint"),
        _fn("hour", "ts", out="bigint"), _fn("minute", "ts", out="bigint"),
        _fn("second", "tm", out="bigint"), _fn("millisecond", "tm", out="bigint"),
        _fn("hour", "ttz", out="bigint"), _fn("day", "ttz", out="bigint"),
        _fn("minute", "twtz", out="bigint"), _fn("timezone_hour", "ttz", out="bigint"),
        _fn("timezone_minute", "ttz", out="bigint"), _fn("to_milliseconds", "a", out="bigint"),
    ],
    "date_arithmetic": [
        _fn("date_trunc", ("varchar", unit), "dm", out="date")
        for unit in ("day", "week", "month", "quarter", "year")
    ] + [
        _fn("date_trunc", ("varchar", "month"), "ts", out="timestamp"),
    ] + [
        _fn("date_add", ("varchar", unit), "j", "dm", out="date")
        for unit in ("day", "week", "month", "quarter", "year")
    ] + [
        _fn("date_add", ("varchar", "month"), "j", "ts", out="timestamp"),
    ] + [
        _fn("date_diff", ("varchar", unit), "dt", "dm", out="bigint")
        for unit in ("day", "week", "month", "quarter", "year")
    ],
    "strings": [
        _fn(name, "t", out="varchar") for name in (
            "upper", "lower", "trim", "reverse", "soundex", "md5", "sha256", "xxhash64",
            "to_hex", "to_base64", "to_utf8", "normalize", "word_stem", "murmur3")
    ] + [
        _fn("replace", "t", ("varchar", "O"), ("varchar", "0"), out="varchar"),
        _fn("split_part", "t", ("varchar", "_"), ("bigint", 2), out="varchar"),
        _fn("translate", "t", ("varchar", "AO"), ("varchar", "o"), out="varchar"),
        _fn("lpad", "s", ("bigint", 6), ("varchar", "*-"), out="varchar"),
        _fn("rpad", "t", ("bigint", 3), ("varchar", "."), out="varchar"),
        _fn("regexp_extract", "t", ("varchar", "([A-Z])_?([A-Z])"), ("bigint", 2),
            out="varchar"),
        _fn("regexp_replace", "t", ("varchar", "([A-Z])"), ("varchar", "<$1>"),
            out="varchar"),
        _fn("concat", "s", ("varchar", "/"), "t", out="varchar"),
        _fn("length", "t", out="bigint"), _fn("codepoint", "s", out="bigint"),
        _fn("strpos", "t", ("varchar", "O"), out="bigint"),
        _fn("strrpos", "t", ("varchar", "O"), out="bigint"),
        _fn("regexp_count", "t", ("varchar", "[A-Z]"), out="bigint"),
        _fn("regexp_position", "t", ("varchar", "[0-9]"), out="bigint"),
        _fn("crc32", "t", out="bigint"),
        _fn("levenshtein_distance", "t", ("varchar", "PROMO"), out="bigint"),
        _fn("hamming_distance", "s", ("varchar", "SHIP"), out="bigint"),
        _fn("regexp_like", "t", ("varchar", "^P.*[OX]$"), out="boolean"),
        _fn("starts_with", "t", ("varchar", "PRO"), out="boolean"),
        _fn("ends_with", "s", ("varchar", "IL"), out="boolean"),
        _fn("luhn_check", "u", out="boolean"),
        _fn("from_base", "u", ("bigint", 16), out="bigint"),
        _fn("from_iso8601_date", "u", out="date"),
    ],
    "temporal_casts": [
        _cast("ttz", "timestamp"), _cast("ts", "timestamp(3) with time zone"),
        _cast("ttz", "date"), _cast("ts", "time(3)"), _cast("ttz", "time(3)"),
        _cast("twtz", "time(3)"), _cast("tm", "time(3) with time zone"),
        _cast("dm", "timestamp(3) with time zone"), _cast("dm", "timestamp"),
        _cast("ts", "date"), _cast("u", "date"), _cast("u", "bigint"), _cast("u", "double"),
        _cast("u", "boolean"), _cast("u", "decimal(10,2)"),
        _fn("$lt", "ttz", ("timestamp(3) with time zone", (1 << 42) | 841), out="boolean"),
        _fn("$eq", "twtz", ("time(3) with time zone", 841), out="boolean"),
        _fn("$gte", "tm", ("time(3)", 43_200_000_000), out="boolean"),
    ],
}
CDF_REL, CDF_ABS = 1e-9, 1e-12


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_function_family_matches_reference(family, data):
    for i, build in enumerate(FAMILIES[family]):
        ref_expr, port_expr = build(NS(rir, rtypes)), build(NS(pir, ptypes))
        want_data, want_valid, want_dict = _ref_eval(ref_expr, data)
        got_data, got_valid, got_dict = _port_eval(port_expr, data)
        where = f"{family}[{i}] {port_expr}"
        np.testing.assert_array_equal(got_valid, want_valid, err_msg=where)
        assert got_data.dtype == want_data.dtype, where
        got, want = got_data[got_valid], want_data[want_valid]
        if got.dtype.kind != "f":
            np.testing.assert_array_equal(got, want, err_msg=where)
            assert got_dict == want_dict, where
        elif family == "cdf":
            np.testing.assert_allclose(got, want, rtol=CDF_REL, atol=CDF_ABS, equal_nan=True,
                                       err_msg=where)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True,
                                       err_msg=where)


def test_random_is_uniform_in_its_bounds():
    """random() and random(n): a salt per compilation, so only the bounds
    compare with the reference."""
    n = NS(pir, ptypes)
    layout = {s: pc.ColumnLayout(ptypes.parse_type(t)) for s, (t, _) in COLUMNS.items()}
    u = pc.compile_expression(n.call("random", [], "double"), layout, N, "cpu")[0]({})
    assert bool(u.valid.all()) and 0 <= float(u.data.min()) and float(u.data.max()) < 1
    k = pc.compile_expression(
        n.call("random", [n.const("bigint", 5)], "bigint"), layout, N, "cpu")[0]({})
    assert bool(k.valid.all()) and set(k.data.tolist()) <= set(range(5))


@pytest.mark.parametrize("type_name", [
    "time(3)", "time(3) with time zone", "timestamp(3) with time zone"])
def test_temporal_storage_round_trip_matches_reference(type_name, data):
    """A temporal column stored in the port decodes to the reference's
    Python values, zoned values in their own offsets."""
    from trino_tpu.spi.page import Column as RefColumn
    from trino_tpu_torch.spi.page import Column

    sym = {"time(3)": "tm", "time(3) with time zone": "twtz",
           "timestamp(3) with time zone": "ttz"}[type_name]
    vals, valid = data[sym]
    want = RefColumn.from_numpy(rtypes.parse_type(type_name), vals, valid).decode()
    got = Column.from_numpy(ptypes.parse_type(type_name), vals, valid, device="cpu").decode()
    assert list(got) == list(want)
    assert [getattr(v, "tzinfo", None) for v in got] == [getattr(v, "tzinfo", None) for v in want]


# ---------------------------------------------------------------- nested values

NN = 64  # rows of the nested families
NESTED_COLUMNS = {  # symbol -> type name
    "arr": "array(bigint)", "arr2": "array(bigint)", "sarr": "array(varchar)",
    "m": "map(varchar, bigint)", "m2": "map(varchar, bigint)",
    "r": "row(n bigint, s varchar, d decimal(12,2))", "k": "bigint", "sk": "varchar",
}


@pytest.fixture(scope="module")
def nested_data():
    """Python values of the nested columns, from a seed: NULL arrays, empty
    arrays, NULL elements and repeated values; maps with NULL values."""
    rng = np.random.default_rng(23)

    def maybe(p, v):
        return None if rng.random() < p else v

    def ints(n):
        return [maybe(0.15, int(rng.integers(-3, 4))) for _ in range(n)]

    def a_map():
        keys = [k for k in "abcd" if rng.random() < 0.5]
        return dict(zip(keys, ints(len(keys))))

    vocab = ["AIR", "FOB", "MAIL", "a", "b"]
    return {
        "arr": [maybe(0.1, ints(int(rng.integers(0, 6)))) for _ in range(NN)],
        "arr2": [maybe(0.1, ints(int(rng.integers(0, 5)))) for _ in range(NN)],
        "sarr": [maybe(0.1, [maybe(0.15, vocab[int(rng.integers(0, 5))])
                             for _ in range(int(rng.integers(0, 5)))]) for _ in range(NN)],
        "m": [maybe(0.1, a_map()) for _ in range(NN)],
        "m2": [maybe(0.1, a_map()) for _ in range(NN)],
        "r": [maybe(0.1, (int(rng.integers(-5, 5)), vocab[int(rng.integers(0, 5))],
                          round(float(rng.normal(0, 100)), 2))) for _ in range(NN)],
        "k": [maybe(0.1, int(rng.integers(-3, 4))) for _ in range(NN)],
        "sk": [maybe(0.1, ["a", "b", "z", "MAIL"][int(rng.integers(0, 4))]) for _ in range(NN)],
    }


def _nested_eval(ref: bool, expr, values):
    """The decoded values of ``expr`` over the nested columns in one engine:
    columns from ``Column.from_nested``, the executor's value and layout
    helpers, the result rebuilt as a column of the expression's type."""
    if ref:
        from trino_tpu.runtime import executor as ex
        from trino_tpu.spi.page import Column as Col

        types, comp, kw, ckw = rtypes, rc, {}, {}
    else:
        from trino_tpu_torch.runtime import executor as ex
        from trino_tpu_torch.spi.page import Column as Col

        types, comp, kw, ckw = ptypes, pc, {"device": "cpu"}, {"device": "cpu"}
    layout, env = {}, {}
    for sym, tname in NESTED_COLUMNS.items():
        col = Col.from_nested(types.parse_type(tname), values[sym], **kw)
        layout[sym] = comp.ColumnLayout(col.type, col.dictionary, ex._child_dicts(col))
        env[sym] = ex._cval_of(col)
    fn, out_dict = comp.compile_expression(expr, layout, NN, *ckw.values())
    return list(ex._column_of(expr.type, fn(env), out_dict).decode())


def _lam(n, params, body):
    """A lambda over (name, type name) parameters; ``body`` builds the body
    from the parameter references."""
    refs = [n.ir.Reference(p, n.t.parse_type(t)) for p, t in params]
    return n.ir.Lambda(tuple(p for p, _ in params),
                       tuple(n.t.parse_type(t) for _, t in params), body(*refs))


def _nref(n, sym):
    return n.ir.Reference(sym, n.t.parse_type(NESTED_COLUMNS[sym]))


def _nest(name, *args, out):
    """A call over nested symbols (str), constants ((type, value)) and
    lambdas (callables of the NS)."""
    def build(n):
        built = [_nref(n, a) if isinstance(a, str) else a(n) if callable(a) else n.const(*a)
                 for a in args]
        return n.call(name, built, out)
    return build


NESTED_FAMILIES = {
    "constructors": [
        _nest("$array", "k", ("bigint", 7), ("bigint", None), out="array(bigint)"),
        _nest("$array", "sk", ("varchar", "q"), out="array(varchar)"),
        _nest("$row", "k", "sk", out="row(bigint, varchar)"),
        _nest("$map", "sarr", "arr", out="map(varchar, bigint)"),
        lambda n: n.cast(n.const("unknown", None), "array(bigint)"),
        lambda n: n.cast(n.const("unknown", None), "map(varchar, bigint)"),
        lambda n: n.cast(n.const("unknown", None), "row(bigint, varchar)"),
        _nest("repeat", "k", ("bigint", None), out="array(bigint)"),
    ],
    "accessors": [
        _nest("$subscript", "arr", "k", out="bigint"),
        _nest("element_at", "arr", ("bigint", 2), out="bigint"),
        _nest("element_at", "sarr", ("bigint", 1), out="varchar"),
        _nest("element_at", "m", "sk", out="bigint"),
        _nest("$field", "r", ("bigint", 1), out="varchar"),
        _nest("$field", "r", ("bigint", 2), out="decimal(12,2)"),
        _nest("cardinality", "arr", out="bigint"),
        _nest("cardinality", "m", out="bigint"),
        _nest("map_keys", "m", out="array(varchar)"),
        _nest("map_values", "m", out="array(bigint)"),
    ],
    "search": [
        _nest("contains", "arr", "k", out="boolean"),
        _nest("contains", "sarr", "sk", out="boolean"),
        _nest("array_position", "arr", "k", out="bigint"),
        _nest("array_position", "sarr", ("varchar", "MAIL"), out="bigint"),
        _nest("array_min", "arr", out="bigint"),
        _nest("array_max", "arr", out="bigint"),
        _nest("array_max", "sarr", out="varchar"),
    ],
    "ordering": [
        _nest("array_sort", "arr", out="array(bigint)"),
        _nest("array_sort", "sarr", out="array(varchar)"),
        _nest("array_distinct", "arr", out="array(bigint)"),
        _nest("array_distinct", "sarr", out="array(varchar)"),
    ],
    "reshaping": [
        _nest("$array_concat", "arr", "arr2", out="array(bigint)"),
        _nest("slice", "arr", ("bigint", 2), ("bigint", 2), out="array(bigint)"),
        _nest("slice", "arr", ("bigint", -2), ("bigint", 5), out="array(bigint)"),
        _nest("trim_array", "arr", ("bigint", 1), out="array(bigint)"),
        _nest("repeat", "k", ("bigint", 3), out="array(bigint)"),
        _nest("map_concat", "m", "m2", out="map(varchar, bigint)"),
    ],
    "sets": [
        _nest("array_remove", "arr", "k", out="array(bigint)"),
        _nest("array_except", "arr", "arr2", out="array(bigint)"),
        _nest("array_intersect", "arr", "arr2", out="array(bigint)"),
        _nest("arrays_overlap", "arr", "arr2", out="boolean"),
    ],
    "lambdas": [
        _nest("transform", "arr", lambda n: _lam(n, [("x", "bigint")], lambda x: n.call(
            "$add", [n.call("$multiply", [x, n.const("bigint", 2)], "bigint"),
                     n.ir.Reference("k", n.t.parse_type("bigint"))], "bigint")),
              out="array(bigint)"),
        _nest("transform", "sarr", lambda n: _lam(n, [("x", "varchar")], lambda x: n.call(
            "lower", [x], "varchar")), out="array(varchar)"),
        _nest("filter", "arr", lambda n: _lam(n, [("x", "bigint")], lambda x: n.call(
            "$gt", [x, n.ir.Reference("k", n.t.parse_type("bigint"))], "boolean")),
              out="array(bigint)"),
        *[_nest(m, "arr", lambda n: _lam(n, [("x", "bigint")], lambda x: n.call(
            "$gt", [x, n.const("bigint", 0)], "boolean")), out="boolean")
          for m in ("any_match", "all_match", "none_match")],
        _nest("zip_with", "arr", "arr2", lambda n: _lam(
            n, [("p", "bigint"), ("q", "bigint")],
            lambda p, q: n.call("$subtract", [p, q], "bigint")), out="array(bigint)"),
        _nest("reduce", "arr", ("bigint", 0),
              lambda n: _lam(n, [("s", "bigint"), ("x", "bigint")],
                             lambda s, x: n.call("$add", [s, x], "bigint")),
              lambda n: _lam(n, [("s", "bigint")], lambda s: s), out="bigint"),
        _nest("transform_values", "m", lambda n: _lam(
            n, [("mk", "varchar"), ("mv", "bigint")],
            lambda mk, mv: n.call("$multiply", [mv, n.const("bigint", 10)], "bigint")),
              out="map(varchar, bigint)"),
        _nest("map_filter", "m", lambda n: _lam(
            n, [("mk", "varchar"), ("mv", "bigint")],
            lambda mk, mv: n.call("$gt", [mv, n.const("bigint", 0)], "boolean")),
              out="map(varchar, bigint)"),
    ],
}


@pytest.mark.parametrize("family", sorted(NESTED_FAMILIES))
def test_nested_family_matches_reference(family, nested_data):
    """Each nested and higher-order function over [cap, W] layouts with
    NULL elements and empty and NULL arrays: the decoded values of every
    row, as the reference's compiler gives them."""
    from tests.test_torch_nested import same_value

    for i, build in enumerate(NESTED_FAMILIES[family]):
        want = _nested_eval(True, build(NS(rir, rtypes)), nested_data)
        got = _nested_eval(False, build(NS(pir, ptypes)), nested_data)
        assert same_value(got, want), f"{family}[{i}]: {got} != {want}"


@pytest.mark.parametrize("type_name", [
    "array(array(bigint))", "map(varchar, bigint)",
    "row(n bigint, d decimal(12,2))"])
def test_nested_layout_round_trip_matches_reference(type_name):
    """``Column.from_nested`` then ``decode``, against the reference's: an
    array of arrays (a flattened child), a map with string keys, a row with
    a DECIMAL field; NULL values, NULL elements and empty values."""
    from trino_tpu.spi.page import Column as RefColumn
    from trino_tpu_torch.spi.page import Column

    values = {
        "array(array(bigint))": [[[1, 2], None, []], None, [], [[3, None, 5]]],
        "map(varchar, bigint)": [{"a": 1, "b": None}, None, {}, {"zz": 7}],
        "row(n bigint, d decimal(12,2))": [(1, 2.5), None, (None, -0.75), (3, None)],
    }[type_name]
    want = RefColumn.from_nested(rtypes.parse_type(type_name), values, capacity=6).decode()
    got = Column.from_nested(ptypes.parse_type(type_name), values, capacity=6,
                             device="cpu").decode()
    assert list(got) == list(want)
    assert list(got)[:4] == values
