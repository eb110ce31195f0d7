"""The fused projection's expression programs (``ops/expr_program.py``) on
the CPU: each operation family the program lowers, and every computed fused
projection of TPC-H and TPC-DS, run through ``hopper_kernels.expr_program``
(its plain version on CPU tensors) against the reference's
``trino_tpu.ops.compiler`` and against the port's own closures; then the
assignments that stay on their closures (a string-valued result, a long
decimal, a projection past the program's output limit), each ticking
``megakernels.STAGES["project_torch"]`` and still giving the reference's
values.

The same seeded numpy columns go through both packages, with NULLs, zeros,
the int64 and int32 extremes, negative half-up ties and dates before 1970.
Against the closures every row compares bit for bit (validity and data, the
NULL rows' data too); against the reference integers, decimals, dates and
booleans compare exactly where valid, with validity, and DOUBLE at 1e-9
relative.
"""

import numpy as np
import pytest
import torch

from tests.tpch_corpus import TPCH_QUERIES

import jax.numpy as jnp

import trino_tpu.sql.ir as rir
import trino_tpu.spi.types as rtypes
from trino_tpu.ops import compiler as rc
from trino_tpu.spi.page import Dictionary as RefDictionary

import trino_tpu_torch.sql.ir as pir
import trino_tpu_torch.spi.types as ptypes
from trino_tpu_torch.ops import compiler as pc
from trino_tpu_torch.ops import expr_program as EP
from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as MK
from trino_tpu_torch.runtime import executor as pex
from trino_tpu_torch.spi.page import Column, Dictionary, Page

N = 509
REL_TOL = 1e-9
NATIONS = np.asarray(["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT"], dtype=object)
PRIORITIES = np.asarray(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"],
                        dtype=object)
DAYS = np.asarray(["Friday", "Monday", "Saturday", "Sunday", "Thursday", "Tuesday",
                   "Wednesday"], dtype=object)
DICTS = {"nation": NATIONS, "prio": PRIORITIES, "dname": DAYS}
I64 = np.iinfo(np.int64)
COLUMNS = {  # symbol -> (type name, values)
    "price": ("decimal(12,2)", lambda r: r.integers(90_000, 10_500_000, N)),
    "disc": ("decimal(12,2)", lambda r: r.integers(0, 11, N)),
    "qty": ("decimal(12,2)", lambda r: r.integers(100, 5_001, N)),
    "cost": ("decimal(12,2)", lambda r: r.integers(100, 100_001, N)),
    "avail": ("integer", lambda r: r.integers(1, 10_000, N).astype(np.int32)),
    "odate": ("date", lambda r: np.where(r.random(N) < 0.3, r.choice(
        [-719468, -25509, -672, -1, 0, 59, 60, 11016], N), r.integers(-40_000, 40_000, N))
        .astype(np.int32)),
    "nation": ("varchar", lambda r: r.integers(0, len(NATIONS), N).astype(np.int32)),
    "prio": ("varchar", lambda r: r.integers(0, len(PRIORITIES), N).astype(np.int32)),
    "dname": ("varchar", lambda r: r.integers(0, len(DAYS), N).astype(np.int32)),
    "sales": ("decimal(7,2)", lambda r: r.integers(0, 20_000, N)),
    "ship_sk": ("integer", lambda r: r.integers(2_450_815, 2_452_700, N).astype(np.int32)),
    "sold_sk": ("integer", lambda r: r.integers(2_450_815, 2_452_600, N).astype(np.int32)),
    "a": ("bigint", lambda r: np.where(r.random(N) < 0.3, r.choice(
        [I64.min, I64.min + 1, -1, 0, 1, I64.max], N), r.integers(-(2**62), 2**62, N))),
    "b": ("bigint", lambda r: np.where(r.random(N) < 0.2, 0, r.integers(-(10**6), 10**6, N))),
    "i": ("integer", lambda r: np.where(r.random(N) < 0.3, r.choice(
        [-(2**31), 2**31 - 1, 0, -1, 7], N), r.integers(-(2**31), 2**31, N)).astype(np.int32)),
    "j": ("integer", lambda r: r.integers(-7, 8, N).astype(np.int32)),
    "sm": ("smallint", lambda r: np.where(r.random(N) < 0.2, -(2**15), r.integers(
        -(2**15), 2**15, N)).astype(np.int16)),
    "ti": ("tinyint", lambda r: r.integers(-128, 128, N).astype(np.int8)),
    "d4": ("decimal(15,4)", lambda r: np.where(r.random(N) < 0.4, r.choice(
        [-150, -50, 50, 150, -250, 250, -149, 149], N), r.integers(-(10**9), 10**9, N))),
    "x": ("double", lambda r: np.where(r.random(N) < 0.1, r.choice(
        [0.0, -0.0, 1.5, -1.5], N), r.normal(0, 1000, N))),
    "y": ("double", lambda r: np.where(r.random(N) < 0.15, r.choice(
        [0.0, -0.0, 3.0, -3.0], N), r.normal(0, 30, N))),
    "f": ("boolean", lambda r: r.random(N) < 0.5),
    "g": ("boolean", lambda r: r.random(N) < 0.5),
}


class NS:
    """One package's IR constructors, so each entry makes the same
    expression in either package."""

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

    def seq(self, sym, s, name="$eq"):
        return self.call(name, [self.ref(sym), self.const("varchar", s)], "boolean")

    def revenue(self, price="price", disc="disc"):
        return self.call("$multiply", [self.ref(price), self.call("$subtract", [
            self.const("decimal(13,2)", 100), self.cast(self.ref(disc), "decimal(13,2)")],
            "decimal(13,2)")], "decimal(18,4)")


# each family: a list of (expression, output type) assignments of one program
FAMILIES = {
    "integer_arithmetic": lambda n: [
        (n.call("$add", [n.ref("a"), n.ref("b")], "bigint"), "bigint"),
        (n.call("$subtract", [n.ref("i"), n.ref("j")], "integer"), "integer"),
        (n.call("$multiply", [n.ref("a"), n.ref("a")], "bigint"), "bigint"),
        (n.call("$add", [n.ref("i"), n.const("integer", 2**31 - 1)], "integer"), "integer"),
        (n.call("$negate", [n.ref("i")], "integer"), "integer"),
        (n.call("$negate", [n.ref("sm")], "smallint"), "smallint"),
        (n.call("$multiply", [n.ref("ti"), n.ref("ti")], "tinyint"), "tinyint"),
    ],
    "integer_division": lambda n: [
        (n.call("$divide", [n.ref("a"), n.ref("b")], "bigint"), "bigint"),
        (n.call("$divide", [n.ref("i"), n.ref("j")], "integer"), "integer"),
        (n.call("$modulus", [n.ref("a"), n.ref("b")], "bigint"), "bigint"),
        (n.call("$modulus", [n.ref("i"), n.ref("j")], "integer"), "integer"),
        (n.call("$divide", [n.ref("sm"), n.ref("i")], "integer"), "integer"),
        (n.call("$modulus", [n.ref("a"), n.ref("sm")], "bigint"), "bigint"),
        (n.call("$divide", [n.ref("i"), n.const("integer", 0)], "integer"), "integer"),
    ],
    "decimal_arithmetic": lambda n: [
        (n.revenue(), "decimal(18,4)"),
        (n.call("$multiply", [n.ref("cost"), n.ref("avail")], "decimal(18,2)"),
         "decimal(18,2)"),
        (n.call("$add", [n.ref("price"), n.ref("cost")], "decimal(13,2)"), "decimal(13,2)"),
        (n.call("$modulus", [n.ref("d4"), n.const("decimal(15,4)", 70000)], "decimal(15,4)"),
         "decimal(15,4)"),
        (n.call("$negate", [n.ref("d4")], "decimal(15,4)"), "decimal(15,4)"),
    ],
    "casts": lambda n: [
        (n.cast(n.ref("d4"), "decimal(12,2)"), "decimal(12,2)"),
        (n.cast(n.ref("price"), "decimal(15,4)"), "decimal(15,4)"),
        (n.cast(n.ref("i"), "decimal(12,2)"), "decimal(12,2)"),
        (n.cast(n.ref("d4"), "bigint"), "bigint"),
        (n.cast(n.ref("price"), "double"), "double"),
        (n.cast(n.ref("a"), "double"), "double"),
        (n.cast(n.ref("i"), "bigint"), "bigint"),
        (n.cast(n.ref("a"), "integer"), "integer"),
        (n.cast(n.ref("f"), "integer"), "integer"),
        (n.cast(n.ref("j"), "boolean"), "boolean"),
        (n.cast(n.const("unknown", None), "bigint"), "bigint"),
    ],
    "double_arithmetic": lambda n: [
        (n.call("$add", [n.ref("x"), n.ref("y")], "double"), "double"),
        (n.call("$subtract", [n.ref("x"), n.ref("b")], "double"), "double"),
        (n.call("$multiply", [n.ref("x"), n.ref("y")], "double"), "double"),
        (n.call("$divide", [n.ref("x"), n.ref("y")], "double"), "double"),
        (n.call("$modulus", [n.ref("x"), n.ref("y")], "double"), "double"),
        (n.call("$negate", [n.ref("x")], "double"), "double"),
        (n.call("$divide", [n.ref("a"), n.ref("b")], "double"), "double"),
    ],
    "comparisons": lambda n: [
        (n.call(op, [n.ref(a), n.ref(b)], "boolean"), "boolean")
        for op, a, b in (("$eq", "a", "b"), ("$ne", "i", "j"), ("$lt", "x", "y"),
                         ("$lte", "price", "cost"), ("$gt", "odate", "ship_sk"),
                         ("$gte", "x", "b"), ("$lt", "f", "g"))
    ] + [(n.call("$lte", [n.call("$subtract", [n.ref("ship_sk"), n.ref("sold_sk")],
                                   "integer"), n.const("integer", 30)], "boolean"), "boolean")],
    "string_comparisons": lambda n: [
        (n.seq("nation", "BRAZIL"), "boolean"), (n.seq("prio", "2-HIGH", "$ne"), "boolean"),
        (n.seq("nation", "ZAMBIA"), "boolean"), (n.seq("nation", "BRB", "$lt"), "boolean"),
        (n.seq("prio", "3-MEDIUM", "$gte"), "boolean"),
        (n.call("$lte", [n.const("varchar", "CANADA"), n.ref("nation")], "boolean"), "boolean"),
        (n.call("$eq", [n.ref("nation"), n.const("varchar", None)], "boolean"), "boolean"),
    ],
    "logic": lambda n: [
        (n.call("$and", [n.ref("f"), n.ref("g")], "boolean"), "boolean"),
        (n.call("$or", [n.ref("f"), n.call("$lt", [n.ref("x"), n.ref("y")], "boolean")],
                "boolean"), "boolean"),
        (n.call("$not", [n.ref("f")], "boolean"), "boolean"),
        (n.call("$is_null", [n.ref("a")], "boolean"), "boolean"),
        (n.call("$not_null", [n.ref("nation")], "boolean"), "boolean"),
        (n.call("coalesce", [n.ref("a"), n.cast(n.ref("i"), "bigint"), n.const("bigint", -1)],
                "bigint"), "bigint"),
        (n.ir.InLut(n.ref("nation"), (True, False, True, False, True)), "boolean"),
    ],
    "case": lambda n: [
        (n.case([(n.call("$lt", [n.ref("a"), n.ref("b")], "boolean"), n.ref("price")),
                 (n.ref("f"), n.const("decimal(12,2)", 7))], n.const("decimal(12,2)", -1),
                "decimal(12,2)"), "decimal(12,2)"),
        (n.case([(n.call("$gt", [n.ref("j"), n.const("integer", 0)], "boolean"), n.ref("a"))],
                None, "bigint"), "bigint"),
        (n.case([(n.ref("g"), n.ref("x"))], n.ref("i"), "double"), "double"),
    ],
    "date_parts": lambda n: [
        (n.call(part, [n.ref("odate")], "bigint"), "bigint") for part in ("year", "month", "day")
    ],
}

# the computed fused projections of TPC-H (Q3, Q5 and Q10 share the revenue
# form) and TPC-DS, over columns of the same types
PROJECTIONS = {
    "tpch_q03_q05_q10": lambda n: [(n.revenue(), "decimal(18,4)")],
    "tpch_q08": lambda n: [
        (n.call("year", [n.ref("odate")], "bigint"), "bigint"),
        (n.case([(n.seq("nation", "BRAZIL"), n.revenue())], n.const("decimal(18,4)", 0),
                "decimal(18,4)"), "decimal(18,4)"),
        (n.revenue(), "decimal(18,4)"),
    ],
    "tpch_q09": lambda n: [
        (n.call("year", [n.ref("odate")], "bigint"), "bigint"),
        (n.call("$subtract", [n.revenue(), n.call("$multiply", [n.ref("cost"), n.ref("qty")],
                                                  "decimal(18,4)")], "decimal(18,4)"),
         "decimal(18,4)"),
    ],
    "tpch_q11": lambda n: [
        (n.call("$multiply", [n.ref("cost"), n.ref("avail")], "decimal(18,2)"),
         "decimal(18,2)")],
    "tpch_q12": lambda n: [
        (n.case([(n.call("$or", [n.seq("prio", "1-URGENT"), n.seq("prio", "2-HIGH")],
                         "boolean"), n.const("integer", 1))], n.const("integer", 0), "integer"),
         "integer"),
        (n.case([(n.call("$and", [n.seq("prio", "1-URGENT", "$ne"),
                                  n.seq("prio", "2-HIGH", "$ne")], "boolean"),
                  n.const("integer", 1))], n.const("integer", 0), "integer"), "integer"),
    ],
    "tpcds_q43": lambda n: [
        (n.case([(n.seq("dname", day), n.ref("sales"))], n.const("decimal(7,2)", None),
                "decimal(7,2)"), "decimal(7,2)") for day in ("Sunday", "Monday", "Saturday")
    ],
    "tpcds_q62_q99": lambda n: [
        (n.case([(cond, n.const("integer", 1))], n.const("integer", 0), "integer"), "integer")
        for cond in (
            n.call("$lte", [n.call("$subtract", [n.ref("ship_sk"), n.ref("sold_sk")],
                                   "integer"), n.const("integer", 30)], "boolean"),
            n.call("$and", [
                n.call("$gt", [n.call("$subtract", [n.ref("ship_sk"), n.ref("sold_sk")],
                                      "integer"), n.const("integer", 30)], "boolean"),
                n.call("$lte", [n.call("$subtract", [n.ref("ship_sk"), n.ref("sold_sk")],
                                       "integer"), n.const("integer", 60)], "boolean")],
                "boolean"),
            n.call("$gt", [n.call("$subtract", [n.ref("ship_sk"), n.ref("sold_sk")],
                                  "integer"), n.const("integer", 60)], "boolean"))
    ],
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(15)
    return {sym: (values(rng), rng.random(N) < 0.85) for sym, (_, values) in COLUMNS.items()}


def _port_setup(data):
    dicts = {sym: Dictionary(v) for sym, v in DICTS.items()}
    layout, env = {}, {}
    for sym, (tname, _) in COLUMNS.items():
        d = dicts.get(sym)
        layout[sym] = pc.ColumnLayout(ptypes.parse_type(tname), d)
        vals, valid = data[sym]
        env[sym] = pc.CVal(torch.from_numpy(vals), torch.from_numpy(valid), d)
    return layout, env


def _ref_eval(expr, data):
    dicts = {sym: RefDictionary(v) for sym, v in DICTS.items()}
    layout, env = {}, {}
    for sym, (tname, _) in COLUMNS.items():
        d = dicts.get(sym)
        layout[sym] = rc.ColumnLayout(rtypes.parse_type(tname), d)
        vals, valid = data[sym]
        env[sym] = rc.CVal(jnp.asarray(vals), jnp.asarray(valid), d)
    fn, _ = rc.compile_expression(expr, layout, N)
    v = fn(env)
    return np.asarray(v.data), np.asarray(v.valid)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _check_assignments(build, data):
    """Each assignment through one program: all lowered; bit for bit the
    closure's value as the projection stores it; the reference's on valid
    rows."""
    assigns = build(NS(pir, ptypes))
    ref_assigns = build(NS(rir, rtypes))
    layout, env = _port_setup(data)
    types = [ptypes.parse_type(t) for _, t in assigns]
    program = EP.build_program([(f"o{k}", e) for k, (e, _) in enumerate(assigns)], types,
                               layout, "cpu")
    assert all(k >= 0 for k in program.assign_out), program.assign_out
    outs = HK.expr_program(program, [(env[s].data, env[s].valid)
                                     for s in program.input_symbols])
    for (expr, tname), (ref_expr, _), (d, v), t in zip(assigns, ref_assigns, outs, types):
        fn, _ = pc.compile_expression(expr, layout, N, "cpu")
        want = fn(env)
        assert d.dtype == t.torch_dtype
        assert torch.equal(v, want.valid), str(expr)
        assert torch.equal(_bits(d), _bits(want.data.to(t.torch_dtype))), str(expr)
        rd, rv = _ref_eval(ref_expr, data)
        np.testing.assert_array_equal(v.numpy(), rv)
        if t == ptypes.DOUBLE:
            np.testing.assert_allclose(d.numpy()[rv], rd[rv], rtol=REL_TOL, atol=0)
        else:
            np.testing.assert_array_equal(d.numpy()[rv], rd[rv].astype(d.numpy().dtype))
    return program


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_operation_family_matches_closures_and_reference(family, data):
    _check_assignments(FAMILIES[family], data)


@pytest.mark.parametrize("projection", sorted(PROJECTIONS))
def test_fused_projection_matches_closures_and_reference(projection, data):
    program = _check_assignments(PROJECTIONS[projection], data)
    assert program.n_regs <= HK.EXPR_MAX_REGS and len(program.code) <= HK.EXPR_MAX_INSTRS


def test_common_subexpressions_are_computed_once(data):
    """Q8's revenue appears twice in its projection; the program reads each
    column once and computes the product once."""
    program = _check_assignments(PROJECTIONS["tpch_q08"], data)
    ops = [p[0] for p in program.plain]
    assert ops.count("load") == len(program.input_symbols) == 4
    assert ops.count("mul") == 1


def _project(assigns, data):
    """(page, closure counts) of a projection through the executor's fused
    projection (``_project_program``)."""
    layout, env = _port_setup(data)
    types = [ptypes.parse_type(t) for _, t in assigns]
    compiled = []
    for (expr, _), t in zip(assigns, types):
        fn, out_dict = pc.compile_expression(expr, layout, N, "cpu")
        compiled.append((fn, t, out_dict))
    program = EP.build_program([(f"o{k}", e) for k, (e, _) in enumerate(assigns)], types,
                               layout, "cpu")
    cols = tuple(Column(layout[s].type, env[s].data, env[s].valid, layout[s].dictionary)
                 for s in COLUMNS)
    page = Page(cols, torch.ones(N, dtype=torch.bool))
    MK.reset_counts()
    out = pex._project_program(program, tuple(compiled), env, page)
    return out, program, dict(MK.STAGES)


def test_assignments_left_on_closures_tick_project_torch(data):
    """A string-valued CASE, a long-decimal product and a rename: the first
    two keep their closures (one ``project_torch`` tick each), the rename
    none; the values are the reference's."""
    n, r = NS(pir, ptypes), NS(rir, rtypes)

    def build(ns):
        return [
            (ns.case([(ns.ref("f"), ns.ref("nation"))], ns.const("varchar", "NONE"), "varchar"),
             "varchar"),
            (ns.call("$multiply", [ns.ref("d4"), ns.ref("price")], "decimal(38,6)"),
             "decimal(38,6)"),
            (ns.ref("a"), "bigint"),
            (ns.revenue(), "decimal(18,4)"),
        ]

    out, program, stages = _project(build(n), data)
    assert program.assign_out == (EP.CLOSURE, EP.CLOSURE, EP.RENAME, 0)
    assert stages.get("project_torch") == 2 and stages.get("project") == 1
    dicts = {sym: list(v) for sym, v in DICTS.items()}
    for col, (expr, tname) in zip(out.columns, build(r)):
        rd, rv = _ref_eval(expr, data)
        np.testing.assert_array_equal(col.valid.numpy(), rv)
        if tname == "varchar":
            got = np.asarray(col.dictionary.values)[col.data.numpy()[rv]]
            vocab = ["NONE"] + dicts["nation"]
            want = np.asarray(sorted(set(vocab)), dtype=object)[rd[rv]]
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(col.data.numpy()[rv], rd[rv])


def test_projection_past_the_output_limit_keeps_the_rest_on_closures(data):
    """One assignment more than a program holds: the first
    ``EXPR_MAX_OUTPUTS`` run in the program, the last on its closure (one
    tick), every value the reference's."""
    k = HK.EXPR_MAX_OUTPUTS + 1

    def build(ns):
        return [(ns.call("$add", [ns.ref("a"), ns.const("bigint", c)], "bigint"), "bigint")
                for c in range(k)]

    out, program, stages = _project(build(NS(pir, ptypes)), data)
    assert program.assign_out == tuple(range(k - 1)) + (EP.CLOSURE,)
    assert stages.get("project_torch") == 1
    for col, (expr, _) in zip(out.columns, build(NS(rir, rtypes))):
        rd, rv = _ref_eval(expr, data)
        np.testing.assert_array_equal(col.valid.numpy(), rv)
        np.testing.assert_array_equal(col.data.numpy()[rv], rd[rv])


def test_programs_are_cached_and_dropped_with_the_closures(data):
    layout, _ = _port_setup(data)
    assigns = [("o", PROJECTIONS["tpch_q11"](NS(pir, ptypes))[0][0])]
    types = [ptypes.parse_type("decimal(18,2)")]
    a = EP.build_program(assigns, types, layout, "cpu")
    assert EP.build_program(assigns, types, layout, "cpu") is a
    pc.clear_cache()
    assert EP.build_program(assigns, types, layout, "cpu") is not a


def test_expr_program_raises_on_inputs_it_does_not_take(data):
    layout, env = _port_setup(data)
    assigns = [("o", PROJECTIONS["tpch_q11"](NS(pir, ptypes))[0][0])]
    program = EP.build_program(assigns, [ptypes.parse_type("decimal(18,2)")], layout, "cpu")
    inputs = [(env[s].data, env[s].valid) for s in program.input_symbols]
    with pytest.raises(ValueError):
        HK.expr_program(program, inputs[:1])
    with pytest.raises(TypeError):
        HK.expr_program(program, [(d.to(torch.int16), v) for d, v in inputs])


# the register file's facts the kernel relies on: its shared file has
# max(n_regs, 1) rows and a row's validity is one 32-bit mask


def _check_register_indices(program):
    """Every register an instruction names (its operands, and its result but
    a store's) lies in the file and the mask."""
    assert 0 <= program.n_regs <= HK.EXPR_MAX_REGS == 32
    size = max(program.n_regs, 1)
    for (op, dst, a, b, c, _, _), (name, _, args, *_) in zip(program.code, program.plain):
        assert op == EP.OPS[name]
        named = (a, b, c)[:len(args)] + (() if name == "store" else (dst,))
        assert list(named[:len(args)]) == list(args)
        assert all(0 <= r < size for r in named), (name, dst, a, b, c, size)


def test_tpch_corpus_programs_fit_the_file_and_the_mask(monkeypatch):
    """Every program the TPC-H corpus's fused projections build at SF0.01."""
    from trino_tpu_torch.runtime import LocalQueryRunner

    built = []
    orig = EP.build_program

    def tapped(*args, **kw):
        built.append(orig(*args, **kw))
        return built[-1]

    monkeypatch.setattr(EP, "build_program", tapped)
    runner = LocalQueryRunner.tpch(scale=0.01, device="cpu")
    pc.clear_cache()
    for sql in TPCH_QUERIES.values():
        runner.execute(sql)
    programs = [p for p in built if p.code]
    assert len(programs) >= 5
    for program in programs:
        _check_register_indices(program)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_programs_fit_the_file_and_the_mask(family, data):
    layout, _ = _port_setup(data)
    assigns = FAMILIES[family](NS(pir, ptypes))
    program = EP.build_program([(f"o{k}", e) for k, (e, _) in enumerate(assigns)],
                               [ptypes.parse_type(t) for _, t in assigns], layout, "cpu")
    _check_register_indices(program)


def test_program_struct_carries_n_regs(data):
    """The kernel parameter ends with n_code then n_regs, as ExprProgram in
    csrc/expr_program.cu does."""
    assert [f for f, _ in HK._ExprProgram._fields_[-2:]] == ["n_code", "n_regs"]
    layout, _ = _port_setup(data)
    assigns = PROJECTIONS["tpch_q08"](NS(pir, ptypes))
    program = EP.build_program([(f"o{k}", e) for k, (e, _) in enumerate(assigns)],
                               [ptypes.parse_type(t) for _, t in assigns], layout, "cpu")
    static = HK._program_struct(program)
    assert (static.n_code, static.n_regs) == (len(program.code), program.n_regs)
    assert program.n_regs >= 3


def _rows_of_plan(n: int, k: int, block_rows: int, grid: int) -> np.ndarray:
    """How many times the kernel's threads take each row: block b takes
    tiles b, b + grid, ...; thread t row j of a tile, row tile * block_rows
    + j * EXPR_BLOCK_THREADS + t, where it is below n."""
    threads = HK.EXPR_BLOCK_THREADS
    assert block_rows == k * threads
    tiles = -(-n // block_rows)
    seen = np.zeros(n, np.int64)
    local = (np.arange(k)[:, None] * threads + np.arange(threads)[None, :]).ravel()
    for b in range(grid):
        for tile in range(b, tiles, grid):
            rows = tile * block_rows + local
            np.add.at(seen, rows[rows < n], 1)
    return seen


# resident blocks of kernel<k> an SM holds, by k (0: the file does not fit):
# a few registers, the main projection's 7, 16 and the limit's 32
OCCUPANCY = {"3 registers": {4: 4, 2: 8, 1: 8}, "7 registers": {4: 3, 2: 7, 1: 8},
             "16 registers": {4: 1, 2: 3, 1: 6}, "32 registers": {4: 0, 2: 1, 1: 3}}


@pytest.mark.parametrize("regs", sorted(OCCUPANCY))
@pytest.mark.parametrize("n", ["1", "block rows less one", "4194307"])
def test_expr_program_plan_covers_every_row_once(regs, n):
    sms, occupancy = 132, OCCUPANCY[regs]
    n_regs = int(regs.split()[0])
    rows = 1 if n == "1" else int(n) if n.isdigit() else None
    if rows is None:  # a block's rows less one, of the k the plan takes there
        k, block_rows, _ = HK.expr_program_plan(10**9, n_regs, sms, occupancy)
        rows = block_rows - 1
    k, block_rows, grid = HK.expr_program_plan(rows, n_regs, sms, occupancy)
    assert occupancy[k] >= 1 and 1 <= grid <= sms * occupancy[k]
    assert (_rows_of_plan(rows, k, block_rows, grid) == 1).all()


def test_expr_program_plan_takes_the_most_rows_a_thread_at_two_blocks_an_sm():
    occupancy = OCCUPANCY["7 registers"]
    assert HK.expr_program_plan(4_194_304, 7, 132, occupancy) == (4, 1024, 396)
    assert HK.expr_program_plan(1, 7, 132, occupancy) == (4, 1024, 1)
    assert HK.expr_program_plan(4_194_304, 16, 132, OCCUPANCY["16 registers"])[0] == 2
    assert HK.expr_program_plan(4_194_304, 32, 132, OCCUPANCY["32 registers"])[0] == 1
    assert HK.expr_program_plan(4_194_304, 32, 132, {4: 0, 2: 1, 1: 0})[0] == 2
    with pytest.raises(ValueError):
        HK.expr_program_plan(100, 33, 132, {4: 0, 2: 0, 1: 0})
