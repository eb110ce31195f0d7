"""Long decimals (DECIMAL(p>18), two int64 limbs) in the port against the
reference: each function of ``trino_tpu_torch/ops/int128.py`` against
``trino_tpu/ops/int128.py`` on the same limbs (random 128-bit values, the
int64 edges, and values near zero), bit for bit; then long-decimal SQL
(VALUES and literals, casts both ways, comparisons, ``+ - *``, negation,
``sum``/``avg`` through the limb decomposition, ORDER BY) through both
engines at TPC-H SF0.01, rows identical.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_tpch_corpus import assert_same_rows
from trino_tpu.ops import int128 as ref
from trino_tpu.runtime import LocalQueryRunner as RefRunner

from trino_tpu_torch.ops import int128 as port
from trino_tpu_torch.runtime import LocalQueryRunner

_EDGES = [0, 1, -1, 2**63 - 1, -(2**63), 2**63, -(2**63) - 1, 2**64 - 1, 2**64,
          -(2**64), 10**37, -(10**37), 2**126, -(2**126)]


def _values(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    vals = list(_EDGES)
    for bits in (8, 40, 70, 100, 125):
        for x in rng.integers(0, 2**62, size=(n // 5, 2), dtype=np.int64):
            v = (int(x[0]) << 62 | int(x[1])) % (1 << bits)
            vals.append(-v if rng.random() < 0.5 else v)
    return vals


def _limbs(vals):
    return ref.np_from_ints(vals)


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


BINARY = ["add", "sub", "mul", "eq", "lt", "lte"]
UNARY = ["negate", "abs_", "is_negative", "to_float64", "fits_int64", "hi", "lo"]


@pytest.mark.parametrize("fn", BINARY)
def test_binary_matches_reference(fn):
    a, b = _limbs(_values(1)), _limbs(_values(2)[::-1])
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    _same(getattr(port, fn)(torch.from_numpy(a), torch.from_numpy(b)),
          getattr(ref, fn)(a, b))


@pytest.mark.parametrize("fn", UNARY)
def test_unary_matches_reference(fn):
    a = _limbs(_values(3))
    _same(getattr(port, fn)(torch.from_numpy(a)), getattr(ref, fn)(a))


def test_order_key_pair_and_int64_products_match_reference():
    a = _limbs(_values(4))
    for g, w in zip(port.order_key_pair(torch.from_numpy(a)), ref.order_key_pair(a)):
        _same(g, w)
    x = np.array([0, 1, -1, 2**63 - 1, -(2**63), 123456789012345, -98765432109876],
                 dtype=np.int64)
    _same(port.from_int64(torch.from_numpy(x)), ref.from_int64(x))
    small = _limbs([v % 10**30 - 5 * 10**29 for v in _values(5)])
    for k in (1, -7, 10**9, -(2**40)):
        _same(port.mul_int64(torch.from_numpy(small), k), ref.mul_int64(small, k))


@pytest.mark.parametrize("k", [0, 1, 2, 9, 10, 18, 19, 30])
def test_rescale_matches_reference(k):
    a = _limbs([v % 10**36 - 5 * 10**35 for v in _values(6)])
    _same(port.div_round_pow10(torch.from_numpy(a), k), ref.div_round_pow10(a, k))
    small = _limbs([v % 10**18 for v in _values(7)])
    _same(port.scale_up_pow10(torch.from_numpy(small), min(k, 19)),
          ref.scale_up_pow10(small, min(k, 19)))


def test_div_int_matches_reference():
    a = _limbs([v % 10**36 - 5 * 10**35 for v in _values(8)])
    d = np.random.default_rng(8).integers(0, 2**31 - 1, size=len(a)).astype(np.int64)
    _same(port.div_int(torch.from_numpy(a), torch.from_numpy(d)), ref.div_int(a, d))


def test_host_conversions_round_trip():
    vals = [v for v in _values(9) if -(2**127) <= v < 2**127]
    limbs = port.np_from_ints(vals)
    np.testing.assert_array_equal(limbs, ref.np_from_ints(vals))
    assert port.np_to_ints(limbs) == ref.np_to_ints(limbs)


LONG_SQL = {
    "values": "SELECT x FROM (VALUES CAST(12345678901234567890.5 AS DECIMAL(22,1)), "
    "CAST(-3.5 AS DECIMAL(22,1)), NULL) t(x)",
    "literals": "SELECT 12345678901234567890.5, -12345678901234567890.25 * 3",
    "sum_avg": "SELECT sum(CAST(l_extendedprice AS DECIMAL(30,2))), "
    "avg(CAST(l_extendedprice AS DECIMAL(30,2))) FROM lineitem",
    "grouped_product_sum": "SELECT l_returnflag, sum(CAST(l_extendedprice AS DECIMAL(30,2)) "
    "* CAST(l_quantity AS DECIMAL(25,2))) s FROM lineitem GROUP BY l_returnflag "
    "ORDER BY s DESC",
    "compare": "SELECT count(*) FROM lineitem WHERE CAST(l_extendedprice AS DECIMAL(30,2)) "
    "* 1000000000000 > CAST(4000000000000000.00 AS DECIMAL(30,2))",
    "casts": "SELECT o_orderkey, CAST(CAST(o_totalprice AS DECIMAL(30,4)) AS DECIMAL(12,2)), "
    "CAST(CAST(o_totalprice AS DECIMAL(30,2)) AS double), CAST(CAST(o_totalprice AS "
    "DECIMAL(30,2)) AS bigint), -CAST(o_totalprice AS DECIMAL(30,2)), "
    "CAST(o_totalprice AS DECIMAL(30,2)) - CAST(1 AS DECIMAL(20,0)) "
    "FROM orders ORDER BY o_orderkey LIMIT 20",
    "order_by": "SELECT o_orderkey, CAST(o_totalprice AS DECIMAL(30,2)) v FROM orders "
    "ORDER BY v DESC, o_orderkey LIMIT 20",
}


@pytest.fixture(scope="module")
def runners():
    return RefRunner.tpch(scale=0.01), LocalQueryRunner.tpch(scale=0.01, device="cpu")


@pytest.mark.parametrize("case", sorted(LONG_SQL))
def test_long_decimal_sql_matches_reference(case, runners):
    r, p = runners
    assert_same_rows(p.execute(LONG_SQL[case]), r.execute(LONG_SQL[case]))


# long decimals as aggregation payloads: the group sort carries their limbs
# (the sort shape, and the fused join+aggregate's sort stage with fusion on)
PAYLOAD_SQL = {
    "sort_count": "SELECT l_partkey, count(CAST(l_extendedprice AS DECIMAL(30,2))) c "
    "FROM lineitem GROUP BY l_partkey ORDER BY l_partkey",
    "join_count_sum": "SELECT o_custkey, count(CAST(l_extendedprice AS DECIMAL(30,2))) c, "
    "sum(CAST(l_extendedprice AS DECIMAL(30,2))) s FROM lineitem JOIN orders "
    "ON l_orderkey = o_orderkey GROUP BY o_custkey ORDER BY o_custkey",
}


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("case", sorted(PAYLOAD_SQL))
def test_long_decimal_payload_matches_reference(case, fusion, runners):
    r, p = runners
    p.session.set("pallas_fusion", fusion)
    try:
        assert_same_rows(p.execute(PAYLOAD_SQL[case]), r.execute(PAYLOAD_SQL[case]))
    finally:
        p.session.set("pallas_fusion", True)


@pytest.mark.parametrize("fn", ["min", "max"])
def test_long_decimal_min_max_raise_naming_int128(fn, runners):
    """The reference's hi-then-tied-lo reduction is not ported: a named
    refusal, not a shape error from the reduction."""
    _, p = runners
    sql = (f"SELECT l_returnflag, {fn}(CAST(l_extendedprice AS DECIMAL(30,2))) "
           "FROM lineitem GROUP BY l_returnflag")
    with pytest.raises(NotImplementedError, match=r"ops\.int128"):
        p.execute(sql)
