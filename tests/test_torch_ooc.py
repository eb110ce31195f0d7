"""The out-of-core runner (``runtime/ooc.py``) in the port, on the CPU at
SF0.01, held against the reference's in-core rows and the port's own.

The cases of ``tests/test_ooc.py``: Q1, Q3, Q5, Q18 and a LEFT join with 4
buckets and split batches of 2; a global aggregate over an empty selection;
a 1-byte memory budget that sends every chunk to the disk tier; the
cross-join refusal; split batching that covers every row; unit counts.
Besides: ``prefetch_depth`` 0 and 2 give identical rows, and the bucket
store, the chunk split and the shape classes against the reference's.
The reference's out-of-core runner itself is not run (its XLA compiles
cost tens of seconds a query on the CPU).
"""

import numpy as np
import pytest

from trino_tpu.runtime import LocalQueryRunner as RefRunner
from trino_tpu.runtime import ooc as ref_ooc

from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.runtime import LocalQueryRunner
from trino_tpu_torch.runtime import ooc
from trino_tpu_torch.runtime.ooc import OutOfCoreRunner, OutOfCoreUnsupported, execute_out_of_core
from trino_tpu_torch.spi import types as port_types

SCALE = 0.01

Q1 = """
SELECT l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
       sum(l_extendedprice*(1-l_discount)), avg(l_quantity), count(*)
FROM lineitem WHERE l_shipdate <= DATE '1998-09-02'
GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus
"""

Q3 = """
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate LIMIT 10
"""

Q5 = """
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'ASIA' AND o_orderdate >= DATE '1994-01-01'
  AND o_orderdate < DATE '1995-01-01'
GROUP BY n_name ORDER BY revenue DESC
"""

# TPC-H's threshold of 300 leaves one order at SF0.01; 150 (the corpus
# text's) leaves a few dozen
Q18 = """
SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
FROM customer, orders, lineitem
WHERE o_orderkey IN (
    SELECT l_orderkey FROM lineitem GROUP BY l_orderkey HAVING sum(l_quantity) > {qty})
  AND c_custkey = o_custkey AND o_orderkey = l_orderkey
GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate LIMIT 100
"""

LEFT_JOIN = """
SELECT c_custkey, count(o_orderkey)
FROM customer LEFT JOIN orders ON c_custkey = o_custkey
GROUP BY c_custkey ORDER BY c_custkey LIMIT 20
"""

QUERIES = {"q1": Q1, "q3": Q3, "q5": Q5, "q18_300": Q18.format(qty=300),
           "q18_150": Q18.format(qty=150), "leftjoin": LEFT_JOIN,
           "empty_selection":
               "SELECT count(*), sum(l_quantity) FROM lineitem WHERE l_quantity < 0"}


@pytest.fixture(scope="module")
def runner():
    return LocalQueryRunner.tpch(scale=SCALE, device="cpu")


@pytest.fixture(scope="module")
def reference_rows():
    ref = RefRunner.tpch(scale=SCALE)
    return {q: ref.execute(sql).rows for q, sql in QUERIES.items()}


def _ooc_rows(runner, sql, **kw):
    kw.setdefault("n_buckets", 4)
    kw.setdefault("split_batch", 2)
    names, page = execute_out_of_core(runner.plan_sql(sql), runner.metadata,
                                      runner.session, **kw)
    return names, page.to_pylist()


def _assert_matches(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for rg, rw in zip(got, want):
        for a, b in zip(rg, rw):
            if isinstance(a, float) and isinstance(b, float):
                assert a == b or abs(a - b) <= 1e-9 * max(abs(a), abs(b)), (a, b)
            else:
                assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_matches_in_core(runner, reference_rows, query):
    names, got = _ooc_rows(runner, QUERIES[query])
    _assert_matches(got, reference_rows[query])
    _assert_matches(got, runner.execute(QUERIES[query]).rows)
    assert names == list(runner.plan_sql(QUERIES[query]).root.column_names)


@pytest.mark.parametrize("query", ["q3", "q18_150"])
def test_prefetch_depth_zero_and_two_identical(runner, query):
    _, serial = _ooc_rows(runner, QUERIES[query], prefetch_depth=0)
    plan = runner.plan_sql(QUERIES[query])
    r = OutOfCoreRunner(plan, runner.metadata, runner.session, n_buckets=4, split_batch=2,
                        prefetch_depth=2)
    _, page = r.execute()
    assert page.to_pylist() == serial
    assert r.stats["prefetch_hits"] > 0 and r.stats["prefetch_misses"] == 0
    assert r.stats["prefetch_max_depth"] <= 2


def test_prefetch_budget_caps_staged_buckets(runner):
    r = OutOfCoreRunner(runner.plan_sql(Q3), runner.metadata, runner.session, n_buckets=4,
                        split_batch=2, prefetch_depth=3, prefetch_budget_bytes=1)
    _, page = r.execute()
    assert r.stats["prefetch_max_depth"] == 1  # one bucket is always admitted
    assert page.to_pylist() == runner.execute(Q3).rows


def test_bucket_store_spills_and_results_match(runner, reference_rows, tmp_path):
    r = OutOfCoreRunner(runner.plan_sql(Q3), runner.metadata, runner.session, n_buckets=4,
                        split_batch=2, mem_budget_bytes=1, spool_dir=str(tmp_path))
    _, page = r.execute()
    assert r.stats["spilled_bytes"] > 0
    _assert_matches(page.to_pylist(), reference_rows["q3"])
    # the spool files go with the store
    assert not any(tmp_path.iterdir())


def test_stats_keys_are_the_reference_keys(runner):
    r = OutOfCoreRunner(runner.plan_sql(Q1), runner.metadata, runner.session, n_buckets=4,
                        split_batch=2)
    r.execute()
    want = {"fragments", "device_busy_secs", "compile_secs", "fallback_secs",
            "host_wait_secs", "emit_secs", "prefetch_hits", "prefetch_misses",
            "prefetch_max_inflight_bytes", "prefetch_max_depth", "caps_from_store",
            "spilled_bytes", "shape_classes", "compiles"}
    assert want <= set(r.stats)
    assert r.stats["device_busy_secs"] > 0 and r.stats["fallback_secs"] == 0


def test_cross_join_rejected(runner, tmp_path):
    plan = runner.plan_sql("SELECT count(*) FROM nation, region")
    with pytest.raises(OutOfCoreUnsupported):
        OutOfCoreRunner(plan, runner.metadata, runner.session, spool_dir=str(tmp_path))
    with pytest.raises(OutOfCoreUnsupported):
        execute_out_of_core(plan, runner.metadata, runner.session)


@pytest.mark.parametrize("batch", [1, 3, 100])
def test_split_batching_covers_all_rows(runner, batch):
    sql = "SELECT count(*) FROM lineitem"
    _, got = _ooc_rows(runner, sql, split_batch=batch)
    assert got == runner.execute(sql).rows


@pytest.fixture(scope="module")
def small_splits():
    r = LocalQueryRunner(device="cpu")
    r.register_catalog("tpch", TpchConnector(scale=SCALE, split_target_rows=8192, device="cpu"))
    r.session.catalog, r.session.schema = "tpch", "sf0_01"
    return r


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_unit_counts_reflect_batching(small_splits, batch):
    from trino_tpu_torch.parallel.runner import scan_sources
    from trino_tpu_torch.planner.plan import TableScanNode, visit_plan

    sql = "SELECT count(*) FROM lineitem"
    scans = []
    visit_plan(small_splits.plan_sql(sql).root,
               lambda n: scans.append(n) if isinstance(n, TableScanNode) else None)
    n_splits = len(scan_sources(small_splits.metadata, scans[0])[0])
    assert n_splits >= 2
    r = OutOfCoreRunner(small_splits.plan_sql(sql), small_splits.metadata,
                        small_splits.session, n_buckets=4, split_batch=batch)
    _, page = r.execute()
    units = [v for k, v in r.stats.items() if k.endswith("_units")]
    # a single-split unit first, then ceil((splits - 1) / batch) batches
    assert max(units) == 1 + -(-(n_splits - 1) // batch)
    assert page.to_pylist() == small_splits.execute(sql).rows


# --------------------------------------------------------------------------- #
# the pieces against the reference's
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [0, 1, 1024, 1025, 4096, 5000, 70000, 1 << 22])
def test_shape_class_like_reference(n):
    assert ooc._shape_class(n) == ref_ooc._shape_class(n)


def _chunk(rng, n):
    bigint = port_types.parse_type("bigint")
    return [(bigint, rng.integers(0, 100, n), rng.random(n) < 0.9, None),
            (bigint, np.arange(n), np.ones(n, dtype=bool), None)]


@pytest.mark.parametrize("n_buckets", [1, 4, 64])
def test_split_chunk_by_targets_like_reference(n_buckets):
    rng = np.random.default_rng(7)
    cols = _chunk(rng, 5000)
    targets = rng.integers(0, n_buckets, 5000)
    got = ooc._split_chunk_by_targets(cols, targets, n_buckets)
    want = ref_ooc._split_chunk_by_targets(cols, targets, n_buckets)
    assert len(got) == len(want) == n_buckets
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        for (_, gd, gv, _), (_, wd, wv, _) in zip(g or [], w or []):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gv, wv)


def test_bucket_store_memory_then_disk(tmp_path):
    from trino_tpu_torch.runtime.spiller import io_pool

    rng = np.random.default_rng(9)
    first, second = _chunk(rng, 1000), _chunk(rng, 500)
    store = ooc.BucketStore(2, budget_bytes=ooc._chunk_bytes(first), spool_dir=str(tmp_path),
                            tag="t")
    store.append(1, first, pool=io_pool())
    store.append(1, second, pool=io_pool())
    store.append(0, _chunk(rng, 0))  # empty chunks are dropped
    assert store.spilled_bytes == ooc._chunk_bytes(second)
    assert store.rows_of(1) == 1500 and store.rows_of(0) == 0
    assert store.bucket_nbytes(1) == ooc._chunk_bytes(first) + ooc._chunk_bytes(second)
    back = store.read(1, pool=io_pool())
    for chunk, orig in zip(back, (first, second)):
        for (_, d, v, _), (_, od, ov, _) in zip(chunk, orig):
            np.testing.assert_array_equal(d, od)
            np.testing.assert_array_equal(v, ov)
    assert len(store.read_all()) == 2
    store.drop()
    assert not any(tmp_path.iterdir())
