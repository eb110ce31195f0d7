"""The streaming aggregation (``runtime/streaming.py``) in the port against
the reference's ``execute_streaming``, on the CPU.

The cases of ``tests/test_streaming.py``: Q6 (a global aggregate), Q1 with
the avg decomposition, the carry's bounded capacity, and the refusals of a
join, unbounded group keys and DISTINCT. The connector's splits are cut to
8,192 rows so the stream runs over many splits at SF0.02. Rows must equal
the reference's streamed rows and the port's in-core rows (DOUBLE at 1e-9
relative).
"""

import numpy as np
import pytest

from trino_tpu.connectors.tpch import TpchConnector as RefConnector
from trino_tpu.runtime import LocalQueryRunner as RefRunner
from trino_tpu.runtime.streaming import execute_streaming as ref_execute_streaming

from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.runtime import LocalQueryRunner
from trino_tpu_torch.runtime.streaming import (
    StreamingAggQuery,
    StreamingUnsupported,
    execute_streaming,
)

SPLIT_ROWS = 1 << 13

QUERIES = {
    "q06": """
        SELECT sum(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= DATE '1994-01-01'
          AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR
          AND l_discount BETWEEN 0.06 - 0.01 AND 0.06 + 0.01
          AND l_quantity < 24
    """,
    "q01": """
        SELECT l_returnflag, l_linestatus,
               sum(l_quantity) AS sum_qty,
               sum(l_extendedprice) AS sum_base_price,
               sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
               avg(l_quantity) AS avg_qty, avg(l_discount) AS avg_disc,
               count(*) AS count_order
        FROM lineitem
        WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus
    """,
    # DOUBLE sums and avg, min/max, a boolean key and a HAVING-free tail
    "doubles": """
        SELECT l_linestatus, l_discount > 0.05, avg(l_extendedprice * 1.5e0),
               sum(l_tax * 2.0e0), min(l_shipdate), max(l_quantity), count(l_comment)
        FROM lineitem WHERE l_quantity > 10
        GROUP BY l_linestatus, l_discount > 0.05
        ORDER BY 1, 2
    """,
}


def _runner(cls, connector_cls, **kw):
    r = cls(**kw)
    r.register_catalog("tpch", connector_cls(scale=0.02, split_target_rows=SPLIT_ROWS, **kw))
    r.session.catalog, r.session.schema = "tpch", "sf0_02"
    return r


@pytest.fixture(scope="module")
def runner():
    return _runner(LocalQueryRunner, TpchConnector, device="cpu")


@pytest.fixture(scope="module")
def reference():
    r = _runner(RefRunner, RefConnector)
    out = {}
    for q, sql in QUERIES.items():
        _, page = ref_execute_streaming(r.plan_sql(sql), r.metadata, r.session)
        act = np.asarray(page.active)
        out[q] = [tuple(row) for row, a in zip(page.to_pylist(), act) if a]
    return out


def _close(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        for a, b in zip(rg, rw):
            if isinstance(a, float) and isinstance(b, float):
                assert a == b or abs(a - b) <= 1e-9 * max(abs(a), abs(b)), (a, b)
            else:
                assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_streamed_rows_match_reference_and_in_core(query, runner, reference):
    q = StreamingAggQuery(runner.plan_sql(QUERIES[query]), runner.metadata, runner.session)
    names, page = q.execute()
    assert q.splits_processed > 4  # genuinely streamed
    assert q.stats["generate_secs"] > 0
    rows = page.to_pylist()
    _close(rows, reference[query])
    _close(rows, runner.execute(QUERIES[query]).rows)
    assert names == list(runner.plan_sql(QUERIES[query]).root.column_names)


def test_grouped_sums_run_through_the_kernel_wrappers(runner, monkeypatch):
    """The partial aggregation of every split reaches the grouped-sum
    wrappers (on the CPU their plain version): one pass a split at least."""
    calls = []
    real = HK.grouped_sum_i64

    def counting(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(HK, "grouped_sum_i64", counting)
    runner.session.set("pallas_aggregation", "interpret")
    try:
        q = StreamingAggQuery(runner.plan_sql(QUERIES["q01"]), runner.metadata, runner.session)
        q.execute()
    finally:
        runner.session.set("pallas_aggregation", "auto")
    assert len(calls) >= q.splits_processed


def test_carry_capacity_bounded(runner):
    """The carry (the partial state) stays at the key domain's size, however
    many splits streamed through."""
    q = StreamingAggQuery(runner.plan_sql(QUERIES["q01"]), runner.metadata, runner.session)
    page = None
    for p in q._split_pages():
        page = q._partial_rel(p).page
        break
    assert page.capacity <= 64
    carry = page
    for n, p in enumerate(q._split_pages()):
        carry = q._step(carry, p)
        assert carry.capacity == page.capacity
        if n == 3:
            break


def test_join_rejected(runner):
    plan = runner.plan_sql("SELECT count(*) FROM lineitem, orders WHERE l_orderkey = o_orderkey")
    with pytest.raises(StreamingUnsupported):
        execute_streaming(plan, runner.metadata, runner.session)


def test_unbounded_group_keys_rejected(runner):
    plan = runner.plan_sql("SELECT l_orderkey, sum(l_quantity) FROM lineitem GROUP BY l_orderkey")
    q = StreamingAggQuery(plan, runner.metadata, runner.session)
    with pytest.raises(StreamingUnsupported):
        q.execute()


def test_distinct_rejected(runner):
    plan = runner.plan_sql("SELECT count(DISTINCT l_suppkey) FROM lineitem")
    with pytest.raises(StreamingUnsupported):
        execute_streaming(plan, runner.metadata, runner.session)
