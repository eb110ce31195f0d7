"""The worker control plane of the port (``trino_tpu_torch.server.worker``)
through the remote tier of its ``DistributedQueryRunner`` at
``device="cpu"``: ``tests/test_worker.py``'s twelve test functions that do
not use fault-tolerant execution, replayed with the port's classes (rows
against the reference's ``LocalQueryRunner``), and its FTE case, which must
raise naming the module that is not ported. Every HTTP call has a timeout
and every fixture stops its servers in a finalizer, so that no test can
hang the suite. Also: the exchange destination stage runs on the workers'
hash exchanges, and both entry points default to ``cuda``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from trino_tpu.runtime import LocalQueryRunner as RefLocal

from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.metadata import CatalogManager, Session
from trino_tpu_torch.parallel.runner import DistributedQueryRunner
from trino_tpu_torch.server.worker import SIGNATURE_HEADER, WorkerServer, sign

SCALE = 0.0005
SECRET = "test-cluster-secret"
TIMEOUT = 60


def _worker_catalogs():
    c = CatalogManager()
    c.register("tpch", TpchConnector(scale=SCALE, split_target_rows=512, device="cpu"))
    return c


def _start(secret=SECRET):
    return WorkerServer(_worker_catalogs(), secret=secret, device="cpu").start()


@pytest.fixture(scope="module")
def workers(request):
    ws = [_start() for _ in range(2)]
    request.addfinalizer(lambda: [w.stop() for w in ws])
    return ws


def _make_dist(workers, n_workers=4, secret=SECRET):
    dist = DistributedQueryRunner(
        Session(catalog="tpch", schema="sf0_0005"), n_workers=n_workers,
        worker_urls=[f"http://{w.address}" for w in workers], secret=secret, device="cpu")
    dist.catalogs.register("tpch", TpchConnector(scale=SCALE, split_target_rows=512,
                                                 device="cpu"))
    return dist


@pytest.fixture(scope="module")
def remote_dist(workers):
    return _make_dist(workers)


@pytest.fixture(scope="module")
def local():
    return RefLocal.tpch(scale=SCALE)


def _open(req):
    return urllib.request.urlopen(req, timeout=TIMEOUT)


class TestRemoteWorkers:
    QUERIES = [
        "SELECT count(*), sum(l_quantity) FROM lineitem",
        "SELECT l_returnflag, count(*) c, avg(l_quantity) a FROM lineitem GROUP BY 1 ORDER BY 1",
        "SELECT count(*) FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
        "WHERE l_quantity < 10",
        "SELECT c_mktsegment, count(*) FROM customer JOIN nation ON c_nationkey = n_nationkey "
        "GROUP BY 1 ORDER BY 1",
    ]

    @pytest.mark.parametrize("sql", QUERIES)
    def test_parity_with_local(self, remote_dist, local, sql):
        a = remote_dist.execute(sql).rows
        b = local.execute(sql).rows
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            for va, vb in zip(ra, rb):
                if isinstance(va, float):
                    assert abs(va - vb) <= 1e-9 * max(1.0, abs(vb))
                else:
                    assert va == vb

    def test_bad_task_body_rejected(self, workers):
        body = b"not json"
        req = urllib.request.Request(f"http://{workers[0].address}/v1/task/bogus", data=body,
                                     method="POST")
        req.add_header(SIGNATURE_HEADER, sign(SECRET, "POST", "/v1/task/bogus", body))
        with pytest.raises(urllib.error.HTTPError) as e:
            _open(req)
        assert e.value.code == 400

    def test_signature_binds_method_and_path(self, workers):
        # a GET signature must not authorize a DELETE of the same path
        rel = "/v1/task/sometask"
        req = urllib.request.Request(f"http://{workers[0].address}{rel}", method="DELETE")
        req.add_header(SIGNATURE_HEADER, sign(SECRET, "GET", rel))
        with pytest.raises(urllib.error.HTTPError) as e:
            _open(req)
        assert e.value.code == 401
        # nor a POST under another task id
        body = b"{}"
        req2 = urllib.request.Request(f"http://{workers[0].address}/v1/task/b", data=body,
                                      method="POST")
        req2.add_header(SIGNATURE_HEADER, sign(SECRET, "POST", "/v1/task/a", body))
        with pytest.raises(urllib.error.HTTPError) as e:
            _open(req2)
        assert e.value.code == 401

    def test_unsigned_request_rejected(self, workers):
        req = urllib.request.Request(f"http://{workers[0].address}/v1/task/bogus", data=b"{}",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            _open(req)
        assert e.value.code == 401

    def test_no_pickle_on_the_wire(self):
        import inspect

        import trino_tpu_torch.runtime.plancodec as codec
        import trino_tpu_torch.server.worker as w

        assert "pickle" not in inspect.getsource(w)
        assert "import pickle" not in inspect.getsource(codec)

    def test_status_longpoll_and_results(self, workers, remote_dist):
        remote_dist.execute("SELECT count(*) FROM nation")
        rel = "/v1/task/nonexistent"
        req = urllib.request.Request(f"http://{workers[0].address}{rel}?maxWait=0", method="GET")
        req.add_header(SIGNATURE_HEADER, sign(SECRET, "GET", rel))
        with pytest.raises(urllib.error.HTTPError) as e:
            _open(req)
        assert e.value.code == 404


class TestFailureRecovery:
    def test_worker_death_recovers_with_query_retry(self, local):
        w1, w2 = _start(), _start()
        try:
            dist = _make_dist([w1, w2])
            dist.session.set("retry_policy", "QUERY")
            sql = "SELECT l_returnflag, count(*) FROM lineitem GROUP BY 1 ORDER BY 1"
            assert dist.execute(sql).rows == local.execute(sql).rows
            # kill one worker; the next run must fail over to the survivor
            w2.stop()
            assert dist.execute(sql).rows == local.execute(sql).rows
        finally:
            w1.stop()

    def test_task_failure_propagates_without_retry(self, workers):
        from trino_tpu_torch.runtime.failure import RetryableQueryError

        dist = _make_dist(workers)
        dist.session.set("retry_policy", "NONE")
        # a catalog the workers do not mount: a deterministic task failure,
        # a plain error and not a retryable one
        dist.catalogs.register("tpch2", TpchConnector(scale=SCALE, split_target_rows=512,
                                                      device="cpu"))
        with pytest.raises(RuntimeError) as e:
            dist.execute("SELECT count(*) FROM tpch2.sf0_0005.nation")
        assert not isinstance(e.value, RetryableQueryError)


class TestWorkerConcurrency:
    def test_concurrent_queries_one_worker_memory_capped(self, local):
        w = _start()
        try:
            agg = ("SELECT l_returnflag, count(*), sum(l_quantity) FROM lineitem "
                   "GROUP BY 1 ORDER BY 1")
            join = "SELECT count(*) FROM lineitem JOIN orders ON l_orderkey = o_orderkey"
            expected = {"agg": local.execute(agg).rows, "join": local.execute(join).rows}
            results, errors = {}, []

            def run_one(i):
                try:
                    dist = _make_dist([w], n_workers=2)
                    dist.session.set("query_max_memory_bytes", 64 << 20)
                    kind = "agg" if i % 2 == 0 else "join"
                    results[i] = (kind, dist.execute(agg if kind == "agg" else join).rows)
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append((i, repr(e)))

            threads = [threading.Thread(target=run_one, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            assert not errors, errors
            assert len(results) == 8
            for kind, rows in results.values():
                assert rows == expected[kind]
        finally:
            w.stop()


class TestFairExecutor:
    def test_short_query_not_starved_by_long_backlog(self):
        from trino_tpu_torch.server.worker import FairTaskExecutor

        ex = FairTaskExecutor(n_threads=2)
        try:
            finished = {}

            def work(q, dur):
                def fn():
                    time.sleep(dur)
                    finished[q] = time.monotonic()

                return fn

            t0 = time.monotonic()
            for i in range(14):
                ex.submit("longq", f"longq_f{i}_p0", work(f"longq{i}", 0.08))
            time.sleep(0.02)  # the long query occupies both threads
            ex.submit("shortq", "shortq_f0_p0", work("short", 0.01))
            deadline = time.monotonic() + 5
            while "short" not in finished and time.monotonic() < deadline:
                time.sleep(0.01)
            assert "short" in finished
            # FIFO would drain about 0.56 s of backlog first
            assert finished["short"] - t0 < 0.4
        finally:
            ex.stop()

    def test_scheduling_stats_surface_in_status(self):
        from trino_tpu_torch.server.worker import Task, _status_json

        t = Task("q_f0_p0")
        t.queued_at = time.monotonic() - 0.5
        t.started_at = t.queued_at + 0.2
        t.ended_at = t.started_at + 0.1
        st = json.loads(_status_json(t))
        assert 0.15 < st["queuedSecs"] < 0.25
        assert 0.05 < st["runSecs"] < 0.15

    def test_fte_tasks_ride_the_fair_pool(self):
        w = _start("fair-secret")
        try:
            dist = _make_dist([w], n_workers=1, secret="fair-secret")
            dist.session.set("retry_policy", "TASK")
            dist.session.set("distributed_sort", False)
            with pytest.raises(NotImplementedError, match="runtime.fte_scheduler"):
                dist.execute("SELECT count(*) FROM nation")
        finally:
            w.stop()


class TestLocalExchange:
    def test_colocated_pull_skips_http(self):
        w = _start("localex-secret")
        try:
            dist = _make_dist([w], n_workers=2, secret="localex-secret")
            res = dist.execute(
                "SELECT l_returnflag, count(*) FROM lineitem GROUP BY 1 ORDER BY 1")
            assert len(res.rows) == 3
            assert w.tasks.local_exchange_pages > 0
        finally:
            w.stop()


class TestExchangeStage:
    def test_hash_exchanges_take_the_fused_destination(self, workers, local):
        """Q3's and Q18's hash exchanges with more than one consumer part:
        fused roots compute the destination (folded into ``hash_expand``
        and ``segment_agg``, whose plain versions run here), every
        partitioned output goes through ``repartition_frames`` and none
        through the host branch."""
        from tests.tpch_corpus import TPCH_QUERIES
        from trino_tpu_torch.ops import megakernels as MK

        dist = _make_dist(workers)
        dist.session.set("target_partition_rows", 1)
        for w in workers:
            w.tasks.reset_stats()
        MK.reset_counts()
        for q in ("q03", "q18"):
            assert dist.execute(TPCH_QUERIES[q]).rows == local.execute(TPCH_QUERIES[q]).rows
        assert MK.STAGES["dest_expand"] + MK.STAGES["dest_aggregate"] > 0
        assert sum(w.tasks.stats["exchange_frames"] for w in workers) > 0
        assert sum(w.tasks.stats["host_branch_pages"] for w in workers) == 0

    def test_durable_output_raises_naming_its_module(self, workers):
        from trino_tpu_torch.server.worker import TaskDescriptor, encode_task

        body = encode_task(TaskDescriptor(output={"kind": "durable", "n": 1}))
        rel = "/v1/task/durable_f0_p0"
        req = urllib.request.Request(f"http://{workers[0].address}{rel}", data=body,
                                     method="POST")
        req.add_header(SIGNATURE_HEADER, sign(SECRET, "POST", rel, body))
        with pytest.raises(urllib.error.HTTPError) as e:
            _open(req)
        assert e.value.code == 400 and b"runtime.fte_plane" in e.value.read()


class TestEmitOutput:
    """``_emit_output``'s host formulation (the copy to the host, the numpy
    hash, a page per consumer) serves CPU pages only, here with the device
    repartition switched off, and sends every row where the device
    formulation sends it. A page on the card with a nested column raises,
    naming what is not ported."""

    DESC_OUTPUT = {"kind": "partitioned", "n": 3, "keys": ["k", "s"],
                   "symbols": ["k", "s", "x"]}

    @staticmethod
    def _page(nested=False):
        from trino_tpu_torch.spi.page import Column, Page
        from trino_tpu_torch.spi.types import BIGINT, DOUBLE, ArrayType, varchar_type

        n = 40
        rng = np.random.default_rng(13)
        keys = Column.from_numpy(BIGINT, rng.integers(-50, 50, n), rng.random(n) < 0.9,
                                 device="cpu")
        strs = Column.from_strings([None if i % 7 == 0 else f"s{i % 5}" for i in range(n)],
                                   varchar_type(), device="cpu")
        if nested:
            third = Column.from_nested(ArrayType(element=BIGINT),
                                       [[i, -i] if i % 5 else None for i in range(n)],
                                       device="cpu")
        else:
            third = Column.from_numpy(DOUBLE, rng.normal(size=n), device="cpu")
        return Page((keys, strs, third), torch.from_numpy(rng.random(n) < 0.8))

    def _emit(self, page):
        from trino_tpu_torch.metadata import Metadata
        from trino_tpu_torch.runtime.serde import deserialize_page
        from trino_tpu_torch.server.worker import (
            OutputBuffer,
            Task,
            TaskDescriptor,
            TaskManager,
        )

        tasks = TaskManager(Metadata(CatalogManager()), None, task_threads=1, device="cpu")
        try:
            task = Task("emit_f0_p0", buffer=OutputBuffer(3))
            tasks._emit_output(task, TaskDescriptor(output=dict(self.DESC_OUTPUT)), page)
        finally:
            tasks.executor.stop()
        rows = []
        for b in range(3):
            blobs, _, _ = task.buffer.get(b, 0, max_wait=0)
            rows.append(sorted(
                (r for blob in blobs for r in deserialize_page(blob, device="cpu").to_pylist()),
                key=repr))
        return dict(tasks.stats), rows

    def test_host_branch_serves_cpu_pages(self, monkeypatch):
        from trino_tpu_torch.ops.repartition import DEVICE_REPARTITION_ENV
        from trino_tpu_torch.spi.host_pages import host_partition_targets, page_to_host

        page = self._page()
        device_stats, device_rows = self._emit(page)
        assert device_stats["exchange_frames"] == 3 and device_stats["host_branch_pages"] == 0
        monkeypatch.setenv(DEVICE_REPARTITION_ENV, "0")
        host_stats, host_rows = self._emit(page)
        assert host_stats["host_branch_pages"] == 1 and host_stats["exchange_frames"] == 0
        target = host_partition_targets(page_to_host(page), [0, 1], 3)
        want = [sorted((r for r, t in zip(page.to_pylist(), target) if t == b), key=repr)
                for b in range(3)]
        assert host_rows == want == device_rows

    def test_nested_page_on_the_card_raises(self):
        page = self._page(nested=True)

        class OnCard:
            """The page as a CUDA page shows itself to ``_emit_output``
            (its columns, its device); no tensor is touched before the
            refusal."""

            columns = page.columns
            device = torch.device("cuda")

        with pytest.raises(NotImplementedError,
                           match=r"ops\.repartition \(nested layouts on the device epilogue\)"):
            self._emit(OnCard())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default without a card")
def test_entry_points_default_to_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedQueryRunner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedQueryRunner.tpch(scale=0.01)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkerServer(CatalogManager())
