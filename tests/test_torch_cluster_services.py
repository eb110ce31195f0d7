"""The cluster services that the port's distributed tier carries, armed as
the reference's tests arm them, at ``device="cpu"``:

- the ``task_crash_mid_execute`` chaos site in ``run_fragment_partition``:
  a query retry (``retry_policy=QUERY``) recovers the rows, no retry
  policy fails the query, a USER-category crash is never retried. The
  staged tier of both packages goes through the same cases (the reference
  with ``use_ici_exchange`` false, so that it runs staged under the tests'
  host devices). On the port's HTTP workers the crash fails the query
  fast, as the reference's remote tier does;
- the memory pool: ``default_pool`` sized by
  ``TRINO_TPU_MEMORY_POOL_BYTES`` and handed to the worker, the blocking
  budget (woken by a peer's free, or timing out after
  ``TRINO_TPU_MEMORY_RESERVE_TIMEOUT`` seconds), revocable reservations
  that never block, and the staged tier's parked stage outputs counted in
  the pool of the current ``memory_scope`` (``tests/test_memory_arbitration.py``'s
  pool cases, replayed);
- topology placement (``worker_locations`` with ``coordinator_location``):
  ``tests/test_runtime_services.py``'s near-worker and capacity cases,
  replayed through the port's ``WorkerServer``s.

Every fixture stops its servers in a ``finally``.
"""

import threading
import time

import pytest

from trino_tpu.parallel.runner import DistributedQueryRunner as RefDistributed
from trino_tpu.runtime import LocalQueryRunner as RefLocal
from trino_tpu.runtime.failure import ChaosInjector as RefChaos
from trino_tpu.runtime.failure import InjectedFailure as RefInjectedFailure

from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.metadata import CatalogManager, Session
from trino_tpu_torch.parallel.runner import DistributedQueryRunner
from trino_tpu_torch.runtime import memory as M
from trino_tpu_torch.runtime.failure import ChaosInjector, InjectedFailure
from trino_tpu_torch.server.worker import WorkerServer

SCALE = 0.0005
SQL = ("SELECT l_returnflag, l_linestatus, count(*), sum(l_quantity) FROM lineitem "
       "GROUP BY 1, 2 ORDER BY 1, 2")
SITE = "task_crash_mid_execute"


@pytest.fixture(scope="module")
def expected():
    return RefLocal.tpch(scale=SCALE).execute(SQL).rows


def _with_policy(package: str, policy: str):
    """A staged runner of ``package`` with ``retry_policy``, its chaos
    harness and its injected-failure type."""
    if package == "reference":
        runner = RefDistributed.tpch(scale=SCALE, n_workers=2)
        runner.session.set("use_ici_exchange", False)
        harness = (RefChaos, RefInjectedFailure)
    else:
        runner = DistributedQueryRunner.tpch(scale=SCALE, n_workers=2, device="cpu")
        harness = (ChaosInjector, InjectedFailure)
    runner.session.set("retry_policy", policy)
    return (runner, *harness)


def _catalogs():
    c = CatalogManager()
    c.register("tpch", TpchConnector(scale=SCALE, split_target_rows=512, device="cpu"))
    return c


def _remote(workers, secret, **kw):
    dist = DistributedQueryRunner(
        Session(catalog="tpch", schema="sf0_0005"), n_workers=2,
        worker_urls=[f"http://{w.address}" for w in workers], secret=secret, device="cpu", **kw)
    dist.catalogs.register("tpch", TpchConnector(scale=SCALE, split_target_rows=512,
                                                 device="cpu"))
    return dist


class TestTaskCrashMidExecute:
    @pytest.mark.parametrize("package", ["reference", "port"])
    def test_query_retry_recovers(self, package, expected):
        runner, chaos_type, _ = _with_policy(package, "QUERY")
        with chaos_type() as chaos:
            chaos.arm(SITE, times=1)
            rows = runner.execute(SQL).rows
        assert chaos.fired == {SITE: 1}
        assert rows == expected

    @pytest.mark.parametrize("package", ["reference", "port"])
    def test_without_retry_the_query_fails(self, package):
        runner, chaos_type, failure = _with_policy(package, "NONE")
        with chaos_type() as chaos:
            chaos.arm(SITE, times=1)
            with pytest.raises(failure, match="injected crash mid-execute"):
                runner.execute(SQL)
        assert chaos.fired == {SITE: 1}

    @pytest.mark.parametrize("package", ["reference", "port"])
    def test_user_category_is_never_retried(self, package):
        runner, chaos_type, failure = _with_policy(package, "QUERY")
        with chaos_type() as chaos:
            chaos.arm(SITE, times=2, category="USER")
            with pytest.raises(failure, match=r"\[category=USER\]"):
                runner.execute(SQL)
        assert chaos.fired == {SITE: 1}

    def test_http_workers_fail_fast_then_serve(self, expected):
        """On the remote tier a task's crash reaches the coordinator as a
        worker-reported failure, and only transport failures retry (as in
        the reference's ``_execute_remote_streaming``): the query fails
        once, naming the crash, and the same workers then serve it."""
        secret = "chaos-secret"
        workers = [WorkerServer(_catalogs(), secret=secret, device="cpu").start()
                   for _ in range(2)]
        try:
            dist = _remote(workers, secret)
            dist.session.set("retry_policy", "QUERY")
            with ChaosInjector() as chaos:
                chaos.arm(SITE, times=1)
                with pytest.raises(RuntimeError, match="InjectedFailure: injected crash"):
                    dist.execute(SQL)
            assert chaos.fired == {SITE: 1}
            assert dist.execute(SQL).rows == expected
        finally:
            for w in workers:
                w.stop()


class TestMemoryPool:
    def test_default_pool_sized_by_env_reaches_the_worker(self, monkeypatch):
        monkeypatch.setattr(M, "_default_pool", None)
        monkeypatch.setattr(M, "_default_pool_init", False)
        monkeypatch.setenv(M.POOL_BYTES_ENV, "64MB")
        pool = M.default_pool()
        assert pool is not None and pool.max_bytes == 64 << 20
        assert M.default_pool() is pool
        w = WorkerServer(_catalogs(), device="cpu")
        try:
            assert w.tasks.memory_pool is pool
            assert w.tasks.memory_info()["maxBytes"] == 64 << 20
        finally:
            w.tasks.executor.stop()

    def test_unset_env_means_no_pool(self, monkeypatch):
        monkeypatch.setattr(M, "_default_pool", None)
        monkeypatch.setattr(M, "_default_pool_init", False)
        monkeypatch.delenv(M.POOL_BYTES_ENV, raising=False)
        assert M.default_pool() is None

    def test_blocking_reserve_unblocks_on_peer_free(self):
        pool = M.MemoryPool(1000, name="b", reserve_timeout=10)
        pool.reserve("qa", 800)
        granted = threading.Event()

        def blocked():
            pool.reserve("qb", 600)  # blocks: 800 + 600 > 1000
            granted.set()

        t = threading.Thread(target=blocked)
        t.start()
        time.sleep(0.1)
        assert not granted.is_set()
        assert pool.blocked_total == 1
        pool.reserve("qa", -700)  # the peer releases
        assert granted.wait(5)
        t.join(5)
        assert pool.memory_announcement()["reservedBytes"] == 100 + 600

    def test_blocking_reserve_times_out(self, monkeypatch):
        monkeypatch.setenv(M.RESERVE_TIMEOUT_ENV, "0.2")
        pool = M.MemoryPool(100, name="t")
        assert pool.reserve_timeout == 0.2
        pool.reserve("qa", 100)
        t0 = time.monotonic()
        with pytest.raises(M.ExceededMemoryLimitError, match="full"):
            pool.reserve("qb", 50)
        assert time.monotonic() - t0 >= 0.15
        assert pool.memory_announcement()["reservedBytes"] == 100  # nothing booked for qb

    def test_revocable_never_blocks(self):
        pool = M.MemoryPool(100, name="r", reserve_timeout=10)
        pool.reserve("qa", 90)
        t0 = time.monotonic()
        pool.reserve("qa", 500, revocable=True)  # overcommits, returns at once
        assert time.monotonic() - t0 < 1
        assert pool.memory_announcement()["reservedBytes"] == 590

    def test_free_owner_sweeps_everything(self):
        pool = M.MemoryPool(0, name="s")
        pool.reserve("qa", 100)
        pool.reserve("qa", 50, revocable=True)
        assert pool.free_owner("qa") == 150
        assert pool.memory_announcement()["reservedBytes"] == 0

    def test_staged_outputs_count_in_the_scope_pool(self, expected):
        runner = DistributedQueryRunner.tpch(scale=SCALE, n_workers=2, device="cpu")
        pool = M.MemoryPool(0, name="probe")
        with M.memory_scope("q", pool):
            rows = runner.execute(SQL).rows
        assert rows == expected
        assert pool.peak_bytes > 0  # the parked stage outputs, from their tensors
        assert pool.memory_announcement()["reservedBytes"] == 0  # closed with the query


class TestTopologyPlacement:
    """``tests/test_runtime_services.py``'s placement cases on the port."""

    SECRET = "topo-secret"

    def _pair(self):
        return [WorkerServer(_catalogs(), secret=self.SECRET, device="cpu").start()
                for _ in range(2)]

    def test_streaming_tier_prefers_near_workers(self):
        near, far = self._pair()
        try:
            urls = [f"http://{far.address}", f"http://{near.address}"]
            dist = _remote([far, near], self.SECRET,
                           worker_locations={urls[0]: "r2/rk9/h9", urls[1]: "r1/rk1/h2"},
                           coordinator_location="r1/rk1/h1")
            assert dist.execute("SELECT count(*) FROM nation").rows == [(25,)]
            # every task landed on the near worker; the far one saw none
            assert near.tasks.count() > 0
            assert far.tasks.count() == 0
        finally:
            near.stop()
            far.stop()

    def test_capacity_spills_to_far_tier(self):
        near, far = self._pair()
        try:
            urls = [f"http://{near.address}", f"http://{far.address}"]
            dist = _remote([near, far], self.SECRET,
                           worker_locations={urls[0]: "r1/rk1/h2", urls[1]: "r2/rk9/h9"},
                           coordinator_location="r1/rk1/h1")
            dist.session.set("max_tasks_per_worker", 1)
            res = dist.execute(
                "SELECT l_returnflag, count(*) FROM lineitem GROUP BY 1 ORDER BY 1")
            assert len(res.rows) == 3
            counts = dist.last_placement.counts
            # the near worker filled to its capacity target, the overflow
            # spilled to the far tier
            assert counts[urls[0]] >= 1
            assert counts[urls[1]] >= 1
        finally:
            near.stop()
            far.stop()
