"""Shared by ``tests/test_torch_distributed.py`` and
``tests/test_torch_distributed_2.py``: TPC-H SF0.01 through both packages'
``DistributedQueryRunner`` (staged), the port's HTTP workers, and the port's
``LocalQueryRunner``.

Both distributed runners get one session: ``target_partition_rows`` 100,
so that the hash fragments of SF0.01 run on more than one partition, and
``use_ici_exchange`` false. Under the tests' eight host devices the
reference would otherwise take its single-program ICI tier (``last_tier ==
"ici"``), which records no partition counts; the port has no such tier and
runs staged on either setting. The tests compare rows and partition
counts, never the tier's name.
"""

import threading

import pytest

from trino_tpu.parallel.runner import DistributedQueryRunner as RefDistributed

from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.metadata import CatalogManager, Session
from trino_tpu_torch.parallel.runner import DistributedQueryRunner
from trino_tpu_torch.runtime import LocalQueryRunner
from trino_tpu_torch.server.worker import WorkerServer

SCALE = 0.01
SECRET = "distributed-test-secret"
SESSION = {"target_partition_rows": 100, "use_ici_exchange": False}
REL_TOL = 1e-9


def same_rows(got, want) -> bool:
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for a, b in zip(rg, rw):
            if isinstance(b, float) and isinstance(a, float):
                if not (a == b or abs(a - b) <= REL_TOL * max(1.0, abs(b))):
                    return False
            elif a != b:
                return False
    return True


class Runs:
    """Module-wide runners and the reference's rows and partition counts,
    one reference run per (query, n_workers)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ref = {}
        self._ref_rows = {}
        self.local = LocalQueryRunner.tpch(scale=SCALE, device="cpu")
        self.port = {}

    def reference(self, sql: str, n_workers: int):
        with self._lock:
            key = (sql, n_workers)
            if key not in self._ref_rows:
                r = self._ref.get(n_workers)
                if r is None:
                    r = self._ref[n_workers] = RefDistributed.tpch(scale=SCALE, n_workers=n_workers)
                    for k, v in SESSION.items():
                        r.session.set(k, v)
                rows = r.execute(sql).rows
                self._ref_rows[key] = (rows, dict(r.last_partition_counts), r.last_tier)
            return self._ref_rows[key]

    def staged(self, n_workers: int, fusion: bool) -> DistributedQueryRunner:
        key = (n_workers, fusion)
        if key not in self.port:
            d = DistributedQueryRunner.tpch(scale=SCALE, n_workers=n_workers, device="cpu")
            for k, v in SESSION.items():
                d.session.set(k, v)
            d.session.set("pallas_fusion", fusion)
            self.port[key] = d
        return self.port[key]


def worker_catalogs():
    c = CatalogManager()
    c.register("tpch", TpchConnector(scale=SCALE, split_target_rows=4096, device="cpu"))
    return c


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.fixture(scope="module")
def workers():
    ws = [WorkerServer(worker_catalogs(), secret=SECRET, device="cpu").start() for _ in range(2)]
    yield ws
    for w in ws:
        w.stop()


def remote_runner(workers, fusion: bool) -> DistributedQueryRunner:
    d = DistributedQueryRunner(
        Session(catalog="tpch", schema="sf0_01"), n_workers=4,
        worker_urls=[f"http://{w.address}" for w in workers], secret=SECRET, device="cpu")
    d.register_catalog("tpch", TpchConnector(scale=SCALE, split_target_rows=4096, device="cpu"))
    for k, v in SESSION.items():
        d.session.set(k, v)
    d.session.set("pallas_fusion", fusion)
    return d


def check_staged(runs, sql: str, n_workers: int, fusion: bool) -> None:
    want, want_counts, _tier = runs.reference(sql, n_workers)
    d = runs.staged(n_workers, fusion)
    got = d.execute(sql).rows
    assert d.last_tier == "staged" and "parallel.mesh_runner" in d.last_tier_reason
    assert same_rows(got, want), (got[:3], want[:3])
    assert same_rows(runs.local.execute(sql).rows, got)
    assert d.last_partition_counts == want_counts


def check_remote(runs, workers, sql: str, fusion: bool) -> None:
    want, _, _ = runs.reference(sql, 4)
    d = remote_runner(workers, fusion)
    got = d.execute(sql).rows
    assert d.last_tier == "remote"
    assert same_rows(got, want), (got[:3], want[:3])
