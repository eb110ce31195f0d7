"""DistributedQueryRunner: multi-worker, stage-by-stage fragment execution.

The port's counterpart of ``trino_tpu.parallel.runner`` (ref: the
coordinator scheduling loop of SURVEY.md §3.1, PipelinedQueryScheduler.java:163,
SourcePartitionedScheduler, and the §3.3 exchange data plane). A query is
planned, given exchanges, cut into fragments and run on ``n_workers``
logical workers, two ways:

- **staged** (no ``worker_urls``): each fragment runs once per partition in
  this process, children first; a stage's outputs are gathered, broadcast,
  hash-repartitioned (``host_partition_targets``) or range-repartitioned
  (``host_range_targets``) through host chunks before the consumer stage
  runs. ``exchange_compression`` sends every exchanged page through the
  wire serde. Parked stage outputs spill past
  ``exchange_spill_trigger_bytes``.
- **remote** (``worker_urls``): every fragment's tasks are posted to
  ``server.worker.WorkerServer``s at once and pull their inputs worker to
  worker (``_execute_remote_streaming``); a task whose output feeds a hash
  exchange runs the exchange destination stage in its fused join or
  aggregation and cuts its frames with ``partition_epilogue``.

Pages live on the runner's ``device`` (default ``cuda``, which raises where
no card is visible). ``retry_policy=QUERY`` re-runs a failed query on the
live workers (``runtime.failure.execute_with_retry``).

Not ported, each raising by its module's name when a session asks for it:
``retry_policy=TASK`` (``runtime.fte_scheduler``), ``ha_plane``
(``runtime.ha``), ``fragment_cache`` (``runtime.cachestore``),
``cluster_obs`` (``runtime.clusterobs``) and ``device_batching``
(``runtime.device_scheduler``). The single-program ICI tier
(``parallel.mesh_runner``) is not ported either: every query takes the
staged tier and says so in ``last_tier_reason``. Statistics feedback is
left out, as in the port's ``LocalQueryRunner``: it is advisory and changes
no row.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import knobs
from .._unported import unported
from ..device import resolve_device
from ..metadata import CatalogManager, Metadata, Session
from ..planner import LogicalPlanner, optimize
from ..planner.fragmenter import (
    ExchangeType,
    Partitioning,
    PlanFragment,
    RemoteSourceNode,
    SubPlan,
    add_exchanges,
    create_fragments,
    remote_sources,
)
from ..planner.plan import LogicalPlan, OutputNode, PlanNode, TableScanNode, visit_plan
from ..runtime.executor import PlanExecutor, Relation, _concat_pages
from ..runtime.local import QueryResult
from ..runtime.tracing import TRACER
from ..spi.host_pages import (
    empty_page_for,
    host_order_key,
    host_partition_targets,
    page_from_host_chunks,
    page_to_host,
)
from ..spi.page import Page
from ..sql import parse_statement

_INT64_MIN = np.int64(np.iinfo(np.int64).min)
_INT64_MAX = np.int64(np.iinfo(np.int64).max)


def host_range_targets(chunk_cols: List[List], rs: RemoteSourceNode, n: int) -> List[np.ndarray]:
    """Row -> consumer partition by sort-order range, per producer chunk
    (the distributed sort's shuffle). Boundaries are quantile cuts of the
    encoded first sort key across all producers, and equal keys always
    share a target (searchsorted over value cuts): the parent GATHER
    concatenates locally sorted parts in part order."""
    o = rs.orderings[0]
    ki = list(rs.symbols).index(o.symbol)
    real = [c[ki][3] for c in chunk_cols if c[ki][3] is not None]
    remap = None
    if real and len({d.fingerprint() for d in real}) > 1:
        # codes are local to a dictionary: re-encode into one merged sorted
        # vocabulary so that code order is value order across producers
        merged_values = sorted(set().union(*[list(d.values) for d in real]))
        code_of = {s: c for c, s in enumerate(merged_values)}
        remap = {id(d): np.array([code_of[s] for s in d.values], dtype=np.int64) for d in real}
    keys: List[np.ndarray] = []
    for cols in chunk_cols:
        _, data, valid, dictionary = cols[ki]
        if dictionary is not None and remap is not None:
            lut = remap[id(dictionary)]
            data = lut[np.clip(data, 0, len(lut) - 1)]
        k = host_order_key(np.asarray(data))
        if not o.ascending:
            k = ~k
        keys.append(np.where(np.asarray(valid), k,
                             _INT64_MIN if o.nulls_first else _INT64_MAX))
    all_keys = np.concatenate(keys) if keys else np.zeros(0, dtype=np.int64)
    if len(all_keys) == 0:
        return [np.zeros(len(k), dtype=np.int64) for k in keys]
    sk = np.sort(all_keys)
    cuts = sk[[(len(sk) * (i + 1)) // n for i in range(n - 1)]]
    return [np.searchsorted(cuts, k, side="right") for k in keys]


def _worker_alive(url: str, secret) -> bool:
    """Whether the worker at ``url`` answers (a 404 for an unknown task is
    an answer)."""
    import urllib.error
    import urllib.request

    from ..server.worker import SIGNATURE_HEADER, sign

    rel = "/v1/task/__probe__"
    req = urllib.request.Request(f"{url.rstrip('/')}{rel}", method="GET")
    req.add_header(SIGNATURE_HEADER, sign(secret, "GET", rel))
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            resp.read()
        return True
    except urllib.error.HTTPError:
        return True
    except OSError:
        return False


def scan_sources(metadata, node: TableScanNode):
    """The scan set-up rule (constraint absorption, split enumeration,
    column projection) every tier that reads a TableScanNode shares.
    Returns (splits, col_indexes, page_source_provider)."""
    connector = metadata.connector_for(node.table)
    handle = node.table
    if node.constraint.domains:
        absorbed = metadata.apply_filter(handle, node.constraint)
        if absorbed is not None:
            handle = absorbed
    splits = connector.split_manager().get_splits(handle)
    meta = metadata.get_table_metadata(node.table)
    col_indexes = [meta.column_index(c) for _, c in node.assignments]
    return splits, col_indexes, connector.page_source_provider()


def run_fragment_partition(executor: "_FragmentExecutor", root: PlanNode) -> Page:
    """One fragment for one partition -> its output Page (shared by the
    staged scheduler, the out-of-core tier and the worker task API)."""
    from ..runtime.failure import InjectedFailure, chaos_category, chaos_fire

    # chaos site: a task dying with its output uncommitted, on any path
    act = chaos_fire("task_crash_mid_execute", text=type(root).__name__)
    if act is not None:
        raise InjectedFailure("injected crash mid-execute", category=chaos_category(act))
    if isinstance(root, OutputNode):
        _, page = executor.execute()
        return page
    rel = executor.eval(root)
    out = Page(tuple(rel.column_for(s) for s in root.output_symbols), rel.page.active)
    if "_megakernel_epilogue" in rel.page.__dict__:
        # a fused root computed the exchange destination as its last stage:
        # carry it across the output-symbol rewrap
        from ..ops.megakernels import reattach_epilogue

        reattach_epilogue(rel.page, out, root.output_symbols)
    return out


class _FragmentExecutor(PlanExecutor):
    """Executes one fragment for one partition: remote sources read staged
    pages; table scans take this partition's splits (round-robin)."""

    def __init__(self, plan: LogicalPlan, metadata: Metadata, session: Session,
                 staged: Dict[int, List[Page]], partition: int, n_workers: int,
                 device=None):
        super().__init__(plan, metadata, session, device)
        self.staged = staged
        self.partition = partition
        self.n_workers = n_workers

    def _exec_RemoteSourceNode(self, node: RemoteSourceNode) -> Relation:
        pages = self.staged[node.fragment_id]
        page = pages[self.partition] if self.partition < len(pages) else pages[0]
        return Relation(page, node.symbols)

    def _exec_TableScanNode(self, node: TableScanNode) -> Relation:
        splits, col_indexes, provider = scan_sources(self.metadata, node)
        splits = [s for i, s in enumerate(splits) if i % self.n_workers == self.partition]
        symbols = tuple(s for s, _ in node.assignments)
        if not splits:
            # the storage layouts (long decimals' lanes, the sentinel
            # dictionaries) of a partition that drew no split
            device = self.metadata.connector_for(node.table).device
            page = empty_page_for(symbols, {s: self.types[s] for s in symbols}, device)
            return Relation(page, symbols)
        pages = [provider.create_page_source(sp, col_indexes) for sp in splits]
        return Relation(_concat_pages(pages), symbols)


def _session_flag(session: Session, name: str) -> bool:
    try:
        return bool(session.get(name))
    except KeyError:
        return False


class DistributedQueryRunner:
    """Multi-worker engine (the DistributedQueryRunner.java:108 analogue: a
    whole multi-stage cluster in one process, or a coordinator over remote
    workers)."""

    def __init__(
        self,
        session: Optional[Session] = None,
        n_workers: int = 4,
        worker_urls: Optional[List[str]] = None,
        secret: Optional[str] = None,
        worker_locations: Optional[Dict[str, str]] = None,
        coordinator_location: str = "",
        node_registry=None,
        device=None,
    ):
        """``worker_urls``: tasks go to remote ``WorkerServer``s over the
        /v1/task HTTP API instead of running here; workers mount the same
        catalogs. ``secret``: the shared HMAC secret of internal requests
        (default ``$TRINO_TPU_INTERNAL_SECRET``). ``worker_locations`` (url
        -> "region/rack/host") with ``coordinator_location`` turn on
        nearest-first placement with ``max_tasks_per_worker`` capacity;
        ``node_registry`` overlays announced locations. ``device``: where
        this process's pages live (default ``cuda``)."""
        self.device = resolve_device(device)
        self.catalogs = CatalogManager()
        self.metadata = Metadata(self.catalogs)
        self.session = session or Session()
        self.n_workers = n_workers
        self.worker_urls = worker_urls
        self.worker_locations = worker_locations or {}
        self.coordinator_location = coordinator_location
        self.node_registry = node_registry
        self.secret = secret if secret is not None else knobs.env_str("TRINO_TPU_INTERNAL_SECRET")
        # which tier ran the last query, and why not the ICI tier
        self.last_tier: Optional[str] = None
        self.last_tier_reason: Optional[str] = None
        self.last_partition_counts: Dict[int, int] = {}
        self.last_spiller = None
        self.last_placement = None

    @staticmethod
    def tpch(scale: float = 0.01, n_workers: int = 4, split_target_rows: int = 4096,
             device=None) -> "DistributedQueryRunner":
        """Runner with the tpch catalog mounted, its pages on ``device``."""
        from ..connectors.tpch import TpchConnector

        runner = DistributedQueryRunner(
            Session(catalog="tpch", schema="sf" + f"{scale:g}".replace(".", "_")), n_workers,
            device=device,
        )
        runner.catalogs.register("tpch", TpchConnector(
            scale=scale, split_target_rows=split_target_rows, device=runner.device))
        return runner

    def register_catalog(self, name: str, connector) -> None:
        self.catalogs.register(name, connector)

    def plan_distributed(self, sql: str) -> SubPlan:
        from ..planner.fragmenter import determine_partition_counts

        stmt = parse_statement(sql)
        plan = LogicalPlanner(self.metadata, self.session).plan(stmt)
        plan = optimize(plan, self.metadata, self.session)
        plan = add_exchanges(plan, self.metadata, self.session)
        subplan = create_fragments(plan)
        return determine_partition_counts(subplan, self.metadata, self.session, self.n_workers)

    def execute(self, sql: str) -> QueryResult:
        from ..runtime.failure import execute_with_retry

        return execute_with_retry(
            self._execute_once, sql, retry_policy=str(self.session.get("retry_policy")))

    def _refuse_unported_planes(self) -> None:
        if str(self.session.get("retry_policy")) == "TASK":
            unported("runtime.fte_scheduler (retry_policy=TASK)")
        for flag, module in (("ha_plane", "runtime.ha"),
                             ("fragment_cache", "runtime.cachestore"),
                             ("cluster_obs", "runtime.clusterobs"),
                             ("device_batching", "runtime.device_scheduler")):
            if _session_flag(self.session, flag):
                unported(f"{module} ({flag}=true)")

    def _execute_once(self, sql: str) -> QueryResult:
        self._refuse_unported_planes()
        subplan = self.plan_distributed(sql)
        self.last_partition_counts = {}
        if self.worker_urls:
            # every stage's tasks dispatch at once and pull their inputs
            # from the producers' output buffers
            self.last_tier, self.last_tier_reason = "remote", None
            return self._execute_remote_streaming(subplan)
        self.last_tier = "staged"
        self.last_tier_reason = (
            "parallel.mesh_runner (the single-program ICI tier) is not ported to "
            f"trino_tpu_torch yet; {torch.cuda.device_count()} CUDA devices for "
            f"{self.n_workers} workers"
        )
        return self._execute_staged(subplan)

    def _execute_staged(self, subplan: SubPlan) -> QueryResult:
        from ..runtime.memory import page_bytes, query_memory_context
        from ..runtime.spiller import Spiller

        spiller = Spiller(int(self.session.get("exchange_spill_trigger_bytes") or 0))
        self.last_spiller = spiller
        # parked stage outputs are revocable memory of the current scope's
        # pool, counted from their tensors
        memory = query_memory_context(tag="exchange")
        parked = memory.new_local("staged", revocable=True)
        staged: Dict[int, List[object]] = {}
        root_id = subplan.root_fragment.fragment_id
        try:
            for frag in subplan.fragments:
                pages = self._execute_fragment(subplan, frag, staged)
                staged[frag.fragment_id] = (
                    pages if frag.fragment_id == root_id else spiller.maybe_spill(pages))
                parked.set_bytes(sum(page_bytes(p) for v in staged.values() for p in v
                                     if isinstance(p, Page)))
            final_pages = staged[root_id]
            assert len(final_pages) == 1
            root = subplan.root_fragment.root
            assert isinstance(root, OutputNode)
            return QueryResult(list(root.column_names), final_pages[0].to_pylist(),
                               [c.type for c in final_pages[0].columns])
        finally:
            memory.close()

    # ------------------------------------------------------------------ staged

    def _parts_for(self, frag: PlanFragment) -> int:
        """Fragment width: SINGLE runs one part; the others take the
        stats-derived count (DeterminePartitionCount.java:88) capped by the
        worker count."""
        if frag.partitioning == Partitioning.SINGLE:
            return 1
        if frag.partition_count is not None:
            return max(1, min(self.n_workers, frag.partition_count))
        return self.n_workers

    def _execute_fragment(self, subplan: SubPlan, frag: PlanFragment, staged) -> List[Page]:
        from ..runtime.spiller import Spiller

        n_parts = self._parts_for(frag)
        self.last_partition_counts[frag.fragment_id] = n_parts
        exchanged: Dict[int, List[Page]] = {}
        for rs in remote_sources(frag.root):
            producer = [Spiller.load(e, device=self.device) for e in staged[rs.fragment_id]]
            pages = self._run_exchange(rs, producer, n_parts, subplan)
            if self.session.get("exchange_compression"):
                # cross the wire: serialize, LZ4, deserialize
                from ..runtime.serde import deserialize_page, serialize_page

                pages = [deserialize_page(serialize_page(p), device=self.device) for p in pages]
            exchanged[rs.fragment_id] = pages
        plan = LogicalPlan(frag.root, subplan.types)
        return [
            run_fragment_partition(
                _FragmentExecutor(plan, self.metadata, self.session, exchanged, p, n_parts,
                                  self.device),
                frag.root)
            for p in range(n_parts)
        ]

    def _run_exchange(self, rs: RemoteSourceNode, producer_pages: List[Page],
                      n_consumer_parts: int, subplan: SubPlan) -> List[Page]:
        """The staged tier's exchange through host chunks: gather,
        broadcast, hash repartition or range repartition of the producers'
        outputs."""
        if rs.exchange_type == ExchangeType.GATHER:
            return [self._merge_host(producer_pages)]
        if rs.exchange_type == ExchangeType.BROADCAST:
            merged = self._merge_host(producer_pages)
            return [merged for _ in range(n_consumer_parts)]
        host_parts: List[List] = [[] for _ in range(n_consumer_parts)]
        chunk_cols = [page_to_host(page) for page in producer_pages]
        chunk_cols = [c for c in chunk_cols if c and len(c[0][1])]
        if rs.exchange_type == ExchangeType.REPARTITION_RANGE:
            targets = host_range_targets(chunk_cols, rs, n_consumer_parts)
        else:
            key_idx = [rs.symbols.index(k) for k in rs.partition_keys]
            targets = [host_partition_targets(cols, key_idx, n_consumer_parts)
                       for cols in chunk_cols]
        for cols, target in zip(chunk_cols, targets):
            for part in range(n_consumer_parts):
                sel = target == part
                if sel.any():
                    host_parts[part].append([(c[0], c[1][sel], c[2][sel], c[3]) for c in cols])
        return [self._build_page(host_parts[part], rs, subplan)
                for part in range(n_consumer_parts)]

    def _merge_host(self, pages: List[Page]) -> Page:
        chunks = [page_to_host(p) for p in pages]
        chunks = [c for c in chunks if len(c) == 0 or len(c[0][1]) > 0] or chunks[:1]
        return page_from_host_chunks(chunks, device=self.device)

    def _build_page(self, chunk_list, rs: RemoteSourceNode, subplan: SubPlan) -> Page:
        if not chunk_list:
            return empty_page_for(rs.symbols, {s: subplan.types[s] for s in rs.symbols},
                                  self.device)
        return page_from_host_chunks(chunk_list, device=self.device)

    # ------------------------------------------------------------------ remote

    def _execute_remote_streaming(self, subplan: SubPlan) -> QueryResult:
        """Pipelined scheduler: every fragment's tasks are created up front
        and pull their inputs worker to worker with token-acked page
        streams, so stages overlap (ref: PipelinedQueryScheduler.java:163,
        HttpRemoteTask, DirectExchangeClient)."""
        import urllib.error
        import urllib.request
        import uuid

        from ..runtime.failure import RetryableQueryError
        from ..runtime.nodes import TopologyPlacement
        from ..runtime.serde import deserialize_page
        from ..server.worker import (
            SIGNATURE_HEADER,
            TaskDescriptor,
            TaskFailedError,
            encode_task,
            pull_buffer,
            sign,
        )

        secret = self.secret
        query_id = uuid.uuid4().hex[:12]
        frag_by_id = {f.fragment_id: f for f in subplan.fragments}
        root_id = subplan.root_fragment.fragment_id

        # after a failed attempt, re-probe the workers so that the query
        # retry lands only on live ones
        live_urls = list(self.worker_urls)
        if getattr(self, "_probe_workers_next", False):
            live_urls = [u for u in self.worker_urls if _worker_alive(u, secret)]
            self._probe_workers_next = False
            if not live_urls:
                raise RuntimeError("no live workers")

        def parts_of(frag: PlanFragment) -> int:
            # FIXED_RANGE stays single-part here: workers partition their
            # own outputs and cannot agree on range cuts without a barrier
            if frag.partitioning in (Partitioning.SINGLE, Partitioning.FIXED_RANGE):
                return 1
            return self._parts_for(frag)

        consumer_of: Dict[int, Tuple[RemoteSourceNode, int]] = {}
        for frag in subplan.fragments:
            for rs in remote_sources(frag.root):
                consumer_of[rs.fragment_id] = (rs, parts_of(frag))

        def task_id(fid: int, p: int) -> str:
            return f"{query_id}_f{fid}_p{p}"

        effective_locations = dict(self.worker_locations)
        if self.node_registry is not None:
            for n in self.node_registry.all_nodes():
                if n.location and not n.coordinator:
                    effective_locations[n.uri] = n.location
        cap = int(self.session.get("max_tasks_per_worker") or 0)
        placer = None
        if effective_locations and self.coordinator_location:
            placer = TopologyPlacement(self.coordinator_location, live_urls,
                                       effective_locations, cap)
        self.last_placement = placer

        def url_for(fid: int, p: int) -> str:
            if placer is not None:
                return placer.assign((fid, p)).rstrip("/")
            return live_urls[(fid * 31 + p) % len(live_urls)].rstrip("/")

        def post_task(url: str, tid: str, desc: TaskDescriptor) -> None:
            body = encode_task(desc)
            rel = f"/v1/task/{tid}"
            req = urllib.request.Request(f"{url}{rel}", data=body, method="POST")
            req.add_header(SIGNATURE_HEADER, sign(secret, "POST", rel, body))
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    resp.read()
            except urllib.error.HTTPError as e:
                # a definitive rejection (signature, plan): no retry helps
                raise RuntimeError(
                    f"worker {url} rejected task: {e.code} {e.read()[:200]!r}") from e
            except OSError as e:
                self._probe_workers_next = True
                raise RetryableQueryError(f"worker {url} unreachable: {e}") from e

        tasks_to_post: List[tuple] = []
        for frag in subplan.fragments:
            n_parts = parts_of(frag)
            self.last_partition_counts[frag.fragment_id] = n_parts
            consumer = consumer_of.get(frag.fragment_id)
            if frag.fragment_id == root_id or consumer is None:
                out_spec = {"kind": "gather", "n": 1}
            else:
                rs, consumer_parts = consumer
                if rs.exchange_type == ExchangeType.REPARTITION:
                    out_spec = {"kind": "partitioned", "n": consumer_parts,
                                "keys": list(rs.partition_keys), "symbols": list(rs.symbols)}
                elif rs.exchange_type == ExchangeType.BROADCAST:
                    out_spec = {"kind": "broadcast", "n": consumer_parts}
                else:
                    out_spec = {"kind": "gather", "n": 1}
            remotes: List[RemoteSourceNode] = []
            visit_plan(frag.root,
                       lambda n: remotes.append(n) if isinstance(n, RemoteSourceNode) else None)
            for p in range(n_parts):
                inputs = {}
                for rs in remotes:
                    producer_parts = parts_of(frag_by_id[rs.fragment_id])
                    inputs[rs.fragment_id] = {
                        "exchange_type": rs.exchange_type.value,
                        "buffer": p,
                        "sources": [{"url": url_for(rs.fragment_id, pp),
                                     "task": task_id(rs.fragment_id, pp)}
                                    for pp in range(producer_parts)],
                    }
                desc = TaskDescriptor(
                    root=frag.root, types=subplan.types,
                    session_props=dict(self.session.properties), partition=p,
                    n_workers=n_parts, inputs=inputs, output=out_spec,
                    trace=TRACER.capture_ids(),
                )
                tasks_to_post.append(
                    (url_for(frag.fragment_id, p), task_id(frag.fragment_id, p), desc))

        # pull the root task's buffer like any exchange consumer, then tear
        # every created task down, also after a failure part way through
        created: List[Tuple[str, str]] = []
        root_url, root_task = url_for(root_id, 0), task_id(root_id, 0)
        try:
            for url, tid, desc in tasks_to_post:
                post_task(url, tid, desc)
                created.append((url, tid))
            pages = [deserialize_page(blob, device="cpu")
                     for blob in pull_buffer(root_url, root_task, 0, secret)]
        except TaskFailedError as e:
            # only transport-flavored task failures retry
            if any(s in e.error_text for s in (
                    "URLError", "ConnectionRefused", "ConnectionReset", "unreachable",
                    "TimeoutError", "RemoteDisconnected")):
                self._probe_workers_next = True
                raise RetryableQueryError(str(e)) from e
            raise RuntimeError(str(e)) from e
        except OSError as e:
            self._probe_workers_next = True
            raise RetryableQueryError(f"query failed: {e}") from e
        finally:
            for url, tid in created:
                try:
                    rel = f"/v1/task/{tid}"
                    req = urllib.request.Request(f"{url}{rel}", method="DELETE")
                    req.add_header(SIGNATURE_HEADER, sign(secret, "DELETE", rel))
                    urllib.request.urlopen(req, timeout=10).read()
                except OSError:  # lint: disable=bare-except-swallow -- best-effort remote task cleanup; worker TTL is the backstop
                    pass
        # the result is assembled on the host: it becomes Python rows
        merged = page_from_host_chunks([page_to_host(p) for p in pages], device="cpu")
        root = subplan.root_fragment.root
        assert isinstance(root, OutputNode)
        return QueryResult(list(root.column_names), merged.to_pylist(),
                           [c.type for c in merged.columns])
