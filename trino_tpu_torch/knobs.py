"""Central knob registry: every deployment env var and session property.

Reference blueprint: io.trino's config-property classes (io.trino.execution
TaskManagerConfig et al) + SystemSessionProperties.java — one declared,
typed, documented entry per knob, instead of ad-hoc ``os.environ`` reads
scattered through the runtime. Two tables live here:

- ``ENV_KNOBS``: every ``TRINO_TPU_*`` environment variable. The typed
  accessors below (``env_str``/``env_int``/``env_bytes``/...) are the ONLY
  sanctioned way to read them — the engine lint
  (``tools/lint`` rule ``env-read-outside-knobs``) fails any
  ``os.environ[...]`` read of a ``TRINO_TPU_*`` name outside this module.
  All accessors resolve at CALL time (late binding): an env var set after
  ``import trino_tpu`` still takes effect, matching the lazily-built
  memory pool and the result-cache deployment opt-in.

- ``SESSION_PROPERTIES``: name/type/default/description for every session
  property ``metadata.Session`` accepts. ``Session.DEFAULTS`` is built FROM
  this table, so a property cannot exist without a declared description.

``python -m trino_tpu.knobs`` renders both tables as the markdown knob
registry in ARCHITECTURE.md (``--write`` updates the section in place
between the ``knob-table`` markers); tests assert the committed table
matches the generator, so the hand-maintained doc can no longer drift.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


def parse_bytes(text) -> int:
    """``"512MB"``/``"2GB"``/``"4096"`` -> bytes (0 on empty/None/garbage).
    The canonical size parser — ``runtime.memory.parse_bytes`` re-exports it."""
    if text is None:
        return 0
    if isinstance(text, (int, float)):
        return int(text)
    s = str(text).strip().upper()
    if not s:
        return 0
    mult = 1
    for suffix, m in (
        ("TB", 1 << 40), ("GB", 1 << 30), ("MB", 1 << 20),
        ("KB", 1 << 10), ("B", 1),
    ):
        if s.endswith(suffix):
            s = s[: -len(suffix)]
            mult = m
            break
    try:
        return int(float(s) * mult)
    except ValueError:
        return 0


# --------------------------------------------------------------------------- #
# environment knobs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class EnvKnob:
    name: str
    type: str  # int | float | bytes | path | str | flag
    default: str  # rendered default for the doc table ("unset" when optional)
    description: str


ENV_KNOBS: Tuple[EnvKnob, ...] = (
    EnvKnob(
        "TRINO_TPU_IO_THREADS", "int", "4",
        "size of the shared host-I/O thread pool (spill/prefetch/serde jobs)",
    ),
    EnvKnob(
        "TRINO_TPU_CAP_STORE", "path", "unset",
        "persisted per-stage capacity tuning store (single JSON, atomic "
        "rename); unset = in-process dict",
    ),
    EnvKnob(
        "TRINO_TPU_MEMORY_POOL_BYTES", "bytes", "unset",
        "process memory pool size (kB/MB/GB suffixes); unset/0 = memory "
        "arbitration off",
    ),
    EnvKnob(
        "TRINO_TPU_QUERY_MAX_MEMORY", "bytes", "unset",
        "deployment default for the query_max_memory_bytes session property "
        "(resolved at lookup time)",
    ),
    EnvKnob(
        "TRINO_TPU_MEMORY_RESERVE_TIMEOUT", "float", "30",
        "seconds a blocked user reservation waits (spill/kill escalation "
        "window) before MemoryReserveTimeout",
    ),
    EnvKnob(
        "TRINO_TPU_QUERY_HISTORY", "int", "100",
        "completed queries kept queryable in the QueryManager ring "
        "(system.runtime.queries)",
    ),
    EnvKnob(
        "TRINO_TPU_QUERY_HISTORY_PATH", "path", "unset",
        "coordinator persistent query-history JSONL (survives restarts, "
        "backs system.runtime.query_history)",
    ),
    EnvKnob(
        "TRINO_TPU_FLIGHT_RING", "int", "65536",
        "flight-recorder ring capacity in events; overflow is counted as "
        "dropped_events",
    ),
    EnvKnob(
        "TRINO_TPU_STATS_HISTORY", "path", "unset",
        "statistics-feedback history persistence file (atomic-rename merge); "
        "unset = bounded in-process dict",
    ),
    EnvKnob(
        "TRINO_TPU_RESULT_CACHE", "path", "unset",
        "result-cache persistence file; a set path is also the deployment "
        "opt-in for the result tier",
    ),
    EnvKnob(
        "TRINO_TPU_DEVICE_REPARTITION", "flag", "1",
        "kill-switch for the device-side repartition epilogue (0/false = "
        "a CUDA page is refused; a CPU page takes the host path either way)",
    ),
    EnvKnob(
        "TRINO_TPU_INTERNAL_SECRET", "str", "unset",
        "shared HMAC secret authenticating intra-cluster coordinator/worker "
        "HTTP requests",
    ),
    EnvKnob(
        "TRINO_TPU_VALIDATE_PLAN", "flag", "unset",
        "force the validate_plan session default on (1/true) or off "
        "(0/false) process-wide; unset = on under pytest only",
    ),
    EnvKnob(
        "TRINO_TPU_HA_DIR", "path", "unset",
        "serving fabric substrate directory (leader lease + fencing state); "
        "set on every coordinator of an HA pair",
    ),
    EnvKnob(
        "TRINO_TPU_SHARED_CACHE_DIR", "path", "unset",
        "cross-process warm-tier directory on the object-store layer; a set "
        "path is also the deployment opt-in for the shared cache tier",
    ),
    EnvKnob(
        "TRINO_TPU_HEARTBEAT_SUSPECT_SECS", "float", "heartbeat/3",
        "heartbeat-loss grace window: a worker silent past this is SUSPECT "
        "(no new dispatch, no blacklist strike) before GONE",
    ),
    EnvKnob(
        "TRINO_TPU_CLUSTER_OBS", "flag", "unset",
        "server-process gate for the cluster observability plane "
        "(announcement metric/clock riders, /v1/flightrecorder?query_id=, "
        "/v1/metrics/cluster, /v1/query/{id}/profile); unset/0 = off with "
        "byte-identical responses",
    ),
    EnvKnob(
        "TRINO_TPU_QUERY_PROFILE_DIR", "path", "unset",
        "persisted query-profile bundle directory (one JSON per query, "
        "atomic rename); a set path is also the deployment opt-in for "
        "profile persistence and system.runtime.query_profiles",
    ),
    EnvKnob(
        "TRINO_TPU_ANNOUNCE_METRICS_MAX", "int", "256",
        "max metric series piggybacked on one worker announcement; overflow "
        "is dropped and counted "
        "(trino_tpu_announcement_metrics_dropped_total)",
    ),
    EnvKnob(
        "TRINO_TPU_HOSTPROF", "flag", "unset",
        "server-process gate for the host-path observability plane: starts "
        "the wall-clock sampling profiler and the GIL-contention probe for "
        "the process lifetime (coordinator/worker start()); unset/0 = off "
        "with no sampler thread and byte-identical query results",
    ),
    EnvKnob(
        "TRINO_TPU_HOSTPROF_INTERVAL_MS", "float", "19",
        "host-profiler sampling interval in milliseconds (floored at 1; "
        "the 19ms default is co-prime with common 10/20/100ms periodic "
        "work so samples don't alias against it)",
    ),
    EnvKnob(
        "TRINO_TPU_HOSTPROF_RING", "int", "4096",
        "host-profiler sample-ring capacity (per-thread stack samples); "
        "overflow is dropped and counted "
        "(trino_tpu_hostprof_dropped_samples_total)",
    ),
    EnvKnob(
        "TRINO_TPU_FLEET_DIR", "path", "unset",
        "coordinator-fleet membership substrate directory (heartbeat "
        "objects + follower-read status board); a set path is the opt-in "
        "for the active-active fleet plane",
    ),
    EnvKnob(
        "TRINO_TPU_FLEET_ROUTE", "str", "redirect",
        "non-owner statement handling: \"redirect\" answers 307 with the "
        "owner's address, \"proxy\" forwards the statement intake to the "
        "owner (result paging always goes direct)",
    ),
    EnvKnob(
        "TRINO_TPU_FLEET_PARTITION_BY", "str", "session",
        "ownership hash key: \"session\" = user@source, \"group\" = the "
        "resolved resource-group path (every session of a group lands on "
        "one coordinator, keeping its admission queue a single total order)",
    ),
    EnvKnob(
        "TRINO_TPU_FLEET_HEARTBEAT_SECS", "float", "1",
        "fleet membership heartbeat cadence; liveness TTL is 3 beats (one "
        "missed beat never reshuffles the ownership ring)",
    ),
    EnvKnob(
        "TRINO_TPU_FLEET_FOLLOWER_READS", "flag", "1",
        "serve system.*-only statements, warm result-cache hits, and "
        "GET /v1/query/{id} status polls from ANY fleet member (0/false = "
        "route every request to the owner)",
    ),
    EnvKnob(
        "TRINO_TPU_FLEET_FRONT_PORT", "int", "0",
        "shared SO_REUSEPORT client-facing port for the multi-process "
        "protocol front (each forked coordinator also binds a unique "
        "per-node port that membership advertises); 0 = no front listener",
    ),
    EnvKnob(
        "TRINO_TPU_HTTP_BACKLOG", "int", "0",
        "coordinator HTTP accept-backlog (listen(2) queue) size; 0 = the "
        "stdlib default (5). Part of the fleet front plane: the fleet CLI "
        "sets 128 per front process so a concurrent-session storm queues "
        "in the kernel instead of dropping SYNs into ~1s retransmits",
    ),
    EnvKnob(
        "TRINO_TPU_OBJECT_RETRY_MAX", "int", "5",
        "max retries per object-store request (throttle/timeout) before "
        "the EXTERNAL-classified failure escapes to the failure plane",
    ),
    EnvKnob(
        "TRINO_TPU_OBJECT_RETRY_INITIAL_MS", "int", "20",
        "object-store retry backoff base in ms (doubles per failure, "
        "0.5-1.5x jitter)",
    ),
    EnvKnob(
        "TRINO_TPU_OBJECT_RETRY_CAP_MS", "int", "1000",
        "object-store retry backoff cap in ms",
    ),
    EnvKnob(
        "TRINO_TPU_OBJECT_REQUEST_DEADLINE_MS", "int", "10000",
        "per-request deadline across all retries of one object-store "
        "request; past it the last failure escapes",
    ),
    EnvKnob(
        "TRINO_TPU_OBJECT_RETRY_BUDGET", "int", "64",
        "process-wide object-store retry token bucket (each retry spends "
        "1, each clean request refunds 0.1): a store-wide throttling event "
        "degrades to first-failure instead of amplifying load",
    ),
    EnvKnob(
        "TRINO_TPU_OBJECT_LIST_PAGE", "int", "1000",
        "object-store LIST page size in keys; each page is one retryable "
        "request",
    ),
    EnvKnob(
        "TRINO_TPU_OBJECT_LIST_LAG_MS", "int", "0",
        "object-store list-after-write visibility lag in ms: objects "
        "younger than this are omitted from listings even though direct "
        "GETs succeed (0 = strongly consistent listing; the "
        "object_store_list_lag chaos site forces lag per listing)",
    ),
    EnvKnob(
        "TRINO_TPU_OBJECT_MULTIPART_THRESHOLD", "bytes", "8MB",
        "puts at or above this size upload as multipart (each part its "
        "own retryable request); unset/0 = 8MB",
    ),
    EnvKnob(
        "TRINO_TPU_ROOFLINE_PEAKS", "str", "built-in per-platform defaults",
        "measured roofline peaks per platform for kernel-cost diagnosis, "
        "\"platform=FLOPS:BYTES\" comma-separated (e.g. "
        "\"cpu=5e10:2e10,tpu=1.97e14:8.19e11\"); unset = conservative "
        "placeholder defaults (classification still honest, pct-of-roofline "
        "approximate)",
    ),
)

_ENV_BY_NAME: Dict[str, EnvKnob] = {k.name: k for k in ENV_KNOBS}


def _declared(name: str) -> EnvKnob:
    knob = _ENV_BY_NAME.get(name)
    if knob is None:
        raise KeyError(
            f"undeclared env knob {name!r}: add it to trino_tpu.knobs.ENV_KNOBS"
        )
    return knob


def env_raw(name: str) -> Optional[str]:
    """The one sanctioned ``os.environ`` read for ``TRINO_TPU_*`` names."""
    _declared(name)
    return os.environ.get(name)


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    v = env_raw(name)
    return v if v is not None else default


def env_path(name: str) -> Optional[str]:
    """Path-valued knob: empty string counts as unset."""
    return env_raw(name) or None


def env_int(name: str, default: int) -> int:
    raw = (env_raw(name) or "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        # a malformed env var must never fail queries mid-flight
        return default


def env_float(name: str, default: float) -> float:
    raw = (env_raw(name) or "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def env_bytes(name: str) -> int:
    """Size knob ("512MB"/"2GB"/plain bytes) -> int, 0 on unset/garbage."""
    return parse_bytes(env_raw(name))


def env_flag(name: str, default: bool) -> bool:
    raw = (env_raw(name) or "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "false", "no", "off")


def default_validate_plan() -> bool:
    """``validate_plan`` session default: on under pytest (every test run
    exercises the checkers over its whole query corpus), off on the
    production hot path; TRINO_TPU_VALIDATE_PLAN forces either way."""
    raw = (env_raw("TRINO_TPU_VALIDATE_PLAN") or "").strip().lower()
    if raw:
        return raw not in ("0", "false", "no", "off")
    return "PYTEST_CURRENT_TEST" in os.environ


# --------------------------------------------------------------------------- #
# session properties
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class SessionProperty:
    name: str
    type: str
    default: object
    description: str


SESSION_PROPERTIES: Tuple[SessionProperty, ...] = (
    SessionProperty(
        "join_distribution_type", "varchar", "AUTO",
        "AUTO | PARTITIONED | BROADCAST build-side placement "
        "(DetermineJoinDistributionType)",
    ),
    SessionProperty(
        "join_reordering_strategy", "varchar", "AUTOMATIC",
        "NONE (syntactic order) | ELIMINATE_CROSS_JOINS | AUTOMATIC "
        "(cost-based reorder of flat inner-join trees)",
    ),
    SessionProperty(
        "task_concurrency", "integer", 1,
        "worker-side task parallelism",
    ),
    SessionProperty(
        "split_target_rows", "integer", 1 << 20,
        "rows per split/page",
    ),
    SessionProperty(
        "hash_partition_count", "integer", 8,
        "partitions for FIXED_HASH stages",
    ),
    SessionProperty(
        "push_partial_aggregation", "boolean", True,
        "split SINGLE aggregations into PARTIAL below / FINAL above the "
        "exchange",
    ),
    SessionProperty(
        "broadcast_join_threshold_rows", "integer", 1_000_000,
        "estimated build rows at or below which AUTO joins broadcast",
    ),
    SessionProperty(
        "exchange_compression", "boolean", False,
        "LZ4-serialize pages crossing the DCN exchange tier (the ICI tier "
        "never serializes)",
    ),
    SessionProperty(
        "enable_dynamic_filtering", "boolean", True,
        "build-side key range narrows the probe side before evaluation "
        "(DynamicFilterService analogue)",
    ),
    SessionProperty(
        "query_max_memory_bytes", "bigint", 0,
        "per-query device-memory reservation limit (0 = unlimited); "
        "deployment default via TRINO_TPU_QUERY_MAX_MEMORY, resolved at "
        "lookup time",
    ),
    SessionProperty(
        "exchange_spill_trigger_bytes", "bigint", 0,
        "device-byte budget for stage outputs parked between fragments; "
        "beyond it pages spill to LZ4 host memory",
    ),
    SessionProperty(
        "spill_operator_threshold_bytes", "bigint", 0,
        "operator-state revoke threshold: grouped agg/join state beyond "
        "this hash-partitions to host memory (0 = off)",
    ),
    SessionProperty(
        "retry_policy", "varchar", "NONE",
        "NONE | QUERY (re-run once on retryable failure) | TASK "
        "(fault-tolerant execution: durable exchange + per-task retry)",
    ),
    SessionProperty(
        "task_retry_attempts", "integer", 2,
        "FTE attempts per task before the query fails",
    ),
    SessionProperty(
        "fte_exchange_dir", "varchar", "",
        "FTE durable exchange directory (default: a managed temp dir)",
    ),
    SessionProperty(
        "task_completion_timeout", "double", 300.0,
        "per-attempt completion deadline in seconds (0 = unbounded); a hung "
        "attempt fails the ATTEMPT, never the query",
    ),
    SessionProperty(
        "fte_task_concurrency", "integer", 8,
        "concurrent task attempts in flight per query",
    ),
    SessionProperty(
        "fte_retry_initial_delay", "double", 0.05,
        "classified-retry backoff initial delay (doubles per failure, "
        "0.5-1.5x jitter)",
    ),
    SessionProperty(
        "fte_retry_max_delay", "double", 2.0,
        "classified-retry backoff cap in seconds",
    ),
    SessionProperty(
        "fte_blacklist_ttl", "double", 60.0,
        "seconds a misbehaving worker sits out before timed re-admission",
    ),
    SessionProperty(
        "fte_speculation_enabled", "boolean", True,
        "stragglers past the quantile threshold get ONE speculative sibling "
        "attempt; first durable commit wins",
    ),
    SessionProperty(
        "fte_speculation_min_secs", "double", 10.0,
        "minimum task age before speculation triggers",
    ),
    SessionProperty(
        "fte_speculation_quantile", "double", 0.75,
        "completed-duration quantile feeding the straggler threshold",
    ),
    SessionProperty(
        "fte_speculation_multiplier", "double", 4.0,
        "straggler threshold = max(min_secs, multiplier x P[quantile])",
    ),
    SessionProperty(
        "distributed_sort", "boolean", True,
        "ORDER BY beyond one device: range shuffle + per-shard sort + merge "
        "gather",
    ),
    SessionProperty(
        "mesh_join_capacity_factor", "double", 1.0,
        "single-program ICI execution: initial join output capacity as a "
        "multiple of probe capacity (overflow retries double it)",
    ),
    SessionProperty(
        "use_ici_exchange", "boolean", True,
        "try lowering fragment trees into one shard_map program before the "
        "staged DCN path",
    ),
    SessionProperty(
        "target_partition_rows", "integer", 1_000_000,
        "adaptive partition counts: a FIXED_HASH/FIXED_RANGE fragment runs "
        "ceil(est_rows / this) parts, capped by worker count",
    ),
    SessionProperty(
        "max_tasks_per_worker", "integer", 0,
        "topology placement: tasks per worker before placement spills to "
        "the next tier (0 = unbounded)",
    ),
    SessionProperty(
        "pallas_aggregation", "varchar", "auto",
        "hand-written kernel tier for direct-indexed grouped aggregation: "
        "auto | off | force | interpret (resolve_pallas_aggregation documents "
        "the policy: AUTO and FORCE run the grouped-sum kernels, OFF keeps "
        "the plain formulation)",
    ),
    SessionProperty(
        "pallas_fusion", "boolean", True,
        "fused hash-join path (ops/megakernels.py): joins, and joins feeding "
        "a grouped aggregation, run through the hash_probe, hash_expand and "
        "segment_agg kernels; off = the serial sort-based join and plain "
        "aggregation. Default on in the port (the reference defaults off for "
        "its device-batching contract, which the port does not carry): the "
        "kernels are the main path under test",
    ),
    SessionProperty(
        "pallas_interpret", "varchar", "auto",
        "kept for the reference's session vocabulary; no effect in the port "
        "(a kernel wrapper runs its plain version exactly when its tensors "
        "lie on the CPU)",
    ),
    SessionProperty(
        "query_stats_sync", "boolean", False,
        "fence every operator for exact device/host/compile attribution "
        "(defeats async dispatch; EXPLAIN ANALYZE VERBOSE turns it on)",
    ),
    SessionProperty(
        "flight_recorder", "boolean", False,
        "record pipeline events into the process flight-recorder ring",
    ),
    SessionProperty(
        "kernel_cost", "boolean", False,
        "XLA cost-model attribution (runtime/kernelcost.py): per-plan-node "
        "FLOPs / HBM bytes / peak device memory with roofline diagnosis in "
        "EXPLAIN ANALYZE VERBOSE and system.runtime.kernel_costs; off = "
        "byte-identical execution path",
    ),
    SessionProperty(
        "statistics_feedback", "boolean", True,
        "collect per-node actual row counts, detect mis-estimates, record "
        "estimate-vs-actual history",
    ),
    SessionProperty(
        "history_based_stats", "boolean", False,
        "overlay recorded actuals onto the stats estimator on the next "
        "planning of a matching shape (Presto HBO analogue)",
    ),
    SessionProperty(
        "qerror_threshold", "double", 2.0,
        "q-error above which a plan node emits a cardinality_misestimate "
        "flight event + counter",
    ),
    SessionProperty(
        "result_cache", "boolean", False,
        "serve repeated queries from the full-result tier (a set "
        "$TRINO_TPU_RESULT_CACHE also opts the process in)",
    ),
    SessionProperty(
        "result_cache_max_bytes", "bigint", 64 << 20,
        "byte bound shared by the result and fragment tiers (LRU eviction)",
    ),
    SessionProperty(
        "result_cache_ttl", "double", 300.0,
        "staleness fallback for catalogs without a version hook; 0 = such "
        "plans bypass the result/fragment tiers",
    ),
    SessionProperty(
        "fragment_cache", "boolean", False,
        "materialize shared scan->filter->(partial-)agg prefixes once into "
        "the durable exchange store (single-flight dedup)",
    ),
    SessionProperty(
        "plan_cache_size", "integer", 0,
        "optimized-plan LRU by statement text + session state; a hit skips "
        "parse/analysis/optimization (0 = off)",
    ),
    SessionProperty(
        "validate_plan", "boolean", False,
        "run plan sanity checkers after EVERY optimizer rule "
        "(planner/sanity.py); default resolves dynamically — on under "
        "pytest, off otherwise, forced by TRINO_TPU_VALIDATE_PLAN",
    ),
    SessionProperty(
        "device_batching", "boolean", False,
        "pack compatible fragment subtrees from concurrent queries into "
        "one ragged device launch + shared-scan elimination "
        "(runtime/device_scheduler.py); off = byte-identical serial path",
    ),
    SessionProperty(
        "batch_max_lanes", "integer", 8,
        "device batching: max work-item lanes packed into one ragged "
        "launch (1 effectively disables packing, scans still share)",
    ),
    SessionProperty(
        "batch_admit_window_ms", "double", 2.0,
        "device batching: how long a batch leader holds admission open "
        "for compatible concurrent work items before launching",
    ),
    SessionProperty(
        "tensor_plane", "boolean", False,
        "tensor workload plane (ops/tensor.py): master gate for VECTOR "
        "top-k fusion and model scoring; off = plans and execution "
        "byte-identical (the similarity scalar family itself is always "
        "available, like any scalar function)",
    ),
    SessionProperty(
        "vector_topk_fusion", "boolean", False,
        "fuse ORDER BY <similarity> LIMIT k into ONE scores->top-k device "
        "program (optimizer fuse_vector_topn; needs tensor_plane); off = "
        "the serial Project + TopN pair, the bit-identity oracle",
    ),
    SessionProperty(
        "vector_query_batching", "boolean", False,
        "vector serving plane: coalesce concurrent VectorTopN work items "
        "that differ only in their constant query vector into ONE stacked "
        "device launch during the batch_admit_window_ms linger (needs "
        "device_batching); off = byte-identical per-query launches",
    ),
    SessionProperty(
        "ann_mode", "varchar", "off",
        "approximate vector search: off (exact scan, the recall oracle) | "
        "approx (IVF centroid pre-pass prunes cluster splits to the "
        "ann_nprobe nearest, like partition pruning) | approx(nprobe=N) "
        "(inline nprobe override)",
    ),
    SessionProperty(
        "ann_nprobe", "integer", 1,
        "IVF clusters probed per approximate vector top-k (ann_mode= "
        "approx); nprobe >= the index's cluster count reads every split "
        "in id order — bit-identical to exact mode",
    ),
    SessionProperty(
        "ann_recall_sample_rate", "double", 0.0,
        "fraction of ANN-pruned vector top-k executions re-run against "
        "the unpruned exact oracle to measure recall@k "
        "(system.runtime.ann_recall); 0 = never sample",
    ),
    SessionProperty(
        "model_scoring", "boolean", False,
        "SQL-surfaced model scoring: enables the linear_score / gbdt_score "
        "table functions (models compiled to XLA matmul / vectorized tree "
        "traversal; needs tensor_plane)",
    ),
    SessionProperty(
        "ha_plane", "boolean", False,
        "serving fabric plane (runtime/ha.py): journal FTE dispatch "
        "progress next to the durable exchange so a standby coordinator "
        "can replay it and resume in-flight queries after failover; off = "
        "byte-identical execution path",
    ),
    SessionProperty(
        "shared_cache_tier", "boolean", False,
        "cross-process warm tier: the result cache reads/publishes entries "
        "through $TRINO_TPU_SHARED_CACHE_DIR with leased single-flight so "
        "a coordinator fleet shares one warm cache (needs the env dir set)",
    ),
    SessionProperty(
        "elastic_workers", "boolean", False,
        "worker elasticity: the scale controller admits late-joining "
        "workers into running FTE queries and drains departing ones "
        "gracefully, driven by queue depth / memory pressure / blacklist "
        "churn signals",
    ),
    SessionProperty(
        "cluster_obs", "boolean", False,
        "cluster observability plane (runtime/clusterobs.py): cross-node "
        "trace assembly, per-stage time breakdown on FTE queries, query-"
        "profile persistence, and the EXPLAIN ANALYZE VERBOSE dominant-cost "
        "diagnosis; off = byte-identical execution path",
    ),
    SessionProperty(
        "slow_query_threshold", "double", 0.0,
        "wall-time seconds at or above which a completed query's profile "
        "bundle auto-persists to $TRINO_TPU_QUERY_PROFILE_DIR (0 = every "
        "completed query; needs cluster_obs + the profile dir)",
    ),
    SessionProperty(
        "host_profile", "boolean", False,
        "host-path observability plane (runtime/hostprof.py): run the "
        "wall-clock sampling profiler for this statement's execution "
        "(refcounted, like flight_recorder) — collapsed host stacks land "
        "in system.runtime.host_profile and the speedscope export; off = "
        "no sampler thread and byte-identical results",
    ),
    SessionProperty(
        "cache_aware_admission", "boolean", True,
        "serve result-cache hits BEFORE the resource-group queue gate (a "
        "warm hit never waits behind queued queries); no-op unless the "
        "result tier is enabled",
    ),
    SessionProperty(
        "protocol_first_response_wait", "double", 0.0,
        "seconds the initial POST /v1/statement response may wait for the "
        "query to reach a terminal state (the protocol's maxWait long-poll "
        "applied to the first response): a fast query — a warm cache hit "
        "above all — drains in ONE round trip instead of POST + GET; 0 = "
        "respond immediately (byte-identical protocol sequence)",
    ),
)

# session defaults resolved dynamically at LOOKUP time (metadata.Session.get):
# the static default above is what SHOW SESSION prints, the callable is what
# an unset property actually returns
DYNAMIC_SESSION_DEFAULTS = {
    "validate_plan": default_validate_plan,
}

# session defaults seeded from the environment at LOOKUP time
ENV_SESSION_DEFAULTS = {
    "query_max_memory_bytes": "TRINO_TPU_QUERY_MAX_MEMORY",
}


def session_property_names() -> frozenset:
    return frozenset(p.name for p in SESSION_PROPERTIES)


# --------------------------------------------------------------------------- #
# pallas-tier policy resolvers (THE documented policy — executor._pallas_mode
# and the device-batching admission check both delegate here, so the mode
# vocabulary cannot drift between the launch sites)
# --------------------------------------------------------------------------- #


def resolve_pallas_aggregation(value) -> str:
    """``pallas_aggregation`` session value -> static engine mode of the port.

    - ``auto`` (the default) -> ``"kernel"``: integer sums and
      counts of the direct-indexed aggregation go through the grouped-sum
      kernel wrappers (ops/hopper_kernels.py), which launch the CUDA kernel
      on a card; pages under 32768 rows keep the plain formulation. The
      reference keeps its XLA formulation under AUTO because of a TPU v5e
      measurement; that reason does not carry over to the H100, and the
      kernel is the main path under test.
    - ``force``: an alias of ``auto``, kept so that session values written
      for the reference still parse; it selects nothing of its own.
    - ``interpret`` -> ``"interpret"``: the wrappers at every page size. On
      CPU tensors a wrapper computes its plain version, so this is the CPU
      test hook.
    - ``off`` (and anything unrecognised) -> ``"off"``: the plain
      ``kernels.direct_group_reduce`` formulation.
    """
    mode = str(value or "auto").lower()
    if mode == "interpret":
        return "interpret"
    if mode in ("auto", "force"):
        return "kernel"
    return "off"


def resolve_ann_mode(value) -> Tuple[str, Optional[int]]:
    """``ann_mode`` session value -> ``(mode, nprobe_override)``.

    - ``off`` (default) -> ``("off", None)``: exact scans, no pruning.
    - ``approx`` -> ``("approx", None)``: centroid-pruned probing with the
      probe width taken from the ``ann_nprobe`` session knob.
    - ``approx(nprobe=N)`` -> ``("approx", N)``: inline probe-width
      override, clamped to >= 1.

    Unrecognised strings resolve to ``off`` — planner knobs degrade to the
    exact path, they never fail a query.
    """
    import re

    s = str(value or "off").strip().lower()
    if s == "approx":
        return ("approx", None)
    m = re.match(r"^approx\(\s*nprobe\s*=\s*(\d+)\s*\)$", s)
    if m:
        return ("approx", max(1, int(m.group(1))))
    return ("off", None)


# --------------------------------------------------------------------------- #
# doc generation
# --------------------------------------------------------------------------- #

TABLE_BEGIN = "<!-- knob-table:begin (generated by python -m trino_tpu.knobs) -->"
TABLE_END = "<!-- knob-table:end -->"


def knob_table_markdown() -> str:
    """The generated ARCHITECTURE.md knob registry section."""
    lines: List[str] = [TABLE_BEGIN, ""]
    lines.append("**Environment knobs** (read only through `trino_tpu.knobs`):")
    lines.append("")
    lines.append("| env var | type | default | meaning |")
    lines.append("|---|---|---|---|")
    def esc(text) -> str:
        # markdown table cells: literal pipes must be escaped or the row
        # grows extra columns (join_distribution_type's "AUTO | PARTITIONED")
        return str(text).replace("|", "\\|")

    for k in ENV_KNOBS:
        lines.append(
            f"| `{k.name}` | {k.type} | `{k.default}` | {esc(k.description)} |"
        )
    lines.append("")
    lines.append("**Session properties** (`metadata.Session`, SET SESSION):")
    lines.append("")
    lines.append("| property | type | default | meaning |")
    lines.append("|---|---|---|---|")
    for p in SESSION_PROPERTIES:
        default = p.default if p.default != "" else "''"
        lines.append(
            f"| `{p.name}` | {p.type} | `{default}` | {esc(p.description)} |"
        )
    lines.append("")
    lines.append(TABLE_END)
    return "\n".join(lines)


def _replace_table(doc: str, table: str) -> str:
    start = doc.find(TABLE_BEGIN)
    end = doc.find(TABLE_END)
    if start < 0 or end < 0:
        raise SystemExit(
            "ARCHITECTURE.md is missing the knob-table markers; add "
            f"{TABLE_BEGIN!r} ... {TABLE_END!r} where the table belongs"
        )
    return doc[:start] + table + doc[end + len(TABLE_END):]


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    table = knob_table_markdown()
    if "--write" in argv:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "ARCHITECTURE.md")
        doc = open(path).read()
        open(path, "w").write(_replace_table(doc, table))
        print(f"updated knob table in {path}", file=sys.stderr)
    else:
        print(table)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
