"""Chip smoke test of the PyTorch/CUDA port (trino_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, and the final JSON line is not
printed):

1. Card and build: the card's name and power limit, then the Hopper kernels
   compiled from ``trino_tpu_torch/csrc/`` (build seconds and the ptxas
   report).
2. Kernels against their plain torch versions on the card, bit-exact: each
   wrapper at its main path's shape (one lineitem page of TPC-H SF10: G = 12
   for the grouped sums; Q3's join sizes for the hash join; Q3's joined
   rows for the segment sums; Q10's joined page for the group sort and the
   repartition epilogue) and at edge shapes, timed with CUDA events beside
   its bytes bound, its plain version and, where one torch call computes
   the same function (or, for the two sorts, the one call that does their
   sorting work: ``torch.sort`` of one int64 key), that call. The group
   sort's time is split by phase (stats and the host read, compose, radix
   passes, finish and gather) with its plan's composites and its stream
   operations a call; the segment sums' stream operations are counted; the
   hash probe's time is split into its memset, claim, bucket and probe
   phases and the repartition epilogue's into its count and sweep (or
   three-launch) phases, each with its stream operations and device time
   by kernel. The hash probe is compared on what the expansion reads of it
   (the kernel leaves the rest unspecified), and the expansion run on its
   output against the plain expansion on the plain probe's output, over
   the whole joined page; its bound is counted on what it must move, beside
   the whole-table bound of earlier versions.
3. TPC-H Q6, Q1, Q3 and Q10 at SF10 through ``LocalQueryRunner.tpch(scale=
   10)`` with the default session: the launch counts of each run (every
   count set to 0 just before it), rows identical to the run with the
   kernel tier off (``pallas_aggregation=off`` for Q6 and Q1,
   ``pallas_fusion=false`` for Q3 and Q10) and to an independent numpy
   computation over the port's generator, no fallback of the fused path,
   Q10's fused phases (probe 3, expand 3, aggregate 1), Q10's group sort
   on one 64-bit composite, and the wall seconds of each query. Every
   kernel is also checked and timed on the inputs the queries gave it (its
   real distributions; the repartition epilogue on Q10's joined page; the
   hash probe, with the whole joined page and its phase split, on each of
   Q3's two and Q10's three joins); those times go in the kernels line,
   but the epilogue's, which come from phase 6's spill path. The group
   sort and the segment sums also print their device time by kernel
   (``torch.profiler``).
4. TPC-H Q14 and Q18 at SF10 (Q18 with TPC-H's quantity threshold of 300)
   with the default session: wall seconds, peak device memory
   (``torch.cuda.max_memory_allocated`` after a reset), launches by fused
   phase and by kernel, no fallback; rows identical to the kernel tier off
   and to a numpy computation over the port's generator (Q14's DOUBLE at
   1e-9 relative); the hash probe and expansion held bit-exact and timed on
   the inputs each join gave them.
5. The 22 queries of ``tests/tpch_corpus.py`` at SF1, each with the
   default session (launch counts printed by query) and with the kernel
   tier off: rows identical (DOUBLE at 1e-9 relative), no fallback but the
   CROSS joins the fused path declines (Q11, Q22), and every kernel each
   query launched held bit-exact against its plain version on the inputs
   the query gave it.
6. The out-of-core tier. (a) Q1 at SF100 through the streaming
   aggregation (``runtime/streaming.py``): wall, splits, peak device memory
   (fails past 8 GiB), the I/O pool's generation seconds and the main
   thread's wait, launches by kernel; rows equal to numpy sums tapped from
   the host arrays the connector generates, the grouped sums bit-exact on
   the first split's inputs. (b) Q3 and Q18 (threshold 300) at SF10
   through the out-of-core runner (``runtime/ooc.py``) with the
   reference's defaults: rows identical to phases 3 and 4, wall, peak
   beside the in-core peak, units by fragment, ``host_wait_secs``,
   ``emit_secs``, prefetch hits (must be > 0) and misses, ``spilled_bytes``,
   launches, every launched kernel bit-exact on its inputs; then Q3 with
   the prefetch off and a 256 MiB store budget (its disk tier), rows
   identical again. (c) Q3 at SF10 with ``spill_operator_threshold_bytes``
   at 1 GiB: rows identical to phase 3's, the spill through
   ``partition_epilogue``, every launch bit-exact on its own inputs, the
   device formulation's frames byte-identical to the host-backed one's on
   the smallest spilled relation; the epilogue timed on the largest for
   the kernels line.
7. TPC-DS and window functions. (a) q3, q7, q65 and q98 of the TPC-DS
   corpus at SF10 through ``LocalQueryRunner.tpcds(scale=10)`` with the
   default session: wall, peak device memory, launches by kernel and
   fused phase, no fallback, every tapped launch bit-exact against its
   plain version on its own inputs, the NULL join keys each probe met
   (and how many on active rows), q7's largest star join's ``hash_probe``
   and ``hash_expand`` timed beside their bounds; q7 again with dynamic
   filtering off, so its NULL foreign keys stay active into the probe's
   trash bucket (fails if none does), rows identical to the default run;
   rows identical to the kernel tier off, q3 and q98 equal to numpy over
   the generator. (b) The 25 corpus queries (texts read from
   ``tests/test_tpcds.py`` by ``tests/tpcds_corpus_texts.py``, which
   fails unless 25 come out) at SF1, as phase 5 runs TPC-H's. (c) A
   ``rank()`` and ROWS-frame ``sum`` window over TPC-H ``orders`` at SF10
   (15,000,000 rows), filtered to rank <= 3 and aggregated by rank: rows
   equal to numpy.
8. TPC-H SF10 held in memory tables (``connectors/memory.py``). (a) CREATE
   TABLE AS of ``lineitem``, ``orders``, ``customer``, ``part``, ``supplier``,
   ``nation`` and ``region`` into ``memory.default``: rows against the
   generator's count, seconds, device bytes stored, peak. (b) Q6, Q1, Q3,
   Q10 and Q18 (threshold 300) from the memory tables with the default
   session: rows identical to phases 3 and 4's over ``tpch``, the wall
   beside that phase's, peak, launches by kernel and fused phase, no
   fallback, Q10's fused phases as in phase 3, every tapped launch
   bit-exact against its plain version, and whether the optimized plan's
   text equals the one over ``tpch`` (printed, not a gate). (c) A checksum
   of every stored tensor (each column's data bits and ``valid``, each
   page's ``active``) after (a) and after (b): equal. (f) Four queries of
   the scalar functions and the aggregate long tail (``FUNCTION_QUERIES``:
   F1, Q1's shape with the variance family; F2, a join under a grouped
   aggregation with ``date_trunc``, ``date_diff`` and ``regexp_like``; F3,
   the statistical, bitwise and approximate aggregates; F4, ISO week parts
   and string transforms) with the default session: wall, peak, launches
   by kernel, ``FALLBACKS`` (must stay empty); rows identical to the
   kernel tier off, F1 and F2 equal to numpy over the generator (the
   variance family by the reference's one-pass formula over exact sums,
   at 1e-9 relative), F1 through both grouped sums and F2 through
   ``hash_probe`` and ``hash_expand``, every tapped launch bit-exact; the
   checksums again. (g) The nested queries (``NESTED_QUERIES``): N1, a
   CTAS of every customer's orders as two arrays in date order
   (``array_agg`` with ORDER BY), its lane width, rows, bytes and the sum
   of its arrays' lengths against the order count; N2, UNNEST of those
   arrays into the ``lineitem`` join; N3, lambdas and array functions over
   the arrays carried through the ``customer`` join's ``hash_expand``; N4,
   ``histogram``, ``array_agg(DISTINCT)``, ``map_agg`` and ``listagg``; N5,
   JSON, URL and ``split`` over ``orders``' dictionary columns. Each with
   its wall, peak and launches by kernel; rows equal to the flat queries
   (``NESTED_FLAT``) that compute the same without nested values, N2 and
   N3 identical to the kernel tier off, through ``hash_probe`` and
   ``hash_expand`` with no fallback and every tapped launch bit-exact, and
   N3's ``prices`` lanes carried by the expansion; then DROP of
   ``cust_orders`` (device memory back within 1 % of its level before N1)
   and the checksums again. (d) A DELETE of
   ``orders`` by ``o_orderdate``, an UPDATE of ``l_discount`` by
   ``l_shipmode``, a MERGE into ``orders`` from about 1,500,000 source rows
   (half matched, half inserted) and a DELETE of ``lineitem`` rolled back,
   each with its wall and peak and against numpy over the generator; after
   the ROLLBACK the counts and checksums equal those before it. (e) DROP of
   every table: device memory allocated back within 1 % of its level before
   (a).
9. The seconds of each phase, a ``kernels`` JSON line (launches summed over
   the default runs of phases 3 to 8, 8f's and 8g's included), then the contract's last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is visible, or
when the port (or ``tests/tpch_corpus.py`` and
``tests/tpcds_corpus_texts.py``) is not importable beside this script.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SCALE = 10
G_Q1 = 12  # Q1's direct-indexed domains (4, 3)
# H100 SXM memory rate and float32 CUDA-core rate at 700 W (NVIDIA's data
# sheet): the bounds below divide by these
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
Q6_PRED = (8766, 9131, 5, 7, 2400)  # 1994-01-01, 1995-01-01, 0.05, 0.07, 24.00
Q3_DATE = 9204  # 1995-03-15
Q10_DATES = (8674, 8766)  # 1993-10-01, 1994-01-01
Q10_PARTS = 8  # the engine's hash_partition_count default, for the epilogue
# the texts of tests/tpch_corpus.py
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
               sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
               avg(l_quantity) AS avg_qty,
               avg(l_extendedprice) AS avg_price,
               avg(l_discount) AS avg_disc,
               count(*) AS count_order
        FROM lineitem
        WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus
    """,
    "q03": """
        SELECT l_orderkey,
               sum(l_extendedprice * (1 - l_discount)) AS revenue,
               o_orderdate, o_shippriority
        FROM customer, orders, lineitem
        WHERE c_mktsegment = 'BUILDING'
          AND c_custkey = o_custkey
          AND l_orderkey = o_orderkey
          AND o_orderdate < DATE '1995-03-15'
          AND l_shipdate > DATE '1995-03-15'
        GROUP BY l_orderkey, o_orderdate, o_shippriority
        ORDER BY revenue DESC, o_orderdate, l_orderkey
        LIMIT 10
    """,
    "q10": """
        SELECT c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) AS revenue, c_acctbal
        FROM customer, orders, lineitem, nation
        WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
          AND o_orderdate >= DATE '1993-10-01' AND o_orderdate < DATE '1994-01-01'
          AND l_returnflag = 'R' AND c_nationkey = n_nationkey
        GROUP BY c_custkey, c_name, c_acctbal
        ORDER BY revenue DESC, c_custkey
        LIMIT 20
    """,
}
# the kernel tier of each query, and the session that turns it off
KERNELS_OF = {
    "q06": ("q6_fused",),
    "q01": ("grouped_sum_i64", "grouped_sum_i32"),
    "q03": ("hash_probe", "hash_expand", "segment_sum"),
    "q10": ("hash_probe", "hash_expand", "group_sort", "segment_sum"),
}
OFF_SESSION = {"q06": ("pallas_aggregation", "off"), "q01": ("pallas_aggregation", "off"),
               "q03": ("pallas_fusion", False), "q10": ("pallas_fusion", False)}
# the default-session walls of phases 3 and 4, by query (phase 8 prints its
# walls over memory tables beside them)
INCORE_WALLS = {}
# the fused phases each query must run (megakernels.LAUNCHES)
PHASES_OF = {"q03": {"probe": 2, "expand": 2, "aggregate": 1},
             "q10": {"probe": 3, "expand": 3, "aggregate": 1}}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events over
    ``reps`` calls after one warm-up call). Every input is larger than the
    50 MB L2 at the main-path shape, so each call reads HBM."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int, ops: int) -> tuple:
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / CORE_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #


def grouped_cases(n_main: int, dev):
    """(label, values int64, weight, gid, G, offsets) cases for the grouped
    sums. ``offsets`` are the element offsets (values, weight, gid) of the
    views the kernel is given, taken after the values' cast: offset views
    start off 16-byte alignment."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def rnd(n, lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)

    def case(label, n, G, lo=-(10**12), hi=10**12, wrate=0.8, gmax=None, offsets=(0, 0, 0)):
        vals = rnd(n, lo, hi)
        w = torch.rand(n, generator=gen, device=dev) < wrate
        gid = rnd(n, 0, gmax or G, torch.int32)
        return label, vals, w, gid, G, offsets

    yield case("uniform n=%d G=%d" % (n_main, G_Q1), n_main, G_Q1, 1, 10**9, 0.98)
    # Q1's page at SF10: 4 of its 12 groups live, in its row counts per group
    label, vals, w, _, G, off = case("Q1's 4 live groups of 12, n=%d" % n_main, n_main, G_Q1,
                                     1, 10**9, 0.98)
    live = torch.tensor([0, 3, 4, 6], dtype=torch.int32, device=dev)
    share = torch.tensor([15_594_570, 406_798, 28_389_020, 15_602_153], dtype=torch.float64,
                         device=dev)
    pick = torch.multinomial(share, n_main, replacement=True, generator=gen)
    yield label, vals, w, live[pick], G, off
    label, vals, w, gid, G, off = case("one live group of 12, n=%d" % n_main, n_main, G_Q1,
                                       1, 10**9, 0.98)
    yield label, vals, w, torch.full_like(gid, 4), G, off
    yield case("G=64 n=%d" % n_main, n_main, 64, 1, 10**9, 0.98)
    yield case("views offset by one row, n=%d" % n_main, n_main, G_Q1, 1, 10**9, 0.98,
               offsets=(1, 1, 1))
    yield case("views offset apart (values 0, weight 2, gid 1)", 1_000_003, G_Q1,
               offsets=(0, 2, 1))
    yield case("views offset by three rows, G=64", 777_777, 64, offsets=(3, 3, 3))
    yield case("unaligned n", 1_000_003, G_Q1)
    yield case("n=0", 0, G_Q1)
    yield case("n=3, offset by one row", 4, 5, offsets=(1, 1, 1))
    yield case("G=1", 777_777, 1)
    yield case("G=17", 777_777, 17)
    yield case("G=33", 777_777, 33)
    yield case("G=64", 777_777, 64)
    yield case("empty groups", 500_001, G_Q1, gmax=5)
    label, vals, w, _, G, off = case("gid out of range", 400_003, 6)
    yield label, vals, w, rnd(400_003, -3, 9, torch.int32), G, off
    yield case("wrapping int64", 1_000_000, 5, -(2**62), 2**62, 1.0)
    label, vals, w, gid, G, off = case("all-false mask", 300_000, G_Q1)
    yield "all-false mask", vals, torch.zeros_like(w), gid, G, off


def q6_cases(n_main: int, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def rnd(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    def case(label, n, price_lo=90_000, price_hi=10_500_000, mask_rate=0.98):
        cols = (
            rnd(n, 8000, 10600), rnd(n, 0, 11), rnd(n, 100, 5100),
            rnd(n, price_lo, price_hi),
            (torch.rand(n, generator=gen, device=dev) < mask_rate).to(torch.int32),
        )
        return label, cols

    yield case("main n=%d" % n_main, n_main)
    yield case("unaligned n", 1_000_003)
    yield case("n=0", 0)
    # products up to (2^31-1)*10: past the Pallas kernel's int32 product limit
    yield case("products past int32", 1_000_000, 2**31 - 1000, 2**31 - 1)
    yield case("all-false mask", 300_000, mask_rate=0.0)


def round_capacity(n: int, base: int = 1024) -> int:
    cap = base
    while cap < n:
        cap *= 2
    return cap


# --------------------------------------------------------------------------- #
# the hash join and the segment sums: cases, checks, timings
# --------------------------------------------------------------------------- #


def key_bytes(cols) -> int:
    """Bytes of one row of (data, valid) columns."""
    return sum(d.element_size() * (d[0].numel() if d.ndim > 1 else 1) + 1 for d, _ in cols)


def join_cases(HK, n_main: int, dev):
    """(label, pkeys, bkeys, luts, probe_active, build_active, left_outer,
    past_limit) cases for hash_probe and hash_expand. The first has the
    shape of Q3's second join at SF10: one lineitem page of probe keys
    against a build side of 2,097,152 slots, 70 % active, with unique keys
    (order keys). ``past_limit`` lets the table pass the engine's entry
    limit (the fan-out case's C = 8192)."""
    from trino_tpu_torch.ops import megakernels as MK
    from trino_tpu_torch.runtime.capstore import capacity_class

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def rnd(n, lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)

    def mask(n, rate):
        return torch.rand(n, generator=gen, device=dev) < rate

    m = 2_097_152
    bk = torch.arange(m, device=dev, dtype=torch.int64) * 4 + 1
    yield ("Q3 shape n=%d m=%d" % (n_main, m), ((rnd(n_main, 0, 4 * m), mask(n_main, 1.0)),),
           ((bk, mask(m, 1.0)),), (None,), mask(n_main, 0.54), mask(m, 0.7), False, False)
    n, m = 1_000_003, 300_007
    yield ("LEFT, NULL keys", ((rnd(n, 0, 400_000), mask(n, 0.9)),),
           ((rnd(m, 0, 400_000), mask(m, 0.9)),), (None,), mask(n, 0.8), mask(m, 0.7), True,
           False)
    lut = rnd(4000, -1, 3000)  # probe vocabulary -> build codes, some absent
    yield ("dictionary key through a LUT", ((rnd(n, 0, 4000, torch.int32), mask(n, 0.95)),),
           ((rnd(4096, 0, 3000, torch.int32), mask(4096, 0.95)),), (lut,), mask(n, 0.8),
           mask(4096, 0.7), False, False)
    yield ("two keys (int32, float64)",
           ((rnd(n, 0, 2000, torch.int32), mask(n, 0.95)),
            (rnd(n, 0, 40).to(torch.float64) / 4 - 5, mask(n, 0.95))),
           ((rnd(100_000, 0, 2000, torch.int32), mask(100_000, 0.95)),
            (rnd(100_000, 0, 40).to(torch.float64) / 4 - 5, mask(100_000, 0.95))),
           (None, None), mask(n, 0.8), mask(100_000, 0.7), True, False)
    yield ("empty build", ((rnd(n, 0, 1000), mask(n, 1.0)),),
           ((rnd(m, 0, 1000), mask(m, 1.0)),), (None,), mask(n, 0.8), mask(m, 0.0), True,
           False)
    yield ("duplicate-heavy build (retry at a wider C)",
           ((rnd(100_000, 0, 400), mask(100_000, 1.0)),),
           ((rnd(4096, 0, 40), mask(4096, 1.0)),), (None,), mask(100_000, 0.9),
           mask(4096, 0.9), False, False)
    edge = torch.tensor([-(2**63), 2**63 - 1, -1, 0, 1], device=dev)
    yield ("INT64_MIN/MAX and negative keys",
           ((edge[rnd(100_003, 0, 5)], mask(100_003, 1.0)),),
           ((edge[rnd(1024, 0, 5)], mask(1024, 1.0)),), (None,), mask(100_003, 1.0),
           mask(1024, 0.3), False, False)
    # one build key on 3,000 rows: past the retries' classes of 128, 512 and
    # 2048 slots, so each probe row with it emits 3,000 slots, more than a
    # scan tile's rows; six such rows, two adjacent, two across a tile edge,
    # one the last row (its slots run into the tail)
    n, m = 20_003, 4096
    bkey = torch.cat([torch.full((3000,), 7, device=dev),
                      torch.arange(m - 3000, device=dev) + 10_000])
    pkey = rnd(n, 10_000, 12_000)
    pkey[torch.tensor([5, 6, 2047, 2048, 9_000, n - 1], device=dev)] = 7
    yield ("fan-out: one build key on 3000 rows", ((pkey, mask(n, 1.0)),),
           ((bkey, mask(m, 1.0)),), (None,), mask(n, 1.0) | (pkey == 7), mask(m, 1.0), False,
           True)
    # one bucket of exactly C build rows (the first slot class), then of C + 1
    # (the retry at the next class): key 7 on that many rows, every other
    # build key kept out of its bucket
    n, m = 100_003, 4096
    B = capacity_class(m)
    others = torch.arange(4 * m, device=dev) + 100
    others = others[HK.bucket_of([others], B) != HK.bucket_of([others.new_full((1,), 7)], B)]
    pkey = rnd(n, 0, 5000)
    pkey[::97] = 7
    for rows in (MK.DEFAULT_BUCKET_CAP, MK.DEFAULT_BUCKET_CAP + 1):
        bkey = torch.cat([others.new_full((rows,), 7), others[:m - rows]])
        yield (f"a bucket of exactly {rows} rows", ((pkey, mask(n, 1.0)),),
               ((bkey, mask(m, 1.0)),), (None,), mask(n, 0.9), mask(m, 1.0), False, False)
    # an inner join with no match: every output slot is past the total, so
    # hash_expand reads the last probe row's (empty) bucket
    n, m = 100_003, 50_000
    yield ("every build key NULL", ((rnd(n, 0, 1000), mask(n, 0.9)),),
           ((rnd(m, 0, 1000), mask(m, 0.0)),), (None,), mask(n, 0.8), mask(m, 1.0), False,
           False)
    yield ("a one-row build side", ((rnd(n, 0, 4), mask(n, 0.95)),),
           ((torch.tensor([2], device=dev), mask(1, 1.0)),), (None,), mask(n, 0.8),
           mask(1, 1.0), True, False)
    pkey, pvalid, pactive = rnd(n, 0, 400_000), mask(n, 0.9), mask(n, 0.7)
    pvalid[-1], pactive[-1] = False, False
    yield ("LEFT, inactive and NULL-key probe rows, the last one both",
           ((pkey, pvalid),), ((rnd(m, 0, 400_000), mask(m, 0.9)),), (None,), pactive,
           mask(m, 0.7), True, False)


def payload_cols(keys, n: int, dev, seed: int):
    """A join side's columns: its keys, then an int32 and a float64 column."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return list(keys) + [
        (torch.randint(-9, 9, (n,), generator=gen, device=dev, dtype=torch.int32),
         torch.rand(n, generator=gen, device=dev) < 0.9),
        (torch.rand(n, generator=gen, device=dev, dtype=torch.float64),
         torch.ones(n, dtype=torch.bool, device=dev)),
    ]


def same_probe(got: dict, want: dict, args) -> bool:
    """Everything hash_expand reads of hash_probe's output, and no less:
    counts, max_count and emit on every row; every occupied slot of every
    bucket below B, and slot 0 of each bucket an unmatched output slot
    reads (a LEFT join's active rows', and the last row's, whose bucket the
    slots past the total read); bucket_p and count on the active rows and
    the last row. The kernel leaves the rest unspecified. An attempt whose
    largest bucket overflows C is read only for its counts (the phase
    retries at a wider C): its table, count and emit are unspecified."""
    _, _, _, pa, _, B, C, left = args
    if int(want["max_count"]) > C:
        return all(torch.equal(got[k], want[k]) for k in ("counts", "max_count"))
    if not all(torch.equal(got[k], want[k]) for k in ("counts", "emit", "max_count")):
        return False
    rows = pa.clone() if left else torch.zeros_like(pa)
    rows[-1] = True
    read = torch.arange(C, device=pa.device) < want["counts"][:B, None].clamp(max=C)
    read[want["bucket_p"][rows].to(torch.int64), 0] = True
    rows = pa.clone()
    rows[-1] = True
    return (torch.equal(got["table"][:B][read], want["table"][:B][read])
            and all(torch.equal(got[k][rows], want[k][rows]) for k in ("bucket_p", "count")))


def same_join(HK, pargs, pcols, bcols) -> bool:
    """hash_expand on the kernel's probe output against hash_expand_plain on
    the plain probe output, over the whole joined page (inactive slots
    too), at the capacity the engine would give it."""
    got = HK.hash_probe(*pargs)
    want = HK.hash_probe_plain(*pargs)
    pkeys, bkeys, luts, pa = pargs[:4]
    cap = round_capacity(max(int(want["emit"].sum()), 1))
    return same_expand(
        HK.hash_expand(*expand_args(got, pkeys, bkeys, luts, pa, pcols, bcols, cap)),
        HK.hash_expand_plain(*expand_args(want, pkeys, bkeys, luts, pa, pcols, bcols, cap)))


def same_expand(got, want) -> bool:
    pairs = list(zip(got[0] + got[1], want[0] + want[1]))
    return torch.equal(got[2], want[2]) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in pairs)


def probe_args(HK, pkeys, bkeys, luts, pa, ba, left, past_limit=False):
    """hash_probe's arguments at the engine's table shape, retried once at
    the wider slot class as ``megakernels.probe_phase`` does (past the
    engine's table limit only where ``past_limit``)."""
    from trino_tpu_torch.runtime.capstore import capacity_class

    from trino_tpu_torch.ops import megakernels as MK

    B = capacity_class(int(ba.shape[0]))
    C = MK.DEFAULT_BUCKET_CAP
    need = int(HK.hash_probe_plain(pkeys, bkeys, luts, pa, ba, B, C, left)["max_count"])
    if need > C:
        C = capacity_class(need, base=8)
        if (B + 1) * C > MK.TABLE_ENTRY_LIMIT and not past_limit:
            fail(f"a join case past the table limit: B={B} C={C}")
    return (pkeys, bkeys, luts, pa, ba, B, C, left)


def expand_args(pr: dict, pkeys, bkeys, luts, pa, probe_cols, build_cols, cap=None):
    if cap is None:
        cap = round_capacity(max(int(pr["emit"].sum()), 1))
    return (pr["table"], pr["counts"], pr["bucket_p"], pr["count"], pr["emit"], pkeys,
            bkeys, luts, pa, probe_cols, build_cols, cap)


def probe_bound_whole_table(args) -> tuple:
    """The bound of the first design, which zeroed the whole table: every
    row's keys, validity and activity read on both sides, the whole [B+1, C]
    table and the counts written, and 12 bytes a probe row (bucket_p,
    count, emit)."""
    pkeys, bkeys, luts, pa, ba, B, C, _ = args
    n, m = pa.shape[0], ba.shape[0]
    lut = sum(l.numel() * 8 for l in luts if l is not None)
    nbytes = (n * (key_bytes(pkeys) + 1) + m * (key_bytes(bkeys) + 1) + lut
              + (B + 1) * C * 4 + (B + 1) * 4 + n * 12 + 4)
    return bound_ms(nbytes, 30 * (n + m))


def probe_bound(args) -> tuple:
    """Bytes hash_probe must move on these inputs, now that no later phase
    reads an empty slot or an inactive row's bucket: every probe row's
    activity, and the keys and validity of the active rows (and the last);
    the build side's activity and its active rows' keys; one 4-byte slot
    for each active build row with valid keys, counts and max_count; emit
    for every probe row, bucket_p (and on LEFT joins count) for the active
    rows and the last."""
    pkeys, bkeys, luts, pa, ba, B, C, left = args
    n, m = pa.shape[0], ba.shape[0]
    n_read = int(pa.sum()) + (0 if bool(pa[-1]) else 1)
    m_read = int(ba.sum())
    claimed = ba.clone()
    for _, v in bkeys:
        claimed &= v
    lut = sum(l.numel() * 8 for l in luts if l is not None)
    nbytes = (n + n_read * key_bytes(pkeys) + m + m_read * key_bytes(bkeys) + lut
              + int(claimed.sum()) * 4 + (B + 2) * 4 + 4 * n + n_read * (8 if left else 4))
    return bound_ms(nbytes, 30 * (n_read + m))


def share(bound: float, ms: float) -> str:
    """A kernel's time as a share of its bound; never above 100 %: a call
    faster than the bound found its inputs in the 50 MB L2 from the call
    before."""
    if ms <= 0 or bound > ms:
        return "faster than its bound (inputs left in L2 by the call before)"
    return f"{100 * bound / ms:.1f} % of its bound"


def phase_split(HK, name: str, args, reps: int = 10) -> dict:
    """Mean milliseconds of each phase of ``name``'s wrapper on these
    inputs (CUDA events from its ``phase_events``, over ``reps`` calls after
    one warm-up)."""
    getattr(HK, name)(*args)
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        getattr(HK, name)(*args, phase_events=spans)
    torch.cuda.synchronize()
    ms = {}
    for phase, a, b in spans:
        ms[phase] = ms.get(phase, 0.0) + a.elapsed_time(b) / reps
    return ms


def print_split(HK, name: str, label: str, args) -> None:
    """``name``'s phase split, stream operations a call and device time by
    kernel on these inputs."""
    ms = phase_split(HK, name, args)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
    print(f"  {name} [{label}] split (ms): {parts} (sum {sum(ms.values()):.4f}); "
          f"{ops_per_call(HK, name, args)} stream operations a call", flush=True)
    print_device_us(f"{name} [{label}]", lambda: getattr(HK, name)(*args))


def print_probe_bounds(label: str, args, ms: float) -> None:
    b, by = probe_bound(args)
    old, _ = probe_bound_whole_table(args)
    print(f"  hash_probe [{label}]: kernel {ms:.4f} ms, bound {b:.4f} ms ({by}; the "
          f"whole-table bound {old:.4f} ms), {share(b, ms)}", flush=True)


def expand_bound(args) -> tuple:
    """Bytes the expansion must move on these inputs: the scan reads emit
    whole; each output slot reads its probe row's count, bucket, keys and
    activity, the occupied slots of its bucket with their build keys, and
    one row of every column; it writes one row of every column and its
    activity."""
    table, counts, bucket_p, count, emit, pkeys, bkeys, _, pa, pcols, bcols, cap = args
    n = emit.shape[0]
    C = table.shape[1]
    rows = emit > 0  # bucket_p is unspecified on inactive rows
    occ = counts[bucket_p[rows].to(torch.int64)].clamp(max=C).to(torch.int64)
    slot_reads = int((emit[rows].to(torch.int64) * occ).sum())
    row = key_bytes(pcols) + key_bytes(bcols)
    nbytes = (n * 4 + cap * (4 + 4 + key_bytes(pkeys) + 1)
              + slot_reads * (4 + key_bytes(bkeys) - len(bkeys)) + cap * (2 * row + 1))
    return bound_ms(nbytes, cap * (2 * max(n, 2).bit_length() + 10 * C))


def segment_cases(HK, n_main: int, dev):
    """(label, values, weight, starts) cases for segment_sum; the first has
    the shape of Q3's joined rows at SF10 (4,194,304 slots, about four rows
    to a group, the active rows a prefix)."""
    from trino_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def case(label, n, group_rate, dtype=torch.int64, active_rate=1.0, head=0, pad=16):
        new_group = torch.rand(n, generator=gen, device=dev) < group_rate
        new_group[head] = True
        new_group[:head] = False
        n_act = int(n * active_rate)
        new_group[n_act:] = False
        starts = K.boundary_positions(new_group, int(new_group.sum()) + pad)
        if dtype == torch.bool:
            vals = torch.rand(n, generator=gen, device=dev) < 0.5
        else:
            vals = torch.randint(-(2**62), 2**62, (n,), generator=gen, device=dev).to(dtype)
        w = torch.rand(n, generator=gen, device=dev) < 0.9
        w[n_act:] = False
        return label, vals, w, starts

    def fixed(label, n, firsts, pad=16):
        """Groups starting at the rows ``firsts``, all rows active."""
        new_group = torch.zeros(n, dtype=torch.bool, device=dev)
        new_group[torch.tensor(sorted(set(firsts)), device=dev)] = True
        starts = K.boundary_positions(new_group, int(new_group.sum()) + pad)
        vals = torch.randint(-(2**62), 2**62, (n,), generator=gen, device=dev)
        return label, vals, torch.rand(n, generator=gen, device=dev) < 0.9, starts

    yield case("Q3 shape n=4194304", 4_194_304, 0.25, active_rate=0.75)
    yield case("one segment n=%d" % n_main, n_main, 0.0)
    tile = HK.SEGMENT_TILE_ROWS
    n = 40 * tile + 5
    # short groups, then one over 30 tiles (from inside tile 3), then short ones
    bounds = [0, 7, 100, 3 * tile + 11, 33 * tile + 1, 33 * tile + 2, 35 * tile]
    yield fixed("one group across 30 tiles", n, bounds)
    yield fixed("starts exactly on tile boundaries", n,
                list(range(0, n, tile)) + [5 * tile + 1, 9 * tile - 1])
    yield fixed("groups of one row", 3 * tile + 1, list(range(3 * tile + 1)))
    yield case("int32 values", 1_000_003, 0.01, torch.int32)
    yield case("bool values (a count)", 1_000_003, 0.3, torch.bool)
    yield case("rows before the first group", 500_001, 0.001, head=777)
    yield case("no padding slots", 300_000, 0.2, pad=0)
    yield case("n=1", 1, 1.0)


def segment_bound(args) -> tuple:
    values, _, starts = args
    n = values.shape[0]
    nbytes = n * (values.element_size() + 1) + starts.shape[0] * 16
    return bound_ms(nbytes, 3 * n * max(starts.shape[0], 2).bit_length())


# --------------------------------------------------------------------------- #
# the group sort and the repartition epilogue: cases, checks, bounds
# --------------------------------------------------------------------------- #

Q10_SLOTS = 2_097_152  # Q10's joined page at SF10: about 1.2M active rows


def q10_page(dev, gen):
    """A page shaped like Q10's joined page at SF10: 2,097,152 slots, the
    first 1,200,000 active, grouped on about 390,000 customers by
    (c_custkey bigint, c_name int32 code = c_custkey - 1, c_acctbal
    decimal(12,2)); the keys come from the join's build side, so they are
    NULL on the inactive slots; then the revenue decimal(18,4). Returns
    (key_cols, payload_cols, active)."""
    n, groups = Q10_SLOTS, 390_000
    cust = torch.randperm(1_500_000, generator=gen, device=dev)[:groups] + 1
    acct = torch.randint(-99_999, 999_999, (1_500_001,), generator=gen, device=dev)
    ck = cust[torch.randint(0, groups, (n,), generator=gen, device=dev)]
    active = torch.arange(n, device=dev) < 1_200_000
    keys = [(ck, active.clone()), ((ck - 1).to(torch.int32), active.clone()),
            (acct[ck], active.clone())]
    revenue = torch.randint(0, 10**11, (n,), generator=gen, device=dev)
    return keys, list(keys) + [(revenue, active.clone())], active


def group_sort_cases(HK, dev):
    """(label, key_cols, payload_cols, active) cases for group_sort; the
    first has the shape of Q10's joined page at SF10."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def rnd(n, lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)

    def mask(n, rate):
        return torch.rand(n, generator=gen, device=dev) < rate

    def case(label, keys, active):
        n = active.shape[0]
        vals = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        vals[rnd(n, 0, n)[:16]] = float("nan")
        return label, keys, list(keys) + [(vals, mask(n, 0.9))], active

    keys, payload, active = q10_page(dev, gen)
    yield "Q10 shape n=%d, 3 keys" % Q10_SLOTS, keys, payload, active
    # one active row whose keys are all NULL (a LEFT join's unmatched row):
    # validity differs from activity there, so the plan keeps the validity bits
    flip = [(d, v.clone()) for d, v in keys]
    for _, v in flip:
        v[12_345] = False
    yield ("Q10 shape, one active row with NULL keys", flip, flip + payload[len(keys):],
           active)
    del keys, payload, flip
    n = 300_007
    big = rnd(n, 0, 2**63 - 1)
    big[:2] = torch.tensor([0, 2**63 - 2], device=dev)  # a 63-bit range
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    yield case("a 64-bit plan (63-bit key and its NULLs)", [(big, mask(n, 0.9))], ones)
    yield case("a 65-bit plan (the same with inactive rows)", [(big, mask(n, 0.9))],
               mask(n, 0.8))
    tile = HK.SORT_TILE_ROWS
    for m in (tile - 1, tile, tile + 1):
        yield case(f"n={m} (a tile's rows{' - 1' if m < tile else ' + 1' if m > tile else ''})",
                   [(rnd(m, 0, 10**6), mask(m, 0.9))], mask(m, 0.8))
    yield case("every key sharing its low digit (one bucket takes every row)",
               [(rnd(n, 0, 10**5) * 256 + 7, ones)], ones)
    # one composite over 2- and 1-byte keys with NULLs: the carried keys are
    # written from the sorted composite, their NULL rows read at their old place
    yield case("int16, int8 and bool keys with NULLs in one composite", [
        (rnd(n, -300, 300, torch.int16), mask(n, 0.9)), (rnd(n, -100, 100, torch.int8),
                                                         mask(n, 0.9)),
        (mask(n, 0.5), mask(n, 0.9))], mask(n, 0.8))
    yield case("one key", [(rnd(n, 0, 5000), mask(n, 0.9))], mask(n, 0.8))
    yield case("five keys (int64, int32, int16, bool, float32)", [
        (rnd(n, 0, 6), mask(n, 0.95)), (rnd(n, -3, 3, torch.int32), mask(n, 0.95)),
        (rnd(n, 0, 4, torch.int16), mask(n, 0.95)), (mask(n, 0.5), mask(n, 0.95)),
        (rnd(n, 0, 5).to(torch.float32) / 2, mask(n, 0.95))], mask(n, 0.8))
    pool = torch.tensor([-0.0, 0.0, -1.5, 2.5, float("nan"), float("-inf"), float("inf"),
                         1e300, -3e-300], dtype=torch.float64, device=dev)
    yield case("DOUBLE key with -0.0, negatives and NaN",
               [(pool[rnd(n, 0, pool.shape[0])], mask(n, 0.9))], mask(n, 0.8))
    edge = torch.tensor([-(2**63), 2**63 - 1, -1, 0, 1], device=dev)
    yield case("INT64_MIN and INT64_MAX keys", [(edge[rnd(n, 0, 5)], mask(n, 0.9)),
                                                (rnd(n, 0, 3), mask(n, 1.0))], mask(n, 0.8))
    yield case("NULL keys", [(rnd(n, 0, 100), mask(n, 0.5)), (rnd(n, 0, 9), mask(n, 0.3))],
               mask(n, 0.9))
    yield case("inactive rows interleaved", [(rnd(n, 0, 1000), mask(n, 1.0))], mask(n, 0.5))
    yield case("all rows inactive", [(rnd(n, 0, 1000), mask(n, 0.9))], mask(n, 0.0))
    yield case("one group", [(torch.full((n,), 7, device=dev), ones)], ones.clone())
    yield case("all rows distinct", [(torch.randperm(n, generator=gen, device=dev), ones)],
               mask(n, 0.9))
    yield case("n=1", [(rnd(1, 0, 9), mask(1, 1.0))], mask(1, 1.0))


def epilogue_cases(dev):
    """(label, key_cols, luts, cols, active, n_parts) cases for
    partition_epilogue; the first is the Q10-shaped page at the engine's
    default partition count, its c_name key through a value-key LUT."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def rnd(n, lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)

    def mask(n, rate):
        return torch.rand(n, generator=gen, device=dev) < rate

    keys, payload, active = q10_page(dev, gen)
    name_lut = rnd(1_500_000, -(2**63), 2**63 - 1)
    yield ("Q10 shape n=%d, %d parts" % (Q10_SLOTS, Q10_PARTS), keys, [None, name_lut, None],
           payload, active, Q10_PARTS)
    n = 1_000_003
    big = (rnd(n, -(2**63), 2**63 - 1), mask(n, 0.95))
    code = (rnd(n, 0, 5000, torch.int32), mask(n, 0.9))
    lut = rnd(5000, -(2**63), 2**63 - 1)
    cols = [big, code, (torch.rand(n, generator=gen, device=dev, dtype=torch.float64),
                        mask(n, 1.0))]
    active = mask(n, 0.8)
    # 255 parts is the one-sweep path's largest (256 destinations), 256 the
    # three-launch path's smallest
    for parts in (1, 8, 64, 255, 256, 1024):
        yield f"bigint key, {parts} parts", [big], [None], cols, active, parts
    yield "NULL keys", [(big[0], mask(n, 0.5))], [None], cols, active, 64
    yield "a dictionary key", [code], [lut], cols, active, 64
    yield "two keys", [big, code], [None, lut], cols, active, 1024
    yield "no key", [], [], cols, active, 8
    yield "all rows inactive", [big], [None], cols, mask(n, 0.0), 8
    # past one gather set: the sweep also writes a permutation for the rest
    for parts in (8, 1024):
        yield f"19 columns (two gather sets), {parts} parts", [big], [None], cols * 6, active, parts
    # a page under one 4,096-row tile of the sweep, one row, one tile and a row
    for m in (1, 1000, 4097):
        small = [(d[:m], v[:m]) for d, v in cols]
        label = f"a page of {m} row{'s' if m > 1 else ''}"
        yield label, small[:1], [None], small, active[:m].clone(), 8


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Floats compared bit for bit (NaN, -0.0)."""
    return {torch.float64: lambda: t.view(torch.int64),
            torch.float32: lambda: t.view(torch.int32)}.get(t.dtype, lambda: t)()


def same_cols(got, want) -> bool:
    return len(got) == len(want) and all(
        torch.equal(_bits(a), _bits(b)) and torch.equal(av, bv)
        for (a, av), (b, bv) in zip(got, want))


def same_group_sort(got, want) -> bool:
    return (same_cols(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2]) and int(got[3]) == int(want[3]))


def same_epilogue(got, want) -> bool:
    return same_cols(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))


def page_bytes(cols) -> int:
    """Bytes of every distinct tensor among (data, valid) columns."""
    seen = {}
    for d, v in cols:
        for t in (d, v):
            if t is not None:
                seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def group_sort_bound(args) -> tuple:
    """Read the keys, the payload and the activity once; write the payload,
    the activity, new_group and the count."""
    keys, payload, active = args
    n = active.shape[0]
    nbytes = page_bytes(list(keys) + list(payload) + [(active, None)])
    nbytes += sum(d.numel() * d.element_size() + n for d, _ in payload) + 2 * n + 8
    return bound_ms(nbytes, 2 * n * len(keys))


def epilogue_bound(args) -> tuple:
    """Read the keys (and the LUT entries this page's codes use), the
    columns and the activity once; write the columns and the activity in
    partition order, and 16 bytes a partition."""
    keys, luts, cols, active, parts = args
    n = active.shape[0]
    lut_bytes = 0
    for (d, _), lut in zip(keys, luts):
        if lut is not None:
            lut_bytes += 8 * int(torch.unique(d).numel())
    nbytes = page_bytes(list(keys) + list(cols) + [(active, None)]) + lut_bytes
    nbytes += sum(d.numel() * d.element_size() + n for d, _ in cols) + n + 16 * parts
    return bound_ms(nbytes, 12 * n * max(len(keys), 1))


def sort_yardstick(key: torch.Tensor) -> float:
    """``torch.sort(stable=True)`` with indices on one int64 key of the
    page's length: the one torch call that does the sorting work of the two
    sorts (not the same function; recorded as their library_ms)."""
    k = key.to(torch.int64)
    return time_ms(lambda: torch.sort(k, stable=True))


def time_wrapper(HK, name, args) -> tuple:
    """(kernel ms, plain ms, library ms or None, bound ms, bound_by) of one
    wrapper on these inputs."""
    wrapper = getattr(HK, name)
    plain = getattr(HK, PLAIN[name])
    ms = time_ms(lambda: wrapper(*args))
    plain_ms = time_ms(lambda: plain(*args), reps=3)
    lib = None
    if name.startswith("grouped_sum"):
        v, w, gid, G = args
        gid64 = gid.to(torch.int64)
        pre = torch.where(w, v.to(torch.int64), 0)
        lib = time_ms(lambda: torch.zeros(G, dtype=torch.int64, device=v.device)
                      .index_add_(0, gid64, pre))
        b, by = bound_ms(v.shape[0] * (v.element_size() + 1 + 4) + G * 8, 2 * v.shape[0])
    elif name == "segment_sum":
        # index_add_ by each row's group (slot 0 takes the rows before the
        # first group), the group index computed before the timing
        v, w, starts = args
        rows = torch.arange(v.shape[0], device=v.device)
        gid1 = torch.searchsorted(starts, rows, right=True)
        pre = torch.where(w, v.to(torch.int64), 0)
        out = starts.shape[0] + 1
        lib = time_ms(lambda: torch.zeros(out, dtype=torch.int64, device=v.device)
                      .index_add_(0, gid1, pre))
        b, by = segment_bound(args)
    elif name == "hash_probe":
        b, by = probe_bound(args)
    elif name == "group_sort":
        lib = sort_yardstick(args[0][0][0])
        b, by = group_sort_bound(args)
    elif name == "partition_epilogue":
        lib = sort_yardstick(args[3])
        b, by = epilogue_bound(args)
    else:
        b, by = expand_bound(args)
    return ms, plain_ms, lib, b, by


PLAIN = {
    "grouped_sum_i64": "grouped_sum_plain", "grouped_sum_i32": "grouped_sum_plain",
    "hash_probe": "hash_probe_plain", "hash_expand": "hash_expand_plain",
    "segment_sum": "segment_sum_plain", "group_sort": "group_sort_plain",
    "partition_epilogue": "partition_epilogue_plain",
}


def same_result(HK, name, args) -> bool:
    got = getattr(HK, name)(*args)
    want = getattr(HK, PLAIN[name])(*args)
    torch.cuda.synchronize()
    if name == "hash_probe":
        return same_probe(got, want, args)
    if name == "hash_expand":
        return same_expand(got, want)
    if name == "group_sort":
        return same_group_sort(got, want)
    if name == "partition_epilogue":
        return same_epilogue(got, want)
    return torch.equal(got, want)


class LaunchTap:
    """Wraps kernel wrappers for the length of one query: CUDA events
    around each call give the time of the main path's own launches, and the
    inputs of one call per wrapper (the one ``keep`` scores highest, the
    later on ties; for the grouped sums the first) are kept, to be checked
    and timed again afterwards on the query's real distributions."""

    KEEP = {
        "hash_probe": lambda a: a[3].shape[0],  # the larger probe side
        "hash_expand": lambda a: a[8].shape[0],
        "segment_sum": lambda a: a[0].element_size(),  # a sum over a count
        "group_sort": lambda a: a[2].shape[0],
    }

    def __init__(self, HK, names, keep_all=()):
        self.HK = HK
        self.orig = {n: getattr(HK, n) for n in names}
        self.events = {n: [] for n in names}
        self.inputs = {}
        self.score = {}
        self.probes = []  # the inputs of every hash_probe call
        self.every = {n: [] for n in keep_all}  # every call's inputs, by name

    def __enter__(self):
        for name, fn in self.orig.items():
            def tapped(*args, _name=name, _fn=fn):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                self.events[_name].append((start, end))
                if _name == "hash_probe":
                    self.probes.append(args)
                if _name in self.every:
                    self.every[_name].append(args)
                keep = self.KEEP.get(_name)
                score = keep(args) if keep else 0
                if _name not in self.inputs or (keep and score >= self.score[_name]):
                    self.inputs[_name], self.score[_name] = args, score
                return out
            setattr(self.HK, name, tapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.HK, name, fn)

    def launch_ms(self, name) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[name]]


SHAPE_OF = {
    "hash_probe": lambda a: f"n={a[3].shape[0]} m={a[4].shape[0]} B={a[5]} C={a[6]}",
    "hash_expand": lambda a: (f"n={a[8].shape[0]} out={a[11]} C={a[0].shape[1]} "
                              f"columns={len(a[9])}+{len(a[10])}"),
    "segment_sum": lambda a: f"n={a[0].shape[0]} slots={a[2].shape[0]} {a[0].dtype}",
    "group_sort": lambda a: (f"n={a[2].shape[0]} keys={[str(d.dtype) for d, _ in a[0]]} "
                             f"active={int(a[2].sum())} columns={len(a[1])}"),
    "partition_epilogue": lambda a: (f"n={a[3].shape[0]} keys={len(a[0])} parts={a[4]} "
                                     f"active={int(a[3].sum())} columns={len(a[2])}"),
}


def record(results: dict, name: str, query: str, timing: tuple, recorded: set) -> None:
    """The kernels line keeps each kernel's times on the first query whose
    path launched it (Q3's for the hash join and the segment sums, Q10's
    for the group sort); later queries' times are printed only."""
    if name in recorded:
        return
    ms, plain, lib, b, by = timing
    results[name].update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
    recorded.add(name)


def check_query_inputs(HK, query: str, tap: LaunchTap, results: dict, recorded: set) -> None:
    """Each kernel on the inputs the query's path gave it: bit-exact against
    its plain version, timed beside its bound; these times replace the
    synthetic cases' in the kernels line."""
    for name in tap.orig:
        in_run = tap.launch_ms(name)
        args = tap.inputs[name]
        if not same_result(HK, name, args):
            fail(f"{name} [{query} inputs] differs from its plain version")
        shape = SHAPE_OF.get(name, lambda a: f"n={a[0].shape[0]} G={a[3]}")(args)
        print(f"  {name} [{query} inputs {shape}]: bit-exact", flush=True)
        if name.startswith("grouped_sum"):
            v, w, gid, G = args
            counts = torch.bincount(gid[w].to(torch.int64), minlength=G)
            print(f"  {name}: weight share {float(w.float().mean()):.4f}, rows per "
                  f"group {counts.tolist()}", flush=True)
        print(f"  {name}: {len(in_run)} launches inside {query}, "
              f"{sum(in_run):.4f} ms in all, each {[round(t, 4) for t in in_run]}",
              flush=True)
        timing = time_wrapper(HK, name, args)
        print_timing(f"{name} [{query} inputs]", timing)
        if name == "hash_expand":
            scan, slots = expand_split_ms(HK, args)
            print(f"  hash_expand [{query} inputs]: scan pass {scan:.4f} ms, slot-and-gather "
                  f"pass {slots:.4f} ms", flush=True)
        elif name == "group_sort":
            plan = sort_split(HK, f"{query} inputs", args)
            if plan != [64]:
                fail(f"group_sort [{query} inputs] sorted composites {plan}, not one of 64 bits")
        elif name == "segment_sum":
            print(f"  segment_sum [{query} inputs]: {ops_per_call(HK, name, args)} stream "
                  "operations a call", flush=True)
            print_device_us(f"segment_sum [{query} inputs]", lambda: HK.segment_sum(*args))
        record(results, name, query, timing, recorded)


def check_every_probe(HK, query: str, tap: LaunchTap) -> None:
    """hash_probe on the inputs of each of the query's joins: bit-exact
    against its plain version, hash_expand over the whole joined page on
    its output (each side's keys and two payload columns), timed beside its
    bounds, with its phase split and device time by kernel."""
    for k, args in enumerate(tap.probes):
        label = f"{query} join {k + 1}"
        if not same_result(HK, "hash_probe", args):
            fail(f"hash_probe [{label}] differs from its plain version")
        pkeys, bkeys, _, pa, ba = args[:5]
        pcols = payload_cols(pkeys, pa.shape[0], pa.device, 30 + k)
        bcols = payload_cols(bkeys, ba.shape[0], pa.device, 40 + k)
        if not same_join(HK, args, pcols, bcols):
            fail(f"hash_expand on hash_probe's output [{label}] differs from the plain join")
        del pcols, bcols
        print(f"  hash_probe [{label} {SHAPE_OF['hash_probe'](args)}]: bit-exact, and the "
              "whole joined page", flush=True)
        print_probe_bounds(label, args, time_ms(lambda: HK.hash_probe(*args)))
        print_split(HK, "hash_probe", label, args)


def expand_split_ms(HK, args, reps: int = 10) -> tuple:
    """Mean milliseconds of hash_expand's scan pass and of its slot pass
    (with the gather) on these inputs: CUDA events recorded just before the
    scan, between the passes and after the slot pass, after one warm-up."""
    HK.hash_expand(*args)
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        HK.hash_expand(*args, phase_events=ev)
        marks.append(ev)
    torch.cuda.synchronize()
    return (sum(a.elapsed_time(b) for a, b, _ in marks) / reps,
            sum(b.elapsed_time(c) for _, b, c in marks) / reps)


def print_timing(label: str, timing: tuple) -> None:
    ms, plain, lib, b, by = timing
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {b:.4f} ms ({by})",
          flush=True)


def check_epilogue_on_q10(HK, conn, tap: LaunchTap, results: dict, recorded: set) -> None:
    """The repartition epilogue, which no query path calls, on the page
    Q10's group sort was given: its three group keys at the engine's
    default partition count, c_name through its dictionary's value keys."""
    keys, payload, active = tap.inputs["group_sort"]
    t0 = time.perf_counter()
    names = conn.dictionary("customer", "c_name", SCALE)
    name_lut = torch.as_tensor(names.value_keys(), device=active.device)
    print(f"  c_name value keys ({len(names)} strings): {time.perf_counter() - t0:.3f} s "
          "on the host", flush=True)
    luts = [name_lut if d.dtype == torch.int32 else None for d, _ in keys]
    args = (keys, luts, payload, active, Q10_PARTS)
    if not same_result(HK, "partition_epilogue", args):
        fail("partition_epilogue [q10 joined page] differs from its plain version")
    print(f"  partition_epilogue [q10 joined page {SHAPE_OF['partition_epilogue'](args)}]: "
          "bit-exact", flush=True)
    timing = time_wrapper(HK, "partition_epilogue", args)
    print_timing("partition_epilogue [q10 joined page]", timing)
    print_split(HK, "partition_epilogue", "q10 joined page", args)
    record(results, "partition_epilogue", "q10", timing, recorded)


def sort_plan(HK, args) -> list:
    """Bits of each composite key the group sort's plan packs these keys
    into (least significant first)."""
    keys, _, active = args
    plan = HK.radix_plan(HK.group_sort_stats_plain(keys, active), active.shape[0])
    return [sum(f[3] for f in comp) for comp in plan]


def ops_per_call(HK, name, args) -> int:
    """Kernel launches and memsets of one call of ``name``'s wrapper."""
    torch.cuda.synchronize()
    before = HK.stream_ops(name)
    getattr(HK, name)(*args)
    torch.cuda.synchronize()
    return HK.stream_ops(name) - before


def device_us(fn, reps: int = 10) -> dict:
    """Microseconds of device time a call of ``fn`` spends in each kernel
    and memset, by name (``torch.profiler`` over ``reps`` calls after one
    warm-up; empty where the profiler sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip() or ev.key[:40]
            out[name] = out.get(name, 0.0) + us / reps
    return out


def print_device_us(label: str, fn) -> None:
    try:
        us = device_us(fn)
    except (AssertionError, RuntimeError) as e:  # a profiler that cannot trace the card
        print(f"  {label}: device time by kernel not measured ({e})", flush=True)
        return
    if not us:
        print(f"  {label}: device time by kernel not measured (the profiler saw no "
              "device activity)", flush=True)
        return
    parts = ", ".join(f"{k} {v:.1f}" for k, v in sorted(us.items(), key=lambda kv: -kv[1]))
    print(f"  {label}: device us a call {sum(us.values()):.1f} ({parts})", flush=True)


def sort_split(HK, label: str, args, reps: int = 10) -> list:
    """Print group_sort's time by phase on these inputs (CUDA events from
    its ``phase_events``, means over ``reps`` calls after one warm-up), its
    plan and its stream operations a call; return the plan's composite
    widths."""
    ms = phase_split(HK, "group_sort", args, reps)
    print_device_us(f"group_sort [{label}]", lambda: HK.group_sort(*args))
    key = args[0][0][0].to(torch.int64)
    print_device_us(f"torch.sort yardstick [{label}]", lambda: torch.sort(key, stable=True))
    bits = sort_plan(HK, args)
    passes = sum(-(-b // 8) for b in bits)
    print(f"  group_sort [{label}] split: stats and host read {ms['stats']:.4f} ms, compose "
          f"{ms['compose']:.4f} ms, radix passes {ms['passes']:.4f} ms, finish and gather "
          f"{ms['finish']:.4f} ms (sum {sum(ms.values()):.4f}); composites {bits}, "
          f"{passes} passes, {ops_per_call(HK, 'group_sort', args)} stream operations a "
          "call", flush=True)
    return bits


# the composite widths group_sort's plan must give the cases that test it
SORT_PLANS = {0: [64], 1: [44, 23], 2: [64], 3: [64, 1]}


def check_sort_kernels(HK, dev, results: dict) -> None:
    """group_sort and partition_epilogue against their plain versions on
    every case; the first (Q10-shaped) case of each is timed and
    group_sort's split printed."""
    for i, (label, keys, payload, active) in enumerate(group_sort_cases(HK, dev)):
        args = (keys, payload, active)
        if not same_result(HK, "group_sort", args):
            fail(f"group_sort [{label}] differs from its plain version")
        plan = sort_plan(HK, args)
        print(f"  group_sort [{label}]: bit-exact "
              f"({int(HK.group_sort_plain(*args)[3])} groups, composites {plan})", flush=True)
        if i in SORT_PLANS and plan != SORT_PLANS[i]:
            fail(f"group_sort [{label}] planned composites {plan}, not {SORT_PLANS[i]}")
        if i == 0:
            results["group_sort"] = timed_entry(HK, "group_sort", args)
            sort_split(HK, "main shape", args)
        del args, keys, payload, active
    torch.cuda.empty_cache()
    for i, (label, keys, luts, cols, active, parts) in enumerate(epilogue_cases(dev)):
        args = (keys, luts, cols, active, parts)
        if not same_result(HK, "partition_epilogue", args):
            fail(f"partition_epilogue [{label}] differs from its plain version")
        print(f"  partition_epilogue [{label}]: bit-exact", flush=True)
        if i == 0:
            results["partition_epilogue"] = timed_entry(HK, "partition_epilogue", args)
            print_split(HK, "partition_epilogue", "main shape", args)
        del args, keys, luts, cols, active


def check_join_kernels(HK, n_main: int, dev, results: dict) -> None:
    """hash_probe, hash_expand and segment_sum against their plain versions
    on every case; the first (main-shape) case of each is timed."""
    cases = enumerate(join_cases(HK, n_main, dev))
    for i, (label, pkeys, bkeys, luts, pa, ba, left, past_limit) in cases:
        pargs = probe_args(HK, pkeys, bkeys, luts, pa, ba, left, past_limit)
        if not same_result(HK, "hash_probe", pargs):
            fail(f"hash_probe [{label}] differs from its plain version")
        pr = HK.hash_probe(*pargs)
        pcols = payload_cols(pkeys, pa.shape[0], dev, 10 + i)
        bcols = payload_cols(bkeys, ba.shape[0], dev, 20 + i)
        if not same_join(HK, pargs, pcols, bcols):
            fail(f"hash_expand on hash_probe's output [{label}] differs from the plain join")
        eargs = expand_args(pr, pkeys, bkeys, luts, pa, pcols, bcols)
        if not same_result(HK, "hash_expand", eargs):
            fail(f"hash_expand [{label}] differs from its plain version")
        total = int(pr["emit"].sum())
        # out_capacity below the total: the slots past it are dropped
        short = expand_args(pr, pkeys, bkeys, luts, pa, pcols, bcols, max(1, total // 3))
        if not same_result(HK, "hash_expand", short):
            fail(f"hash_expand [{label}, out_capacity {short[-1]} < {total}] differs "
                 "from its plain version")
        # past one gather set: the slot pass saves its rows for a gather pass
        wide = expand_args(pr, pkeys, bkeys, luts, pa, pcols * 3, bcols * 3)
        n_wide = 3 * len(pcols + bcols)
        if i == 1 and not same_result(HK, "hash_expand", wide):
            fail(f"hash_expand [{label}, {n_wide} columns] differs from its plain version")
        print(f"  hash_probe, hash_expand [{label}]: bit-exact (C={pargs[6]}, {total} output "
              f"rows, most from one probe row {int(pr['emit'].max())}; and at out_capacity "
              f"{short[-1]}{f'; and with {n_wide} columns' if i == 1 else ''})", flush=True)
        if i == 0:
            for name, args in (("hash_probe", pargs), ("hash_expand", eargs)):
                results[name] = timed_entry(HK, name, args)
            print_probe_bounds("main shape", pargs, results["hash_probe"]["ms"])
            print_split(HK, "hash_probe", "main shape", pargs)
            scan, slots = expand_split_ms(HK, eargs)
            print(f"  hash_expand [main shape]: scan pass {scan:.4f} ms, slot-and-gather pass "
                  f"{slots:.4f} ms", flush=True)
        del pr, pargs, eargs, short, wide, pcols, bcols
    torch.cuda.empty_cache()
    for i, (label, v, w, starts) in enumerate(segment_cases(HK, n_main, dev)):
        if not same_result(HK, "segment_sum", (v, w, starts)):
            fail(f"segment_sum [{label}] differs from its plain version")
        print(f"  segment_sum [{label}]: bit-exact ({starts.shape[0]} slots)", flush=True)
        if i == 0:
            results["segment_sum"] = timed_entry(HK, "segment_sum", (v, w, starts))
            print(f"  segment_sum: {ops_per_call(HK, 'segment_sum', (v, w, starts))} stream "
                  "operations a call", flush=True)
            print_device_us("segment_sum [main shape]", lambda: HK.segment_sum(v, w, starts))


SOURCES = {
    "grouped_sum_i64": ("trino_tpu_torch/csrc/grouped_sum.cu",
                        "trino_tpu/ops/pallas_kernels.py:217"),
    "grouped_sum_i32": ("trino_tpu_torch/csrc/grouped_sum.cu",
                        "trino_tpu/ops/pallas_kernels.py:238"),
    "q6_fused": ("trino_tpu_torch/csrc/q6.cu", "trino_tpu/ops/pallas_kernels.py:64"),
    "hash_probe": ("trino_tpu_torch/csrc/hash_probe.cu",
                   "trino_tpu/ops/megakernels.py:320"),
    "hash_expand": ("trino_tpu_torch/csrc/hash_expand.cu",
                    "trino_tpu/ops/megakernels.py:468"),
    "segment_sum": ("trino_tpu_torch/csrc/segment_agg.cu",
                    "trino_tpu/ops/megakernels.py:573"),
    "group_sort": ("trino_tpu_torch/csrc/group_sort.cu",
                   "trino_tpu/ops/megakernels.py:533"),
    "partition_epilogue": ("trino_tpu_torch/csrc/partition_epilogue.cu",
                           "trino_tpu/ops/megakernels.py:603"),
}


def timed_entry(HK, name, args) -> dict:
    ms, plain, lib, b, by = timing = time_wrapper(HK, name, args)
    print_timing(f"{name} [main shape]", timing)
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": 0, "ms": ms, "plain_ms": plain, "bound_ms": b,
        "bound_by": by, "library_ms": lib,
    }


def check_kernels(HK, n_main: int, dev) -> dict:
    """Every wrapper against its plain version; timings at the main shape."""
    results = {}
    for name, vdtype in (("grouped_sum_i64", torch.int64), ("grouped_sum_i32", torch.int32)):
        wrapper = getattr(HK, name)
        for i, (label, vals, w, gid, G, (ov, ow, og)) in enumerate(grouped_cases(n_main, dev)):
            n = max(vals.shape[0] - max(ov, ow, og), 0)
            v = vals.to(vdtype)[ov:ov + n]
            w, gid = w[ow:ow + n], gid[og:og + n]
            got = wrapper(v, w, gid, G)
            want = HK.grouped_sum_plain(v, w, gid, G)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} [{label}] differs from its plain version: "
                     f"{got.tolist()[:8]} vs {want.tolist()[:8]}")
            timing = ""
            if i == 0:
                results[name] = timed_entry(HK, name, (v, w, gid, G))
            elif n >= n_main - 1:
                timing = f", kernel {time_ms(lambda: wrapper(v, w, gid, G)):.4f} ms"
            print(f"  {name} [{label}]: bit-exact{timing}", flush=True)
            del v, w, gid, vals

    worst = 0
    timing = None
    for label, cols in q6_cases(n_main, dev):
        got = HK.q6_fused(*cols, *Q6_PRED)
        want = HK.q6_plain(*cols, *Q6_PRED)
        torch.cuda.synchronize()
        worst = max(worst, int((got - want).abs()))
        if not torch.equal(got, want):
            fail(f"q6_fused [{label}] differs: {int(got)} vs {int(want)}")
        print(f"  q6_fused [{label}]: bit-exact ({int(got)})", flush=True)
        if timing is None:
            n = cols[0].shape[0]
            ms = time_ms(lambda: HK.q6_fused(*cols, *Q6_PRED))
            plain = time_ms(lambda: HK.q6_plain(*cols, *Q6_PRED))
            b, by = bound_ms(n * 20 + 8, 8 * n)
            timing = (ms, plain, b, by)
    ms, plain, b, by = timing
    results["q6_fused"] = {
        "name": "q6_fused", "route": "cuda", "source": "trino_tpu_torch/csrc/q6.cu",
        "replaces": "trino_tpu/ops/pallas_kernels.py:64",
        "launches": 0, "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }
    print(f"  q6_fused: kernel {ms:.4f} ms, plain {plain:.4f} ms, no single "
          f"torch call, bound {b:.4f} ms ({by})", flush=True)
    return results


# --------------------------------------------------------------------------- #
# phase 3: Q6, Q1, Q3 and Q10 at SF10
# --------------------------------------------------------------------------- #


def splits_of(g, conn, table: str):
    total = conn.split_count(table, SCALE)
    for s in range(total):
        yield g.generate_split(table, SCALE, s, total).columns


def order_sets(g, conn):
    """One pass over the orders splits: Q3's qualifying orders sorted by
    key, (keys, dates, ship priorities) of orders before 1995-03-15 placed
    by BUILDING customers; and Q10's, (keys, customer keys) of orders from
    1993-10-01 to before 1994-01-01 placed by customers of a nation."""
    seg = conn.dictionary("customer", "c_mktsegment", SCALE).code_of("BUILDING")
    nations = np.concatenate([d["n_nationkey"] for d in splits_of(g, conn, "nation")])
    building, with_nation = [], []
    for d in splits_of(g, conn, "customer"):
        building.append(d["c_custkey"][d["c_mktsegment"] == seg])
        with_nation.append(d["c_custkey"][np.isin(d["c_nationkey"], nations)])
    building, with_nation = np.concatenate(building), np.concatenate(with_nation)
    q3 = ([], [], [])
    q10 = ([], [])
    lo, hi = Q10_DATES
    for d in splits_of(g, conn, "orders"):
        keep = (d["o_orderdate"] < Q3_DATE) & np.isin(d["o_custkey"], building)
        for acc, col in zip(q3, ("o_orderkey", "o_orderdate", "o_shippriority")):
            acc.append(d[col][keep])
        keep = ((d["o_orderdate"] >= lo) & (d["o_orderdate"] < hi)
                & np.isin(d["o_custkey"], with_nation))
        for acc, col in zip(q10, ("o_orderkey", "o_custkey")):
            acc.append(d[col][keep])
    q3 = [np.concatenate(x) for x in q3]
    q10 = [np.concatenate(x) for x in q10]
    o3, o10 = np.argsort(q3[0], kind="stable"), np.argsort(q10[0], kind="stable")
    return [x[o3] for x in q3], [x[o10] for x in q10]


def q10_top(g, conn, ocust, order_rev, order_rows):
    """Q10's top 20 customers from the revenue of each qualifying order's
    lineitem rows, in the engine's row form."""
    hit = order_rows > 0
    cust, inv = np.unique(ocust[hit], return_inverse=True)
    rev = np.zeros(cust.shape[0], dtype=np.int64)
    np.add.at(rev, inv, order_rev[hit])
    top = np.lexsort((cust, -rev))[:20]
    parts = [(d["c_custkey"], d["c_name"], d["c_acctbal"]) for d in splits_of(g, conn, "customer")]
    ckey, code, bal = (np.concatenate(x) for x in zip(*parts))
    order = np.argsort(ckey, kind="stable")
    at = order[np.searchsorted(ckey[order], cust[top])]
    names = conn.dictionary("customer", "c_name", SCALE)
    print(f"  Q10 has {cust.shape[0]} groups", flush=True)
    return [(int(cust[i]), names.values[int(code[j])], int(rev[i]) / 10**4, int(bal[j]) / 100)
            for i, j in zip(top, at)]


Q1_SHIPDATE = 10471  # DATE '1998-12-01' - INTERVAL '90' DAY


def q1_split_sums(d, G) -> np.ndarray:
    """Q1's sums of one lineitem split's host arrays ``d``, int64 by
    (returnflag, linestatus) code: qty, price, disc_price, charge, disc,
    count."""
    acc = np.zeros((6,) + tuple(G), dtype=np.int64)
    qty = d["l_quantity"].astype(np.int64)
    price = d["l_extendedprice"].astype(np.int64)
    disc = d["l_discount"].astype(np.int64)
    tax = d["l_tax"].astype(np.int64)
    keep = d["l_shipdate"] <= Q1_SHIPDATE
    flat = d["l_returnflag"].astype(np.int64) * G[1] + d["l_linestatus"]
    dp = price * (100 - disc)
    for gi in np.unique(flat[keep]):
        m = keep & (flat == gi)
        a, b = divmod(int(gi), G[1])
        for i, v in enumerate((qty, price, dp, dp * (100 + tax), disc)):
            acc[i, a, b] += v[m].sum(dtype=np.int64)
        acc[5, a, b] += int(m.sum())
    return acc


def _avg(s, n):  # round-half-up decimal avg, as the engine computes it
    half = n // 2
    return (s + half) // n if s >= 0 else -((-s + half) // n)


def q1_rows(acc, rf, ls) -> list:
    """Q1's rows, in the engine's output form, from its int64 sums."""
    rows = []
    for a in range(acc.shape[1]):
        for b in range(acc.shape[2]):
            n = int(acc[5, a, b])
            if n == 0:
                continue
            sq, sp, sd, sc, sdisc = (int(acc[i, a, b]) for i in range(5))
            rows.append((
                rf.values[a], ls.values[b], sq / 100, sp / 100, sd / 10**4,
                sc / 10**6, _avg(sq, n) / 100, _avg(sp, n) / 100, _avg(sdisc, n) / 100, n,
            ))
    return rows


def numpy_oracle(g, conn):
    """Q1's sums and counts, Q6's revenue, Q3's top orders and Q10's top
    customers from the port's generator, in numpy int64, as rows in the
    engine's output form. One pass over the lineitem splits serves all
    four."""
    import datetime

    (okeys, odates, oprio), (k10, c10) = order_sets(g, conn)
    q3_rev = np.zeros(okeys.shape[0], dtype=np.int64)
    q3_rows = np.zeros(okeys.shape[0], dtype=np.int64)
    q10_rev = np.zeros(k10.shape[0], dtype=np.int64)
    q10_rows = np.zeros(k10.shape[0], dtype=np.int64)
    total = conn.split_count("lineitem", SCALE)
    rf = conn.dictionary("lineitem", "l_returnflag", SCALE)
    ls = conn.dictionary("lineitem", "l_linestatus", SCALE)
    flag_r = rf.code_of("R")
    G = (len(rf), len(ls))
    acc = np.zeros((6,) + G, dtype=np.int64)  # qty, price, disc_price, charge, disc, count
    revenue = np.int64(0)
    gen_secs = 0.0
    for s in range(total):
        t0 = time.perf_counter()
        d = g.generate_split("lineitem", SCALE, s, total).columns
        gen_secs += time.perf_counter() - t0
        acc += q1_split_sums(d, G)
        qty = d["l_quantity"].astype(np.int64)
        price = d["l_extendedprice"].astype(np.int64)
        disc = d["l_discount"].astype(np.int64)
        ship = d["l_shipdate"].astype(np.int64)
        dp = price * (100 - disc)
        lo, hi, dlo, dhi, qhi = Q6_PRED
        k6 = (ship >= lo) & (ship < hi) & (disc >= dlo) & (disc <= dhi) & (qty < qhi)
        revenue += (price * disc)[k6].sum(dtype=np.int64)
        lk = d["l_orderkey"]
        pos = np.minimum(np.searchsorted(okeys, lk), max(okeys.shape[0] - 1, 0))
        hit = (ship > Q3_DATE) & (okeys[pos] == lk)
        np.add.at(q3_rev, pos[hit], dp[hit])
        np.add.at(q3_rows, pos[hit], 1)
        pos = np.minimum(np.searchsorted(k10, lk), max(k10.shape[0] - 1, 0))
        hit = (d["l_returnflag"] == flag_r) & (k10[pos] == lk)
        np.add.at(q10_rev, pos[hit], dp[hit])
        np.add.at(q10_rows, pos[hit], 1)

    q1 = q1_rows(acc, rf, ls)
    grp = np.nonzero(q3_rows)[0]
    top = grp[np.lexsort((okeys[grp], odates[grp], -q3_rev[grp]))][:10]
    epoch = datetime.date(1970, 1, 1)
    q3 = [(int(okeys[i]), int(q3_rev[i]) / 10**4,
           epoch + datetime.timedelta(days=int(odates[i])), int(oprio[i])) for i in top]
    print(f"  generating the {total} lineitem splits on the host: "
          f"{gen_secs:.3f} s of the oracle's pass; Q3 has {grp.shape[0]} groups",
          flush=True)
    q10 = q10_top(g, conn, c10, q10_rev, q10_rows)
    return {"q01": q1, "q06": [(int(revenue) / 10**4,)], "q03": q3, "q10": q10}


REL_TOL = 1e-9  # DOUBLE values; everything else compares exactly


def same_value(got, want, is_double: bool) -> bool:
    if not is_double or got is None or want is None:
        return got == want and type(got) is type(want)
    if got != got or want != want:  # NaN equals NaN
        return got != got and want != want
    return got == want or abs(got - want) <= REL_TOL * max(abs(got), abs(want))


def same_rows(got: list, want: list, doubles) -> bool:
    """Row for row, in order; the columns flagged in ``doubles`` at
    ``REL_TOL`` relative."""
    return len(got) == len(want) and all(
        len(g) == len(w) and all(same_value(a, b, d) for a, b, d in zip(g, w, doubles))
        for g, w in zip(got, want))


def double_columns(res) -> list:
    return [t.display() == "double" for t in res.column_types]


def run_default(HK, runner, sql: str, kernel_names, keep_all=()) -> tuple:
    """One run of ``sql`` with the runner's session, every count set to 0
    just before it and read just after, through a LaunchTap of
    ``kernel_names`` (keeping every call's inputs of ``keep_all``). Returns
    (result, wall s, HK launches, fused phases, fallbacks, tap)."""
    from trino_tpu_torch.ops import megakernels as MK

    tap = LaunchTap(HK, kernel_names, keep_all)
    torch.cuda.synchronize()
    HK.reset_launch_counts()
    MK.reset_counts()
    t0 = time.perf_counter()
    with tap:
        res = runner.execute(sql)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, dict(HK.LAUNCHES), dict(MK.LAUNCHES), dict(MK.FALLBACKS), tap


def run_off(HK, off, sql: str) -> tuple:
    """One run with the kernel tier off (result, wall s); fails if anything
    launched."""
    from trino_tpu_torch.ops import megakernels as MK

    HK.reset_launch_counts()
    MK.reset_counts()
    t0 = time.perf_counter()
    res = off.execute(sql)
    torch.cuda.synchronize()
    if any(HK.LAUNCHES.values()) or any(MK.LAUNCHES.values()):
        fail(f"the kernel tier off launched {HK.LAUNCHES} {MK.LAUNCHES}")
    return res, time.perf_counter() - t0


def off_runner(dev, scale, benchmark="tpch"):
    """A runner over ``benchmark``'s connector with the kernel tier off."""
    from trino_tpu_torch.runtime import LocalQueryRunner

    off = getattr(LocalQueryRunner, benchmark)(scale=scale, device=dev)
    off.session.set("pallas_aggregation", "off")
    off.session.set("pallas_fusion", False)
    return off


def run_queries(HK, dev, kernels: dict) -> tuple:
    """Each query with the default session (counts set to 0 just before,
    read just after; the kernels checked and timed on its inputs), then
    with the kernel tier off, then the numpy oracle. Returns the launch
    counts of the default runs, their rows and their peak device memory,
    by query."""
    from trino_tpu_torch.connectors.tpch import generator as g
    from trino_tpu_torch.runtime import LocalQueryRunner

    runner = LocalQueryRunner.tpch(scale=SCALE, device=dev)
    rows, launches, recorded, peaks = {}, {}, set(), {}
    for q, sql in QUERIES.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches[q], phases, fallbacks, tap = run_default(
            HK, runner, sql, [k for k in KERNELS_OF[q] if k != "q6_fused"])
        peaks[q] = torch.cuda.max_memory_allocated()
        rows[q] = res.rows
        INCORE_WALLS[q] = wall
        print(f"  {q} SF{SCALE} default session: {wall:.3f} s wall, peak device memory "
              f"{peaks[q]} bytes, {len(res.rows)} rows, launches {launches[q]}, fused phases "
              f"{phases}, fallbacks {fallbacks}", flush=True)
        if fallbacks:
            fail(f"{q} fell back from the fused path: {fallbacks}")
        for name in tap.orig:
            if launches[q][name] == 0:
                fail(f"{q} did not go through {name}: {launches[q]}")
        want_phases = PHASES_OF.get(q, {})
        if any(phases[k] != v for k, v in want_phases.items()):
            fail(f"{q} ran the fused phases {phases}, not {want_phases}")
        check_query_inputs(HK, q, tap, kernels, recorded)
        if q in ("q03", "q10"):
            check_every_probe(HK, q, tap)
        if q == "q10":
            check_epilogue_on_q10(HK, runner.catalogs.get("tpch"), tap, kernels, recorded)
        del tap, res
        torch.cuda.empty_cache()

    off = off_runner(dev, SCALE)
    for q, sql in QUERIES.items():
        res, wall = run_off(HK, off, sql)
        if res.rows != rows[q]:
            fail(f"{q}: default rows {rows[q]} != kernel-tier-off rows {res.rows}")
        print(f"  {q} SF{SCALE} {OFF_SESSION[q][0]}={OFF_SESSION[q][1]}: {wall:.3f} s wall, "
              "rows identical", flush=True)
        del res
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    want = numpy_oracle(g, runner.catalogs.get("tpch"))
    print(f"  numpy oracle: {time.perf_counter() - t0:.3f} s", flush=True)
    for q in QUERIES:
        if rows[q] != want[q]:
            fail(f"{q} rows {rows[q]} != numpy oracle {want[q]}")
    print(f"  q01, q06, q03 and q10 rows equal the numpy oracle; q06 {rows['q06']}, "
          f"q03 {rows['q03']}, q10 {rows['q10'][:3]}...", flush=True)
    return launches, rows, peaks


# --------------------------------------------------------------------------- #
# phase 4: Q14 and Q18 at SF10
# --------------------------------------------------------------------------- #

# Q18 with TPC-H's own quantity threshold (300); tests/tpch_corpus.py's text
# uses 150, which suits SF0.01, and runs at SF1 in phase 5
Q18_SF10 = """
        SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
               sum(l_quantity)
        FROM customer, orders, lineitem
        WHERE o_orderkey IN (
            SELECT l_orderkey FROM lineitem
            GROUP BY l_orderkey HAVING sum(l_quantity) > 300
          )
          AND c_custkey = o_custkey
          AND o_orderkey = l_orderkey
        GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
        ORDER BY o_totalprice DESC, o_orderdate, o_orderkey
        LIMIT 100
    """
Q14_DATES = (9374, 9404)  # 1995-09-01, 1995-10-01
Q18_QTY = 30000  # 300.00 at l_quantity's scale
# the fused phases each must run, and the kernels each launches
NEW_PHASES_OF = {"q14": {"probe": 1, "expand": 1, "aggregate": 0, "group_sort": 0},
                 "q18": {"probe": 2, "expand": 2, "aggregate": 0, "group_sort": 0}}
JOIN_KERNELS = ("hash_probe", "hash_expand")
# every wrapper a query's path can launch
PATH_KERNELS = ("grouped_sum_i64", "grouped_sum_i32", "hash_probe", "hash_expand",
                "segment_sum", "group_sort")
def q14_q18_oracle(g, conn, q18_qty: int) -> dict:
    """Q14's promotion revenue share and Q18's large-volume customers from
    the port's generator in numpy (int64 sums, Python ints where a product
    could pass int64), as rows in the engine's output form."""
    import datetime

    promo_codes = np.array([s.startswith("PROMO") for s in
                            conn.dictionary("part", "p_type", SCALE).values])
    pkeys, ptypes = [], []
    for d in splits_of(g, conn, "part"):
        pkeys.append(d["p_partkey"])
        ptypes.append(d["p_type"])
    pkeys, ptypes = np.concatenate(pkeys), np.concatenate(ptypes)
    promo_of = np.zeros(int(pkeys.max()) + 1, dtype=bool)
    promo_of[pkeys] = promo_codes[ptypes]
    promo, total = 0, 0
    qty_of = np.zeros(g.row_count("orders", SCALE) + 1)  # orderkeys run 1..orders
    lo, hi = Q14_DATES
    for d in splits_of(g, conn, "lineitem"):
        ship = d["l_shipdate"]
        keep = (ship >= lo) & (ship < hi)
        dp = d["l_extendedprice"][keep].astype(np.int64) * (100 - d["l_discount"][keep])
        promo += int(dp[promo_of[d["l_partkey"][keep]]].sum(dtype=np.int64))
        total += int(dp.sum(dtype=np.int64))
        lk = d["l_orderkey"]
        first = int(lk.min())
        q = np.bincount(lk - first, weights=d["l_quantity"])  # exact below 2**53
        qty_of[first:first + q.shape[0]] += q
    # CAST(100.00 * sum_promo AS double) / CAST(sum_all AS double): the
    # product at scale 6, the sum at scale 4
    q14 = [(float(10000 * promo) / 1e6 / (float(total) / 1e4),)]

    big = np.nonzero(qty_of > q18_qty)[0]
    cols = ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice")
    orders = [[] for _ in cols]
    for d in splits_of(g, conn, "orders"):
        keep = np.isin(d["o_orderkey"], big)
        for acc, c in zip(orders, cols):
            acc.append(d[c][keep])
    okey, ocust, odate, oprice = (np.concatenate(x) for x in orders)
    top = np.lexsort((okey, odate, -oprice))[:100]
    parts = [(d["c_custkey"], d["c_name"]) for d in splits_of(g, conn, "customer")]
    ckey, code = (np.concatenate(x) for x in zip(*parts))
    order = np.argsort(ckey, kind="stable")
    at = order[np.searchsorted(ckey[order], ocust[top])]
    names = conn.dictionary("customer", "c_name", SCALE)
    epoch = datetime.date(1970, 1, 1)
    q18 = [(names.values[int(code[j])], int(ocust[i]), int(okey[i]),
            epoch + datetime.timedelta(days=int(odate[i])), int(oprice[i]) / 100,
            int(qty_of[okey[i]]) / 100) for i, j in zip(top, at)]
    print(f"  Q18 has {big.shape[0]} orders over the threshold", flush=True)
    return {"q14": q14, "q18": q18}


def run_q14_q18(HK, dev, kernels: dict) -> tuple:
    """Q14 and Q18 at SF10 with the default session: wall seconds, peak
    device memory, launches by phase and by kernel, no fallback; each
    kernel checked and timed on the inputs the query gave it (and the hash
    probe, with the whole joined page, on every join); rows identical to
    the kernel tier off and to the numpy oracle. Returns the launch counts
    of the default runs, their rows and their peak device memory."""
    from trino_tpu_torch.connectors.tpch import generator as g
    from trino_tpu_torch.runtime import LocalQueryRunner
    from tests.tpch_corpus import TPCH_QUERIES

    texts = {"q14": TPCH_QUERIES["q14"], "q18": Q18_SF10}
    runner = LocalQueryRunner.tpch(scale=SCALE, device=dev)
    # the kernels line keeps phase 3's times: these are printed only
    rows, launches, recorded, peaks = {}, {}, set(kernels), {}
    for q, sql in texts.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches[q], phases, fallbacks, tap = run_default(
            HK, runner, sql, JOIN_KERNELS)
        peak = peaks[q] = torch.cuda.max_memory_allocated()
        rows[q] = (res.rows, double_columns(res))
        INCORE_WALLS[q] = wall
        print(f"  {q} SF{SCALE} default session: {wall:.3f} s wall, peak device memory "
              f"{peak} bytes ({peak / 2**30:.2f} GiB), {len(res.rows)} rows, launches "
              f"{launches[q]}, fused phases {phases}, fallbacks {fallbacks}", flush=True)
        if fallbacks:
            fail(f"{q} fell back from the fused path: {fallbacks}")
        if phases != NEW_PHASES_OF[q]:
            fail(f"{q} ran the fused phases {phases}, not {NEW_PHASES_OF[q]}")
        for name in JOIN_KERNELS:
            if launches[q][name] == 0:
                fail(f"{q} did not go through {name}: {launches[q]}")
        check_query_inputs(HK, q, tap, kernels, recorded)
        check_every_probe(HK, q, tap)
        del tap, res
    del runner
    torch.cuda.empty_cache()

    off = off_runner(dev, SCALE)
    for q, sql in texts.items():
        res, wall = run_off(HK, off, sql)
        if not same_rows(res.rows, rows[q][0], rows[q][1]):
            fail(f"{q}: default rows {rows[q][0][:3]} != kernel-tier-off rows {res.rows[:3]}")
        print(f"  {q} SF{SCALE} kernel tier off: {wall:.3f} s wall, rows identical",
              flush=True)
        del res
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    want = q14_q18_oracle(g, off.catalogs.get("tpch"), Q18_QTY)
    print(f"  numpy oracle: {time.perf_counter() - t0:.3f} s", flush=True)
    for q in texts:
        if not same_rows(rows[q][0], want[q], rows[q][1]):
            fail(f"{q} rows {rows[q][0][:3]} != numpy oracle {want[q][:3]}")
    print(f"  q14 and q18 rows equal the numpy oracle (q14 at {REL_TOL} relative); q14 "
          f"{rows['q14'][0]}, q18 {rows['q18'][0][:2]}...", flush=True)
    return launches, {q: r for q, (r, _) in rows.items()}, peaks


# --------------------------------------------------------------------------- #
# phase 5: the 22 corpus queries at SF1
# --------------------------------------------------------------------------- #

CORPUS_SCALE = 1
# the corpus's keyless joins, which the fused path declines as the
# reference does (they run the serial join)
CROSS_JOINS = {"q11": 1, "q22": 1}


def run_corpus(HK, dev, texts: dict, scale, benchmark: str, cross_joins: dict) -> dict:
    """Every query of ``texts`` at ``scale`` over ``benchmark``'s connector
    with the default session (counts set to 0 just before each, read just
    after) and with the kernel tier off: rows identical (DOUBLE at REL_TOL
    relative), no fallback but the declined CROSS joins (``cross_joins``:
    query -> count), and every kernel the query launched held bit-exact
    against its plain version on the inputs the query gave it (each hash
    probe on every join). Returns the launch counts by query."""
    from trino_tpu_torch.runtime import LocalQueryRunner

    runner = getattr(LocalQueryRunner, benchmark)(scale=scale, device=dev)
    off = off_runner(dev, scale, benchmark)
    launches = {}
    for q, sql in texts.items():
        label = f"{q} SF{scale}"
        res, wall, launches[q], phases, fallbacks, tap = run_default(
            HK, runner, sql, PATH_KERNELS)
        declined = {"cross_join": cross_joins[q]} if q in cross_joins else {}
        if dict(fallbacks) != declined:
            fail(f"{label} fell back from the fused path: {fallbacks}")
        checked = check_launched(HK, label, tap, launches[q])
        del tap
        ref, off_wall = run_off(HK, off, sql)
        if not same_rows(res.rows, ref.rows, double_columns(res)):
            fail(f"{label}: default rows {res.rows[:3]} != kernel-tier-off rows {ref.rows[:3]}")
        print(f"  {label}: {len(res.rows)} rows identical to the kernel tier off; "
              f"{wall:.3f} s default, {off_wall:.3f} s off; launches "
              f"{launched(launches[q])}, fused phases {launched(phases)}, fallbacks "
              f"{dict(fallbacks)}; bit-exact on its inputs: {checked}", flush=True)
        del res, ref
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 6: the out-of-core tier
# --------------------------------------------------------------------------- #

STREAM_SCALE = 100
STREAM_PEAK_LIMIT = 8 << 30  # the streaming tier's point is a bounded footprint
OOC_SCALE = 10
OOC_DISK_BUDGET = 256 << 20  # the serial run's store budget, to reach its disk tier
SPILL_SCALE = 10
SPILL_THRESHOLD = 1 << 30
GROUPED_SUMS = ("grouped_sum_i64", "grouped_sum_i32")
Q1_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
           "l_returnflag", "l_linestatus")
OOC_STATS = ("host_wait_secs", "emit_secs", "device_busy_secs", "prefetch_hits",
             "prefetch_misses", "prefetch_max_inflight_bytes", "prefetch_max_depth",
             "spilled_bytes", "shape_classes")


def launched(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def check_launched(HK, label: str, tap: LaunchTap, launches: dict) -> list:
    """Every kernel the run launched, bit-exact against its plain version
    on the inputs of one of its calls (each hash probe on every join)."""
    checked = []
    for name in tap.orig:
        if launches[name]:
            if not same_result(HK, name, tap.inputs[name]):
                fail(f"{name} [{label} inputs] differs from its plain version")
            checked.append(name)
    for k, args in enumerate(tap.probes):
        if not same_result(HK, "hash_probe", args):
            fail(f"hash_probe [{label} join {k + 1}] differs from its plain version")
    return checked


def run_streaming_q1(HK, dev) -> dict:
    """(a) Q1 at SF100 through ``execute_streaming``'s query object with the
    default session: rows equal to numpy sums tapped from the host arrays
    the connector generates (one generation pass), every grouped-sum kernel
    bit-exact on the first split's inputs, peak device memory under
    STREAM_PEAK_LIMIT. Returns the launch counts."""
    from trino_tpu_torch.connectors.tpch import generator as g
    from trino_tpu_torch.ops import megakernels as MK
    from trino_tpu_torch.runtime import LocalQueryRunner
    from trino_tpu_torch.runtime.streaming import StreamingAggQuery

    runner = LocalQueryRunner.tpch(scale=STREAM_SCALE, device=dev)
    conn = runner.catalogs.get("tpch")
    rf = conn.dictionary("lineitem", "l_returnflag", STREAM_SCALE)
    ls = conn.dictionary("lineitem", "l_linestatus", STREAM_SCALE)
    G = (len(rf), len(ls))
    real = g.generate_split
    pending = []
    lock = threading.Lock()

    def oracle(cols):
        t0 = time.perf_counter()
        return q1_split_sums(cols, G), time.perf_counter() - t0

    def tapping(table, scale, split, total):
        data = real(table, scale, split, total)
        if table == "lineitem" and scale == STREAM_SCALE:
            cols = {c: data.columns[c] for c in Q1_COLS}
            top = int(data.columns["l_orderkey"].max()) if data.count else 0
            with lock:
                pending.append((oracle_pool.submit(oracle, cols), top))
        return data

    q = StreamingAggQuery(runner.plan_sql(QUERIES["q01"]), runner.metadata, runner.session)
    real_step = q._step

    def checked_step(carry, page):
        # a step must not synchronize the host with the card
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_step(carry, page)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    q._step = checked_step
    tap = LaunchTap(HK, GROUPED_SUMS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    HK.reset_launch_counts()
    MK.reset_counts()
    # the oracle's numpy sums run on threads of their own, beside the
    # engine's I/O pool, not inside its generation
    oracle_pool = ThreadPoolExecutor(max_workers=3, thread_name_prefix="q1-oracle")
    g.generate_split = tapping
    try:
        t0 = time.perf_counter()
        with tap:
            _, page = q.execute()
            rows = page.to_pylist()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        g.generate_split = real
    peak = torch.cuda.max_memory_allocated()
    launches = dict(HK.LAUNCHES)
    acc = np.zeros((6,) + G, dtype=np.int64)
    tap_secs, max_key = 0.0, 0
    for fut, top in pending:
        sums, secs = fut.result()
        acc += sums
        tap_secs += secs
        max_key = max(max_key, top)
    oracle_pool.shutdown()
    st = q.stats
    print(f"  q01 SF{STREAM_SCALE} streamed: {wall:.3f} s wall, {q.splits_processed} splits, "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB), launches "
          f"{launched(launches)}; no step synchronized the host", flush=True)
    print(f"  q01 SF{STREAM_SCALE}: generation and staging {st['generate_secs']:.3f} "
          f"thread-seconds on the I/O pool ({st['generate_secs'] / wall:.2f} per wall second), "
          f"main thread waiting on splits {st['host_wait_secs']:.3f} s "
          f"({st['host_wait_secs'] / wall:.3f} of the wall); the oracle's sums "
          f"{tap_secs:.3f} thread-seconds beside them; largest l_orderkey {max_key}",
          flush=True)
    if q.splits_processed != len(pending):
        fail(f"q01 SF{STREAM_SCALE} streamed {q.splits_processed} splits, the tap saw "
             f"{len(pending)}")
    want = q1_rows(acc, rf, ls)
    if rows != want:
        fail(f"q01 SF{STREAM_SCALE} streamed rows {rows} != numpy oracle {want}")
    for name in GROUPED_SUMS:
        if launches[name] < q.splits_processed:
            fail(f"q01 SF{STREAM_SCALE}: {name} launched {launches[name]} times over "
                 f"{q.splits_processed} splits")
        if not same_result(HK, name, tap.inputs[name]):
            fail(f"{name} [q01 SF{STREAM_SCALE} first split] differs from its plain version")
        per = tap.launch_ms(name)
        print(f"  {name} [q01 SF{STREAM_SCALE} first split n={tap.inputs[name][0].shape[0]}]: "
              f"bit-exact; {len(per)} launches, {sum(per):.3f} ms in all", flush=True)
    if peak > STREAM_PEAK_LIMIT:
        fail(f"q01 SF{STREAM_SCALE} streamed with {peak} bytes of device memory, over "
             f"{STREAM_PEAK_LIMIT}")
    print(f"  q01 SF{STREAM_SCALE} rows equal the numpy oracle: {rows[:1]}...", flush=True)
    return launches


def ooc_run(HK, runner, sql: str, label: str, **kw) -> tuple:
    """One out-of-core run (counts set to 0 just before, read just after):
    (rows, runner, wall s, peak bytes, HK launches, fused phases, fallbacks,
    tap)."""
    from trino_tpu_torch.ops import megakernels as MK
    from trino_tpu_torch.runtime.ooc import OutOfCoreRunner

    ooc = OutOfCoreRunner(runner.plan_sql(sql), runner.metadata, runner.session, **kw)
    tap = LaunchTap(HK, PATH_KERNELS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    HK.reset_launch_counts()
    MK.reset_counts()
    t0 = time.perf_counter()
    with tap:
        _, page = ooc.execute()
        rows = page.to_pylist()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(HK.LAUNCHES)
    units = {k: v for k, v in ooc.stats.items() if k.endswith("_units")}
    stats = {k: (round(ooc.stats[k], 3) if isinstance(ooc.stats[k], float) else ooc.stats[k])
             for k in OOC_STATS}
    print(f"  {label}: {wall:.3f} s wall, peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB), {len(rows)} rows; units {units}; {stats}; "
          f"host_wait_secs {ooc.stats['host_wait_secs'] / wall:.3f} and emit_secs "
          f"{ooc.stats['emit_secs'] / wall:.3f} of the wall; launches {launched(launches)}, "
          f"fused phases {launched(dict(MK.LAUNCHES))}, fallbacks {dict(MK.FALLBACKS)}",
          flush=True)
    return rows, ooc, wall, peak, launches, tap


def run_out_of_core(HK, dev, incore_rows: dict, incore_peaks: dict) -> dict:
    """(b) Q3 and Q18 (TPC-H's threshold of 300) at SF10 through the
    out-of-core runner with the reference's defaults: rows identical to the
    in-core rows of phases 3 and 4, the prefetch on (hits > 0), each
    launched kernel bit-exact on its inputs; then Q3 with the prefetch off
    and a store budget that sends chunks to disk, rows identical again.
    Returns the launch counts."""
    from trino_tpu_torch.runtime import LocalQueryRunner

    runner = LocalQueryRunner.tpch(scale=OOC_SCALE, device=dev)
    launches = {}
    for q, sql in (("q03", QUERIES["q03"]), ("q18", Q18_SF10)):
        label = f"{q} SF{OOC_SCALE} out of core"
        rows, ooc, _, peak, launches[label], tap = ooc_run(HK, runner, sql, label)
        print(f"  {label}: peak {peak} bytes beside {incore_peaks[q]} in core", flush=True)
        if rows != incore_rows[q]:
            fail(f"{label}: rows {rows[:3]} != in-core rows {incore_rows[q][:3]}")
        if ooc.stats["prefetch_hits"] <= 0:
            fail(f"{label}: no prefetch hit {ooc.stats}")
        checked = check_launched(HK, label, tap, launches[label])
        print(f"  {label}: rows identical to in core; bit-exact on its inputs: {checked}",
              flush=True)
        del tap, ooc
    label = f"q03 SF{OOC_SCALE} out of core, prefetch off, {OOC_DISK_BUDGET} byte store budget"
    rows, ooc, _, _, launches[label], tap = ooc_run(
        HK, runner, QUERIES["q03"], label, prefetch_depth=0, mem_budget_bytes=OOC_DISK_BUDGET)
    if rows != incore_rows["q03"]:
        fail(f"{label}: rows {rows[:3]} != in-core rows {incore_rows['q03'][:3]}")
    if ooc.stats["spilled_bytes"] <= 0 or ooc.stats["prefetch_hits"]:
        fail(f"{label}: no disk tier or a prefetch {ooc.stats}")
    print(f"  {label}: rows identical to in core and to the prefetched run", flush=True)
    del tap, ooc
    torch.cuda.empty_cache()
    return launches


def run_operator_spill(HK, dev, incore_rows: dict, kernels: dict) -> dict:
    """(c) Q3 at SF10 with ``spill_operator_threshold_bytes`` at 1 GiB:
    rows identical to phase 3's, the spill really run, every
    ``partition_epilogue`` launch bit-exact on its own inputs, and the
    frames of the device formulation byte-identical to the host-backed
    formulation's on the smallest spilled relation. The epilogue's times
    in the kernels line are taken on the largest spilled relation's inputs.
    Returns the launch counts."""
    from trino_tpu_torch.ops import megakernels as MK
    from trino_tpu_torch.ops import repartition as R
    from trino_tpu_torch.runtime import LocalQueryRunner, PlanExecutor
    from trino_tpu_torch.spi.page import Column, Page

    runner = LocalQueryRunner.tpch(scale=SPILL_SCALE, device=dev)
    runner.session.set("spill_operator_threshold_bytes", SPILL_THRESHOLD)
    label = f"q03 SF{SPILL_SCALE} spill_operator_threshold_bytes={SPILL_THRESHOLD}"
    spilled = []
    real = PlanExecutor._hash_partition_spill

    def capture(self, rel, key_symbols, nparts):
        blobs = real(self, rel, key_symbols, nparts)
        spilled.append((rel, [rel.symbols.index(k) for k in key_symbols], nparts, blobs))
        return blobs

    ex = PlanExecutor(runner.plan_sql(QUERIES["q03"]), runner.metadata, runner.session)
    tap = LaunchTap(HK, ("partition_epilogue",) + PATH_KERNELS,
                    keep_all=("partition_epilogue",))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    HK.reset_launch_counts()
    MK.reset_counts()
    PlanExecutor._hash_partition_spill = capture
    try:
        t0 = time.perf_counter()
        with tap:
            _, page = ex.execute()
            rows = page.to_pylist()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        PlanExecutor._hash_partition_spill = real
    peak = torch.cuda.max_memory_allocated()
    launches = dict(HK.LAUNCHES)
    print(f"  {label}: {wall:.3f} s wall, peak device memory {peak} bytes, spill_count "
          f"{ex.spill_count}, spilled_bytes {ex.spilled_bytes}, relations spilled "
          f"{[(r.page.capacity, n) for r, _, n, _ in spilled]}, launches {launched(launches)}, "
          f"fused phases {launched(dict(MK.LAUNCHES))}, fallbacks {dict(MK.FALLBACKS)}",
          flush=True)
    if rows != incore_rows["q03"]:
        fail(f"{label}: rows {rows[:3]} != in-core rows {incore_rows['q03'][:3]}")
    if ex.spill_count <= 0 or launches["partition_epilogue"] <= 0:
        fail(f"{label}: no spill through partition_epilogue ({ex.spill_count} frames, "
             f"{launches['partition_epilogue']} launches)")
    if dict(MK.FALLBACKS) != {"spill_threshold": 1}:
        fail(f"{label}: fallbacks {dict(MK.FALLBACKS)}, not the spill threshold's one")
    calls = tap.every["partition_epilogue"]
    in_run = tap.launch_ms("partition_epilogue")
    for k, args in enumerate(calls):
        if not same_result(HK, "partition_epilogue", args):
            fail(f"partition_epilogue [{label} launch {k + 1}] differs from its plain version")
        print(f"  partition_epilogue [{label} launch {k + 1} {SHAPE_OF['partition_epilogue'](args)}]"
              f": bit-exact, {in_run[k]:.4f} ms in the run", flush=True)
    checked = check_launched(HK, label, tap, launches)
    print(f"  {label}: rows identical to in core; bit-exact on its inputs: {checked}",
          flush=True)
    rel, key_idx, nparts, blobs = min(spilled, key=lambda s: s[0].page.capacity)
    t0 = time.perf_counter()
    cpu = Page(tuple(Column(c.type, c.data.cpu(), c.valid.cpu(), c.dictionary)
                     for c in rel.page.columns), rel.page.active.cpu())
    host_frames, _ = R.repartition_frames(cpu, key_idx, nparts)
    if host_frames != blobs:
        fail(f"{label}: the device frames of the {rel.page.capacity}-row relation differ "
             "from the host-backed formulation's")
    print(f"  {label}: the {nparts} device frames of the {rel.page.capacity}-row relation "
          f"({sum(map(len, blobs))} bytes) are byte-identical to the host-backed "
          f"formulation's ({time.perf_counter() - t0:.3f} s on the host)", flush=True)
    args = max(calls, key=lambda a: a[3].shape[0])
    timing = time_wrapper(HK, "partition_epilogue", args)
    print_timing(f"partition_epilogue [{label} {SHAPE_OF['partition_epilogue'](args)}]", timing)
    print_split(HK, "partition_epilogue", f"{label}", args)
    ms, plain, lib, b, by = timing
    kernels["partition_epilogue"].update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                                         bound_by=by)
    del tap, calls, spilled
    torch.cuda.empty_cache()
    return {label: launches}


def spill_footprint(dev, incore_rows: dict) -> None:
    """Q3 at SF10 untapped, in core and then under the 1 GiB spill, each
    after a reset of the peak: the tapped runs keep kernel inputs on the
    card, so only these peaks say what the spill does to the footprint.
    Rows must again equal phase 3's."""
    from trino_tpu_torch.runtime import LocalQueryRunner, PlanExecutor

    runner = LocalQueryRunner.tpch(scale=SPILL_SCALE, device=dev)
    seen = {}
    for name, thresh in (("in core", 0), ("spilled", SPILL_THRESHOLD)):
        runner.session.set("spill_operator_threshold_bytes", thresh)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ex = PlanExecutor(runner.plan_sql(QUERIES["q03"]), runner.metadata, runner.session)
        _, page = ex.execute()
        rows = page.to_pylist()
        torch.cuda.synchronize()
        seen[name] = (torch.cuda.max_memory_allocated(), time.perf_counter() - t0,
                      ex.spill_count)
        del ex, page
        if rows != incore_rows["q03"]:
            fail(f"q03 SF{SPILL_SCALE} untapped {name}: rows {rows[:3]} != phase 3's")
    (p_in, w_in, _), (p_sp, w_sp, n_sp) = seen["in core"], seen["spilled"]
    if n_sp <= 0:
        fail(f"q03 SF{SPILL_SCALE} untapped: the {SPILL_THRESHOLD}-byte threshold spilled nothing")
    print(f"  q03 SF{SPILL_SCALE} untapped: peak device memory {p_sp} bytes spilled "
          f"({n_sp} frames, {w_sp:.3f} s) beside {p_in} bytes in core ({w_in:.3f} s), "
          f"{p_sp / p_in:.3f} of it; rows identical", flush=True)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 7: TPC-DS and window functions
# --------------------------------------------------------------------------- #

DS_SCALE = 10
DS_CORPUS_SCALE = 1
WINDOW_SCALE = 10
# q3: two joins and an aggregation; q7: four joins, decimal avgs, NULL
# foreign keys; q65: two aggregations joined; q98: a window over groups
DS_QUERIES = ("q3", "q7", "q65", "q98")
# the corpus's keyless joins (q88's count subqueries), declined as the
# reference declines them
DS_CROSS_JOINS = {"q88": 2}
# BASELINE config 5's window/TopN shape over orders, aggregated so the host
# gets few rows
WINDOW_SQL = """
        SELECT rnk, count(*), sum(s3), min(s3), max(o_custkey) FROM (
          SELECT o_custkey,
                 rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC) rnk,
                 sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC
                                         ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) s3
          FROM orders)
        WHERE rnk <= 3 GROUP BY rnk ORDER BY rnk
    """


def null_keys(args) -> tuple:
    """(NULL join keys on the probe side, of them on active rows, the same
    for the build side) of one hash_probe call."""
    pkeys, bkeys, _, pa, ba = args[:5]
    pnull = pa.new_zeros(pa.shape)
    for _, v in pkeys:
        pnull = pnull | ~v
    bnull = ba.new_zeros(ba.shape)
    for _, v in bkeys:
        bnull = bnull | ~v
    return (int(pnull.sum()), int((pnull & pa).sum()), int(bnull.sum()),
            int((bnull & ba).sum()))


def check_every_launch(HK, label: str, tap: LaunchTap) -> dict:
    """Every tapped launch of the run against its plain version on its own
    inputs (the probe on what the expansion reads). Returns the number
    checked by kernel."""
    checked = {}
    for name, calls in tap.every.items():
        for k, args in enumerate(calls):
            if not same_result(HK, name, args):
                fail(f"{name} [{label} call {k + 1}] differs from its plain version")
        checked[name] = len(calls)
    return checked


def ds_splits(ds, table: str, scale):
    conn = ds.TpcdsConnector(scale=scale, device="cpu")
    total = conn.split_count(table, scale)
    for s in range(total):
        data, count = ds.generate_split(table, scale, s, total)
        yield {c: ds.data_valid(v) for c, v in data.items()}, count


def ds_dimension(ds, table: str, cols, scale) -> dict:
    """Whole columns of a dimension table (data only: none of these is
    nullable) by name."""
    acc = {c: [] for c in cols}
    for data, count in ds_splits(ds, table, scale):
        for c in cols:
            arr, valid = data[c]
            if valid is not None and not valid[:count].all():
                fail(f"{table}.{c} has NULLs the oracle does not expect")
            acc[c].append(arr[:count])
    return {c: np.concatenate(v) for c, v in acc.items()}


def ds_oracle(scale) -> dict:
    """q3 and q98 from the TPC-DS generator in numpy, one pass over
    store_sales: exact integer cent sums, rows in the engine's output form
    (q3 in its ORDER BY, ties left to the comparison; q98's ratio as the
    engine's DOUBLE expression computes it)."""
    from trino_tpu_torch.connectors import tpcds as ds

    conn = ds.TpcdsConnector(scale=scale, device="cpu")
    dd = ds_dimension(ds, "date_dim", ("d_date_sk", "d_year", "d_moy"), scale)
    it = ds_dimension(ds, "item", ("i_item_sk", "i_manufact_id", "i_brand_id", "i_brand",
                                   "i_item_id", "i_class", "i_category"), scale)
    nd = int(dd["d_date_sk"].max()) + 1
    year_of = np.zeros(nd, dtype=np.int64)
    year_of[dd["d_date_sk"]] = dd["d_year"]
    nov = np.zeros(nd, dtype=bool)
    nov[dd["d_date_sk"]] = dd["d_moy"] == 11
    y2001 = np.zeros(nd, dtype=bool)
    y2001[dd["d_date_sk"]] = dd["d_year"] == 2001
    ni = int(it["i_item_sk"].max()) + 1
    sel3 = np.zeros(ni, dtype=bool)
    sel3[it["i_item_sk"]] = it["i_manufact_id"] < 200
    cats = conn.dictionary("item", "i_category", scale)
    want_cats = np.array([v in ("Jewelry", "Men", "Women") for v in cats.values])
    sel98 = np.zeros(ni, dtype=bool)
    sel98[it["i_item_sk"]] = want_cats[it["i_category"]]
    brand_id = np.zeros(ni, dtype=np.int64)
    brand_id[it["i_item_sk"]] = it["i_brand_id"]
    brand = np.zeros(ni, dtype=np.int64)
    brand[it["i_item_sk"]] = it["i_brand"]
    g3 = {}  # (d_year, i_brand_id, i_brand code) -> cents
    rev = np.zeros(ni, dtype=np.int64)
    nrev = np.zeros(ni, dtype=np.int64)
    for data, count in ds_splits(ds, "store_sales", scale):
        dsk, dvalid = data["ss_sold_date_sk"]
        isk, _ = data["ss_item_sk"]
        price, _ = data["ss_ext_sales_price"]
        dsk, isk, price = dsk[:count], isk[:count], price[:count].astype(np.int64)
        ok = np.ones(count, dtype=bool) if dvalid is None else dvalid[:count]
        dsk = np.where(ok, dsk, 0)
        m3 = ok & nov[dsk] & sel3[isk]
        keys = np.stack([year_of[dsk[m3]], brand_id[isk[m3]], brand[isk[m3]]], axis=1)
        if keys.shape[0]:
            uniq, inv = np.unique(keys, axis=0, return_inverse=True)
            # float64 bincount sums are exact below 2**53 cents per split
            sums = np.bincount(inv.reshape(-1), weights=price[m3]).astype(np.int64)
            for k, v in zip(map(tuple, uniq.tolist()), sums.tolist()):
                g3[k] = g3.get(k, 0) + v
        m98 = ok & y2001[dsk] & sel98[isk]
        rev += np.bincount(isk[m98], weights=price[m98], minlength=ni).astype(np.int64)
        nrev += np.bincount(isk[m98], minlength=ni)
    brands = conn.dictionary("item", "i_brand", scale)
    q3 = [(y, bi, brands.values[b], cents / 100) for (y, bi, b), cents in g3.items()]
    q3.sort(key=lambda r: (r[0], -r[3], r[1]))
    ids, classes = conn.dictionary("item", "i_item_id", scale), conn.dictionary(
        "item", "i_class", scale)
    item_of = np.zeros(ni, dtype=np.int64)
    item_of[it["i_item_sk"]] = np.arange(it["i_item_sk"].shape[0])
    hit = np.nonzero(nrev)[0]
    cls = it["i_class"][item_of[hit]]
    class_sum = {}
    for c, r in zip(cls.tolist(), rev[hit].tolist()):
        class_sum[c] = class_sum.get(c, 0) + r
    q98 = []
    for sk, c in zip(hit.tolist(), cls.tolist()):
        j = item_of[sk]
        cents = int(rev[sk])
        ratio = float(cents * 1000) / 1000.0 / (float(class_sum[c]) / 100.0)
        q98.append((ids.values[it["i_item_id"][j]], cats.values[it["i_category"][j]],
                    cents / 100, ratio))
    q98.sort(key=lambda r: (r[1], r[0]))
    return {"q3": q3, "q98": q98}


def q3_order_ok(rows) -> bool:
    keys = [(r[0], -r[3], r[1]) for r in rows]
    return keys == sorted(keys)


def run_tpcds(HK, dev) -> tuple:
    """7a: q3, q7, q65 and q98 at DS_SCALE, in core, with the default
    session (counts set to 0 just before each run, read just after): wall,
    peak device memory, launches by kernel and fused phase, no fallback;
    every tapped launch bit-exact against its plain version on its own
    inputs; the NULL join keys each probe met; q7's largest join's
    hash_probe and hash_expand timed beside their bounds. Then q7 with
    dynamic filtering off, so the NULL foreign keys stay active into the
    probe (the trash bucket); rows identical to the default run. Rows
    identical to the kernel tier off; q3 and q98 equal to numpy. Returns
    the launch counts."""
    from trino_tpu_torch.runtime import LocalQueryRunner
    from tests.tpcds_corpus_texts import tpcds_corpus

    texts = tpcds_corpus()
    runner = LocalQueryRunner.tpcds(scale=DS_SCALE, device=dev)
    rows, launches = {}, {}
    runs = [(q, texts[q], True) for q in DS_QUERIES] + [("q7 no dynamic filter", texts["q7"],
                                                         False)]
    for q, sql, dynamic in runs:
        runner.session.set("enable_dynamic_filtering", dynamic)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches[q], phases, fallbacks, tap = run_default(
            HK, runner, sql, PATH_KERNELS, keep_all=PATH_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {q} SF{DS_SCALE}: {wall:.3f} s wall, peak device memory {peak} bytes "
              f"({peak / 2**30:.2f} GiB, the tap holding every launch's inputs), "
              f"{len(res.rows)} rows, launches {launched(launches[q])}, fused phases "
              f"{launched(phases)}, fallbacks {dict(fallbacks)}", flush=True)
        if fallbacks:
            fail(f"{q} SF{DS_SCALE} fell back from the fused path: {fallbacks}")
        for name in JOIN_KERNELS:
            if launches[q][name] == 0:
                fail(f"{q} SF{DS_SCALE} did not go through {name}: {launches[q]}")
        active_nulls = 0
        for k, args in enumerate(tap.probes):
            pn, pna, bn, bna = null_keys(args)
            active_nulls += pna + bna
            print(f"  {q} join {k + 1} [{SHAPE_OF['hash_probe'](args)}]: NULL keys probe "
                  f"{pn} ({pna} active), build {bn} ({bna} active)", flush=True)
        checked = check_every_launch(HK, f"{q} SF{DS_SCALE}", tap)
        print(f"  {q}: every launch bit-exact on its own inputs: {launched(checked)}",
              flush=True)
        if not dynamic and active_nulls == 0:
            fail(f"{q}: no active NULL join key reached the probe")
        if q == "q7":
            for name in JOIN_KERNELS:
                args = tap.inputs[name]
                timing = time_wrapper(HK, name, args)
                print_timing(f"{name} [q7 SF{DS_SCALE} largest join "
                             f"{SHAPE_OF[name](args)}]", timing)
            print_split(HK, "hash_probe", f"q7 SF{DS_SCALE} largest join",
                        tap.inputs["hash_probe"])
        if not dynamic:
            if not same_rows(res.rows, rows["q7"][0], rows["q7"][1]):
                fail(f"{q}: rows differ from the default run's")
            print(f"  {q}: rows identical to the default run", flush=True)
        else:
            rows[q] = (res.rows, double_columns(res))
        del tap, res
        torch.cuda.empty_cache()
    del runner

    off = off_runner(dev, DS_SCALE, "tpcds")
    for q in DS_QUERIES:
        res, wall = run_off(HK, off, texts[q])
        if not same_rows(res.rows, rows[q][0], rows[q][1]):
            fail(f"{q} SF{DS_SCALE}: default rows {rows[q][0][:3]} != kernel-tier-off rows "
                 f"{res.rows[:3]}")
        print(f"  {q} SF{DS_SCALE} kernel tier off: {wall:.3f} s wall, rows identical",
              flush=True)
        del res
        torch.cuda.empty_cache()
    del off

    t0 = time.perf_counter()
    want = ds_oracle(DS_SCALE)
    print(f"  numpy oracle (q3, q98): {time.perf_counter() - t0:.3f} s", flush=True)
    got3 = rows["q3"][0]
    if not q3_order_ok(got3) or sorted(got3) != sorted(want["q3"]):
        fail(f"q3 rows {got3[:3]} != numpy oracle {want['q3'][:3]}")
    if not same_rows(rows["q98"][0], want["q98"], rows["q98"][1]):
        fail(f"q98 rows {rows['q98'][0][:3]} != numpy oracle {want['q98'][:3]}")
    print(f"  q3 ({len(got3)} rows) and q98 ({len(rows['q98'][0])} rows) equal the numpy "
          f"oracle; q3 {got3[:2]}, q98 {rows['q98'][0][:2]}", flush=True)
    return launches


def window_oracle(scale) -> list:
    """WINDOW_SQL from the TPC-H generator in numpy: orders sorted by
    (o_custkey, o_totalprice DESC), rank as one plus the rows of the
    customer priced higher, the ROWS frame's sum as a prefix-sum
    difference, aggregated by rank."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.connectors.tpch import generator as g

    conn = TpchConnector(scale=scale, device="cpu")
    total = conn.split_count("orders", scale)
    cust, price = [], []
    for s in range(total):
        d = g.generate_split("orders", scale, s, total)
        cust.append(d.columns["o_custkey"][:d.count])
        price.append(d.columns["o_totalprice"][:d.count].astype(np.int64))
    cust, price = np.concatenate(cust), np.concatenate(price)
    order = np.lexsort((-price, cust))
    c, p = cust[order], price[order]
    n = c.shape[0]
    idx = np.arange(n)
    new_part = np.ones(n, dtype=bool)
    new_part[1:] = c[1:] != c[:-1]
    part_start = np.maximum.accumulate(np.where(new_part, idx, 0))
    peer = new_part.copy()
    peer[1:] |= p[1:] != p[:-1]
    peer_start = np.maximum.accumulate(np.where(peer, idx, 0))
    rnk = peer_start - part_start + 1
    ps = np.concatenate([[0], np.cumsum(p)])
    lo = np.maximum(idx - 2, part_start)
    s3 = ps[idx + 1] - ps[lo]
    out = []
    for r in (1, 2, 3):
        m = rnk == r
        out.append((r, int(m.sum()), int(s3[m].sum()) / 100, int(s3[m].min()) / 100,
                    int(c[m].max())))
    return out


def run_window(HK, dev) -> dict:
    """7c: WINDOW_SQL over TPC-H orders at WINDOW_SCALE with the default
    session: wall, peak device memory, launches; rows equal to numpy.
    Returns the launch counts."""
    from trino_tpu_torch.runtime import LocalQueryRunner

    runner = LocalQueryRunner.tpch(scale=WINDOW_SCALE, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, wall, launches, phases, fallbacks, tap = run_default(HK, runner, WINDOW_SQL,
                                                              PATH_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    checked = check_launched(HK, "window", tap, launches)
    print(f"  window query over orders SF{WINDOW_SCALE}: {wall:.3f} s wall, peak device "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB), rows {res.rows}, launches "
          f"{launched(launches)}, fused phases {launched(phases)}; bit-exact: {checked}",
          flush=True)
    del tap, runner
    t0 = time.perf_counter()
    want = window_oracle(WINDOW_SCALE)
    print(f"  numpy oracle: {time.perf_counter() - t0:.3f} s", flush=True)
    if res.rows != want:
        fail(f"window query rows {res.rows} != numpy oracle {want}")
    print("  window query rows equal the numpy oracle", flush=True)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 8: TPC-H SF10 held in memory tables
# --------------------------------------------------------------------------- #

MEM_TABLES = ("lineitem", "orders", "customer", "part", "supplier", "nation", "region")
MEM_QUERIES = ("q06", "q01", "q03", "q10", "q18")
DELETE_DATES = (9131, 9496)  # 1995-01-01, 1996-01-01
NEW_KEY_OFFSET = 1_000_000_000  # MERGE source keys that no order has
MEM_DML = {
    "delete": "DELETE FROM orders WHERE o_orderdate >= DATE '1995-01-01' "
              "AND o_orderdate < DATE '1996-01-01'",
    "update": "UPDATE lineitem SET l_discount = 0.10 WHERE l_shipmode = 'AIR'",
    # about 1,500,000 source rows: the orders of one customer in ten, even keys
    # as they are (present unless the DELETE took them), odd keys moved past
    # every order's key (new)
    "merge": f"MERGE INTO orders t USING (SELECT o_orderkey + (o_orderkey % 2) * "
             f"{NEW_KEY_OFFSET} AS k, o_custkey AS c, o_orderstatus AS s, "
             "CAST(o_totalprice * 2 AS decimal(12,2)) AS p, o_orderdate AS d, "
             "o_orderpriority AS op, o_clerk AS cl, o_shippriority AS sp, o_comment AS cm "
             "FROM orders WHERE o_custkey % 10 = 3) src ON t.o_orderkey = src.k "
             "WHEN MATCHED THEN UPDATE SET o_totalprice = src.p "
             "WHEN NOT MATCHED THEN INSERT (o_orderkey, o_custkey, o_orderstatus, "
             "o_totalprice, o_orderdate, o_orderpriority, o_clerk, o_shippriority, "
             "o_comment) VALUES (src.k, src.c, src.s, src.p, src.d, src.op, src.cl, src.sp, "
             "src.cm)",
    "rollback": "DELETE FROM lineitem WHERE l_returnflag = 'R'",
}


def checksum(t: torch.Tensor) -> int:
    """A position-weighted sum of a tensor's bits on the device (int64,
    wrapping; odd weights): a change of any one element changes it."""
    x = t.reshape(t.shape[0], -1)
    if x.dtype.is_floating_point:
        x = x.view(torch.int64 if x.element_size() == 8 else torch.int32)
    w = torch.arange(1, 2 * x.shape[0], 2, dtype=torch.int64, device=x.device)
    return int((x.to(torch.int64) * w[:, None]).sum())


def table_checksums(conn) -> dict:
    """Every stored tensor's checksum: each column's data bits and
    ``valid``, and each page's ``active``."""
    out = {}
    for name, table in sorted(conn._tables.items(), key=lambda kv: str(kv[0])):
        for i, page in enumerate(table.pages):
            out[(name.table, i, "active")] = checksum(page.active)
            for c, col in zip(table.columns, page.columns):
                out[(name.table, i, c.name)] = (checksum(col.data), checksum(col.valid))
    return out


def same_checksums(label: str, got: dict, want: dict) -> None:
    changed = sorted(str(k) for k in set(got) | set(want) if got.get(k) != want.get(k))
    if changed:
        fail(f"{label}: stored tensors changed: {changed[:8]}")
    print(f"  {label}: the checksums of {len(want)} stored tensors are unchanged", flush=True)


def stored_size(table) -> tuple:
    """(device bytes, pages, slots) of a stored table."""
    from trino_tpu_torch.runtime.memory import page_bytes

    return (sum(page_bytes(p) for p in table.pages), len(table.pages),
            sum(p.capacity for p in table.pages))


def check_every_call(HK, label: str, tap: LaunchTap) -> int:
    """Every call the tap kept (``keep_all``) bit-exact against its plain
    version; returns how many."""
    n = 0
    for name, calls in tap.every.items():
        for args in calls:
            if not same_result(HK, name, args):
                fail(f"{name} [{label}, call {n + 1}] differs from its plain version")
            n += 1
    return n


def generator_count(g, conn, table: str) -> int:
    if table != "lineitem":
        return g.row_count(table, SCALE)
    total = conn.split_count("lineitem", SCALE)
    return sum(g.lineitem_split_rows(SCALE, s, total) for s in range(total))


class DmlLineitemSums:
    """8d's numpy sums over ``lineitem``, split by split: 8f's oracle pass
    over the generator feeds it, so ``lineitem`` is generated once for
    both."""

    def __init__(self, conn):
        self.air = conn.dictionary("lineitem", "l_shipmode", SCALE).code_of("AIR")
        self.flag_r = conn.dictionary("lineitem", "l_returnflag", SCALE).code_of("R")
        self.n_line = self.n_air = self.n_r = self.disc_rest = 0

    def add(self, d) -> None:
        is_air = d["l_shipmode"] == self.air
        self.n_line += is_air.shape[0]
        self.n_air += int(is_air.sum())
        self.n_r += int((d["l_returnflag"] == self.flag_r).sum())
        self.disc_rest += int(d["l_discount"][~is_air].sum(dtype=np.int64))


def dml_oracle(g, conn, li: DmlLineitemSums) -> dict:
    """What each statement of MEM_DML returns and leaves, from the port's
    generator in numpy (``lineitem``'s part from ``li``): rows affected,
    then count(*) and the sum it reads (decimals as the engine decodes
    them)."""
    o = {c: [] for c in ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice")}
    for d in splits_of(g, conn, "orders"):
        for c in o:
            o[c].append(d[c])
    key, cust, date, price = (np.concatenate(o[c]) for c in o)
    lo, hi = DELETE_DATES
    present = ~((date >= lo) & (date < hi))
    n_line, n_air, n_r, disc_rest = li.n_line, li.n_air, li.n_r, li.disc_rest
    src = present & (cust % 10 == 3)
    matched = src & (key % 2 == 0)
    inserted = src & (key % 2 == 1)
    orders_after = int(present.sum()) + int(inserted.sum())
    price_after = (int(price[present].sum(dtype=np.int64)) + int(price[matched].sum(dtype=np.int64))
                   + 2 * int(price[inserted].sum(dtype=np.int64)))
    return {
        "delete": ([(int((~present).sum()),)], "SELECT count(*) FROM orders",
                   [(int(present.sum()),)]),
        "update": ([(n_air,)], "SELECT sum(l_discount) FROM lineitem",
                   [((disc_rest + 10 * n_air) / 100,)]),
        "merge": ([(int(src.sum()),)], "SELECT count(*), sum(o_totalprice) FROM orders",
                  [(orders_after, price_after / 100)]),
        "rollback": ([(n_r,)], "SELECT count(*) FROM lineitem", [(n_line - n_r,)]),
        "source_rows": int(src.sum()),
    }


# phase 8f: the scalar functions and the aggregate long tail over the SF10
# memory tables (``tests/test_torch_function_tables.py`` runs the same four
# texts at SF0.01 against the reference)
FUNCTION_QUERIES = {
    # Q1's shape with the variance family
    "f1": "SELECT l_returnflag, l_linestatus, count(*), sum(l_quantity), stddev(l_quantity), "
          "variance(l_extendedprice), stddev_pop(l_discount), var_samp(l_tax) FROM lineitem "
          "GROUP BY 1, 2 ORDER BY 1, 2",
    # a join feeding a grouped aggregation, date and regex functions in the
    # filter and the key
    "f2": "SELECT date_trunc('month', o_orderdate) AS m, count(*), sum(l_extendedprice) "
          "FROM orders JOIN lineitem ON o_orderkey = l_orderkey "
          "WHERE date_diff('day', l_shipdate, l_receiptdate) > 20 "
          "AND regexp_like(o_clerk, '0{3}[1-4]') GROUP BY 1 ORDER BY 1",
    # the rest of the aggregates
    "f3": "SELECT l_returnflag, corr(l_quantity, l_extendedprice), "
          "regr_slope(l_extendedprice, l_quantity), covar_pop(l_quantity, l_discount), "
          "skewness(l_discount), kurtosis(l_tax), geometric_mean(l_quantity), "
          "entropy(l_linenumber), min_by(l_orderkey, l_extendedprice), "
          "max_by(l_orderkey, l_extendedprice), bitwise_xor_agg(l_orderkey), "
          "checksum(l_orderkey), approx_distinct(l_partkey), "
          "approx_percentile(l_extendedprice, 0.5) FROM lineitem GROUP BY 1 ORDER BY 1",
    # date parts and string transforms over dictionary columns
    "f4": "SELECT year_of_week(o_orderdate), week(o_orderdate), count(*), "
          "count_if(regexp_like(o_clerk, '9$')), max(length(o_orderpriority)), "
          "min(lpad(reverse(o_orderstatus), 3, '*')) FROM orders GROUP BY 1, 2 ORDER BY 1, 2",
}
# the kernels each function query must launch
FUNCTION_KERNELS = {"f1": GROUPED_SUMS, "f2": JOIN_KERNELS, "f3": (), "f4": ()}
F2_CLERK = r"0{3}[1-4]"


def _exact_moments(inv: np.ndarray, v: np.ndarray, groups: int) -> tuple:
    """(sum, sum of squares) of non-negative integer ``v`` by group, each an
    exact Python int: with v = a * 4096 + b, v^2 is a^2 * 2^24 + 2ab * 2^12
    + b^2, and each part's sums stay exact in float64."""
    v = v.astype(np.int64)
    a, b = v >> 12, v & 4095
    s1 = _exact_bincount(inv, v, groups)
    aa, ab, bb = (_exact_bincount(inv, x, groups) for x in (a * a, a * b, b * b))
    return ([int(x) for x in s1],
            [int(x) * 2**24 + 2 * int(y) * 2**12 + int(z) for x, y, z in zip(aa, ab, bb)])


def _exact_bincount(inv: np.ndarray, values: np.ndarray, groups: int) -> np.ndarray:
    """int64 sums of integer ``values`` by group (float64 partial sums of
    one split stay below 2^53, so they are exact)."""
    out = np.bincount(inv, weights=values.astype(np.float64), minlength=groups)
    if out.max(initial=0) >= 2.0**53:
        fail("a split's decimal sum passed 2^53")
    return np.round(out).astype(np.int64)


def _variance(s1, s2, n, sample: bool):
    """The reference's one-pass variance: E[x^2] - E[x]^2, floored at 0."""
    mean = s1 / n
    var = max(s2 / n - mean * mean, 0.0)
    return var * n / max(n - 1, 1) if sample else var


def function_oracle(g, conn, visit=None) -> dict:
    """F1's and F2's rows from the port's generator in numpy: counts and
    decimal sums exact (int64), the variance family by the reference's
    one-pass formula over the exact sums and sums of squares. ``visit``,
    when given, sees every ``lineitem`` split of the pass too."""
    import datetime
    import re

    rf = conn.dictionary("lineitem", "l_returnflag", SCALE)
    ls = conn.dictionary("lineitem", "l_linestatus", SCALE)
    G = len(rf) * len(ls)
    clerks = conn.dictionary("orders", "o_clerk", SCALE)
    clerk_hit = np.array([re.search(F2_CLERK, s) is not None for s in clerks.values])
    okey, odate = [], []
    for d in splits_of(g, conn, "orders"):
        keep = clerk_hit[d["o_clerk"].astype(np.int64)]
        okey.append(d["o_orderkey"][keep])
        odate.append(d["o_orderdate"][keep])
    okey, odate = np.concatenate(okey), np.concatenate(odate)
    order = np.argsort(okey, kind="stable")
    okey, odate = okey[order], odate[order]
    month = odate.astype("datetime64[D]").astype("datetime64[M]").astype(
        "datetime64[D]").astype(np.int64)
    months, minv = np.unique(month, return_inverse=True)
    f2_count = np.zeros(months.shape[0], dtype=np.int64)
    f2_sum = np.zeros(months.shape[0], dtype=np.int64)
    count = np.zeros(G, dtype=np.int64)
    qty = np.zeros(G, dtype=np.int64)
    # exact integer sums and sums of squares of the stored cents
    sums = {c: [[0] * G, [0] * G] for c in
            ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    for d in splits_of(g, conn, "lineitem"):
        if visit is not None:
            visit(d)
        inv = d["l_returnflag"].astype(np.int64) * len(ls) + d["l_linestatus"]
        count += np.bincount(inv, minlength=G)
        qty += _exact_bincount(inv, d["l_quantity"], G)
        for c, acc in sums.items():
            s1, s2 = _exact_moments(inv, d[c], G)
            acc[0] = [x + y for x, y in zip(acc[0], s1)]
            acc[1] = [x + y for x, y in zip(acc[1], s2)]
        lk = d["l_orderkey"]
        pos = np.minimum(np.searchsorted(okey, lk), max(okey.shape[0] - 1, 0))
        hit = (okey[pos] == lk) & (
            d["l_receiptdate"].astype(np.int64) - d["l_shipdate"] > 20)
        f2_count += np.bincount(minv[pos[hit]], minlength=months.shape[0])
        f2_sum += _exact_bincount(minv[pos[hit]], d["l_extendedprice"][hit], months.shape[0])
    f1 = []
    for i in range(G):
        n = int(count[i])
        if n == 0:
            continue
        a, b = divmod(i, len(ls))
        q, p, disc, tax = ((s1[i] / 100, s2[i] / 10**4) for s1, s2 in sums.values())
        f1.append((rf.values[a], ls.values[b], n, int(qty[i]) / 100,
                   math.sqrt(_variance(*q, n, True)), _variance(*p, n, True),
                   math.sqrt(_variance(*disc, n, False)), _variance(*tax, n, True)))
    epoch = datetime.date(1970, 1, 1)
    f2 = [(epoch + datetime.timedelta(days=int(m)), int(c), int(s) / 100)
          for m, c, s in zip(months, f2_count, f2_sum) if c > 0]
    return {"f1": f1, "f2": f2}


def run_function_queries(HK, dev, runner, conn, tpch, li: DmlLineitemSums) -> dict:
    """Phase 8f: F1-F4 over the memory tables with the default session,
    each with the card's name and power limit, its wall (the host clock
    around ``execute`` and a synchronize), peak device memory, launches by
    kernel and fallbacks:
    rows identical to the kernel tier off (DOUBLE at 1e-9 relative), F1
    and F2 equal to numpy over the generator, every tapped launch bit-exact
    against its plain version, no fallback. Returns the launch counts by
    query."""
    from trino_tpu_torch.connectors.tpch import generator as g
    from trino_tpu_torch.metadata import Session
    from trino_tpu_torch.runtime import LocalQueryRunner

    off = LocalQueryRunner(Session(catalog="memory", schema="default"), device=dev)
    off.register_catalog("memory", conn)
    off.session.set("pallas_aggregation", "off")
    off.session.set("pallas_fusion", False)
    t0 = time.perf_counter()
    want = function_oracle(g, tpch, li.add)
    print(f"  8f numpy oracle of F1 and F2 (and 8d's lineitem sums, the same pass): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    launches = {}
    card = card_line()
    for q, sql in FUNCTION_QUERIES.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches[f"{q} memory"], phases, fallbacks, tap = run_default(
            HK, runner, sql, PATH_KERNELS, keep_all=PATH_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        n_checked = check_every_call(HK, f"{q} memory", tap)
        del tap
        off_res, off_wall = run_off(HK, off, sql)
        doubles = double_columns(res)
        print(f"  8f {q} ({card}): {wall:.3f} s wall (kernel tier off {off_wall:.3f} s), peak device "
              f"memory {peak} bytes ({peak / 2**30:.2f} GiB, the tap holding every launch's "
              f"inputs), {len(res.rows)} rows, launches {launched(launches[f'{q} memory'])}, "
              f"fused phases {launched(phases)}, FALLBACKS {fallbacks}; every tapped launch "
              f"bit-exact ({n_checked}); first row {res.rows[:1]}", flush=True)
        if res.column_names != off_res.column_names or not same_rows(
                res.rows, off_res.rows, doubles):
            fail(f"{q}: rows {res.rows[:3]} != the kernel tier off's {off_res.rows[:3]}")
        if q in want and not same_rows(res.rows, want[q], doubles):
            fail(f"{q}: rows {res.rows[:3]} != numpy {want[q][:3]}")
        if fallbacks:
            fail(f"{q} fell back from the fused path: {fallbacks}")
        for name in FUNCTION_KERNELS[q]:
            if launches[f"{q} memory"][name] == 0:
                fail(f"{q} did not go through {name}")
        print(f"  8f {q}: rows identical to the kernel tier off"
              + (" and to numpy" if q in want else ""), flush=True)
        del res, off_res
    return launches


# phase 8g: ARRAY, MAP and ROW values, UNNEST, lambdas and the JSON and URL
# functions over the SF10 memory tables (``tests/test_torch_nested_tables.py``
# runs the same texts at SF0.01 against the reference)
NESTED_CTAS = (
    "CREATE TABLE cust_orders AS SELECT o_custkey, "
    "array_agg(o_orderkey ORDER BY o_orderdate, o_orderkey) AS okeys, "
    "array_agg(o_totalprice ORDER BY o_orderdate, o_orderkey) AS prices "
    "FROM orders GROUP BY o_custkey")
NESTED_QUERIES = {
    # N2: UNNEST feeding the join kernels
    "n2": "SELECT c.o_custkey, count(*), sum(l_extendedprice * (1 - l_discount)) "
          "FROM cust_orders c CROSS JOIN UNNEST(c.okeys) AS u(okey) "
          "JOIN lineitem ON l_orderkey = u.okey "
          "GROUP BY c.o_custkey ORDER BY 3 DESC, 1 LIMIT 20",
    # N3: lambdas and array functions over an array payload through the join
    "n3": "SELECT c_mktsegment, count(*), max(array_max(transform(okeys, k -> k % 1000))), "
          "sum(cardinality(filter(prices, p -> p > 100000))), "
          "sum(reduce(prices, CAST(0 AS DOUBLE), (s, p) -> s + CAST(p AS DOUBLE), s -> s)), "
          "sum(cardinality(array_distinct(transform(okeys, k -> k % 7)))), "
          "count_if(contains(transform(okeys, k -> k % 10), 3)), "
          "sum(element_at(array_sort(okeys), 1)), sum(cardinality(slice(okeys, 2, 3))) "
          "FROM cust_orders JOIN customer ON c_custkey = o_custkey "
          "GROUP BY c_mktsegment ORDER BY 1",
    # N4: the map-valued aggregates
    "n4": "SELECT l_returnflag, histogram(l_shipmode), "
          "array_sort(array_agg(DISTINCT l_shipinstruct)) FROM lineitem "
          "GROUP BY l_returnflag ORDER BY 1",
    "n4b": "SELECT r_name, map_agg(n_name, n_nationkey), "
           "listagg(n_name, ',') WITHIN GROUP (ORDER BY n_name) "
           "FROM nation JOIN region ON n_regionkey = r_regionkey GROUP BY r_name ORDER BY 1",
    # N5: JSON, URL and split over dictionary columns of orders
    "n5": "SELECT p, h, count(*), sum(k) FROM (SELECT json_extract_scalar("
          "'{\"p\": \"' || o_orderpriority || '\", \"s\": \"' || o_orderstatus || '\"}', "
          "'$.p') AS p, url_extract_host('http://' || lower(o_orderstatus) || '/x') AS h, "
          "CAST(split(o_clerk, '#')[2] AS bigint) AS k FROM orders) GROUP BY 1, 2 ORDER BY 1, 2",
}
# the same values without arrays, maps, lambdas, JSON or URLs
NESTED_FLAT = {
    "n2": "SELECT o_custkey, count(*), sum(l_extendedprice * (1 - l_discount)) "
          "FROM orders JOIN lineitem ON l_orderkey = o_orderkey "
          "GROUP BY o_custkey ORDER BY 3 DESC, 1 LIMIT 20",
    "n3": "SELECT c_mktsegment, count(*), max(mx), sum(n_big), sum(tot), sum(nd), "
          "count_if(has3), sum(first_key), sum(CASE WHEN n > 4 THEN 3 ELSE n - 1 END) "
          "FROM (SELECT o_custkey, count(*) AS n, max(o_orderkey % 1000) AS mx, "
          "count_if(o_totalprice > 100000) AS n_big, sum(CAST(o_totalprice AS DOUBLE)) AS tot, "
          "count(DISTINCT o_orderkey % 7) AS nd, bool_or(o_orderkey % 10 = 3) AS has3, "
          "min(o_orderkey) AS first_key FROM orders GROUP BY o_custkey) t "
          "JOIN customer ON c_custkey = o_custkey GROUP BY c_mktsegment ORDER BY 1",
    "n4": "SELECT l_returnflag, l_shipmode, count(*) FROM lineitem GROUP BY 1, 2 ORDER BY 1, 2",
    "n4_distinct": "SELECT DISTINCT l_returnflag, l_shipinstruct FROM lineitem ORDER BY 1, 2",
    "n4b": "SELECT r_name, n_name, n_nationkey FROM nation JOIN region "
           "ON n_regionkey = r_regionkey ORDER BY 1, 2",
    "n5": "SELECT o_orderpriority, lower(o_orderstatus), count(*), "
          "sum(CAST(substr(o_clerk, 7) AS bigint)) FROM orders GROUP BY 1, 2 ORDER BY 1, 2",
}
# the kernels each nested query must launch
NESTED_KERNELS = {"n1": (), "n2": JOIN_KERNELS, "n3": JOIN_KERNELS, "n4": (), "n4b": (),
                  "n5": ()}


def nested_flat_rows(runner, q: str) -> list:
    """What N2-N5 must return, from the flat queries over the same tables:
    N4's histogram and distinct lists and N4b's map and list rebuilt from
    flat rows on the host."""
    rows = runner.execute(NESTED_FLAT[q]).rows
    if q == "n4":
        hist = {}
        for flag, mode, n in rows:
            hist.setdefault(flag, {})[mode] = n
        insts = {}
        for flag, inst in runner.execute(NESTED_FLAT["n4_distinct"]).rows:
            insts.setdefault(flag, []).append(inst)
        return [(f, hist[f], insts[f]) for f in sorted(hist)]
    if q == "n4b":
        by_region = {}
        for region, nation, key in rows:
            by_region.setdefault(region, []).append((nation, key))
        return [(r, dict(v), ",".join(n for n, _ in v)) for r, v in sorted(by_region.items())]
    return rows


def run_nested_query(HK, runner, off, q: str, sql: str, card: str) -> tuple:
    """One nested query with the default session: its wall, peak, launches
    by kernel, fused phases and FALLBACKS; the rows against the kernel tier
    off; every tapped launch bit-exact. Returns (result, launches,
    columns carried by row index through ``hash_expand``)."""
    from trino_tpu_torch.ops import megakernels as MK

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, wall, launches, phases, fallbacks, tap = run_default(
        HK, runner, sql, PATH_KERNELS, keep_all=PATH_KERNELS)
    carried = dict(MK.CARRIED)
    peak = torch.cuda.max_memory_allocated()
    n_checked = check_every_call(HK, f"{q} nested", tap)
    del tap
    print(f"  8g {q} ({card}): {wall:.3f} s wall, peak device memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB, the tap holding every launch's inputs), "
          f"{len(res.rows)} rows, launches {launched(launches)}, fused phases "
          f"{launched(phases)}, FALLBACKS {fallbacks}, carried by row index {carried}; "
          f"every tapped launch bit-exact ({n_checked}); first row {res.rows[:1]}", flush=True)
    if fallbacks:
        fail(f"{q} fell back from the fused path: {fallbacks}")
    for name in NESTED_KERNELS[q]:
        if launches[name] == 0:
            fail(f"{q} did not go through {name}")
    if off is not None:
        off_res, off_wall = run_off(HK, off, sql)
        if res.column_names != off_res.column_names or not same_nested_rows(
                res.rows, off_res.rows):
            fail(f"{q}: rows {res.rows[:3]} != the kernel tier off's {off_res.rows[:3]}")
        print(f"  8g {q}: rows identical to the kernel tier off ({off_wall:.3f} s)", flush=True)
    return res, launches, carried


def same_nested_rows(got: list, want: list) -> bool:
    """Row for row; floats at ``REL_TOL`` relative, inside lists, dicts
    and tuples too; everything else equal and of the same type."""
    def same(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return same_value(a, b, True)
        if type(a) is not type(b):
            return False
        if isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(b, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in b)
        return a == b

    return same(got, want)


def run_nested_queries(HK, dev, runner, conn) -> dict:
    """Phase 8g over the memory tables: N1, a CTAS of every customer's
    orders as two arrays in date order (aggregate ORDER BY, the lane width
    a host read), gated on its element count; N2, UNNEST of those arrays
    into the join kernels, N3, lambdas and array functions over an array
    payload carried through ``hash_expand``, N4, ``histogram``,
    ``array_agg(DISTINCT)``, ``map_agg`` and ``listagg``, N5, JSON, URL
    and ``split`` over dictionary columns: each with its wall, peak and
    launches by kernel; rows equal to the flat queries (DOUBLE at 1e-9
    relative) and, for N2 and N3, identical to the kernel tier off. Then
    DROP of ``cust_orders``: device memory back within 1 % of its level
    before N1. Returns the launch counts by query."""
    from trino_tpu_torch.metadata import Session
    from trino_tpu_torch.runtime import LocalQueryRunner
    from trino_tpu_torch.spi.connector import SchemaTableName

    off = LocalQueryRunner(Session(catalog="memory", schema="default"), device=dev)
    off.register_catalog("memory", conn)
    off.session.set("pallas_aggregation", "off")
    off.session.set("pallas_fusion", False)
    card = card_line()
    launches = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    res, wall, launches["n1 nested"], _, fallbacks, tap = run_default(
        HK, runner, NESTED_CTAS, PATH_KERNELS)
    del tap
    peak = torch.cuda.max_memory_allocated()
    table = conn.table(SchemaTableName("default", "cust_orders"))
    stored, n_pages, cap = stored_size(table)
    width = table.pages[0].columns[1].data.shape[1]
    (n,), = res.rows
    (elements,), = runner.execute("SELECT sum(cardinality(okeys)) FROM cust_orders").rows
    want_elements = runner.execute("SELECT count(*) FROM orders").rows[0][0]
    print(f"  8g n1 ({card}): CTAS cust_orders {n} rows, lane width W = {width}, {stored} "
          f"bytes stored ({stored / 2**30:.2f} GiB, {n_pages} page of {cap} slots), "
          f"{wall:.3f} s wall, peak device memory {peak} bytes ({peak / 2**30:.2f} GiB), "
          f"launches {launched(launches['n1 nested'])}; sum(cardinality(okeys)) {elements} "
          f"(orders {want_elements}); UNNEST grid of N2: {cap} x {width} = {cap * width} "
          "rows", flush=True)
    if elements != want_elements or fallbacks:
        fail(f"n1: {elements} array elements for {want_elements} orders, fallbacks {fallbacks}")

    for q, sql in NESTED_QUERIES.items():
        res, launches[f"{q} nested"], carried = run_nested_query(
            HK, runner, off if q in ("n2", "n3") else None, q, sql, card)
        want = nested_flat_rows(runner, q)
        if not same_nested_rows(res.rows, want):
            fail(f"{q}: rows {res.rows[:3]} != the flat query's {want[:3]}")
        if q == "n3" and "array(decimal(12,2))" not in carried:
            fail(f"n3: hash_expand did not carry the prices lanes ({carried})")
        print(f"  8g {q}: rows equal to the flat query's", flush=True)
        del res

    runner.execute("DROP TABLE cust_orders")
    del table
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"  8g after DROP of cust_orders: {left} bytes allocated, {base} before N1 "
          f"({left - base:+d})", flush=True)
    if abs(left - base) > 0.01 * base:
        fail(f"device memory after the DROP {left} is not within 1 % of {base}")
    return launches


def run_memory_tables(HK, dev, incore_rows: dict, kernels: dict) -> dict:
    """Phase 8: (a) CTAS of seven TPC-H SF10 tables into memory tables, (b)
    Q6, Q1, Q3, Q10 and Q18 from them against phases 3 and 4's rows, (c)
    stored-tensor checksums unchanged by the queries, (f) the function
    queries F1-F4 and the checksums again, (g) the nested queries N1-N5
    and the checksums again, (d) DELETE, UPDATE,
    MERGE and a rolled-back DELETE against numpy over the generator, (e)
    DROP and device memory back to its level. Returns the launch counts of
    (b), (f), (g) and (d), by run."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.connectors.tpch import generator as g
    from trino_tpu_torch.metadata import Session
    from trino_tpu_torch.runtime import LocalQueryRunner
    from trino_tpu_torch.spi.connector import SchemaTableName

    from trino_tpu_torch.ops.compiler import clear_cache

    # DROP TABLE empties the compile cache, so (e) compares against a level
    # taken with it empty too: the closures of phases 3-7 hold their LUTs
    # on the card until then
    clear_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    print(f"  device memory allocated before the load, the compile cache empty: {base} "
          "bytes", flush=True)
    runner = LocalQueryRunner(Session(catalog="memory", schema="default"), device=dev)
    tpch = TpchConnector(scale=SCALE, device=dev)
    runner.register_catalog("tpch", tpch)
    conn = MemoryConnector(device=dev)
    runner.register_catalog("memory", conn)
    schema = f"tpch.sf{SCALE:g}".replace(".", "_").replace("tpch_", "tpch.")

    # (a) the load
    stored_all = 0
    for table in MEM_TABLES:
        want = generator_count(g, tpch, table)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (n,), = runner.execute(
            f"CREATE TABLE {table} AS SELECT * FROM {schema}.{table}").rows
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stored, n_pages, cap = stored_size(conn.table(SchemaTableName("default", table)))
        stored_all += stored
        print(f"  8a CTAS {table}: {n} rows (generator {want}), {secs:.3f} s, {stored} bytes "
              f"stored ({stored / 2**30:.2f} GiB, {n_pages} page of {cap} slots), peak "
              f"device memory {peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)
        if n != want:
            fail(f"CTAS {table} stored {n} rows, the generator has {want}")
    print(f"  8a: {stored_all} bytes stored in all ({stored_all / 2**30:.2f} GiB), "
          f"{torch.cuda.memory_allocated()} bytes allocated", flush=True)
    loaded = table_checksums(conn)

    # (b) the queries
    texts = {q: QUERIES.get(q, Q18_SF10) for q in MEM_QUERIES}
    plans = LocalQueryRunner.tpch(scale=SCALE, device=dev)  # plans only, over tpch
    launches = {}
    for q, sql in texts.items():
        names = [k for k in KERNELS_OF.get(q, JOIN_KERNELS) if k != "q6_fused"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches[f"{q} memory"], phases, fallbacks, tap = run_default(
            HK, runner, sql, names, keep_all=names)
        peak = torch.cuda.max_memory_allocated()
        same_plan = runner.explain(sql) == plans.explain(sql).replace(
            f"{schema}.", "memory.default.")
        print(f"  8b {q} over memory tables: {wall:.3f} s wall (over tpch, phase "
              f"{4 if q == 'q18' else 3}: {INCORE_WALLS[q]:.3f} s), peak device memory {peak} "
              f"bytes ({peak / 2**30:.2f} GiB, the tap holding every launch's inputs), "
              f"{len(res.rows)} rows, launches {launched(launches[f'{q} memory'])}, fused "
              f"phases {launched(phases)}, fallbacks {fallbacks}, optimized plan text equal "
              f"to tpch's: {same_plan}", flush=True)
        if not same_rows(res.rows, incore_rows[q], double_columns(res)):
            fail(f"{q} over memory tables: rows {res.rows[:3]} != phase 3/4 rows "
                 f"{incore_rows[q][:3]}")
        if fallbacks:
            fail(f"{q} over memory tables fell back from the fused path: {fallbacks}")
        for name in names:
            if launches[f"{q} memory"][name] == 0:
                fail(f"{q} over memory tables did not go through {name}")
        if q == "q10" and any(phases[k] != v for k, v in PHASES_OF["q10"].items()):
            fail(f"q10 over memory tables ran the fused phases {phases}, not "
                 f"{PHASES_OF['q10']}")
        check_query_inputs(HK, f"{q} memory", tap, kernels, set(kernels))
        n_checked = check_every_call(HK, f"{q} memory", tap)
        print(f"  8b {q}: rows identical to phase {4 if q == 'q18' else 3}'s; every tapped "
              f"launch bit-exact ({n_checked})", flush=True)
        del tap, res
    del plans
    torch.cuda.empty_cache()

    # (c) nothing wrote into a stored table
    same_checksums("8c after the queries", table_checksums(conn), loaded)

    # (f) the function queries, on the tables as loaded
    li = DmlLineitemSums(tpch)
    launches.update(run_function_queries(HK, dev, runner, conn, tpch, li))
    torch.cuda.empty_cache()
    same_checksums("8f after the function queries", table_checksums(conn), loaded)

    # (g) the nested queries, on the tables as loaded
    launches.update(run_nested_queries(HK, dev, runner, conn))
    torch.cuda.empty_cache()
    same_checksums("8g after the nested queries", table_checksums(conn), loaded)

    # (d) DML
    t0 = time.perf_counter()
    want = dml_oracle(g, tpch, li)
    print(f"  8d numpy oracle: {time.perf_counter() - t0:.3f} s; the MERGE source holds "
          f"{want['source_rows']} rows", flush=True)
    for name, sql in MEM_DML.items():
        affected, check_sql, check_rows = want[name]
        if name == "rollback":
            before = table_checksums(conn)
            counts = {t: runner.execute(f"SELECT count(*) FROM {t}").rows for t in MEM_TABLES}
            runner.execute("START TRANSACTION")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches[f"dml {name}"], _, _, tap = run_default(HK, runner, sql, ())
        peak = torch.cuda.max_memory_allocated()
        got = runner.execute(check_sql).rows
        print(f"  8d {name}: {res.rows[0][0]} rows, {wall:.3f} s wall, peak device memory "
              f"{peak} bytes ({peak / 2**30:.2f} GiB); {check_sql}: {got}", flush=True)
        if res.rows != affected or got != check_rows:
            fail(f"{name}: {res.rows} rows and {got}, numpy {affected} and {check_rows}")
        if name == "rollback":
            runner.execute("ROLLBACK")
            undo_peak = torch.cuda.max_memory_allocated()
            after = {t: runner.execute(f"SELECT count(*) FROM {t}").rows for t in MEM_TABLES}
            print(f"  8d rollback: peak device memory with the pre-image held {undo_peak} "
                  f"bytes ({undo_peak / 2**30:.2f} GiB); counts after ROLLBACK {after}",
                  flush=True)
            if after != counts:
                fail(f"counts after ROLLBACK {after} != before {counts}")
            same_checksums("8d after ROLLBACK", table_checksums(conn), before)
        del tap, res
    print("  8d: DELETE, UPDATE, MERGE and the rolled-back DELETE equal numpy", flush=True)

    # (e) drop
    for table in MEM_TABLES:
        runner.execute(f"DROP TABLE {table}")
    del runner, conn, tpch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"  8e after DROP: {left} bytes allocated, {base} before the load "
          f"({left - base:+d})", flush=True)
    if abs(left - base) > 0.01 * base:
        fail(f"device memory after DROP {left} is not within 1 % of {base}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from trino_tpu_torch.ops import hopper_kernels as HK
    from trino_tpu_torch.connectors.tpch import TpchConnector

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    print("phase 1: build", flush=True)
    start = t0 = time.perf_counter()
    lib = HK.build()
    build_s = time.perf_counter() - t0
    print(f"  built {lib.name} in {build_s:.2f} s", flush=True)
    print((lib.parent / "build.log").read_text(), flush=True)

    print("phase 2: kernels against their plain versions", flush=True)
    t0 = time.perf_counter()
    conn = TpchConnector(scale=SCALE, device="cpu")
    splits = conn.split_count("lineitem", SCALE)
    n_main = splits * conn.split_capacity("lineitem", SCALE, splits)
    kernels = check_kernels(HK, n_main, dev)
    torch.cuda.empty_cache()
    check_join_kernels(HK, n_main, dev, kernels)
    torch.cuda.empty_cache()
    check_sort_kernels(HK, dev, kernels)
    torch.cuda.empty_cache()

    phase_s = {"build": build_s, "kernels": time.perf_counter() - t0}
    t0 = time.perf_counter()
    print(f"phase 3: TPC-H Q6, Q1, Q3 and Q10 at SF{SCALE}", flush=True)
    launches, incore_rows, incore_peaks = run_queries(HK, dev, kernels)
    phase_s["queries"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    print(f"phase 4: TPC-H Q14 and Q18 at SF{SCALE}", flush=True)
    more, rows, peaks = run_q14_q18(HK, dev, kernels)
    launches.update(more)
    incore_rows.update(rows)
    incore_peaks.update(peaks)
    phase_s["q14_q18"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    print(f"phase 5: the 22 TPC-H corpus queries at SF{CORPUS_SCALE}", flush=True)
    from tests.tpch_corpus import TPCH_QUERIES

    corpus = run_corpus(HK, dev, dict(sorted(TPCH_QUERIES.items())), CORPUS_SCALE, "tpch",
                        CROSS_JOINS)
    phase_s["corpus"] = time.perf_counter() - t0
    launches.update({f"{q} SF{CORPUS_SCALE}": v for q, v in corpus.items()})

    t0 = time.perf_counter()
    print(f"phase 6: the out-of-core tier: Q1 at SF{STREAM_SCALE} streamed, Q3 and Q18 at "
          f"SF{OOC_SCALE} out of core, Q3 at SF{SPILL_SCALE} under operator-state spill",
          flush=True)
    launches[f"q01 SF{STREAM_SCALE} streamed"] = run_streaming_q1(HK, dev)
    torch.cuda.empty_cache()
    launches.update(run_out_of_core(HK, dev, incore_rows, incore_peaks))
    launches.update(run_operator_spill(HK, dev, incore_rows, kernels))
    spill_footprint(dev, incore_rows)
    phase_s["out_of_core"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    print(f"phase 7: TPC-DS q3, q7, q65 and q98 at SF{DS_SCALE}, the 25 TPC-DS corpus "
          f"queries at SF{DS_CORPUS_SCALE}, a window query over TPC-H orders at "
          f"SF{WINDOW_SCALE}", flush=True)
    launches.update({f"{q} SF{DS_SCALE} (tpcds)": v for q, v in run_tpcds(HK, dev).items()})
    phase_s["tpcds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from tests.tpcds_corpus_texts import tpcds_corpus

    ds_corpus = run_corpus(HK, dev, tpcds_corpus(), DS_CORPUS_SCALE, "tpcds", DS_CROSS_JOINS)
    launches.update({f"{q} SF{DS_CORPUS_SCALE} (tpcds)": v for q, v in ds_corpus.items()})
    phase_s["tpcds_corpus"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches[f"window SF{WINDOW_SCALE}"] = run_window(HK, dev)
    phase_s["window"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    print(f"phase 8: TPC-H SF{SCALE} held in memory tables: CTAS, Q6, Q1, Q3, Q10 and Q18, "
          "the function queries F1-F4, the nested queries N1-N5, DELETE, UPDATE, MERGE, a "
          "rolled-back transaction, DROP", flush=True)
    launches.update(run_memory_tables(HK, dev, incore_rows, kernels))
    phase_s["memory_tables"] = time.perf_counter() - t0
    for name, k in kernels.items():
        k["launches"] = sum(runs[name] for runs in launches.values())
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f", total {time.perf_counter() - start:.1f}", flush=True)

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
