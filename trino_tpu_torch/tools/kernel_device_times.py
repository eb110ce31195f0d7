"""Device time of the hash probe and expansion, the sorts, the one-request
segment aggregation and the sort-path aggregation, by kernel, on the card.

    python3 trino_tpu_torch/tools/kernel_device_times.py [--root DIR] [--joins FILE]

Imports ``trino_tpu_torch`` from ``DIR`` (default: this checkout), so an
unpacked copy of another commit can be measured beside this one in one run
on one card. Builds its kernels, then times ``hopper_kernels.hash_probe``
on the inputs of TPC-H Q3's two joins and Q10's three at SF10,
``hopper_kernels.group_sort`` on a page shaped like Q10's joined page at
SF10 (2,097,152 rows, 1,200,000 active, three keys of 21-bit ranges NULL
on the inactive rows), ``hopper_kernels.partition_epilogue`` on the same
page at 8 partitions, and ``hopper_kernels.segment_agg`` with one request
(an integer sum) on two sorted pages:
524,288 rows in 131,072 slots, 119,740 groups of about four rows (the shape
of Q3's at SF10), and 4,194,304 rows in groups of about four. After each join's probe,
``hopper_kernels.hash_expand`` runs on that probe's output, with both
sides' keys and a seeded int32 and float64 column each, then with the
exchange destination of 4 partitions on the probe key (and on the probe
key, a build key and an int32 column through a value-key LUT): folded into
the expansion where ``hash_expand`` takes a destination, and always as the
expansion followed by ``partition_dest``. ``megakernels.aggregate_phase``
runs on the inputs of Q3's and Q10's sort-path aggregations, and
``megakernels.expand_phase`` on the inputs of the join under Q3's presorted
and Q12's direct aggregation at SF1 (the join, the fused projection and the
grouping: each tree's own stages after the join), captured by one run of
the two queries through ``DIR``'s runner. For each it
prints the wrapper's milliseconds (CUDA events over 10 calls after one;
the host's work between launches included), the device kernels and
memsets of one call, and the device microseconds a call spends in each
(``torch.profiler`` over 10 calls). The join inputs are
the probe calls of one run of the two queries through ``DIR``'s
``LocalQueryRunner`` (about a minute of host generation), saved to
``FILE`` (default: ``trino_tpu_torch/_build/kernel_inputs/joins_sf10.pt``
of this checkout, gitignored) by the first run and read by later ones,
so every commit is timed on the same inputs; the aggregation inputs go to
``aggregates_sf10.pt`` beside it. Needs a card and ``nvcc``.

    python3 trino_tpu_torch/tools/kernel_device_times.py [--root DIR] --aggregates

times the main path's kernels alone on its own calls: ``lineitem``,
``orders``, ``customer``, ``supplier``, ``nation`` and ``region`` of TPC-H
SF10 are loaded into ``DIR``'s memory tables by CTAS (as ``chip_smoke.py``
phase 8 loads them), then TPC-H Q3, Q5, Q10, Q12 and Q18 (TPC-H's
threshold 300) and ``chip_smoke.py``'s T1-T5 run through ``DIR``'s
``LocalQueryRunner``, keeping every ``hash_probe``, ``hash_expand``,
``group_sort``, ``presorted_group``, ``segment_agg``,
``segment_agg_direct``, ``segment_sort``, ``hll`` and ``expr_program``
call's arguments (a query ``DIR`` cannot run, T5 on a tree without
long-decimal group keys, is reported as not run). Each call is reported
as above (wrapper ms, device us by kernel and memset) beside its bound
(``chip_smoke.py``'s ``probe_bound``, ``expand_bound``,
``group_sort_bound``, ``presorted_bound``, ``segment_agg_bound``,
``direct_bound``, ``resort_bound`` and ``expr_bound``: bytes over 3.35
TB/s) and the query's wall. Then Q3 over the ``tpch`` generators at SF10
(whose joined page is ordered on its first group key, so it groups through
``presorted_group``; a memory table's scan keeps no order): its
``presorted_group`` call inside the query (the host's ms in the wrapper,
and the stream's ms between CUDA events around it), then alone as above.
Last, ``presorted_group`` on ``chip_smoke.py`` phase 2's Q3-shaped pages
(4,194,304 and 524,288 slots) and ``expr_program`` on its main projection
(4,194,304 rows, 32 instructions, 6 outputs). The generator and the plans
are deterministic, so two checkouts see the same inputs: to compare a
commit with its parent on one card, unpack the parent's
``trino_tpu_torch/`` (``git archive HEAD trino_tpu_torch``) into a
gitignored directory and run, in one call::

    for r in parent . . parent; do
        python3 trino_tpu_torch/tools/kernel_device_times.py --root $r --aggregates
    done
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

import torch


QUERIES = {
    "q03": """
        SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
               o_orderdate, o_shippriority
        FROM customer, orders, lineitem
        WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
          AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
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


def capture_joins(HK, path: Path) -> None:
    """Runs Q3 and Q10 at SF10, keeping a compact copy of the arguments of
    every hash_probe call, and saves them as ``[(label, args), ...]``; the
    arguments of each ``aggregate_phase`` call go to ``aggregates_sf10.pt``
    beside it the same way (its sorted page is not written again, so the
    call's own tensors are kept)."""
    from trino_tpu_torch.ops import megakernels as MK
    from trino_tpu_torch.runtime import LocalQueryRunner

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(copy(y) for y in x)
        return x

    joins, aggregates = [], []
    orig, orig_agg = HK.hash_probe, MK.aggregate_phase
    runner = LocalQueryRunner.tpch(scale=10, device="cuda")
    try:
        for q, sql in QUERIES.items():
            k = [0]

            def tapped(*args, _q=q, _k=k):
                _k[0] += 1
                joins.append((f"{_q} join {_k[0]}", copy(args)))
                return orig(*args)

            def tapped_agg(*args, _q=q):
                aggregates.append((f"{_q} aggregation", args))
                return orig_agg(*args)

            HK.hash_probe, MK.aggregate_phase = tapped, tapped_agg
            runner.execute(sql)
    finally:
        HK.hash_probe, MK.aggregate_phase = orig, orig_agg
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(joins, path)
    torch.save(aggregates, path.parent / "aggregates_sf10.pt")


EXPAND_QUERIES = {
    "q03": QUERIES["q03"],
    "q12": """
        SELECT l_shipmode,
               sum(CASE WHEN o_orderpriority = '1-URGENT' OR o_orderpriority = '2-HIGH'
                        THEN 1 ELSE 0 END) AS high_line_count,
               sum(CASE WHEN o_orderpriority <> '1-URGENT' AND o_orderpriority <> '2-HIGH'
                        THEN 1 ELSE 0 END) AS low_line_count
        FROM orders, lineitem
        WHERE o_orderkey = l_orderkey AND l_shipmode IN ('MAIL', 'SHIP')
          AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
          AND l_receiptdate >= DATE '1994-01-01' AND l_receiptdate < DATE '1995-01-01'
        GROUP BY l_shipmode
        ORDER BY l_shipmode
    """,
}


def expand_calls(scale: int = 1) -> list:
    """(label, args, kw) of the last expand_phase call with a stage after
    the join (a projection or an aggregation) of Q3 and Q12, from one run
    of each through this tree's runner."""
    from trino_tpu_torch.ops import megakernels as MK
    from trino_tpu_torch.runtime import LocalQueryRunner

    runner = LocalQueryRunner.tpch(scale=scale, device="cuda")
    out = []
    orig = MK.expand_phase
    for q, sql in EXPAND_QUERIES.items():
        calls = []

        def tapped(*args, _calls=calls, **kw):
            _calls.append((args, kw))
            return orig(*args, **kw)

        MK.expand_phase = tapped
        try:
            runner.execute(sql)
        finally:
            MK.expand_phase = orig
        fused = [c for c in calls if c[0][8] is not None or c[0][9] is not None]
        out.append((f"{q} SF{scale}", *fused[-1]))
    return out


def side_cols(keys, n: int, dev, seed: int):
    """A join side's columns: its keys, then an int32 and a float64 column
    (seeded, so every commit expands the same bytes)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return list(keys) + [
        (torch.randint(-9, 9, (n,), generator=gen, device=dev, dtype=torch.int32),
         torch.rand(n, generator=gen, device=dev) < 0.9),
        (torch.rand(n, generator=gen, device=dev, dtype=torch.float64),
         torch.rand(n, generator=gen, device=dev) < 0.9),
    ]


def expand_args(pr: dict, probe: tuple, dev) -> tuple:
    """``hash_expand``'s arguments after one join's probe: its table and
    emit counts, both sides' columns, and the emitted rows rounded up to
    1,024 slots."""
    pkeys, bkeys, luts, pa, ba = probe[:5]
    cap = -(-max(int(pr["emit"].sum()), 1) // 1024) * 1024
    return (pr["table"], pr["counts"], pr["bucket_p"], pr["count"], pr["emit"], pkeys, bkeys,
            luts, pa, side_cols(pkeys, pa.shape[0], dev, 1),
            side_cols(bkeys, ba.shape[0], dev, 2), cap)


def q10_page(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n, groups = 2_097_152, 390_000
    cust = torch.randperm(1_500_000, generator=gen, device=dev)[:groups] + 1
    acct = torch.randint(-99_999, 999_999, (1_500_001,), generator=gen, device=dev)
    ck = cust[torch.randint(0, groups, (n,), generator=gen, device=dev)]
    active = torch.arange(n, device=dev) < 1_200_000
    keys = [(ck, active.clone()), ((ck - 1).to(torch.int32), active.clone()),
            (acct[ck], active.clone())]
    revenue = torch.randint(0, 10**11, (n,), generator=gen, device=dev)
    return keys, list(keys) + [(revenue, active.clone())], active


def sorted_page(dev, n: int, groups: int, slots: int, seed: int):
    """values, weight and starts of ``groups`` groups of random lengths over
    the first rows of n (about four rows each), padded with n to ``slots``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    firsts = torch.randperm(min(4 * groups, n) - 1, generator=gen, device=dev)[:groups - 1] + 1
    starts = torch.full((slots,), n, dtype=torch.int64, device=dev)
    starts[:groups] = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                 torch.sort(firsts).values])
    vals = torch.randint(-(2**62), 2**62, (n,), generator=gen, device=dev)
    weight = torch.rand(n, generator=gen, device=dev) < 0.9
    return vals, weight, starts


def wrapper_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the tracer can miss the first kernels of a traced window: each window
# opens on spin kernels and a pause on the host, left out of the result
_PAD_SPINS = 4
_SPIN_CYCLES = 1_000_000


def traced_kernels(fn, reps: int) -> list:
    """(name, device us, count) of each kernel and memset over ``reps``
    calls of ``fn`` after one untraced warm-up call (``torch.profiler``;
    empty where it sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(_PAD_SPINS):
            torch.cuda._sleep(_SPIN_CYCLES)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us or str(getattr(ev, "device_type", "")).endswith("CUDA"):
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip() or ev.key[:40]
            if name != "spin_kernel":
                out.append((name, us, ev.count))
    return out


def device_us(fn, reps: int = 10) -> tuple:
    """(device us a call by kernel or memset, how many of each a call)."""
    out, count = {}, {}
    for name, us, n in traced_kernels(fn, reps):
        if us:
            out[name] = out.get(name, 0.0) + us / reps
            count[name] = count.get(name, 0) + n / reps
    return out, count


def report(root: str, label: str, fn) -> None:
    ms = wrapper_ms(fn)
    us, count = device_us(fn)
    parts = ", ".join(f"{k} {v:.1f}" for k, v in sorted(us.items(), key=lambda kv: -kv[1]))
    print(f"[{root}] {label}: wrapper {ms:.4f} ms; device {sum(us.values()):.1f} us a call "
          f"in {sum(count.values()):g} kernels and memsets ({parts})", flush=True)


def dest_reports(root: str, HK, label: str, ex: tuple, dev) -> None:
    """The expansion with the exchange destination on one key and on three
    (a dictionary key among them): folded into ``hash_expand`` where it
    takes one, and as the expansion followed by ``partition_dest``."""
    import inspect

    pcols = ex[9]
    code = next(i for i, (d, _) in enumerate(pcols) if d.dtype == torch.int32)
    lut = torch.arange(64, dtype=torch.int64, device=dev) * 7919
    for keys, luts in (((0,), [None]), ((0, len(pcols), code), [None, None, lut])):
        def then_dest(keys=keys, luts=luts):
            out = HK.hash_expand(*ex)
            cols = out[0] + out[1]
            return HK.partition_dest([cols[i] for i in keys], luts, out[2], 4)

        report(root, f"hash_expand then partition_dest on {len(keys)} keys, {label}", then_dest)
        if "dest" in inspect.signature(HK.hash_expand).parameters:
            folded = ex + ((keys, luts, 4),)
            report(root, f"hash_expand with the destination on {len(keys)} keys, {label}",
                   lambda: HK.hash_expand(*folded))


# the tables the aggregation queries read, and the queries (chip_smoke.py's
# T1-T5 beside Q3, Q5, Q10, Q12 and Q18)
AGG_TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region")
AGG_SCALE = 10
AGG_KERNELS = ("hash_probe", "hash_expand", "group_sort", "presorted_group", "segment_agg",
               "segment_agg_direct", "segment_sort", "hll", "expr_program")


def memory_runner(root: str, dev, scale=AGG_SCALE, tables=AGG_TABLES):
    """``DIR``'s runner over memory tables holding ``tables`` of TPC-H at
    ``scale``, each loaded by CTAS (its seconds printed)."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.metadata import Session
    from trino_tpu_torch.runtime import LocalQueryRunner

    runner = LocalQueryRunner(Session(catalog="memory", schema="default"), device=dev)
    runner.register_catalog("tpch", TpchConnector(scale=scale, device=dev))
    runner.register_catalog("memory", MemoryConnector(device=dev))
    for table in tables:
        t0 = time.perf_counter()
        schema = f"sf{scale:g}".replace(".", "_")
        runner.execute(f"CREATE TABLE {table} AS SELECT * FROM tpch.{schema}.{table}")
        print(f"[{root}] CTAS {table}: {time.perf_counter() - t0:.3f} s", flush=True)
    return runner


def query_calls(HK, runner, sql: str, names, dev, around=None) -> tuple:
    """(wall s, [(name, args, kwargs), ...]): the query run once to warm,
    then again with every call of the wrappers ``names`` kept in order
    (``around(name, call)``, where given, makes each of these calls)."""
    calls = []
    orig = {n: getattr(HK, n) for n in names}

    def tapped(*args, _name, **kw):
        calls.append((_name, args, kw))
        if around is not None and dev.type == "cuda":
            return around(_name, lambda: orig[_name](*args, **kw))
        return orig[_name](*args, **kw)

    for n in names:
        setattr(HK, n, lambda *a, _name=n, **kw: tapped(*a, _name=_name, **kw))
    try:
        runner.execute(sql)  # warm
        calls.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.execute(sql)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(HK, n, orig[n])
    return wall, calls


def aggregate_reports(root: str, HK, here: Path, dev=None, scale=AGG_SCALE) -> None:
    """Every call of the wrappers ``AGG_KERNELS`` in Q3, Q5, Q10, Q12, Q18
    and T1-T5 over memory tables at ``scale``, timed on its own arguments
    right after its query; Q3's presorted grouping over the generators;
    then the phase 2 pages (module docstring)."""
    sys.path.insert(1, str(here))
    from chip_smoke import (LONG_DECIMAL_QUERIES, LONG_TAIL_QUERIES, Q18_SF10, RESORT_QUERIES,
                            direct_bound, expand_bound, expr_bound, expr_cases,
                            group_sort_bound, presorted_bound, presorted_cases, probe_bound,
                            resort_bound, segment_agg_bound)
    from tests.tpch_corpus import TPCH_QUERIES

    dev = torch.device("cuda") if dev is None else dev
    runner = memory_runner(root, dev, scale)
    texts = {"q03": QUERIES["q03"], "q05": TPCH_QUERIES["q05"], "q10": QUERIES["q10"],
             "q12": EXPAND_QUERIES["q12"], "q18": Q18_SF10, **LONG_TAIL_QUERIES,
             **RESORT_QUERIES, **LONG_DECIMAL_QUERIES}
    names = AGG_KERNELS
    bounds = {"segment_agg": segment_agg_bound, "segment_agg_direct": direct_bound,
              "segment_sort": lambda a: resort_bound("segment_sort", a),
              "hll": lambda a: resort_bound("hll", a), "expr_program": expr_bound,
              "hash_probe": probe_bound, "hash_expand": expand_bound,
              "group_sort": group_sort_bound, "presorted_group": presorted_bound}
    shapes = {
        "hash_probe": lambda a: (f"n={a[3].shape[0]} m={a[4].shape[0]} B={a[5]} C={a[6]} "
                                 f"keys={len(a[0])}"),
        "hash_expand": lambda a: (f"n={a[4].shape[0]} slots={a[11]} probe columns={len(a[9])} "
                                  f"build columns={len(a[10])}"),
        "group_sort": lambda a: (f"n={a[2].shape[0]} active={int(a[2].sum())} "
                                 f"keys={len(a[0])} payloads={len(a[1])}"),
        "presorted_group": lambda a: (f"n={a[1].shape[0]} active={int(a[1].sum())} "
                                      f"keys={len(a[0])}"),
        "segment_agg": lambda a: (f"n={a[0].shape[0]} slots={a[2]} requests={len(a[5])} "
                                  f"outputs={len(a[6])}"),
        "segment_agg_direct": lambda a: (f"n={a[2].shape[0]} G={math.prod(a[1])} "
                                         f"requests={len(a[3])} outputs={len(a[4])}"),
        "segment_sort": lambda a: (f"n={a[0].shape[0]} groups={int(a[0].sum())} "
                                   f"values={a[1].dtype} participants_first={a[3]}"),
        "hll": lambda a: f"n={a[0].shape[0]} groups={int(a[0].sum())} slots={a[1]}",
        "expr_program": lambda a: (f"n={(a[1][0][1] if a[1] else a[2]).shape[0]} "
                                   f"instructions={len(a[0].code)} registers={a[0].n_regs} "
                                   f"inputs={len(a[1])} outputs={len(a[0].output_dtypes)}"),
    }

    def report_calls(q, calls):
        for k, (name, args, kw) in enumerate(calls):
            b, by = bounds[name](args)
            report(root, f"{name}, {q} call {k + 1} ({shapes[name](args)}; bound {b:.4f} ms, "
                         f"{by})", lambda: getattr(HK, name)(*args, **kw))

    for q, sql in texts.items():
        try:
            wall, calls = query_calls(HK, runner, sql, names, dev)
        except NotImplementedError as e:  # a tree without what the query needs
            print(f"[{root}] {q} over memory tables: not run ({e})", flush=True)
            continue
        print(f"[{root}] {q} over memory tables: {wall:.4f} s wall, {len(calls)} kernel calls",
              flush=True)
        report_calls(q, calls)
        del calls
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    del runner
    presorted_in_query(root, HK, dev, scale, report_calls)
    cases = presorted_cases(HK, dev)
    for _ in range(2):
        label, args = next(cases)
        b, by = presorted_bound(args)
        report(root, f"presorted_group, phase 2's {label} (keys={len(args[0])}; bound "
                     f"{b:.4f} ms, {by})", lambda: HK.presorted_group(*args))
    del cases, args
    label, args = next(iter(expr_cases(HK, dev)))
    b, by = expr_bound(args)
    report(root, f"expr_program, phase 2's {label} ({shapes['expr_program'](args)}; bound "
                 f"{b:.4f} ms, {by})", lambda: HK.expr_program(*args))


def presorted_in_query(root: str, HK, dev, scale, report_calls) -> None:
    """Q3 over the ``tpch`` generators at ``scale``: each
    ``presorted_group`` call inside the query (the host's ms in the wrapper
    and the stream's ms between CUDA events around it), then each call
    alone (``report_calls``)."""
    from trino_tpu_torch.runtime import LocalQueryRunner

    inside = []

    def around(name, call):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        out = call()
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        inside.append((name, host, start, end))
        return out

    runner = LocalQueryRunner.tpch(scale=scale, device=dev)
    wall, calls = query_calls(HK, runner, QUERIES["q03"], ("presorted_group",), dev, around)
    print(f"[{root}] q03 over tpch: {wall:.4f} s wall, {len(calls)} presorted_group calls",
          flush=True)
    for k, (name, host, start, end) in enumerate(inside[-len(calls):] if calls else []):
        print(f"[{root}] {name}, q03 over tpch call {k + 1} inside the query: host "
              f"{host:.4f} ms in the wrapper, stream {start.elapsed_time(end):.4f} ms between "
              "events around it", flush=True)
    report_calls("q03 over tpch", calls)
    del calls, runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    here = Path(__file__).resolve().parents[2]
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--joins", default=str(
        here / "trino_tpu_torch" / "_build" / "kernel_inputs" / "joins_sf10.pt"))
    ap.add_argument("--aggregates", action="store_true",
                    help="only the main path's kernels on the calls of Q3, Q5, Q10, Q12, Q18 "
                         "and T1-T5 over memory tables, and presorted_group on Q3's over tpch")
    opts = ap.parse_args()
    root, joins = opts.root, Path(opts.joins)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, root)
    from trino_tpu_torch.ops import hopper_kernels as HK

    if not HK.__file__.startswith(str(Path(root).resolve())):
        sys.exit(f"imported {HK.__file__}, not from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    HK.build()
    if opts.aggregates:
        aggregate_reports(root, HK, here)
        return
    dev = torch.device("cuda")
    if not (joins.exists() and (joins.parent / "aggregates_sf10.pt").exists()):
        capture_joins(HK, joins)
    from trino_tpu_torch.ops import megakernels as MK

    for label, args in torch.load(joins, map_location=dev):
        shape = f"n={args[3].shape[0]} m={args[4].shape[0]} B={args[5]} C={args[6]}"
        report(root, f"hash_probe, {label} ({shape})", lambda: HK.hash_probe(*args))
        ex = expand_args(HK.hash_probe(*args), args, dev)
        report(root, f"hash_expand, {label} ({ex[-1]} slots)", lambda: HK.hash_expand(*ex))
        if label.startswith("q03"):
            dest_reports(root, HK, label, ex, dev)
        del ex
    del args
    torch.cuda.empty_cache()
    for label, args in torch.load(joins.parent / "aggregates_sf10.pt", map_location=dev,
                                  weights_only=False):
        page = args[4]
        report(root, f"aggregate_phase, {label} (n={page.active.shape[0]} slots={args[3]} "
                     f"aggregates={len(args[1])})", lambda: MK.aggregate_phase(*args))
    del args, page
    torch.cuda.empty_cache()
    for label, args, kw in expand_calls():
        report(root, f"expand_phase, {label} (the join and its stages after it)",
               lambda: MK.expand_phase(*args, **kw))
    del args, kw
    torch.cuda.empty_cache()
    keys, payload, active = args = q10_page(dev)
    report(root, "group_sort, Q10-shaped page", lambda: HK.group_sort(*args))
    report(root, "partition_epilogue, the same page, 8 parts",
           lambda: HK.partition_epilogue(keys, [None] * len(keys), payload, active, 8))
    del args, keys, payload, active
    for label, shape in (("segment_agg one request, Q3-shaped rows (524,288 in 131,072 "
                          "slots)", (524_288, 119_740, 131_072, 1)),
                         ("segment_agg one request, 4,194,304 rows in groups of about four",
                          (4_194_304, 786_000, 786_016, 2))):
        v, w, starts = sorted_page(dev, *shape)
        new_group = torch.zeros(v.shape[0], dtype=torch.bool, device=dev)
        new_group[starts[starts < v.shape[0]]] = True
        groups = torch.tensor(shape[1], device=dev)
        req = [HK.AggRequest("sum", v)]
        out = [HK.AggOutput("value", (0,), torch.int64)]
        report(root, label, lambda: HK.segment_agg(new_group, groups, shape[2], w, [], req, out))


if __name__ == "__main__":
    main()
