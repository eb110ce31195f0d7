"""Walls of ``chip_smoke.py`` phase 8b's five queries over TPC-H SF10 held
in memory tables, on the card.

    python3 trino_tpu_torch/tools/resident_walls.py [--root DIR] [--label NAME] [--reps N]
                                                     [--profile QUERY,...]

Imports ``trino_tpu_torch`` and ``chip_smoke`` from ``DIR`` (default: this
checkout), so an unpacked copy of another commit can be timed beside this
one in one call on one card: run it for the parent and the change in
turns (parent, change, change, parent). Builds the kernels, loads the
seven tables of phase 8a by CREATE TABLE AS, then runs Q6, Q1, Q3, Q10 and
Q18 (threshold 300) with the default session ``N + 1`` times each (default
5 + 1), the first a warm-up, and prints one line: the label, then per
query the median, least and largest wall of the other ``N`` (seconds, the
host clock around ``execute`` and a synchronize), and the card's name and
power limit. With ``--profile q03,q18`` (say) it then runs each named query
once more under ``torch.profiler`` and prints its wall there, its device
time (the kernels' and memsets' own time, summed), the host's time
blocked in ``cudaStreamSynchronize`` and the operators that took the most
host time and device time. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", default=None)
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("resident_walls: no CUDA device")
    import chip_smoke as C
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.metadata import Session
    from trino_tpu_torch.ops import hopper_kernels as HK
    from trino_tpu_torch.runtime import LocalQueryRunner

    if not C.__file__.startswith(root):
        sys.exit(f"resident_walls: imported {C.__file__}, not the tree at {root}")
    HK.build()
    dev = torch.device("cuda")
    runner = LocalQueryRunner(Session(catalog="memory", schema="default"), device=dev)
    runner.register_catalog("tpch", TpchConnector(scale=C.SCALE, device=dev))
    runner.register_catalog("memory", MemoryConnector(device=dev))
    for table in C.MEM_TABLES:
        runner.execute(f"CREATE TABLE {table} AS SELECT * FROM tpch.sf{C.SCALE}.{table}")
    walls = {}
    for q in C.MEM_QUERIES:
        sql = C.QUERIES.get(q, C.Q18_SF10)
        times = []
        for _ in range(args.reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.execute(sql)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rest = times[1:]
        walls[q] = (round(statistics.median(rest), 4), round(min(rest), 4), round(max(rest), 4))
    print(f"walls {args.label}: {walls}; card: {C.card_line()}", flush=True)
    for q in args.profile.split(",") if args.profile else ():
        profile_query(runner, C.QUERIES.get(q, C.Q18_SF10), f"{args.label} {q}")


def profile_query(runner, sql: str, label: str) -> None:
    """One run of ``sql`` under ``torch.profiler``: its wall, its device
    time, and the top operators by host and by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in ka
                    if e.device_type == DeviceType.CUDA) / 1e3
    syncs = [e for e in ka if e.key == "cudaStreamSynchronize"]
    sync_ms = sum(e.cpu_time_total for e in syncs) / 1e3
    print(f"profile {label}: wall {wall:.4f} s under the profiler, device time "
          f"{device_ms:.3f} ms, host blocked in {sum(e.count for e in syncs)} stream "
          f"synchronizes {sync_ms:.3f} ms", flush=True)
    for key in ("self_cpu_time_total", "self_cuda_time_total"):
        print(ka.table(sort_by=key, row_limit=15), flush=True)


if __name__ == "__main__":
    main()
