"""Device time of the hash probe, the sorts and the segment sums, by
kernel, on the card.

    python3 trino_tpu_torch/tools/kernel_device_times.py [--root DIR] [--joins FILE]

Imports ``trino_tpu_torch`` from ``DIR`` (default: this checkout), so an
unpacked copy of another commit can be measured beside this one in one run
on one card. Builds its kernels, then times ``hopper_kernels.hash_probe``
on the inputs of TPC-H Q3's two joins and Q10's three at SF10,
``hopper_kernels.group_sort`` on a page shaped like Q10's joined page at
SF10 (2,097,152 rows, 1,200,000 active, three keys of 21-bit ranges NULL
on the inactive rows), ``hopper_kernels.partition_epilogue`` on the same
page at 8 partitions, and ``hopper_kernels.segment_sum`` on two sorted
pages: 524,288 rows in 131,072 slots, 119,740 groups of about four rows
(the shape of Q3's at SF10), and 4,194,304 rows in groups of about four
(``chip_smoke.py``'s synthetic case). For each it prints the wrapper's
milliseconds (CUDA events over 10 calls after one; the host's work between
launches included) and the device microseconds a call spends in each
kernel and memset (``torch.profiler`` over 10 calls). The join inputs are
the probe calls of one run of the two queries through ``DIR``'s
``LocalQueryRunner`` (about a minute of host generation), saved to
``FILE`` (default: ``trino_tpu_torch/_build/kernel_inputs/joins_sf10.pt``
of this checkout, gitignored) by the first run and read by later ones,
so every commit is timed on the same inputs. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
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
    every hash_probe call, and saves them as ``[(label, args), ...]``."""
    from trino_tpu_torch.runtime import LocalQueryRunner

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(copy(y) for y in x)
        return x

    joins = []
    orig = HK.hash_probe
    runner = LocalQueryRunner.tpch(scale=10, device="cuda")
    try:
        for q, sql in QUERIES.items():
            k = [0]

            def tapped(*args, _q=q, _k=k):
                _k[0] += 1
                joins.append((f"{_q} join {_k[0]}", copy(args)))
                return orig(*args)

            HK.hash_probe = tapped
            runner.execute(sql)
    finally:
        HK.hash_probe = orig
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(joins, path)


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


def device_us(fn, reps: int = 10) -> dict:
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


def report(root: str, label: str, fn) -> None:
    ms = wrapper_ms(fn)
    us = device_us(fn)
    parts = ", ".join(f"{k} {v:.1f}" for k, v in sorted(us.items(), key=lambda kv: -kv[1]))
    print(f"[{root}] {label}: wrapper {ms:.4f} ms; device {sum(us.values()):.1f} us a call "
          f"({parts})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    here = Path(__file__).resolve().parents[2]
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--joins", default=str(
        here / "trino_tpu_torch" / "_build" / "kernel_inputs" / "joins_sf10.pt"))
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
    dev = torch.device("cuda")
    if not joins.exists():
        capture_joins(HK, joins)
    for label, args in torch.load(joins, map_location=dev):
        shape = f"n={args[3].shape[0]} m={args[4].shape[0]} B={args[5]} C={args[6]}"
        report(root, f"hash_probe, {label} ({shape})", lambda: HK.hash_probe(*args))
    del args
    torch.cuda.empty_cache()
    keys, payload, active = args = q10_page(dev)
    report(root, "group_sort, Q10-shaped page", lambda: HK.group_sort(*args))
    report(root, "partition_epilogue, the same page, 8 parts",
           lambda: HK.partition_epilogue(keys, [None] * len(keys), payload, active, 8))
    del args, keys, payload, active
    for label, shape in (("segment_sum, Q3-shaped rows (524,288 in 131,072 slots)",
                          (524_288, 119_740, 131_072, 1)),
                         ("segment_sum, 4,194,304 rows in groups of about four",
                          (4_194_304, 786_000, 786_016, 2))):
        v, w, starts = sorted_page(dev, *shape)
        report(root, label, lambda: HK.segment_sum(v, w, starts))


if __name__ == "__main__":
    main()
