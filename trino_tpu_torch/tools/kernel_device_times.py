"""Device time of the sorts and the segment sums, by kernel, on the card.

    python3 trino_tpu_torch/tools/kernel_device_times.py [--root DIR]

Imports ``trino_tpu_torch`` from ``DIR`` (default: this checkout), so an
unpacked copy of another commit can be measured beside this one in one run
on one card. Builds its kernels, then times ``hopper_kernels.group_sort``
on a page shaped like TPC-H Q10's joined page at SF10 (2,097,152 rows,
1,200,000 active, three keys of 21-bit ranges NULL on the inactive rows),
``hopper_kernels.partition_epilogue`` on the same page at 8 partitions,
and ``hopper_kernels.segment_sum`` on two sorted pages: 524,288 rows in
131,072 slots, 119,740 groups of about four rows (the shape of Q3's at
SF10), and 4,194,304 rows in groups of about four (``chip_smoke.py``'s
synthetic case). For each it prints the wrapper's milliseconds (CUDA events
over 10 calls after one; the host's work between launches included) and
the device microseconds a call spends in each kernel and memset
(``torch.profiler`` over 10 calls). Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch


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
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    root = ap.parse_args().root
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
