"""Variants of the hash probe and of the repartition epilogue, timed on the
card.

    python3 trino_tpu_torch/tools/probe_epilogue_variants.py [--joins FILE]

Builds the kernel library from edited copies of ``csrc/`` with ``nvcc``
into ``trino_tpu_torch/_build/probe_epilogue_variants/`` (the variants
below: each edit applies to the one source that holds its text), binds
each in turn to ``hopper_kernels``, checks it against the plain versions,
and times ``hopper_kernels.partition_epilogue`` on a page shaped like TPC-H
Q10's joined page at SF10 at 8 partitions and ``hopper_kernels.hash_probe``
on TPC-H Q3's second join and Q10's third join at SF10 (the inputs
``kernel_device_times.py`` saves to ``FILE``; without them, the probe is
not timed): the wrapper's milliseconds (CUDA events over 10 calls after
one) and the device microseconds a call by kernel (``torch.profiler``),
the variants in turns, forward then backward. Prints the card line and
each variant's registers. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT.parent))

from trino_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from trino_tpu_torch.tools.kernel_device_times import (  # noqa: E402
    device_us, q10_page, wrapper_ms)

OUT = ROOT / "_build" / "probe_epilogue_variants"
SOURCES = ("hash_probe.cu", "partition_epilogue.cu", "radix_pass.cuh", "join_keys.cuh")
VARIANTS = {
    "as built": {},
    "probe 4 rows a thread": {
        "constexpr int kRows = 2;  // probe rows a thread holds at once":
        "constexpr int kRows = 4;  // probe rows a thread holds at once"},
    "probe activity read in its own step": {
        "      act[k] = next[k];\n      next[k] = i[k] + step < n && probe_active[i[k] + step];":
        "      act[k] = i[k] < n && probe_active[i[k]];"},
    "probe outputs stored plainly": {
        "        __stcs(bucket_p + i[k], take[k] ? b[k] : 0);\n"
        "        if (count != emit) __stcs(count + i[k], hits);":
        "        bucket_p[i[k]] = take[k] ? b[k] : 0;\n"
        "        if (count != emit) count[i[k]] = hits;",
        "      __stcs(emit + i[k], left_outer ? (act[k] ? (hits > 1 ? hits : 1) : 0) : hits);":
        "      emit[i[k]] = left_outer ? (act[k] ? (hits > 1 ? hits : 1) : 0) : hits;"},
    "epilogue sweep staging 68 KB of columns at once": {
        "constexpr int kStageBytes = 20 * 1024;": "constexpr int kStageBytes = 68 * 1024;"},
}
# kernels whose registers are printed
KERNELS = ("probe_kernelILi1E", "claim_kernel", "buckets_kernel", "sweep_kernel",
           "count_kernel")


def variant_csrc(name: str, edits: dict) -> Path:
    """A copy of csrc/ with each edit applied to the one source that has it."""
    d = OUT / "".join(c if c.isalnum() else "_" for c in name) / "csrc"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(HK.CSRC, d)
    for old, new in edits.items():
        hits = [d / f for f in SOURCES if old in (d / f).read_text()]
        if len(hits) != 1 or hits[0].read_text().count(old) != 1:
            sys.exit(f"{name}: {old!r} is not at one place of one source")
        hits[0].write_text(hits[0].read_text().replace(old, new))
    return d


def registers(lib: Path) -> str:
    log = (lib.parent / "build.log").read_text().splitlines()
    out = []
    for k in KERNELS:
        at = [i for i, line in enumerate(log) if k in line and "Compiling" in line]
        regs = [line.split("Used", 1)[1].split(",")[0].strip() for line in log[at[0]:at[0] + 4]
                if "Used" in line] if at else ["?"]
        out.append(f"{k.split('ILi')[0]} {regs[0]}")
    return ", ".join(out)


def same_probe(got, want, pa) -> bool:
    rows = pa.clone()
    rows[-1] = True
    return (all(torch.equal(got[k], want[k]) for k in ("counts", "emit", "max_count"))
            and all(torch.equal(got[k][rows], want[k][rows]) for k in ("bucket_p", "count")))


def same_epilogue(got, want) -> bool:
    return (all(torch.equal(a.view(torch.int64) if a.dtype == torch.float64 else a,
                            b.view(torch.int64) if b.dtype == torch.float64 else b)
                and torch.equal(av, bv) for (a, av), (b, bv) in zip(got[0], want[0]))
            and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])))


def report(label: str, fn) -> None:
    ms = wrapper_ms(fn)
    us = device_us(fn)
    parts = ", ".join(f"{k} {v:.1f}" for k, v in sorted(us.items(), key=lambda kv: -kv[1]))
    print(f"{label}: wrapper {ms:.4f} ms; device {sum(us.values()):.1f} us ({parts})",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--joins", default=str(ROOT / "_build" / "kernel_inputs" / "joins_sf10.pt"))
    joins_file = Path(ap.parse_args().joins)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    dirs = {name: variant_csrc(name, edits) for name, edits in VARIANTS.items()}
    libs, errors = {}, []

    def build(name):
        try:
            libs[name] = HK.build(dirs[name], dirs[name].parent / "build")
        except RuntimeError as e:
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=build, args=(n,), name=f"build-{n}")
               for n in VARIANTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        sys.exit("\n".join(errors))
    for name in VARIANTS:
        print(f"{name}: {registers(libs[name])}", flush=True)
    dev = torch.device("cuda")
    keys, payload, active = q10_page(dev)
    eargs = (keys, [None] * len(keys), payload, active, 8)
    joins = []
    if joins_file.exists():
        joins = [(label, args) for label, args in torch.load(joins_file, map_location=dev)
                 if label in ("q03 join 2", "q10 join 3")]
    want_ep = HK.partition_epilogue_plain(*eargs)
    want_pr = [HK.hash_probe_plain(*args) for _, args in joins]
    for name in VARIANTS:
        HK._LIB = HK.bind(libs[name])
        if not same_epilogue(HK.partition_epilogue(*eargs), want_ep):
            sys.exit(f"{name}: partition_epilogue differs from its plain version")
        for (label, args), want in zip(joins, want_pr):
            if not same_probe(HK.hash_probe(*args), want, args[3]):
                sys.exit(f"{name}: hash_probe [{label}] differs from its plain version")
        print(f"{name}: bit-exact", flush=True)
    del want_ep, want_pr
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        HK._LIB = HK.bind(libs[name])
        report(f"{name}: partition_epilogue, Q10-shaped page, 8 parts",
               lambda: HK.partition_epilogue(*eargs))
        for label, args in joins:
            report(f"{name}: hash_probe, {label}", lambda: HK.hash_probe(*args))


if __name__ == "__main__":
    main()
