"""``segment_agg`` and ``segment_agg_direct`` built from this checkout's
``csrc/`` against an edited copy of it, on one card.

    python3 trino_tpu_torch/tools/agg_kernel_ab.py --other DIR

Builds both kernel libraries (``hopper_kernels.build``; ``DIR``'s into
``trino_tpu_torch/_build/agg_ab/``) and prints, for each, the reduce
kernels' registers, stack and spill as ptxas reports them and the source
line of every local-memory access in them (``nvcc -cubin -lineinfo``, then
``nvdisasm -g``). Then each library in turn runs ``chip_smoke.py``'s phase
2 cases of both kernels, a sort-path page of T1's size (67,108,864 rows,
about 2,284 groups; the long tail's moments and rows sets) and direct pages
of T2's size (67,108,864 rows, G = 6) and Q12's (524,288 rows, G = 8) with
T2's requests: the two libraries' outputs must be the same bits, and every
case of 4,194,304 rows or more is timed in the order other, tree, tree,
other (CUDA events over 10 calls after one). Last, a page of Q3's shape
at SF10 (524,288 rows, 131,072 slots, about 119,700 groups of four rows,
three keys, an integer sum and a count), whose wrapper time is the host's:
timed in 10 alternations of the two libraries, with the host microseconds
of the wrapper's weight-column check (``segment_agg_mask_columns``). ``DIR``
must export the C interface this checkout's wrappers bind. Prints the card
line first. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT.parent))

from trino_tpu_torch.ops import hopper_kernels as HK  # noqa: E402

OUT = ROOT / "_build" / "agg_ab"
REDUCE_KERNELS = {"segment_agg.cu": "agg_reduce_kernel",
                  "segment_agg_direct.cu": "direct_reduce_kernel"}
T1_ROWS = 67_108_864
TIMED_ROWS = 4_194_304


def ptxas_lines(lib: Path) -> list:
    """The reduce kernels' ptxas summaries from ``build``'s log."""
    log = (lib.parent / "build.log").read_text().splitlines()
    out = []
    for i, line in enumerate(log):
        for kernel in REDUCE_KERNELS.values():
            if "Compiling entry" in line and kernel in line:
                used = log[i + 3].split(":", 1)[1].strip()
                out.append(f"{kernel}: {log[i + 2].strip()}; {used}")
    return out


def local_accesses(csrc: Path, tag: str) -> list:
    """Each local-memory load and store of the reduce kernels, with the
    source line above it in the disassembly."""
    cuda = Path(HK._nvcc()).parent
    out = []
    for src, kernel in REDUCE_KERNELS.items():
        cubin = OUT / f"{tag}_{Path(src).stem}.cubin"
        subprocess.run([str(cuda / "nvcc"), *HK.NVCC_FLAGS[:4], "-lineinfo", "-cubin", "-o",
                        str(cubin), str(csrc / src)], check=True, capture_output=True)
        sass = subprocess.run([str(cuda / "nvdisasm"), "-g", "-c", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        fn = loc = None
        for line in sass.splitlines():
            m = re.search(r"^\.text\.(\S+):", line)
            if m:
                fn = m.group(1)
            m = re.search(r'//## File "([^"]+)", line (\d+)', line)
            if m:
                loc = f"{Path(m.group(1)).name}:{m.group(2)}"
            if fn and kernel in fn and re.search(r"\b(STL|LDL)", line):
                out.append(f"{kernel}: {loc} {line.split('*/')[-1].strip()}")
    return out


def sort_path_cases(C, dev):
    yield from C.long_tail_cases(HK, dev)
    yield from C.segment_agg_cases(HK, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for part in ("moments", "rows"):
        new_group = torch.rand(T1_ROWS, generator=gen, device=dev) < 2284 / T1_ROWS
        new_group[0] = True
        active = torch.rand(T1_ROWS, generator=gen, device=dev) < 0.97
        keys, _ = C._agg_page(dev, gen, T1_ROWS, new_group, active, n_keys=1)
        reqs, outs = C._long_tail_requests(HK, dev, gen, T1_ROWS, active, part)
        groups = new_group.sum()
        yield f"{part} at T1's size", (new_group, groups, C.round_capacity(int(groups), 16),
                                       active, keys, reqs, outs, None)


def direct_cases(C, dev):
    yield from C.direct_variance_cases(HK, dev, 1 << 20)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    R, O = HK.AggRequest, HK.AggOutput
    for label, n, domains in (("T2's requests at Q12's size, G=8", 524_288, (8,)),
                              ("T2's requests at T2's size, G=6", T1_ROWS, (6,))):
        active = torch.rand(n, generator=gen, device=dev) < 0.9
        keys = [(torch.randint(0, max(D - 1, 1), (n,), generator=gen,
                               device=dev).to(torch.int32),
                 torch.rand(n, generator=gen, device=dev) < 0.97) for D in domains]
        reqs, outs = [], []
        for lo, hi, op in ((100, 5001, "stddev_samp"), (90_000, 10_500_000, "var_samp"),
                           (0, 11, "stddev_pop"), (0, 9, "var_pop")):
            v = torch.randint(lo, hi, (n,), generator=gen, device=dev)
            ok = torch.rand(n, generator=gen, device=dev) < 0.95
            at = len(reqs)
            reqs += [R("count", valid=ok), R("fsum", v, ok, divisor=100.0),
                     R("fsum", v, ok, divisor=100.0, power=2)]
            outs += [O(op, (at, at + 1, at + 2), torch.float64),
                     O("value", (at + 2, at), torch.float64)]
        yield label, (keys, domains, active, reqs, outs)


def q3_shape(C, dev):
    """A sorted page of Q3's aggregation at SF10 (module docstring)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    n, n_act = 524_288, 479_000
    new_group = torch.rand(n, generator=gen, device=dev) < 0.25
    new_group[0] = True
    new_group[n_act:] = False
    active = torch.arange(n, device=dev) < n_act
    keys, _ = C._agg_page(dev, gen, n, new_group, active)
    vals = torch.randint(0, 10**11, (n,), generator=gen, device=dev)
    reqs = [HK.AggRequest("sum", vals, active), HK.AggRequest("count", valid=active)]
    outs = [HK.AggOutput("value", (0, 1), torch.int64)]
    return (new_group, new_group.sum(), 131_072, active, keys, reqs, outs, None)


def tensors(name: str, res) -> list:
    """A call's outputs as raw bytes (bools as they are)."""
    if name == "segment_agg":
        starts, exists, keys, outs, dest = res
        flat = [starts, exists] + [t for kv in keys for t in kv] + [t for o in outs for t in o]
        flat += [] if dest is None else [dest]
    else:
        exists, keys, outs = res
        flat = [exists] + [t for kv in keys for t in kv] + [t for o in outs for t in o]
    return [t.clone() if t.dtype == torch.bool else t.contiguous().view(torch.uint8).clone()
            for t in flat]


def wrapper_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="an edited copy of csrc/")
    other = Path(ap.parse_args().other).resolve()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}

    def build(tag):
        paths[tag] = HK.build() if tag == "tree" else HK.build(other, OUT)

    builds = [threading.Thread(target=build, args=(tag,), name=f"build-{tag}")
              for tag in ("tree", "other")]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    libs = {k: HK.bind(p) for k, p in paths.items()}
    for tag, csrc in (("other", other), ("tree", HK.CSRC)):
        for line in ptxas_lines(paths[tag]) + local_accesses(csrc, tag):
            print(f"[{tag}] {line}", flush=True)
    import chip_smoke as C

    dev = torch.device("cuda")
    same_all = True
    for name, cases in (("segment_agg", sort_path_cases(C, dev)),
                        ("segment_agg_direct", direct_cases(C, dev))):
        fn = getattr(HK, name)
        for label, args in cases:
            got = {}
            for tag in ("other", "tree"):
                HK._LIB = libs[tag]
                got[tag] = tensors(name, fn(*args))
            same = all(torch.equal(x, y) for x, y in zip(got["other"], got["tree"]))
            same_all = same_all and same
            rows = args[0].shape[0] if name == "segment_agg" else args[2].shape[0]
            line = f"{name} [{label}, n={rows}]: the same bits {same}"
            if rows >= TIMED_ROWS:
                ms = {"other": [], "tree": []}
                for tag in ("other", "tree", "tree", "other"):
                    HK._LIB = libs[tag]
                    ms[tag].append(wrapper_ms(lambda: fn(*args)))
                line += "; ms " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in ms.items())
            print(line, flush=True)
            del got, args
            torch.cuda.empty_cache()
    args = q3_shape(C, dev)
    ms = {"other": [], "tree": []}
    for _ in range(10):
        for tag in ("other", "tree"):
            HK._LIB = libs[tag]
            ms[tag].append(wrapper_ms(lambda: HK.segment_agg(*args)))
    for tag, v in ms.items():
        print(f"segment_agg [Q3's shape, n=524288], {tag}: ms median {statistics.median(v):.4f}, "
              f"min {min(v):.4f}, max {max(v):.4f} over {len(v)} timings", flush=True)
    t0 = time.perf_counter()
    for _ in range(1000):
        HK.segment_agg_mask_columns(args[5], args[3])
    print(f"segment_agg_mask_columns on Q3's shape: "
          f"{(time.perf_counter() - t0) * 1000:.2f} host us a call", flush=True)
    print("every case the same bits" if same_all else "the libraries differ", flush=True)
    if not same_all:
        sys.exit(1)


if __name__ == "__main__":
    main()
