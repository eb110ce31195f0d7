"""Variants of the group sort's one-sweep pass, timed on the card.

    python3 trino_tpu_torch/tools/sort_pass_variants.py

Builds the kernel library from edited copies of ``csrc/`` with ``nvcc``
into ``trino_tpu_torch/_build/sort_variants/`` (in ``radix_pass.cuh``: the
pass's tile at 8, 12 and 16 rows a thread; its look-back reading 1, 4 or 8
earlier tiles a step; its warp ranking by eight ballots instead of
__match_any_sync; the row indices read again when the tile is staged
instead of kept in registers, at 16, 24 and 32 rows a thread; in
``group_sort.cu``: the stats and compose kernels at eight blocks an SM, or
one row a thread at a time), binds each in turn to
``hopper_kernels.group_sort``, and times it on a page shaped like TPC-H
Q10's joined page at SF10 (2,097,152 rows, 1,200,000 active, three keys of
21-bit ranges NULL on the inactive rows: one 64-bit composite, eight
passes): the wrapper (CUDA events over 10 calls after one) and its
``phase_events`` split, the variants in turns, forward then backward. Each
variant is checked bit for bit against ``group_sort_plain`` first. Prints
the card line, each variant's pass registers and one line per variant and
turn. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT.parent))

from trino_tpu_torch.ops import hopper_kernels as HK  # noqa: E402

OUT = ROOT / "_build" / "sort_variants"
ITEMS = "constexpr int kSweepItems = 16;"
WINDOW = "constexpr int kSweepWindow = 4;"
# the pass's warp ranking (warp_rank, shared with the repartition epilogue's
# sweep) by eight ballots, one a digit bit
BALLOTS = {
    """    const bool ok = d != kNoDigit;
    const unsigned peers = __match_any_sync(0xffffffffu, d);""":
    """    const bool ok = d != kNoDigit;
    unsigned peers = __ballot_sync(0xffffffffu, ok);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const bool bit = (d >> b) & 1;
      const unsigned set = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? set : ~set;
    }""",
}
# the row indices not kept in registers but read again when the tile is staged
RELOAD = {
    """  int32_t idx[kSweepItems];
""": "",
    """    idx[it] = i < n ? (idx_in != nullptr ? idx_in[i] : static_cast<int32_t>(i)) : 0;
  }
#pragma unroll
  for (int it = 0; it < kSweepItems; ++it) {
    const int64_t i = row0 + it * 32 + lane;
    key[it] = i < n ? keys_in[gather_keys ? static_cast<int64_t>(idx[it]) : i] : 0;""":
    """    key[it] = i < n ? keys_in[gather_keys ? static_cast<int64_t>(idx_in[i]) : i] : 0;""",
    """      s_idx[p] = idx[it];""":
    """      const int64_t i = row0 + it * 32 + lane;
      s_idx[p] = idx_in != nullptr ? idx_in[i] : static_cast<int32_t>(i);""",
}
VARIANTS = {
    "16 rows a thread, window 4 (as built)": {},
    "window 1": {WINDOW: "constexpr int kSweepWindow = 1;"},
    "window 8": {WINDOW: "constexpr int kSweepWindow = 8;"},
    "8 rows a thread (2,048-row tiles)": {ITEMS: "constexpr int kSweepItems = 8;"},
    "12 rows a thread (3,072-row tiles)": {ITEMS: "constexpr int kSweepItems = 12;"},
    "row indices read again when staged": RELOAD,
    "the same, 24 rows a thread (6,144-row tiles)": {
        ITEMS: "constexpr int kSweepItems = 24;", **RELOAD},
    "the same, 32 rows a thread (8,192-row tiles)": {
        ITEMS: "constexpr int kSweepItems = 32;", **RELOAD},
    "ranked by eight ballots": BALLOTS,
    "stats and compose at eight blocks an SM": {
        "const int cap = hopper::sm_count() * 4;": "const int cap = hopper::sm_count() * 8;"},
    "stats and compose one row a thread at a time": {
        "constexpr int kUnroll = 4;": "constexpr int kUnroll = 1;"},
}


def variant_csrc(name: str, edits: dict) -> Path:
    """A copy of csrc/ with each edit applied to the one source that has it."""
    d = OUT / "".join(c if c.isalnum() else "_" for c in name) / "csrc"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(HK.CSRC, d)
    for old, new in edits.items():
        hits = [f for f in (d / "radix_pass.cuh", d / "group_sort.cu") if old in f.read_text()]
        if len(hits) != 1:
            sys.exit(f"{name}: {old!r} is in {len(hits)} of radix_pass.cuh and group_sort.cu")
        if hits[0].read_text().count(old) != 1:
            sys.exit(f"{name}: {old!r} is not one place in {hits[0].name}")
        hits[0].write_text(hits[0].read_text().replace(old, new))
    return d


def q10_page(dev):
    """chip_smoke.py's Q10-shaped page: keys (c_custkey bigint, c_name int32
    code, c_acctbal bigint) valid exactly on the 1,200,000 active rows, and
    a revenue column."""
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


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split_ms(args, reps: int = 10) -> dict:
    HK.group_sort(*args)
    spans = []
    for _ in range(reps):
        HK.group_sort(*args, phase_events=spans)
    torch.cuda.synchronize()
    ms = {}
    for phase, a, b in spans:
        ms[phase] = ms.get(phase, 0.0) + a.elapsed_time(b) / reps
    return ms


def use(path: Path) -> None:
    """Bind the variant's library to the wrappers."""
    HK.SORT_TILE_ROWS = ctypes.CDLL(str(path)).group_sort_tile_rows()
    HK._LIB = HK.bind(path)


def main() -> None:
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
    for name, path in libs.items():
        log = (path.parent / "build.log").read_text().splitlines()
        at = [i for i, line in enumerate(log) if "sweep_pass" in line and "Compiling" in line]
        regs = [line.split(":", 1)[1].strip() for line in log[at[0]:at[0] + 4]
                if "registers" in line] if at else ["?"]
        print(f"{name}: pass {regs[0]}", flush=True)
    dev = torch.device("cuda")
    args = q10_page(dev)
    want = HK.group_sort_plain(*args)
    for name in VARIANTS:
        use(libs[name])
        got = HK.group_sort(*args)
        same = (all(torch.equal(a, b) and torch.equal(av, bv)
                    for (a, av), (b, bv) in zip(got[0], want[0]))
                and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])))
        if not same:
            sys.exit(f"{name}: differs from group_sort_plain")
        print(f"{name}: bit-exact", flush=True)
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        use(libs[name])
        ms = time_ms(lambda: HK.group_sort(*args))
        sp = split_ms(args)
        print(f"Q10-shaped page, {name}: group_sort {ms:.4f} ms; split stats "
              f"{sp['stats']:.4f}, compose {sp['compose']:.4f}, passes {sp['passes']:.4f}, "
              f"finish {sp['finish']:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
