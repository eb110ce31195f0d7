"""Variants of ``hash_expand``'s scan pass, timed on the card.

    python3 trino_tpu_torch/tools/expand_scan_variants.py

Builds edited copies of ``csrc/hash_expand.cu`` with ``nvcc`` into
``trino_tpu_torch/_build/scan_variants/`` (tiles of 8, 16 and 24 rounds of
16-byte copies; and the look-back taken out, which leaves every tile's
offset at 0 and is timed only), and times each one's scan pass
(``hash_expand_scan``: the memset and the scan kernel; CUDA events over 20
launches after one) on a Q3-shaped ``emit`` (121,634,816 rows, 0.43 % of
them emitting one slot) and on an ``emit`` of zeros, the variants in turns,
forward then backward. Prints the card line, each variant's registers, and
one line per input and variant. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "csrc"
OUT = ROOT / "_build" / "scan_variants"
N = 121_634_816
ROUNDS = "constexpr int kRounds = 24;"
LOOK_BACK = "const int64_t off = tile == 0 ? 0 : look_back(status, tile);"
VARIANTS = {
    "24 rounds (as built)": {},
    "16 rounds": {ROUNDS: "constexpr int kRounds = 16;"},
    "8 rounds": {ROUNDS: "constexpr int kRounds = 8;"},
    "24 rounds, no look-back": {LOOK_BACK: "const int64_t off = 0;"},
}


def build(name: str, edits: dict) -> tuple:
    src = (CSRC / "hash_expand.cu").read_text()
    for old, new in edits.items():
        if old not in src:
            sys.exit(f"{name}: {old!r} is not in hash_expand.cu")
        src = src.replace(old, new)
    d = OUT / name.replace(" ", "_").replace(",", "").replace("(", "").replace(")", "")
    d.mkdir(parents=True, exist_ok=True)
    (d / "hash_expand.cu").write_text(src)
    for h in CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    return subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
         str(d / "hash_expand.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d / "lib.so"


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    libs = {}
    for name, (proc, path) in {n: build(n, e) for n, e in VARIANTS.items()}.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line]
        print(f"{name}: scan kernel {regs[-1]}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.hash_expand_scan.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [
            ctypes.c_void_p] * 4
        lib.hash_expand_tile_rows.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    inputs = {"Q3-shaped emit": (torch.rand(N, generator=gen, device=dev) < 0.0043).to(
        torch.int32), "emit of zeros": torch.zeros(N, dtype=torch.int32, device=dev)}
    stream = torch.cuda.current_stream().cuda_stream
    for label, emit in inputs.items():
        cap = max(1024, 1 << (max(int(emit.sum()), 1) - 1).bit_length())
        row = torch.empty(cap, dtype=torch.int64, device=dev)
        d = torch.empty(cap, dtype=torch.int32, device=dev)
        for name in list(libs) + list(libs)[::-1]:
            lib = libs[name]
            state = torch.empty(3 + -(-N // lib.hash_expand_tile_rows()), dtype=torch.int64,
                                device=dev)
            ms = time_ms(lambda: lib.hash_expand_scan(
                emit.data_ptr(), N, cap, state.data_ptr(), row.data_ptr(), d.data_ptr(),
                stream))
            print(f"{label}, {name}: scan pass {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
