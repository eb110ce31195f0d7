"""``segment_sort`` built from this checkout's ``csrc/`` beside variants of
``segment_sort.cu`` that undo one design choice each, timed on one card.

    python3 trino_tpu_torch/tools/segment_sort_variants.py

Each variant is the tree's ``segment_sort.cu`` with one substitution:

- ``match_any``: a step's lanes of one digit found by ``__match_any_sync``
  in place of eight ballots (``digit_peers``);
- ``count_scatter_2``: the large segments' count and scatter passes at two
  blocks an SM (their launch bounds) in place of three;
- ``small_3``: the small segments' batches at three blocks an SM in place
  of four.

Every library is built (``hopper_kernels.build``, the variants into
``trino_tpu_torch/_build/variants/``), then each sorts two seeded pages of
67,108,864 slots, 59,992,541 of them active (the inactive tail in the last
group, its values one), keyed by a price in cents (24 bits) with a weight
of two columns: T4's shape (a group per about 60 rows) and T3's (a group
per about 24,934 rows). Each call's outputs must be the tree's bit for bit;
each is timed by ``torch.profiler`` (device microseconds a call by kernel,
over three calls after one). Prints the card line first. Needs a card and
``nvcc``.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from trino_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from trino_tpu_torch.tools.kernel_device_times import device_us  # noqa: E402

OUT = ROOT / "trino_tpu_torch" / "_build" / "variants"
SLOTS, ACTIVE = 67_108_864, 59_992_541
SHAPES = {"t4 shape": 60, "t3 shape": 24_934}

BALLOTS = "      const unsigned peers = digit_peers(d);"
COUNT = "__launch_bounds__(kThreads, 3)\nsort_count_kernel("
SCATTER = "__launch_bounds__(kThreads, 3)\nsort_scatter_kernel("
SMALL = "return sizeof(K) == 4 ? (small ? 4 : 3) : 2;"


def variants(src: str) -> dict:
    out = {
        "tree": src,
        "match_any": src.replace(BALLOTS, "      const unsigned peers = __match_any_sync("
                                          "0xffffffffu, d);"),
        "count_scatter_2": src.replace(COUNT, COUNT.replace("3)", "2)"))
                              .replace(SCATTER, SCATTER.replace("3)", "2)")),
        "small_3": src.replace(SMALL, "return sizeof(K) == 4 ? 3 : 2;"),
    }
    for name, text in out.items():
        if name != "tree" and text == src:
            raise RuntimeError(f"variant {name} changed nothing: segment_sort.cu moved on")
    return out


def build_all(texts: dict) -> dict:
    """Each variant's csrc copy built into its own directory, all at once."""
    libs, errors = {}, []

    def build(name, text):
        try:
            csrc = OUT / name / "csrc"
            if csrc.exists():
                shutil.rmtree(csrc)
            shutil.copytree(ROOT / "trino_tpu_torch" / "csrc", csrc)
            (csrc / "segment_sort.cu").write_text(text)
            libs[name] = HK.build(csrc, OUT / name / "build")
        except Exception as e:  # reported below, after every build ends
            errors.append((name, e))

    threads = [threading.Thread(target=build, args=kv, name=f"build-{kv[0]}")
               for kv in texts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"builds failed: {errors}")
    return libs


def page(per_group: int, seed: int):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    active = torch.arange(SLOTS, device=dev) < ACTIVE
    new_group = (torch.rand(SLOTS, generator=g, device=dev) < 1.0 / per_group) & active
    new_group[0] = True
    cents = torch.randint(90_000, 10_494_951, (SLOTS,), generator=g, device=dev)
    cents[ACTIVE:] = 1
    valid = torch.rand(SLOTS, generator=g, device=dev) < 0.97
    return new_group, cents, [active, valid], True


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    src = (ROOT / "trino_tpu_torch" / "csrc" / "segment_sort.cu").read_text()
    texts = variants(src)
    libs = build_all(texts)
    pages = {label: page(per, seed=k + 3) for k, (label, per) in enumerate(SHAPES.items())}
    want = {}
    for name in texts:
        HK._LIB = HK.bind(libs[name])
        for label, args in pages.items():
            got = HK.segment_sort(*args)
            torch.cuda.synchronize()
            if name == "tree":
                want[label] = got
            elif not all(torch.equal(a, b) for a, b in zip(got, want[label])):
                sys.exit(f"{name} [{label}] differs from the tree's outputs")
            us, _ = device_us(lambda: HK.segment_sort(*args), 3)
            parts = ", ".join(f"{k} {v:.1f}" for k, v in sorted(us.items(), key=lambda kv: -kv[1]))
            print(f"{name} [{label}]: device {sum(us.values()):.1f} us a call ({parts})",
                  flush=True)


if __name__ == "__main__":
    main()
