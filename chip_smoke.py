"""Chip smoke test of the PyTorch/CUDA port (trino_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, and the final JSON line is not
printed):

1. Card and build: the card's name and power limit, then the Hopper kernels
   compiled from ``trino_tpu_torch/csrc/`` (build seconds and the ptxas
   report).
2. Kernels against their plain torch versions on the card, bit-exact: each
   wrapper at the main path's shape (one lineitem page of TPC-H SF10, G = 12)
   and at edge shapes, timed with CUDA events beside its bytes bound, its
   plain version and, where one torch call computes the same function, that
   call.
3. TPC-H Q6 and Q1 at SF10 through ``LocalQueryRunner.tpch(scale=10)`` with
   the default session: the launch counts of the run, rows identical to the
   ``pallas_aggregation=off`` path and to an independent numpy computation
   over the port's generator, and the wall seconds of each query. The
   grouped sums are also checked and timed on the inputs Q1 gave them (its
   real gid and weight distribution); those times go in the kernels line.
4. A ``kernels`` JSON line, then the contract's last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is visible, or
when the port is not importable beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
}


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
    """(label, values int64, weight, gid, G) cases for the grouped sums."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def rnd(n, lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)

    def case(label, n, G, lo=-(10**12), hi=10**12, wrate=0.8, gmax=None):
        vals = rnd(n, lo, hi)
        w = torch.rand(n, generator=gen, device=dev) < wrate
        gid = rnd(n, 0, gmax or G, torch.int32)
        return label, vals, w, gid, G

    yield case("uniform n=%d G=%d" % (n_main, G_Q1), n_main, G_Q1, 1, 10**9, 0.98)
    yield case("unaligned n", 1_000_003, G_Q1)
    yield case("n=0", 0, G_Q1)
    yield case("G=1", 777_777, 1)
    yield case("G=64", 777_777, 64)
    yield case("empty groups", 500_001, G_Q1, gmax=5)
    label, vals, w, _, G = case("gid out of range", 400_003, 6)
    yield label, vals, w, rnd(400_003, -3, 9, torch.int32), G
    yield case("wrapping int64", 1_000_000, 5, -(2**62), 2**62, 1.0)
    label, vals, w, gid, G = case("all-false mask", 300_000, G_Q1)
    yield "all-false mask", vals, torch.zeros_like(w), gid, G


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


def time_grouped(HK, name, v, w, gid, G) -> tuple:
    """(kernel ms, plain ms, index_add_ ms, bound ms, bound_by) of one
    grouped-sum wrapper on these inputs."""
    n = v.shape[0]
    gid64 = gid.to(torch.int64)
    pre = torch.where(w, v.to(torch.int64), 0)
    wrapper = getattr(HK, name)
    ms = time_ms(lambda: wrapper(v, w, gid, G))
    plain = time_ms(lambda: HK.grouped_sum_plain(v, w, gid, G))
    lib = time_ms(
        lambda: torch.zeros(G, dtype=torch.int64, device=v.device).index_add_(0, gid64, pre)
    )
    b, by = bound_ms(n * (v.element_size() + 1 + 4) + G * 8, 2 * n)
    return ms, plain, lib, b, by


class LaunchTap:
    """Wraps the grouped-sum wrappers for the length of one query: CUDA
    events around each call give the time of the main path's own launches,
    and each wrapper's first inputs (Q1's real page: its gid and weight
    distribution) are kept to be checked and timed again afterwards."""

    NAMES = ("grouped_sum_i64", "grouped_sum_i32")

    def __init__(self, HK):
        self.HK = HK
        self.orig = {n: getattr(HK, n) for n in self.NAMES}
        self.events = {n: [] for n in self.NAMES}
        self.inputs = {}

    def __enter__(self):
        for name, fn in self.orig.items():
            def tapped(*args, _name=name, _fn=fn):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                self.events[_name].append((start, end))
                self.inputs.setdefault(_name, args)
                return out
            setattr(self.HK, name, tapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.HK, name, fn)

    def launch_ms(self, name) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[name]]


def check_q1_page(HK, tap: LaunchTap, results: dict) -> None:
    """Each grouped sum on the inputs Q1's path gave it: bit-exact against
    its plain version, timed beside its bound; these times replace the
    uniform case's in the kernels line."""
    for name in tap.NAMES:
        in_run = tap.launch_ms(name)
        v, w, gid, G = tap.inputs[name]
        got = getattr(HK, name)(v, w, gid, G)
        want = HK.grouped_sum_plain(v, w, gid, G)
        if not torch.equal(got, want):
            fail(f"{name} [Q1 page] differs from its plain version: "
                 f"{got.tolist()} vs {want.tolist()}")
        counts = torch.bincount(gid[w].to(torch.int64), minlength=G)
        print(f"  {name} [Q1 page n={v.shape[0]} G={G}]: bit-exact; weight share "
              f"{float(w.float().mean()):.4f}, rows per group {counts.tolist()}",
              flush=True)
        print(f"  {name}: {len(in_run)} launches inside Q1, "
              f"{sum(in_run):.4f} ms in all, each {[round(t, 4) for t in in_run]}",
              flush=True)
        ms, plain, lib, b, by = time_grouped(HK, name, v, w, gid, G)
        print(f"  {name} [Q1 page]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"index_add_ {lib:.4f} ms, bound {b:.4f} ms ({by})", flush=True)
        results[name].update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                             bound_by=by)


def check_kernels(HK, n_main: int, dev) -> dict:
    """Every wrapper against its plain version; timings at the main shape."""
    results = {}
    for name, vdtype in (("grouped_sum_i64", torch.int64), ("grouped_sum_i32", torch.int32)):
        wrapper = getattr(HK, name)
        worst = 0
        timing = None
        for label, vals, w, gid, G in grouped_cases(n_main, dev):
            v = vals.to(vdtype)
            got = wrapper(v, w, gid, G)
            want = HK.grouped_sum_plain(v, w, gid, G)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            if not torch.equal(got, want):
                fail(f"{name} [{label}] differs from its plain version: "
                     f"{got.tolist()[:8]} vs {want.tolist()[:8]}")
            worst = max(worst, err)
            print(f"  {name} [{label}]: bit-exact", flush=True)
            if timing is None:
                timing = time_grouped(HK, name, v, w, gid, G)
        ms, plain, lib, b, by = timing
        results[name] = {
            "name": name, "route": "cuda",
            "source": "trino_tpu_torch/csrc/grouped_sum.cu",
            "replaces": {
                "grouped_sum_i64": "trino_tpu/ops/pallas_kernels.py:217",
                "grouped_sum_i32": "trino_tpu/ops/pallas_kernels.py:238",
            }[name],
            "launches": 0, "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
        }
        print(f"  {name} [uniform]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"index_add_ {lib:.4f} ms, bound {b:.4f} ms ({by})", flush=True)

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
# phase 3: Q6 and Q1 at SF10
# --------------------------------------------------------------------------- #


def numpy_oracle(g, conn):
    """Q1's sums and counts and Q6's revenue from the port's generator, in
    numpy int64, as rows in the engine's output form."""
    total = conn.split_count("lineitem", SCALE)
    rf = conn.dictionary("lineitem", "l_returnflag", SCALE)
    ls = conn.dictionary("lineitem", "l_linestatus", SCALE)
    G = (len(rf), len(ls))
    acc = np.zeros((6,) + G, dtype=np.int64)  # qty, price, disc_price, charge, disc, count
    revenue = np.int64(0)
    gen_secs = 0.0
    for s in range(total):
        t0 = time.perf_counter()
        d = g.generate_split("lineitem", SCALE, s, total).columns
        gen_secs += time.perf_counter() - t0
        qty = d["l_quantity"].astype(np.int64)
        price = d["l_extendedprice"].astype(np.int64)
        disc = d["l_discount"].astype(np.int64)
        tax = d["l_tax"].astype(np.int64)
        ship = d["l_shipdate"].astype(np.int64)
        keep = ship <= 10471  # DATE '1998-12-01' - INTERVAL '90' DAY
        flat = d["l_returnflag"].astype(np.int64) * G[1] + d["l_linestatus"]
        dp = price * (100 - disc)
        for gi in np.unique(flat[keep]):
            m = keep & (flat == gi)
            a, b = divmod(int(gi), G[1])
            for i, v in enumerate((qty, price, dp, dp * (100 + tax), disc)):
                acc[i, a, b] += v[m].sum(dtype=np.int64)
            acc[5, a, b] += int(m.sum())
        lo, hi, dlo, dhi, qhi = Q6_PRED
        k6 = (ship >= lo) & (ship < hi) & (disc >= dlo) & (disc <= dhi) & (qty < qhi)
        revenue += (price * disc)[k6].sum(dtype=np.int64)

    def avg(s, n):  # round-half-up decimal avg, as the engine computes it
        half = n // 2
        return (s + half) // n if s >= 0 else -((-s + half) // n)

    q1 = []
    for a in range(G[0]):
        for b in range(G[1]):
            n = int(acc[5, a, b])
            if n == 0:
                continue
            sq, sp, sd, sc, sdisc = (int(acc[i, a, b]) for i in range(5))
            q1.append((
                rf.values[a], ls.values[b], sq / 100, sp / 100, sd / 10**4,
                sc / 10**6, avg(sq, n) / 100, avg(sp, n) / 100, avg(sdisc, n) / 100, n,
            ))
    print(f"  generating the {total} lineitem splits on the host: "
          f"{gen_secs:.3f} s of the oracle's pass", flush=True)
    return q1, [(int(revenue) / 10**4,)]


def run_queries(HK, dev, kernels: dict) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from trino_tpu_torch.connectors.tpch import generator as g
    from trino_tpu_torch.runtime import LocalQueryRunner

    queries = QUERIES
    runner = LocalQueryRunner.tpch(scale=SCALE, device=dev)
    rows, launches = {}, {}
    tap = LaunchTap(HK)
    for q, sql in queries.items():
        HK.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if q == "q01":
            with tap:
                res = runner.execute(sql)
        else:
            res = runner.execute(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[q] = dict(HK.LAUNCHES)
        rows[q] = res.rows
        print(f"  {q} SF{SCALE} default session: {wall:.3f} s wall, "
              f"{len(res.rows)} rows, launches {launches[q]}", flush=True)
    if launches["q01"]["grouped_sum_i64"] == 0 or launches["q01"]["grouped_sum_i32"] == 0:
        fail(f"Q1 did not go through the grouped-sum kernels: {launches['q01']}")
    check_q1_page(HK, tap, kernels)
    del tap
    torch.cuda.empty_cache()

    off = LocalQueryRunner.tpch(scale=SCALE, device=dev)
    off.session.set("pallas_aggregation", "off")
    for q, sql in queries.items():
        HK.reset_launch_counts()
        t0 = time.perf_counter()
        res = off.execute(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(HK.LAUNCHES.values()):
            fail(f"{q} with pallas_aggregation=off launched {HK.LAUNCHES}")
        if res.rows != rows[q]:
            fail(f"{q}: default rows {rows[q]} != pallas_aggregation=off rows {res.rows}")
        print(f"  {q} SF{SCALE} pallas_aggregation=off: {wall:.3f} s wall, "
              "rows identical", flush=True)

    t0 = time.perf_counter()
    want_q1, want_q6 = numpy_oracle(g, runner.catalogs.get("tpch"))
    print(f"  numpy oracle: {time.perf_counter() - t0:.3f} s", flush=True)
    if rows["q01"] != want_q1:
        fail(f"q01 rows {rows['q01']} != numpy oracle {want_q1}")
    if rows["q06"] != want_q6:
        fail(f"q06 rows {rows['q06']} != numpy oracle {want_q6}")
    print(f"  q01 and q06 rows equal the numpy oracle: {rows['q06']}", flush=True)
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
    t0 = time.perf_counter()
    lib = HK.build()
    print(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    print((lib.parent / "build.log").read_text(), flush=True)

    print("phase 2: kernels against their plain versions", flush=True)
    conn = TpchConnector(scale=SCALE, device="cpu")
    splits = conn.split_count("lineitem", SCALE)
    n_main = splits * conn.split_capacity("lineitem", SCALE, splits)
    kernels = check_kernels(HK, n_main, dev)
    torch.cuda.empty_cache()

    print(f"phase 3: TPC-H Q6 and Q1 at SF{SCALE}", flush=True)
    launches = run_queries(HK, dev, kernels)
    for name, k in kernels.items():
        k["launches"] = launches["q01"][name] + launches["q06"][name]

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
