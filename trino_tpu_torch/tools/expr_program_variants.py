"""``expr_program``'s kernel beside the one-row interpreter it replaced,
timed on one card.

    python3 trino_tpu_torch/tools/expr_program_variants.py --baseline DIR

``DIR`` is a checkout (an unpacked ``git archive``) of a commit whose
``trino_tpu_torch/csrc/expr_program.cu`` is the one-row-a-thread
interpreter with its register file, 32 values and 32 validity flags, in a
per-thread array (local memory). The variants:

- ``one row, local file``: ``DIR``'s kernel as it stands;
- ``one row, mask``: the same with the validity flags as one 32-bit mask a
  row in a register (four text substitutions), the values still local;
- ``shared file, k=1``, ``k=2``, ``k=4``: this checkout's kernel (values in
  shared memory, validity in the mask, k rows a thread) at each k, over
  the grid ``hopper_kernels.expr_program_plan`` gives that k; ``plan``
  marks the k the plan takes.

``DIR``'s ``expr_program.cu`` and its variant are built alone (with the
headers beside them) into ``trino_tpu_torch/_build/variants/``; this
checkout's library is ``hopper_kernels.build``'s. The programs are every
``expr_program`` call of TPC-H Q3, Q5, Q10 and Q12 over the SF10 memory
tables (loaded and tapped as ``kernel_device_times.py --aggregates`` does)
and ``chip_smoke.py`` phase 2's main projection and its program at the
limits (128 instructions, 32 registers) at 4,194,304 rows. Each
variant's outputs must equal the plain version bit for bit; each is timed
by ``torch.profiler`` (device microseconds a call, over 10 calls after
one). Prints the card line, each variant's ptxas report for its kernels,
then one line a program and variant. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from trino_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from trino_tpu_torch.tools import kernel_device_times as KD  # noqa: E402

OUT = ROOT / "trino_tpu_torch" / "_build" / "variants"
QUERIES = ("q03", "q05", "q10", "q12")

# the mask in place of the one-row kernel's flags
MASK = (
    ("  bool v[hopper::kMaxExprRegs];", "  uint32_t vm = 0;"),
    ("    v[k] = false;\n", ""),
    ("const bool va = v[ins.a], vb = v[ins.b], vc = v[ins.c];",
     "const bool va = (vm >> ins.a) & 1u, vb = (vm >> ins.b) & 1u, vc = (vm >> ins.c) & 1u;"),
    ("      v[ins.dst] = ov;",
     "      vm = (vm & ~(1u << ins.dst)) | (static_cast<uint32_t>(ov) << ins.dst);"),
)


def one_row_sources(baseline: Path) -> dict:
    src = (baseline / "trino_tpu_torch" / "csrc" / "expr_program.cu").read_text()
    masked = src
    for old, new in MASK:
        if old not in masked:
            raise RuntimeError(f"{baseline}'s expr_program.cu is not the one-row interpreter: "
                               f"no {old.strip()!r}")
        masked = masked.replace(old, new)
    return {"one row, local file": src, "one row, mask": masked}


def build_one_row(baseline: Path, texts: dict) -> dict:
    """Each one-row source built alone with its headers, all at once;
    returns name -> (CDLL, build.log)."""
    libs, errors = {}, []

    def build(name, text):
        try:
            d = OUT / name.replace(", ", "_").replace(" ", "_")
            csrc = d / "csrc"
            if csrc.exists():
                shutil.rmtree(csrc)
            csrc.mkdir(parents=True)
            for h in (baseline / "trino_tpu_torch" / "csrc").glob("*.cuh"):
                shutil.copy(h, csrc / h.name)
            (csrc / "expr_program.cu").write_text(text)
            path = HK.build(csrc, d / "build")
            lib = ctypes.CDLL(str(path))
            lib.expr_program.argtypes = [ctypes.POINTER(HK._ExprProgram), ctypes.c_int64,
                                         ctypes.c_void_p]
            lib.expr_program.restype = ctypes.c_int
            libs[name] = (lib, (path.parent / "build.log").read_text())
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


def kernel_param(program, inputs, outs):
    """The kernel parameter of one call (as the wrapper fills it)."""
    p = HK._ExprProgram()
    ctypes.memmove(ctypes.addressof(p), ctypes.addressof(HK._program_struct(program)),
                   ctypes.sizeof(HK._ExprProgram))
    for c, (d, v) in zip(p.inp, inputs):
        c.data, c.valid, c.type = d.data_ptr(), v.data_ptr(), HK._KEY_TYPES[d.dtype]
    for c, (d, v) in zip(p.out, outs):
        c.data, c.valid, c.type = d.data_ptr(), v.data_ptr(), HK._KEY_TYPES[d.dtype]
    return p


def launches(program, inputs, active, one_row: dict, dev) -> dict:
    """name -> a function launching that variant into its own outputs,
    which it returns."""
    n = (inputs[0][1] if inputs else active).shape[0]
    lib = HK._library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occupancy = {k: lib.expr_program_blocks_per_sm(k, program.n_regs)
                 for k in HK.EXPR_ROWS_PER_THREAD}
    plan_k = HK.expr_program_plan(n, program.n_regs, sms, occupancy)[0]
    out = {}

    def outputs():
        return [(torch.empty(n, dtype=dt, device=dev), torch.empty(n, dtype=torch.bool,
                                                                  device=dev))
                for dt in program.output_dtypes]

    for name, (vlib, _) in one_row.items():
        outs = outputs()
        p = kernel_param(program, inputs, outs)

        def run(vlib=vlib, p=p, outs=outs, name=name):
            HK._check_launch(name, vlib.expr_program(ctypes.byref(p), n,
                                                     torch.cuda.current_stream().cuda_stream))
            return outs

        out[name] = run
    for k in sorted(HK.EXPR_ROWS_PER_THREAD):
        if occupancy[k] < 1:
            continue
        outs = outputs()
        p = kernel_param(program, inputs, outs)
        grid = min(-(-n // (k * HK.EXPR_BLOCK_THREADS)), sms * occupancy[k])

        def run(k=k, p=p, outs=outs, grid=grid):
            HK._check_launch("expr_program", lib.expr_program(
                ctypes.byref(p), n, k, grid, torch.cuda.current_stream().cuda_stream))
            return outs

        out[f"shared file, k={k}{' (plan)' if k == plan_k else ''}"] = run
    return out


def programs(dev) -> list:
    """(label, (program, inputs, active)) of every expr_program call of
    QUERIES over the SF10 memory tables, then the main projection."""
    from chip_smoke import FUSED_SLOTS, expr_cases, limit_inputs, limit_program
    from tests.tpch_corpus import TPCH_QUERIES

    texts = {"q03": KD.QUERIES["q03"], "q05": TPCH_QUERIES["q05"], "q10": KD.QUERIES["q10"],
             "q12": KD.EXPAND_QUERIES["q12"]}
    runner = KD.memory_runner("tree", dev)
    out = []
    for q in QUERIES:
        _, calls = KD.query_calls(HK, runner, texts[q], ("expr_program",), dev)
        for k, (_, args) in enumerate(calls):
            program, inputs = args[0], args[1]
            active = args[2] if len(args) > 2 else None
            out.append((f"{q} call {k + 1}", (program, inputs, active)))
    del runner
    label, args = next(iter(expr_cases(HK, dev)))
    out.append((f"phase 2's {label}", (*args, None)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    limit = limit_program(dev)
    out.append((f"phase 2's program at the limits n={FUSED_SLOTS}",
                (limit, limit_inputs(limit, FUSED_SLOTS, dev, gen), None)))
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def ptxas_lines(log: str) -> str:
    """The registers, stack and shared memory lines of expr_program's
    kernels in a build.log."""
    lines = log.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "Function properties for" in line and "expr_program_kernel" in line:
            keep += [line.split("for ")[-1]] + lines[i + 1:i + 3]
    return "\n".join("    " + x.strip() for x in keep)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True,
                    help="a checkout whose expr_program.cu is the one-row interpreter")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    tree = HK.build()
    one_row = build_one_row(Path(opts.baseline).resolve(), one_row_sources(
        Path(opts.baseline).resolve()))
    for name, (_, log) in one_row.items():
        print(f"{name}:\n{ptxas_lines(log)}", flush=True)
    print(f"shared file (this checkout):\n{ptxas_lines((tree.parent / 'build.log').read_text())}",
          flush=True)
    for label, (program, inputs, active) in programs(dev):
        want = HK.expr_program_plain(program, inputs, active)
        n = (inputs[0][1] if inputs else active).shape[0]
        for name, run in launches(program, inputs, active, one_row, dev).items():
            got = run()
            torch.cuda.synchronize()
            same = all(torch.equal(_bits(a), _bits(b)) and torch.equal(av, bv)
                       for (a, av), (b, bv) in zip(got, want))
            if not same:
                sys.exit(f"{name} [{label}] differs from the plain version")
            us, _ = KD.device_us(run)
            print(f"{label} (n={n}, {len(program.code)} instructions, {program.n_regs} "
                  f"registers, {len(program.output_dtypes)} outputs) {name}: device "
                  f"{sum(us.values()):.1f} us a call", flush=True)


if __name__ == "__main__":
    main()
