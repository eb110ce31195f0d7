"""Hand-written Hopper kernels and their plain torch versions.

The port's counterpart of ``trino_tpu.ops.pallas_kernels``. The kernels are
CUDA C++ for ``sm_90a`` in ``trino_tpu_torch/csrc/``; :func:`build` compiles
them with ``nvcc`` into one shared library with a plain C interface (keyed on
a hash of the sources, under ``trino_tpu_torch/_build/``), loaded with
ctypes at first use.

Each wrapper checks its inputs and raises on anything the kernel does not
take. Given CPU tensors it computes its plain version, the function the CPU
tests hold against the reference; given CUDA tensors it launches its kernel
on the current stream or raises. Nothing falls back. A wrapper adds one to
``LAUNCHES[name]`` each time it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import kernels as K

# G limit of the grouped sums: the kernel's shared accumulators hold 64
# groups (the reference's PALLAS_GROUP_LIMIT, kept so the gates agree)
GROUP_LIMIT = 64

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"grouped_sum_i64": 0, "grouped_sum_i32": 0, "q6_fused": 0}

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# build and load
# --------------------------------------------------------------------------- #


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path("/usr/local/cuda/bin/nvcc")
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the Hopper kernels cannot be built")


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library and return its
    path; a library built from the same sources, headers (``csrc/*.cuh``)
    and flags is reused. Each source compiles in its own ``nvcc`` process,
    all started together; the compiler's output (registers, shared memory,
    spills) is kept in ``build.log`` beside the library."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(CSRC.glob("*.cuh")) + sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    digest = h.hexdigest()[:16]
    out_dir = BUILD_DIR / digest
    lib = out_dir / "libhopper_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for s in sources:
        obj = out_dir / (s.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log = []
    failed = []
    for s, _, p in procs:
        text, _ = p.communicate()
        log.append(f"== {s.name} (rc={p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(s.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"libhopper_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the Hopper kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for name in ("grouped_sum_i64", "grouped_sum_i32"):
                fn = getattr(lib, name)
                fn.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr]
                fn.restype = i32
            lib.q6_fused.argtypes = [ptr] * 5 + [i64] + [i32] * 5 + [ptr, ptr]
            lib.q6_fused.restype = i32
            _LIB = lib
        return _LIB


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_vectors(name: str, tensors, dtypes) -> None:
    dev = tensors[0].device
    n = tensors[0].shape[0] if tensors[0].ndim == 1 else None
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.ndim != 1 or t.shape[0] != n:
            raise ValueError(f"{name}: expected 1-D tensors of one length")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


# --------------------------------------------------------------------------- #
# grouped sums (replace pallas_kernels.grouped_sum_i64 / grouped_sum_i32)
# --------------------------------------------------------------------------- #


def grouped_sum_plain(
    values: torch.Tensor, weight: torch.Tensor, gid: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """out[g] = sum(values[i] for gid[i]==g and weight[i]) as int64 (mod 2^64):
    the engine's plain ``direct_group_reduce``. A row whose gid lies outside
    [0, num_groups) is skipped, as the kernel skips it."""
    inside = (gid >= 0) & (gid < num_groups)
    return K.direct_group_reduce(
        values.to(torch.int64), weight & inside, gid.clamp(0, num_groups - 1),
        num_groups, "sum",
    )


def _grouped_sum(name: str, vdtype, values, weight, gid, num_groups: int):
    _check_vectors(name, (values, weight, gid), (vdtype, torch.bool, torch.int32))
    if not 1 <= num_groups <= GROUP_LIMIT:
        raise ValueError(f"{name}: num_groups {num_groups} outside [1, {GROUP_LIMIT}]")
    if values.device.type == "cpu":
        return grouped_sum_plain(values, weight, gid, num_groups)
    out = torch.empty(num_groups, dtype=torch.int64, device=values.device)
    rc = getattr(_library(), name)(
        values.data_ptr(), weight.data_ptr(), gid.data_ptr(), values.shape[0],
        num_groups, out.data_ptr(), _stream(values),
    )
    _check_launch(name, rc)
    LAUNCHES[name] += 1
    return out


def grouped_sum_i64(
    values: torch.Tensor, weight: torch.Tensor, gid: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """out[g] = sum(values[i] for gid[i]==g and weight[i]), exact int64.

    values int64, weight bool, gid int32, num_groups <= 64 (the reference's
    signature, without its ``interpret`` flag: a CPU tensor selects the plain
    version). Rows whose gid lies outside [0, num_groups) are skipped on
    either device."""
    return _grouped_sum("grouped_sum_i64", torch.int64, values, weight, gid, num_groups)


def grouped_sum_i32(
    values: torch.Tensor, weight: torch.Tensor, gid: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """out[g] = sum of int32 values per group, as int64. Covers counts
    (values = weight as int32) and narrow integer sums."""
    return _grouped_sum("grouped_sum_i32", torch.int32, values, weight, gid, num_groups)


# --------------------------------------------------------------------------- #
# Q6 (replaces pallas_kernels.q6_fused)
# --------------------------------------------------------------------------- #


def q6_plain(shipdate, discount, quantity, extendedprice, mask,
             lo_date, hi_date, lo_disc, hi_disc, hi_qty) -> torch.Tensor:
    """The reference's ``q6_reference`` formula: int64 products, int64 sum."""
    keep = (
        (shipdate >= lo_date)
        & (shipdate < hi_date)
        & (discount >= lo_disc)
        & (discount <= hi_disc)
        & (quantity < hi_qty)
        & (mask != 0)
    )
    prod = extendedprice.to(torch.int64) * discount.to(torch.int64)
    return torch.where(keep, prod, 0).sum(dtype=torch.int64)


def q6_fused(
    shipdate: torch.Tensor,
    discount: torch.Tensor,
    quantity: torch.Tensor,
    extendedprice: torch.Tensor,
    mask: torch.Tensor,
    lo_date: int,
    hi_date: int,
    lo_disc: int,
    hi_disc: int,
    hi_qty: int,
) -> torch.Tensor:
    """Fused Q6: sum(price * discount) over the predicate; a 0-d int64 tensor.

    Inputs are int32 1-D tensors (dates as days, decimals as cents) plus an
    int32 0/1 mask (active & validity), as in the reference. Unlike the
    Pallas kernel, which multiplies in int32, every product is int64, so the
    sum is exact for any int32 inputs (mod 2^64)."""
    cols = (shipdate, discount, quantity, extendedprice, mask)
    _check_vectors("q6_fused", cols, (torch.int32,) * 5)
    bounds = (lo_date, hi_date, lo_disc, hi_disc, hi_qty)
    if any(not -(2**31) <= int(b) < 2**31 for b in bounds):
        raise ValueError("q6_fused: predicate bounds must fit int32")
    if shipdate.device.type == "cpu":
        return q6_plain(*cols, *bounds)
    out = torch.empty((), dtype=torch.int64, device=shipdate.device)
    rc = _library().q6_fused(
        *(c.data_ptr() for c in cols), shipdate.shape[0], *(int(b) for b in bounds),
        out.data_ptr(), _stream(shipdate),
    )
    _check_launch("q6_fused", rc)
    LAUNCHES["q6_fused"] += 1
    return out
