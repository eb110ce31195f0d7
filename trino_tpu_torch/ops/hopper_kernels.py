"""Hand-written Hopper kernels and their plain torch versions.

The port's counterpart of ``trino_tpu.ops.pallas_kernels`` and of the
Pallas bodies of ``trino_tpu.ops.megakernels`` (the hash-join probe and
expansion and the stages after it: the fused projection's expression
program, the presorted grouping and the direct aggregation; the group sort,
the sort-path aggregation with its re-sort of each group's rows and its
HyperLogLog registers, the repartition epilogue and the exchange
destination stage). The kernels are
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
import math
import os
import shutil
import subprocess
import struct
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

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

LAUNCHES = {
    "grouped_sum_i64": 0, "grouped_sum_i32": 0, "q6_fused": 0,
    "hash_probe": 0, "hash_expand": 0, "segment_agg": 0, "group_sort": 0,
    "partition_epilogue": 0, "partition_dest": 0,
    "expr_program": 0, "presorted_group": 0, "segment_agg_direct": 0,
    "segment_sort": 0, "hll": 0,
}

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


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile every ``*.cu`` of ``csrc`` into one shared library and return
    its path; a library built from the same sources, headers (``*.cuh``)
    and flags is reused. Each source compiles in its own ``nvcc`` process,
    all started together; the compiler's output (registers, shared memory,
    spills) is kept in ``build.log`` beside the library."""
    sources = sorted(csrc.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(csrc.glob("*.cuh")) + sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    digest = h.hexdigest()[:16]
    out_dir = build_dir / digest
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


def bind(path: Path):
    """Load a library :func:`build` made and declare its C interface;
    raises where its constants disagree with the wrappers'."""
    lib = ctypes.CDLL(str(path))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("grouped_sum_i64", "grouped_sum_i32"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr]
        fn.restype = i32
    lib.q6_fused.argtypes = [ptr] * 5 + [i64] + [i32] * 5 + [ptr, ptr]
    lib.q6_fused.restype = i32
    keyset, events = ctypes.POINTER(_KeySet), ctypes.POINTER(ctypes.c_void_p)
    lib.hash_probe.argtypes = (
        [keyset, keyset, ptr, ptr, i64, i64, i32, i32, i32] + [ptr] * 6 + [events, ptr]
    )
    lib.hash_probe.restype = i32
    lib.hash_expand_scan.argtypes = [ptr, i64, i64, ptr, ptr, ptr, ptr]
    lib.hash_expand_scan.restype = i32
    lib.hash_expand_slots.argtypes = (
        [keyset, keyset] + [ptr] * 4 + [i64, i64, i32, i64] + [ptr] * 7
        + [ctypes.POINTER(_GatherSet), i32, ctypes.POINTER(_DestKeys), ptr, ptr]
    )
    lib.hash_expand_slots.restype = i32
    lib.segment_agg.argtypes = (
        [ctypes.POINTER(_AggRequestSet), ctypes.POINTER(_AggOutputSet),
         ctypes.POINTER(_GroupKeySet)] + [ptr] * 3 + [i64, i64] + [ptr] * 5 + [events, ptr])
    lib.segment_agg.restype = i32
    lib.segment_agg_partial_words.argtypes = [i32, i64, i64, i32]
    lib.segment_agg_partial_words.restype = i64
    for name, want in (("hash_expand_gather_cols", _MAX_GATHER_COLS),
                       ("hash_expand_tile_rows", EXPAND_TILE_ROWS),
                       ("hash_expand_state_head", _EXPAND_STATE_HEAD),
                       ("hash_expand_look_back", EXPAND_LOOK_BACK),
                       ("wide_key_limit", _MAX_WIDE_KEYS),
                       ("radix_tile_rows", _TILE_ROWS),
                       ("group_sort_tile_rows", SORT_TILE_ROWS),
                       ("segment_agg_tile_rows", SEGMENT_TILE_ROWS),
                       # the NaN rule reads the plain cumsum's blocks as tiles
                       ("segment_agg_tile_rows", K.CUMSUM_BLOCK),
                       ("segment_agg_max_masks", SEGMENT_AGG_MAX_MASKS),
                       ("segment_agg_max_requests", SEGMENT_AGG_MAX_REQUESTS),
                       ("segment_agg_max_outputs", SEGMENT_AGG_MAX_OUTPUTS),
                       ("segment_agg_max_reads", AGG_MAX_READS),
                       ("segment_agg_request_bytes", ctypes.sizeof(_AggRequest)),
                       ("segment_agg_output_bytes", ctypes.sizeof(_AggOutput)),
                       ("radix_perm_cols", _MAX_PERM_COLS),
                       ("partition_epilogue_max_parts", EPILOGUE_MAX_PARTS),
                       ("partition_epilogue_sweep_bins", EPILOGUE_SWEEP_BINS)):
        fn = getattr(lib, name)
        fn.restype = i32
        if fn() != want:
            raise RuntimeError(f"csrc and its wrapper disagree on {name}")
    gather = ctypes.POINTER(_PermGatherSet)
    wide, comp = ctypes.POINTER(_WideKeySet), ctypes.POINTER(_Composite)
    lib.group_sort_stats.argtypes = [wide, ptr, i64, ptr, ptr, ptr]
    lib.group_sort_compose.argtypes = [wide, ptr, i64, comp, i32, ptr, ptr, i64, ptr]
    lib.group_sort_passes.argtypes = (
        [comp, i32, i64] + [ptr] * 5 + [ctypes.POINTER(ctypes.c_void_p), ptr])
    lib.group_sort_finish.argtypes = (
        [wide, ptr, i64, i32, ptr, ptr, i32, i32, ctypes.POINTER(_DecodeSet), gather,
         i32] + [ptr] * 4)
    for name in ("group_sort_stats", "group_sort_compose", "group_sort_passes",
                 "group_sort_finish"):
        getattr(lib, name).restype = i32
    lib.group_sort_scratch_words.argtypes = [i64, i32]
    for name in ("group_sort_scratch_words", *(f"{k}_stream_ops" for k in _STREAM_OPS)):
        getattr(lib, name).restype = i64
    weights = ctypes.POINTER(_WeightSet)
    lib.segment_sort_stats.argtypes = [ptr, ptr, i32, weights, i64] + [ptr] * 5
    lib.segment_sort_small.argtypes = (
        [ptr, ptr, i32, i32, weights, i64] + [ptr] * 3 + [i32, i32] + [ptr] * 4)
    lib.segment_sort_large.argtypes = (
        [ptr, i32, i32, weights, i64, i32, i32] + [ptr] * 3 + [i64, i64] + [ptr] * 12)
    lib.hll.argtypes = [ptr, ptr, i32, weights, i64, i64, ctypes.c_float, i64] + [ptr] * 6
    lib.hll_blocks_per_sm.argtypes = []
    lib.tile_scratch_words.argtypes = [i64]
    lib.tile_scratch_words.restype = i64
    for name in ("segment_sort_stats", "segment_sort_small", "segment_sort_large", "hll",
                 "hll_blocks_per_sm"):
        getattr(lib, name).restype = i32
    lib.partition_epilogue.argtypes = (
        [ctypes.POINTER(_WideKeySet), ptr, ptr, i64, i32] + [ptr] * 6
        + [gather, i32, events, ptr]
    )
    lib.partition_epilogue.restype = i32
    lib.partition_dest.argtypes = [ctypes.POINTER(_WideKeySet), ptr, i64, i32, ptr, ptr]
    lib.partition_dest.restype = i32
    lib.expr_program.argtypes = [ctypes.POINTER(_ExprProgram), i64, i32, i32, ptr]
    lib.expr_program_blocks_per_sm.argtypes = [i32, i32]
    for name in ("expr_program", "expr_program_blocks_per_sm"):
        getattr(lib, name).restype = i32
    lib.presorted_group.argtypes = (
        [ctypes.POINTER(_PresortKey), i32, ptr, i64, ptr, i64] + [ptr] * 4)
    lib.presorted_group.restype = i32
    for name, want in (("presorted_group_max_epoch", _PRESORTED_MAX_EPOCH),
                       ("presorted_group_max_rows", _PRESORTED_MAX_ROWS)):
        fn = getattr(lib, name)
        fn.restype = i64
        if fn() != want:
            raise RuntimeError(f"csrc and its wrapper disagree on {name}")
    lib.segment_agg_direct.argtypes = (
        [ctypes.POINTER(_AggRequestSet), ctypes.POINTER(_AggOutputSet),
         ctypes.POINTER(_DirectKeySet), ptr, i64, i32] + [ptr] * 3 + [events, ptr])
    lib.segment_agg_direct.restype = i32
    lib.segment_agg_direct_blocks.argtypes = [i64]
    lib.segment_agg_direct_blocks.restype = i64
    for name, want in (("expr_program_max_instrs", EXPR_MAX_INSTRS),
                       ("expr_program_max_regs", EXPR_MAX_REGS),
                       ("expr_program_max_consts", EXPR_MAX_CONSTS),
                       ("expr_program_max_inputs", EXPR_MAX_INPUTS),
                       ("expr_program_max_outputs", EXPR_MAX_OUTPUTS),
                       ("expr_program_max_luts", EXPR_MAX_LUTS),
                       ("presorted_group_tile_rows", PRESORTED_TILE_ROWS),
                       ("presorted_group_state_head", _PRESORTED_STATE_HEAD),
                       ("presorted_group_max_keys", PRESORTED_MAX_KEYS),
                       ("segment_agg_direct_max_groups", DIRECT_MAX_GROUPS),
                       ("segment_agg_direct_max_keys", DIRECT_MAX_KEYS),
                       ("segment_sort_max_weights", SEGMENT_SORT_MAX_WEIGHTS),
                       ("segment_sort_tile_rows", SEGMENT_TILE_ROWS),
                       ("segment_sort_batch_rows", SEGMENT_SORT_BATCH_ROWS),
                       ("segment_sort_chunk_rows", SEGMENT_SORT_CHUNK_ROWS),
                       ("segment_sort_stat_words", _SORT_STAT_WORDS),
                       ("segment_sort_item_bytes", 8 * _SORT_ITEM_WORDS),
                       ("segment_sort_entry_bytes", 8 * _SORT_ENTRY_WORDS),
                       ("hll_bits", K.HLL_BITS),
                       ("hll_max_weights", SEGMENT_SORT_MAX_WEIGHTS)):
        fn = getattr(lib, name)
        fn.restype = i32
        if fn() != want:
            raise RuntimeError(f"csrc and its wrapper disagree on {name}")
    return lib


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = bind(build())
        return _LIB


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _phase_marks(phase_events, phases):
    """The CUDA events a kernel's C entry point records at the bounds of its
    ``phases`` (a ctypes array of their handles), each phase appended to the
    list ``phase_events`` as ``(phase, start, end)``; None where
    ``phase_events`` is None."""
    if phase_events is None:
        return None
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(phases) + 1)]
    for m in marks:
        m.record()  # creates the event, which the entry point records again
    phase_events.extend((p, marks[k], marks[k + 1]) for k, p in enumerate(phases))
    return (ctypes.c_void_p * len(marks))(*(m.cuda_event for m in marks))


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


# --------------------------------------------------------------------------- #
# hash join (replaces megakernels.probe_phase / expand_phase's join stage)
# --------------------------------------------------------------------------- #

# key columns one join carries, and columns per gather set: the sizes of
# KeySet and GatherSet in csrc/join_keys.cuh and csrc/hash_expand.cu
_MAX_KEYS = 4
_MAX_GATHER_COLS = 16
# hash_expand's scan tile (probe rows a block scans, kTileRows), its
# look-back window (tiles, one a thread) and the int64 words of its scan
# state ahead of the tile status words (kStateHead)
EXPAND_TILE_ROWS = 24576
EXPAND_LOOK_BACK = 256
_EXPAND_STATE_HEAD = 3
# probe rows per chunk of the plain versions' [rows, C] match block
_PLAIN_CHUNK = 1 << 20

_KEY_TYPES = {
    torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3,
    torch.bool: 4, torch.float64: 5, torch.float32: 6,
}


class _KeyCol(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("lut", ctypes.c_void_p), ("lut_len", ctypes.c_int64), ("type", ctypes.c_int),
    ]


class _KeySet(ctypes.Structure):
    _fields_ = [("col", _KeyCol * _MAX_KEYS), ("n", ctypes.c_int)]


class _GatherCol(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p), ("src_valid", ctypes.c_void_p),
        ("dst", ctypes.c_void_p), ("dst_valid", ctypes.c_void_p),
        ("elem_bytes", ctypes.c_int), ("build_side", ctypes.c_int),
    ]


class _GatherSet(ctypes.Structure):
    _fields_ = [("col", _GatherCol * _MAX_GATHER_COLS), ("n", ctypes.c_int)]


def normalized_keys(key_cols, luts):
    """(data, valid) key columns -> (normalized int64 keys, all-keys-valid):
    dictionary-coded probe keys translate through the build dictionary's
    LUT (an absent value becomes invalid), and every key compares on
    ``kernels.order_key`` bits (the reference's ``_normalized_keys``)."""
    keys: List[torch.Tensor] = []
    ok = None
    for (d, v), lut in zip(key_cols, luts):
        if lut is not None:
            d = lut[d.to(torch.int64).clamp(0, lut.shape[0] - 1)]
            v = v & (d >= 0)
        keys.append(K.order_key(d))
        ok = v if ok is None else ok & v
    return keys, ok


def bucket_of(keys: Sequence[torch.Tensor], n_buckets: int) -> torch.Tensor:
    """Chained SplitMix64 over the normalized key tuple, masked to
    ``n_buckets - 1`` (a power of two), as int32."""
    h = None
    for k in keys:
        h = K.splitmix64(k if h is None else h + k)
    return (h & (n_buckets - 1)).to(torch.int32)


def _bucket_eq(table, counts, bucket, pk, pk_ok, bk, C: int):
    """``eq[i, c]``: slot c of row i's bucket holds a build row whose keys
    equal row i's; ``rows[i, c]``: that slot's build row, clipped to
    [0, m-1] (the reference's ``_bucket_match``)."""
    m = bk[0].shape[0]
    rows = table[bucket.to(torch.int64)].to(torch.int64).clamp(0, m - 1)
    occ = torch.arange(C, device=rows.device) < counts[bucket.to(torch.int64)][:, None]
    eq = occ & pk_ok[:, None]
    for p, b in zip(pk, bk):
        eq = eq & (b[rows] == p[:, None])
    return eq, rows


def hash_probe_plain(pkeys, bkeys, luts, probe_active, build_active,
                     n_buckets: int, C: int, left_outer: bool) -> Dict[str, torch.Tensor]:
    """The reference's ``_probe_phase_body``: build rows enter their
    bucket's slots in ascending row order (a stable sort by bucket; where a
    bucket overflows, slot C-1 keeps its last row, as the sequential
    insertion leaves it), inactive and NULL-key rows enter trash bucket B;
    each probe row counts its bucket's equal-key slots in chunks of rows."""
    pk, pv = normalized_keys(pkeys, luts)
    bk, bv = normalized_keys(bkeys, (None,) * len(bkeys))
    pa = probe_active & pv
    ba = build_active & bv
    dev = ba.device
    m = ba.shape[0]
    bb = torch.where(ba, bucket_of(bk, n_buckets).to(torch.int64), n_buckets)
    counts64 = torch.bincount(bb, minlength=n_buckets + 1)
    order = torch.sort(bb, stable=True).indices
    bsorted = bb[order]
    rank = torch.arange(m, device=dev) - (torch.cumsum(counts64, 0) - counts64)[bsorted]
    keep = (rank < C - 1) | (rank == counts64[bsorted] - 1)
    flat = bsorted * C + rank.clamp(max=C - 1)
    table = torch.zeros((n_buckets + 1) * C, dtype=torch.int32, device=dev)
    table[flat[keep]] = order[keep].to(torch.int32)
    table = table.view(n_buckets + 1, C)
    counts = counts64.to(torch.int32)
    bucket_p = bucket_of(pk, n_buckets)
    n = pa.shape[0]
    count = torch.empty(n, dtype=torch.int32, device=dev)
    for lo in range(0, n, _PLAIN_CHUNK):
        sl = slice(lo, lo + _PLAIN_CHUNK)
        eq, _ = _bucket_eq(table, counts, bucket_p[sl], [k[sl] for k in pk], pa[sl], bk, C)
        count[sl] = eq.sum(1, dtype=torch.int32)
    if left_outer:
        emit = torch.where(probe_active, count.clamp(min=1), 0).to(torch.int32)
    else:
        emit = count
    return {
        "table": table, "counts": counts, "bucket_p": bucket_p, "count": count,
        "emit": emit, "max_count": counts[:n_buckets].max(),
    }


def _key_set(name: str, key_cols, luts, n: int, cls=None):
    ks = (cls or _KeySet)()
    ks.n = len(key_cols)
    for k, ((d, v), lut) in enumerate(zip(key_cols, luts)):
        if d.dtype not in _KEY_TYPES or d.ndim != 1 or d.shape[0] != n:
            raise TypeError(f"{name}: unsupported key column {d.dtype} {tuple(d.shape)}")
        _check_vectors(name, (d, v), (d.dtype, torch.bool))
        col = ks.col[k]
        col.data, col.valid, col.type = d.data_ptr(), v.data_ptr(), _KEY_TYPES[d.dtype]
        if lut is not None:
            _check_vectors(name, (lut,), (torch.int64,))
            if lut.device != d.device or lut.shape[0] < 1:
                raise ValueError(f"{name}: LUT must be a non-empty tensor on {d.device}")
            col.lut, col.lut_len = lut.data_ptr(), lut.shape[0]
    return ks


def _check_keys(name: str, pkeys, bkeys, luts) -> None:
    if not 1 <= len(pkeys) <= _MAX_KEYS or len(bkeys) != len(pkeys) or len(luts) != len(pkeys):
        raise ValueError(f"{name}: 1 to {_MAX_KEYS} key columns per side, one LUT slot each")


def hash_probe(pkeys, bkeys, luts, probe_active: torch.Tensor, build_active: torch.Tensor,
               n_buckets: int, C: int, left_outer: bool, *,
               phase_events=None) -> Dict[str, torch.Tensor]:
    """One build+probe attempt at ``n_buckets`` buckets of ``C`` slots.

    ``pkeys``/``bkeys``: (data, valid) key columns (1 to 4 per side, any
    integer, bool or float storage); ``luts``: per key, None or an int64
    dictionary translation of probe codes into build codes. Returns
    ``table`` int32 [B+1, C], ``counts`` int32 [B+1], ``bucket_p``,
    ``count`` and ``emit`` int32 [N] (on inner joins ``count`` is
    ``emit``, as in :func:`hash_probe_plain`), and ``max_count`` (0-d
    int32; above C a bucket overflowed and the table is not usable).

    On CUDA tensors the kernel is one memset (counts and max_count, one
    buffer) and three launches (claim, buckets, probe), and leaves
    unspecified what no later phase reads: the table's slots at or past
    ``min(counts[b], C)`` (the memset of the whole table is gone), except
    slot 0 of an empty bucket below B that :func:`hash_expand` reads for an
    unmatched output slot (the bucket of a LEFT join's active probe row or
    of the last probe row), which is 0; ``bucket_p`` and ``count`` on
    inactive probe rows other than the last (their keys are not read); and
    where ``max_count`` > C, ``count`` and ``emit``. Everything else equals
    :func:`hash_probe_plain`. ``phase_events``, None or a list, gets one
    ``(phase, start, end)`` pair of recorded CUDA events for each of
    ``"memset"``, ``"claim"``, ``"buckets"`` and ``"probe"``."""
    _check_keys("hash_probe", pkeys, bkeys, luts)
    _check_vectors("hash_probe", (probe_active,), (torch.bool,))
    _check_vectors("hash_probe", (build_active,), (torch.bool,))
    if probe_active.device != build_active.device:
        raise ValueError(f"hash_probe: sides on {probe_active.device} and {build_active.device}")
    n, m = probe_active.shape[0], build_active.shape[0]
    if not 1 <= m < 2**31 or n < 1:
        raise ValueError("hash_probe: both sides non-empty, build rows within int32")
    if not 1 <= n_buckets < 2**30 or n_buckets & (n_buckets - 1) or not 1 <= C < 2**30:
        raise ValueError(f"hash_probe: B={n_buckets} must be a power of two and C={C} "
                         "positive")
    if probe_active.device.type == "cpu":
        return hash_probe_plain(pkeys, bkeys, luts, probe_active, build_active,
                                n_buckets, C, left_outer)
    dev = probe_active.device
    pks = _key_set("hash_probe", pkeys, luts, n)
    bks = _key_set("hash_probe", bkeys, (None,) * len(bkeys), m)
    meta = torch.empty(n_buckets + 2, dtype=torch.int32, device=dev)
    heads = torch.empty(n_buckets, dtype=torch.int32, device=dev)
    emit = torch.empty(n, dtype=torch.int32, device=dev)
    out = {
        "table": torch.empty((n_buckets + 1, C), dtype=torch.int32, device=dev),
        "counts": meta[:n_buckets + 1],
        "bucket_p": torch.empty(n, dtype=torch.int32, device=dev),
        "count": torch.empty(n, dtype=torch.int32, device=dev) if left_outer else emit,
        "emit": emit,
        "max_count": meta[n_buckets + 1],
    }
    events = _phase_marks(phase_events, ("memset", "claim", "buckets", "probe"))
    rc = _library().hash_probe(
        ctypes.byref(pks), ctypes.byref(bks), probe_active.data_ptr(),
        build_active.data_ptr(), n, m, n_buckets, C, int(left_outer),
        out["table"].data_ptr(), meta.data_ptr(), heads.data_ptr(),
        *(out[k].data_ptr() for k in ("bucket_p", "count", "emit")), events,
        _stream(probe_active),
    )
    _check_launch("hash_probe", rc)
    LAUNCHES["hash_probe"] += 1
    return out


def hash_expand_plain(table, counts, bucket_p, count, emit, pkeys, bkeys, luts,
                      probe_active, probe_cols, build_cols, out_capacity: int, dest=None):
    """The join stage of the reference's ``_expand_phase_body``: slots from
    ``kernels.expand_probe_slots``; each slot's build row is the (d+1)-th
    equal-key slot of its probe row's bucket (a cumsum over the match block,
    slot 0 where there is none), in chunks of slots; then the gathers, and
    given ``dest`` the destination stage, :func:`partition_dest_plain` over
    the gathered columns."""
    pk, pv = normalized_keys(pkeys, luts)
    bk, _ = normalized_keys(bkeys, (None,) * len(bkeys))
    pa = probe_active & pv
    C = table.shape[1]
    probe_idx, d, out_active, _ = K.expand_probe_slots(emit, out_capacity)
    matched = d < count[probe_idx]
    bpos = torch.empty(out_capacity, dtype=torch.int64, device=table.device)
    for lo in range(0, out_capacity, _PLAIN_CHUNK):
        sl = slice(lo, lo + _PLAIN_CHUNK)
        pi = probe_idx[sl]
        eq, rows = _bucket_eq(table, counts, bucket_p[pi], [k[pi] for k in pk], pa[pi], bk, C)
        cum = torch.cumsum(eq.to(torch.int32), 1)
        sel = eq & (cum == (d[sl] + 1)[:, None])
        slot = torch.argmax(sel.to(torch.int8), 1)
        bpos[sl] = rows.gather(1, slot[:, None])[:, 0]
    probe_out = [(dt[probe_idx], v[probe_idx]) for dt, v in probe_cols]
    build_out = [(dt[bpos], v[bpos] & matched) for dt, v in build_cols]
    if dest is None:
        return probe_out, build_out, out_active
    key_idx, dluts, n_parts = dest
    cols = probe_out + build_out
    return (probe_out, build_out, out_active,
            partition_dest_plain([cols[i] for i in key_idx], dluts, out_active, n_parts))


def _dest_keys(name: str, dest, probe_cols, build_cols):
    """The DestKeys of a destination folded into ``hash_expand``:
    ``(key_idx, luts, n_parts)`` over ``probe_cols + build_cols``."""
    dk = _DestKeys()
    if dest is None:
        return dk
    key_idx, luts, n_parts = dest
    cols = list(probe_cols) + list(build_cols)
    if not 1 <= len(key_idx) <= _MAX_WIDE_KEYS or len(luts) != len(key_idx):
        raise ValueError(f"{name}: 1 to {_MAX_WIDE_KEYS} destination keys, one LUT slot each")
    if not 1 <= n_parts <= EPILOGUE_MAX_PARTS:
        raise ValueError(f"{name}: n_parts {n_parts} outside [1, {EPILOGUE_MAX_PARTS}]")
    for k, (i, lut) in enumerate(zip(key_idx, luts)):
        if not 0 <= i < len(cols):
            raise ValueError(f"{name}: destination key {i} is not a column")
        d, v = cols[i]
        if d.ndim != 1 or d.dtype not in _KEY_TYPES:
            raise TypeError(f"{name}: unsupported destination key {d.dtype} {tuple(d.shape)}")
        c = dk.col[k]
        c.data, c.valid, c.type = d.data_ptr(), v.data_ptr(), _KEY_TYPES[d.dtype]
        if lut is not None:
            _check_vectors(name, (lut,), (torch.int64,))
            if lut.device != d.device or lut.shape[0] < 1:
                raise ValueError(f"{name}: LUT must be a non-empty tensor on {d.device}")
            c.lut, c.lut_len = lut.data_ptr(), lut.shape[0]
        dk.build_side[k] = int(i >= len(probe_cols))
    dk.n, dk.n_parts = len(key_idx), n_parts
    return dk


def hash_expand(table, counts, bucket_p, count, emit, pkeys, bkeys, luts,
                probe_active: torch.Tensor, probe_cols, build_cols, out_capacity: int,
                dest=None, *, phase_events=None):
    """The join expansion into ``out_capacity`` slots after
    :func:`hash_probe` (its table, counts, bucket_p, count and emit).

    ``probe_cols``/``build_cols``: (data, valid) of every column of each
    side, in page order. Returns ``(probe_out, build_out, out_active)``:
    the gathered (data, valid) pairs, build validity ANDed with the slot's
    matched flag, and the output activity. ``dest``, None or ``(key_idx,
    luts, n_parts)`` (the exchange keys' positions among ``probe_cols +
    build_cols``, each None or the int64 value-key LUT of its dictionary,
    and 1 to :data:`EPILOGUE_MAX_PARTS` partitions), adds a fourth result:
    each slot's exchange destination (int32, ``n_parts`` on an inactive
    slot), :func:`partition_dest` of the gathered keys. On CUDA tensors the
    kernel is a scan pass over ``emit`` (tiles of :data:`EXPAND_TILE_ROWS`
    rows) and a slot pass, which also writes the destination;
    ``phase_events``, None or three ``torch.cuda.Event``, are recorded on
    the stream before the scan, between the passes and after the slot pass,
    to split the kernel's time."""
    _check_keys("hash_expand", pkeys, bkeys, luts)
    _check_vectors("hash_expand", (probe_active,), (torch.bool,))
    _check_vectors("hash_expand", (emit, count, bucket_p), (torch.int32,) * 3)
    n, m = probe_active.shape[0], bkeys[0][0].shape[0]
    if emit.shape[0] != n or table.ndim != 2 or counts.shape[0] != table.shape[0]:
        raise ValueError("hash_expand: probe outputs do not match the probe side")
    if out_capacity < 1:
        raise ValueError("hash_expand: out_capacity must be positive")
    if table.dtype != torch.int32 or counts.dtype != torch.int32 or not table.is_contiguous():
        raise TypeError("hash_expand: table and counts are int32, the table contiguous")
    for side, cols, rows in (("probe", probe_cols, n), ("build", build_cols, m)):
        for d, v in cols:
            if d.shape[0] != rows or v.shape != (rows,) or v.dtype != torch.bool:
                raise ValueError(f"hash_expand: a {side} column is not {rows} rows")
            if d.device != probe_active.device or not (d.is_contiguous() and v.is_contiguous()):
                raise ValueError(f"hash_expand: {side} columns must be contiguous "
                                 f"on {probe_active.device}")
    dk = _dest_keys("hash_expand", dest, probe_cols, build_cols)
    if probe_active.device.type == "cpu":
        return hash_expand_plain(table, counts, bucket_p, count, emit, pkeys, bkeys,
                                 luts, probe_active, probe_cols, build_cols, out_capacity, dest)
    if n >= 2**31 or out_capacity >= 2**31:
        raise ValueError("hash_expand: the kernel takes at most 2^31 - 1 probe rows "
                         "and output slots")
    dev = probe_active.device
    pks = _key_set("hash_expand", pkeys, luts, n)
    bks = _key_set("hash_expand", bkeys, (None,) * len(bkeys), m)
    outs = []
    cols = [(c, 0) for c in probe_cols] + [(c, 1) for c in build_cols]
    n_sets = max(1, -(-len(cols) // _MAX_GATHER_COLS))
    sets = (_GatherSet * n_sets)()
    for i, ((d, v), side) in enumerate(cols):
        od = torch.empty((out_capacity,) + tuple(d.shape[1:]), dtype=d.dtype, device=dev)
        ov = torch.empty(out_capacity, dtype=torch.bool, device=dev)
        outs.append((od, ov))
        g = sets[i // _MAX_GATHER_COLS]
        gc = g.col[g.n]
        gc.src, gc.src_valid, gc.dst, gc.dst_valid = (
            d.data_ptr(), v.data_ptr(), od.data_ptr(), ov.data_ptr())
        gc.elem_bytes = d.element_size() * (d[0].numel() if d.ndim > 1 else 1)
        if gc.elem_bytes not in (1, 2, 4, 8, 16):
            raise TypeError(f"hash_expand: {gc.elem_bytes}-byte elements are not supported")
        gc.build_side = side
        g.n += 1
    lib = _library()
    stream = _stream(probe_active)
    state = torch.empty(_EXPAND_STATE_HEAD + -(-n // EXPAND_TILE_ROWS), dtype=torch.int64,
                        device=dev)
    slot_row = torch.empty(out_capacity, dtype=torch.int64, device=dev)
    slot_d = torch.empty(out_capacity, dtype=torch.int32, device=dev)
    out_active = torch.empty(out_capacity, dtype=torch.bool, device=dev)
    dest_out = torch.empty(out_capacity, dtype=torch.int32, device=dev) if dk.n else None
    # the slot pass saves each slot's rows only for the gather sets after the first
    saved = [torch.empty(out_capacity, dtype=dt, device=dev) if n_sets > 1 else None
             for dt in (torch.int64, torch.int64, torch.bool)]
    marks = list(phase_events or ())
    if marks:
        marks[0].record()
    _check_launch("hash_expand", lib.hash_expand_scan(
        emit.data_ptr(), n, out_capacity, state.data_ptr(), slot_row.data_ptr(),
        slot_d.data_ptr(), stream))
    if marks:
        marks[1].record()
    rc = lib.hash_expand_slots(
        ctypes.byref(pks), ctypes.byref(bks), count.data_ptr(), bucket_p.data_ptr(),
        table.data_ptr(), counts.data_ptr(), n, m, table.shape[1], out_capacity,
        state.data_ptr(), slot_row.data_ptr(), slot_d.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in saved), out_active.data_ptr(),
        sets, n_sets, ctypes.byref(dk), None if dest_out is None else dest_out.data_ptr(),
        stream,
    )
    _check_launch("hash_expand", rc)
    if marks:
        marks[2].record()
    LAUNCHES["hash_expand"] += 1
    out = outs[: len(probe_cols)], outs[len(probe_cols):], out_active
    return out if dest_out is None else out + (dest_out,)


# --------------------------------------------------------------------------- #
# the sort-path aggregation (replaces megakernels.aggregate_phase): segment_agg
# --------------------------------------------------------------------------- #

# rows of one segment_agg tile (kSegRows in csrc/segment_agg.cu)
SEGMENT_TILE_ROWS = 2048
# the most requests, outputs and group keys one segment_agg call takes
# (kMaxAggRequests, kMaxAggOutputs in csrc/agg_common.cuh; kMaxWideKeys in
# csrc/join_keys.cuh), and the most requests one output reads (kMaxAggReads)
SEGMENT_AGG_MAX_REQUESTS = 32
SEGMENT_AGG_MAX_OUTPUTS = 24
SEGMENT_AGG_MAX_KEYS = 8
AGG_MAX_READS = 6
# the most distinct bool columns (the activity, filters and validities) one
# segment_agg call's requests read as weights (kMaxMasks in csrc/segment_agg.cu)
SEGMENT_AGG_MAX_MASKS = 16
# request kinds, finishing ops and per-row transforms (AggKind, AggOp,
# AggTransform in csrc/agg_common.cuh)
_AGG_KINDS = {"sum": 0, "fsum": 1, "min": 2, "max": 3, "fmin": 4, "fmax": 5, "last": 6,
              "count": 7, "band": 8, "bor": 9, "bxor": 10, "checksum": 11, "match_last": 12,
              "tied": 13}
_AGG_OPS = {"value": 0, "avg_decimal": 1, "avg_double": 2, "bool_and": 3, "bool_or": 4,
            "first": 5, "var_pop": 6, "var_samp": 7, "stddev_pop": 8, "stddev_samp": 9,
            "covar_pop": 10, "covar_samp": 11, "corr": 12, "regr_slope": 13,
            "regr_intercept": 14, "regr_avgx": 15, "regr_avgy": 16, "regr_sxx": 17,
            "regr_syy": 18, "regr_sxy": 19, "regr_r2": 20, "skewness": 21, "kurtosis": 22,
            "geometric_mean": 23, "entropy": 24, "percentile": 25, "digest": 26,
            "int128": 27}
_AGG_PREDS = {None: 0, "nonzero": 1, "zero": 2}
_AGG_TRANSFORMS = {None: 0, "log": 1, "clamp0": 2, "xlog2x": 3, "order_key": 4}
_BITWISE_IDENTITY = {"band": -1, "bor": 0, "bxor": 0}
# what a NULL row adds to a checksum
CHECKSUM_NULL = 0x9E3779B9
# the centroids of a digest output (kDigestCentroids; spi/types.py
# TDIGEST_CENTROIDS): each slot holds their means, then their weights
DIGEST_CENTROIDS = 64
# the finishing ops of the variance family and of the two-column moments
_VARIANCE_OPS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")
_TWO_COLUMN_OPS = ("covar_pop", "covar_samp", "corr", "regr_slope", "regr_intercept",
                   "regr_avgx", "regr_avgy", "regr_sxx", "regr_syy", "regr_sxy", "regr_r2")


@dataclass(frozen=True, eq=False)
class AggRequest:
    """One per-group reduction of the aggregation kernels.

    ``kind``: ``count`` (weighted rows), ``sum`` (int64 sum, wrapping, of
    integer or bool values), ``fsum`` (float64 sum of a per-row double: the
    value divided by ``divisor``, then ``transform`` (``log``, ``clamp0``:
    ``max(x, 0)``, ``xlog2x``: ``c * log2(c)`` of ``c = max(x, 0)`` where
    ``c > 0``, else 0), raised to ``power`` (1 to 4, multiplied left to
    right: ``x * x * x`` is ``(x * x) * x``) and times ``values2`` divided
    by ``divisor2`` where given), ``min``/``max`` (of integer, bool or
    float values, or of ``order_key`` transforms: the int64 order key of
    any value), ``band``/``bor``/``bxor`` (bitwise AND, OR, XOR of the
    values as int64), ``checksum`` (the wrapping sum of
    ``splitmix64(order_key(v))``, ``v`` the value or ``lut[code]`` of a
    dictionary code, or :data:`CHECKSUM_NULL` where ``valid`` is false:
    ``valid`` is not part of its weight), ``last`` (the last weighted
    row: ``arbitrary``'s), ``match_last`` (the last weighted row whose
    order key equals request ``ref``'s result for its group, an
    ``order_key`` min or max: ``min_by``/``max_by``'s row) or ``tied``
    (the min, or the max, as request ``ref`` is a min or a max, of the
    int64 values among the weighted rows whose ``values2`` equals request
    ``ref``'s result for its group, ``values2`` being ``ref``'s values: a
    long decimal's lo limb in unsigned order among the rows tied on its hi
    limb's extreme). A row is
    weighted where the page's activity, ``filt & filt_valid`` (an
    aggregate FILTER), ``valid``, ``valid2`` and ``pred`` on the value
    (``"nonzero"`` or ``"zero"``) all hold; None leaves a term out. A
    ``resorted`` count reads columns that :func:`segment_sort` re-sorted
    within each group (the exact distinct count: its sorted weight and
    run heads): their weight carries each row's activity, so the page's
    activity at the row's new position is not part of it."""

    kind: str
    values: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    filt: Optional[torch.Tensor] = None
    filt_valid: Optional[torch.Tensor] = None
    pred: Optional[str] = None
    divisor: float = 1.0
    power: int = 1
    transform: Optional[str] = None
    values2: Optional[torch.Tensor] = None
    valid2: Optional[torch.Tensor] = None
    divisor2: float = 1.0
    lut: Optional[torch.Tensor] = None
    ref: int = -1
    resorted: bool = False

    def weight(self, active: torch.Tensor) -> torch.Tensor:
        w = torch.ones_like(active) if self.resorted else active
        if self.filt is not None:
            w = w & (self.filt & self.filt_valid)
        if self.valid is not None and self.kind != "checksum":
            w = w & self.valid
        if self.valid2 is not None:
            w = w & self.valid2
        if self.pred is not None:
            nz = self.values.to(torch.bool)
            w = w & (nz if self.pred == "nonzero" else ~nz)
        return w

    def key(self):
        """What two equal requests share (the tensors by address; the two
        validities in either order)."""
        def ptr(t):
            return None if t is None else (t.data_ptr(), t.dtype)

        valids = tuple(sorted((ptr(self.valid), ptr(self.valid2)), key=str))
        return (self.kind, ptr(self.values), valids, ptr(self.filt), ptr(self.filt_valid),
                ptr(self.values2), ptr(self.lut), self.pred, self.divisor, self.divisor2,
                self.power, self.transform, self.ref, self.resorted)


@dataclass(frozen=True, eq=False)
class AggOutput:
    """One aggregate's output column from the requests' results.

    ``reads`` names the requests the op reads, in its order:

    - ``value`` (request ``a`` cast to ``dtype``), ``avg_decimal`` (``a``
      over count ``b``, rounded half up), ``avg_double`` (``a`` as a double
      over count ``b``, then over ``divisor``, cast to ``dtype``),
      ``bool_and``/``bool_or`` (count ``a`` zero / positive) and ``first``
      (``values`` at row ``a``, a ``last`` or ``match_last`` request; with
      ``values_valid``, valid only where that is true at the row) read
      ``(a, b)``: valid where count ``b`` is positive, or everywhere where
      ``b`` is -1 or left out;
    - the variance family (``var_pop``, ``var_samp``, ``stddev_pop``,
      ``stddev_samp``) reads ``(count, sum x, sum x^2)``;
    - the two-column moments (``covar_*``, ``corr``, ``regr_*`` but
      ``regr_count``, a ``value``) read ``(count, sum x, sum y, sum xy, sum
      x^2, sum y^2)``, -1 where the op needs none;
    - ``skewness`` and ``kurtosis`` read ``(count, sum x, ..., sum x^3)``
      and ``(..., sum x^4)``, ``geometric_mean`` ``(count, sum log x)``,
      ``entropy`` ``(count, sum max(x, 0), sum c log2 c)``;
    - ``percentile`` reads ``(a, b)``: a ``last`` request's row, where it
      reads the quantile q in ``quantiles`` (as a double, over
      ``divisor``), and the count ``b`` of the group's participants; it
      gathers ``values`` (:func:`segment_sort`'s sorted column, the
      participants first) at the group's start plus ``clamp(floor(q *
      max(b - 1, 0)), 0, max(b - 1, 0))``, valid where ``b`` is positive;
    - ``int128`` reads ``(a, b, c)``: a ``min``/``max`` request ``a`` of a
      long decimal's hi limb, the ``tied`` request ``b`` of its lo limb in
      unsigned order, and the count ``c``; it writes the ``[slots, 2]``
      int64 limbs ``(a, b ^ INT64_MIN)``, valid where ``c`` is positive;
    - ``digest`` reads ``(b,)``, the count of the group's participants,
      and writes a ``[slots, 2 * DIGEST_CENTROIDS]`` float64 output: from
      ``values`` (sorted with the participants first; ``values_valid`` its
      sorted weight) over ``divisor``, the mean and the weight of each
      centroid, the participants of rank r in the group whose bucket
      ``clip(int((0.5 + asin(clip(2 q - 1, -1, 1)) / pi) * 64), 0, 63)``,
      ``q = (r + 0.5) / b``, is its index; valid where ``b`` is positive.

    Each is finished as ``executor._eval_aggregate`` finished it, operation
    by operation."""

    op: str
    reads: Tuple[int, ...]
    dtype: torch.dtype
    divisor: float = 1.0
    values: Optional[torch.Tensor] = None
    values_valid: Optional[torch.Tensor] = None
    quantiles: Optional[torch.Tensor] = None


def _fsum_rows(req: AggRequest, w: torch.Tensor) -> torch.Tensor:
    """An ``fsum`` request's per-row doubles (those of unweighted rows do
    not count), in the order of operations of the reference's formulas."""
    x = req.values.to(torch.float64)
    if req.divisor != 1.0:
        x = x / req.divisor
    if req.transform == "log":
        x = torch.where(w, torch.log(torch.where(w, x, 1.0)), 0.0)
    elif req.transform in ("clamp0", "xlog2x"):
        x = x.clamp(min=0.0)
        if req.transform == "xlog2x":
            x = torch.where(x > 0, x * torch.log2(torch.where(x > 0, x, 1.0)), 0.0)
    y = x
    for _ in range(req.power - 1):
        y = y * x
    if req.values2 is not None:
        x2 = req.values2.to(torch.float64)
        if req.divisor2 != 1.0:
            x2 = x2 / req.divisor2
        y = y * x2
    return y


def run_request(req: AggRequest, active: torch.Tensor, reduce_fn, first_fn,
                results=(), broadcast_fn=None, requests=()) -> torch.Tensor:
    """A request through the torch reductions of an aggregation path
    (``reduce_fn(vals, weight, kind)``, ``first_fn(vals, weight)`` and, for
    a ``match_last`` or ``tied`` request, ``broadcast_fn`` of the earlier
    ``results`` of ``requests``, the executor's): a ``last`` or
    ``match_last`` request gives the row."""
    w = req.weight(active)
    if req.kind == "count":
        return reduce_fn(w.to(torch.int64), w, "count")
    v = req.values
    if req.kind in ("sum", "band", "bor", "bxor"):
        return reduce_fn(v.to(torch.int64), w, req.kind)
    if req.kind == "fsum":
        return reduce_fn(_fsum_rows(req, w), w, "sum")
    if req.kind == "checksum":
        if req.lut is not None:
            v = req.lut[v.to(torch.int64).clamp(0, req.lut.shape[0] - 1)]
        hashed = K.splitmix64(K.order_key(v))
        if req.valid is not None:
            hashed = torch.where(req.valid, hashed, CHECKSUM_NULL)
        return reduce_fn(torch.where(w, hashed, 0), w, "sum")
    if req.kind in ("min", "max"):
        if req.transform == "order_key":
            v = K.order_key(v)
        if v.dtype.is_floating_point:
            masked = torch.where(w, v, float("inf") if req.kind == "min" else float("-inf"))
        elif v.dtype == torch.bool:
            masked = torch.where(w, v, req.kind == "min")
        else:
            masked = torch.where(w, v.to(torch.int64),
                                 K.INT64_MAX if req.kind == "min" else K.INT64_MIN)
        return reduce_fn(masked, torch.ones_like(w), req.kind)
    if req.kind == "tied":
        # the reference's tied-lo pass: the extreme among the rows on the
        # group's extreme of ``ref``
        kind = requests[req.ref].kind
        tied = w & (req.values2.to(torch.int64) == broadcast_fn(results[req.ref]))
        sent = K.INT64_MAX if kind == "min" else K.INT64_MIN
        return reduce_fn(torch.where(tied, v.to(torch.int64), sent), torch.ones_like(w), kind)
    rows = torch.arange(w.shape[0], dtype=torch.int64, device=w.device)
    if req.kind == "last":
        return first_fn(rows, w)
    if req.kind == "match_last":
        return first_fn(rows, w & (K.order_key(v) == broadcast_fn(results[req.ref])))
    raise ValueError(f"unknown aggregate request {req.kind!r}")


def run_requests(requests, active: torch.Tensor, reduce_fn, first_fn, broadcast_fn=None):
    """Every request in order (a ``match_last`` or ``tied`` reads an earlier
    result)."""
    results = []
    for r in requests:
        results.append(run_request(r, active, reduce_fn, first_fn, results, broadcast_fn,
                                   requests))
    return results


def _moments(op: str, r, out_cap: int):
    """The finishing of the moments from the read results ``r`` (count
    first), as ``executor._eval_aggregate`` computed it."""
    cnt = r[0]
    n = cnt.clamp(min=1).to(torch.float64)
    if op in _VARIANCE_OPS:
        s1, s2 = r[1], r[2]
        mean = s1 / n
        var_pop = (s2 / n - mean * mean).clamp(min=0.0)
        if op.endswith("_pop"):
            var, valid = var_pop, cnt > 0
        else:
            var, valid = var_pop * n / (n - 1).clamp(min=1), cnt > 1
        return (torch.sqrt(var) if op.startswith("stddev") else var), valid
    if op in _TWO_COLUMN_OPS:
        sx, sy, sxy, sxx, syy = r[1:6]

        def cov():
            return sxy / n - (sx / n) * (sy / n)

        def varx():
            return (sxx / n - (sx / n) ** 2).clamp(min=0.0)

        def vary():
            return (syy / n - (sy / n) ** 2).clamp(min=0.0)

        if op == "covar_pop":
            return cov(), cnt > 0
        if op == "covar_samp":
            return cov() * n / (n - 1).clamp(min=1.0), cnt > 1
        if op == "corr":
            denom = torch.sqrt(varx() * vary())
            return cov() / torch.where(denom > 0, denom, 1.0), (cnt > 1) & (denom > 0)
        if op in ("regr_slope", "regr_intercept"):
            vx = varx()
            slope = cov() / torch.where(vx > 0, vx, 1.0)
            data = slope if op == "regr_slope" else sy / n - slope * (sx / n)
            return data, (cnt > 1) & (vx > 0)
        if op == "regr_avgx":
            return sx / n, cnt > 0
        if op == "regr_avgy":
            return sy / n, cnt > 0
        if op == "regr_sxx":
            return varx() * n, cnt > 0
        if op == "regr_syy":
            return vary() * n, cnt > 0
        if op == "regr_sxy":
            return cov() * n, cnt > 0
        # regr_r2: 1.0 where y is constant, NULL where x is
        vx, vy = varx(), vary()
        r2 = (cov() * cov()) / torch.where(vx * vy > 0, vx * vy, 1.0)
        return torch.where(vy > 0, r2, 1.0), (cnt > 0) & (vx > 0)
    if op in ("skewness", "kurtosis"):
        # central moments from the raw power sums
        s1, s2, s3 = r[1], r[2], r[3]
        m = s1 / n
        M2 = s2 - s1 * m
        M3 = s3 - 3 * s2 * m + 2 * s1 * m * m
        if op == "skewness":
            data = torch.sqrt(n) * M3 / torch.pow(M2.clamp(min=1e-300), 1.5)
            return data, (cnt > 2) & (M2 > 0)
        s4 = r[4]
        M4 = s4 - 4 * s3 * m + 6 * s2 * m * m - 3 * s1 * m * m * m
        data = (n * (n + 1) / ((n - 1) * (n - 2) * (n - 3)).clamp(min=1.0)) * (
            n * M4 / (M2 * M2).clamp(min=1e-300)
        ) - 3 * (n - 1) * (n - 1) / ((n - 2) * (n - 3)).clamp(min=1.0)
        return data, (cnt > 3) & (M2 > 0)
    if op == "geometric_mean":
        return torch.exp(r[1] / n), cnt > 0
    if op == "entropy":
        # log2 entropy of the per-row counts: log2(S) - sum(c log2 c) / S
        s, sl = r[1], r[2]
        pos = s > 0
        safe = torch.where(pos, s, 1.0)
        return torch.where(pos, torch.log2(safe) - sl / safe, 0.0).clamp(min=0.0), cnt > 0
    raise ValueError(f"unknown aggregate output {op!r}")


def _percentile(out: AggOutput, r, starts: torch.Tensor):
    """The ``percentile`` op (executor's percentile_fn): the rank of the
    group's quantile among its participants, gathered from the sorted
    values."""
    row, nq = r
    n = out.values.shape[0]
    q = out.quantiles[row.clamp(0, n - 1)].to(torch.float64)
    if out.divisor != 1.0:
        q = q / out.divisor
    top = (nq - 1).clamp(min=0)
    idx = torch.minimum(torch.floor(q * top.to(torch.float64)).to(torch.int64).clamp(min=0),
                        top)
    return out.values[(starts + idx).clamp(0, n - 1)].to(out.dtype), nq > 0


def _digest(out: AggOutput, nonempty: torch.Tensor, starts: torch.Tensor, gid: torch.Tensor,
            out_cap: int):
    """The ``digest`` op (executor's tdigest_fn): each participant's bucket
    from its rank in the group, then one sum of the values and one of the
    weights per (group, bucket)."""
    kc = DIGEST_CENTROIDS
    w2 = out.values_valid
    x = out.values.to(torch.float64)
    if out.divisor != 1.0:
        x = x / out.divisor
    n = x.shape[0]
    rank = torch.arange(n, dtype=torch.int64, device=x.device) - starts[gid]
    n_g = nonempty[gid].clamp(min=1).to(torch.float64)
    q = (rank.to(torch.float64) + 0.5) / n_g
    scale = 0.5 + torch.asin(torch.clamp(2.0 * q - 1.0, -1.0, 1.0)) / math.pi
    bucket = (scale * kc).to(torch.int32).clamp(0, kc - 1)
    seg = torch.where(w2, gid * kc + bucket, out_cap * kc)
    sums = torch.zeros(out_cap * kc + 1, dtype=torch.float64, device=x.device)
    sums.index_add_(0, seg, torch.where(w2, x, 0.0))
    cnts = torch.zeros(out_cap * kc + 1, dtype=torch.float64, device=x.device)
    cnts.index_add_(0, seg, w2.to(torch.float64))
    sums, cnts = sums[:-1].reshape(out_cap, kc), cnts[:-1].reshape(out_cap, kc)
    means = torch.where(cnts > 0, sums / cnts.clamp(min=1.0), 0.0)
    return torch.cat([means, cnts], dim=-1), nonempty > 0


def finish_output(out: AggOutput, results, out_cap: int, starts=None, gid=None):
    """An output's (data, valid) from the requests' results: the finishing
    of ``executor._eval_aggregate``. ``percentile`` and ``digest`` read each
    group's first row ``starts`` (:func:`segment_agg_plain`'s), and the
    digest each row's group index ``gid``."""
    r = [None if k < 0 else results[k] for k in out.reads]
    if out.op == "percentile":
        return _percentile(out, r, starts)
    if out.op == "digest":
        return _digest(out, r[0], starts, gid, out_cap)
    if out.op == "int128":
        return torch.stack([r[0], r[1] ^ K.INT64_MIN], -1), r[2] > 0
    if out.op not in ("value", "avg_decimal", "avg_double", "bool_and", "bool_or", "first"):
        return _moments(out.op, r, out_cap)
    a = r[0]
    if len(r) < 2 or r[1] is None:
        valid = torch.ones(out_cap, dtype=torch.bool, device=a.device)
    else:
        valid = r[1] > 0
    if out.op == "value":
        return a.to(out.dtype), valid
    if out.op == "avg_decimal":
        nonempty = r[1]
        half = nonempty // 2
        denom = nonempty.clamp(min=1)
        data = torch.where(a >= 0, (a + half) // denom, -((-a + half) // denom))
        return data.to(out.dtype), valid
    if out.op == "avg_double":
        data = a.to(torch.float64) / r[1].clamp(min=1)
        if out.divisor != 1.0:
            data = data / out.divisor
        return data.to(out.dtype), valid
    if out.op == "bool_and":
        return a == 0, valid
    if out.op == "bool_or":
        return a > 0, valid
    # first: the values at the request's row
    if out.values_valid is not None:
        valid = valid & out.values_valid[a]
    return out.values[a], valid


def segment_agg_plain(new_group, num_groups, out_cap: int, active, key_cols, requests,
                      outputs, dest=None):
    """The reference's ``_aggregate_impl`` over a group-sorted page, for the
    requests and outputs given: ``kernels.boundary_positions``, the key
    gathers at the starts, sums and counts by cumsum at the group
    boundaries, the bitwise reductions by prefix sums of each bit, min, max,
    ``last`` and ``match_last`` by a scatter on the group index (rows
    before the first group in no slot), the finishing, and the destination
    stage (:func:`partition_dest_plain` of the gathered keys)."""
    n = new_group.shape[0]
    dev = new_group.device
    starts = K.boundary_positions(new_group, out_cap)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)]) - 1
    bounds = (starts, ends)
    safe = starts.clamp(0, n - 1)
    group_exists = torch.arange(out_cap, device=dev) < num_groups
    keys_out = [(d[safe], v[safe] & group_exists) for d, v in key_cols]
    gid = K.cumsum(new_group) - 1
    in_group = gid >= 0
    gid = gid.clamp(min=0)

    def reduce_fn(vals, w, kind):
        if kind in ("sum", "count"):
            return K.segment_reduce(vals, w, None, out_cap, kind, new_group, bounds)
        if kind in K.BITWISE_KINDS:
            return K.bitwise_group_reduce(vals, w, gid, out_cap, kind, bounds)
        return K.segment_reduce(vals, w & in_group, gid, out_cap, kind)

    def first_fn(vals, w):
        return K.direct_group_first(vals, w & in_group, gid, out_cap)

    results = run_requests(requests, active, reduce_fn, first_fn, lambda g: g[gid])
    outs = [finish_output(o, results, out_cap, starts, gid) for o in outputs]
    dest_out = None
    if dest is not None:
        positions, luts, n_parts = dest
        dest_out = partition_dest_plain([keys_out[i] for i in positions], luts, group_exists,
                                        n_parts)
    return starts, group_exists, keys_out, outs, dest_out


class _AggRequest(ctypes.Structure):
    _fields_ = [
        ("values", ctypes.c_void_p), ("valid", ctypes.c_void_p), ("filter", ctypes.c_void_p),
        ("filter_valid", ctypes.c_void_p), ("values2", ctypes.c_void_p),
        ("valid2", ctypes.c_void_p), ("lut", ctypes.c_void_p), ("inv_divisor", ctypes.c_double),
        ("inv_divisor2", ctypes.c_double), ("identity", ctypes.c_int64),
        ("lut_len", ctypes.c_int32),
        ("ref", ctypes.c_int32), ("type", ctypes.c_int8), ("type2", ctypes.c_int8),
        ("kind", ctypes.c_int8), ("pred", ctypes.c_int8), ("power", ctypes.c_int8),
        ("transform", ctypes.c_int8), ("resorted", ctypes.c_int8),
    ]


class _AggRequestSet(ctypes.Structure):
    _fields_ = [("req", _AggRequest * SEGMENT_AGG_MAX_REQUESTS), ("n", ctypes.c_int)]


class _AggOutput(ctypes.Structure):
    _fields_ = [
        ("first_values", ctypes.c_void_p), ("first_valid", ctypes.c_void_p),
        ("data", ctypes.c_void_p), ("valid", ctypes.c_void_p), ("divisor", ctypes.c_double),
        ("op", ctypes.c_int), ("reads", ctypes.c_int * AGG_MAX_READS), ("n_reads", ctypes.c_int),
        ("out_type", ctypes.c_int), ("elem_bytes", ctypes.c_int), ("a_float", ctypes.c_int),
        ("values_type", ctypes.c_int), ("quantiles_type", ctypes.c_int),
        ("quantiles", ctypes.c_void_p),
    ]


class _AggOutputSet(ctypes.Structure):
    _fields_ = [("out", _AggOutput * SEGMENT_AGG_MAX_OUTPUTS), ("n", ctypes.c_int)]


def _f64_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


def _check_request_col(name: str, t, dtypes, n: int, dev) -> None:
    if t is None:
        return
    if t.ndim != 1 or t.dtype not in dtypes:
        raise TypeError(f"{name}: request column of {t.dtype} {tuple(t.shape)} is not supported")
    _check_vectors(name, (t,), (t.dtype,))
    if t.shape[0] != n or t.device != dev:
        raise ValueError(f"{name}: request columns must be {n} rows on {dev}")


def _request_plan(name: str, req: AggRequest, at: int, requests, n: int, dev):
    """(C kind, identity bits, result is a double) of request ``at``;
    raises on what the kernel does not take."""
    kind = req.kind
    if kind not in _AGG_KINDS or kind in ("fmin", "fmax"):
        raise ValueError(f"{name}: unknown request kind {kind!r}")
    for t in (req.valid, req.valid2, req.filt, req.filt_valid):
        _check_request_col(name, t, (torch.bool,), n, dev)
    _check_request_col(name, req.values, _KEY_TYPES, n, dev)
    _check_request_col(name, req.values2, _KEY_TYPES, n, dev)
    if (req.filt is None) != (req.filt_valid is None):
        raise ValueError(f"{name}: a filter needs its validity")
    if req.pred not in _AGG_PREDS or req.transform not in _AGG_TRANSFORMS:
        raise ValueError(f"{name}: unknown predicate {req.pred!r} or transform {req.transform!r}")
    v = req.values
    if v is None and (kind != "count" or req.pred is not None):
        raise ValueError(f"{name}: a {kind} request needs its values")
    if kind != "fsum" and (req.power != 1 or (req.values2 is not None and kind != "tied")
                           or req.transform not in (None, "order_key")):
        raise ValueError(f"{name}: powers, second operands and transforms are fsum's")
    if not 1 <= req.power <= 4:
        raise ValueError(f"{name}: power {req.power} outside [1, 4]")
    if req.transform == "order_key" and kind not in ("min", "max", "match_last"):
        raise ValueError(f"{name}: order_key transforms a min, max or match_last")
    if req.resorted and kind != "count":
        raise ValueError(f"{name}: a resorted request is a count")
    if req.lut is not None:
        if kind != "checksum" or v.dtype.is_floating_point:
            raise ValueError(f"{name}: a LUT translates a checksum's dictionary codes")
        _check_vectors(name, (req.lut,), (torch.int64,))
        if req.lut.device != dev or req.lut.shape[0] < 1:
            raise ValueError(f"{name}: LUT must be a non-empty tensor on {dev}")
    is_float = v is not None and v.dtype.is_floating_point
    if kind in ("sum", "band", "bor", "bxor") and is_float:
        raise TypeError(f"{name}: a {kind} of doubles (a float sum is an fsum request)")
    if kind == "match_last":
        if not (0 <= req.ref < at and requests[req.ref].kind in ("min", "max")
                and requests[req.ref].transform == "order_key"):
            raise ValueError(f"{name}: match_last reads an earlier order_key min or max")
        return _AGG_KINDS[kind], -1, False
    if kind == "tied":
        ref = requests[req.ref] if 0 <= req.ref < at else None
        if (ref is None or ref.kind not in ("min", "max") or ref.transform is not None
                or ref.values is None or ref.values.dtype != torch.int64
                or req.values2 is None or req.values2.data_ptr() != ref.values.data_ptr()
                or v.dtype != torch.int64 or req.transform is not None or req.pred is not None):
            raise ValueError(f"{name}: a tied request reduces int64 values on the rows tied "
                             "on an earlier int64 min or max, whose values are its values2")
        return _AGG_KINDS[kind], int(K.INT64_MAX if ref.kind == "min" else K.INT64_MIN), False
    if kind in ("min", "max"):
        if req.transform == "order_key" or not (is_float or v.dtype == torch.bool):
            return _AGG_KINDS[kind], int(K.INT64_MAX if kind == "min" else K.INT64_MIN), False
        if is_float:
            return (_AGG_KINDS["f" + kind],
                    _f64_bits(float("inf") if kind == "min" else float("-inf")), True)
        return _AGG_KINDS[kind], int(kind == "min"), False
    if kind == "last":
        return _AGG_KINDS["last"], -1, False
    return _AGG_KINDS[kind], _BITWISE_IDENTITY.get(kind, 0), kind == "fsum"


def _check_group_keys(name: str, key_cols, n: int, dev) -> None:
    """Group keys of ``segment_agg``: 1-D columns, or a long decimal's
    ``[n, 2]`` int64 limbs (gathered as 16-byte elements)."""
    if len(key_cols) > SEGMENT_AGG_MAX_KEYS:
        raise ValueError(f"{name}: 0 to {SEGMENT_AGG_MAX_KEYS} group keys")
    for d, v in key_cols:
        if d.ndim == 2:
            if (d.dtype != torch.int64 or tuple(d.shape) != (n, 2) or not d.is_contiguous()
                    or d.device != dev):
                raise TypeError(f"{name}: a 2-D key is a long decimal's contiguous int64 limbs")
            _check_vectors(name, (v,), (torch.bool,))
            if v.shape[0] != n or v.device != dev:
                raise ValueError(f"{name}: columns must be {n} rows on {dev}")
    _check_page_cols(name, [c for c in key_cols if c[0].ndim != 2], n, dev)
    for d, _ in key_cols:
        if d.dtype not in _KEY_TYPES:
            raise TypeError(f"{name}: unsupported key column {d.dtype}")


# the requests each finishing op reads after its count: their number, and
# whether a -1 (not needed) may stand for one
_MOMENT_READS = {**{op: (3, False) for op in _VARIANCE_OPS},
                 **{op: (6, True) for op in _TWO_COLUMN_OPS},
                 "skewness": (4, False), "kurtosis": (5, False),
                 "geometric_mean": (2, False), "entropy": (3, False)}


def _check_output(name: str, o: AggOutput, requests, plans, active) -> None:
    n, dev = active.shape[0], active.device
    if o.op not in _AGG_OPS or o.dtype not in _KEY_TYPES:
        raise ValueError(f"{name}: unsupported output {o.op!r} of {o.dtype}")
    reads = tuple(o.reads)
    if not reads or len(reads) > AGG_MAX_READS or reads[0] < 0 or any(
            not -1 <= k < len(requests) for k in reads):
        raise ValueError(f"{name}: an output names a request that is not there")
    kinds = [None if k < 0 else requests[k].kind for k in reads]
    if o.op in ("percentile", "digest"):
        want = ["last", "count"] if o.op == "percentile" else ["count"]
        if kinds != want or o.values is None or o.values.ndim != 1:
            raise ValueError(f"{name}: {o.op} reads {tuple(want)} and gathers 1-D sorted values")
        _check_request_col(name, o.values, _KEY_TYPES, n, dev)
        if o.op == "percentile":
            _check_request_col(name, o.quantiles, _KEY_TYPES, n, dev)
            if o.quantiles is None or o.values.dtype != o.dtype:
                raise TypeError(f"{name}: percentile keeps its values' type and reads quantiles")
        else:
            _check_request_col(name, o.values_valid, (torch.bool,), n, dev)
            if o.values_valid is None or o.dtype != torch.float64:
                raise TypeError(f"{name}: a digest is float64 and reads its sorted weight")
        return
    if o.op == "int128":
        if (kinds[1:] != ["tied", "count"] or kinds[0] not in ("min", "max")
                or requests[reads[1]].ref != reads[0] or o.dtype != torch.int64):
            raise ValueError(f"{name}: int128 reads a min or max, the tied request on it and "
                             "a count into int64 limbs")
        return
    if o.op in _MOMENT_READS:
        count, sparse = _MOMENT_READS[o.op]
        if (len(reads) != count or kinds[0] != "count" or o.dtype != torch.float64
                or any(k != "fsum" and not (sparse and k is None) for k in kinds[1:])):
            raise ValueError(f"{name}: {o.op} reads a count and {count - 1} float sums "
                             "into a double")
        return
    if len(reads) > 2 or (len(reads) == 2 and kinds[1] not in (None, "count")) or (
            o.op in ("avg_decimal", "avg_double") and (len(reads) < 2 or reads[1] < 0)):
        raise ValueError(f"{name}: an output's validity and divisor are counts")
    if o.op == "first":
        if kinds[0] not in ("last", "match_last") or o.values is None or o.values.ndim != 1:
            raise ValueError(f"{name}: first gathers 1-D values at a last request's row")
        _check_page_cols(name, [(o.values, active if o.values_valid is None
                                 else o.values_valid)], n, dev)
        if o.values.dtype != o.dtype:
            raise TypeError(f"{name}: first keeps its values' type")
    elif kinds[0] in ("last", "match_last"):
        raise ValueError(f"{name}: a row request is finished by first")
    elif o.op == "value" and plans[reads[0]][2] and not o.dtype.is_floating_point:
        raise TypeError(f"{name}: a float result cast to {o.dtype}")
    elif o.op in ("bool_and", "bool_or") and (kinds[0] != "count" or o.dtype != torch.bool):
        raise ValueError(f"{name}: {o.op} reads a count into a bool")


def _agg_plans(name: str, requests, outputs, active: torch.Tensor, match: bool = True):
    """The C plan of each request (:func:`_request_plan`), after the checks
    that the requests and outputs are a set the aggregation kernels take
    (``match``: whether the sort path's own are: ``match_last`` and
    ``resorted`` requests, ``percentile`` and ``digest`` outputs); raises
    on what they do not. Both take ``tied`` requests."""
    n, dev = active.shape[0], active.device
    if len(requests) > SEGMENT_AGG_MAX_REQUESTS or len(outputs) > SEGMENT_AGG_MAX_OUTPUTS:
        raise ValueError(f"{name}: at most {SEGMENT_AGG_MAX_REQUESTS} requests and "
                         f"{SEGMENT_AGG_MAX_OUTPUTS} outputs a call")
    if not match and any(r.kind == "match_last" or r.resorted for r in requests):
        raise ValueError(f"{name}: takes no match_last or resorted request")
    if not match and any(o.op in ("percentile", "digest") for o in outputs):
        raise ValueError(f"{name}: takes no percentile or digest output")
    plans = [_request_plan(name, r, i, requests, n, dev) for i, r in enumerate(requests)]
    for o in outputs:
        _check_output(name, o, requests, plans, active)
    return plans


def _agg_sets(requests, outputs, plans, slots: int, dev):
    """The kernels' request and output sets, and each output's (data, valid)
    buffers of ``slots`` rows."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    rs = _AggRequestSet()
    rs.n = len(requests)
    for c, r, (kind, ident, _) in zip(rs.req, requests, plans):
        c.values, c.valid, c.values2, c.valid2 = (ptr(r.values), ptr(r.valid), ptr(r.values2),
                                                  ptr(r.valid2))
        c.filter, c.filter_valid, c.lut = ptr(r.filt), ptr(r.filt_valid), ptr(r.lut)
        c.lut_len = 0 if r.lut is None else r.lut.shape[0]
        # the reciprocals, correctly rounded as the card's division is
        c.inv_divisor, c.inv_divisor2 = 1.0 / float(r.divisor), 1.0 / float(r.divisor2)
        c.identity, c.kind = ident, kind
        c.type = _KEY_TYPES[r.values.dtype] if r.values is not None else 0
        c.type2 = _KEY_TYPES[r.values2.dtype] if r.values2 is not None else 0
        c.pred, c.power, c.ref = _AGG_PREDS[r.pred], r.power, r.ref
        c.transform, c.resorted = _AGG_TRANSFORMS[r.transform], int(r.resorted)
    os_ = _AggOutputSet()
    os_.n = len(outputs)
    outs = []
    for c, o in zip(os_.out, outputs):
        lanes = {"digest": (2 * DIGEST_CENTROIDS,), "int128": (2,)}.get(o.op, ())
        data = torch.empty((slots,) + lanes, dtype=o.dtype, device=dev)
        valid = torch.empty(slots, dtype=torch.bool, device=dev)
        outs.append((data, valid))
        c.data, c.valid, c.divisor = data.data_ptr(), valid.data_ptr(), float(o.divisor)
        c.op, c.out_type, c.n_reads = _AGG_OPS[o.op], _KEY_TYPES[o.dtype], len(o.reads)
        for j, k in enumerate(o.reads):
            c.reads[j] = k
        c.a_float = int(plans[o.reads[0]][2])
        if o.op == "first":
            c.first_values, c.elem_bytes = o.values.data_ptr(), o.values.element_size()
            c.first_valid = ptr(o.values_valid)
        elif o.op in ("percentile", "digest"):
            c.first_values, c.elem_bytes = o.values.data_ptr(), o.values.element_size()
            c.values_type = _KEY_TYPES[o.values.dtype]
            if o.op == "percentile":
                c.quantiles, c.quantiles_type = o.quantiles.data_ptr(), _KEY_TYPES[
                    o.quantiles.dtype]
    return rs, os_, outs


def segment_agg_mask_columns(requests, active: torch.Tensor) -> set:
    """The distinct bool columns ``segment_agg``'s reduce pass reads as
    weight masks for ``requests``: the activity, each filter, its validity
    and each validity, told apart by address as the kernel does."""
    cols = {active.data_ptr()}
    for r in requests:
        cols.update(t.data_ptr() for t in (r.filt, r.filt_valid, r.valid, r.valid2)
                    if t is not None)
    return cols


def segment_agg(new_group: torch.Tensor, num_groups: torch.Tensor, out_cap: int,
                active: torch.Tensor, key_cols, requests, outputs, dest=None, *,
                phase_events=None):
    """The sort-path aggregation over a group-sorted page, whole.

    ``new_group`` (bool, set on each group's first row), ``num_groups`` (a
    0-d int64 tensor), ``out_cap`` output slots, the page's ``active``;
    ``key_cols``: (data, valid) of each group key (0 to 8, 1-D); ``requests``
    (:class:`AggRequest`, up to :data:`SEGMENT_AGG_MAX_REQUESTS`) and
    ``outputs`` (:class:`AggOutput`, up to :data:`SEGMENT_AGG_MAX_OUTPUTS`),
    the requests' weights reading at most :data:`SEGMENT_AGG_MAX_MASKS`
    distinct bool columns (:func:`segment_agg_mask_columns`); ``dest``, None or ``(key positions, luts, n_parts)``: the exchange
    destination of each slot from its gathered keys (each LUT None or the
    int64 value-key LUT of its dictionary).

    Returns ``(starts, group_exists, keys_out, outs, dest)``: each group's
    first row (int64 [out_cap], n past the last group), ``arange(out_cap) <
    num_groups``, the keys at ``min(starts, n - 1)`` with validity &
    group_exists, each output's (data, valid), and the destination (int32,
    ``n_parts`` past num_groups) or None. The slots past ``num_groups`` are
    inactive rows: their data and validity are left unspecified by the
    kernel, which writes zeros there. Float64 sums add in another order
    than the plain cumsum form (a digest's centroid sums too), but follow
    it past a value that is not finite: where ``out_cap > 1`` a group's sum
    is NaN wherever the plain cumsum difference is (``csrc/segment_agg.cu``
    gives the rule); every other value is bit-identical.
    On CUDA tensors the kernel is five launches (count, scan, reduce, span
    and finish; four without requests), eight with a ``match_last``
    request (a resolve pass writes each group's extreme, then a second
    reduce and span serve the match requests), and one more for each
    ``digest`` output, over tiles of
    :data:`SEGMENT_TILE_ROWS` rows and no memset; ``out_cap`` must hold
    every group. A division by a scalar there is a product with its
    reciprocal, as torch divides by a scalar on the card. ``phase_events``,
    a list, gets ``(phase, start, end)`` CUDA events of the count, scan,
    reduce, span, second round and finish passes (see ``group_sort``)."""
    name = "segment_agg"
    _check_vectors(name, (new_group, active), (torch.bool, torch.bool))
    n, dev = new_group.shape[0], new_group.device
    if n < 1 or out_cap < 1:
        raise ValueError(f"{name}: at least one row and one output slot")
    if not (isinstance(num_groups, torch.Tensor) and num_groups.dtype == torch.int64
            and num_groups.ndim == 0 and num_groups.device == dev):
        raise TypeError(f"{name}: num_groups must be a 0-d int64 tensor on {dev}")
    _check_group_keys(name, key_cols, n, dev)
    plans = _agg_plans(name, requests, outputs, active)
    if len(segment_agg_mask_columns(requests, active)) > SEGMENT_AGG_MAX_MASKS:
        raise ValueError(f"{name}: the requests' weights read at most "
                         f"{SEGMENT_AGG_MAX_MASKS} distinct bool columns, the activity among them")
    if dest is not None:
        positions, luts, n_parts = dest
        if (not 1 <= len(positions) <= _MAX_WIDE_KEYS or len(luts) != len(positions)
                or any(not 0 <= i < len(key_cols) for i in positions)):
            raise ValueError(f"{name}: destination keys are 1 to {_MAX_WIDE_KEYS} group keys, "
                             "one LUT slot each")
        if not 1 <= n_parts <= EPILOGUE_MAX_PARTS:
            raise ValueError(f"{name}: n_parts {n_parts} outside [1, {EPILOGUE_MAX_PARTS}]")
    if dev.type == "cpu":
        return segment_agg_plain(new_group, num_groups, out_cap, active, key_cols, requests,
                                 outputs, dest)
    rs, os_, outs = _agg_sets(requests, outputs, plans, out_cap, dev)
    ks = _GroupKeySet()
    ks.n = len(key_cols)
    keys_out = []
    for k, (d, v) in enumerate(key_cols):
        od, ov = torch.empty((out_cap,) + d.shape[1:], dtype=d.dtype, device=dev), torch.empty(
            out_cap, dtype=torch.bool, device=dev)
        keys_out.append((od, ov))
        col = ks.col[k]
        col.data, col.valid, col.type = d.data_ptr(), v.data_ptr(), _KEY_TYPES[d.dtype]
        ks.dst[k], ks.dst_valid[k] = od.data_ptr(), ov.data_ptr()
        ks.elem_bytes[k] = d.element_size() * (d.shape[1] if d.ndim == 2 else 1)
    dest_out = None
    if dest is not None:
        positions, luts, n_parts = dest
        for j, (i, lut) in enumerate(zip(positions, luts)):
            if key_cols[i][0].ndim != 1:
                raise ValueError(f"{name}: no exchange destination of a DECIMAL(p>18) key")
            if lut is not None:
                _check_vectors(name, (lut,), (torch.int64,))
                if lut.device != dev or lut.shape[0] < 1:
                    raise ValueError(f"{name}: LUT must be a non-empty tensor on {dev}")
                ks.col[i].lut, ks.col[i].lut_len = lut.data_ptr(), lut.shape[0]
            ks.dest_key[j] = i
        ks.n_dest, ks.n_parts = len(positions), n_parts
        dest_out = torch.empty(out_cap, dtype=torch.int32, device=dev)
    n_tiles = -(-n // SEGMENT_TILE_ROWS)
    scratch = torch.empty(2 * n_tiles + 1, dtype=torch.int64, device=dev)
    starts = torch.empty(out_cap + 1, dtype=torch.int64, device=dev)
    lib = _library()
    # each request's complete groups, tile partials and first non-finite
    # rows; with a match_last or tied request a row of extremes per request
    # after them
    words = lib.segment_agg_partial_words(
        len(requests), n, out_cap, int(any(r.kind in ("match_last", "tied") for r in requests)))
    partials = torch.empty(max(1, words), dtype=torch.int64, device=dev)
    group_exists = torch.empty(out_cap, dtype=torch.bool, device=dev)
    events = _phase_marks(phase_events,
                          ("count", "scan", "reduce", "span", "second round", "finish"))
    _check_launch(name, lib.segment_agg(
        ctypes.byref(rs), ctypes.byref(os_), ctypes.byref(ks), new_group.data_ptr(),
        active.data_ptr(), num_groups.data_ptr(), n, out_cap, scratch.data_ptr(),
        starts.data_ptr(), partials.data_ptr(), group_exists.data_ptr(),
        None if dest_out is None else dest_out.data_ptr(), events, _stream(new_group)))
    LAUNCHES[name] += 1
    return starts[:out_cap], group_exists, keys_out, outs, dest_out


# --------------------------------------------------------------------------- #
# group sort (replaces megakernels.group_sort_phase and expand_phase's sort
# stage) and the repartition epilogue (replaces megakernels.fused_epilogue)
# --------------------------------------------------------------------------- #

# kMaxWideKeys (csrc/join_keys.cuh), kMaxPermCols and kTileRows
# (csrc/radix_pass.cuh)
_MAX_WIDE_KEYS = 8
_MAX_PERM_COLS = 16
_TILE_ROWS = 2048
# rows of one tile of the group sort's one-sweep pass (kSweepRows)
SORT_TILE_ROWS = 4096
_DIGIT_BITS = 8
# the largest n_parts partition_epilogue takes (kMaxParts), and the most
# destinations (n_parts + 1) its one-sweep path takes (one eight-bit digit)
EPILOGUE_MAX_PARTS = 1024
EPILOGUE_SWEEP_BINS = 256
# composite field kinds (FieldKind in csrc/group_sort.cu)
_VALUE_FIELD, _VALID_FIELD, _INACTIVE_FIELD = 0, 1, 2


class _WideKeySet(ctypes.Structure):
    _fields_ = [("col", _KeyCol * _MAX_WIDE_KEYS), ("n", ctypes.c_int)]


class _GroupKeySet(ctypes.Structure):
    _fields_ = [
        ("col", _KeyCol * _MAX_WIDE_KEYS), ("dst", ctypes.c_void_p * _MAX_WIDE_KEYS),
        ("dst_valid", ctypes.c_void_p * _MAX_WIDE_KEYS),
        ("elem_bytes", ctypes.c_int * _MAX_WIDE_KEYS), ("n", ctypes.c_int),
        ("dest_key", ctypes.c_int * _MAX_WIDE_KEYS), ("n_dest", ctypes.c_int),
        ("n_parts", ctypes.c_int),
    ]


class _DestKeys(ctypes.Structure):
    _fields_ = [("col", _KeyCol * _MAX_WIDE_KEYS), ("build_side", ctypes.c_int * _MAX_WIDE_KEYS),
                ("n", ctypes.c_int), ("n_parts", ctypes.c_int)]


class _Field(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int), ("key", ctypes.c_int), ("offset", ctypes.c_int64),
        ("bits", ctypes.c_int), ("pos", ctypes.c_int),
    ]


class _Composite(ctypes.Structure):
    _fields_ = [
        ("field", _Field * (2 * _MAX_WIDE_KEYS + 1)), ("n_fields", ctypes.c_int),
        ("bits", ctypes.c_int),
    ]


class _DecodeCol(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p), ("dst", ctypes.c_void_p), ("dst_valid", ctypes.c_void_p),
        ("type", ctypes.c_int), ("value_pos", ctypes.c_int), ("value_bits", ctypes.c_int),
        ("offset", ctypes.c_int64), ("valid_mode", ctypes.c_int), ("valid_pos", ctypes.c_int),
    ]


class _DecodeSet(ctypes.Structure):
    _fields_ = [("col", _DecodeCol * _MAX_WIDE_KEYS), ("n", ctypes.c_int)]


# how a decoded key column's validity is read (ValidMode in csrc/group_sort.cu)
_VALID_BIT, _VALID_ACTIVE, _VALID_ALWAYS, _VALID_NEVER = 0, 1, 2, 3
# key storage a sorted composite decodes (integers and bool; floats are gathered)
_DECODED_TYPES = (torch.int64, torch.int32, torch.int16, torch.int8, torch.bool)


class _PermCol(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p), ("src_valid", ctypes.c_void_p),
        ("dst", ctypes.c_void_p), ("dst_valid", ctypes.c_void_p),
        ("elem_bytes", ctypes.c_int),
    ]


class _PermGatherSet(ctypes.Structure):
    _fields_ = [("col", _PermCol * _MAX_PERM_COLS), ("n", ctypes.c_int)]


def _check_page_cols(name: str, cols, n: int, dev) -> None:
    """(data, valid) columns of n rows on ``dev``: 1-D data of 1 to 8 byte
    elements (a caller passes a long decimal's two int64 limbs as two
    columns) and bool validity, both contiguous."""
    for d, v in cols:
        if d.ndim != 1:
            raise ValueError(f"{name}: {d.ndim}-D (int128) columns are not supported")
        if d.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"{name}: {d.element_size()}-byte elements are not supported")
        _check_vectors(name, (d, v), (d.dtype, torch.bool))
        if d.shape[0] != n or d.device != dev:
            raise ValueError(f"{name}: columns must be {n} rows on {dev}")


def _like(cols):
    """New buffers like (data, valid or None) columns."""
    return [(torch.empty_like(d), None if v is None else torch.empty_like(v)) for d, v in cols]


def _perm_gather_sets(cols, outs):
    """PermGatherSets from (data, valid or None) columns into ``outs``:
    returns (sets, n_sets)."""
    n_sets = -(-len(cols) // _MAX_PERM_COLS)
    sets = (_PermGatherSet * max(1, n_sets))()
    for i, ((d, v), (od, ov)) in enumerate(zip(cols, outs)):
        g = sets[i // _MAX_PERM_COLS]
        pc = g.col[g.n]
        pc.src, pc.dst, pc.elem_bytes = d.data_ptr(), od.data_ptr(), d.element_size()
        if v is not None:
            pc.src_valid, pc.dst_valid = v.data_ptr(), ov.data_ptr()
        g.n += 1
    return sets, n_sets


def group_sort_plain(key_cols, payload_cols, active: torch.Tensor):
    """The reference's ``_group_sort_impl`` on tensors: stable passes least
    significant first (each key from the last: its normalized value with
    NULL as INT64_MAX, then its validity, NULL first; then ~active, so
    inactive rows go last) through ``kernels.cosort``, and the group
    boundaries."""
    pass_keys: List[torch.Tensor] = []
    for d, v in reversed(list(key_cols)):
        pass_keys.append(torch.where(v, K.order_key(d), K.INT64_MAX))
        pass_keys.append(v.to(torch.int8))
    pass_keys.append((~active).to(torch.int8))
    payloads: List[torch.Tensor] = []
    for d, v in payload_cols:
        payloads.extend((d, v))
    payloads.append(active)
    sorted_keys, sorted_payloads = K.cosort(pass_keys, payloads)
    active_s = sorted_payloads[-1]
    diff = torch.zeros_like(active_s)
    for k in sorted_keys[:-1]:
        diff = diff | (k != torch.roll(k, 1))
    first = torch.zeros_like(active_s)
    first[0] = True
    prev_active = torch.roll(active_s, 1)
    prev_active[0] = False
    new_group = active_s & (first | diff | ~prev_active)
    out = [(sorted_payloads[2 * i], sorted_payloads[2 * i + 1]) for i in range(len(payload_cols))]
    return out, active_s, new_group, new_group.sum()


def group_sort_stats_plain(key_cols, active: torch.Tensor) -> List[int]:
    """The group sort's stats reduction on tensors: per key the least and
    largest normalized value over its valid rows (INT64_MAX and INT64_MIN
    where it has none), its valid-row count and the rows where its
    validity differs from the activity; then the active-row count."""
    lo, hi, nv, differ = [], [], [], []
    for d, v in key_cols:
        k = K.order_key(d)[v]
        lo.append(int(k.min()) if k.numel() else int(K.INT64_MAX))
        hi.append(int(k.max()) if k.numel() else -int(K.INT64_MAX) - 1)
        nv.append(int(v.sum()))
        differ.append(int((v != active).sum()))
    return lo + hi + nv + differ + [int(active.sum())]


def radix_plan(stats: Sequence[int], n: int):
    """The group sort's composite keys from its stats (as
    :func:`group_sort_stats_plain` gives them): fields least significant
    first, each ``(kind, key, offset, bits, pos)``, packed greedily into
    composites of at most 64 bits. A key's value field is ``value - min``
    in ``bit_length(max - min)`` bits (0 on NULL rows), its validity field
    one bit; a field that is the same on every row is left out, since a
    stable pass over equal digits changes nothing, and so is a validity
    that equals the activity on every row: the inactive field, more
    significant than every validity field, already orders those rows."""
    nk = (len(stats) - 1) // 4
    lo, hi = stats[:nk], stats[nk:2 * nk]
    n_valid, differ, n_active = stats[2 * nk:3 * nk], stats[3 * nk:4 * nk], stats[-1]
    fields = []
    for k in reversed(range(nk)):
        if n_valid[k] and hi[k] > lo[k]:
            fields.append((_VALUE_FIELD, k, lo[k], (hi[k] - lo[k]).bit_length()))
        if 0 < n_valid[k] < n and differ[k]:
            fields.append((_VALID_FIELD, k, 0, 1))
    if 0 < n_active < n:
        fields.append((_INACTIVE_FIELD, 0, 0, 1))
    comps, cur, used = [], [], 0
    for kind, key, offset, bits in fields:
        if used + bits > 64:
            comps.append(cur)
            cur, used = [], 0
        cur.append((kind, key, offset, bits, used))
        used += bits
    if cur:
        comps.append(cur)
    return comps


def _decode_plan(key_cols, payload_cols, stats, plan):
    """The carried columns ``group_sort_finish`` writes from a one-composite
    plan's sorted composite: each integer or bool group key carried as it
    is, as ``{payload index: (key, value_pos, value_bits, offset,
    valid_mode, valid_pos)}``, at most as many as a DecodeSet holds."""
    if len(plan) != 1:
        return {}
    nk = len(key_cols)
    lo, n_valid, n = stats[:nk], stats[2 * nk:3 * nk], key_cols[0][0].shape[0]
    fields = {(kind, key): (pos, bits, offset) for kind, key, offset, bits, pos in plan[0]}
    out = {}
    for j, (d, v) in enumerate(payload_cols):
        for k, (kd, kv) in enumerate(key_cols):
            if (len(out) < _MAX_WIDE_KEYS and d.dtype in _DECODED_TYPES and d.dtype == kd.dtype
                    and d.data_ptr() == kd.data_ptr() and v.data_ptr() == kv.data_ptr()):
                pos, bits, offset = fields.get((_VALUE_FIELD, k),
                                               (0, 0, lo[k] if n_valid[k] else 0))
                if (_VALID_FIELD, k) in fields:
                    mode, vpos = _VALID_BIT, fields[(_VALID_FIELD, k)][0]
                else:
                    mode = (_VALID_ALWAYS if n_valid[k] == n else
                            _VALID_NEVER if n_valid[k] == 0 else _VALID_ACTIVE)
                    vpos = 0
                out[j] = (k, pos, bits, offset, mode, vpos)
                break
    return out


# the kernels whose C entry points count their stream operations
_STREAM_OPS = ("hash_probe", "group_sort", "segment_agg", "partition_epilogue",
               "partition_dest", "expr_program", "presorted_group", "segment_agg_direct",
               "segment_sort", "hll")


def stream_ops(name: str) -> int:
    """Kernel launches and memsets that ``name``'s kernels (one of
    ``hash_probe``, ``group_sort``, ``segment_agg``, ``partition_epilogue``,
    ``partition_dest``, ``expr_program``, ``presorted_group``,
    ``segment_agg_direct``, ``segment_sort`` and ``hll``) have issued since
    the library was loaded."""
    return int(getattr(_library(), f"{name}_stream_ops")())


def group_sort(key_cols, payload_cols, active: torch.Tensor, *, phase_events=None):
    """Stable co-sort of a page by its group keys, and its group boundaries.

    ``key_cols``: (data, valid) of each group key, most significant first (1
    to 8; integer, bool or float storage); ``payload_cols``: (data, valid)
    of every column to carry; ``active`` bool. Returns ``(payload_out,
    active_out, new_group, num_groups)``: the columns in sorted order
    (within a key NULL rows first, inactive rows last, ties in row order),
    ``new_group`` set on the first active row of each group, and the group
    count as a 0-d int64. On CUDA tensors one host read of the keys'
    ranges sizes the passes (:func:`radix_plan`). ``phase_events``, None
    or a list, gets one ``(phase, start, end)`` pair of recorded CUDA
    events for each of ``"stats"`` (the range reduction and its host
    read), ``"compose"``, ``"passes"`` and ``"finish"`` (group boundaries
    and the gathers), to split the kernel's time."""
    _check_vectors("group_sort", (active,), (torch.bool,))
    n, dev = active.shape[0], active.device
    if not 1 <= len(key_cols) <= _MAX_WIDE_KEYS:
        raise ValueError(f"group_sort: 1 to {_MAX_WIDE_KEYS} key columns")
    if not 1 <= n < 2**31:
        raise ValueError("group_sort: 1 to 2^31 - 1 rows (int32 row indices)")
    _check_page_cols("group_sort", key_cols, n, dev)
    _check_page_cols("group_sort", payload_cols, n, dev)
    for d, _ in key_cols:
        if d.dtype not in _KEY_TYPES:
            raise TypeError(f"group_sort: unsupported key column {d.dtype}")
    if dev.type == "cpu":
        return group_sort_plain(key_cols, payload_cols, active)
    lib = _library()
    stream = _stream(active)
    marks = []

    def mark(phase=None):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        if phase is not None:
            phase_events.append((phase, marks[-2], marks[-1]))

    ks = _key_set("group_sort", key_cols, (None,) * len(key_cols), n, _WideKeySet)
    stats = torch.empty(4 * len(key_cols) + 1, dtype=torch.int64, device=dev)
    num_groups = torch.empty((), dtype=torch.int64, device=dev)
    if phase_events is not None:
        mark()
    _check_launch("group_sort", lib.group_sort_stats(
        ctypes.byref(ks), active.data_ptr(), n, stats.data_ptr(), num_groups.data_ptr(),
        stream))
    # the passes' buffers are allocated while the stats run (for one
    # composite, the usual plan), the outputs while the passes run
    alt_keys = torch.empty(n, dtype=torch.int64, device=dev)
    idx = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    comp_keys = torch.empty(n, dtype=torch.int64, device=dev)
    scratch = torch.empty(lib.group_sort_scratch_words(n, 64 // _DIGIT_BITS),
                          dtype=torch.int64, device=dev)
    stats = stats.tolist()
    plan = radix_plan(stats, n)
    if phase_events is not None:
        mark("stats")
    comps = (_Composite * max(1, len(plan)))()
    inactive_pos = -1
    for c, fields in zip(comps, plan):
        for f, (kind, key, offset, bits, pos) in zip(c.field, fields):
            f.kind, f.key, f.offset, f.bits, f.pos = kind, key, offset, bits, pos
            if kind == _INACTIVE_FIELD:
                inactive_pos = pos
        c.n_fields = len(fields)
        c.bits = sum(f[3] for f in fields)
    words = lib.group_sort_scratch_words(
        n, sum(-(-c.bits // _DIGIT_BITS) for c in comps[:len(plan)]))
    if len(plan) > 1:
        comp_keys = torch.empty(len(plan) * n, dtype=torch.int64, device=dev)
        scratch = torch.empty(words, dtype=torch.int64, device=dev)
    _check_launch("group_sort", lib.group_sort_compose(
        ctypes.byref(ks), active.data_ptr(), n, comps, len(plan), comp_keys.data_ptr(),
        scratch.data_ptr(), words, stream))
    if phase_events is not None:
        mark("compose")
    result = (ctypes.c_void_p * 2)()
    _check_launch("group_sort", lib.group_sort_passes(
        comps, len(plan), n, comp_keys.data_ptr(), alt_keys.data_ptr(), idx[0].data_ptr(),
        idx[1].data_ptr(), scratch.data_ptr(), result, stream))
    if phase_events is not None:
        mark("passes")
    outs = _like(payload_cols)
    active_out = torch.empty(n, dtype=torch.bool, device=dev)
    new_group = torch.empty(n, dtype=torch.bool, device=dev)
    decode = _decode_plan(key_cols, payload_cols, stats, plan)
    ds = _DecodeSet()
    for j, (k, pos, bits, offset, mode, vpos) in decode.items():
        dc = ds.col[ds.n]
        (d, _), (od, ov) = payload_cols[j], outs[j]
        dc.src, dc.dst, dc.dst_valid = d.data_ptr(), od.data_ptr(), ov.data_ptr()
        dc.type, dc.value_pos, dc.value_bits, dc.offset = _KEY_TYPES[d.dtype], pos, bits, offset
        dc.valid_mode, dc.valid_pos = mode, vpos
        ds.n += 1
    sets, n_sets = _perm_gather_sets(
        [(d, v) for j, (d, v) in enumerate(payload_cols) if j not in decode],
        [o for j, o in enumerate(outs) if j not in decode])
    _check_launch("group_sort", lib.group_sort_finish(
        ctypes.byref(ks), active.data_ptr(), n, len(plan), result[0], result[1], inactive_pos,
        int(stats[-1] == n), ctypes.byref(ds), sets, n_sets, active_out.data_ptr(),
        new_group.data_ptr(), num_groups.data_ptr(), stream))
    if phase_events is not None:
        mark("finish")
    LAUNCHES["group_sort"] += 1
    return outs, active_out, new_group, num_groups


# --------------------------------------------------------------------------- #
# the re-sorting aggregates (the cosorts and the HyperLogLog registers of
# executor._aggregate_impl inside megakernels.aggregate_phase): segment_sort
# and hll
# --------------------------------------------------------------------------- #

# the most bool columns whose AND is a row's weight (kMaxWeights in
# csrc/segment_rows.cuh); segment_sort's rows one block sorts at once (kCap),
# rows a block of a large segment's passes takes (kChunk), stats words
# (kStatWords) and its Item and Entry records' bytes (csrc/segment_sort.cu)
SEGMENT_SORT_MAX_WEIGHTS = 6
SEGMENT_SORT_BATCH_ROWS = 4096
SEGMENT_SORT_CHUNK_ROWS = 4096
_SORT_STAT_WORDS = 19
_SORT_ITEM_WORDS = 3
_SORT_ENTRY_WORDS = 2
_SORT_ANY_SMALL = 6
_SORT_LIST_WORD = 8


class _WeightSet(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p * SEGMENT_SORT_MAX_WEIGHTS), ("n", ctypes.c_int)]


def _weight_set(name: str, weights, n: int, dev) -> _WeightSet:
    if not 1 <= len(weights) <= SEGMENT_SORT_MAX_WEIGHTS:
        raise ValueError(f"{name}: 1 to {SEGMENT_SORT_MAX_WEIGHTS} weight columns")
    for w in weights:
        _check_request_col(name, w, (torch.bool,), n, dev)
    ws = _WeightSet()
    ws.n = len(weights)
    for k, w in enumerate(weights):
        ws.w[k] = w.data_ptr()
    return ws


def _weight_of(weights) -> torch.Tensor:
    w = weights[0]
    for t in weights[1:]:
        w = w & t
    return w


def _check_segment_rows(name: str, new_group, values, weights):
    _check_vectors(name, (new_group,), (torch.bool,))
    n, dev = new_group.shape[0], new_group.device
    if not 1 <= n < 2**31:
        raise ValueError(f"{name}: 1 to 2^31 - 1 rows (int32 row indices)")
    if values is None:
        raise ValueError(f"{name}: needs its values")
    _check_request_col(name, values, _KEY_TYPES, n, dev)
    return n, dev, _weight_set(name, weights, n, dev)


def segment_sort_plain(new_group, values, weights, participants_first: bool = False):
    """:func:`kernels.segment_sort_plain` with the weight the AND of
    ``weights``."""
    return K.segment_sort_plain(new_group, values, _weight_of(weights), participants_first)


def segment_sort_plan(stats: Sequence[int], n: int, participants_first: bool) -> dict:
    """segment_sort's key and work sizes from its stats (the least and
    largest order key, the weighted rows, and the large segments' rows and
    level-0 items): ``vb`` the bits of ``v = order key - least``, ``wb`` 1
    where the weight sorts (participants first, neither all nor no rows
    weighted), ``levels`` the MSD levels of eight-bit digits of (w, v), and
    the large path's most items a level, chunks a level and batches."""
    lo, hi, n_weighted, large_rows, items0 = stats
    vb = (hi - lo).bit_length() if hi > lo else 0
    wb = 1 if participants_first and 0 < n_weighted < n else 0
    levels = max(1, -(-(vb + wb) // 8))
    items = n // (SEGMENT_SORT_BATCH_ROWS + 1) + 1
    return dict(vb=vb, wb=wb, levels=levels, items=max(items, items0),
                chunks=large_rows // SEGMENT_SORT_CHUNK_ROWS + items + 1,
                entries=levels * (5 * (large_rows // SEGMENT_SORT_BATCH_ROWS) + 5 + items) + 64)


def segment_sort(new_group, values, weights, participants_first: bool = False):
    """Re-sorts a group-sorted page's rows by value within each group.

    ``new_group`` (bool, set on each group's first row; the group of a row
    is ``max(cumsum(new_group) - 1, 0)``), ``values`` (1-D, integer, bool
    or float storage) and ``weights`` (1 to :data:`SEGMENT_SORT_MAX_WEIGHTS`
    bool columns whose AND is a row's weight). Returns ``(values, weight,
    heads)`` in the order of the stable sort by ``(group, [~weight],
    order_key(value))``, the weight key only with ``participants_first``,
    and the run heads (the first row of each (group, order key) run): see
    :func:`kernels.segment_sort_plain`. On CUDA tensors each group's rows
    are sorted in place of the page (``csrc/segment_sort.cu``): six
    launches of stats and segment starts, one host read of the stats
    (:func:`segment_sort_plan`), one launch for the segments of at most
    :data:`SEGMENT_SORT_BATCH_ROWS` rows where there are any, and where
    there are larger ones, three launches an MSD level, the batches and the
    heads at their edges."""
    name = "segment_sort"
    n, dev, ws = _check_segment_rows(name, new_group, values, weights)
    if dev.type == "cpu":
        return segment_sort_plain(new_group, values, weights, participants_first)
    lib = _library()
    stream = _stream(new_group)
    vtype = _KEY_TYPES[values.dtype]
    scratch = torch.empty(lib.tile_scratch_words(n), dtype=torch.int64, device=dev)
    stats = torch.empty(_SORT_STAT_WORDS, dtype=torch.int64, device=dev)
    seg_start = torch.empty(n + 1, dtype=torch.int32, device=dev)
    cap_items = n // (SEGMENT_SORT_BATCH_ROWS + 1) + 1
    items0 = torch.empty(cap_items * _SORT_ITEM_WORDS, dtype=torch.int64, device=dev)
    _check_launch(name, lib.segment_sort_stats(
        new_group.data_ptr(), values.data_ptr(), vtype, ctypes.byref(ws), n, scratch.data_ptr(),
        stats.data_ptr(), seg_start.data_ptr(), items0.data_ptr(), stream))
    # the outputs are allocated while the stats run
    out_values = torch.empty_like(values)
    out_weight = torch.empty(n, dtype=torch.bool, device=dev)
    heads = torch.empty(n, dtype=torch.bool, device=dev)
    st = stats.tolist()
    word = st[_SORT_LIST_WORD]
    items0_n, chunks0 = word >> 40, word & ((1 << 40) - 1)
    plan = segment_sort_plan((st[0], st[1], st[2], st[4], items0_n), n, participants_first)
    if st[_SORT_ANY_SMALL]:
        _check_launch(name, lib.segment_sort_small(
            new_group.data_ptr(), values.data_ptr(), vtype, values.element_size(),
            ctypes.byref(ws), n, scratch.data_ptr(), stats.data_ptr(), seg_start.data_ptr(),
            plan["vb"], plan["wb"], out_values.data_ptr(), out_weight.data_ptr(),
            heads.data_ptr(), stream))
    if items0_n > 0:
        vdt = torch.int64 if plan["vb"] > 32 else torch.int32
        bufs = [torch.empty(n, dtype=dt, device=dev) for dt in (vdt, torch.uint8) * 2]
        items1 = torch.empty_like(items0)
        hist = torch.empty(plan["chunks"] * 256, dtype=torch.int32, device=dev)
        eq_key = torch.empty(plan["chunks"] * 256, dtype=torch.int64, device=dev)
        eq_flag = torch.empty(plan["chunks"] * 8, dtype=torch.int32, device=dev)
        entries = torch.empty(plan["entries"] * _SORT_ENTRY_WORDS, dtype=torch.int64, device=dev)
        _check_launch(name, lib.segment_sort_large(
            values.data_ptr(), vtype, values.element_size(), ctypes.byref(ws), st[0],
            plan["vb"], plan["wb"], stats.data_ptr(), items0.data_ptr(), items1.data_ptr(),
            items0_n, chunks0, *(b.data_ptr() for b in bufs), hist.data_ptr(),
            eq_key.data_ptr(), eq_flag.data_ptr(), entries.data_ptr(), out_values.data_ptr(),
            out_weight.data_ptr(), heads.data_ptr(), stream))
    LAUNCHES[name] += 1
    return out_values, out_weight, heads


def hll_plain(new_group, out_cap: int, values, weights):
    """The reference's ``hll_registers`` then ``hll_estimate`` over each
    row's group ``max(cumsum(new_group) - 1, 0)`` and the weight the AND of
    ``weights`` (:func:`kernels.hll_estimate`'s order of adds)."""
    gid = (K.cumsum(new_group) - 1).clamp(min=0)
    return (K.hll_estimate(K.hll_registers(values, _weight_of(weights), gid, out_cap)),
            torch.ones(out_cap, dtype=torch.bool, device=new_group.device))


def hll_plan(n: int, sms: int, blocks_per_sm: int) -> Tuple[int, int]:
    """(tiles_per_range, grid) of hll's register pass over n rows: the
    page's tiles of :data:`SEGMENT_TILE_ROWS` rows cut into as many
    contiguous ranges as the card holds blocks at once (``sms`` times
    ``blocks_per_sm``), block b taking tiles ``[b * tiles_per_range, (b +
    1) * tiles_per_range)``."""
    n_tiles = -(-n // SEGMENT_TILE_ROWS)
    per = -(-n_tiles // max(sms * blocks_per_sm, 1))
    return per, -(-n_tiles // per)


_HLL_OCCUPANCY: List[int] = []  # the register pass's blocks an SM, read once


def hll(new_group, out_cap: int, values, weights):
    """``approx_distinct``'s HyperLogLog estimate of each group of a
    group-sorted page, as ``(data, valid)``: int64 [out_cap] and bool
    [out_cap], valid everywhere (an empty group estimates 0), from
    ``new_group``, ``values`` and ``weights`` as :func:`segment_sort` takes
    them; ``out_cap`` must hold every group.
    Bit-identical to :func:`hll_plain`. On CUDA tensors six launches: the
    tiles' head counts and their two-pass scan, a pass that classes each
    slot (zeroing the registers, int32 [out_cap, 2048], of the groups that
    need them), the registers (a resident grid, each block a range of tiles
    with its current group's registers in shared memory: :func:`hll_plan`)
    and the estimates of the groups whose registers went to device
    memory."""
    name = "hll"
    n, dev, ws = _check_segment_rows(name, new_group, values, weights)
    if out_cap < 1:
        raise ValueError(f"{name}: at least one output slot")
    if dev.type == "cpu":
        return hll_plain(new_group, out_cap, values, weights)
    lib = _library()
    if not _HLL_OCCUPANCY:
        _HLL_OCCUPANCY.append(lib.hll_blocks_per_sm())
    per, _ = hll_plan(n, torch.cuda.get_device_properties(dev).multi_processor_count,
                      _HLL_OCCUPANCY[0])
    m = 1 << K.HLL_BITS
    alpha = 0.7213 / (1.0 + 1.079 / m)
    regs = torch.empty(out_cap * m, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.tile_scratch_words(n), dtype=torch.int64, device=dev)
    flags = torch.empty(out_cap, dtype=torch.uint8, device=dev)
    out = torch.empty(out_cap, dtype=torch.int64, device=dev)
    valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
    _check_launch(name, lib.hll(
        new_group.data_ptr(), values.data_ptr(), _KEY_TYPES[values.dtype], ctypes.byref(ws), n,
        out_cap, ctypes.c_float(alpha * m * m), per, regs.data_ptr(), scratch.data_ptr(),
        flags.data_ptr(), out.data_ptr(), valid.data_ptr(), _stream(new_group)))
    LAUNCHES[name] += 1
    return out, valid


def partition_dest_plain(key_cols, luts, active: torch.Tensor, n_parts: int) -> torch.Tensor:
    """The reference's ``_partition_dest`` on tensors (``ops/repartition.py``):
    dictionary keys through their value-key LUT, the partition hash, and
    ``n_parts`` for inactive rows, as int32."""
    from . import repartition as R

    keys = [(R.map_value_keys(d, lut), v) for (d, v), lut in zip(key_cols, luts)]
    return R.dest_of(keys, active, n_parts)


def _check_partition_keys(name: str, key_cols, luts, active, n_parts: int) -> None:
    _check_vectors(name, (active,), (torch.bool,))
    n, dev = active.shape[0], active.device
    if not 1 <= n_parts <= EPILOGUE_MAX_PARTS:
        raise ValueError(f"{name}: n_parts {n_parts} outside [1, {EPILOGUE_MAX_PARTS}]")
    if len(key_cols) > _MAX_WIDE_KEYS or len(luts) != len(key_cols):
        raise ValueError(f"{name}: 0 to {_MAX_WIDE_KEYS} keys, one LUT slot each")
    if not 1 <= n < 2**31:
        raise ValueError(f"{name}: 1 to 2^31 - 1 rows (int32 row indices)")
    _check_page_cols(name, key_cols, n, dev)
    for d, _ in key_cols:
        if d.dtype not in _KEY_TYPES:
            raise TypeError(f"{name}: unsupported key column {d.dtype}")


def partition_dest(key_cols, luts, active: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Each row's exchange destination: the exchange stage of the fused join
    and aggregation (the reference's ``epi_spec``).

    ``key_cols``: (data, valid) of each partition key (0 to 8; no key sends
    every row to the partition of one zero key); ``luts``: per key None or
    the int64 value-key LUT of its dictionary; ``n_parts`` 1 to
    :data:`EPILOGUE_MAX_PARTS`. Returns int32 ``[n]``: the partition of each
    active row, ``n_parts`` for an inactive one. :func:`partition_epilogue`
    takes it as its ``dest``."""
    _check_partition_keys("partition_dest", key_cols, luts, active, n_parts)
    n, dev = active.shape[0], active.device
    if dev.type == "cpu":
        return partition_dest_plain(key_cols, luts, active, n_parts)
    ks = _key_set("partition_dest", key_cols, luts, n, _WideKeySet)
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    _check_launch("partition_dest", _library().partition_dest(
        ctypes.byref(ks), active.data_ptr(), n, n_parts, dest.data_ptr(), _stream(active)))
    LAUNCHES["partition_dest"] += 1
    return dest


def partition_epilogue_plain(key_cols, luts, cols, active: torch.Tensor, n_parts: int,
                             dest=None):
    """The reference's ``_repartition_epilogue`` on tensors
    (``ops/repartition.py``): dictionary keys through their value-key LUT,
    the partition hash, inactive rows to ``n_parts`` (or the given
    ``dest``), then the stable sort by destination with offsets and
    counts."""
    from . import repartition as R

    if dest is None:
        dest = partition_dest_plain(key_cols, luts, active, n_parts)
    return R.sort_by_dest(dest, cols, active, n_parts)


def partition_epilogue(key_cols, luts, cols, active: torch.Tensor, n_parts: int, dest=None, *,
                       phase_events=None):
    """The repartition epilogue: rows to partitions, sorted stably by
    partition.

    ``key_cols``: (data, valid) of each partition key (0 to 8; no key sends
    every row to the partition of one zero key); ``luts``: per key None or
    the int64 value-key LUT of its dictionary; ``cols``: (data, valid) of
    every column; ``n_parts`` 1 to :data:`EPILOGUE_MAX_PARTS`. Returns
    ``(cols_out, active_out, offsets, counts)``: partition p's rows are
    ``[offsets[p], offsets[p] + counts[p])`` in their original order
    (int64 offsets and counts), inactive rows after the last.

    On CUDA tensors, while the n_parts + 1 destinations fit
    :data:`EPILOGUE_SWEEP_BINS`, the kernel is a count launch (destinations
    and per-tile counts), a scan of the counts and one sweep that writes
    every column in place (phases ``"count"``, the first two, and
    ``"sweep"``); past that, a destination pass, a three-launch counting
    pass and a gather (``"hash"``, ``"passes"``, ``"gather"``).
    ``phase_events``, None or a list, gets one ``(phase, start, end)`` pair
    of recorded CUDA events for each phase.

    ``dest``, None or each row's destination as :func:`partition_dest`
    gives it (int32 ``[n]``), replaces the hash: the count (or past 255
    partitions the pass) reads it, and ``"count"`` (``"hash"``) then spans
    no destination pass. The output is the hashed run's."""
    _check_partition_keys("partition_epilogue", key_cols, luts, active, n_parts)
    n, dev = active.shape[0], active.device
    _check_page_cols("partition_epilogue", cols, n, dev)
    if dest is not None:
        _check_vectors("partition_epilogue", (dest, active), (torch.int32, torch.bool))
    if dev.type == "cpu":
        return partition_epilogue_plain(key_cols, luts, cols, active, n_parts, dest)
    ks = _key_set("partition_epilogue", key_cols, luts, n, _WideKeySet)
    nb = n_parts + 1
    hist = torch.empty(nb * -(-n // _TILE_ROWS), dtype=torch.int32, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    offsets = torch.empty(nb, dtype=torch.int64, device=dev)
    counts = torch.empty(nb, dtype=torch.int64, device=dev)
    gathered = list(cols) + [(active, None)]
    outs = _like(gathered)
    sets, n_sets = _perm_gather_sets(gathered, outs)
    sweep = nb <= EPILOGUE_SWEEP_BINS
    given = dest
    dest = torch.empty(n if sweep or given is None else 1,
                       dtype=torch.uint8 if sweep else torch.int32, device=dev)
    # the sweep writes a permutation only for the gather sets after the first
    idx = torch.empty(n, dtype=torch.int32, device=dev) if not sweep or n_sets > 1 else None
    events = _phase_marks(phase_events,
                          ("count", "sweep") if sweep else ("hash", "passes", "gather"))
    rc = _library().partition_epilogue(
        ctypes.byref(ks), active.data_ptr(), None if given is None else given.data_ptr(), n,
        n_parts, dest.data_ptr(),
        None if idx is None else idx.data_ptr(), hist.data_ptr(), totals.data_ptr(),
        offsets.data_ptr(), counts.data_ptr(), sets, n_sets, events, _stream(active),
    )
    _check_launch("partition_epilogue", rc)
    LAUNCHES["partition_epilogue"] += 1
    return outs[:-1], outs[-1][0], offsets[:n_parts], counts[:n_parts]


# --------------------------------------------------------------------------- #
# the fused stages of expand_phase after the join (replace the projection,
# the presorted grouping and the direct aggregation of
# megakernels._expand_phase_body): expr_program, presorted_group and
# segment_agg_direct
# --------------------------------------------------------------------------- #

# the presorted grouping's tile, its scan state's counters ahead of the tile
# status words, the keys one launch takes, the epochs a status word tells
# apart and the most rows (kTileRows, kStateHead, kMaxPresortKeys,
# kEpochMask, kValueMask in csrc/presorted_group.cu)
PRESORTED_TILE_ROWS = 2048
_PRESORTED_STATE_HEAD = 4
PRESORTED_MAX_KEYS = 8
_PRESORTED_MAX_EPOCH = (1 << 22) - 1
_PRESORTED_MAX_ROWS = (1 << 40) - 1
# the tiles a new state buffer holds at least (134,217,728 rows)
_PRESORTED_MIN_TILES = 65536


class _PresortKey(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p), ("type", ctypes.c_int64)]


class _PresortState:
    """A stream's scan state for ``presorted_group``: the buffer (counters,
    then a status word a tile; zeroed when it is made) and the epoch of its
    last launch."""

    def __init__(self, tiles: int, dev):
        self.buf = torch.zeros(_PRESORTED_STATE_HEAD + tiles, dtype=torch.int64, device=dev)
        self.tiles = tiles
        self.epoch = 0


_PRESORTED_STATES: Dict[tuple, _PresortState] = {}
_PRESORTED_LOCK = threading.Lock()


def presorted_launches(n_keys: int) -> int:
    """The launches of one ``presorted_group`` call on ``n_keys`` keys: one,
    and one more for each :data:`PRESORTED_MAX_KEYS` - 1 keys past
    :data:`PRESORTED_MAX_KEYS`."""
    extra = max(0, n_keys - PRESORTED_MAX_KEYS)
    return 1 + -(-extra // (PRESORTED_MAX_KEYS - 1))


def _presorted_state(dev, stream: int, tiles: int, launches: int):
    """The state buffer of ``stream`` on ``dev`` and the first of the
    ``launches`` epochs the call takes: a new zeroed buffer where the
    stream has none, holds fewer than ``tiles`` tiles, or would reuse an
    epoch (a status word then cannot tell an earlier launch's from its own)."""
    key = (dev.index, stream)
    with _PRESORTED_LOCK:
        st = _PRESORTED_STATES.get(key)
        if st is None or st.tiles < tiles or st.epoch + launches > _PRESORTED_MAX_EPOCH:
            st = _PresortState(max(tiles, _PRESORTED_MIN_TILES), dev)
            _PRESORTED_STATES[key] = st
        first = st.epoch + 1
        st.epoch += launches
        return st.buf, first


def presorted_group_plain(key_cols, active: torch.Tensor):
    """The reference's ``_presorted_group_impl`` grouping on tensors: each
    key as ``kernels.order_key`` (INT64_MAX where NULL) against the last
    active row before it (``kernels.last_active_prev``)."""
    d0, v0 = key_cols[0]
    k1 = torch.where(v0, K.order_key(d0), K.INT64_MAX)
    prev_k1, has_prev = K.last_active_prev(k1, active)
    new_group = active & (~has_prev | (k1 != prev_k1))
    violation = (active & has_prev & (k1 < prev_k1)).any()
    for d, v in key_cols[1:]:
        kn = torch.where(v, K.order_key(d), K.INT64_MAX)
        prev_k, _ = K.last_active_prev(kn, active)
        violation = violation | (active & has_prev & ~new_group & (kn != prev_k)).any()
    return new_group, new_group.sum(), violation


def presorted_group(key_cols, active: torch.Tensor):
    """Group boundaries of a page ordered on its first group key, rows in
    place (inactive rows may be interleaved).

    ``key_cols``: (data, valid) of each group key, any number (integer,
    bool or float storage, 1-D); ``active`` bool. Returns ``(new_group,
    num_groups, violation)``: bool ``[n]`` set on each group's first active
    row, the group count as a 0-d int64 and a 0-d bool set where the first
    key decreases or a later key changes inside a run of the first; all on
    the device, with no host read. On CUDA tensors: one launch over tiles of
    :data:`PRESORTED_TILE_ROWS` rows with the key set passed by value, and
    no memset (:func:`presorted_launches` past :data:`PRESORTED_MAX_KEYS`
    keys); the scan state is the current stream's own buffer, made zeroed
    at the stream's first call (or a larger call, or once in 2^22 - 1
    launches), its status words told apart by an epoch a launch."""
    name = "presorted_group"
    _check_vectors(name, (active,), (torch.bool,))
    n, dev = active.shape[0], active.device
    if not key_cols or n < 1:
        raise ValueError(f"{name}: at least one key and one row")
    _check_page_cols(name, key_cols, n, dev)
    for d, _ in key_cols:
        if d.dtype not in _KEY_TYPES:
            raise TypeError(f"{name}: unsupported key column {d.dtype}")
    if dev.type == "cpu":
        return presorted_group_plain(key_cols, active)
    if n > _PRESORTED_MAX_ROWS:
        raise ValueError(f"{name}: at most {_PRESORTED_MAX_ROWS} rows")
    keys = (_PresortKey * len(key_cols))()
    for k, (d, v) in enumerate(key_cols):
        keys[k].data, keys[k].valid, keys[k].type = d.data_ptr(), v.data_ptr(), _KEY_TYPES[d.dtype]
    stream = _stream(active)
    state, epoch = _presorted_state(dev, stream, -(-n // PRESORTED_TILE_ROWS),
                                    presorted_launches(len(key_cols)))
    new_group = torch.empty(n, dtype=torch.bool, device=dev)
    num_groups = torch.empty((), dtype=torch.int64, device=dev)
    violation = torch.empty((), dtype=torch.bool, device=dev)
    _check_launch(name, _library().presorted_group(
        keys, len(key_cols), active.data_ptr(), n, state.data_ptr(), epoch,
        new_group.data_ptr(), num_groups.data_ptr(), violation.data_ptr(), stream))
    LAUNCHES[name] += 1
    return new_group, num_groups, violation


# the most groups and keys of the direct aggregation (kMaxDirectGroups,
# kMaxDirectKeys in csrc/segment_agg_direct.cu; executor.DIRECT_GROUP_LIMIT)
DIRECT_MAX_GROUPS = 256
DIRECT_MAX_KEYS = 8


class _DirectKeySet(ctypes.Structure):
    _fields_ = [
        ("col", _KeyCol * DIRECT_MAX_KEYS), ("domain", ctypes.c_int * DIRECT_MAX_KEYS),
        ("dst", ctypes.c_void_p * DIRECT_MAX_KEYS),
        ("dst_valid", ctypes.c_void_p * DIRECT_MAX_KEYS), ("n", ctypes.c_int),
    ]


def direct_group_ids(key_cols, domains) -> torch.Tensor:
    """Each row's flat group index (int32): per key its value as int32
    clamped to its codes, ``D - 1`` where NULL, folded ``gid * D + code``."""
    gid = torch.zeros(key_cols[0][0].shape[0], dtype=torch.int32, device=key_cols[0][0].device)
    for (d, v), D in zip(key_cols, domains):
        size = D - 1
        gid = gid * D + torch.where(v, d.to(torch.int32).clamp(0, max(size - 1, 0)), size)
    return gid


def direct_group_keys(key_cols, domains):
    """The key columns at the G groups: each key's code in the flat group
    index's mixed-radix digits, cast to its storage, valid where not the
    NULL slot."""
    G = math.prod(domains)
    rem = torch.arange(G, dtype=torch.int32, device=key_cols[0][0].device)
    codes = []
    for D in reversed(domains):
        codes.append(rem % D)
        rem = rem // D
    return [(c.to(d.dtype), c < D - 1)
            for (d, _), D, c in zip(key_cols, domains, codes[::-1])]


def segment_agg_direct_plain(key_cols, domains, active: torch.Tensor, requests, outputs):
    """The reference's ``_direct_aggregate_impl`` (``"off"``) for the
    requests and outputs given: the group index, every request through
    ``kernels.direct_group_reduce`` and ``direct_group_first`` (the largest
    participating row), ``group_exists`` from the active count, the rebuilt
    keys and the finishing."""
    G = math.prod(domains)
    gid = direct_group_ids(key_cols, domains)

    def reduce_fn(vals, w, kind):
        if kind in K.BITWISE_KINDS:
            return K.bitwise_group_reduce(vals, w, gid, G, kind)
        return K.direct_group_reduce(vals, w, gid, G, kind)

    def first_fn(vals, w):
        return K.direct_group_first(vals, w, gid, G)

    group_exists = reduce_fn(active.to(torch.int64), active, "count") > 0
    results = run_requests(requests, active, reduce_fn, first_fn,
                           lambda g: g[gid.to(torch.int64)])
    return (group_exists, direct_group_keys(key_cols, domains),
            [finish_output(o, results, G) for o in outputs])


def segment_agg_direct(key_cols, domains, active: torch.Tensor, requests, outputs, *,
                       phase_events=None):
    """The direct-indexed aggregation, whole: ``segment_agg``'s requests
    and outputs over small static key domains.

    ``key_cols``: (data, valid) of each group key (1 to
    :data:`DIRECT_MAX_KEYS`: dictionary codes or bools), ``domains`` their
    domain sizes (values plus the NULL slot; their product G at most
    :data:`DIRECT_MAX_GROUPS`), the page's ``active``, ``requests`` and
    ``outputs`` as :func:`segment_agg` takes them. Returns
    ``(group_exists, keys_out, outs)`` at the G groups: whether an active
    row has the group, the rebuilt keys and each output's (data, valid).
    Float sums add in another order than the plain scatter's; every other
    value is bit-identical. It takes no ``match_last`` request (``min_by``
    and ``max_by`` are not direct aggregates). On CUDA tensors two launches
    (reduce and finish), four with a ``tied`` request (a resolve pass folds
    each group's extreme of the requests it reads, then a second reduce
    serves the tied requests), no memset; ``phase_events`` as
    ``segment_agg``'s (the second round inside ``reduce``)."""
    name = "segment_agg_direct"
    _check_vectors(name, (active,), (torch.bool,))
    n, dev = active.shape[0], active.device
    G = math.prod(domains)
    if (not 1 <= len(key_cols) <= DIRECT_MAX_KEYS or len(domains) != len(key_cols)
            or any(D < 1 for D in domains) or not 1 <= G <= DIRECT_MAX_GROUPS or n < 1):
        raise ValueError(f"{name}: 1 to {DIRECT_MAX_KEYS} keys over at most "
                         f"{DIRECT_MAX_GROUPS} groups, and a row")
    _check_page_cols(name, key_cols, n, dev)
    for d, _ in key_cols:
        if d.dtype not in _DECODED_TYPES:
            raise TypeError(f"{name}: unsupported key column {d.dtype}")
    plans = _agg_plans(name, requests, outputs, active, match=False)
    if dev.type == "cpu":
        return segment_agg_direct_plain(key_cols, domains, active, requests, outputs)
    rs, os_, outs = _agg_sets(requests, outputs, plans, G, dev)
    ks = _DirectKeySet()
    ks.n = len(key_cols)
    keys_out = []
    for k, ((d, v), D) in enumerate(zip(key_cols, domains)):
        od = torch.empty(G, dtype=d.dtype, device=dev)
        ov = torch.empty(G, dtype=torch.bool, device=dev)
        keys_out.append((od, ov))
        col = ks.col[k]
        col.data, col.valid, col.type = d.data_ptr(), v.data_ptr(), _KEY_TYPES[d.dtype]
        ks.domain[k], ks.dst[k], ks.dst_valid[k] = D, od.data_ptr(), ov.data_ptr()
    lib = _library()
    blocks = int(lib.segment_agg_direct_blocks(n))
    gids = torch.empty(n, dtype=torch.int16, device=dev)
    # each request's block partials (the active count first), then with a
    # tied request each request's G extremes
    tied = any(r.kind == "tied" for r in requests)
    partials = torch.empty((len(requests) + 1) * blocks * G + tied * len(requests) * G,
                           dtype=torch.int64, device=dev)
    group_exists = torch.empty(G, dtype=torch.bool, device=dev)
    events = _phase_marks(phase_events, ("reduce", "finish"))
    _check_launch(name, lib.segment_agg_direct(
        ctypes.byref(rs), ctypes.byref(os_), ctypes.byref(ks), active.data_ptr(), n, G,
        gids.data_ptr(), partials.data_ptr(), group_exists.data_ptr(), events,
        _stream(active)))
    LAUNCHES[name] += 1
    return group_exists, keys_out, outs


# the limits of one expression program (kMaxExpr* in csrc/expr_program.cu):
# ops/expr_program.py builds within them and leaves the rest on the closures
EXPR_MAX_INSTRS = 128
EXPR_MAX_REGS = 32
EXPR_MAX_CONSTS = 32
EXPR_MAX_INPUTS = 16
EXPR_MAX_OUTPUTS = 16
EXPR_MAX_LUTS = 8


class _ExprInstr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_uint8), ("dst", ctypes.c_uint8), ("a", ctypes.c_uint8),
                ("b", ctypes.c_uint8), ("c", ctypes.c_uint8), ("t", ctypes.c_uint8),
                ("aux", ctypes.c_uint16)]


class _ExprCol(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p), ("type", ctypes.c_int)]


class _ExprLut(ctypes.Structure):
    _fields_ = [("lut", ctypes.c_void_p), ("len", ctypes.c_int64)]


class _ExprProgram(ctypes.Structure):
    _fields_ = [
        ("code", _ExprInstr * EXPR_MAX_INSTRS), ("consts", ctypes.c_int64 * EXPR_MAX_CONSTS),
        ("inp", _ExprCol * EXPR_MAX_INPUTS), ("out", _ExprCol * EXPR_MAX_OUTPUTS),
        ("lut", _ExprLut * EXPR_MAX_LUTS), ("n_code", ctypes.c_int), ("n_regs", ctypes.c_int),
    ]


def expr_program_plain(program, inputs, active=None):
    """The program run one instruction at a time as torch operations over
    whole columns, through the closures' own helpers
    (``expr_program.run_plain``): on the CPU the closures' values, bit for
    bit."""
    from .expr_program import run_plain

    return run_plain(program, inputs, active)


def _program_struct(program) -> _ExprProgram:
    """The parts of a program's kernel parameter that do not change between
    calls (instructions, constants, LUTs), built once per program."""
    static = getattr(program, "_struct", None)
    if static is None:
        static = _ExprProgram()
        static.n_code = len(program.code)
        static.n_regs = program.n_regs
        for c, ins in zip(static.code, program.code):
            c.op, c.dst, c.a, c.b, c.c, c.t, c.aux = ins
        for k, bits in enumerate(program.consts):
            static.consts[k] = bits
        for c, lut in zip(static.lut, program.luts):
            c.lut, c.len = lut.data_ptr(), lut.shape[0]
        program._struct = static
    return static


# rows a thread of expr_program's kernel may take (its template argument K);
# a block takes K * EXPR_BLOCK_THREADS rows at a time
EXPR_ROWS_PER_THREAD = (4, 2, 1)
EXPR_BLOCK_THREADS = 256
_EXPR_OCCUPANCY: Dict[Tuple[int, int], int] = {}


def expr_program_plan(n: int, n_regs: int, sms: int, blocks_per_sm) -> Tuple[int, int, int]:
    """(k, block_rows, grid) of one expr_program launch over n rows: the
    largest k of :data:`EXPR_ROWS_PER_THREAD` of which an SM holds two
    blocks or more (``blocks_per_sm[k]``, the card's occupancy of kernel<k>
    with a file of ``n_regs`` registers; 0 where it does not fit), else the
    smallest k that fits; tiles of ``block_rows = k * EXPR_BLOCK_THREADS``
    rows, and a grid of the tiles capped at the resident blocks
    (``tools/expr_program_variants.py`` measured the largest k fastest on
    every program of the main path, and k = 1 on the 32-register one). Block
    b takes tiles b, b + grid, ...; a thread row j of its tile (j < k), row
    ``tile * block_rows + j * EXPR_BLOCK_THREADS + thread``."""
    fits = [k for k in EXPR_ROWS_PER_THREAD if blocks_per_sm[k] >= 1]
    if not fits:
        raise ValueError(f"expr_program: a file of {n_regs} registers fits no block")
    k = next((k for k in fits if blocks_per_sm[k] >= 2), fits[-1])
    rows = k * EXPR_BLOCK_THREADS
    return k, rows, min(max(-(-n // rows), 1), sms * blocks_per_sm[k])


def _expr_launch_plan(lib, n: int, n_regs: int, dev) -> Tuple[int, int, int]:
    occupancy = {}
    for k in EXPR_ROWS_PER_THREAD:
        key = (k, n_regs)
        if key not in _EXPR_OCCUPANCY:
            _EXPR_OCCUPANCY[key] = lib.expr_program_blocks_per_sm(k, n_regs)
        occupancy[k] = _EXPR_OCCUPANCY[key]
    return expr_program_plan(n, n_regs, torch.cuda.get_device_properties(dev)
                             .multi_processor_count, occupancy)


def expr_program(program, inputs, active=None):
    """Every lowered assignment of a projection in one launch.

    ``program``: an ``expr_program.ExprProgram`` (instructions over a
    register file, constants, LUTs; within the ``EXPR_MAX_*`` limits);
    ``inputs``: (data, valid) of each column it reads, in its order and of
    its dtypes; ``active``, the page's activity, gives the row count and
    the device of a program that reads no column (its constants). Returns
    each output's (data, valid), of the program's output dtypes. On CUDA
    tensors one launch, k rows a thread (:func:`expr_program_plan`)."""
    name = "expr_program"
    if len(inputs) != len(program.input_dtypes) or not (inputs or active is not None):
        raise ValueError(f"{name}: the program reads {len(program.input_dtypes)} columns")
    rows = inputs[0][1] if inputs else active
    n, dev = rows.shape[0], rows.device
    _check_page_cols(name, inputs, n, dev)
    for (d, _), dt in zip(inputs, program.input_dtypes):
        if d.dtype != dt:
            raise TypeError(f"{name}: a {dt} input given {d.dtype}")
    if any(lut.device != dev for lut in program.luts):
        raise ValueError(f"{name}: the program's LUTs are not on {dev}")
    if dev.type == "cpu":
        return expr_program_plain(program, inputs, rows)
    p = _ExprProgram()
    ctypes.memmove(ctypes.addressof(p), ctypes.addressof(_program_struct(program)),
                   ctypes.sizeof(_ExprProgram))
    for c, (d, v) in zip(p.inp, inputs):
        c.data, c.valid, c.type = d.data_ptr(), v.data_ptr(), _KEY_TYPES[d.dtype]
    outs = []
    for c, dt in zip(p.out, program.output_dtypes):
        data = torch.empty(n, dtype=dt, device=dev)
        valid = torch.empty(n, dtype=torch.bool, device=dev)
        outs.append((data, valid))
        c.data, c.valid, c.type = data.data_ptr(), valid.data_ptr(), _KEY_TYPES[dt]
    lib = _library()
    k, _, grid = _expr_launch_plan(lib, n, program.n_regs, dev)
    _check_launch(name, lib.expr_program(ctypes.byref(p), n, k, grid, _stream(rows)))
    LAUNCHES[name] += 1
    return outs
