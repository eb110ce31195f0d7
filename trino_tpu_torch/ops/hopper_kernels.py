"""Hand-written Hopper kernels and their plain torch versions.

The port's counterpart of ``trino_tpu.ops.pallas_kernels`` and of the
Pallas bodies of ``trino_tpu.ops.megakernels`` (the hash-join probe and
expansion, the group sort, the sort-path segment sums, the repartition
epilogue and the exchange destination stage). The kernels are
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
from typing import Dict, List, Sequence

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
    "hash_probe": 0, "hash_expand": 0, "segment_sum": 0, "group_sort": 0,
    "partition_epilogue": 0, "partition_dest": 0,
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
        + [ctypes.POINTER(_GatherSet), i32, ptr]
    )
    lib.hash_expand_slots.restype = i32
    lib.segment_sum.argtypes = [ptr, i32, ptr, ptr, i64, i64, ptr, ptr]
    lib.segment_sum.restype = i32
    for name, want in (("hash_expand_gather_cols", _MAX_GATHER_COLS),
                       ("hash_expand_tile_rows", EXPAND_TILE_ROWS),
                       ("hash_expand_state_head", _EXPAND_STATE_HEAD),
                       ("hash_expand_look_back", EXPAND_LOOK_BACK),
                       ("wide_key_limit", _MAX_WIDE_KEYS),
                       ("radix_tile_rows", _TILE_ROWS),
                       ("group_sort_tile_rows", SORT_TILE_ROWS),
                       ("segment_sum_tile_rows", SEGMENT_TILE_ROWS),
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
    lib.partition_epilogue.argtypes = (
        [ctypes.POINTER(_WideKeySet), ptr, ptr, i64, i32] + [ptr] * 6
        + [gather, i32, events, ptr]
    )
    lib.partition_epilogue.restype = i32
    lib.partition_dest.argtypes = [ctypes.POINTER(_WideKeySet), ptr, i64, i32, ptr, ptr]
    lib.partition_dest.restype = i32
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
                      probe_active, probe_cols, build_cols, out_capacity: int):
    """The join stage of the reference's ``_expand_phase_body``: slots from
    ``kernels.expand_probe_slots``; each slot's build row is the (d+1)-th
    equal-key slot of its probe row's bucket (a cumsum over the match block,
    slot 0 where there is none), in chunks of slots; then the gathers."""
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
    return probe_out, build_out, out_active


def hash_expand(table, counts, bucket_p, count, emit, pkeys, bkeys, luts,
                probe_active: torch.Tensor, probe_cols, build_cols, out_capacity: int,
                *, phase_events=None):
    """The join expansion into ``out_capacity`` slots after
    :func:`hash_probe` (its table, counts, bucket_p, count and emit).

    ``probe_cols``/``build_cols``: (data, valid) of every column of each
    side, in page order. Returns ``(probe_out, build_out, out_active)``:
    the gathered (data, valid) pairs, build validity ANDed with the slot's
    matched flag, and the output activity. On CUDA tensors the kernel is a
    scan pass over ``emit`` (tiles of :data:`EXPAND_TILE_ROWS` rows) and a
    slot pass; ``phase_events``, None or three ``torch.cuda.Event``, are
    recorded on the stream before the scan, between the passes and after
    the slot pass, to split the kernel's time."""
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
    if probe_active.device.type == "cpu":
        return hash_expand_plain(table, counts, bucket_p, count, emit, pkeys, bkeys,
                                 luts, probe_active, probe_cols, build_cols, out_capacity)
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
        sets, n_sets, stream,
    )
    _check_launch("hash_expand", rc)
    if marks:
        marks[2].record()
    LAUNCHES["hash_expand"] += 1
    return outs[: len(probe_cols)], outs[len(probe_cols):], out_active


# --------------------------------------------------------------------------- #
# segment sums (replace the reductions of megakernels.aggregate_phase)
# --------------------------------------------------------------------------- #

_VALUE_TYPES = {torch.int64: 0, torch.int32: 1, torch.bool: 2}
# rows of one segment-sum tile (kSegRows in csrc/segment_agg.cu)
SEGMENT_TILE_ROWS = 2048


def segment_sum_plain(values: torch.Tensor, weight: torch.Tensor,
                      starts: torch.Tensor) -> torch.Tensor:
    """The reference's cumsum-at-boundaries segment sum: ends are the next
    start minus one (n - 1 for the last slot), both bounds clipped."""
    n = values.shape[0]
    vals = torch.where(weight, values.to(torch.int64), 0)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)]) - 1
    return K.segment_sum_bounds(vals, (starts, ends))


def segment_sum(values: torch.Tensor, weight: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """out[g] = sum(values[i] for weighted rows i of segment g) as int64
    (mod 2^64), over group-sorted rows; ``starts`` (int64, ascending,
    padded with n) holds each segment's first row, and segment g ends where
    segment g+1 starts. Values are int64, int32 or bool (a count). On CUDA
    tensors: a memset of the output and one launch over tiles of
    :data:`SEGMENT_TILE_ROWS` rows."""
    if values.dtype not in _VALUE_TYPES:
        raise TypeError(f"segment_sum: values of {values.dtype} are not supported")
    _check_vectors("segment_sum", (values, weight), (values.dtype, torch.bool))
    _check_vectors("segment_sum", (starts,), (torch.int64,))
    if starts.device != values.device or starts.shape[0] < 1 or values.shape[0] < 1:
        raise ValueError("segment_sum: starts must be non-empty on the values' device")
    if values.device.type == "cpu":
        return segment_sum_plain(values, weight, starts)
    out = torch.empty(starts.shape[0], dtype=torch.int64, device=values.device)
    rc = _library().segment_sum(
        values.data_ptr(), _VALUE_TYPES[values.dtype], weight.data_ptr(), starts.data_ptr(),
        values.shape[0], starts.shape[0], out.data_ptr(), _stream(values),
    )
    _check_launch("segment_sum", rc)
    LAUNCHES["segment_sum"] += 1
    return out


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
_STREAM_OPS = ("hash_probe", "group_sort", "segment_sum", "partition_epilogue",
               "partition_dest")


def stream_ops(name: str) -> int:
    """Kernel launches and memsets that ``name``'s kernels (one of
    ``hash_probe``, ``group_sort``, ``segment_sum``, ``partition_epilogue``
    and ``partition_dest``) have issued since the library was loaded."""
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
