"""Host-side page utilities: the out-of-core bucket store, operator-state
spill and every layer that moves rows through host memory.

The port's counterpart of ``trino_tpu.spi.host_pages``. A "host chunk" is
``[(type, data, valid, dictionary), ...]``: one numpy pair per column,
compacted to active rows. The bucket rule (:func:`hash_partition_host`)
works in numpy ``uint64`` exactly as the reference's, so every row lands in
the same bucket; the device hash (``ops/repartition.py``) gives the same
bits on int64.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .page import Column, Dictionary, Page

_INT64_MIN = np.int64(np.iinfo(np.int64).min)
_INT64_MAX = np.int64(np.iinfo(np.int64).max)


def host_order_key(d: np.ndarray) -> np.ndarray:
    """Host mirror of kernels.order_key (floats: sign-magnitude bit unfold)."""
    if d.dtype.kind == "f":
        bits = np.ascontiguousarray(d, dtype=np.float64).view(np.int64)
        return np.where(bits < 0, np.bitwise_xor(~bits, _INT64_MIN), bits)
    return d.astype(np.int64)


def hash_partition_host(cols: List, n: int) -> np.ndarray:
    """Row -> partition over (data, valid) key pairs: the repartition hash
    (NULL keys as INT64_MAX, floats through the order-key unfold), in numpy
    uint64."""
    acc = np.full(cols[0][0].shape, 0x9E3779B97F4A7C15, dtype=np.uint64)
    for d, v in cols:
        k = np.where(v, host_order_key(d), _INT64_MAX)
        x = k.astype(np.uint64)
        x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
        x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
        x = x ^ (x >> np.uint64(33))
        acc = (acc ^ x) * np.uint64(0x100000001B3)
    return (acc % np.uint64(n)).astype(np.int64)


def host_partition_targets(cols: List, key_idx: List[int], n: int) -> np.ndarray:
    """Row -> partition for a host chunk: dictionary-coded keys hash by
    their content-stable value keys (codes are local to one dictionary, and
    the same string must land in one partition whichever producer sent it);
    no keys send every row to the partition of hash(0)."""
    nrows = len(cols[0][1]) if cols else 0
    keys = []
    for i in key_idx:
        _, data, valid, dictionary = cols[i]
        if dictionary is not None:
            lut = dictionary.value_keys()
            data = lut[np.clip(data, 0, len(lut) - 1)]
        keys.append((data, valid))
    keys = keys or [(np.zeros(nrows, dtype=np.int64), np.ones(nrows, dtype=np.bool_))]
    return hash_partition_host(keys, n)


def page_to_host(page: Page):
    """Page -> host chunk, compacted to active rows on the page's device
    before the copy, so only live rows cross to the host."""
    idx = page.active.nonzero().squeeze(1)
    return [
        (c.type, c.data.index_select(0, idx).cpu().numpy(),
         c.valid.index_select(0, idx).cpu().numpy(), c.dictionary)
        for c in page.columns
    ]


def page_from_host_chunks(chunks: List[List], capacity: Optional[int] = None,
                          device=None) -> Page:
    """Merge host chunks from several producers into one Page on ``device``
    (default ``cuda``). Columns whose chunks carry different dictionaries
    are re-encoded into a merged sorted dictionary; ``capacity`` pads the
    page."""
    merged = []
    for i in range(len(chunks[0])):
        type_ = chunks[0][i][0]
        real = [c[i][3] for c in chunks if c[i][3] is not None]
        if real and len({d.fingerprint() for d in real}) > 1:
            merged_values = sorted(set().union(*[list(d.values) for d in real]))
            dictionary = Dictionary(np.asarray(merged_values, dtype=object))
            code_of = {s: c for c, s in enumerate(merged_values)}
            datas = []
            for c in chunks:
                col = c[i]
                if col[3] is None:
                    datas.append(np.zeros_like(col[1]))
                    continue
                lut = np.array([code_of[s] for s in col[3].values], dtype=col[1].dtype)
                datas.append(lut[np.clip(col[1], 0, len(lut) - 1)])
            data = np.concatenate(datas)
        else:
            data = np.concatenate([c[i][1] for c in chunks])
            dictionary = real[0] if real else None
        valid = np.concatenate([c[i][2] for c in chunks])
        merged.append((type_, data, valid, dictionary))
    n = len(merged[0][1]) if merged else 0
    cap = max(capacity or 0, n, 1)
    dev = resolve_device(device)
    cols = tuple(
        Column.from_numpy(tp, d, v, capacity=cap, dictionary=dc, device=dev)
        for tp, d, v, dc in merged
    )
    active = np.zeros(cap, dtype=np.bool_)
    active[:n] = True
    return Page(cols, torch.from_numpy(active).to(dev))


def pages_from_host_rows(col_specs, row_sel: np.ndarray, device=None) -> Page:
    """The rows ``row_sel`` (a boolean mask or indexes) of a host chunk as
    a Page on ``device``."""
    dev = resolve_device(device)
    cols = []
    n = int(row_sel.sum()) if row_sel.dtype == bool else len(row_sel)
    for type_, data, valid, dictionary in col_specs:
        d = data[row_sel]
        cols.append(Column.from_numpy(type_, d, valid[row_sel], capacity=max(len(d), 1),
                                      dictionary=dictionary, device=dev))
    if not cols:
        return Page((), torch.zeros(1, dtype=torch.bool, device=dev))
    active = np.zeros(cols[0].capacity, dtype=np.bool_)
    active[:n] = True
    return Page(tuple(cols), torch.from_numpy(active).to(dev))


# --------------------------------------------------------------------------- #
# LZ4 spill files: numpy arrays -> one compressed file (the out-of-core bucket
# store's disk format). Each array compresses independently, so a thread pool
# can (de)compress a chunk's columns in parallel. Format, little-endian:
#   magic 'TPS1' | narrays u32
#   per array: dtype_len u8 | dtype_str | ndim u8 | dim u64 * ndim |
#              codec u8 (0=raw, 1=lz4) | raw_len u64 | comp_len u64 | payload
# --------------------------------------------------------------------------- #

_SPILL_MAGIC = b"TPS1"
_SPILL_MIN_COMPRESS = 64  # tiny buffers aren't worth an LZ4 round-trip


def _pack_array(a: np.ndarray) -> bytes:
    from .. import native

    raw = np.ascontiguousarray(a).tobytes()
    codec, payload = 0, raw
    if len(raw) >= _SPILL_MIN_COMPRESS:
        comp = native.lz4_compress(raw)
        if len(comp) < len(raw):
            codec, payload = 1, comp
    ds = a.dtype.str.encode()
    head = struct.pack("<B", len(ds)) + ds + struct.pack("<B", a.ndim)
    head += struct.pack(f"<{a.ndim}Q", *a.shape) if a.ndim else b""
    head += struct.pack("<BQQ", codec, len(raw), len(payload))
    return head + payload


def _unpack_array(blob: bytes) -> np.ndarray:
    from .. import native

    (ds_len,) = struct.unpack_from("<B", blob, 0)
    off = 1
    dtype = np.dtype(blob[off : off + ds_len].decode())
    off += ds_len
    (ndim,) = struct.unpack_from("<B", blob, off)
    off += 1
    shape = struct.unpack_from(f"<{ndim}Q", blob, off) if ndim else ()
    off += 8 * ndim
    codec, raw_len, comp_len = struct.unpack_from("<BQQ", blob, off)
    off += struct.calcsize("<BQQ")
    payload = blob[off : off + comp_len]
    if codec == 1:
        payload = native.lz4_decompress(payload, raw_len)
    return np.frombuffer(payload, dtype=dtype).reshape(shape)


def write_arrays_lz4(path: str, arrays: List[np.ndarray], pool=None) -> None:
    """Compress ``arrays`` (in parallel on ``pool`` when given) into one
    spill file. Callers already running on the pool pass ``pool=None``:
    fanning out from inside a pool job deadlocks a saturated executor."""
    packs = list(pool.map(_pack_array, arrays)) if pool is not None else [
        _pack_array(a) for a in arrays
    ]
    with open(path, "wb") as f:
        f.write(_SPILL_MAGIC + struct.pack("<I", len(packs)))
        for p in packs:
            f.write(struct.pack("<Q", len(p)))
            f.write(p)


def read_arrays_lz4(path: str, pool=None) -> List[np.ndarray]:
    """Read a spill file back; decompression parallelizes on ``pool``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _SPILL_MAGIC:
        raise ValueError(f"bad spill file magic in {path}")
    (n,) = struct.unpack_from("<I", data, 4)
    off = 4 + 4
    blobs = []
    for _ in range(n):
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        blobs.append(data[off : off + blen])
        off += blen
    if pool is not None:
        return list(pool.map(_unpack_array, blobs))
    return [_unpack_array(b) for b in blobs]


def empty_page_for(symbols, types, device=None) -> Page:
    """A 1-row all-inactive Page on ``device`` with the symbols' storage
    layouts (an empty exchange input or table scan). String columns carry
    the sentinel empty dictionary."""
    from .types import is_string

    dev = resolve_device(device)
    cols = []
    for s in symbols:
        t = types[s]
        lanes = () if t.storage_lanes is None else (t.storage_lanes,)
        cols.append(Column(
            t,
            torch.zeros((1,) + lanes, dtype=t.torch_dtype, device=dev),
            torch.zeros(1, dtype=torch.bool, device=dev),
            Dictionary.empty() if is_string(t) else None,
        ))
    return Page(tuple(cols), torch.zeros(1, dtype=torch.bool, device=dev))
