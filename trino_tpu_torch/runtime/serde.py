"""Page wire serde: framing, LZ4 compression and checksums.

The port's counterpart of ``trino_tpu.runtime.serde``. Frames are the
exchange-frame contract, so for the same columns the bytes are identical to
the reference's; the byte-level work (LZ4, checksum) is the same C++
(``trino_tpu_torch.native``).

v1 frame layout (little-endian):
  magic 'TPG1' | ncols u32 | capacity u64 | tn_len u32 | type_names | has_dict
  per buffer: dtype_code u8 | codec u8 (0=raw, 1=lz4) | raw_len u64 |
              comp_len u64 | checksum u64 | payload
Buffers, in order: active mask, then per column (data, valid), then per string
column its dictionary as a utf-8 '\\x00'-joined blob.

v2 frame layout ('TPG2'), written by :func:`serialize_page_slices` and
:func:`serialize_page_partitions`:
  magic 'TPG2' | ncols u32 | nrows u64 | tn_len u32 | type_names | has_dict |
  per column: lanes u32 (0 = scalar)
  buffers: per column (data, valid), then per dict column its blob
A v2 frame carries exactly ``nrows`` live rows: no active mask and no
padding. :func:`deserialize_page` reads both versions, and
:class:`LazyPageFrame` parses the header without decoding the buffers.

The reference's flight-recorder spans around encode and decode belong to
the observability plane, which is not ported yet.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from .._unported import unported
from ..device import resolve_device
from ..spi.page import Column, Dictionary, Page
from ..spi.types import parse_type

MAGIC = b"TPG1"
MAGIC2 = b"TPG2"

_DTYPES = [
    np.dtype(np.bool_), np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32),
    np.dtype(np.int64), np.dtype(np.float32), np.dtype(np.float64),
    np.dtype(np.uint8),
]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}

MIN_COMPRESS = 64  # don't bother compressing tiny buffers
_POOL_MIN_BYTES = 1 << 22  # below ~4 MiB the pool handoff beats the LZ4 win
_V2_HEAD = "<IQI"  # ncols u32 | nrows u64 | tn_len u32


def _host(t) -> np.ndarray:
    """A tensor (or array) as a numpy array on the host."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _encode_buffer(arr: np.ndarray, compress: bool) -> bytes:
    raw = np.ascontiguousarray(arr).tobytes()
    codec = 0
    payload = raw
    if compress and len(raw) >= MIN_COMPRESS:
        comp = native.lz4_compress(raw)
        if len(comp) < len(raw):
            codec = 1
            payload = comp
    header = struct.pack(
        "<BBQQQ", _DTYPE_CODE[arr.dtype], codec, len(raw), len(payload),
        native.hash64(payload),
    )
    return header + payload


def _decode_buffer(buf: memoryview, offset: int) -> Tuple[np.ndarray, int]:
    try:
        dtype_code, codec, raw_len, comp_len, checksum = struct.unpack_from(
            "<BBQQQ", buf, offset
        )
    except struct.error as e:
        raise ValueError(f"truncated page frame: {e}") from None
    offset += struct.calcsize("<BBQQQ")
    payload = bytes(buf[offset : offset + comp_len])
    if len(payload) != comp_len:
        raise ValueError(
            f"truncated page frame: buffer needs {comp_len} bytes, "
            f"{len(payload)} remain"
        )
    offset += comp_len
    if checksum and native.hash64(payload) != checksum:
        raise ValueError("page frame checksum mismatch")
    if codec == 1:
        payload = native.lz4_decompress(payload, raw_len)
    if dtype_code >= len(_DTYPES):
        raise ValueError(f"corrupt page frame: unknown dtype code {dtype_code}")
    return np.frombuffer(payload, dtype=_DTYPES[dtype_code]), offset


def _dict_blob(dictionary: Dictionary, compress: bool) -> bytes:
    blob = "\x00".join(str(s) for s in dictionary.values).encode()
    return _encode_buffer(np.frombuffer(blob, dtype=np.uint8), compress)


def _decode_dictionary(buf: memoryview, offset: int) -> Tuple[Dictionary, int]:
    blob, offset = _decode_buffer(buf, offset)
    values = bytes(blob.tobytes()).decode().split("\x00")
    return Dictionary(np.asarray(values, dtype=object)), offset


def serialize_page(page: Page, compress: bool = True) -> bytes:
    """Page -> v1 wire bytes (the whole capacity, inactive rows included)."""
    buffers: List[bytes] = [_encode_buffer(_host(page.active), compress)]
    dict_blobs: List[bytes] = []
    for c in page.columns:
        buffers.append(_encode_buffer(_host(c.data), compress))
        buffers.append(_encode_buffer(_host(c.valid), compress))
        if c.dictionary is not None:
            dict_blobs.append(_dict_blob(c.dictionary, compress))
    type_names = "\x00".join(c.type.display() for c in page.columns).encode()
    has_dict = bytes(1 if c.dictionary is not None else 0 for c in page.columns)
    head = MAGIC + struct.pack("<IQI", page.num_columns, page.capacity, len(type_names))
    return b"".join([head, type_names, has_dict, *buffers, *dict_blobs])


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    # frombuffer arrays are read-only: torch gets a writable copy
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def deserialize_page(data: bytes, device=None) -> Page:
    """Wire bytes (v1 or v2) -> a Page on ``device`` (default ``cuda``)."""
    buf = memoryview(data)
    if bytes(buf[:4]) == MAGIC2:
        return LazyPageFrame(data).to_page(device=device)
    if bytes(buf[:4]) != MAGIC:
        raise ValueError("bad page frame magic")
    dev = resolve_device(device)
    ncols, capacity, tn_len = struct.unpack_from("<IQI", buf, 4)
    offset = 4 + struct.calcsize("<IQI")
    type_names = bytes(buf[offset : offset + tn_len]).decode().split("\x00") if tn_len else []
    offset += tn_len
    has_dict = list(buf[offset : offset + ncols])
    offset += ncols
    active, offset = _decode_buffer(buf, offset)
    raw_cols = []
    for _ in range(ncols):
        data_arr, offset = _decode_buffer(buf, offset)
        valid_arr, offset = _decode_buffer(buf, offset)
        raw_cols.append((data_arr, valid_arr))
    dictionaries: List[Optional[Dictionary]] = []
    for i in range(ncols):
        if has_dict[i]:
            dictionary, offset = _decode_dictionary(buf, offset)
            dictionaries.append(dictionary)
        else:
            dictionaries.append(None)
    cols = []
    for (data_arr, valid_arr), tname, dictionary in zip(raw_cols, type_names, dictionaries):
        type_ = parse_type(tname)
        if type_.storage_lanes is not None:
            unported("ops.int128 (multi-lane storage)")
        cols.append(Column(
            type_, _tensor(data_arr, type_.storage_dtype, dev),
            _tensor(valid_arr, np.bool_, dev), dictionary,
        ))
    return Page(tuple(cols), _tensor(active, np.bool_, dev))


# --------------------------------------------------------------------------- #
# serde v2: partition-sliced frames
# --------------------------------------------------------------------------- #


def _v2_shared_header(cols, compress: bool = True) -> Tuple[bytes, bytes, bytes, List[bytes]]:
    """What every partition frame of one page shares: type names, dictionary
    flags, lane widths and the dictionary blobs, encoded once."""
    type_names = "\x00".join(t.display() for t, _, _, _ in cols).encode()
    has_dict = bytes(1 if dc is not None else 0 for _, _, _, dc in cols)
    lanes = struct.pack(
        f"<{len(cols)}I", *[d.shape[1] if d.ndim == 2 else 0 for _, d, _, _ in cols]
    )
    dict_blobs = [_dict_blob(dc, compress) for _, _, _, dc in cols if dc is not None]
    return type_names, has_dict, lanes, dict_blobs


def serialize_page_slices(
    cols: Sequence,
    offsets: np.ndarray,
    counts: np.ndarray,
    compress: bool = True,
    pool=None,
) -> List[bytes]:
    """One v2 frame per partition, sliced from a partition-contiguous host
    chunk ``[(type, data, valid, dictionary), ...]`` whose rows
    ``[offsets[k], offsets[k] + counts[k])`` belong to partition k (the
    repartition epilogue's output). ``pool``: an executor the per-buffer
    LZ4 work fans out on (``spiller.io_pool``); callers already running on
    that pool pass None."""
    n_parts = len(counts)
    type_names, has_dict, lanes, shared_dicts = _v2_shared_header(cols, compress)
    slices: List[np.ndarray] = []
    for k in range(n_parts):
        o, c = int(offsets[k]), int(counts[k])
        for _, d, v, _ in cols:
            slices.append(d[o : o + c])
            slices.append(v[o : o + c])
    total_bytes = sum(a.nbytes for a in slices)
    if pool is not None and len(slices) > 1 and total_bytes >= _POOL_MIN_BYTES:
        encoded = list(pool.map(lambda a: _encode_buffer(a, compress), slices))
    else:
        encoded = [_encode_buffer(a, compress) for a in slices]
    frames: List[bytes] = []
    per = 2 * len(cols)
    for k in range(n_parts):
        head = MAGIC2 + struct.pack(_V2_HEAD, len(cols), int(counts[k]), len(type_names))
        frames.append(b"".join(
            [head, type_names, has_dict, lanes, *encoded[k * per : (k + 1) * per],
             *shared_dicts]
        ))
    return frames


def serialize_page_partitions(
    cols: Sequence,
    dest: np.ndarray,
    n_parts: int,
    compress: bool = True,
    pool=None,
) -> Tuple[List[bytes], np.ndarray]:
    """Row gather and v2 frame encode fused, one task per partition:
    ``cols`` is a full-capacity host chunk, ``dest`` each row's partition
    (``n_parts`` for inactive rows, which are dropped). Each partition's
    rows keep their relative order. Returns ``(frames, counts)``,
    byte-identical to :func:`serialize_page_slices` over the
    partition-contiguous chunk of the same page."""
    type_names, has_dict, lanes, dict_blobs = _v2_shared_header(cols, compress)

    def one_partition(p: int) -> Tuple[bytes, int]:
        idx = np.flatnonzero(dest == p)
        out = [MAGIC2 + struct.pack(_V2_HEAD, len(cols), len(idx), len(type_names)),
               type_names, has_dict, lanes]
        for _, d, v, _ in cols:
            out.append(_encode_buffer(d[idx], compress))
            out.append(_encode_buffer(v[idx], compress))
        out.extend(dict_blobs)
        return b"".join(out), len(idx)

    nbytes = sum(d.nbytes + v.nbytes for _, d, v, _ in cols)
    if pool is not None and n_parts > 1 and nbytes >= _POOL_MIN_BYTES:
        built = list(pool.map(one_partition, range(n_parts)))
    else:
        built = [one_partition(p) for p in range(n_parts)]
    return [f for f, _ in built], np.asarray([c for _, c in built], dtype=np.int64)


class LazyPageFrame:
    """A parsed frame header with the buffer decode deferred to
    :meth:`to_page`. For v1 frames ``nrows`` is the frame's capacity."""

    __slots__ = ("data", "version", "ncols", "nrows", "_body", "_type_names",
                 "_has_dict", "_lanes")

    def __init__(self, data: bytes):
        buf = memoryview(data)
        magic = bytes(buf[:4])
        try:
            if magic == MAGIC2:
                self.version = 2
                self.ncols, self.nrows, tn_len = struct.unpack_from(_V2_HEAD, buf, 4)
                offset = 4 + struct.calcsize(_V2_HEAD)
                self._type_names = (
                    bytes(buf[offset : offset + tn_len]).decode().split("\x00")
                    if tn_len else []
                )
                offset += tn_len
                self._has_dict = list(buf[offset : offset + self.ncols])
                offset += self.ncols
                self._lanes = list(struct.unpack_from(f"<{self.ncols}I", buf, offset))
                offset += 4 * self.ncols
                if len(self._type_names) != self.ncols:
                    raise ValueError(
                        f"corrupt v2 frame: {self.ncols} columns, "
                        f"{len(self._type_names)} type names"
                    )
            elif magic == MAGIC:
                self.version = 1
                self.ncols, self.nrows, _ = struct.unpack_from("<IQI", buf, 4)
                offset = 0  # v1 decode re-reads from the top
                self._type_names = self._has_dict = self._lanes = None
            else:
                raise ValueError("bad page frame magic")
        except struct.error as e:
            raise ValueError(f"truncated page frame: {e}") from None
        self.data = data
        self._body = offset

    @property
    def nbytes(self) -> int:
        return len(self.data)

    def to_page(self, capacity: Optional[int] = None, device=None) -> Page:
        """Decode to a Page on ``device`` (default ``cuda``), padded to
        ``capacity`` rows (v1 frames carry their own capacity)."""
        if self.version == 1:
            return deserialize_page(self.data, device=device)
        dev = resolve_device(device)
        buf = memoryview(self.data)
        offset = self._body
        raw_cols = []
        for _ in range(self.ncols):
            data_arr, offset = _decode_buffer(buf, offset)
            valid_arr, offset = _decode_buffer(buf, offset)
            raw_cols.append((data_arr, valid_arr))
        dictionaries: List[Optional[Dictionary]] = []
        for i in range(self.ncols):
            if self._has_dict[i]:
                dictionary, offset = _decode_dictionary(buf, offset)
                dictionaries.append(dictionary)
            else:
                dictionaries.append(None)
        n = self.nrows
        cap = max(capacity if capacity is not None else n, 1)
        cols = []
        for i, ((data_arr, valid_arr), tname) in enumerate(zip(raw_cols, self._type_names)):
            type_ = parse_type(tname)
            if self._lanes[i] or type_.storage_lanes is not None:
                unported("ops.int128 (multi-lane storage)")
            if len(data_arr) != n or len(valid_arr) != n:
                raise ValueError(
                    f"corrupt v2 frame: column {i} has {len(data_arr)} rows, header says {n}"
                )
            data = np.zeros(cap, dtype=type_.storage_dtype)
            data[:n] = data_arr
            valid = np.zeros(cap, dtype=np.bool_)
            valid[:n] = valid_arr
            cols.append(Column(type_, torch.from_numpy(data).to(dev),
                               torch.from_numpy(valid).to(dev), dictionaries[i]))
        active = np.zeros(cap, dtype=np.bool_)
        active[:n] = True
        return Page(tuple(cols), torch.from_numpy(active).to(dev))
