"""Host LZ4 block codec and the frame checksum, in C++ loaded with ctypes.

The port's counterpart of ``trino_tpu.native``: ``pageserde.cpp`` is the
reference's source, unchanged, so compressed payloads and checksums are the
same bytes. It is compiled with ``g++`` at first use into
``trino_tpu_torch/_build/native/`` (keyed on a hash of the source and the
flags). Unlike the reference, which falls back to uncompressed frames when
the build fails, a failed build raises: frames must be byte-identical to the
reference's, and those are compressed.

``lz4_compress_plain``, ``lz4_decompress_plain`` and ``hash64_plain`` are
the same functions in pure Python (the same greedy single-probe compressor,
so the same bytes): the plain versions the tests hold the native ones
against. They are slow and are used nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "pageserde.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
# no -march=native: the build directory may be copied to another machine
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile ``pageserde.cpp`` and return the library's path; a library
    built from the same source and flags is reused. Raises when ``g++``
    fails or is missing."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"_pageserde-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise RuntimeError(f"g++ could not run to build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            for name in ("lz4_compress", "lz4_decompress"):
                fn = getattr(lib, name)
                fn.restype = i64
                fn.argtypes = [ctypes.c_char_p, i64, ptr, i64]
            lib.lz4_max_compressed.restype = i64
            lib.lz4_max_compressed.argtypes = [i64]
            lib.hash64.restype = ctypes.c_uint64
            lib.hash64.argtypes = [ctypes.c_char_p, i64]
            _LIB = lib
        return _LIB


def lz4_compress(data: bytes) -> bytes:
    lib = get_lib()
    n = len(data)
    cap = lib.lz4_max_compressed(n)
    dst = ctypes.create_string_buffer(cap)
    written = lib.lz4_compress(data, n, dst, cap)
    if written < 0:
        raise RuntimeError("lz4_compress failed")
    return dst.raw[:written]


def lz4_decompress(data: bytes, raw_len: int) -> bytes:
    lib = get_lib()
    dst = ctypes.create_string_buffer(raw_len)
    written = lib.lz4_decompress(data, len(data), dst, raw_len)
    if written != raw_len:
        raise ValueError(f"lz4_decompress: corrupt frame ({written} != {raw_len})")
    return dst.raw


def hash64(data: bytes) -> int:
    return int(get_lib().hash64(data, len(data)))


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

_M64 = (1 << 64) - 1


def _literals_header(out: bytearray, token_at: int, lit_len: int) -> None:
    if lit_len >= 15:
        out[token_at] = 0xF0
        rest = lit_len - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    else:
        out[token_at] = lit_len << 4


def lz4_compress_plain(data: bytes) -> bytes:
    """``lz4_compress`` in Python: a 4,096-entry table of the last position
    of each 4-byte sequence's hash, one probe, greedy forward extension."""
    src = bytes(data)
    n = len(src)
    out = bytearray()
    table = [-1] * (1 << 12)
    anchor = i = 0
    while i + 12 <= n:
        seq = int.from_bytes(src[i:i + 4], "little")
        h = ((seq * 2654435761) & 0xFFFFFFFF) >> 20
        cand = table[h]
        table[h] = i
        if cand >= 0 and i - cand <= 65535 and src[cand:cand + 4] == src[i:i + 4]:
            m, c = i + 4, cand + 4
            while m < n - 5 and src[m] == src[c]:
                m += 1
                c += 1
            token_at = len(out)
            out.append(0)
            _literals_header(out, token_at, i - anchor)
            out += src[anchor:i]
            off = i - cand
            out += bytes((off & 0xFF, off >> 8))
            ml = m - i - 4
            if ml >= 15:
                out[token_at] |= 0x0F
                ml -= 15
                while ml >= 255:
                    out.append(255)
                    ml -= 255
                out.append(ml)
            else:
                out[token_at] |= ml
            i = anchor = m
        else:
            i += 1
    token_at = len(out)
    out.append(0)
    _literals_header(out, token_at, n - anchor)
    out += src[anchor:]
    return bytes(out)


def lz4_decompress_plain(data: bytes, raw_len: int) -> bytes:
    """``lz4_decompress`` in Python; raises on a corrupt frame."""
    src = bytes(data)
    out = bytearray()
    ip, n = 0, len(src)
    while ip < n:
        token = src[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise ValueError("lz4_decompress: corrupt frame")
                b = src[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n or len(out) + lit > raw_len:
            raise ValueError("lz4_decompress: corrupt frame")
        out += src[ip:ip + lit]
        ip += lit
        if ip >= n:
            break
        if ip + 2 > n:
            raise ValueError("lz4_decompress: corrupt frame")
        off = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if off == 0 or len(out) < off:
            raise ValueError("lz4_decompress: corrupt frame")
        ml = token & 0x0F
        if ml == 15:
            while True:
                if ip >= n:
                    raise ValueError("lz4_decompress: corrupt frame")
                b = src[ip]
                ip += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        if len(out) + ml > raw_len:
            raise ValueError("lz4_decompress: corrupt frame")
        start = len(out) - off
        for k in range(ml):  # overlapping copy, byte by byte
            out.append(out[start + k])
    if len(out) != raw_len:
        raise ValueError(f"lz4_decompress: corrupt frame ({len(out)} != {raw_len})")
    return bytes(out)


def hash64_plain(data: bytes) -> int:
    """``hash64`` in Python: a 64-bit mix over 8-byte lanes."""
    src = bytes(data)
    n = len(src)
    acc = 0x9E3779B97F4A7C15 ^ n
    i = 0
    while i + 8 <= n:
        lane = (int.from_bytes(src[i:i + 8], "little") * 0xC2B2AE3D27D4EB4F) & _M64
        lane = ((lane << 31) | (lane >> 33)) & _M64
        acc = ((acc ^ lane) * 0x9E3779B185EBCA87 + 0x165667B19E3779F9) & _M64
        i += 8
    if i < n:
        tail = int.from_bytes(src[i:], "little")
        acc = ((acc ^ tail) * 0xC2B2AE3D27D4EB4F) & _M64
    acc ^= acc >> 29
    acc = (acc * 0xBF58476D1CE4E5B9) & _M64
    acc ^= acc >> 32
    return acc
