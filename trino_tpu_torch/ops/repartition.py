"""Device-side repartition epilogue: hash -> partition id -> stable sort.

The port's counterpart of the epilogue half of ``trino_tpu.ops.repartition``
(``partition_ids``, ``hash_key_columns``, ``_partition_dest`` and
``_repartition_epilogue``), as plain torch. Partition p's rows end up at
``[offsets[p], offsets[p] + counts[p])`` of the sorted page in their
original order, inactive rows after the last partition. The partition hash
is part of the exchange-frame contract, so it is bit-identical to the
reference's. ``hopper_kernels.partition_epilogue`` is the same function as
one CUDA kernel (``megakernels.fused_epilogue``).

The host path (:func:`repartition_frames`, :func:`repartition_to_host`)
turns a page into one v2 exchange frame per partition, with the
reference's two formulations: on a CUDA page the whole epilogue runs on the
card in ``partition_epilogue`` and one transfer brings the
partition-contiguous page to the host; on a CPU page the hash gives each
row's destination and the frames gather their rows on the host. Both give
the same frame bytes. A long decimal's two limbs ride both (v1 and v2
frames carry lanes).

A fused join or aggregation whose fragment feeds a hash exchange computes
each row's destination as its last stage (``hopper_kernels.partition_dest``)
and attaches it to the page (``megakernels.attach_epilogue``);
:func:`_take_fused_dest` consumes it once for the matching exchange spec.
On a CUDA page ``partition_epilogue`` then takes that destination and skips
its hash; on a CPU page the host formulation reads it. The reference's
flight-recorder spans around the epilogue are not ported.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import knobs
from ..spi.page import Column, Page, is_nested_column
from . import kernels as K

DEVICE_REPARTITION_ENV = "TRINO_TPU_DEVICE_REPARTITION"


def device_repartition_enabled() -> bool:
    """Env kill-switch (default on): off, :func:`repartition_frames` refuses
    a CUDA page, because the port keeps no host formulation on the card. A
    CPU page takes the host formulation with it off."""
    return knobs.env_flag(DEVICE_REPARTITION_ENV, True)

_GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15
_FMIX_1 = -49064778989728563  # 0xFF51AFD7ED558CCD
_FMIX_2 = -4265267296055464877  # 0xC4CEB9FE1A85EC53
_FNV_PRIME = 0x100000001B3


def _fmix64(x: torch.Tensor) -> torch.Tensor:
    """The 64-bit finalizer on int64 bits: wrapping multiplies and logical
    shifts give the same bits as the reference's uint64 arithmetic."""
    x = (x ^ K._shift_right_logical(x, 33)) * _FMIX_1
    x = (x ^ K._shift_right_logical(x, 33)) * _FMIX_2
    return x ^ K._shift_right_logical(x, 33)


def _unsigned_mod(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x`` read as uint64, modulo ``m`` (1 <= m < 2^31): torch's ``%`` is
    signed, so the top bit is split off. u = 2 * (u >> 1) + (u & 1), and
    both halves are non-negative int64."""
    half = K._shift_right_logical(x, 1) % m
    return (half * 2 + (x & 1)) % m


def partition_ids(key_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  num_partitions: int) -> torch.Tensor:
    """Row -> destination partition (the PagePartitioner hash), int32.

    ``key_cols`` are (data, valid) pairs: NULL keys hash as INT64_MAX, so
    the NULL group lands on one partition; floats hash through the
    ``order_key`` bit unfold. Per key the 64-bit finalizer, folded into an
    FNV-style accumulator; the result modulo ``num_partitions`` unsigned."""
    acc = None
    for d, v in key_cols:
        k = torch.where(v, K.order_key(d), K.INT64_MAX)
        x = _fmix64(k)
        acc = ((_GOLDEN if acc is None else acc) ^ x) * _FNV_PRIME
    if acc is None:
        raise ValueError("partition_ids: at least one key column")
    return _unsigned_mod(acc, num_partitions).to(torch.int32)


def map_value_keys(data: torch.Tensor, lut) -> torch.Tensor:
    """Dictionary codes -> content-stable value keys through ``lut`` (codes
    clipped into it); ``data`` unchanged when ``lut`` is None."""
    if lut is None:
        return data
    return lut[data.to(torch.int64).clamp(0, lut.shape[0] - 1)]


def hash_key_columns(cols: Sequence[Column]):
    """Columns -> (data, valid) pairs for partition hashing. Dictionary-coded
    columns map through their ``Dictionary.value_keys`` (codes are local to
    a dictionary, so two producers with different vocabularies would
    otherwise route one string to two partitions)."""
    out = []
    for c in cols:
        lut = None
        if c.dictionary is not None:
            lut = torch.as_tensor(c.dictionary.value_keys(), device=c.data.device)
        out.append((map_value_keys(c.data, lut), c.valid))
    return out


def dest_of(keys, active: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Partition id of each active row over hashed (data, valid) keys, and
    ``n_parts`` (the discard tail) for inactive rows; no keys hash one zero
    key, the host rule."""
    cap = active.shape[0]
    if not keys:
        keys = [(torch.zeros(cap, dtype=torch.int64, device=active.device),
                 torch.ones(cap, dtype=torch.bool, device=active.device))]
    target = partition_ids(keys, n_parts)
    return torch.where(active, target, torch.full_like(target, n_parts))


def supports_device_repartition(page: Page) -> bool:
    """Scalar and multi-lane (long decimal) columns ride the epilogue and
    the v2 frames; nested layouts (array/map/row: children, lengths) take
    the legacy per-partition path, as in the reference: the wire serde has
    no frame for them."""
    return not any(is_nested_column(c) for c in page.columns)


def _partition_dest(n_parts: int, key_idx: Tuple[int, ...], page: Page) -> torch.Tensor:
    """Per-row destination: the partition id of active rows, ``n_parts``
    for inactive ones."""
    keys = hash_key_columns([page.columns[i] for i in key_idx])
    return dest_of(keys, page.active, n_parts)


def sort_by_dest(dest: torch.Tensor, cols, active: torch.Tensor, n_parts: int):
    """(data, valid) columns and the activity sorted stably by ``dest``,
    with each partition's int64 offset and count: ``(cols_out, active_out,
    offsets, counts)``."""
    counts = torch.bincount(dest.to(torch.int64), minlength=n_parts + 1)[:n_parts]
    offsets = torch.cumsum(counts, 0) - counts
    perm = torch.sort(dest, stable=True).indices
    out: List[Tuple[torch.Tensor, torch.Tensor]] = [(d[perm], v[perm]) for d, v in cols]
    return out, active[perm], offsets, counts


def _repartition_epilogue(n_parts: int, key_idx: Tuple[int, ...], page: Page):
    """The in-program epilogue. Returns (sorted_page, offsets, counts):
    partition p's rows occupy ``sorted_page[offsets[p] : offsets[p] +
    counts[p]]`` in original relative order; inactive rows sort to the
    tail (destination ``n_parts``)."""
    dest = _partition_dest(n_parts, key_idx, page)
    cols, active, offsets, counts = sort_by_dest(
        dest, [(c.data, c.valid) for c in page.columns], page.active, n_parts
    )
    out = tuple(Column(c.type, d, v, c.dictionary) for c, (d, v) in zip(page.columns, cols))
    return Page(out, active), offsets, counts


def _take_fused_dest(page: Page, key_idx: Tuple[int, ...], n_parts: int):
    """The destination a fused join or aggregation attached to this page
    object for exactly this exchange spec (``megakernels.attach_epilogue``),
    or None. The attachment is popped: it is valid only for the page it was
    computed from."""
    payload = page.__dict__.pop("_megakernel_epilogue", None)
    if not payload:
        return None
    if payload.get("key_idx") != tuple(key_idx) or payload.get("n_parts") != n_parts:
        return None  # computed for another partitioning: hash again
    return payload.get("dest")


def repartition_frames(page: Page, key_idx: Sequence[int], n_parts: int, pool=None,
                       compress: bool = True):
    """Page -> one serialized v2 frame per partition and the row counts,
    ``(frames, counts)``.

    - CUDA page: the epilogue on the card (``partition_epilogue``, given
      the attached destination where a fused stage left one) and one
      transfer of the partition-contiguous page, then the frames are
      sliced out of it (``serde.serialize_page_slices``). With
      ``TRINO_TPU_DEVICE_REPARTITION`` off it raises: there is no plain
      fallback on the card.
    - CPU page: the attached destination or the hash gives each row's
      destination, then gather and encode run per partition
      (``serde.serialize_page_partitions``).

    The frame bytes are the same either way."""
    from ..runtime.serde import serialize_page_partitions, serialize_page_slices

    key_idx = tuple(key_idx)
    on_card = page.device.type == "cuda"
    if on_card and not device_repartition_enabled():
        raise RuntimeError(f"{DEVICE_REPARTITION_ENV}=0, but a CUDA page has no other "
                           "repartition formulation than the partition_epilogue kernel")
    fused = _take_fused_dest(page, key_idx, n_parts)
    if on_card:
        cols, offsets, counts = repartition_to_host(page, key_idx, n_parts, dest=fused)
        return serialize_page_slices(cols, offsets, counts, compress=compress, pool=pool), counts
    dest = (fused if fused is not None else _partition_dest(n_parts, key_idx, page)).numpy()
    host_cols = [(c.type, c.data.numpy(), c.valid.numpy(), c.dictionary) for c in page.columns]
    return serialize_page_partitions(host_cols, dest, n_parts, compress=compress, pool=pool)


def repartition_to_host(page: Page, key_idx: Sequence[int], n_parts: int, dest=None):
    """The accelerator formulation: the epilogue's partition-contiguous page
    on the host, ``(cols, offsets, counts)``, ``cols`` a host chunk whose
    rows ``[offsets[p], offsets[p] + counts[p])`` are partition p's in their
    original order (int64 numpy offsets and counts of length ``n_parts``;
    the chunk holds the live rows only). ``megakernels.fused_epilogue`` runs
    the epilogue (on a CUDA page the ``partition_epilogue`` kernel: hash,
    stable sort by destination, offsets and counts on the card; on a CPU
    page its plain version), then the counts are read, every column's live
    rows copied out (into pinned memory from the card) and one wait.
    ``dest``: each row's destination, where a fused stage computed it."""
    from . import megakernels as MK

    sorted_page, offsets, counts = MK.fused_epilogue(page, tuple(key_idx), n_parts, dest=dest)
    counts_h = counts.cpu().numpy()
    n = int(counts_h.sum())
    pin = page.device.type == "cuda"
    outs = []
    for c in sorted_page.columns:
        pair = []
        for t in (c.data, c.valid):
            h = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype, pin_memory=pin)
            h.copy_(t[:n], non_blocking=pin)
            pair.append(h)
        outs.append((c, pair))
    offsets_h = offsets.cpu().numpy()  # waits for the copies queued above
    cols = [(c.type, d.numpy(), v.numpy(), c.dictionary) for c, (d, v) in outs]
    return cols, offsets_h, counts_h
