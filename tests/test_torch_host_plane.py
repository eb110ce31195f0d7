"""The port's host data plane against the reference's, on the CPU.

- The native LZ4 codec and checksum (``trino_tpu_torch.native``) against
  their pure-Python plain versions both ways, and against the reference's
  native build: the same bytes.
- ``serialize_page`` (v1), ``serialize_page_slices`` and
  ``serialize_page_partitions`` (v2) give bytes identical to the
  reference's for pages built from the same numpy columns (bigint,
  integer, decimal, date, boolean, double, dictionary strings, NULLs), and
  each engine reads the other's frames back.
- ``host_partition_targets`` gives the reference's buckets, with two
  chunks of different dictionaries, NULL keys and -0.0 / NaN float keys;
  the device hash (``ops/repartition.partition_ids``) the same bits.
- ``page_from_host_chunks`` merges dictionaries like the reference.
- ``repartition_frames`` on a CPU page gives the reference's frame bytes,
  and the accelerator formulation (``repartition_to_host``, the plain
  epilogue on the CPU) the same frames; a CUDA page with the device
  repartition switched off is refused, not sent down a host path.
- The LZ4 spill files are the reference's bytes and read back.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from trino_tpu import native as ref_native
from trino_tpu.ops import repartition as ref_repart
from trino_tpu.runtime import serde as ref_serde
from trino_tpu.spi import host_pages as ref_hp
from trino_tpu.spi import page as ref_page
from trino_tpu.spi import types as ref_types

from trino_tpu_torch import native
from trino_tpu_torch.ops import repartition as R
from trino_tpu_torch.runtime import serde
from trino_tpu_torch.runtime.memory import page_bytes
from trino_tpu_torch.spi import host_pages as hp
from trino_tpu_torch.spi import page as port_page
from trino_tpu_torch.spi import types as port_types


def _payloads():
    rng = np.random.default_rng(3)
    return {
        "empty": b"",
        "one byte": b"a",
        "short repeat": b"abcd" * 3,
        "long run": b"x" * 5000,
        "low entropy": rng.integers(0, 4, 20000, dtype=np.uint8).tobytes(),
        "int64 column": np.sort(rng.integers(0, 1000, 4000)).astype(np.int64).tobytes(),
        "random": rng.integers(0, 256, 3001, dtype=np.uint8).tobytes(),
        "long literal then match": rng.integers(0, 256, 300, dtype=np.uint8).tobytes() * 3,
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_lz4_native_against_plain_both_ways(name):
    data = PAYLOADS[name]
    comp = native.lz4_compress(data)
    assert comp == native.lz4_compress_plain(data) == ref_native.lz4_compress(data)
    assert native.lz4_decompress_plain(comp, len(data)) == data
    assert native.lz4_decompress(native.lz4_compress_plain(data), len(data)) == data
    assert native.hash64(data) == native.hash64_plain(data) == ref_native.hash64(data)


def test_lz4_corrupt_frame_raises_in_both():
    data = PAYLOADS["low entropy"]
    comp = bytearray(native.lz4_compress(data))
    comp[len(comp) // 2] ^= 0xFF
    comp = bytes(comp[: len(comp) - 3])
    with pytest.raises(ValueError):
        native.lz4_decompress(comp, len(data))
    with pytest.raises(ValueError):
        native.lz4_decompress_plain(comp, len(data))


# --------------------------------------------------------------------------- #
# pages built from the same numpy columns on both sides
# --------------------------------------------------------------------------- #

N = 3000
CAP = 4096
SCHEMA = ("bigint", "integer", "decimal(12,2)", "date", "boolean", "double", "varchar")


def _columns(seed: int, vocab=("AIR", "MAIL", "RAIL", "SHIP", "TRUCK")):
    rng = np.random.default_rng(seed)
    datas = [
        rng.integers(-(2**62), 2**62, N),
        rng.integers(-1000, 1000, N).astype(np.int32),
        rng.integers(0, 10**7, N),
        rng.integers(8000, 10000, N).astype(np.int32),
        rng.random(N) < 0.5,
        np.where(rng.random(N) < 0.1, -0.0, rng.normal(size=N)),
        rng.integers(0, len(vocab), N).astype(np.int32),
    ]
    datas[5][::97] = np.nan
    valids = [rng.random(N) < 0.9 for _ in datas]
    active = rng.random(N) < 0.8
    return datas, valids, active, list(vocab)


def _ref_page(datas, valids, active, vocab):
    rdict = ref_page.Dictionary(np.asarray(vocab, dtype=object))
    cols = tuple(
        ref_page.Column.from_numpy(ref_types.parse_type(t), d, v, CAP,
                                   rdict if t == "varchar" else None)
        for t, d, v in zip(SCHEMA, datas, valids)
    )
    act = np.zeros(CAP, dtype=bool)
    act[:N] = active
    return ref_page.Page(cols, jnp.asarray(act))


def _port_page(datas, valids, active, vocab):
    pdict = port_page.Dictionary(np.asarray(vocab, dtype=object))
    return port_page.page_from_numpy(
        [port_types.parse_type(t) for t in SCHEMA], datas, valids, active,
        [pdict if t == "varchar" else None for t in SCHEMA], capacity=CAP, device="cpu",
    )


@pytest.fixture(scope="module")
def pages():
    cols = _columns(11)
    return _ref_page(*cols), _port_page(*cols)


def _rows(page) -> str:
    """A page's rows as text: NaN equals NaN, -0.0 differs from 0.0."""
    return repr(page.to_pylist())


def _host_cols(page, to_np):
    return [(c.type, to_np(c.data), to_np(c.valid), c.dictionary) for c in page.columns]


@pytest.mark.parametrize("compress", [True, False])
def test_serialize_page_v1_bytes_identical(pages, compress):
    ref, port = pages
    ours = serde.serialize_page(port, compress=compress)
    assert ours == ref_serde.serialize_page(ref, compress=compress)
    back = serde.deserialize_page(ours, device="cpu")
    assert _rows(back) == _rows(port)
    assert back.capacity == CAP


def test_v2_slices_and_partitions_bytes_identical(pages):
    ref, port = pages
    rng = np.random.default_rng(5)
    dest = np.where(np.asarray(ref.active), rng.integers(0, 6, CAP), 6)
    ref_cols = _host_cols(ref, np.asarray)
    port_cols = _host_cols(port, lambda t: t.numpy())
    want, want_counts = ref_serde.serialize_page_partitions(ref_cols, dest, 6)
    got, got_counts = serde.serialize_page_partitions(port_cols, dest, 6)
    assert got == want
    np.testing.assert_array_equal(got_counts, want_counts)
    order = np.concatenate([np.flatnonzero(dest == p) for p in range(6)])
    offsets = np.concatenate([[0], np.cumsum(want_counts)[:-1]])
    sliced = [(t, d[order], v[order], dc) for t, d, v, dc in port_cols]
    assert serde.serialize_page_slices(sliced, offsets, want_counts) == want
    # each engine reads the other's frames: the same rows
    for frame, ref_frame in zip(got, want):
        lazy = serde.LazyPageFrame(ref_frame)
        mine = lazy.to_page(capacity=_pow2(lazy.nrows), device="cpu")
        theirs = ref_serde.LazyPageFrame(frame).to_page()
        assert _rows(mine) == _rows(theirs)
        assert mine.capacity == _pow2(lazy.nrows)


def _pow2(n):
    cap = 1
    while cap < max(n, 1):
        cap *= 2
    return cap


def test_bad_frames_raise(pages):
    _, port = pages
    frame = serde.serialize_page(port)
    with pytest.raises(ValueError, match="magic"):
        serde.deserialize_page(b"XXXX" + frame[4:], device="cpu")
    with pytest.raises(ValueError, match="truncated|checksum|corrupt"):
        serde.deserialize_page(frame[: len(frame) // 2], device="cpu")


def test_page_bytes_matches_reference(pages):
    from trino_tpu.runtime.memory import page_bytes as ref_page_bytes

    ref, port = pages
    assert page_bytes(port) == ref_page_bytes(ref)


# --------------------------------------------------------------------------- #
# bucket targets
# --------------------------------------------------------------------------- #


def _both_chunks(seed, vocab):
    datas, valids, active, vocab = _columns(seed, vocab)
    ref = ref_hp.page_to_host(_ref_page(datas, valids, active, vocab))
    port = hp.page_to_host(_port_page(datas, valids, active, vocab))
    return ref, port


@pytest.fixture(scope="module")
def chunk_pairs():
    # two producers with different vocabularies: the same strings get
    # different codes, and one string exists in one vocabulary only
    return [_both_chunks(21, ("AIR", "MAIL", "RAIL", "SHIP", "TRUCK")),
            _both_chunks(22, ("FOB", "MAIL", "REG AIR", "SHIP"))]


def test_page_to_host_matches_reference(chunk_pairs):
    for ref, port in chunk_pairs:
        assert len(ref) == len(port)
        for (rt, rd, rv, rdc), (pt, pd, pv, pdc) in zip(ref, port):
            assert rt.display() == pt.display()
            np.testing.assert_array_equal(pd, rd)
            np.testing.assert_array_equal(pv, rv)
            assert (rdc is None) == (pdc is None)


@pytest.mark.parametrize("key_idx", [[0], [1, 6], [5], [6], [2, 3, 4], []],
                         ids=["bigint", "int+varchar", "double", "varchar", "three", "nokey"])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_host_partition_targets_identical(chunk_pairs, key_idx, n):
    for ref, port in chunk_pairs:
        np.testing.assert_array_equal(
            hp.host_partition_targets(port, key_idx, n),
            ref_hp.host_partition_targets(ref, key_idx, n),
        )


def test_same_string_same_bucket_across_dictionaries(chunk_pairs):
    """MAIL and SHIP have different codes in the two chunks but one bucket."""
    (_, a), (_, b) = chunk_pairs
    ta, tb = (hp.host_partition_targets(c, [6], 64) for c in (a, b))
    for s in ("MAIL", "SHIP"):
        ca, cb = a[6][3].code_of(s), b[6][3].code_of(s)
        ra = ta[(a[6][1] == ca) & a[6][2]]
        rb = tb[(b[6][1] == cb) & b[6][2]]
        assert len(set(ra) | set(rb)) == 1


def test_float_keys_negative_zero_and_nan():
    d = np.array([0.0, -0.0, np.nan, -np.nan, 1.5, -1.5, np.inf, -np.inf])
    v = np.array([True] * 7 + [False])
    for n in (3, 64):
        want = ref_hp.hash_partition_host([(d, v)], n)
        np.testing.assert_array_equal(hp.hash_partition_host([(d, v)], n), want)
        dev = R.partition_ids([(torch.from_numpy(d), torch.from_numpy(v))], n)
        np.testing.assert_array_equal(dev.numpy(), want)


@pytest.mark.parametrize("n", [2, 64, 1024])
def test_device_hash_bit_identical_to_host_targets(chunk_pairs, n):
    """The port's int64 device hash and the numpy uint64 host rule agree on
    every row, dictionary keys through their value keys."""
    _, port = chunk_pairs[0]
    keys = [0, 5, 6]
    want = hp.host_partition_targets(port, keys, n)
    lut = torch.from_numpy(port[6][3].value_keys())
    cols = [(torch.from_numpy(port[i][1]), torch.from_numpy(port[i][2])) for i in keys]
    cols[2] = (R.map_value_keys(cols[2][0], lut), cols[2][1])
    np.testing.assert_array_equal(R.partition_ids(cols, n).numpy(), want)


def test_value_keys_match_reference():
    vocab = np.asarray(["", "a", "Customer#000000001", "ÿ", "MAIL"], dtype=object)
    np.testing.assert_array_equal(port_page.Dictionary(vocab).value_keys(),
                                  ref_page.Dictionary(vocab).value_keys())


# --------------------------------------------------------------------------- #
# merging chunks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("capacity", [None, 8192])
def test_page_from_host_chunks_merges_like_reference(chunk_pairs, capacity):
    ref = ref_hp.page_from_host_chunks([r for r, _ in chunk_pairs], capacity=capacity)
    port = hp.page_from_host_chunks([p for _, p in chunk_pairs], capacity=capacity,
                                    device="cpu")
    assert port.capacity == ref.capacity
    np.testing.assert_array_equal(port.active.numpy(), np.asarray(ref.active))
    for rc, pc in zip(ref.columns, port.columns):
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(rc.data))
        np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(rc.valid))
        if rc.dictionary is not None:
            assert list(pc.dictionary.values) == list(rc.dictionary.values)
    assert _rows(port) == _rows(ref)


def test_pages_from_host_rows_and_empty_page(chunk_pairs):
    ref, port = chunk_pairs[0]
    sel = np.arange(len(port[0][1])) % 3 == 0
    got = hp.pages_from_host_rows(port, sel, device="cpu")
    assert _rows(got) == _rows(ref_hp.pages_from_host_rows(ref, sel))
    types = {"a": port_types.parse_type("bigint"), "s": port_types.parse_type("varchar")}
    empty = hp.empty_page_for(("a", "s"), types, device="cpu")
    assert empty.capacity == 1 and not bool(empty.active.any())
    assert empty.columns[1].dictionary is port_page.Dictionary.empty()


# --------------------------------------------------------------------------- #
# repartition frames
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("key_idx,n_parts", [((0,), 8), ((6,), 4), ((1, 6), 64), ((5,), 3),
                                             ((), 8)])
def test_repartition_frames_match_reference(pages, key_idx, n_parts):
    ref, port = pages
    want, want_counts = ref_repart.repartition_frames(ref, key_idx, n_parts)
    got, got_counts = R.repartition_frames(port, key_idx, n_parts)
    assert got == want
    np.testing.assert_array_equal(got_counts, want_counts)
    # the accelerator formulation (the epilogue, then slicing) gives the
    # same frames: here through the plain epilogue, on the card the kernel
    cols, offsets, counts = R.repartition_to_host(port, key_idx, n_parts)
    np.testing.assert_array_equal(counts, want_counts)
    assert serde.serialize_page_slices(cols, offsets, counts) == want


def test_card_page_refused_without_device_repartition(monkeypatch):
    """TRINO_TPU_DEVICE_REPARTITION=0 on a CUDA page raises before any work:
    the card has no formulation but the ``partition_epilogue`` kernel."""
    from types import SimpleNamespace

    monkeypatch.setenv("TRINO_TPU_DEVICE_REPARTITION", "0")
    card_page = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="partition_epilogue"):
        R.repartition_frames(card_page, (0,), 8)


# --------------------------------------------------------------------------- #
# spill files
# --------------------------------------------------------------------------- #


def test_spill_files_identical_and_round_trip(tmp_path, chunk_pairs):
    from trino_tpu_torch.runtime.spiller import io_pool

    _, port = chunk_pairs[0]
    arrays = [c[1] for c in port] + [c[2] for c in port] + [np.zeros(3, dtype=np.int8)]
    mine, theirs = str(tmp_path / "mine.lz4"), str(tmp_path / "theirs.lz4")
    hp.write_arrays_lz4(mine, arrays, pool=io_pool())
    ref_hp.write_arrays_lz4(theirs, arrays)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for back in (hp.read_arrays_lz4(mine), hp.read_arrays_lz4(theirs, pool=io_pool())):
        for a, b in zip(arrays, back):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_spiller_parks_largest_pages_and_loads_them_back(pages):
    from trino_tpu_torch.runtime.spiller import Spiller

    _, port = pages
    small = port_page.Page(tuple(port.columns[:1]), port.active)
    sp = Spiller(trigger_bytes=page_bytes(small) + 1)
    out = sp.maybe_spill([small, port])
    assert out[0] is small and out[1] is not port
    assert sp.spill_count == 1 and sp.spilled_bytes == page_bytes(port)
    assert _rows(Spiller.load(out[1], device="cpu")) == _rows(port)
    assert Spiller().maybe_spill([port])[0] is port


# --------------------------------------------------------------------------- #
# digests (TDIGEST and QDIGEST: [cap, 128] float64 lanes) in the frames
# --------------------------------------------------------------------------- #

DIGEST_SCHEMA = ("bigint", "tdigest", "qdigest(bigint)")


@pytest.fixture(scope="module")
def digest_pages():
    """Both packages' pages of a key and two digests (means then weights)."""
    rng = np.random.default_rng(23)

    def lanes():
        d = np.zeros((N, 128))
        d[:, :64] = rng.normal(50.0, 20.0, (N, 64))
        d[:, 64:] = rng.integers(0, 6, (N, 64))
        return d

    datas = [rng.integers(0, 10**6, N), lanes(), lanes()]
    valids = [rng.random(N) < 0.9 for _ in datas]
    active = rng.random(N) < 0.8
    cols = tuple(ref_page.Column.from_numpy(ref_types.parse_type(t), d, v, CAP)
                 for t, d, v in zip(DIGEST_SCHEMA, datas, valids))
    act = np.zeros(CAP, dtype=bool)
    act[:N] = active
    port = port_page.page_from_numpy([port_types.parse_type(t) for t in DIGEST_SCHEMA], datas,
                                     valids, active, capacity=CAP, device="cpu")
    return ref_page.Page(cols, jnp.asarray(act)), port


@pytest.mark.parametrize("compress", [True, False])
def test_digest_page_v1_bytes_identical(digest_pages, compress):
    """A digest column travels as its lanes in the reference's v1 frame and
    comes back with its lane axis (the rows decode as the digest's
    summary)."""
    ref, port = digest_pages
    ours = serde.serialize_page(port, compress=compress)
    assert ours == ref_serde.serialize_page(ref, compress=compress)
    back = serde.deserialize_page(ours, device="cpu")
    assert [tuple(c.data.shape) for c in back.columns] == [(CAP,), (CAP, 128), (CAP, 128)]
    assert _rows(back) == _rows(port) == _rows(ref)
    for a, b in zip(back.columns, port.columns):
        assert torch.equal(a.data, b.data) and torch.equal(a.valid, b.valid)


def test_digest_page_v2_partitions_bytes_identical(digest_pages):
    ref, port = digest_pages
    rng = np.random.default_rng(7)
    dest = np.where(np.asarray(ref.active), rng.integers(0, 4, CAP), 4)
    want, want_counts = ref_serde.serialize_page_partitions(_host_cols(ref, np.asarray), dest, 4)
    got, got_counts = serde.serialize_page_partitions(_host_cols(port, lambda t: t.numpy()),
                                                      dest, 4)
    assert got == want
    np.testing.assert_array_equal(got_counts, want_counts)
    for frame in got:
        lazy = serde.LazyPageFrame(frame)
        mine = lazy.to_page(capacity=_pow2(lazy.nrows), device="cpu")
        assert _rows(mine) == _rows(ref_serde.LazyPageFrame(frame).to_page())


def test_digest_page_spills_and_loads_back(digest_pages):
    from trino_tpu_torch.runtime.spiller import Spiller

    _, port = digest_pages
    sp = Spiller(trigger_bytes=1)
    out = sp.maybe_spill([port])
    assert sp.spill_count == 1 and out[0] is not port
    back = Spiller.load(out[0], device="cpu")
    for a, b in zip(back.columns, port.columns):
        assert torch.equal(a.data, b.data) and torch.equal(a.valid, b.valid)
