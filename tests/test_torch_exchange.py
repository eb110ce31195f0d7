"""The exchange destination stage and the exchange frames of the port
(``trino_tpu_torch.ops.megakernels``, ``ops/repartition.py``,
``runtime/serde.py``) against the reference's.

- The destination stage (``epi_spec``) of ``expand_phase`` and
  ``aggregate_phase`` against the reference's Pallas phases in interpret
  mode, as ``tests/test_torch_megakernels.py`` runs them: BIGINT,
  dictionary VARCHAR and DOUBLE keys with NULLs, 2 to 8 partitions, every
  row's destination bit for bit.
- ``attach_epilogue`` / ``reattach_epilogue`` across an output rewrap that
  reorders the columns.
- ``repartition_frames`` given an attached destination: the same bytes as
  without one, as the device formulation's, and as the reference's.
- DECIMAL(38,2) columns (two int64 limbs a row, NULLs, negative values) in
  v1 and v2 frames byte-identical to the reference's, and host chunks that
  round-trip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import megakernels as RMK
from trino_tpu.spi.page import Column as RColumn
from trino_tpu.spi.page import Dictionary as RDict
from trino_tpu.spi.page import Page as RPage
from trino_tpu.spi import types as rt

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as PMK
from trino_tpu_torch.ops import repartition as PR
from trino_tpu_torch.spi.page import Column as PColumn
from trino_tpu_torch.spi.page import Dictionary as PDict
from trino_tpu_torch.spi.page import Page as PPage
from trino_tpu_torch.spi import types as pt

_VOCAB = np.asarray(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "FOB", "REG AIR"], dtype=object)
_DOUBLES = np.array([-0.0, 0.0, -1.5, 2.25, np.nan, -np.inf, 1e300, -3e-300, 7.0])


def _join_case(seed, n=1500, m=700, key_range=120):
    """Probe and build pages of both packages: a bigint join key with
    NULLs on each side; the probe carries a dictionary varchar and a double
    (NULLs, -0.0, NaN), the build a bigint payload."""
    rng = np.random.default_rng(seed)
    pk, pkv = rng.integers(0, key_range, n), rng.random(n) < 0.9
    bk, bkv = rng.integers(0, key_range, m), rng.random(m) < 0.9
    code, cv = rng.integers(0, len(_VOCAB), n).astype(np.int32), rng.random(n) < 0.85
    dbl, dv = _DOUBLES[rng.integers(0, len(_DOUBLES), n)], rng.random(n) < 0.85
    pay, pa, ba = rng.integers(-(2**40), 2**40, m), rng.random(n) < 0.8, rng.random(m) < 0.7
    ones_m = np.ones(m, bool)
    rprobe = RPage((RColumn(rt.BIGINT, jnp.asarray(pk), jnp.asarray(pkv)),
                    RColumn(rt.VARCHAR, jnp.asarray(code), jnp.asarray(cv), RDict(_VOCAB)),
                    RColumn(rt.DOUBLE, jnp.asarray(dbl), jnp.asarray(dv))), jnp.asarray(pa))
    rbuild = RPage((RColumn(rt.BIGINT, jnp.asarray(bk), jnp.asarray(bkv)),
                    RColumn(rt.BIGINT, jnp.asarray(pay), jnp.asarray(ones_m))), jnp.asarray(ba))
    t = torch.from_numpy
    pprobe = PPage((PColumn(pt.BIGINT, t(pk), t(pkv)),
                    PColumn(pt.VARCHAR, t(code), t(cv), PDict(_VOCAB)),
                    PColumn(pt.DOUBLE, t(dbl), t(dv))), t(pa))
    pbuild = PPage((PColumn(pt.BIGINT, t(bk), t(bkv)),
                    PColumn(pt.BIGINT, t(pay), t(ones_m))), t(ba))
    return rprobe, rbuild, pprobe, pbuild


# joined page: probe key 0, varchar 1, double 2, build key 3, build payload 4
EPI_KEYS = {"bigint": (0,), "varchar": (1,), "double": (2,), "varchar_double_bigint": (1, 2, 4),
            "build_key": (3,)}


@pytest.mark.parametrize("n_parts", [2, 3, 8])
@pytest.mark.parametrize("keys", sorted(EPI_KEYS))
def test_expand_phase_destination_matches_reference(keys, n_parts):
    rprobe, rbuild, pprobe, pbuild = _join_case(seed=40 + n_parts)
    rk = ((rprobe.columns[0].data, rprobe.columns[0].valid),)
    rb = ((rbuild.columns[0].data, rbuild.columns[0].valid),)
    pkeys = ((pprobe.columns[0].data, pprobe.columns[0].valid),)
    bkeys = ((pbuild.columns[0].data, pbuild.columns[0].valid),)
    want_pr = RMK.probe_phase(rk, rb, (None,), rprobe.active, rbuild.active, False, True)
    got_pr = PMK.probe_phase(pkeys, bkeys, (None,), pprobe.active, pbuild.active, False)
    cap = max(int(np.asarray(want_pr["emit"]).sum()), 1) + 7
    symbols = ("pk", "mode", "price", "bk", "pay")
    epi_spec = (EPI_KEYS[keys], n_parts)
    want, want_dest = RMK.expand_phase(want_pr, rk, rb, (None,), rprobe, rbuild, cap, symbols,
                                       None, None, epi_spec, True)
    before = (HK.LAUNCHES["hash_expand"], HK.LAUNCHES["partition_dest"], PMK.STAGES["dest"],
              PMK.STAGES["dest_expand"])
    got, got_dest = PMK.expand_phase(got_pr, pkeys, bkeys, (None,), pprobe, pbuild, cap,
                                     symbols, None, None, epi_spec)
    # the destination is folded into hash_expand's slot pass; a CPU page
    # runs the plain version, so no kernel launch is counted
    assert (HK.LAUNCHES["hash_expand"], HK.LAUNCHES["partition_dest"], PMK.STAGES["dest"],
            PMK.STAGES["dest_expand"]) == before[:3] + (before[3] + 1,)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert got_dest.dtype == torch.int32
    np.testing.assert_array_equal(got_dest.numpy(), np.asarray(want_dest))
    assert set(np.unique(got_dest.numpy())) <= set(range(n_parts + 1))


@pytest.mark.parametrize("n_parts", [3, 8])
@pytest.mark.parametrize("keys", sorted(EPI_KEYS))
def test_left_outer_expand_phase_destination_matches_reference(keys, n_parts):
    """A LEFT join's destination: unmatched probe rows carry NULL build
    columns (and the build side has NULL keys of its own), which the folded
    stage hashes as NULL, as the reference does."""
    rprobe, rbuild, pprobe, pbuild = _join_case(seed=60 + n_parts, key_range=300)
    rk = ((rprobe.columns[0].data, rprobe.columns[0].valid),)
    rb = ((rbuild.columns[0].data, rbuild.columns[0].valid),)
    pkeys = ((pprobe.columns[0].data, pprobe.columns[0].valid),)
    bkeys = ((pbuild.columns[0].data, pbuild.columns[0].valid),)
    want_pr = RMK.probe_phase(rk, rb, (None,), rprobe.active, rbuild.active, True, True)
    got_pr = PMK.probe_phase(pkeys, bkeys, (None,), pprobe.active, pbuild.active, True)
    cap = max(int(np.asarray(want_pr["emit"]).sum()), 1) + 5
    symbols = ("pk", "mode", "price", "bk", "pay")
    epi_spec = (EPI_KEYS[keys], n_parts)
    want, want_dest = RMK.expand_phase(want_pr, rk, rb, (None,), rprobe, rbuild, cap, symbols,
                                       None, None, epi_spec, True)
    before = PMK.STAGES["dest_expand"], PMK.STAGES["dest"]
    got, got_dest = PMK.expand_phase(got_pr, pkeys, bkeys, (None,), pprobe, pbuild, cap,
                                     symbols, None, None, epi_spec)
    assert (PMK.STAGES["dest_expand"], PMK.STAGES["dest"]) == (before[0] + 1, before[1])
    act = np.asarray(want.active)
    np.testing.assert_array_equal(got.active.numpy(), act)
    # unmatched probe rows: the build key is NULL on some active slots
    assert (act & ~got.columns[3].valid.numpy()).any()
    np.testing.assert_array_equal(got_dest.numpy(), np.asarray(want_dest))


def _sorted_agg_pages(seed, n=3000):
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, 400, n))
    kvalid = rng.random(n) < 0.95
    vals = rng.integers(-(10**10), 10**10, n)
    vvalid = rng.random(n) < 0.9
    active = rng.random(n) < 0.85
    dec_r, dec_p = rt.parse_type("decimal(12,2)"), pt.parse_type("decimal(12,2)")
    rpage = RPage((RColumn(rt.BIGINT, jnp.asarray(key), jnp.asarray(kvalid)),
                   RColumn(dec_r, jnp.asarray(vals), jnp.asarray(vvalid))), jnp.asarray(active))
    t = torch.from_numpy
    ppage = PPage((PColumn(pt.BIGINT, t(key), t(kvalid)), PColumn(dec_p, t(vals), t(vvalid))),
                  t(active))
    return rpage, ppage


@pytest.mark.parametrize("n_parts", [2, 5, 8])
def test_aggregate_phase_destination_matches_reference(n_parts):
    from trino_tpu.planner import plan as rplan
    from trino_tpu.runtime import executor as rex
    from trino_tpu_torch.planner import plan as pplan
    from trino_tpu_torch.runtime import executor as pex

    def aggs(plan, types):
        return (("s", plan.Aggregation("sum", ("v",),
                                       output_type=types.parse_type("decimal(18,2)"))),
                ("c", plan.Aggregation("count", (), output_type=types.parse_type("bigint"))))

    rpage, ppage = _sorted_agg_pages(50 + n_parts)
    symbols, keys, needed = ("k", "v"), ("k",), ("k", "v")
    rp, rng_, rn, _ = rex._presorted_group_impl(keys, needed, symbols, rpage)
    pp, png, pn, _ = pex._presorted_group_impl(keys, needed, symbols, ppage)
    out_cap = pex._round_capacity(int(pn), base=16)
    for epi_keys in ((0,), (0, 2)):  # the group key; with the count
        epi_spec = (epi_keys, n_parts)
        want, want_dest = RMK.aggregate_phase(keys, aggs(rplan, rt), needed, out_cap, rp, rng_,
                                              rn, epi_spec, True)
        got, got_dest = PMK.aggregate_phase(keys, aggs(pplan, pt), needed, out_cap, pp, png, pn,
                                            epi_spec)
        assert got.to_pylist() == want.to_pylist()
        np.testing.assert_array_equal(got_dest.numpy(), np.asarray(want_dest))


def test_partition_dest_wrapper_checks_its_inputs():
    n = 16
    d, v = torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=torch.bool)
    with pytest.raises(ValueError, match="n_parts"):
        HK.partition_dest([(d, v)], [None], v, HK.EPILOGUE_MAX_PARTS + 1)
    with pytest.raises(ValueError, match="int128"):
        HK.partition_dest([(torch.zeros(n, 2, dtype=torch.int64), v)], [None], v, 4)
    with pytest.raises(TypeError):
        HK.partition_epilogue([(d, v)], [None], [(d, v)], v, 4,
                              dest=torch.zeros(n, dtype=torch.int64))
    # no key: every active row to the partition of one zero key, as the hash
    got = HK.partition_dest([], [], v, 7)
    assert got.dtype == torch.int32 and len(set(got.tolist())) == 1


def _frame_pages(seed, n=2500):
    """A page of both packages: bigint key with NULLs, dictionary varchar,
    double, DECIMAL(38,2) with NULLs and negative values; interleaved
    inactive rows."""
    rng = np.random.default_rng(seed)
    key, kv = rng.integers(-(2**62), 2**62, n), rng.random(n) < 0.9
    code, cv = rng.integers(0, len(_VOCAB), n).astype(np.int32), rng.random(n) < 0.9
    dbl = rng.normal(size=n) * 1e6
    big = [int(x) * 10**12 + int(y) for x, y in zip(rng.integers(-10**15, 10**15, n),
                                                     rng.integers(0, 10**12, n))]
    # [hi, lo]: hi the signed top 64 bits, lo the low 64 bits read as int64
    limbs = np.array([[v >> 64, (v & ((1 << 64) - 1)) - ((v >> 63 & 1) << 64)] for v in big],
                     dtype=np.int64)
    dv = rng.random(n) < 0.85
    active = rng.random(n) < 0.8
    ones = np.ones(n, bool)
    d38r, d38p = rt.parse_type("decimal(38,2)"), pt.parse_type("decimal(38,2)")
    rpage = RPage((RColumn(rt.BIGINT, jnp.asarray(key), jnp.asarray(kv)),
                   RColumn(rt.VARCHAR, jnp.asarray(code), jnp.asarray(cv), RDict(_VOCAB)),
                   RColumn(rt.DOUBLE, jnp.asarray(dbl), jnp.asarray(ones)),
                   RColumn(d38r, jnp.asarray(limbs), jnp.asarray(dv))), jnp.asarray(active))
    t = torch.from_numpy
    ppage = PPage((PColumn(pt.BIGINT, t(key), t(kv)),
                   PColumn(pt.VARCHAR, t(code), t(cv), PDict(_VOCAB)),
                   PColumn(pt.DOUBLE, t(dbl), t(ones)),
                   PColumn(d38p, t(limbs.copy()), t(dv))), t(active))
    return rpage, ppage


@pytest.mark.parametrize("n_parts", [2, 4, 8])
@pytest.mark.parametrize("key_idx", [(0,), (1,), (1, 2)])
def test_frames_with_an_attached_destination_match_reference(key_idx, n_parts):
    from trino_tpu.ops import repartition as RR

    rpage, ppage = _frame_pages(60 + n_parts)
    want, want_counts = RR.repartition_frames(rpage, key_idx, n_parts, compress=True)
    plain, plain_counts = PR.repartition_frames(ppage, key_idx, n_parts)
    dest = HK.partition_dest([(ppage.columns[i].data, ppage.columns[i].valid) for i in key_idx],
                             PMK._key_luts([ppage.columns[i] for i in key_idx], "cpu"),
                             ppage.active, n_parts)
    PMK.attach_epilogue(ppage, dest, key_idx, n_parts)
    fused, fused_counts = PR.repartition_frames(ppage, key_idx, n_parts)
    assert "_megakernel_epilogue" not in ppage.__dict__  # consumed once
    # the device formulation (partition_epilogue given the destination)
    from trino_tpu_torch.runtime.serde import serialize_page_slices

    cols, offsets, counts = PR.repartition_to_host(ppage, key_idx, n_parts, dest=dest)
    sliced = serialize_page_slices(cols, offsets, counts)
    assert plain == fused == sliced == want
    np.testing.assert_array_equal(plain_counts, np.asarray(want_counts))
    np.testing.assert_array_equal(fused_counts, plain_counts)
    np.testing.assert_array_equal(counts, plain_counts)


def test_a_destination_for_another_spec_is_not_used():
    _, ppage = _frame_pages(70)
    wrong = torch.zeros(ppage.capacity, dtype=torch.int32)
    PMK.attach_epilogue(ppage, wrong, (0,), 4)
    assert PR._take_fused_dest(ppage, (0,), 8) is None
    assert PR._take_fused_dest(ppage, (0,), 4) is None  # popped by the first look


def test_reattach_epilogue_across_the_output_rewrap():
    _, ppage = _frame_pages(71)
    dest = torch.arange(ppage.capacity, dtype=torch.int32) % 3
    PMK.attach_epilogue(ppage, dest, (1, 0), 3, keys=("mode", "key"))
    # the fragment root's output order: (price, key, dec, mode)
    out = PPage((ppage.columns[2], ppage.columns[0], ppage.columns[3], ppage.columns[1]),
                ppage.active)
    PMK.reattach_epilogue(ppage, out, ("price", "key", "dec", "mode"))
    assert "_megakernel_epilogue" not in ppage.__dict__
    got = out._megakernel_epilogue
    assert got["key_idx"] == (3, 1) and got["n_parts"] == 3 and got["dest"] is dest
    assert PR._take_fused_dest(out, (3, 1), 3) is dest
    # a rewrap that drops a key symbol loses the destination
    PMK.attach_epilogue(ppage, dest, (1, 0), 3, keys=("mode", "key"))
    bare = PPage((ppage.columns[0],), ppage.active)
    PMK.reattach_epilogue(ppage, bare, ("key",))
    assert "_megakernel_epilogue" not in bare.__dict__


def test_long_decimal_frames_match_reference_and_round_trip():
    from trino_tpu.runtime import serde as RS
    from trino_tpu.spi import host_pages as RH
    from trino_tpu_torch.runtime import serde as PS
    from trino_tpu_torch.spi import host_pages as PH

    rpage, ppage = _frame_pages(72)
    v1 = PS.serialize_page(ppage)
    assert v1 == RS.serialize_page(rpage)
    back = PS.deserialize_page(v1, device="cpu")
    assert back.columns[3].data.shape == (ppage.capacity, 2)
    assert back.to_pylist() == ppage.to_pylist() == rpage.to_pylist()
    # v2: the live rows of a host chunk, sliced into two partitions
    rchunk, pchunk = RH.page_to_host(rpage), PH.page_to_host(ppage)
    for (_, rd, rv, _), (_, pd, pv, _) in zip(rchunk, pchunk):
        np.testing.assert_array_equal(pd, rd)
        np.testing.assert_array_equal(pv, rv)
    n = len(pchunk[0][1])
    offsets, counts = np.array([0, n // 3]), np.array([n // 3, n - n // 3])
    frames = PS.serialize_page_slices(pchunk, offsets, counts)
    assert frames == RS.serialize_page_slices(rchunk, offsets, counts)
    pages = [PS.deserialize_page(f, device="cpu") for f in frames]
    assert [r for p in pages for r in p.to_pylist()] == ppage.to_pylist()
    # host chunks round-trip through a merged page
    merged = PH.page_from_host_chunks([PH.page_to_host(p) for p in pages], device="cpu")
    assert merged.columns[3].data.shape[1] == 2
    assert merged.to_pylist() == ppage.to_pylist()
    # the lazy frame keeps the lanes when it pads
    lazy = PS.LazyPageFrame(frames[1]).to_page(capacity=4096, device="cpu")
    assert lazy.capacity == 4096 and lazy.to_pylist() == pages[1].to_pylist()
