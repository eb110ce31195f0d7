"""The port's hash-join and segment-aggregation phases
(``trino_tpu_torch.ops.megakernels``, whose kernel wrappers run their plain
versions on CPU tensors) against the reference's Pallas phases in interpret
mode (``trino_tpu.ops.megakernels``, as ``tests/test_megakernels.py`` runs
them). The same seeded numpy inputs go through both; every compared output
is exact: nothing on this path is DOUBLE arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import megakernels as RMK
from trino_tpu.spi.page import Column as RColumn
from trino_tpu.spi.page import Page as RPage
from trino_tpu.spi.types import BIGINT as RBIGINT
from trino_tpu.spi.types import DOUBLE as RDOUBLE

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as PMK
from trino_tpu_torch.spi.page import Column as PColumn
from trino_tpu_torch.spi.page import Page as PPage
from trino_tpu_torch.spi.types import BIGINT as PBIGINT
from trino_tpu_torch.spi.types import DOUBLE as PDOUBLE


def _keys(rng, n, key_range, valid_rate=0.9, lut_size=None):
    """One key column (data, valid) in numpy, codes below ``lut_size`` when
    it is a dictionary key."""
    hi = lut_size if lut_size is not None else key_range
    data = rng.integers(0, hi, n)
    if lut_size is not None:
        data = data.astype(np.int32)
    return data, rng.random(n) < valid_rate


def _case(seed, n, m, key_range=300, n_keys=1, dict_key=False, build_rate=0.7):
    rng = np.random.default_rng(seed)
    pk = [_keys(rng, n, key_range, lut_size=40 if dict_key else None)
          for _ in range(n_keys)]
    bk = [_keys(rng, m, key_range if not dict_key else 30) for _ in range(n_keys)]
    if dict_key:
        bk = [(d.astype(np.int32), v) for d, v in bk]
    luts = [None] * n_keys
    if dict_key:
        # probe code -> build code; a third of the probe vocabulary is absent
        lut = rng.integers(0, 30, 40)
        lut[rng.random(40) < 0.33] = -1
        luts[0] = lut.astype(np.int64)
    pa = rng.random(n) < 0.8
    ba = rng.random(m) < build_rate
    return pk, bk, luts, pa, ba


def _ref(pk, bk, luts, pa, ba):
    return (tuple((jnp.asarray(d), jnp.asarray(v)) for d, v in pk),
            tuple((jnp.asarray(d), jnp.asarray(v)) for d, v in bk),
            tuple(None if l is None else jnp.asarray(l) for l in luts),
            jnp.asarray(pa), jnp.asarray(ba))


def _port(pk, bk, luts, pa, ba):
    t = torch.from_numpy
    return (tuple((t(d), t(v)) for d, v in pk), tuple((t(d), t(v)) for d, v in bk),
            tuple(None if l is None else t(l) for l in luts), t(pa), t(ba))


CASES = {
    "inner": dict(seed=1, n=1500, m=1024),
    "class_edge": dict(seed=2, n=1024, m=1025),
    "two_keys": dict(seed=3, n=2000, m=700, key_range=12, n_keys=2),
    "dictionary_lut": dict(seed=4, n=1800, m=600, dict_key=True),
    "empty_build": dict(seed=5, n=900, m=512, build_rate=0.0),
    "sparse_matches": dict(seed=6, n=3000, m=800, key_range=10**6),
}


def _probe_both(case, left_outer):
    args = _case(**CASES[case])
    want = RMK.probe_phase(*_ref(*args), left_outer, True)
    got = PMK.probe_phase(*_port(*args), left_outer)
    return args, want, got


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_phase_matches_reference(case, left_outer):
    _, want, got = _probe_both(case, left_outer)
    assert want is not None and got is not None
    assert got["C"] == want["C"]
    for k in ("table", "counts", "bucket_p", "count", "emit"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_phase_matches_reference(case, left_outer):
    args, want_pr, got_pr = _probe_both(case, left_outer)
    pk, bk, luts, pa, ba = args
    n, m = pa.shape[0], ba.shape[0]
    rng = np.random.default_rng(99)
    pay_p = rng.normal(size=n)
    pay_b = rng.integers(-(10**15), 10**15, m)
    rpk, rbk, rluts, rpa, rba = _ref(*args)
    ppk, pbk, pluts, ppa, pba = _port(*args)
    rprobe = RPage(tuple(RColumn(RBIGINT, d.astype(jnp.int64), v) for d, v in rpk)
                   + (RColumn(RDOUBLE, jnp.asarray(pay_p), jnp.ones(n, bool)),), rpa)
    rbuild = RPage(tuple(RColumn(RBIGINT, d.astype(jnp.int64), v) for d, v in rbk)
                   + (RColumn(RBIGINT, jnp.asarray(pay_b), jnp.asarray(ba)),), rba)
    pprobe = PPage(tuple(PColumn(PBIGINT, d.to(torch.int64), v) for d, v in ppk)
                   + (PColumn(PDOUBLE, torch.from_numpy(pay_p),
                              torch.ones(n, dtype=torch.bool)),), ppa)
    pbuild = PPage(tuple(PColumn(PBIGINT, d.to(torch.int64), v) for d, v in pbk)
                   + (PColumn(PBIGINT, torch.from_numpy(pay_b), torch.from_numpy(ba)),), pba)
    cap = max(int(np.asarray(want_pr["emit"]).sum()), 1) + 3
    symbols = tuple(f"c{i}" for i in range(len(rprobe.columns) + len(rbuild.columns)))
    want, _ = RMK.expand_phase(want_pr, rpk, rbk, rluts, rprobe, rbuild, cap, symbols,
                               None, None, None, True)
    got = PMK.expand_phase(got_pr, ppk, pbk, pluts, pprobe, pbuild, cap, symbols, None, None)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    for gc, wc in zip(got.columns, want.columns):
        np.testing.assert_array_equal(gc.valid.numpy(), np.asarray(wc.valid))
        np.testing.assert_array_equal(gc.data.numpy(), np.asarray(wc.data))


def test_probe_phase_retries_on_duplicate_heavy_build():
    """3 distinct keys x 120 build rows each overflow the 32-slot buckets:
    one retry at capacity_class(120, 8) = 128 slots, on both packages."""
    rng = np.random.default_rng(7)
    bkey = np.repeat(np.arange(3), 120)
    pk = [(rng.integers(0, 4, 500), np.ones(500, bool))]
    bk = [(bkey, np.ones(360, bool))]
    args = (pk, bk, [None], rng.random(500) < 0.9, np.ones(360, bool))
    want = RMK.probe_phase(*_ref(*args), False, True)
    before = PMK.LAUNCHES["probe"]
    got = PMK.probe_phase(*_port(*args), False)
    assert PMK.LAUNCHES["probe"] - before == 2
    assert got["C"] == want["C"] == 128
    for k in ("table", "counts", "bucket_p", "count", "emit"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


def test_probe_phase_declines_bucket_skew(monkeypatch):
    """A retry whose table would pass TABLE_ENTRY_LIMIT declines on both
    packages, and the port counts the fallback by reason."""
    monkeypatch.setattr(RMK, "TABLE_ENTRY_LIMIT", 1024)
    monkeypatch.setattr(PMK, "TABLE_ENTRY_LIMIT", 1024)
    bkey = np.repeat(np.arange(3), 120)
    args = ([(np.arange(50), np.ones(50, bool))], [(bkey, np.ones(360, bool))], [None],
            np.ones(50, bool), np.ones(360, bool))
    assert RMK.probe_phase(*_ref(*args), False, True) is None
    before = PMK.FALLBACKS["bucket_skew"]
    assert PMK.probe_phase(*_port(*args), False) is None
    assert PMK.FALLBACKS["bucket_skew"] == before + 1


def _sorted_agg_page(seed, n=3000):
    """A page ordered on its first column with interleaved inactive rows:
    (key bigint, value decimal(12,2) with NULLs, bigint value)."""
    from trino_tpu.spi import types as rt
    from trino_tpu_torch.spi import types as pt

    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, 400, n))
    vals = rng.integers(-(10**10), 10**10, n)
    big = rng.integers(-(2**62), 2**62, n)
    vvalid = rng.random(n) < 0.9
    active = rng.random(n) < 0.85
    ones = np.ones(n, bool)
    dec_r, dec_p = rt.parse_type("decimal(12,2)"), pt.parse_type("decimal(12,2)")
    rpage = RPage((RColumn(RBIGINT, jnp.asarray(key), jnp.asarray(ones)),
                   RColumn(dec_r, jnp.asarray(vals), jnp.asarray(vvalid)),
                   RColumn(RBIGINT, jnp.asarray(big), jnp.asarray(ones))), jnp.asarray(active))
    t = torch.from_numpy
    ppage = PPage((PColumn(PBIGINT, t(key), t(ones)), PColumn(dec_p, t(vals), t(vvalid)),
                   PColumn(PBIGINT, t(big), t(ones))), t(active))
    return rpage, ppage


def _aggs(plan, types):
    dec = types.parse_type("decimal(18,2)")
    A = plan.Aggregation
    return (
        ("s", A("sum", ("v",), output_type=dec)),
        ("t", A("sum", ("b",), output_type=types.parse_type("bigint"))),
        ("c", A("count", (), output_type=types.parse_type("bigint"))),
        ("cv", A("count", ("v",), output_type=types.parse_type("bigint"))),
        ("av", A("avg", ("v",), output_type=types.parse_type("decimal(12,2)"))),
        ("mn", A("min", ("b",), output_type=types.parse_type("bigint"))),
    )


def test_aggregate_phase_matches_reference():
    from trino_tpu.planner import plan as rplan
    from trino_tpu.runtime import executor as rex
    from trino_tpu.spi import types as rt
    from trino_tpu_torch.planner import plan as pplan
    from trino_tpu_torch.runtime import executor as pex
    from trino_tpu_torch.spi import types as pt

    rpage, ppage = _sorted_agg_page(8)
    symbols, keys, needed = ("k", "v", "b"), ("k",), ("k", "v", "b")
    rp, rng_, rn, rviol = rex._presorted_group_impl(keys, needed, symbols, rpage)
    pp, png, pn, pviol = pex._presorted_group_impl(keys, needed, symbols, ppage)
    assert not bool(rviol) and not bool(pviol)
    np.testing.assert_array_equal(png.numpy(), np.asarray(rng_))
    assert int(pn) == int(rn)
    out_cap = pex._round_capacity(int(pn), base=16)
    want, _ = RMK.aggregate_phase(keys, _aggs(rplan, rt), needed, out_cap, rp, rng_, rn,
                                  None, True)
    got = PMK.aggregate_phase(keys, _aggs(pplan, pt), needed, out_cap, pp, png, pn)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    act = got.active.numpy()
    for gc, wc in zip(got.columns, want.columns):
        np.testing.assert_array_equal(gc.valid.numpy()[act], np.asarray(wc.valid)[act])
        np.testing.assert_array_equal(gc.data.numpy()[act], np.asarray(wc.data)[act])
    assert got.to_pylist() == want.to_pylist()


def test_segment_sum_plain_matches_reference_segment_reduce():
    """The segment-sum wrapper's plain version (int64, int32 and bool
    values) against the reference's cumsum-at-boundaries reduction,
    padding slots included."""
    from trino_tpu.ops import kernels as RK

    rng = np.random.default_rng(9)
    n = 4000
    new_group = rng.random(n) < 0.03
    new_group[0] = True
    out_cap = int(new_group.sum()) + 9
    starts = RK.boundary_positions(jnp.asarray(new_group), out_cap)
    ends = jnp.concatenate([starts[1:], jnp.array([n])]) - 1
    w = rng.random(n) < 0.6
    for vals in (rng.integers(-(2**62), 2**62, n),
                 rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), rng.random(n) < 0.5):
        want = np.asarray(RK.segment_reduce(
            jnp.asarray(vals).astype(jnp.int64), jnp.asarray(w), None, out_cap, "sum",
            jnp.asarray(new_group), (starts, ends)))
        got = HK.segment_sum(torch.from_numpy(vals), torch.from_numpy(w),
                             torch.from_numpy(np.array(starts)).to(torch.int64))
        np.testing.assert_array_equal(got.numpy(), want)
