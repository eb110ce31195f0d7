"""The port's plain relational kernels (``trino_tpu_torch.ops.kernels``)
against ``trino_tpu.ops.kernels``: the same numpy inputs, made from a seed,
through both; integer and boolean results bit-exact, DOUBLE sums to 1e-9
relative (the two frameworks add floats in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import kernels as RK

from trino_tpu_torch.ops import kernels as PK


def _inputs(n, G, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int64":
        vals = rng.integers(-(10**15), 10**15, n)
    elif dtype == "int32":
        vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    elif dtype == "float64":
        vals = rng.normal(scale=1e6, size=n)
    else:
        vals = rng.random(n) < 0.5
    w = rng.random(n) < 0.7
    gid = rng.integers(0, max(G - 2, 1), n).astype(np.int32)  # last groups empty
    return vals, w, gid


REDUCE_CASES = [
    (kind, dtype)
    for kind in ("sum", "count", "min", "max")
    for dtype in ("int64", "int32", "float64", "bool")
    if (kind, dtype) != ("sum", "bool")  # the engine never sums booleans
]


@pytest.mark.parametrize("kind,dtype", REDUCE_CASES)
def test_direct_group_reduce(kind, dtype):
    n, G = 5003, 12
    vals, w, gid = _inputs(n, G, dtype, seed=REDUCE_CASES.index((kind, dtype)))
    want = np.asarray(RK.direct_group_reduce(
        jnp.asarray(vals), jnp.asarray(w), jnp.asarray(gid), G, kind))
    got = PK.direct_group_reduce(
        torch.from_numpy(vals), torch.from_numpy(w), torch.from_numpy(gid), G, kind
    ).numpy()
    assert got.dtype == want.dtype
    if dtype == "float64" and kind == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_direct_group_first():
    n, G = 4001, 9
    vals, w, gid = _inputs(n, G, "int64", seed=3)
    want = np.asarray(RK.direct_group_first(
        jnp.asarray(vals), jnp.asarray(w), jnp.asarray(gid), G))
    got = PK.direct_group_first(
        torch.from_numpy(vals), torch.from_numpy(w), torch.from_numpy(gid), G)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
def test_segment_reduce_global(kind):
    vals, w, _ = _inputs(3001, 1, "int64", seed=5)
    if kind in ("min", "max"):  # the engine masks with the sentinel first
        sent = RK.INT64_MAX if kind == "min" else RK.INT64_MIN
        vals = np.where(w, vals, sent)
    want = np.asarray(RK.segment_reduce(jnp.asarray(vals), jnp.asarray(w), None, 1, kind))
    got = PK.segment_reduce(torch.from_numpy(vals), torch.from_numpy(w), None, 1, kind)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lexsort_perm_with_ties_nulls_and_inactive_rows():
    rng = np.random.default_rng(9)
    n = 3000
    k1 = rng.integers(0, 5, n)
    k2 = rng.normal(size=n)
    k2[rng.random(n) < 0.1] = -0.0
    valid2 = rng.random(n) < 0.9
    active = rng.random(n) < 0.8
    for asc, nulls_first in ((True, False), (False, True)):
        rkeys = [RK.encode_sort_column(jnp.asarray(k1), jnp.ones(n, bool), asc, nulls_first),
                 RK.encode_sort_column(jnp.asarray(k2), jnp.asarray(valid2), not asc, nulls_first)]
        pkeys = [PK.encode_sort_column(torch.from_numpy(k1), torch.ones(n, dtype=torch.bool),
                                       asc, nulls_first),
                 PK.encode_sort_column(torch.from_numpy(k2), torch.from_numpy(valid2),
                                       not asc, nulls_first)]
        for rk, pk in zip(rkeys, pkeys):
            np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
        want = np.asarray(RK.lexsort_perm(rkeys, jnp.asarray(active)))
        got = PK.lexsort_perm(pkeys, torch.from_numpy(active)).numpy()
        np.testing.assert_array_equal(got, want)


def test_float_order_key():
    x = np.array([-np.inf, -2.5, -0.0, 0.0, 1e-300, 3.0, np.inf, -1e300])
    want = np.asarray(RK.float_order_key(jnp.asarray(x)))
    got = PK.float_order_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("count,offset", [(5, 0), (7, 11), (0, 0), (10**6, 3)])
def test_limit_mask(count, offset):
    active = np.random.default_rng(2).random(500) < 0.6
    want = np.asarray(RK.limit_mask(jnp.asarray(active), count, offset))
    got = PK.limit_mask(torch.from_numpy(active), count, offset).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# join, sort-path and TopN primitives
# --------------------------------------------------------------------------- #


def test_splitmix64_edges_and_negatives():
    rng = np.random.default_rng(11)
    x = np.concatenate([
        np.array([RK.INT64_MIN, RK.INT64_MAX, -1, 0, 1, RK.INT64_MIN + 1, -(2**31)]),
        rng.integers(RK.INT64_MIN, RK.INT64_MAX, 2000, endpoint=True),
    ]).astype(np.int64)
    want = np.asarray(RK.splitmix64(jnp.asarray(x)))
    got = PK.splitmix64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cosort_stable_multi_pass():
    rng = np.random.default_rng(12)
    n = 4000
    keys = [rng.integers(0, 7, n), rng.integers(0, 3, n).astype(np.int8)]
    payloads = [np.arange(n), rng.random(n) < 0.5]
    wk, wp = RK.cosort([jnp.asarray(k) for k in keys], [jnp.asarray(p) for p in payloads])
    gk, gp = PK.cosort([torch.from_numpy(k) for k in keys],
                       [torch.from_numpy(p) for p in payloads])
    for g, w in zip(gk + gp, list(wk) + list(wp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_last_active_prev(rate):
    rng = np.random.default_rng(13)
    vals = rng.integers(-(10**12), 10**12, 3001)
    active = rng.random(3001) < rate
    wv, wh = RK.last_active_prev(jnp.asarray(vals), jnp.asarray(active))
    gv, gh = PK.last_active_prev(torch.from_numpy(vals), torch.from_numpy(active))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("out_cap", [1, 16, 300, 5000])
def test_boundary_positions(out_cap):
    new_group = np.random.default_rng(14).random(4000) < 0.05
    want = np.asarray(RK.boundary_positions(jnp.asarray(new_group), out_cap))
    got = PK.boundary_positions(torch.from_numpy(new_group), out_cap).numpy()
    np.testing.assert_array_equal(got, want)


def _group_sorted(seed, n=5000, rate=0.02):
    rng = np.random.default_rng(seed)
    new_group = rng.random(n) < rate
    new_group[0] = True
    gid = (np.cumsum(new_group) - 1).astype(np.int32)
    return rng, new_group, gid, int(new_group.sum())


@pytest.mark.parametrize("kind,dtype", [("sum", "int64"), ("count", "int64"),
                                        ("sum", "float64"), ("min", "int64"),
                                        ("max", "float64")])
@pytest.mark.parametrize("form", ["bounds", "new_group", "gid"])
def test_segment_reduce_grouped(kind, dtype, form):
    rng, new_group, gid, G = _group_sorted(15)
    n = new_group.shape[0]
    vals = (rng.integers(-(2**62), 2**62, n) if dtype == "int64"
            else rng.normal(scale=1e6, size=n))
    w = rng.random(n) < 0.7
    out_cap = G + 7  # padding slots past the last group
    if kind in ("min", "max"):
        form = "gid"  # the engine reduces min/max by gid only
    rb = pb = None
    if form == "bounds":
        rs = RK.boundary_positions(jnp.asarray(new_group), out_cap)
        rb = (rs, jnp.concatenate([rs[1:], jnp.array([n])]) - 1)
        ps = PK.boundary_positions(torch.from_numpy(new_group), out_cap)
        pb = (ps, torch.cat([ps[1:], torch.tensor([n])]) - 1)
    ng = None if form == "gid" else new_group
    want = np.asarray(RK.segment_reduce(
        jnp.asarray(vals), jnp.asarray(w), jnp.asarray(gid), out_cap, kind,
        None if ng is None else jnp.asarray(ng), rb))
    got = PK.segment_reduce(
        torch.from_numpy(vals), torch.from_numpy(w), torch.from_numpy(gid), out_cap, kind,
        None if ng is None else torch.from_numpy(ng), pb).numpy()
    if dtype == "float64" and kind == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


def _join_inputs(seed, n=3000, m=800, key_range=400):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, key_range, m), rng.random(m) < 0.8,
            rng.integers(0, key_range, n), rng.random(n) < 0.85)


@pytest.mark.parametrize("seed,key_range", [(16, 400), (17, 5), (18, 10**6)])
def test_join_match(seed, key_range):
    bk, ba, pk, pa = _join_inputs(seed, key_range=key_range)
    bk[:3] = RK.INT64_MAX  # genuine INT64_MAX keys never match the inactive tail
    pk[:2] = RK.INT64_MAX
    want = RK.join_match(jnp.asarray(bk), jnp.asarray(ba), jnp.asarray(pk), jnp.asarray(pa))
    got = PK.join_match(torch.from_numpy(bk), torch.from_numpy(ba),
                        torch.from_numpy(pk), torch.from_numpy(pa))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_key_pair_two_columns():
    rng = np.random.default_rng(19)
    pcols = [(rng.integers(0, 9, 500), rng.random(500) < 0.9),
             (rng.normal(size=500).round(1), rng.random(500) < 0.9)]
    bcols = [(rng.integers(0, 9, 300), rng.random(300) < 0.9),
             (rng.normal(size=300).round(1), np.ones(300, bool))]
    want = RK.pack_key_pair([tuple(map(jnp.asarray, c)) for c in pcols],
                            [tuple(map(jnp.asarray, c)) for c in bcols])
    got = PK.pack_key_pair([tuple(map(torch.from_numpy, c)) for c in pcols],
                           [tuple(map(torch.from_numpy, c)) for c in bcols])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("out_cap", [1, 1024, 9000])
def test_expand_probe_slots_zero_emit_runs(out_cap):
    rng = np.random.default_rng(20)
    emit = rng.integers(0, 4, 2500).astype(np.int32)
    emit[:7] = 0  # a leading zero-emit run
    emit[100:160] = 0  # an inner one
    emit[-9:] = 0  # and a trailing one
    want = RK.expand_probe_slots(jnp.asarray(emit), out_cap)
    got = PK.expand_probe_slots(torch.from_numpy(emit), out_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("left_outer", [False, True])
def test_expand_matches(left_outer):
    bk, ba, pk, pa = _join_inputs(21)
    rm = RK.join_match(jnp.asarray(bk), jnp.asarray(ba), jnp.asarray(pk), jnp.asarray(pa))
    count = np.asarray(rm[3])
    emit = np.where(pa, np.maximum(count, 1), 0) if left_outer else count
    cap = int(emit.sum()) + 5
    want = RK.expand_matches(jnp.asarray(emit), rm[3], rm[1], rm[0], cap)
    pm = PK.join_match(torch.from_numpy(bk), torch.from_numpy(ba),
                       torch.from_numpy(pk), torch.from_numpy(pa))
    got = PK.expand_matches(torch.from_numpy(np.array(emit, np.int32)), pm[3], pm[1],
                            pm[0], cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("count", [None, 0, 10, 10**6])
def test_topn_perm(count):
    rng = np.random.default_rng(22)
    k = rng.integers(0, 50, 3000)
    active = rng.random(3000) < 0.6
    rk = [RK.encode_sort_column(jnp.asarray(k), jnp.ones(3000, bool), False, False)]
    pk = [PK.encode_sort_column(torch.from_numpy(k), torch.ones(3000, dtype=torch.bool),
                                False, False)]
    wp, wa = RK.topn_perm(rk, jnp.asarray(active), count)
    gp, ga = PK.topn_perm(pk, torch.from_numpy(active), count)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


# --------------------------------------------------------------------------- #
# the partition hash (ops/repartition.py): part of the exchange-frame contract
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_parts", [1, 2, 7, 64, 1000, 2**31 - 1])
def test_partition_ids_bit_identical(n_parts):
    """Bigint keys over the whole int64 range (about half the hashes have
    the top bit set, where a signed modulo goes wrong), a double key with
    -0.0, NaN and infinities, and NULLs in both, against the reference."""
    from trino_tpu.ops import repartition as RR

    from trino_tpu_torch.ops import repartition as PR

    rng = np.random.default_rng(40)
    n = 5000
    big = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    big[:4] = [-(2**63), 2**63 - 1, 0, -1]
    dbl = rng.choice(np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1.5, -2.5]), n)
    vb, vd = rng.random(n) < 0.9, rng.random(n) < 0.9
    for keys in ([(big, vb)], [(big, vb), (dbl, vd)], [(dbl, vd)]):
        want = RR.partition_ids([(jnp.asarray(d), jnp.asarray(v)) for d, v in keys], n_parts)
        got = PR.partition_ids([(torch.from_numpy(d), torch.from_numpy(v)) for d, v in keys],
                               n_parts)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unsigned_mod_of_top_bit_values():
    """int64 bits read as uint64 modulo m, against numpy's uint64 modulo,
    on values with the top bit set."""
    from trino_tpu_torch.ops import repartition as PR

    rng = np.random.default_rng(41)
    x = rng.integers(-(2**63), 0, 4000, dtype=np.int64)
    x[:3] = [-(2**63), -1, -(2**62)]
    for m in (1, 3, 8, 1000, 2**31 - 1):
        got = PR._unsigned_mod(torch.from_numpy(x), m).numpy()
        np.testing.assert_array_equal(got, (x.view(np.uint64) % np.uint64(m)).astype(np.int64))
