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
