"""The Hopper kernel wrappers (``trino_tpu_torch.ops.hopper_kernels``).

On the CPU a wrapper computes its plain version; those are held here against
the reference's plain formulations, with the cases of tests/test_pallas.py:
``kernels.direct_group_reduce`` (the engine's default path) for the grouped
sums and ``q6_reference`` for Q6. (The Pallas kernels themselves cannot be
the oracle: on this JAX they fail at ``jax.experimental.enable_x64``.) All
results are integers and must be bit-exact.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` (this directory's conftest imports JAX, which the
card's machine does not have).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import kernels as RK
from trino_tpu.ops.pallas_kernels import BLOCK, q6_reference

from trino_tpu_torch.ops import hopper_kernels as HK

PRED = (8766, 9131, 5, 7, 2400)


def _grouped_case(n, G, seed=0, lo=-(10**12), hi=10**12, dtype=np.int64, wrate=0.8):
    rng = np.random.default_rng(seed)
    vals = rng.integers(lo, hi, n, dtype=np.int64).astype(dtype)
    gid = rng.integers(0, G, n, dtype=np.int32)
    w = rng.random(n) < wrate
    return vals, w, gid


def _reference_sum(vals, w, gid, G, kind="sum"):
    return np.asarray(RK.direct_group_reduce(
        jnp.asarray(vals.astype(np.int64)), jnp.asarray(w), jnp.asarray(gid), G, kind))


def _wrapper(name, vals, w, gid, G):
    return getattr(HK, name)(
        torch.from_numpy(vals), torch.from_numpy(w), torch.from_numpy(gid), G
    ).numpy()


GROUPED_CASES = {
    # name: (n, G, kwargs); n deliberately off the TPU kernel's block size
    "unaligned": (BLOCK * 2 + 777, 12, {}),
    "single_group": (BLOCK, 1, {}),
    "g64": (BLOCK + 5, 64, {}),
    "extreme_magnitudes": (BLOCK, 5, {"lo": -(2**62), "hi": 2**62}),
    "all_false_mask": (999, 7, {"wrate": 0.0}),
    "empty_input": (0, 3, {}),
}


@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_grouped_sum_i64_matches_direct_group_reduce(case):
    n, G, kw = GROUPED_CASES[case]
    vals, w, gid = _grouped_case(n, G, **kw)
    np.testing.assert_array_equal(
        _wrapper("grouped_sum_i64", vals, w, gid, G), _reference_sum(vals, w, gid, G))


def test_grouped_sum_i64_wraps_mod_2_64():
    n, G = 64, 2
    vals = np.full(n, 2**62, dtype=np.int64)
    w = np.ones(n, bool)
    gid = np.zeros(n, np.int32)
    got = _wrapper("grouped_sum_i64", vals, w, gid, G)
    np.testing.assert_array_equal(got, _reference_sum(vals, w, gid, G))
    assert got[0] == 0  # 64 * 2^62 = 2^68 == 0 mod 2^64


def test_grouped_sum_i64_empty_groups():
    vals, w, gid = _grouped_case(BLOCK, 1)
    got = _wrapper("grouped_sum_i64", vals, w, gid, 7)
    np.testing.assert_array_equal(got, _reference_sum(vals, w, gid, 7))
    assert got[1:].tolist() == [0] * 6


def test_grouped_sum_i32_count():
    rng = np.random.default_rng(3)
    n, G = BLOCK + 99, 9
    gid = rng.integers(0, G, n, dtype=np.int32)
    w = rng.random(n) < 0.5
    got = _wrapper("grouped_sum_i32", w.astype(np.int32), w, gid, G)
    np.testing.assert_array_equal(got, _reference_sum(w, w, gid, G, "count"))


def test_grouped_sum_i32_negative_values():
    vals, w, gid = _grouped_case(BLOCK, 4, seed=4, lo=-(2**31), hi=2**31 - 1,
                                 dtype=np.int32, wrate=1.0)
    np.testing.assert_array_equal(
        _wrapper("grouped_sum_i32", vals, w, gid, 4), _reference_sum(vals, w, gid, 4))


@pytest.mark.parametrize("name", ["grouped_sum_i64", "grouped_sum_i32"])
def test_grouped_sum_skips_out_of_range_gid(name):
    # the CUDA kernel skips a row whose gid lies outside [0, G); the plain
    # version keeps the same contract
    G = 6
    vals, w, _ = _grouped_case(BLOCK + 13, G, seed=5, lo=-(2**31), hi=2**31 - 1)
    gid = np.random.default_rng(6).integers(-3, G + 3, vals.shape[0], dtype=np.int32)
    inside = (gid >= 0) & (gid < G)
    vals = vals.astype(np.int64 if name == "grouped_sum_i64" else np.int32)
    want = _reference_sum(vals[inside], w[inside], gid[inside], G)
    np.testing.assert_array_equal(_wrapper(name, vals, w, gid, G), want)


@pytest.mark.parametrize("offsets", [(1, 1, 1), (0, 2, 1), (3, 3, 3)])
@pytest.mark.parametrize("name", ["grouped_sum_i64", "grouped_sum_i32"])
def test_grouped_sum_takes_offset_views(name, offsets):
    # an engine tensor may be a view whose data_ptr is off 16-byte
    # alignment; the wrapper takes it (the kernel reads a scalar head and
    # tail) and keeps the contract
    G = 12
    vals, w, gid = _grouped_case(BLOCK + 21, G, seed=7)
    vals = vals.astype(np.int64 if name == "grouped_sum_i64" else np.int32)
    n = vals.shape[0] - max(offsets)
    ov, ow, og = offsets
    v_t, w_t, g_t = (torch.from_numpy(a)[o:o + n] for a, o in ((vals, ov), (w, ow), (gid, og)))
    got = getattr(HK, name)(v_t, w_t, g_t, G).numpy()
    want = _reference_sum(vals[ov:ov + n], w[ow:ow + n], gid[og:og + n], G)
    np.testing.assert_array_equal(got, want)


def test_grouped_sum_rejects_bad_inputs():
    v = torch.zeros(8, dtype=torch.int64)
    w = torch.ones(8, dtype=torch.bool)
    g = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        HK.grouped_sum_i64(v.to(torch.int32), w, g, 3)
    with pytest.raises(TypeError):
        HK.grouped_sum_i64(v, w, g.to(torch.int64), 3)
    with pytest.raises(ValueError):
        HK.grouped_sum_i64(v, w[:5], g, 3)
    with pytest.raises(ValueError):
        HK.grouped_sum_i64(v[::2], w[::2], g[::2].clone(), 3)
    with pytest.raises(ValueError):
        HK.grouped_sum_i32(v.to(torch.int32), w, g, HK.GROUP_LIMIT + 1)
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}  # nothing launched on the CPU


def _q6_inputs(n, seed=0, null_rate=0.0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(8000, 10000, n, dtype=np.int32),
        rng.integers(0, 11, n, dtype=np.int32),
        rng.integers(0, 5100, n, dtype=np.int32),
        rng.integers(0, 10**7, n, dtype=np.int32),
        (rng.random(n) >= null_rate).astype(np.int32),
    )


def _q6_both(args, pred=PRED):
    want = int(q6_reference(*(jnp.asarray(a) for a in args), *pred))
    got = HK.q6_fused(*(torch.from_numpy(a) for a in args), *pred)
    assert got.dtype == torch.int64 and got.dim() == 0
    return int(got), want


Q6_CASES = {
    "aligned": (_q6_inputs, (BLOCK * 3,), {}),
    "unaligned_length": (_q6_inputs, (BLOCK * 2 + 12345,), {}),
    "mask_excludes_rows": (_q6_inputs, (BLOCK,), {"null_rate": 0.3}),
    "empty_input": (_q6_inputs, (0,), {}),
}


@pytest.mark.parametrize("case", sorted(Q6_CASES))
def test_q6_fused_matches_q6_reference(case):
    make, args, kw = Q6_CASES[case]
    got, want = _q6_both(make(*args, **kw))
    assert got == want


def test_q6_fused_empty_selection():
    got, want = _q6_both(_q6_inputs(BLOCK), (0, 0, 5, 7, 2400))
    assert got == want == 0


def test_q6_fused_products_past_int32():
    # The Pallas kernel multiplies in int32 and is exact only while each
    # product stays below 2^31; the port forms every product in int64, as
    # q6_reference does, so products of up to (2^31-1)*10 stay exact.
    n = BLOCK
    args = (
        np.full(n, 9000, np.int32), np.full(n, 7, np.int32), np.zeros(n, np.int32),
        np.full(n, 2**31 - 1, np.int32), np.ones(n, np.int32),
    )
    got, want = _q6_both(args)
    assert got == want == n * 7 * (2**31 - 1)


def test_q6_fused_rejects_bad_inputs():
    cols = [torch.zeros(4, dtype=torch.int32) for _ in range(5)]
    with pytest.raises(TypeError):
        HK.q6_fused(*cols[:4], cols[4].to(torch.bool), *PRED)
    with pytest.raises(ValueError):
        HK.q6_fused(*cols, 0, 2**31, 5, 7, 2400)


# --------------------------------------------------------------------------- #
# hash join and segment sums: input checks (their plain versions are held
# against the reference's phases in tests/test_torch_megakernels.py)
# --------------------------------------------------------------------------- #


def _join_side(n, seed):
    rng = np.random.default_rng(seed)
    keys = ((torch.from_numpy(rng.integers(0, 50, n)), torch.ones(n, dtype=torch.bool)),)
    return keys, torch.from_numpy(rng.random(n) < 0.8)


def test_hash_probe_rejects_bad_inputs():
    pk, pa = _join_side(100, 1)
    bk, ba = _join_side(64, 2)
    with pytest.raises(ValueError, match="power"):
        HK.hash_probe(pk, bk, (None,), pa, ba, 1000, 32, False)
    with pytest.raises(ValueError, match="key columns"):
        HK.hash_probe(pk, bk + bk, (None,), pa, ba, 1024, 32, False)
    with pytest.raises(ValueError, match="key columns"):
        HK.hash_probe(pk * 5, bk * 5, (None,) * 5, pa, ba, 1024, 32, False)
    with pytest.raises(TypeError):
        HK.hash_probe(pk, bk, (None,), pa.to(torch.int8), ba, 1024, 32, False)
    with pytest.raises(ValueError, match="non-empty"):
        HK.hash_probe(pk, bk, (None,), pa, ba[:0], 1024, 32, False)
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}


def test_hash_expand_rejects_bad_inputs():
    pk, pa = _join_side(100, 3)
    bk, ba = _join_side(64, 4)
    pr = HK.hash_probe(pk, bk, (None,), pa, ba, 1024, 32, False)
    args = (pr["table"], pr["counts"], pr["bucket_p"], pr["count"], pr["emit"], pk, bk,
            (None,), pa)
    with pytest.raises(ValueError, match="out_capacity"):
        HK.hash_expand(*args, list(pk), list(bk), 0)
    with pytest.raises(ValueError, match="probe column"):
        HK.hash_expand(*args, [(pk[0][0][:50], pk[0][1][:50])], list(bk), 16)
    with pytest.raises(ValueError, match="contiguous"):
        col = torch.zeros(200, dtype=torch.int64)[::2]
        HK.hash_expand(*args, list(pk), [(col[:64], torch.ones(64, dtype=torch.bool))], 16)
    with pytest.raises(TypeError):
        HK.hash_expand(pr["table"].to(torch.int64), *args[1:], list(pk), list(bk), 16)
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}


def test_one_request_segment_agg_rejects_bad_inputs():
    """The one-request form of ``segment_agg`` (an integer sum or a count,
    the re-sorting aggregates' reductions on the fused path)."""
    v = torch.zeros(8, dtype=torch.int64)
    w = torch.ones(8, dtype=torch.bool)
    new_group = torch.zeros(8, dtype=torch.bool)
    new_group[[0, 3]] = True
    num_groups = torch.tensor(2)
    out = HK.AggOutput("value", (0,), torch.int64)

    def run(vals, weight, ng=num_groups, cap=3, group=new_group):
        return HK.segment_agg(group, ng, cap, weight, [], [HK.AggRequest("sum", vals)], [out])

    with pytest.raises(TypeError):
        run(v.to(torch.float64), w)
    with pytest.raises(TypeError):
        run(v, w, ng=num_groups.to(torch.int32))
    with pytest.raises(ValueError):
        run(v, w[:4])
    with pytest.raises(ValueError):
        run(v, w, cap=0)
    # the padding slot (start = n) reads row n - 1 in the plain version, as
    # the reference's clipped cumsum-at-boundaries form does
    assert run(v + 2, w)[3][0][0].tolist() == [6, 10, 2]
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}
