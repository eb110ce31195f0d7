"""The aggregation kernels' designs on the CPU.

- The sort path past a NaN or an infinity: the reference sums a group's
  doubles as a difference of two prefix sums over the page, so such a
  value at or before a group's first row makes that group's sum NaN, and
  so do finite doubles whose prefix leaves the finite range. The port's
  ``megakernels.aggregate_phase`` (``segment_agg_plain`` on CPU tensors,
  whose rule ``segment_agg``'s kernel follows) against the reference's
  ``aggregate_phase`` in Pallas interpret mode, on pages with NaN, +inf,
  -inf, +inf beside -inf and 1e308 on three rows, in an early group, on a
  group's first row and on rows before the first group: identical rows
  (DOUBLE within ``tests/agg_tolerance.py``'s tolerance, NaN matching
  NaN).
- More weight columns than a ``segment_agg`` call reads (20 filtered sums):
  ``executor._agg_chunks`` splits the calls at ``SEGMENT_AGG_MAX_MASKS``
  distinct bool columns, the wrapper raises past it, and the port's
  ``aggregate_phase`` returns the reference's rows.
- ``segment_agg_direct.cu``'s reduce in numpy, each block a contiguous
  chunk of whole 256-row steps: at every G, warp steps of 32 rows whose
  lanes of one group are reduced in a fixed tree over their ranks and
  added by the group's lowest lane to the warp's accumulator, the warps
  folded in order; then the finish's fold of the blocks (strided over the
  threads, a shuffle tree in each warp, the warps in order), held against
  ``segment_agg_direct_plain`` at G = 1, 6, 8 and 256: integers exactly,
  float sums within 1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_long_tail import _assert_same_page
from trino_tpu.ops import megakernels as RMK
from trino_tpu.planner import plan as rplan
from trino_tpu.runtime import executor as rex
from trino_tpu.spi import types as rt
from trino_tpu.spi.page import Column as RColumn
from trino_tpu.spi.page import Page as RPage

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as PMK
from trino_tpu_torch.planner import plan as pplan
from trino_tpu_torch.runtime import executor as pex
from trino_tpu_torch.spi import types as pt
from trino_tpu_torch.spi.page import Column as PColumn
from trino_tpu_torch.spi.page import Page as PPage

REL_TOL = 1e-9

# --------------------------------------------------------------------------- #
# the sort path past a NaN or an infinity
# --------------------------------------------------------------------------- #

NONFINITE_VALUES = {"nan": (float("nan"),), "+inf": (float("inf"),), "-inf": (float("-inf"),),
                    "+inf beside -inf": (float("inf"), float("-inf")),
                    "1e308 on three rows": (1e308,) * 3}
# (a group holding one 1e308 row has a finite sum whose mean squares past
# the finite range: the reference's finishing on the CPU contracts
# s2 / n - mean * mean into a fused multiply-add there, +inf where the
# port rounds each operation alone, NaN, as torch does; so the places that
# put one 1e308 row in a group are held in test_torch_segment_agg.py's
# tile plan test, whose sums both engines share)
NONFINITE_PLACES = ("early group", "group's first row", "rows before the first group")
# (symbol, function, args, output type): the float sums' finishings and the
# extremes, which the reference does not take by prefix sums
NONFINITE_AGGS = [("s", "sum", ("x",), "double"), ("a", "avg", ("x",), "double"),
                  ("v", "stddev", ("x",), "double"), ("vp", "var_pop", ("x",), "double"),
                  ("sk", "skewness", ("x",), "double"), ("cv", "covar_pop", ("x", "y"), "double"),
                  ("mn", "min", ("x",), "double"), ("mx", "max", ("x",), "double"),
                  ("c", "count", ("x",), "bigint")]


def _nonfinite_pages(values, place, seed, n):
    """Both packages' pages, one BIGINT key in order (groups of about ten
    rows, its first 25 rows inactive: rows before the first group) and two
    doubles ``x`` and ``y``; ``x`` holds ``values`` at ``place``, on rows
    that are active and valid (before the first group: rows 3 and 4)."""
    rng = np.random.default_rng(seed)
    k = np.sort(rng.integers(0, n // 10, n))
    active = rng.random(n) < 0.9
    active[:25] = False
    x = rng.normal(0.0, 1e3, n)
    y = rng.normal(5.0, 1e2, n)
    xv, yv = rng.random(n) < 0.9, rng.random(n) < 0.9
    firsts = [25] + [i for i in range(26, n) if k[i] != k[i - 1]]
    at = {"rows before the first group": 3, "group's first row": firsts[5],
          "early group": firsts[2] + 1}[place]
    for j, v in enumerate(values):
        x[at + j] = v
        xv[at + j] = True
        if place != "rows before the first group":
            active[at + j] = True
    cols = {"k1": ("bigint", k, np.ones(n, bool)), "x": ("double", x, xv),
            "y": ("double", y, yv)}
    rcols = [RColumn(rt.parse_type(t), jnp.asarray(d), jnp.asarray(v)) for t, d, v in cols.values()]
    pcols = [PColumn(pt.parse_type(t), torch.from_numpy(np.ascontiguousarray(d)),
                     torch.from_numpy(v)) for t, d, v in cols.values()]
    return (("k1",), tuple(cols), RPage(tuple(rcols), jnp.asarray(active)),
            PPage(tuple(pcols), torch.from_numpy(active)))


def _aggs(plan, types):
    return tuple((sym, plan.Aggregation(fn, args, output_type=types.parse_type(out)))
                 for sym, fn, args, out in NONFINITE_AGGS)


@pytest.mark.parametrize("n", [3000, 12000])
@pytest.mark.parametrize("place", NONFINITE_PLACES)
@pytest.mark.parametrize("value", sorted(NONFINITE_VALUES))
def test_aggregate_phase_follows_the_reference_past_nan_and_infinities(value, place, n):
    """``aggregate_phase`` of both packages on the same presorted page, of
    3,000 rows (one cumsum scan) and of 12,000 (the cumsum by blocks of
    2,048 rows): the same rows, NaN and infinities at the same slots (a
    value before the first group is inactive there, so it moves no sum)."""
    keys, symbols, rpage, ppage = _nonfinite_pages(NONFINITE_VALUES[value], place,
                                                   len(value) * 3 + len(place), n)
    rp, rng_, rn, rviol = rex._presorted_group_impl(keys, symbols, symbols, rpage)
    pp, png, pn, pviol = pex._presorted_group_impl(keys, symbols, symbols, ppage)
    assert not bool(rviol) and not bool(pviol)
    np.testing.assert_array_equal(png.numpy(), np.asarray(rng_))
    out_cap = pex._round_capacity(int(pn), base=16)
    want, _ = RMK.aggregate_phase(keys, _aggs(rplan, rt), symbols, out_cap, rp, rng_, rn, None,
                                  True)
    PMK.reset_counts()
    aggs = _aggs(pplan, pt)
    got = PMK.aggregate_phase(keys, aggs, symbols, out_cap, pp, png, pn)
    assert PMK.STAGES["aggregate_torch"] == 0
    gid = torch.cumsum(png.to(torch.int64), 0) - 1
    _assert_same_page(got, want, aggs, pex.Relation(pp, symbols), len(keys), gid, out_cap,
                      np.arange(out_cap))
    total = np.asarray(want.columns[1].data)[np.asarray(want.active)]
    if place == "rows before the first group":
        assert np.isfinite(total).all()
    else:
        assert not np.isfinite(total).all()


# --------------------------------------------------------------------------- #
# more weight columns than one segment_agg call reads
# --------------------------------------------------------------------------- #

WIDE_FILTERS = 20


def _wide_filter_pages(n, seed):
    """Both packages' pages: a sorted BIGINT key, a BIGINT ``x`` with NULLs
    and WIDE_FILTERS boolean filter columns with NULLs."""
    rng = np.random.default_rng(seed)
    cols = {"k1": ("bigint", np.sort(rng.integers(0, n // 12, n)), np.ones(n, bool)),
            "x": ("bigint", rng.integers(-1000, 1000, n), rng.random(n) < 0.9)}
    for j in range(WIDE_FILTERS):
        cols[f"f{j}"] = ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.9)
    active = rng.random(n) < 0.9
    rcols = [RColumn(rt.parse_type(t), jnp.asarray(d), jnp.asarray(v)) for t, d, v in cols.values()]
    pcols = [PColumn(pt.parse_type(t), torch.from_numpy(np.ascontiguousarray(d)),
                     torch.from_numpy(v)) for t, d, v in cols.values()]
    return (("k1",), tuple(cols), RPage(tuple(rcols), jnp.asarray(active)),
            PPage(tuple(pcols), torch.from_numpy(active)))


def _wide_aggs(plan, types):
    return tuple((f"s{j}", plan.Aggregation("sum", ("x",), filter=f"f{j}",
                                            output_type=types.parse_type("bigint")))
                 for j in range(WIDE_FILTERS))


def test_aggregate_phase_splits_calls_past_the_weight_column_limit():
    """``sum(x) FILTER (WHERE f_j)`` over 20 filters reads 42 distinct bool
    columns (the activity, x's validity, each filter and its validity):
    ``executor._agg_chunks`` splits them into calls of at most
    ``SEGMENT_AGG_MAX_MASKS`` columns, and ``aggregate_phase`` returns the
    reference's rows; one call over two chunks' requests raises."""
    keys, symbols, rpage, ppage = _wide_filter_pages(4000, seed=7)
    rp, rng_, rn, _ = rex._presorted_group_impl(keys, symbols, symbols, rpage)
    pp, png, pn, _ = pex._presorted_group_impl(keys, symbols, symbols, ppage)
    out_cap = pex._round_capacity(int(pn), base=16)
    aggs = _wide_aggs(pplan, pt)
    rel = pex.Relation(pp, symbols)
    plans = [(i, pex._agg_plan(rel, agg)) for i, (_, agg) in enumerate(aggs)]
    chunks = pex._agg_chunks(plans, pp.active)
    assert len(chunks) == 3
    for chunk in chunks:
        requests = pex._chunk_requests(chunk)[0]
        assert len(HK.segment_agg_mask_columns(requests, pp.active)) <= HK.SEGMENT_AGG_MAX_MASKS
    requests, outputs = pex._chunk_requests(chunks[0] + chunks[1])
    with pytest.raises(ValueError, match="distinct bool columns"):
        HK.segment_agg(png, pn, out_cap, pp.active, [], requests, outputs)
    want, _ = RMK.aggregate_phase(keys, _wide_aggs(rplan, rt), symbols, out_cap, rp, rng_, rn,
                                  None, True)
    PMK.reset_counts()
    got = PMK.aggregate_phase(keys, aggs, symbols, out_cap, pp, png, pn)
    assert PMK.STAGES["aggregate_torch"] == 0
    gid = torch.cumsum(png.to(torch.int64), 0) - 1
    _assert_same_page(got, want, aggs, rel, len(keys), gid, out_cap, np.arange(out_cap))


# --------------------------------------------------------------------------- #
# segment_agg_direct's fold in numpy
# --------------------------------------------------------------------------- #

_THREADS, _WARPS = 256, 8
_SMEM_BUDGET = 32 * 1024
_NO_GROUP = HK.DIRECT_MAX_GROUPS
_OPS = {
    "count": lambda a, b: a + b,
    "sum": lambda a, b: (a + b + 2**63) % 2**64 - 2**63,
    "fsum": lambda a, b: a + b,
    "min": min, "max": max, "last": max,
    "bxor": lambda a, b: a ^ b,
}


def _tree(op, vals):
    """A step's group's contributions in rank order, reduced as the lanes
    do: round d, rank r (a multiple of 2d) takes rank r + d's partial."""
    vals = list(vals)
    d = 1
    while d < len(vals):
        for r in range(0, len(vals), 2 * d):
            if r + d < len(vals):
                vals[r] = op(vals[r], vals[r + d])
        d *= 2
    return vals[0]


def _block_fold(op, ident, per_thread):
    """direct_finish_kernel's block_fold: a shuffle-down tree in each warp
    (lane 0's result), then the warps in order."""
    warps = []
    for w in range(_WARPS):
        x = list(per_thread[w * 32:(w + 1) * 32])
        o = 16
        while o:
            x = [op(x[k], x[k + o]) if k + o < 32 else x[k] for k in range(32)]
            o //= 2
        warps.append(x[0])
    out = warps[0]
    for v in warps[1:]:
        out = op(out, v)
    return out


def _emulate_direct(gid, G, contribs, blocks):
    """``segment_agg_direct.cu``'s reduce and finish folds over ``blocks``
    blocks: per request (kind, identity, each row's contribution), the
    value of each of the G groups from the warps' trees (passes of as many
    requests as the shared memory holds; each pass folds the same way)."""
    n = gid.shape[0]
    chunk = -(-(-(-n // blocks)) // _THREADS) * _THREADS
    per_pass = max(1, _SMEM_BUDGET // (_WARPS * G * 8))
    partials = []
    for p0 in range(0, len(contribs), per_pass):
        for kind, ident, c in contribs[p0:p0 + per_pass]:
            op = _OPS[kind]
            rows = []
            for blk in range(blocks):
                b0, b1 = blk * chunk, min(blk * chunk + chunk, n)
                acc = [[ident] * G for _ in range(_WARPS)]
                for w in range(_WARPS):
                    for step in range(b0 + w * 32, b1, _THREADS):
                        lanes = [i for i in range(step, min(step + 32, b1))
                                 if gid[i] < G]
                        for g in sorted({int(gid[i]) for i in lanes}):
                            peers = [c[i] for i in lanes if gid[i] == g]
                            acc[w][g] = op(acc[w][g], _tree(op, peers))
                block = []
                for g in range(G):
                    x = acc[0][g]
                    for w in range(1, _WARPS):
                        x = op(x, acc[w][g])
                    block.append(x)
                rows.append(block)
            partials.append((op, ident, rows))
    values = []
    for op, ident, rows in partials:
        out = []
        for g in range(G):
            per_thread = []
            for t in range(_THREADS):
                x = ident
                for blk in range(t, blocks, _THREADS):
                    x = op(x, rows[blk][g])
                per_thread.append(x)
            out.append(_block_fold(op, ident, per_thread))
        values.append(out)
    return values


@pytest.mark.parametrize("blocks", [3, 300])
@pytest.mark.parametrize("domains", [(1,), (6,), (8,), (32, 8)])
def test_direct_fold_matches_segment_agg_direct_plain(domains, blocks):
    """The kernel's fold, emulated, against ``segment_agg_direct_plain`` on
    a count, an integer sum, a float sum, a min, a float max, the last row
    and a bitwise XOR over one or two keys with NULLs (G = 1, 6, 8, 256),
    at two grid sizes (more blocks than a block has threads among them)."""
    G = int(np.prod(domains))
    n = 6000 if G < 256 else 20_000
    rng = np.random.default_rng(G + blocks)
    active = rng.random(n) < 0.85
    keys = [(torch.from_numpy(rng.integers(0, max(D - 1, 1), n).astype(np.int32)),
             torch.from_numpy(rng.random(n) < 0.95)) for D in domains]
    ints = rng.integers(-(2**62), 2**62, n)
    dbl = rng.normal(0.0, 1e4, n)
    valid = rng.random(n) < 0.9
    t = torch.from_numpy
    R, O = HK.AggRequest, HK.AggOutput
    requests = [R("count", valid=t(valid)), R("sum", t(ints), t(valid)),
                R("fsum", t(dbl), t(valid)), R("min", t(ints), t(valid)),
                R("max", t(dbl), t(valid)), R("last", t(ints), t(valid)),
                R("bxor", t(ints), t(valid))]
    outputs = [O("value", (k,), dt) for k, dt in enumerate(
        (torch.int64, torch.int64, torch.float64, torch.int64, torch.float64))]
    outputs += [O("first", (5, 0), torch.int64, values=t(ints)),
                O("value", (6,), torch.int64)]
    exists, _, outs = HK.segment_agg_direct_plain(keys, domains, t(active), requests, outputs)
    gid = HK.direct_group_ids(keys, domains).numpy()
    gid = np.where(active, gid, _NO_GROUP)
    w = active & valid
    inf = float("inf")
    contribs = [("count", 0, np.where(active, 1, 0).tolist()),  # exists
                ("count", 0, w.astype(np.int64).tolist()),
                ("sum", 0, np.where(w, ints, 0).tolist()),
                ("fsum", 0.0, np.where(w, dbl, 0.0).tolist()),
                ("min", 2**63 - 1, np.where(w, ints, 2**63 - 1).tolist()),
                ("max", -inf, np.where(w, dbl, -inf).tolist()),
                ("last", -1, np.where(w, np.arange(n), -1).tolist()),
                ("bxor", 0, np.where(w, ints, 0).tolist())]
    values = _emulate_direct(gid, G, contribs, blocks)
    np.testing.assert_array_equal(np.array(values[0]) > 0, exists.numpy())
    ex = exists.numpy()
    for k, (data, _) in enumerate(outs):
        if k == 5:
            want = ints[np.clip(np.array(values[6]), 0, n - 1)]
        else:
            want = np.array(values[k + 1 if k < 5 else 7])
        if k == 2:
            np.testing.assert_allclose(want[ex], data.numpy()[ex], rtol=REL_TOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(want[ex], data.numpy()[ex])
