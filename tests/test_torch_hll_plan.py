"""``hll.cu``'s plan in numpy, held register for register against
``kernels.hll_registers`` and estimate for estimate against
``hopper_kernels.hll_plain``.

The kernel's prepare pass classes each slot from the tile bases: a group
cut by the edge of a block's range of tiles, or lying strictly inside one
tile between the tile's first and last groups, is global (its registers
zeroed in device memory); a slot past the last group estimates 0; every
other group is whole. The register pass gives each block a contiguous
range of whole tiles and keeps its current group's registers in shared
memory: each tile's first group (and, where the tile holds more than one,
its last) takes a shared max a weighted row, a group strictly inside the
tile a global max a row. When the group changes or the range ends the
block finishes it: a whole group's estimate from the shared registers, a
global one's non-zero registers merged into its global registers. The
estimate pass then finishes the global groups.

The emulation takes the tile and the tiles of a range as parameters, so
that pages of a few thousand rows reach every path: groups cut by one, two
and many ranges, tiles of many short groups, ranges whose weights are all
false, slots past the last group. Every slot is written exactly once, and
every global max lands in a zeroed global slot.
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import kernels as K

WHOLE, GLOBAL, EMPTY = 0, 1, 2
M = 1 << K.HLL_BITS


def _codes(values: np.ndarray):
    """Each row's register and rho, as ``hll_registers`` hashes it."""
    h = K.splitmix64(K.order_key(torch.from_numpy(values)))
    bucket = K._shift_right_logical(h, 64 - K.HLL_BITS)
    rest = h << K.HLL_BITS
    rho = torch.where(rest == 0, K.HLL_RHO_MAX, K._count_leading_zeros(rest) + 1)
    return bucket.numpy(), rho.numpy().astype(np.int32)


def _estimate(regs: np.ndarray) -> int:
    return int(K.hll_estimate(torch.from_numpy(regs.reshape(1, M)))[0])


def _tile_of_head(base: np.ndarray, k: int) -> int:
    """The last tile t with base[t] <= k."""
    return int(np.searchsorted(base[:-1], k, side="right")) - 1


def emulate_hll(new_group, values, weight, out_cap: int, tile: int, per: int):
    """The kernel's passes in numpy (see the module docstring). Returns the
    registers of every slot as its finish saw them, the estimates and the
    paths taken."""
    n = new_group.shape[0]
    n_tiles = -(-n // tile)
    gid = np.maximum(np.cumsum(new_group) - 1, 0)
    base = np.concatenate([[0], np.cumsum([new_group[t * tile:(t + 1) * tile].sum()
                                           for t in range(n_tiles)])]).astype(np.int64)
    heads = int(base[-1])
    bucket, rho = _codes(values)
    counts = weight & (gid < out_cap)

    def first_group(t):
        return max(int(base[t]) - 1 + int(new_group[t * tile]), 0)

    def last_group(t):
        return max(int(base[t + 1]) - 1, 0)

    # the prepare pass
    flags = np.zeros(out_cap, np.int64)
    for g in range(out_cap):
        if g >= max(heads, 1):
            flags[g] = EMPTY
            continue
        f = 0 if g == 0 else _tile_of_head(base, g)
        last = n_tiles - 1
        if g + 1 < heads:
            t = _tile_of_head(base, g + 1)
            last = t - 1 if base[t] == g + 1 and new_group[t * tile] else t
        cut = f // per != last // per
        inside = f == last and first_group(f) < g < last_group(f)
        flags[g] = GLOBAL if cut or inside else WHOLE
    glob = np.full((out_cap, M), -1, np.int32)  # -1: never zeroed
    glob[flags == GLOBAL] = 0
    out = np.full(out_cap, -7, np.int64)
    out[flags == EMPTY] = 0
    seen = {}  # a whole group's registers at its finish
    ran = {"whole": 0, "merged": 0, "inside rows": 0, "blocks": 0}

    def finish(g, sh):
        if 0 <= g < out_cap:
            if flags[g] == WHOLE:
                assert g not in seen, f"group {g} finished twice"
                seen[g] = sh.copy()
                out[g] = _estimate(sh)
                ran["whole"] += 1
            else:
                assert flags[g] == GLOBAL
                nz = sh != 0
                glob[g][nz] = np.maximum(glob[g][nz], sh[nz])
                ran["merged"] += 1
        sh[:] = 0

    # the register pass
    grid = -(-n_tiles // per)
    for b in range(grid):
        ran["blocks"] += 1
        sh = np.zeros(M, np.int32)
        cur = -1
        for t in range(b * per, min((b + 1) * per, n_tiles)):
            rows = np.arange(t * tile, min((t + 1) * tile, n))
            rows = rows[counts[rows]]
            g_lo, g_hi = first_group(t), last_group(t)
            if g_lo != cur:
                if cur >= 0:
                    finish(cur, sh)
                cur = g_lo
            lo = rows[gid[rows] == g_lo]
            np.maximum.at(sh, bucket[lo], rho[lo])
            inner = rows[(gid[rows] > g_lo) & (gid[rows] < g_hi)]
            for i in inner:
                assert flags[gid[i]] == GLOBAL and glob[gid[i], bucket[i]] >= 0
                glob[gid[i], bucket[i]] = max(glob[gid[i], bucket[i]], rho[i])
            ran["inside rows"] += len(inner)
            if g_hi != g_lo:
                finish(g_lo, sh)
                cur = g_hi
                hi = rows[gid[rows] == g_hi]
                np.maximum.at(sh, bucket[hi], rho[hi])
        if cur >= 0:
            finish(cur, sh)
    # the estimate pass
    regs = np.zeros((out_cap, M), np.int32)
    for g in range(out_cap):
        if flags[g] == GLOBAL:
            out[g] = _estimate(glob[g])
            regs[g] = glob[g]
        elif flags[g] == WHOLE:
            assert g in seen, f"whole group {g} never finished"
            regs[g] = seen[g]
    ran["global"] = int((flags == GLOBAL).sum())
    return regs, out, ran


def _page(n, firsts, seed, lead=0, dead=None, key_range=5_000, dtype=np.int64):
    """new_group with heads at ``firsts``, seeded values and a weight of
    about 90 % (none on the rows of ``dead``, a slice)."""
    rng = np.random.default_rng(seed)
    ng = np.zeros(n, bool)
    ng[np.asarray(firsts, np.int64)] = True
    values = rng.integers(0, key_range, n).astype(dtype)
    if dtype == np.float64:
        values = values / 7.0
    weight = rng.random(n) < 0.9
    weight[:lead] = False
    if dead is not None:
        weight[dead] = False
    return ng, values, weight


def _groups_of(n, lengths):
    return np.cumsum([0] + list(lengths))[:-1]


# (page, out_cap, tile, tiles per range): the page shapes chip_smoke.py's
# phase 2 adds for hll, at a small tile
CASES = {
    "one group over the whole page": (lambda: _page(3000, [0], 1), 16, 64, 5),
    "no head at all": (lambda: _page(3000, [], 2), 16, 64, 5),
    "rows before the first head": (lambda: _page(3000, [37, 900, 2000], 3, lead=37), 16, 64, 4),
    "groups cut by one range": (lambda: _page(3200, _groups_of(3200, [640] * 5), 4), 16, 64, 7),
    "groups cut by two ranges": (lambda: _page(3200, _groups_of(3200, [1100, 1100, 1000]), 5),
                                 16, 64, 6),
    "groups cut by many ranges": (lambda: _page(4096, [0, 10, 4000], 6), 16, 64, 2),
    "4096 groups of one row": (lambda: _page(4096, np.arange(4096), 7), 4096, 64, 3),
    "a range whose weights are all false": (
        lambda: _page(3000, _groups_of(3000, [500] * 6), 8, dead=slice(640, 1280)), 16, 64, 5),
    "slots past the last group": (lambda: _page(2500, [0, 700, 1400], 9), 64, 64, 4),
    "heads at tile starts": (lambda: _page(2048, np.arange(0, 2048, 64), 10), 32, 64, 3),
    "random groups, doubles": (lambda: _page(6000, np.flatnonzero(
        np.random.default_rng(11).random(6000) < 0.01), 12, dtype=np.float64), 128, 64, 4),
    "one row": (lambda: _page(1, [0], 13), 16, 64, 1),
    "one range": (lambda: _page(3000, _groups_of(3000, [30] * 100), 14), 128, 64, 100),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hll_plan_equals_the_plain_version(case):
    make, out_cap, tile, per = CASES[case]
    ng, values, weight = make()
    regs, out, ran = emulate_hll(ng, values, weight, out_cap, tile, per)
    t_ng, t_v, t_w = (torch.from_numpy(x) for x in (ng, values, weight))
    gid = (torch.cumsum(t_ng.to(torch.int64), 0) - 1).clamp(min=0)
    want_regs = K.hll_registers(t_v, t_w, gid, out_cap).numpy()
    np.testing.assert_array_equal(regs, want_regs)
    want, valid = HK.hll_plain(t_ng, out_cap, t_v, [t_w])
    np.testing.assert_array_equal(out, want.numpy())
    assert bool(valid.all())
    assert ran["whole"] + ran["global"] == max(int(ng.sum()), 1)


def test_hll_plan_reaches_every_path():
    """The cases between them finish whole groups, merge cut ones, take
    rows strictly inside a tile on the global path and leave slots past
    the last group."""
    total = {"whole": 0, "merged": 0, "inside rows": 0, "global": 0}
    for make, out_cap, tile, per in CASES.values():
        _, _, ran = emulate_hll(*make(), out_cap, tile, per)
        for k in total:
            total[k] += ran[k]
    assert all(v > 0 for v in total.values()), total
    _, _, ran = emulate_hll(*CASES["groups cut by many ranges"][0](), 16, 64, 2)
    assert ran["merged"] >= 30  # the middle group spans 31 ranges
    _, _, ran = emulate_hll(*CASES["4096 groups of one row"][0](), 4096, 64, 3)
    assert ran["inside rows"] > 3500


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 67_108_864, 4_194_304 + 3])
@pytest.mark.parametrize("blocks", [1, 5, 8])
def test_hll_plan_covers_every_tile_once(n, blocks):
    sms = 132
    per, grid = HK.hll_plan(n, sms, blocks)
    n_tiles = -(-n // HK.SEGMENT_TILE_ROWS)
    assert grid <= max(sms * blocks, 1) and grid >= 1
    covered = np.zeros(n_tiles, np.int64)
    for b in range(grid):
        covered[b * per:min((b + 1) * per, n_tiles)] += 1
    assert (covered == 1).all()
    assert (grid - 1) * per < n_tiles  # no block without a tile
