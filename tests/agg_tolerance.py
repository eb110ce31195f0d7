"""The tolerance of an aggregate's DOUBLE output that two engines sum in
different orders (plain torch and numpy: no JAX, so ``chip_smoke.py``
imports it as it imports ``tests/tpch_corpus.py``).

The reference's moments are one-pass formulas: a sum of squares less the
squared mean, central moments from raw power sums. Where a group's values
are nearly equal those terms cancel, and a difference in the last bits of
a sum (another order of adds: XLA's against torch's, a kernel's tiles
against a cumsum) becomes a large difference relative to the result (a
``var_pop`` of 1.93e-8 against 0.0 over equal values). A tolerance
relative to the result cannot hold there; one relative to the terms that
cancel can. So each float sum an output reads may differ by ``REL_TOL``
of the sum of its terms' magnitudes, and that difference is carried
through the output's own finishing: the tolerance of a slot is the sum,
over its float sums, of the larger change of the output when that sum
moves up or down by its allowance, plus ``REL_TOL`` of the output.
"""

from dataclasses import replace

import torch

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import kernels as K

REL_TOL = 1e-9


def float_tolerance(requests, output, active: torch.Tensor, gid: torch.Tensor,
                    slots: int) -> torch.Tensor:
    """Per-slot tolerance of ``output`` (an ``HK.AggOutput`` over
    ``requests``, as ``executor._agg_plan`` makes them) on a page whose
    rows belong to slot ``gid`` (int64, -1: no slot)."""
    in_slot = gid >= 0
    g = gid.clamp(min=0)

    def reduce_fn(vals, w, kind):
        if kind in K.BITWISE_KINDS:
            return K.bitwise_group_reduce(vals, w & in_slot, g, slots, kind)
        return K.direct_group_reduce(vals, w & in_slot, g, slots, kind)

    def magnitude_fn(vals, w, kind):
        return reduce_fn(vals.abs() if vals.is_floating_point() else vals, w, kind)

    def first_fn(vals, w):
        return K.direct_group_first(vals, w & in_slot, g, slots)

    def broadcast_fn(per_slot):
        return per_slot[g]

    results = HK.run_requests(requests, active, reduce_fn, first_fn, broadcast_fn)
    terms = HK.run_requests(requests, active, magnitude_fn, first_fn, broadcast_fn)
    base = HK.finish_output(output, results, slots)[0].to(torch.float64)
    tol = REL_TOL * base.abs()
    for k in set(output.reads):
        if k < 0 or requests[k].kind != "fsum":
            continue
        moved = []
        for sign in (1.0, -1.0):
            shifted = list(results)
            shifted[k] = results[k] + sign * REL_TOL * terms[k]
            moved.append((HK.finish_output(output, shifted, slots)[0] - base).abs())
        tol = tol + torch.nan_to_num(torch.maximum(*moved), nan=0.0)
    return tol


def within(got: torch.Tensor, want: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """Where ``got`` is within ``tol`` of ``want`` (NaN matching NaN, an
    infinity matching itself)."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    return same | ((got - want).abs() <= tol)


def digest_tolerance(output, new_group: torch.Tensor, slots: int) -> torch.Tensor:
    """Per slot and lane, the tolerance of a digest output (an
    ``HK.AggOutput`` of op ``digest`` over a group-sorted page's
    ``new_group``): ``REL_TOL`` of the mean of each centroid's values'
    magnitudes on its mean (the same centroids: they follow the ranks,
    not the values), 0 on its weight."""
    gid = (K.cumsum(new_group) - 1).clamp(min=0)
    starts = K.boundary_positions(new_group, slots)
    w2 = output.values_valid
    nonempty = torch.zeros(slots, dtype=torch.int64, device=w2.device).index_add_(
        0, gid, w2.to(torch.int64))
    mag = replace(output, values=output.values.abs())
    tol = REL_TOL * HK.finish_output(mag, {output.reads[0]: nonempty}, slots, starts, gid)[0]
    tol[:, HK.DIGEST_CENTROIDS:] = 0.0
    return tol
