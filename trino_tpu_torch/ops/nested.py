"""ARRAY, MAP and ROW expressions and the lambda-taking functions.

The port's counterpart of ``trino_tpu.ops.compiler``'s nested-value plane
(``_compile_nested``, ``_compile_higher_order`` and their lane helpers),
over the pad-and-mask layout of ``spi/page.py``: an array value is
``data[cap, W]`` + ``elem_valid[cap, W]`` + ``lengths[cap]``, a map two
array children sharing ``lengths``, a row one child per field. Every
function is a handful of ``[cap, W]`` lane operations (a gather along the
lanes, a masked reduction, a stable sort of each row's lanes); nothing
loops over rows.

A lambda body compiles to its own closure over the flattened ``[cap*W]``
lane grid: its parameters are the lanes, and the outer symbols it reads
are repeated onto the grid. ``reduce`` is the reference's loop over the W
lanes, in lane order. As in the reference, a lambda over nested elements
or returning a nested value raises.

The compiler (``ops/compiler.py``) sends ``NESTED_FUNCS`` to
:func:`compile_nested` and the names of ``sql.functions.HIGHER_ORDER_FUNCTIONS``
to :func:`compile_higher_order`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..spi.page import Dictionary
from ..spi.types import ArrayType, MapType, RowType, Type, is_nested, is_string
from ..sql.ir import Constant, Lambda, references
from . import compiler as C
from . import kernels as K
from .scalar_functions import CompileError

NESTED_FUNCS = frozenset(
    {
        "$array", "$row", "$map", "$field", "$subscript", "element_at",
        "cardinality", "contains", "array_position", "array_min", "array_max",
        "array_sort", "array_distinct", "$array_concat", "slice",
        "map_keys", "map_values", "array_remove", "array_except",
        "array_intersect", "arrays_overlap", "trim_array", "repeat",
        "map_concat", "sequence",
    }
)


# --------------------------------------------------------------------------- #
# lane helpers
# --------------------------------------------------------------------------- #


def repeat_cval(v, w: int):
    """A ``[cap]``-row value broadcast to the ``[cap*w]`` lane grid."""

    def rep(x):
        return None if x is None else torch.repeat_interleave(x, w, dim=0)

    return C.CVal(rep(v.data), rep(v.valid), v.dictionary, rep(v.lengths),
                 rep(v.elem_valid), tuple(repeat_cval(c, w) for c in v.children))


def merge_dicts(dicts) -> Dictionary:
    """One element dictionary for string-array construction and
    concatenation; every contributing value must be dictionary-coded."""
    if any(d is None for d in dicts):
        raise CompileError("string array elements must be dictionary-coded")
    return C._merge_dicts(dicts)


def remap_codes(data: torch.Tensor, from_dict, to_dict) -> torch.Tensor:
    """Codes of ``from_dict`` translated into ``to_dict`` (a value
    ``to_dict`` lacks becomes -1, which equals no real code)."""
    return C._gather_codes(C._remap_lut(from_dict, to_dict, data.device), data)


def null_cval(type_: Type, cap: int, device):
    """An all-NULL value of ``type_`` (a nested type gets empty lanes and
    children)."""
    invalid = torch.zeros(cap, dtype=torch.bool, device=device)
    if isinstance(type_, ArrayType):
        return C.CVal(
            torch.zeros((cap, 1), dtype=type_.element.torch_dtype, device=device), invalid,
            lengths=torch.zeros(cap, dtype=torch.int32, device=device),
            elem_valid=torch.zeros((cap, 1), dtype=torch.bool, device=device))
    if isinstance(type_, MapType):
        kids = tuple(null_cval(kt, cap, device) for kt in type_.child_types())
        return C.CVal(torch.zeros(cap, dtype=torch.int8, device=device), invalid,
                     lengths=torch.zeros(cap, dtype=torch.int32, device=device),
                     children=kids)
    if isinstance(type_, RowType):
        kids = tuple(null_cval(kt, cap, device) for kt in type_.child_types())
        return C.CVal(torch.zeros(cap, dtype=torch.int8, device=device), invalid,
                     children=kids)
    lanes = () if type_.storage_lanes is None else (type_.storage_lanes,)
    return C.CVal(torch.zeros((cap,) + lanes, dtype=type_.torch_dtype, device=device), invalid)


def lane_present(a) -> torch.Tensor:
    """[cap, W]: the lane is one of the array's positions."""
    w = a.data.shape[1]
    return torch.arange(w, device=a.data.device)[None, :] < a.lengths[:, None]


def lane_equals(a, x) -> torch.Tensor:
    """[cap, W] equality of array lanes against a scalar column, codes
    translated when the vocabularies differ; mixed integral widths compare
    as int64."""
    xd = x.data
    if a.dictionary is not None and x.dictionary is not None:
        xd = remap_codes(xd, x.dictionary, a.dictionary)
    ad = a.data
    if ad.dtype != xd.dtype and not ad.is_floating_point() and not xd.is_floating_point() \
            and ad.dtype != torch.bool and xd.dtype != torch.bool:
        eq = ad.to(torch.int64) == xd.to(torch.int64)[:, None]
    else:
        eq = ad == xd[:, None].to(ad.dtype)
    return eq & a.elem_valid & x.valid[:, None]


def lane_member(a, b) -> torch.Tensor:
    """[cap, Wa]: a's element is among b's (by value; a NULL element of a
    matches where b holds a NULL: the set functions treat NULL as one
    value)."""
    ad, bd = a.data, b.data
    if a.dictionary is not None and b.dictionary is not None and a.dictionary is not b.dictionary:
        bd = remap_codes(bd, b.dictionary, a.dictionary)
    if ad.dtype != bd.dtype:
        ad, bd = ad.to(torch.int64), bd.to(torch.int64)
    pb = lane_present(b)
    eq = ((ad[:, :, None] == bd[:, None, :]) & a.elem_valid[:, :, None]
          & (b.elem_valid & pb)[:, None, :])
    member = eq.any(2)
    b_has_null = (pb & ~b.elem_valid).any(1)
    return torch.where(a.elem_valid, member, b_has_null[:, None])


def _sort_lanes(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, dim=1, stable=True).indices


def _first_of_runs(key: torch.Tensor, present: torch.Tensor, order: torch.Tensor):
    """Keep mask in lane order: a present lane that is not a later duplicate
    of an equal key within its row, given ``order`` sorting the keys."""
    ks = torch.gather(key, 1, order)
    pres_s = torch.gather(present, 1, order)
    dup_s = torch.zeros_like(pres_s)
    dup_s[:, 1:] = pres_s[:, 1:] & (ks[:, 1:] == ks[:, :-1])
    inv = torch.argsort(order, dim=1)
    return present & ~torch.gather(dup_s, 1, inv)


def _null_last_key(a, present: torch.Tensor) -> torch.Tensor:
    """Lane sort key: values in order, then NULL elements, then absent
    lanes."""
    return torch.where(
        present & a.elem_valid, K.order_key(a.data),
        torch.where(present, torch.tensor(K.INT64_MAX - 1, device=a.data.device),
                    torch.tensor(K.INT64_MAX, device=a.data.device)))


def lane_compact(a, keep: torch.Tensor, distinct: bool, valid=None):
    """Stable compaction of each row's lanes to the kept elements;
    ``distinct`` also drops later duplicates (by value; the NULLs collapse
    to one)."""
    if distinct:
        key = _null_last_key(a, keep)
        keep = _first_of_runs(key, keep, _sort_lanes(key))
    korder = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    data = torch.gather(a.data, 1, korder)
    ev = torch.gather(a.elem_valid, 1, korder) & torch.gather(keep, 1, korder)
    lengths = keep.sum(1).to(torch.int32)
    return C.CVal(data, a.valid if valid is None else valid, a.dictionary, lengths, ev)


def _lengths_of(v) -> torch.Tensor:
    return v.lengths if v.lengths is not None else v.children[0].lengths


# --------------------------------------------------------------------------- #
# constructors, accessors and array functions
# --------------------------------------------------------------------------- #


def dict_tree(c, expr):
    """Compile-time dictionary information of a (possibly nested)
    expression: a Dictionary/None for scalars and arrays, a tuple of
    subtrees for maps (keys, values) and rows (fields)."""
    from ..sql.ir import Call, Reference

    if isinstance(expr, Reference):
        lay = c.layout.get(expr.symbol)
        if lay is None:
            return None
        if isinstance(expr.type, MapType) or expr.type.name == "row":
            return lay.child_dicts
        return lay.dictionary
    if isinstance(expr, Call):
        if expr.name == "$row":
            return tuple(dict_tree(c, a) for a in expr.args)
        if expr.name == "$map":
            return (dict_tree(c, expr.args[0]), dict_tree(c, expr.args[1]))
        if expr.name == "$field":
            sub = dict_tree(c, expr.args[0])
            idx = int(expr.args[1].value)
            return sub[idx] if isinstance(sub, tuple) and idx < len(sub) else None
    try:
        return c.compile(expr)[1]
    except CompileError:
        return None


def _pair_dicts(tree):
    """(keys, values) Dictionary/None of a map's dictionary tree."""
    if not (isinstance(tree, tuple) and len(tree) == 2):
        return None, None
    return tuple(d if isinstance(d, Dictionary) else None for d in tree)


def compile_nested(c, expr) -> Tuple:
    """ARRAY/MAP/ROW constructors, accessors and functions (the reference's
    ``_compile_nested``). ``c`` is the compiler (layout, capacity, device)."""
    name = expr.name
    cap, dev = c.capacity, c.device
    arg_fns = [c.compile(a)[0] for a in expr.args]
    arg_types = [a.type for a in expr.args]
    out_t = expr.type

    def ones():
        return torch.ones(cap, dtype=torch.bool, device=dev)

    def dummy():
        return torch.zeros(cap, dtype=torch.int8, device=dev)

    def lanes_of(w):
        return torch.arange(w, device=dev)[None, :]

    if name == "$array":
        el_t = out_t.element
        merged = None
        if is_string(el_t):
            # a NULL element adds no vocabulary; every other element must be
            # dictionary-coded
            el_dicts = [c.compile(a)[1] for a in expr.args
                        if not (isinstance(a, Constant) and a.value is None)]
            merged = merge_dicts(el_dicts) if el_dicts else None

        def array_fn(env):
            vals = [f(env) for f in arg_fns]
            if not vals:
                data = torch.zeros((cap, 1), dtype=el_t.torch_dtype, device=dev)
                ev = torch.zeros((cap, 1), dtype=torch.bool, device=dev)
            else:
                datas = [remap_codes(v.data, v.dictionary, merged)
                         if merged is not None and v.dictionary is not None else v.data
                         for v in vals]
                dt = functools.reduce(torch.promote_types, [d.dtype for d in datas])
                data = torch.stack([d.to(dt) for d in datas], 1)
                ev = torch.stack([v.valid for v in vals], 1)
            lengths = torch.full((cap,), len(vals), dtype=torch.int32, device=dev)
            return C.CVal(data, ones(), merged, lengths, ev)

        return array_fn, merged

    if name == "$row":

        def row_fn(env):
            return C.CVal(dummy(), ones(), children=tuple(f(env) for f in arg_fns))

        return row_fn, None

    if name == "$map":

        def map_fn(env):
            k, v = arg_fns[0](env), arg_fns[1](env)
            valid = k.valid & v.valid & (k.lengths == v.lengths)
            return C.CVal(dummy(), valid, lengths=k.lengths, children=(k, v))

        return map_fn, None

    if name == "$field":
        idx = int(expr.args[1].value)

        def field_fn(env):
            r = arg_fns[0](env)
            f = r.children[idx]
            return C.CVal(f.data, f.valid & r.valid, f.dictionary, f.lengths, f.elem_valid,
                         f.children)

        d = dict_tree(c, expr)
        return field_fn, d if isinstance(d, Dictionary) else None

    if name in ("$subscript", "element_at") and isinstance(arg_types[0], ArrayType):
        el_t = arg_types[0].element

        def sub_fn(env):
            a, i = arg_fns[0](env), arg_fns[1](env)
            w = a.data.shape[1]
            pos = i.data.to(torch.int64) - 1  # SQL arrays are 1-based
            safe = pos.clamp(0, w - 1)[:, None]
            data = torch.gather(a.data, 1, safe)[:, 0]
            ev = torch.gather(a.elem_valid, 1, safe)[:, 0]
            in_range = (pos >= 0) & (pos < a.lengths.to(torch.int64))
            return C.CVal(data, a.valid & i.valid & in_range & ev, a.dictionary)

        d = c.compile(expr.args[0])[1]
        return sub_fn, d if is_string(el_t) else None

    if name in ("$subscript", "element_at") and isinstance(arg_types[0], MapType):

        def mapsub_fn(env):
            m, k = arg_fns[0](env), arg_fns[1](env)
            keys, vals = m.children
            eq = lane_equals(keys, k)
            found = eq.any(1)
            pos = torch.argmax(eq.to(torch.int8), 1)[:, None]
            data = torch.gather(vals.data, 1, pos)[:, 0]
            ev = torch.gather(vals.elem_valid, 1, pos)[:, 0]
            return C.CVal(data, m.valid & k.valid & found & ev, vals.dictionary)

        _, vd = _pair_dicts(dict_tree(c, expr.args[0]))
        return mapsub_fn, vd

    if name == "cardinality":

        def card_fn(env):
            v = arg_fns[0](env)
            return C.CVal(_lengths_of(v).to(torch.int64), v.valid)

        return card_fn, None

    if name == "contains":

        def contains_fn(env):
            a, x = arg_fns[0](env), arg_fns[1](env)
            present = lane_present(a)
            match = (lane_equals(a, x) & present).any(1)
            has_null = (present & ~a.elem_valid).any(1)
            return C.CVal(match, a.valid & x.valid & (match | ~has_null))

        return contains_fn, None

    if name == "array_position":

        def pos_fn(env):
            a, x = arg_fns[0](env), arg_fns[1](env)
            eq = lane_equals(a, x) & lane_present(a)
            first = torch.argmax(eq.to(torch.int8), 1).to(torch.int64) + 1
            return C.CVal(torch.where(eq.any(1), first, 0), a.valid & x.valid)

        return pos_fn, None

    if name in ("array_min", "array_max"):
        el_t = arg_types[0].element
        is_min = name == "array_min"

        def minmax_fn(env):
            a = arg_fns[0](env)
            present = lane_present(a)
            dt = a.data.dtype
            if dt.is_floating_point:
                sent = float("inf") if is_min else float("-inf")
            elif dt == torch.bool:
                sent = is_min
            else:
                info = torch.iinfo(dt)
                sent = info.max if is_min else info.min
            masked = torch.where(present & a.elem_valid, a.data,
                                 torch.tensor(sent, dtype=dt, device=dev))
            if dt == torch.bool:
                data = masked.all(1) if is_min else masked.any(1)
            else:
                data = masked.amin(1) if is_min else masked.amax(1)
            has_null = (present & ~a.elem_valid).any(1)
            return C.CVal(data, a.valid & (a.lengths > 0) & ~has_null, a.dictionary)

        d = c.compile(expr.args[0])[1]
        return minmax_fn, d if is_string(el_t) else None

    if name in ("array_sort", "array_distinct"):
        distinct = name == "array_distinct"

        def sort_fn(env):
            a = arg_fns[0](env)
            present = lane_present(a)
            # values in order, NULL elements after them, absent lanes last
            key = _null_last_key(a, present)
            order = _sort_lanes(key)
            if not distinct:
                return C.CVal(torch.gather(a.data, 1, order), a.valid, a.dictionary, a.lengths,
                             torch.gather(a.elem_valid, 1, order))
            # the first occurrence of each value, in the original order
            keep = _first_of_runs(key, present, order)
            korder = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
            ev = torch.gather(a.elem_valid, 1, korder) & torch.gather(keep, 1, korder)
            return C.CVal(torch.gather(a.data, 1, korder), a.valid, a.dictionary,
                         keep.sum(1).to(torch.int32), ev)

        return sort_fn, c.compile(expr.args[0])[1]

    if name == "$array_concat":
        el_t = out_t.element
        d0, d1 = c.compile(expr.args[0])[1], c.compile(expr.args[1])[1]
        merged = merge_dicts([d0, d1]) if is_string(el_t) else None

        def concat_fn(env):
            a, b = arg_fns[0](env), arg_fns[1](env)
            wa, wb = a.data.shape[1], b.data.shape[1]
            w = wa + wb
            da, db = a.data, b.data
            if merged is not None:
                da = remap_codes(da, a.dictionary, merged)
                db = remap_codes(db, b.dictionary, merged)
            if da.dtype != db.dtype:
                dt = torch.result_type(da, db)
                da, db = da.to(dt), db.to(dt)
            j = lanes_of(w)
            la = a.lengths[:, None].to(torch.int64)
            from_a = j < la
            ia = j.clamp(0, wa - 1).expand(cap, w)
            ib = (j - la).clamp(0, wb - 1).expand(cap, w)
            data = torch.where(from_a, torch.gather(da, 1, ia), torch.gather(db, 1, ib))
            ev = torch.where(from_a, torch.gather(a.elem_valid, 1, ia),
                             torch.gather(b.elem_valid, 1, ib))
            lengths = a.lengths + b.lengths
            return C.CVal(data, a.valid & b.valid, merged, lengths, ev & (j < lengths[:, None]))

        return concat_fn, merged

    if name == "slice":

        def slice_fn(env):
            a, s, ln = arg_fns[0](env), arg_fns[1](env), arg_fns[2](env)
            w = a.data.shape[1]
            start = s.data.to(torch.int64)
            length = ln.data.to(torch.int64).clamp(min=0)
            lens = a.lengths.to(torch.int64)
            eff = torch.where(start > 0, start - 1, lens + start)
            j = lanes_of(w)
            src = eff[:, None] + j
            take = (j < length[:, None]) & (src >= 0) & (src < lens[:, None])
            safe = src.clamp(0, w - 1)
            data = torch.gather(a.data, 1, safe)
            ev = torch.gather(a.elem_valid, 1, safe) & take
            valid = a.valid & s.valid & ln.valid & (start != 0)
            return C.CVal(data, valid, a.dictionary, take.sum(1).to(torch.int32), ev)

        return slice_fn, c.compile(expr.args[0])[1]

    if name in ("map_keys", "map_values"):
        idx = 0 if name == "map_keys" else 1

        def extract_fn(env):
            m = arg_fns[0](env)
            ch = m.children[idx]
            return C.CVal(ch.data, m.valid, ch.dictionary, ch.lengths, ch.elem_valid)

        return extract_fn, _pair_dicts(dict_tree(c, expr.args[0]))[idx]

    if name == "array_remove":

        def remove_fn(env):
            a, x = arg_fns[0](env), arg_fns[1](env)
            keep = lane_present(a) & ~lane_equals(a, x)
            return lane_compact(a, keep, distinct=False, valid=a.valid & x.valid)

        return remove_fn, c.compile(expr.args[0])[1]

    if name in ("array_except", "array_intersect"):
        except_ = name == "array_except"

        def setop_fn(env):
            a, b = arg_fns[0](env), arg_fns[1](env)
            member = lane_member(a, b)
            keep = lane_present(a) & (~member if except_ else member)
            return lane_compact(a, keep, distinct=True, valid=a.valid & b.valid)

        return setop_fn, c.compile(expr.args[0])[1]

    if name == "arrays_overlap":

        def overlap_fn(env):
            a, b = arg_fns[0](env), arg_fns[1](env)
            pa, pb = lane_present(a), lane_present(b)
            real = (pa & a.elem_valid & lane_member(a, b)).any(1)
            a_null = (pa & ~a.elem_valid).any(1)
            b_null = (pb & ~b.elem_valid).any(1)
            # a real match decides TRUE; else a NULL element on either side
            # makes the answer unknown
            return C.CVal(real, a.valid & b.valid & (real | ~(a_null | b_null)))

        return overlap_fn, None

    if name == "trim_array":

        def trim_fn(env):
            a, n = arg_fns[0](env), arg_fns[1](env)
            cut = n.data.to(torch.int64).clamp(min=0)
            new_len = (a.lengths.to(torch.int64) - cut).clamp(min=0).to(torch.int32)
            pres = lanes_of(a.data.shape[1]) < new_len[:, None]
            # the reference clamps to empty where Trino raises
            return C.CVal(a.data, a.valid & n.valid, a.dictionary, new_len, a.elem_valid & pres)

        return trim_fn, c.compile(expr.args[0])[1]

    if name == "sequence":
        if not all(isinstance(a, Constant) for a in expr.args):
            raise CompileError("sequence: bounds must be literals (static lane width)")
        start, stop = int(expr.args[0].value), int(expr.args[1].value)
        step = int(expr.args[2].value) if len(expr.args) > 2 else (1 if stop >= start else -1)
        if step == 0:
            raise CompileError("sequence: step must not be zero")
        seq = list(range(start, stop + (1 if step > 0 else -1), step))
        wseq = max(len(seq), 1)
        seq_t = torch.tensor(seq or [0], dtype=torch.int64, device=dev)

        def seq_fn(env):
            data = seq_t[None, :].expand(cap, wseq)
            ev = torch.full((cap, wseq), bool(seq), dtype=torch.bool, device=dev)
            lengths = torch.full((cap,), len(seq), dtype=torch.int32, device=dev)
            return C.CVal(data, ones(), None, lengths, ev)

        return seq_fn, None

    if name == "repeat":
        cnt = expr.args[1]
        if not isinstance(cnt, Constant):
            raise CompileError("repeat: count must be a literal (static lane width)")
        if cnt.value is None:  # a NULL count is a NULL result
            return (lambda env: null_cval(out_t, cap, dev)), None
        wn = max(int(cnt.value), 0)

        def repeat_fn(env):
            x = arg_fns[0](env)
            w = max(wn, 1)
            return C.CVal(x.data[:, None].expand(cap, w), ones(), x.dictionary,
                         torch.full((cap,), wn, dtype=torch.int32, device=dev),
                         x.valid[:, None].expand(cap, w))

        return repeat_fn, c.compile(expr.args[0])[1]

    if name == "map_concat":
        pairs = [_pair_dicts(dict_tree(c, a)) for a in expr.args]
        kdicts = [k for k, _ in pairs]
        vdicts = [v for _, v in pairs]
        mk = merge_dicts([d for d in kdicts if d is not None]) if any(kdicts) else None
        mv = merge_dicts([d for d in vdicts if d is not None]) if any(vdicts) else None

        def mapcat_fn(env):
            ms = [f(env) for f in arg_fns]
            kds, vds, keys_ev, vals_ev, press = [], [], [], [], []
            for m, kd_, vd_ in zip(ms, kdicts, vdicts):
                k, v = m.children
                kds.append(remap_codes(k.data, kd_, mk) if mk is not None else k.data)
                vds.append(remap_codes(v.data, vd_, mv) if mv is not None else v.data)
                keys_ev.append(k.elem_valid)
                vals_ev.append(v.elem_valid)
                press.append(lanes_of(k.data.shape[1]) < m.lengths[:, None])
            kd, vd = torch.cat(kds, 1), torch.cat(vds, 1)
            kev, vev = torch.cat(keys_ev, 1), torch.cat(vals_ev, 1)
            pres = torch.cat(press, 1)
            W = kd.shape[1]
            key = torch.where(pres & kev, K.order_key(kd),
                              torch.tensor(K.INT64_MAX, device=dev))
            # the LAST occurrence of a key wins (a later map overrides):
            # order by (key, position descending), keep each run's first
            rev = torch.arange(W - 1, -1, -1, device=dev).expand(cap, W)
            order = torch.sort(rev, dim=1, stable=True).indices
            order = torch.gather(order, 1, torch.sort(torch.gather(key, 1, order), dim=1,
                                                      stable=True).indices)
            keep = pres & kev & _first_of_runs(key, pres, order)
            korder = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
            lengths = keep.sum(1).to(torch.int32)
            keep_s = torch.gather(keep, 1, korder)
            kc = C.CVal(torch.gather(kd, 1, korder), ones(), mk, lengths,
                       torch.gather(kev, 1, korder) & keep_s)
            vc = C.CVal(torch.gather(vd, 1, korder), ones(), mv, lengths,
                       torch.gather(vev, 1, korder) & keep_s)
            valid = ms[0].valid
            for m in ms[1:]:
                valid = valid & m.valid
            return C.CVal(dummy(), valid, lengths=lengths, children=(kc, vc))

        return mapcat_fn, (mk, mv)

    raise CompileError(f"nested function {name} not implemented")


# --------------------------------------------------------------------------- #
# lambdas
# --------------------------------------------------------------------------- #


def _lambda_layout(c, lam: Lambda, param_dicts):
    lay = dict(c.layout)
    for p, pt, pd in zip(lam.params, lam.param_types, param_dicts):
        lay[p] = C.ColumnLayout(pt, pd)
    return lay


def _lambda_free_env(lam: Lambda, env, w: int):
    """The outer symbols the body reads, repeated onto the lane grid."""
    free = references(lam.body) - set(lam.params)
    return {s: repeat_cval(env[s], w) for s in free if s in env}


def _lanes(x: torch.Tensor, dictionary=None, valid=None):
    """A [cap, W] lane tensor flattened to the [cap*W] grid as a value."""
    return C.CVal(x.reshape(-1), valid.reshape(-1), dictionary)


def compile_higher_order(c, expr) -> Tuple:
    """The lambda-taking array and map functions (the reference's
    ``_compile_higher_order``)."""
    compile_expression = C.compile_expression
    name = expr.name
    cap, dev = c.capacity, c.device
    for a in expr.args:
        if isinstance(a, Lambda) and (
                is_nested(a.type) or any(is_nested(p) for p in a.param_types)):
            raise CompileError(
                f"{name} over nested (array/map/row) elements or with a "
                "nested-returning lambda is not supported yet")

    def body_dict(lam, lay) -> Optional[Dictionary]:
        return compile_expression(lam.body, lay, 1, dev)[1]

    def lanes_of(w):
        return torch.arange(w, device=dev)[None, :]

    if name in ("transform", "filter", "any_match", "all_match", "none_match"):
        arr_fn, arr_dict = c.compile(expr.args[0])
        lam = expr.args[1]
        lay = _lambda_layout(c, lam, (arr_dict,))
        out_dict = body_dict(lam, lay)

        def run_body(env):
            a = arr_fn(env)
            w = a.data.shape[1]
            fenv = _lambda_free_env(lam, env, w)
            fenv[lam.params[0]] = _lanes(a.data, a.dictionary, a.elem_valid)
            r = compile_expression(lam.body, lay, cap * w, dev)[0](fenv)
            return a, w, r, lanes_of(w) < a.lengths[:, None]

        if name == "transform":

            def transform_fn(env):
                a, w, r, present = run_body(env)
                return C.CVal(r.data.reshape(cap, w), a.valid, out_dict, a.lengths,
                             r.valid.reshape(cap, w) & present)

            return transform_fn, out_dict

        if name == "filter":

            def filter_fn(env):
                a, w, r, present = run_body(env)
                keep = (r.data.to(torch.bool) & r.valid).reshape(cap, w) & present
                order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
                new_len = keep.sum(1).to(torch.int32)
                ev = torch.gather(a.elem_valid, 1, order) & (lanes_of(w) < new_len[:, None])
                return C.CVal(torch.gather(a.data, 1, order), a.valid, a.dictionary, new_len, ev)

            return filter_fn, arr_dict

        def match_fn(env):
            # three-valued: any_match is TRUE on a true verdict, FALSE when
            # all are false, NULL when none is true but one is NULL
            a, w, r, present = run_body(env)
            bd = r.data.to(torch.bool).reshape(cap, w)
            bv = r.valid.reshape(cap, w)
            any_true = (bd & bv & present).any(1)
            any_false = (~bd & bv & present).any(1)
            any_null = (~bv & present).any(1)
            if name == "any_match":
                data, det = any_true, any_true | ~any_null
            elif name == "all_match":
                data, det = ~any_false, any_false | ~any_null
            else:
                data, det = ~any_true, any_true | ~any_null
            return C.CVal(data, a.valid & det)

        return match_fn, None

    if name == "zip_with":
        a_fn, a_dict = c.compile(expr.args[0])
        b_fn, b_dict = c.compile(expr.args[1])
        lam = expr.args[2]
        lay = _lambda_layout(c, lam, (a_dict, b_dict))
        out_dict = body_dict(lam, lay)

        def zip_fn(env):
            a, b = a_fn(env), b_fn(env)
            w = max(a.data.shape[1], b.data.shape[1])

            def pad(x):
                return x if x.shape[1] == w else torch.nn.functional.pad(x, (0, w - x.shape[1]))

            lane = lanes_of(w)
            lengths = torch.maximum(a.lengths, b.lengths)
            # the shorter array extends with NULLs
            ea = pad(a.elem_valid) & (lane < a.lengths[:, None])
            eb = pad(b.elem_valid) & (lane < b.lengths[:, None])
            fenv = _lambda_free_env(lam, env, w)
            fenv[lam.params[0]] = _lanes(pad(a.data), a.dictionary, ea)
            fenv[lam.params[1]] = _lanes(pad(b.data), b.dictionary, eb)
            r = compile_expression(lam.body, lay, cap * w, dev)[0](fenv)
            return C.CVal(r.data.reshape(cap, w), a.valid & b.valid, out_dict, lengths,
                         r.valid.reshape(cap, w) & (lane < lengths[:, None]))

        return zip_fn, out_dict

    if name == "reduce":
        arr_fn, arr_dict = c.compile(expr.args[0])
        init_fn, _ = c.compile(expr.args[1])
        lam_in, lam_out = expr.args[2], expr.args[3]
        if is_string(lam_in.param_types[0]):
            raise CompileError("reduce with a string-typed state is not supported")
        lay_in = _lambda_layout(c, lam_in, (None, arr_dict))
        lay_out = _lambda_layout(c, lam_out, (None,))
        out_dict = body_dict(lam_out, lay_out)

        def reduce_fn(env):
            a = arr_fn(env)
            s = init_fn(env)
            step, _ = compile_expression(lam_in.body, lay_in, cap, dev)
            free_in = references(lam_in.body) - set(lam_in.params)
            base = {k: env[k] for k in free_in if k in env}
            for i in range(a.data.shape[1]):
                env2 = dict(base)
                env2[lam_in.params[0]] = s
                env2[lam_in.params[1]] = C.CVal(a.data[:, i], a.elem_valid[:, i], a.dictionary)
                s2 = step(env2)
                live = (i < a.lengths) & a.valid
                if s2.data.dim() > live.dim():
                    live_d = live.view(live.shape + (1,) * (s2.data.dim() - 1))
                else:
                    live_d = live
                s = C.CVal(torch.where(live_d, s2.data, s.data),
                          torch.where(live, s2.valid, s.valid))
            finish, _ = compile_expression(lam_out.body, lay_out, cap, dev)
            free_out = references(lam_out.body) - set(lam_out.params)
            env3 = {k: env[k] for k in free_out if k in env}
            env3[lam_out.params[0]] = s
            r = finish(env3)
            return C.CVal(r.data, r.valid & a.valid, out_dict)

        return reduce_fn, out_dict

    if name in ("transform_values", "map_filter"):
        m_fn, _ = c.compile(expr.args[0])
        lam = expr.args[1]
        kd, vd = _pair_dicts(dict_tree(c, expr.args[0]))
        lay = _lambda_layout(c, lam, (kd, vd))
        out_dict = body_dict(lam, lay)

        def run_map_body(env):
            m = m_fn(env)
            k, v = m.children
            w = k.data.shape[1]
            fenv = _lambda_free_env(lam, env, w)
            fenv[lam.params[0]] = _lanes(k.data, k.dictionary, k.elem_valid)
            fenv[lam.params[1]] = _lanes(v.data, v.dictionary, v.elem_valid)
            r = compile_expression(lam.body, lay, cap * w, dev)[0](fenv)
            return m, k, v, w, r, lanes_of(w) < m.lengths[:, None]

        if name == "transform_values":

            def tv_fn(env):
                m, k, v, w, r, present = run_map_body(env)
                nv = C.CVal(r.data.reshape(cap, w), m.valid, out_dict, k.lengths,
                           r.valid.reshape(cap, w) & present)
                return C.CVal(torch.zeros(cap, dtype=torch.int8, device=dev), m.valid,
                             lengths=m.lengths, children=(k, nv))

            return tv_fn, None

        def mf_fn(env):
            m, k, v, w, r, present = run_map_body(env)
            keep = (r.data.to(torch.bool) & r.valid).reshape(cap, w) & present
            order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
            new_len = keep.sum(1).to(torch.int32)
            pres2 = lanes_of(w) < new_len[:, None]

            def reorder(x):
                return C.CVal(torch.gather(x.data, 1, order), x.valid, x.dictionary, new_len,
                             torch.gather(x.elem_valid, 1, order) & pres2)

            return C.CVal(torch.zeros(cap, dtype=torch.int8, device=dev), m.valid,
                         lengths=new_len, children=(reorder(k), reorder(v)))

        return mf_fn, None

    raise CompileError(f"higher-order function {name} not implemented")
