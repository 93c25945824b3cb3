"""Batched CRUSH placement: one call maps N inputs at once.

The port's counterpart of ``ceph_tpu/ops/crush_kernel.py``.  Reference
parity: crush/mapper.c — bucket_straw2_choose (:300-344),
crush_choose_firstn (:414-593), crush_choose_indep (:600-781),
crush_do_rule (:793-999).

Scope (``compile_rule``, a copy of the reference's): arbitrary-depth
straw2/uniform hierarchies (every bucket on the descent straw2 or uniform
and non-empty, each level alg- and type-uniform), multi-TAKE rule programs
of [TAKE, (SET_*,) CHOOSE[LEAF]_FIRSTN/INDEP, EMIT] segments, and the
default tunables (vary_r=1, stable=1, no local retries).  Anything else
compiles to None; callers then take the scalar mapper
(``ceph_tpu_torch/crush/mapper.py``): same answers, slower, and COUNTED
(``fallback_count``).  Compiles are cached on the CrushMap object and
noted under devstats domain "crush_compile".

Three engines compute the same placements:

  * ``"host"``: numpy over the lanes, the reference's host engine
    (``map_firstn``/``map_indep``: masked rounds over the shrinking set of
    unresolved lanes), its straw2 draws in the native host library
    (``ceph_tpu_torch/native``: ``straw2_winner_shared``, ``_rows``,
    ``_rows_indexed``) when it is built, in numpy otherwise; both give
    the same placements.
  * ``"device"`` on CUDA: ``crush_map``, a hand-written kernel
    (``csrc/crush_map.cu``) that runs mapper.c's loops with a tile of
    ``lanes`` threads per input (``choose_lanes``); it replaces the JAX
    package's jitted descent (``JaxEngine._build``).  ``crush_straw2_winners`` replaces its winner
    grid (``_get_winners_fn``).
  * ``"device"`` on ``device="cpu"``: the kernels' plain torch versions
    (``crush_map_plain``, ``straw2_winners_plain``), which the CPU tests
    run and the chip smoke test holds the kernels against.  They are
    never the path for a CUDA tensor.

Every entry defaults to ``"device"`` on ``cuda``, so with no card it
raises.  ``"auto"`` (the reference's rule, for callers on an event loop
that must never wait for a build) takes the device only for 4096 or more
inputs on a warm CUDA engine (library loaded, engine built by
``warmup``), and the host otherwise; ``"host"`` is asked for by name.  A
failed build or launch on the device raises.
"""

from __future__ import annotations

import ctypes
import itertools
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.common import devstats
from ceph_tpu_torch.common.device import (DEFAULT_DEVICE, DeviceLike,
                                          resolve_device)
from ceph_tpu_torch.crush.constants import (
    BUCKET_STRAW2, BUCKET_UNIFORM, CRUSH_ITEM_NONE, RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
    RULE_EMIT, RULE_SET_CHOOSELEAF_TRIES, RULE_SET_CHOOSE_TRIES,
    RULE_TAKE,
)
from ceph_tpu_torch.crush.hashfn import HASH_SEED, np_hash32_2, np_hash32_3
from ceph_tpu_torch.crush.lntable import (ll_table, ln_u16_table,
                                          rh_lh_tables)
from ceph_tpu_torch.crush.types import CrushMap

S64_MIN = -(2**63)

class Level:
    """Dense table for all buckets choosable at one descent depth.

    items/weights: [N, Imax] padded with item -1 / weight 0 (zero-weight
    pads can never win a straw2 draw unless the whole row is zero, in
    which case argmax picks column 0 — a real item — exactly like
    bucket_straw2_choose's first-max scan).  rows maps (-1 - bucket_id)
    -> row for the ids produced by the PREVIOUS level's draw.  All
    buckets at one level share `alg` (straw2 or uniform — enforced by
    _build_levels); ids/sizes feed the uniform perm-choose hash and the
    indep r-stride bump."""

    __slots__ = ("items", "weights", "rows", "items32", "alg", "ids",
                 "sizes")

    def __init__(self, buckets):
        imax = max(b.size for b in buckets)
        n = len(buckets)
        self.alg = buckets[0].alg
        self.items = np.full((n, imax), -1, np.int64)
        self.weights = np.zeros((n, imax), np.int64)
        self.rows = np.full(max(-b.id for b in buckets) + 1, -1, np.int64)
        self.ids = np.zeros(n, np.int64)
        self.sizes = np.zeros(n, np.int64)
        for row, b in enumerate(buckets):
            self.items[row, :b.size] = b.items
            self.weights[row, :b.size] = b.item_weights
            self.rows[-1 - b.id] = row
            self.ids[row] = b.id
            self.sizes[row] = b.size
        # int32 copy for the native indexed-rows draw (item ids are
        # 32-bit in crush)
        self.items32 = np.ascontiguousarray(self.items, np.int32)

    @property
    def shared(self) -> bool:
        return self.items.shape[0] == 1

    @property
    def uniform(self) -> bool:
        return self.alg == BUCKET_UNIFORM


class Segment:
    """One TAKE..CHOOSE..EMIT span in dense-array form."""

    __slots__ = ("firstn", "recurse", "numrep_arg", "choose_tries",
                 "leaf_tries", "outer", "leaf", "max_devices")

    def __init__(self, firstn, recurse, numrep_arg, choose_tries,
                 leaf_tries, outer, leaf, max_devices):
        self.firstn = firstn
        self.recurse = recurse                # chooseleaf?
        self.numrep_arg = numrep_arg          # <=0 = result_max + arg
        self.choose_tries = choose_tries
        self.leaf_tries = leaf_tries
        self.outer = outer                    # [Level] root..dom draws
        self.leaf = leaf                      # [Level] dom..device draws
        self.max_devices = max_devices


class CompiledRule:
    """Compiled rule program: one or more vectorizable segments
    (crush_do_rule EMIT-concatenates them).  `firstn` means the RESULT
    is counts-based — true when any segment is firstn, which covers
    mixed firstn+indep programs (indep segments then contribute their
    full slot width, holes included, exactly like the scalar EMIT)."""

    __slots__ = ("segments", "firstn", "max_devices")

    def __init__(self, segments):
        self.segments = segments
        self.firstn = any(s.firstn for s in segments)
        self.max_devices = segments[0].max_devices

    @property
    def numrep_arg(self):         # single-segment compat accessor
        return self.segments[0].numrep_arg


_MAX_DEPTH = 12      # cycle guard for the level walk


def _build_levels(map_: CrushMap, start, stop_type: int):
    """BFS level tables from `start` buckets down to items of
    `stop_type` (0 = devices).  Returns (levels, bottom_ids) or None
    when the shape isn't uniformly vectorizable."""
    levels = []
    frontier = list(start)
    for _ in range(_MAX_DEPTH):
        for b in frontier:
            if b is None or b.size == 0 \
                    or b.alg not in (BUCKET_STRAW2, BUCKET_UNIFORM):
                return None
        if len({b.alg for b in frontier}) != 1:
            return None          # alg-heterogeneous level
        levels.append(Level(frontier))
        children = []
        seen = set()
        for b in frontier:
            for i in b.items:
                if i not in seen:
                    seen.add(i)
                    children.append(i)
        if stop_type == 0 and all(i >= 0 for i in children):
            if any(i >= map_.max_devices for i in children):
                return None
            return levels, children
        if any(i >= 0 for i in children):
            return None          # mixed devices/buckets at one level
        kids = [map_.bucket(i) for i in children]
        if any(k is None for k in kids):
            return None
        ktypes = {k.type for k in kids}
        if len(ktypes) != 1:
            return None          # type-heterogeneous level
        if stop_type != 0 and ktypes == {stop_type}:
            return levels, children
        frontier = kids
    return None


def _compile_segment(map_: CrushMap, root_id: int, op: int,
                     numrep_arg: int, dom_type: int, choose_tries: int,
                     leaf_tries: int) -> Optional[Segment]:
    if root_id >= 0:
        return None
    root = map_.bucket(root_id)
    if root is None:
        return None
    firstn = op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSE_FIRSTN)
    # chooseleaf to a device type degenerates to plain device choose
    # (mapper.c "we already have a leaf" path)
    recurse = (op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP)
               and dom_type != 0)
    if not recurse and dom_type != 0:
        return None              # plain choose of buckets: no consumer
    built = _build_levels(map_, [root], dom_type)
    if built is None:
        return None
    outer, dom_ids = built
    leaf: List[Level] = []
    if recurse:
        built = _build_levels(map_, [map_.bucket(i) for i in dom_ids], 0)
        if built is None:
            return None
        leaf = built[0]
    t = map_.tunables
    if leaf_tries == 0:
        # do_rule recurse_tries defaults: descend_once -> 1 for firstn
        # (mapper.c:934 flavor); indep always defaults to 1
        leaf_tries = (1 if (not firstn or t.chooseleaf_descend_once)
                      else choose_tries)
    return Segment(firstn, recurse, numrep_arg, choose_tries, leaf_tries,
                   outer, leaf, map_.max_devices)


#: monotonically increasing per-map compile-cache identity; rides the
#: "crush_compile" devstats signature so the epoch-churn guard can
#: assert "one recompile per NEW map, zero per steady-state call"
_map_tokens = itertools.count(1)


def compile_rule(map_: CrushMap, ruleno: int) -> Optional[CompiledRule]:
    """Compile if the rule/topology fits the vectorizable shape —
    guarded per-map cache in front of the real compiler.

    The cache key is the CrushMap OBJECT: every map churn installs a
    freshly decoded CrushMap (OSDMap.apply_incremental replaces
    self.crush wholesale; the mon builds pending_inc.new_crush from
    to_bytes/from_bytes copies), so attachment to the object is exactly
    per-epoch invalidation.  In-place mutators (add_bucket/add_rule/
    builder.reweight_item) drop the cache explicitly.  Each REAL
    compile notes a "crush_compile" devstats launch; cache hits note
    nothing — the perf-smoke plateau guard pins "recompile once per new
    map, never per op"."""
    cache = getattr(map_, "_kernel_compile_cache", None)
    if cache is None:
        cache = {}
        try:
            map_._kernel_compile_cache = cache
            map_._kernel_compile_token = next(_map_tokens)
        except AttributeError:       # slotted/frozen map stand-ins
            return _compile_rule_uncached(map_, ruleno)
    if ruleno in cache:
        return cache[ruleno]
    cr = _compile_rule_uncached(map_, ruleno)
    cache[ruleno] = cr
    devstats.note_launch(
        "crush_compile",
        (map_._kernel_compile_token, ruleno, cr is not None))
    return cr


def _compile_rule_uncached(map_: CrushMap,
                           ruleno: int) -> Optional[CompiledRule]:
    t = map_.tunables
    if not (t.chooseleaf_vary_r == 1 and t.chooseleaf_stable == 1
            and t.choose_local_tries == 0
            and t.choose_local_fallback_tries == 0):
        return None
    if not (0 <= ruleno < len(map_.rules)) or map_.rules[ruleno] is None:
        return None
    rule = map_.rules[ruleno]
    choose_tries = t.choose_total_tries + 1
    leaf_tries = 0
    take_id = None
    pending = None               # (op, arg1, arg2, tries, leaf_tries)
    segments: List[Segment] = []
    for step in rule.steps:
        if step.op == RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                leaf_tries = step.arg1
        elif step.op == RULE_TAKE:
            if pending is not None:
                return None      # choose without emit before next take
            take_id = step.arg1
        elif step.op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP,
                         RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP):
            if take_id is None or pending is not None:
                return None      # chained chooses: fall back
            pending = (step.op, step.arg1, step.arg2, choose_tries,
                       leaf_tries)
        elif step.op == RULE_EMIT:
            if pending is None:
                return None      # emit of a raw take: fall back
            seg = _compile_segment(map_, take_id, pending[0], pending[1],
                                   pending[2], pending[3], pending[4])
            if seg is None:
                return None
            segments.append(seg)
            take_id, pending = None, None
        else:
            return None
    if pending is not None or not segments:
        return None
    return CompiledRule(segments)


# ---------------------------------------------------- fallback accounting

#: total batched->scalar fallbacks since process start (an operator
#: losing the ~100x vectorized path must be able to SEE it)
fallback_events = 0
_fallback_logged: set = set()


def fallback_count() -> int:
    return fallback_events


def note_fallback(map_: CrushMap, ruleno: int) -> None:
    """Count + log (once per map identity/rule) a scalar fallback."""
    global fallback_events
    fallback_events += 1
    key = (id(map_), ruleno)
    if key not in _fallback_logged:
        _fallback_logged.add(key)
        if len(_fallback_logged) > 256:
            _fallback_logged.clear()
        import logging
        logging.getLogger("ceph_tpu_torch.crush").warning(
            "rule %d not vectorizable: falling back to the scalar "
            "mapper (~100x slower placement)", ruleno)
# ------------------------------------------------------------ numpy engine

_LN = None


def _ln():
    global _LN
    if _LN is None:
        _LN = np.asarray(ln_u16_table(), np.int64)
    return _LN


#: the native host library when it is built, False when it is not, None
#: before the first draw asks (a test sets False to force numpy)
_native_mod = None


def _native():
    global _native_mod
    if _native_mod is None:
        from ceph_tpu_torch import native
        _native_mod = native if native.available() else False
    return _native_mod


def _straw2_draw(items, weights, x, r):
    """Vectorized bucket_straw2_choose: returns winning index along the
    last axis.  items/weights [I] (shared bucket) or [X, I] (per-lane);
    x/r [X].  Dispatches to the native C draws when they are built;
    pure numpy otherwise, with identical results."""
    x = np.asarray(x)
    r = np.asarray(r)
    nat = _native()
    if nat and x.ndim == 1:
        rr = np.broadcast_to(r, x.shape)
        if items.ndim == 1:
            return nat.straw2_winner_shared(items, weights, x, rr, _ln())
        return nat.straw2_winner_rows(items, weights, x, rr, _ln())
    u = np_hash32_3(x[..., None],
                    (items & 0xFFFFFFFF).astype(np.uint32),
                    r[..., None]).astype(np.int64) & 0xFFFF
    ln = _ln()[u] - 0x1000000000000          # <= 0
    draw = np.where(weights > 0, -((-ln) // np.maximum(weights, 1)),
                    S64_MIN)
    return np.argmax(draw, axis=-1)


def _perm_choose_idx(sizes: np.ndarray, ids: np.ndarray, x: np.ndarray,
                     r: np.ndarray) -> np.ndarray:
    """Vectorized bucket_perm_choose (mapper.c:73-130): winning INDEX
    per lane.  sizes/ids/x/r are all [X] (each lane may sit in a
    different uniform bucket).

    The scalar runs pr+1 steps of a seeded Fisher-Yates shuffle and
    reads perm[pr].  Swap step p never touches positions < p, so
    positions <= pr are already final after step pr — running ALL
    Imax-1 steps unconditionally leaves perm[pr] unchanged.  That makes
    the trip count static (batchable); pr == 0 lanes take the scalar's
    direct-hash shortcut instead."""
    sizes = np.asarray(sizes, np.int64)
    x_u = np.asarray(x).astype(np.uint32)
    ids_u = (np.asarray(ids) & 0xFFFFFFFF).astype(np.uint32)
    pr = np.broadcast_to(np.asarray(r, np.int64), sizes.shape) % sizes
    X = sizes.shape[0]
    imax = int(sizes.max())
    lanes = np.arange(X)
    perm = np.broadcast_to(np.arange(imax, dtype=np.int64),
                           (X, imax)).copy()
    for p in range(imax - 1):
        i = (np_hash32_3(x_u, ids_u, np.uint32(p)).astype(np.int64)
             % np.maximum(sizes - p, 1))
        swap = (p < sizes - 1) & (i != 0)
        j = np.where(swap, p + i, p)
        tp = perm[:, p].copy()
        tj = perm[lanes, j]
        perm[:, p] = np.where(swap, tj, tp)
        perm[lanes, j] = np.where(swap, tp, tj)
    idx0 = np_hash32_3(x_u, ids_u, np.uint32(0)).astype(np.int64) % sizes
    return np.where(pr == 0, idx0, perm[lanes, pr])


def _stride_r(lv: "Level", rows: Optional[np.ndarray], r, stride):
    """Per-level r for the indep descent.  choose_indep recomputes r at
    every bucket it visits (mapper.c:640-647): uniform buckets whose
    size divides numrep evenly stride by numrep+1 instead of numrep —
    i.e. +ftotal on top of the caller's base r.  firstn passes
    stride=None (no special case anywhere in choose_firstn)."""
    if stride is None or not lv.uniform:
        return r
    numrep, ftotal = stride
    if ftotal == 0:
        return r
    sizes = lv.sizes[0] if rows is None else lv.sizes[rows]
    return r + np.where(sizes % numrep == 0, ftotal, 0)


def _is_out(weights_vec: np.ndarray, item: np.ndarray,
            x: np.ndarray) -> np.ndarray:
    """Vectorized is_out (mapper.c:378-392)."""
    w = np.where((item >= 0) & (item < len(weights_vec)),
                 weights_vec[np.clip(item, 0, len(weights_vec) - 1)], 0)
    out = np.where(w >= 0x10000, False,
                   np.where(w == 0, True,
                            (np_hash32_2(x.astype(np.uint32),
                                         item.astype(np.uint32))
                             .astype(np.int64) & 0xFFFF) >= w))
    return out | (item < 0) | (item >= len(weights_vec))


def _level_draw(lv: "Level", rows: np.ndarray, x: np.ndarray,
                r: np.ndarray) -> np.ndarray:
    """Chosen ITEM ids for one level: each lane draws from the bucket
    at its `rows` index.  Uniform levels run the vectorized
    perm-choose; straw2 takes the native indexed draw (each lane reads
    its row of the level table in place) or the numpy [X, I] gather."""
    if lv.uniform:
        idx = _perm_choose_idx(lv.sizes[rows], lv.ids[rows], x,
                               np.broadcast_to(r, x.shape))
        return lv.items[rows, idx]
    nat = _native()
    if nat and x.ndim == 1:
        rr = np.broadcast_to(r, x.shape)
        return nat.straw2_winner_rows_indexed(
            lv.items32, lv.weights, rows, x, rr, _ln())
    items = lv.items[rows]                  # [X, I]
    weights = lv.weights[rows]
    idx = _straw2_draw(items, weights, x, r)
    return np.take_along_axis(items, idx[:, None], 1)[:, 0]


def _descend(levels: List["Level"], x: np.ndarray, r: np.ndarray,
             stride=None) -> Tuple[np.ndarray, np.ndarray]:
    """One full descent through `levels`.  firstn (stride=None) uses
    the SAME r at every level (mapper.c's retry_bucket loop recomputes
    r identically each iteration); indep passes stride=(numrep, ftotal)
    and uniform levels apply the per-lane +ftotal bump (_stride_r).
    Returns (cand, r_last): the item ids chosen at the bottom level and
    the per-lane r used at the FINAL level — choose_indep hands exactly
    that r to the leaf recursion as parent_r."""
    cand = None
    r_lv = r
    for ln, lv in enumerate(levels):
        if lv.shared:
            r_lv = _stride_r(lv, None, r, stride)
            if lv.uniform:
                cand = _level_draw(lv, np.zeros(x.shape, np.int64), x,
                                   r_lv)
            else:
                idx = _straw2_draw(lv.items[0], lv.weights[0], x, r_lv)
                cand = lv.items[0][idx]
        else:
            rows = lv.rows[-1 - cand]
            r_lv = _stride_r(lv, rows, r, stride)
            cand = _level_draw(lv, rows, x, r_lv)
    return cand, r_lv


def _leaf_choose(seg: Segment, host: np.ndarray, x: np.ndarray,
                 parent_r: np.ndarray, r_step: int,
                 weights_vec: np.ndarray, osds_out: np.ndarray,
                 valid_cols: np.ndarray,
                 indep: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Inner chooseleaf descent from the selected domain bucket down to
    a device, through any number of intervening levels.

    firstn (stable=1): r' = parent_r + ftotal2        (r_step=1)
    indep:             r' = rep + parent_r + n*ftotal2 (caller folds rep
                       into parent_r; r_step=numrep), and every uniform
                       leaf level whose size divides numrep bumps its
                       own r by +ftotal2 (choose_indep recomputes r per
                       visited bucket)
    Rejection: is_out, plus collision against osds already in osds_out
    within valid_cols (firstn semantics; indep passes an empty mask).
    Returns (osd, ok) arrays over the x batch.
    """
    # leaf[0] descent rows come from the chosen dom bucket id; deeper
    # levels re-derive rows from each draw inside _descend_from
    rows = seg.leaf[0].rows[-1 - host]
    osd = np.full(x.shape, -1, np.int64)
    ok = np.zeros(x.shape, bool)
    active = np.ones(x.shape, bool)
    for f2 in range(seg.leaf_tries):
        if not active.any():
            break
        r = parent_r + r_step * f2
        cand = _descend_from(seg.leaf, rows, x, r,
                             (r_step, f2) if indep else None)
        reject = _is_out(weights_vec, cand, x)
        if osds_out.shape[1]:
            coll = ((osds_out == cand[:, None]) & valid_cols).any(axis=1)
            reject = reject | coll
        good = active & ~reject
        osd = np.where(good, cand, osd)
        ok = ok | good
        active = active & reject
    return osd, ok


def _descend_from(levels: List["Level"], rows: np.ndarray, x: np.ndarray,
                  r: np.ndarray, stride=None) -> np.ndarray:
    """_descend, but the first level is entered at per-lane `rows`
    (the chooseleaf entry: each lane starts at its chosen domain)."""
    cand = None
    for ln, lv in enumerate(levels):
        if ln > 0:
            rows = lv.rows[-1 - cand]
        cand = _level_draw(lv, rows, x, _stride_r(lv, rows, r, stride))
    return cand


def map_firstn(seg: Segment, xs: np.ndarray, numrep: int,
               weights_vec: Sequence[int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched crush_choose_firstn(+chooseleaf).  Returns (osds
    [X, numrep] with -1 padding, counts [X])."""
    xs = np.asarray(xs, np.int64)
    wv = np.asarray(weights_vec, np.int64)
    X = len(xs)
    hosts_out = np.full((X, numrep), np.iinfo(np.int64).min, np.int64)
    osds_out = np.full((X, numrep), -1, np.int64)
    outpos = np.zeros(X, np.int64)
    col = np.arange(numrep)
    for rep in range(numrep):
        # lanes still looking for this rep's pick; later rounds run only
        # on the (rapidly shrinking) unresolved subset
        lanes = np.arange(X)
        for ftotal in range(seg.choose_tries):
            if lanes.size == 0:
                break
            r = rep + ftotal
            xsub = xs[lanes]
            r_vec = np.full(lanes.size, r)
            host, _ = _descend(seg.outer, xsub, r_vec)
            valid = col[None, :] < outpos[lanes, None]
            collide = ((hosts_out[lanes] == host[:, None])
                       & valid).any(axis=1)
            if seg.recurse:
                # vary_r=1: sub_r = r >> 0 = r
                osd, leaf_ok = _leaf_choose(
                    seg, host, xsub, r_vec, 1, wv, osds_out[lanes],
                    valid)
            else:
                osd, leaf_ok = host, ~_is_out(wv, host, xsub)
            good = ~collide & leaf_ok
            if good.any():
                rows = lanes[good]
                pos = outpos[rows]
                hosts_out[rows, pos] = host[good]
                osds_out[rows, pos] = osd[good]
                outpos[rows] = pos + 1
            lanes = lanes[~good]
    return osds_out, outpos


def map_indep(seg: Segment, xs: np.ndarray, numrep: int,
              weights_vec: Sequence[int],
              out_size: Optional[int] = None) -> np.ndarray:
    """Batched crush_choose_indep(+chooseleaf): positionally-stable
    result [X, out_size] with CRUSH_ITEM_NONE holes.

    out_size (crush_do_rule: min(numrep, result_max)) bounds the result
    SLOTS; `numrep` keeps feeding the r stride (r = rep + numrep*ftotal,
    mapper.c:668) — conflating them would change the retry sequence and
    diverge from the scalar mapper."""
    out_size = numrep if out_size is None else out_size
    xs = np.asarray(xs, np.int64)
    wv = np.asarray(weights_vec, np.int64)
    X = len(xs)
    UNDEF = np.int64(np.iinfo(np.int64).min)
    hosts_out = np.full((X, out_size), UNDEF, np.int64)
    osds_out = np.full((X, out_size), UNDEF, np.int64)
    all_cols = np.ones((X, out_size), bool)
    empty_valid = np.zeros((X, 0), bool)
    empty_osds = np.zeros((X, 0), np.int64)
    for ftotal in range(seg.choose_tries):
        undef = hosts_out == UNDEF
        if not undef.any():
            break
        for rep in range(out_size):
            lanes = np.nonzero(undef[:, rep])[0]
            if lanes.size == 0:
                continue
            # base stride numrep; uniform levels whose size divides
            # numrep bump by +ftotal inside _descend (mapper.c:640-647)
            r = rep + numrep * ftotal
            xsub = xs[lanes]
            r_vec = np.full(lanes.size, r)
            host, r_last = _descend(seg.outer, xsub, r_vec,
                                    (numrep, ftotal))
            collide = ((hosts_out[lanes] == host[:, None])
                       & all_cols[lanes]).any(axis=1)
            if seg.recurse:
                # inner indep: r' = rep + r_outer + numrep*ftotal2 where
                # r_outer is the (per-lane) r of the FINAL outer draw;
                # its own collision scope is just this slot (never
                # fires)
                osd, leaf_ok = _leaf_choose(
                    seg, host, xsub, rep + r_last,
                    numrep, wv, empty_osds[lanes], empty_valid[lanes],
                    indep=True)
            else:
                osd, leaf_ok = host, ~_is_out(wv, host, xsub)
            good = ~collide & leaf_ok
            rows = lanes[good]
            hosts_out[rows, rep] = host[good]
            osds_out[rows, rep] = osd[good]
    osds_out = np.where(osds_out == UNDEF, CRUSH_ITEM_NONE, osds_out)
    return osds_out


def batch_do_rule_arrays(
        map_: CrushMap, ruleno: int, xs: Sequence[int], result_max: int,
        weights_vec: Sequence[int], engine: str = "device",
        device: DeviceLike = DEFAULT_DEVICE
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Array-native batched do_rule: (osds [X, numrep], counts [X] or
    None for indep).  firstn pads rows with -1 beyond counts[i]; indep
    rows carry CRUSH_ITEM_NONE holes.  Returns None when the rule isn't
    vectorizable (caller must use the scalar mapper).  This is the
    entry used by map_pgs_batch/osdmaptool.

    engine: "device" (the default) = the descent on ``device``: the
    CUDA kernel (csrc/crush_map.cu) on a CUDA device, its plain torch
    version on "cpu"; "host" = the numpy engine; "auto" = "device" for
    batches of 4096 or more on a warm CUDA engine (see warmup()), "host"
    otherwise.
    A failed build or launch on "device" raises: it never turns into
    host work.
    """
    if engine not in ("auto", "host", "device"):
        raise ValueError(f"unknown CRUSH engine {engine!r}: "
                         f"auto, host or device")
    cr = compile_rule(map_, ruleno)
    if cr is None:
        note_fallback(map_, ruleno)
        return None
    if engine == "auto":
        # Route to the device ONLY when its library is loaded and an
        # engine for this topology is built (warm): an event loop must
        # never eat a cold nvcc build.  Callers that want the device pay
        # that up front via warmup() (osdmaptool --engine device does).
        engine = ("device" if len(xs) >= 4096
                  and torch.device(device).type == "cuda"
                  and engine_is_warm(cr, weights_vec, result_max, device)
                  else "host")
    xs_arr = np.asarray(xs, np.int64)
    xs_dev = None
    if engine == "device":
        dev = resolve_device(device)
        xs_dev = torch.from_numpy(np.ascontiguousarray(xs_arr)).to(dev)
    seg_results = []         # (osds, counts|None) per emitted segment
    for seg in cr.segments:
        reps = _seg_numrep(seg, result_max)
        if reps is None:
            continue
        # crush_do_rule indep: out_size = min(numrep, result_max -
        # osize) bounds the slots, but numrep keeps driving the r
        # stride (osize = 0 at every segment's choose)
        numrep, out_size = reps
        if xs_dev is not None:
            eng = _device_engine(seg, weights_vec, xs_dev.device)
            seg_results.append(eng.run(seg, xs_dev, numrep, out_size,
                                       weights_vec))
        elif seg.firstn:
            seg_results.append(map_firstn(seg, xs_arr, numrep,
                                          weights_vec))
        else:
            seg_results.append((map_indep(seg, xs_arr, numrep,
                                          weights_vec, out_size), None))
    if not seg_results:
        return (np.zeros((len(xs), 0), np.int64),
                np.zeros(len(xs), np.int64) if cr.firstn else None)
    if len(seg_results) == 1:
        osds, counts = seg_results[0]
        if cr.firstn and osds.shape[1] > result_max:
            # EMIT caps the result vector at result_max
            osds = osds[:, :result_max]
            counts = np.minimum(counts, result_max)
        return osds, counts
    return _combine_segments(cr.firstn, seg_results, result_max)


def _combine_segments(firstn: bool, seg_results, result_max: int):
    """EMIT-concatenate per-segment results (crush_do_rule result
    vector), capped at result_max."""
    if not firstn:
        osds = np.concatenate([r[0] for r in seg_results], axis=1)
        return osds[:, :result_max], None
    X = seg_results[0][0].shape[0]
    widths = [r[0].shape[1] for r in seg_results]
    total = min(sum(widths), result_max)
    out = np.full((X, total), -1, np.int64)
    counts = np.zeros(X, np.int64)
    # fast path: every lane full in a segment appends contiguously; the
    # general path compacts per-lane (short firstn sets are rare)
    for osds, cnt in seg_results:
        if cnt is None:
            # indep segment inside a mixed program: scalar EMIT appends
            # the full positional slot vector, holes included
            cnt = np.full(X, osds.shape[1], np.int64)
        full = cnt == osds.shape[1]
        start = counts
        w = osds.shape[1]
        if bool(full.all()) and w:
            cols = start[:, None] + np.arange(w)[None, :]
            ok = cols < total
            rows = np.broadcast_to(np.arange(X)[:, None], cols.shape)
            out[rows[ok], cols[ok]] = osds[ok]
            counts = np.minimum(start + w, total)
        else:
            for i in range(X):
                n = int(min(cnt[i], total - counts[i]))
                if n > 0:
                    out[i, counts[i]:counts[i] + n] = osds[i, :n]
                    counts[i] += n
    return out, counts


def batch_do_rule(map_: CrushMap, ruleno: int, xs: Sequence[int],
                  result_max: int, weights_vec: Sequence[int],
                  engine: str = "device",
                  device: DeviceLike = DEFAULT_DEVICE) -> List[List[int]]:
    """Drop-in batched do_rule: vectorized when compilable, scalar host
    fallback otherwise.  Output matches [do_rule(x) for x in xs]."""
    res = batch_do_rule_arrays(map_, ruleno, xs, result_max, weights_vec,
                               engine, device)
    if res is None:
        from ceph_tpu_torch.crush.mapper import do_rule
        return [do_rule(map_, ruleno, int(x), result_max, weights_vec)
                for x in xs]
    osds, counts = res
    if counts is not None:
        return [[int(o) for o in osds[i, :counts[i]]]
                for i in range(len(xs))]
    return [[int(o) for o in row] for row in osds]


def _seg_numrep(seg: Segment, result_max: int) -> Optional[Tuple[int,
                                                                 int]]:
    """(numrep, out_size) for one segment, or None when empty; numrep
    drives the indep r stride, out_size the result slots."""
    numrep = seg.numrep_arg
    if numrep <= 0:
        numrep += result_max
        if numrep <= 0:
            return None
    out_size = numrep if seg.firstn else min(numrep, result_max)
    return numrep, out_size


# ----------------------------------------------------------- device engine
#
# The CUDA kernels of csrc/crush_map.cu and their plain torch versions.
# One DeviceEngine per segment topology and device holds the topology on
# the device; bucket and OSD weights are arguments of every call, so a
# reweight or a new epoch with the same topology reuses the engine.

#: launches of the descent kernel, counted where ``crush_map`` launches it
#: and nowhere else (a run sets it to 0 and reads it to show which path ran)
crush_map_launches = 0
#: launches of the winner-grid kernel, counted in ``crush_straw2_winners``
crush_straw2_winners_launches = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib = None

#: limits of csrc/crush_map.cu (kMaxLevels, kMaxRep, kMaxUniform)
MAX_LEVELS = 12
MAX_REP = 32
MAX_UNIFORM = 256
#: the lanes per input the descent kernel is built for (kLaneVariants)
LANE_VARIANTS = (4, 8, 16)

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
_LN_ONE = 0x1000000000000      # 2^48: crush_ln(0xffff)
_UNDEF = -(2**63)              # int64 sentinel of an open slot
_PLAIN_CHUNK = 65536           # lanes per pass of the plain descent
_INT_MAX = 2**31 - 1           # a tile lane's index before its first item


def _library():
    """The kernels' library, built from csrc/crush_map.cu at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ceph_tpu_torch.common.cuda_build import build
            lib = build("crush_map").lib
            vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.crush_map.argtypes = [
                vp, ci, ci, ci, ci, ci, ci, ci, ci,    # levels .. leaf_tries
                vp, vp, vp, vp, ci, vp,                # topo .. ln_tables
                vp, cll, vp, ci, ci, vp]               # xs .. stream
            lib.crush_map.restype = ci
            lib.crush_straw2_winners.argtypes = [
                vp, vp, ci, vp, vp, cll, vp, ci, vp, vp]
            lib.crush_straw2_winners.restype = ci
            lib.crush_error_string.argtypes = [ci]
            lib.crush_error_string.restype = ctypes.c_char_p
            for fn, want in (("crush_max_levels", MAX_LEVELS),
                             ("crush_max_rep", MAX_REP),
                             ("crush_max_uniform", MAX_UNIFORM)):
                getattr(lib, fn).restype = ci
                got = getattr(lib, fn)()
                if got != want:
                    raise RuntimeError(f"csrc/crush_map.cu {fn}() = {got}, "
                                       f"the wrapper expects {want}")
            buf = (ci * 8)()
            lib.crush_lane_variants.argtypes = [vp, ci]
            lib.crush_lane_variants.restype = ci
            n = lib.crush_lane_variants(ctypes.addressof(buf), len(buf))
            if tuple(buf[:n]) != LANE_VARIANTS:
                raise RuntimeError(f"csrc/crush_map.cu builds lanes "
                                   f"{tuple(buf[:n])}, the wrapper expects "
                                   f"{LANE_VARIANTS}")
            _lib = lib
        return _lib


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.crush_error_string(rc).decode()})")


_table_cache: Dict[Tuple[str, str], torch.Tensor] = {}


def _ln_tables(device: torch.device) -> torch.Tensor:
    """The kernels' crush_ln tables on ``device``: RH[k], LH[k]
    interleaved (k < 129), then LL[0..255]; int64 [514]."""
    key = ("rhlhll", str(device))
    t = _table_cache.get(key)
    if t is None:
        rh, lh = rh_lh_tables()
        packed = np.concatenate([np.stack([rh, lh], 1).reshape(-1),
                                 ll_table()]).astype(np.int64)
        t = _table_cache[key] = torch.from_numpy(packed).to(device)
    return t


def _ln_u16(device: torch.device) -> torch.Tensor:
    """crush_ln of every 16-bit draw on ``device`` (the plain versions'
    gather table)."""
    key = ("u16", str(device))
    t = _table_cache.get(key)
    if t is None:
        t = _table_cache[key] = torch.from_numpy(
            np.asarray(ln_u16_table(), np.int64)).to(device)
    return t


def _u32_weights(weights) -> np.ndarray:
    w = np.asarray(weights, np.int64)
    if w.size and int(w.max()) > M32:
        raise ValueError(f"a straw2 weight of {int(w.max()):#x}: the map "
                         f"format carries weights below 2^32")
    return w


def straw2_recips(weights: np.ndarray) -> np.ndarray:
    """floor((2^64 - 1) / w) per weight as uint64, 0 where w <= 0: the
    reciprocals with which the kernels divide (``recip_quotient``).
    Raises ValueError on a weight of 2^32 or more, which the map format
    (u32 weights) cannot carry."""
    w = _u32_weights(weights)
    out = np.zeros(w.shape, np.uint64)
    pos = w > 0
    out[pos] = np.uint64(M64) // w[pos].astype(np.uint64)
    return out


class SegmentWeights(NamedTuple):
    """A segment's bucket item weights on one device, flattened level by
    level (int64 [W]), and their ``straw2_recips`` (int64 [W] holding the
    uint64 bits), as ``DeviceEngine.weights`` uploads them."""
    weights: torch.Tensor
    recips: torch.Tensor


def choose_lanes(n_inputs: int, thread_slots: int,
                 widths: Sequence[int]) -> int:
    """Lanes per input for one descent launch over straw2 rows of
    ``widths`` (one per straw2 level, ``DeviceEngine.straw2_widths``) on
    a card that holds ``thread_slots`` threads at once (the function
    ``thread_slots`` reads it).

    The most lanes of LANE_VARIANTS that leave no lane idle at the
    narrowest row and give each lane at least two items of the mean row
    (its two hash chains), and at least the fewest built: a warp then
    holds fewer inputs, so it waits less on one input's retries, and the
    lanes' repeated work per level (the reduction's shuffles, the
    bookkeeping) stays small.  If that leaves fewer threads (inputs x
    lanes) than the card's thread slots, as at a pool's 16-32 Ki PGs, the
    fewest more lanes that fill them (else the most): filling the card
    outweighs idle lanes."""
    fit = LANE_VARIANTS[0]
    if widths:
        fit = max([fit] + [g for g in LANE_VARIANTS if g <= min(widths)
                           and 2 * g <= sum(widths) / len(widths)])
    for g in LANE_VARIANTS:
        if g >= fit and n_inputs * g >= thread_slots:
            return g
    return LANE_VARIANTS[-1]


_thread_slots: Dict[int, int] = {}


def thread_slots(device: torch.device) -> int:
    """Threads resident at once on the CUDA ``device``: its SMs times the
    threads one SM holds."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _thread_slots.get(idx)
    if n is None:
        props = torch.cuda.get_device_properties(idx)
        n = _thread_slots[idx] = (props.multi_processor_count
                                  * props.max_threads_per_multi_processor)
    return n


# -- a model of the kernels' arithmetic, for the tests ---------------------

def umulhi64(a, b) -> np.ndarray:
    """The high 64 bits of a * b (CUDA's ``__umul64hi``), from 32-bit
    halves in numpy uint64."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    m32, s32 = np.uint64(M32), np.uint64(32)
    a0, a1 = a & m32, a >> s32
    b0, b1 = b & m32, b >> s32
    p01, p10 = a0 * b1, a1 * b0
    mid = ((a0 * b0) >> s32) + (p01 & m32) + (p10 & m32)
    return a1 * b1 + (p01 >> s32) + (p10 >> s32) + (mid >> s32)


def recip_quotient(n, w, m) -> np.ndarray:
    """The kernels' n // w for n < 2^64, w >= 1, m = straw2_recips(w):
    umulhi(n, m) is the quotient or one less; the remainder fixes it."""
    n = np.asarray(n, np.uint64)
    w = np.asarray(w, np.uint64)
    q = umulhi64(n, m)
    return q + (n - q * w >= w).astype(np.uint64)


def tile_first_max(draws: Sequence[int], lanes: int) -> int:
    """The index a tile of ``lanes`` lanes picks in csrc/crush_map.cu's
    straw2_index: lane j scans items j, j+lanes, ... two at a time,
    keeping its first maximum, then a butterfly of exchanges keeps the
    larger draw, the lower index on equal draws (a lane with no item
    holds INT_MAX).  Every lane must end with the same index."""
    size = len(draws)
    best = []
    for j in range(lanes):
        b, bd = _INT_MAX, S64_MIN
        for i in range(j, size, lanes):
            if b == _INT_MAX or draws[i] > bd:
                b, bd = i, draws[i]
        best.append((b, bd))
    off = lanes // 2
    while off:
        nxt = []
        for j, (b, bd) in enumerate(best):
            ob, obd = best[j ^ off]
            nxt.append((ob, obd) if obd > bd or (obd == bd and ob < b)
                       else (b, bd))
        best = nxt
        off //= 2
    idx = {b for b, _ in best}
    if len(idx) != 1:
        raise AssertionError(f"the tile's lanes disagree: {idx}")
    b = idx.pop()
    return 0 if b == _INT_MAX else b


class DeviceEngine:
    """One segment's topology on one device.

    ``levels`` holds the plain version's per-level tensors (items
    [n, imax], row map, sizes, bucket ids, int64); ``topo`` is the
    kernel's packed int32 form of the same, with ``desc`` the 7 ints per
    level (items, rows, sizes and ids offsets into ``topo``, the weights
    offset, the row width, the uniform flag) that csrc/crush_map.cu reads;
    ``straw2_widths`` the row width of each straw2 level, which
    ``choose_lanes`` reads.
    Raises ValueError for a segment the kernel cannot take (more than
    MAX_LEVELS levels, a uniform bucket wider than MAX_UNIFORM)."""

    def __init__(self, seg: Segment, device: torch.device):
        levels = seg.outer + seg.leaf
        if len(levels) > MAX_LEVELS:
            raise ValueError(f"rule descends {len(levels)} levels; the "
                             f"device descent takes at most {MAX_LEVELS}")
        for lv in levels:
            if lv.uniform and lv.items.shape[1] > MAX_UNIFORM:
                raise ValueError(
                    f"uniform bucket of {lv.items.shape[1]} items; the "
                    f"device descent takes at most {MAX_UNIFORM}")
        self.device = device = _indexed(torch.device(device))
        self.n_outer, self.n_leaf = len(seg.outer), len(seg.leaf)
        self.firstn, self.recurse = seg.firstn, seg.recurse
        self.choose_tries, self.leaf_tries = seg.choose_tries, seg.leaf_tries
        self.uniform = [lv.uniform for lv in levels]
        self.shapes = [lv.items.shape for lv in levels]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
                device)
        self.levels = [(dev(lv.items), dev(lv.rows), dev(lv.sizes),
                        dev(lv.ids & M32)) for lv in levels]
        parts, desc, off, woff = [], [], 0, 0
        for lv in levels:
            n, imax = lv.items.shape
            rows = len(lv.rows)
            desc += [off, off + n * imax, off + n * imax + rows,
                     off + n * imax + rows + n, woff, imax, int(lv.uniform)]
            parts += [lv.items.reshape(-1), lv.rows, lv.sizes, lv.ids]
            off += n * imax + rows + 2 * n
            woff += n * imax
        self.desc = np.ascontiguousarray(desc, np.int32)
        self.topo = torch.from_numpy(
            np.concatenate(parts).astype(np.int32)).to(device)
        self.woffsets = np.cumsum([0] + [n * i for n, i in self.shapes])
        self.straw2_widths = [i for (_, i), u in zip(self.shapes,
                                                     self.uniform) if not u]

    def weights(self, seg: Segment) -> SegmentWeights:
        """The segment's bucket item weights, flattened level by level,
        with their reciprocals: one upload.  Raises ValueError on a weight
        of 2^32 or more (``straw2_recips``)."""
        w = np.concatenate([lv.weights.reshape(-1)
                            for lv in seg.outer + seg.leaf]).astype(np.int64)
        both = torch.from_numpy(np.concatenate(
            [w, straw2_recips(w).view(np.int64)])).to(self.device)
        return SegmentWeights(both[:w.size], both[w.size:])

    def run(self, seg: Segment, xs: torch.Tensor, numrep: int,
            out_size: int, weights_vec: Sequence[int]
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(osds [X, cols] int64, counts [X] or None) for inputs ``xs``
        (int64 on this engine's device): one launch, one packed fetch."""
        osd_w = torch.from_numpy(
            np.asarray(weights_vec, np.int64)).to(self.device)
        devstats.note_launch("crush_map", (id(self), numrep, out_size,
                                           self.firstn, xs.shape[0]))
        packed = crush_map(self, xs, numrep, out_size, self.weights(seg),
                           osd_w)
        host = packed.cpu().numpy()
        if self.firstn:
            return (host[:, :numrep].astype(np.int64),
                    host[:, numrep].astype(np.int64))
        return host.astype(np.int64), None


def crush_map(eng: DeviceEngine, xs: torch.Tensor, numrep: int,
              out_size: int, weights: SegmentWeights,
              osd_weights: torch.Tensor,
              work: Optional[Dict[str, int]] = None,
              lanes: Optional[int] = None) -> torch.Tensor:
    """One segment's descent for inputs ``xs`` on the engine's device:
    packed int32 [X, numrep + 1] (osds padded with -1, then the count)
    for firstn, [X, out_size] with CRUSH_ITEM_NONE holes for indep.

    ``weights`` are the segment's bucket item weights and reciprocals
    (``eng.weights``), ``osd_weights`` the reweight vector, int64 on the
    device.  A CUDA tensor launches the kernel of csrc/crush_map.cu with
    ``lanes`` lanes per input (None: ``choose_lanes``; a count the kernel
    is not built for is refused by the launch) or raises; a CPU tensor
    runs the plain version (``work``, when given, collects the plain
    version's operation counts)."""
    for name, t in (("xs", xs), ("weights", weights.weights),
                    ("recips", weights.recips),
                    ("osd_weights", osd_weights)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-d int64, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != eng.device:
            raise ValueError(f"{name} on {t.device}, engine on "
                             f"{eng.device}")
    for name, t in (("weights", weights.weights),
                    ("recips", weights.recips)):
        if t.shape[0] != eng.woffsets[-1]:
            raise ValueError(f"{name} has {t.shape[0]} entries, the "
                             f"engine's levels {eng.woffsets[-1]}")
    if eng.firstn and out_size != numrep:
        raise ValueError("firstn takes out_size == numrep")
    if not 1 <= out_size <= MAX_REP:
        raise ValueError(f"{out_size} result columns; the device descent "
                         f"takes 1..{MAX_REP}")
    if xs.device.type == "cpu":
        return crush_map_plain(eng, xs, numrep, out_size, weights,
                               osd_weights, work)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    X = xs.shape[0]
    ld = out_size + (1 if eng.firstn else 0)
    out = torch.empty((X, ld), dtype=torch.int32, device=xs.device)
    if X == 0:
        return out
    xs = xs.contiguous()
    wts = weights.weights.contiguous()
    recips = weights.recips.contiguous()
    osd_weights = osd_weights.contiguous()
    if lanes is None:
        lanes = choose_lanes(X, thread_slots(xs.device), eng.straw2_widths)
    lib = _library()
    tables = _ln_tables(xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.crush_map(
            eng.desc.ctypes.data, eng.n_outer, eng.n_leaf, int(eng.firstn),
            int(eng.recurse), numrep, out_size, eng.choose_tries,
            eng.leaf_tries, eng.topo.data_ptr(), wts.data_ptr(),
            recips.data_ptr(), osd_weights.data_ptr(),
            osd_weights.shape[0], tables.data_ptr(), xs.data_ptr(), X,
            out.data_ptr(), ld, int(lanes), stream)
    _check_launch(lib, rc, "crush_map")
    global crush_map_launches
    with _count_lock:
        crush_map_launches += 1
    return out


# -- the plain torch version -------------------------------------------
# uint32 arithmetic emulated in int64: every subtraction and left shift
# is masked back to 32 bits (torch's uint32 coverage is partial).

def _t_mix(a, b, c):
    a = (a - b - c) & M32; a = a ^ (c >> 13)
    b = (b - c - a) & M32; b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 13)
    a = (a - b - c) & M32; a = a ^ (c >> 12)
    b = (b - c - a) & M32; b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 5)
    a = (a - b - c) & M32; a = a ^ (c >> 3)
    b = (b - c - a) & M32; b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 15)
    return a, b, c


def t_hash32_3(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """crush_hash32_3 over broadcast int64 tensors holding uint32s."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    h = HASH_SEED ^ a ^ b ^ c
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _t_mix(a, b, h)
    c, x, h = _t_mix(c, x, h)
    y, a, h = _t_mix(y, a, h)
    b, x, h = _t_mix(b, x, h)
    y, c, h = _t_mix(y, c, h)
    return h


def t_hash32_2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """crush_hash32_2 over broadcast int64 tensors holding uint32s."""
    a, b = torch.broadcast_tensors(a, b)
    h = HASH_SEED ^ a ^ b
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _t_mix(a, b, h)
    x, a, h = _t_mix(x, a, h)
    b, y, h = _t_mix(b, y, h)
    return h


def _count(work, key: str, n) -> None:
    if work is not None:
        work[key] = work.get(key, 0) + int(n)


def _t_straw2_idx(items, weights, x, r, ln_tab, work):
    """Winning index of bucket_straw2_choose along the last axis:
    items/weights [I] or [C, I], x/r [C]."""
    u = t_hash32_3(x[:, None], items & M32, (r & M32)[:, None]) & 0xFFFF
    ln = ln_tab[u] - _LN_ONE
    w = torch.broadcast_to(weights, ln.shape)
    draw = torch.where(
        w > 0, -torch.div(-ln, w.clamp(min=1), rounding_mode="floor"),
        torch.full_like(ln, S64_MIN))
    _count(work, "straw2_draws", (w > 0).sum())
    return draw.argmax(dim=-1)


def _t_perm_idx(imax, sizes, ids_u, x, r, work):
    """bucket_perm_choose's winning INDEX per lane (see _perm_choose_idx:
    running every swap step leaves perm[r % size] as the scalar walk);
    imax is the level's row width."""
    C = x.shape[0]
    pr = r % sizes
    lanes = torch.arange(C, device=x.device)
    perm = torch.arange(imax, device=x.device).expand(C, imax).clone()
    for p in range(imax - 1):
        i = t_hash32_3(x, ids_u, torch.full_like(x, p)) \
            % (sizes - p).clamp(min=1)
        swap = (p < sizes - 1) & (i != 0)
        j = torch.where(swap, p + i, torch.full_like(i, p))
        tp = perm[:, p].clone()
        tj = perm[lanes, j]
        perm[:, p] = torch.where(swap, tj, tp)
        perm[lanes, j] = torch.where(swap, tp, tj)
    idx0 = t_hash32_3(x, ids_u, torch.zeros_like(x)) % sizes
    _count(work, "perm_hashes",
           torch.where(pr == 0, torch.ones_like(pr),
                       torch.minimum(pr, sizes - 2) + 1).sum())
    return torch.where(pr == 0, idx0, perm[lanes, pr])


def _t_is_out(osd_w, item, x, work):
    """is_out (mapper.c:378-392) per lane."""
    n = osd_w.shape[0]
    inb = (item >= 0) & (item < n)
    w = torch.where(inb, osd_w[item.clamp(0, n - 1)],
                    torch.zeros_like(item))
    frac = (t_hash32_2(x, item & M32) & 0xFFFF) >= w
    _count(work, "is_out_hashes", ((w > 0) & (w < 0x10000)).sum())
    out = torch.where(w >= 0x10000, torch.zeros_like(inb),
                      torch.where(w == 0, torch.ones_like(inb), frac))
    return out | ~inb


def _t_descend(eng, wflat, l0, l1, rows, x, r, bump, numrep, ln_tab,
               work):
    """Descend levels [l0, l1) from per-lane ``rows`` of level l0;
    ``bump`` (indep) adds +bump to r at uniform buckets whose size
    divides numrep.  Returns (chosen items, r of the last draw)."""
    cand, r_lv = None, r
    for l in range(l0, l1):
        items, rowmap, sizes, ids_u = eng.levels[l]
        if l > l0:
            rows = rowmap[-1 - cand]
        size = sizes[rows]
        r_lv = r
        if bump and eng.uniform[l]:
            r_lv = r + (size % numrep == 0).to(torch.int64) * bump
        n, imax = eng.shapes[l]
        w = wflat[eng.woffsets[l]:eng.woffsets[l + 1]].view(n, imax)
        if eng.uniform[l]:
            idx = _t_perm_idx(imax, size, ids_u[rows], x, r_lv, work)
            cand = items[rows, idx]
        elif n == 1:
            idx = _t_straw2_idx(items[0], w[0], x, r_lv, ln_tab, work)
            cand = items[0][idx]
        else:
            idx = _t_straw2_idx(items[rows], w[rows], x, r_lv, ln_tab,
                                work)
            cand = items[rows, idx]
    return cand, r_lv


def _t_leaf_choose(eng, wflat, osd_w, host, x, parent_r, r_step, osds_out,
                   valid, indep, numrep, ln_tab, work):
    """The chooseleaf retry below each lane's domain ``host``: leaf
    tries f2 with r' = parent_r + r_step * f2, rejecting is_out and (for
    firstn) collisions with the lane's osds within ``valid``.  Returns
    (osd, ok) per lane; later tries run only on lanes still open."""
    leaf0 = eng.n_outer
    rows = eng.levels[leaf0][1][-1 - host]
    osd = torch.full_like(host, -1)
    ok = torch.zeros_like(host, dtype=torch.bool)
    open_ = torch.arange(host.shape[0], device=host.device)
    for f2 in range(eng.leaf_tries):
        if open_.numel() == 0:
            break
        xs = x[open_]
        cand, _ = _t_descend(eng, wflat, leaf0, leaf0 + eng.n_leaf,
                             rows[open_], xs, parent_r[open_] + r_step * f2,
                             f2 if indep else 0, numrep, ln_tab, work)
        reject = _t_is_out(osd_w, cand, xs, work)
        if osds_out is not None:
            reject |= ((osds_out[open_] == cand[:, None])
                       & valid[open_]).any(dim=1)
        good = open_[~reject]
        osd[good] = cand[~reject]
        ok[good] = True
        open_ = open_[reject]
    return osd, ok


def _plain_firstn(eng, xs, numrep, wflat, osd_w, ln_tab, work):
    X = xs.shape[0]
    dev = xs.device
    hosts = torch.full((X, numrep), _UNDEF, dtype=torch.int64, device=dev)
    osds = torch.full((X, numrep), -1, dtype=torch.int64, device=dev)
    outpos = torch.zeros(X, dtype=torch.int64, device=dev)
    col = torch.arange(numrep, device=dev)
    root = torch.zeros(X, dtype=torch.int64, device=dev)
    for rep in range(numrep):
        lanes = torch.arange(X, device=dev)
        for ftotal in range(eng.choose_tries):
            if lanes.numel() == 0:
                break
            xsub = xs[lanes]
            r = torch.full_like(xsub, rep + ftotal)
            host, _ = _t_descend(eng, wflat, 0, eng.n_outer, root[lanes],
                                 xsub, r, 0, numrep, ln_tab, work)
            valid = col[None, :] < outpos[lanes, None]
            collide = ((hosts[lanes] == host[:, None]) & valid).any(dim=1)
            if eng.recurse:
                # vary_r=1, stable=1: leaf r' = r + f2; leaf tries run
                # only where the domain did not collide
                osd = torch.full_like(host, -1)
                ok = torch.zeros_like(collide)
                free = torch.nonzero(~collide).flatten()
                o, k = _t_leaf_choose(eng, wflat, osd_w, host[free],
                                      xsub[free], r[free], 1,
                                      osds[lanes[free]], valid[free],
                                      False, numrep, ln_tab, work)
                osd[free] = o
                ok[free] = k
            else:
                osd, ok = host, ~_t_is_out(osd_w, host, xsub, work)
            good = ~collide & ok
            rows = lanes[good]
            pos = outpos[rows]
            hosts[rows, pos] = host[good]
            osds[rows, pos] = osd[good]
            outpos[rows] = pos + 1
            lanes = lanes[~good]
    return torch.cat([osds, outpos[:, None]], dim=1).to(torch.int32)


def _plain_indep(eng, xs, numrep, out_size, wflat, osd_w, ln_tab, work):
    X = xs.shape[0]
    dev = xs.device
    hosts = torch.full((X, out_size), _UNDEF, dtype=torch.int64,
                       device=dev)
    osds = torch.full((X, out_size), _UNDEF, dtype=torch.int64, device=dev)
    root = torch.zeros(X, dtype=torch.int64, device=dev)
    for ftotal in range(eng.choose_tries):
        undef = hosts == _UNDEF
        if not bool(undef.any()):
            break
        for rep in range(out_size):
            lanes = torch.nonzero(undef[:, rep]).flatten()
            if lanes.numel() == 0:
                continue
            xsub = xs[lanes]
            r = torch.full_like(xsub, rep + numrep * ftotal)
            host, r_last = _t_descend(eng, wflat, 0, eng.n_outer,
                                      root[lanes], xsub, r, ftotal, numrep,
                                      ln_tab, work)
            collide = (hosts[lanes] == host[:, None]).any(dim=1)
            if eng.recurse:
                # inner indep: r' = rep + r_last + numrep * f2, its own
                # slot its only collision scope (never fires)
                osd = torch.full_like(host, -1)
                ok = torch.zeros_like(collide)
                free = torch.nonzero(~collide).flatten()
                o, k = _t_leaf_choose(eng, wflat, osd_w, host[free],
                                      xsub[free], rep + r_last[free],
                                      numrep, None, None, True, numrep,
                                      ln_tab, work)
                osd[free] = o
                ok[free] = k
            else:
                osd, ok = host, ~_t_is_out(osd_w, host, xsub, work)
            good = ~collide & ok
            rows = lanes[good]
            hosts[rows, rep] = host[good]
            osds[rows, rep] = osd[good]
    osds = torch.where(osds == _UNDEF,
                       torch.full_like(osds, CRUSH_ITEM_NONE), osds)
    return osds.to(torch.int32)


def crush_map_plain(eng: DeviceEngine, xs: torch.Tensor, numrep: int,
                    out_size: int, weights: SegmentWeights,
                    osd_weights: torch.Tensor,
                    work: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """Plain torch version of ``crush_map``, on xs's device: the same
    packed result.  Each replica slot (firstn) or round (indep) runs its
    tries over the lanes still open, in mapper.c's (rep, ftotal) order,
    with crush_ln as a gather into the 64 Ki-entry table; lanes go in
    passes of 65536.  ``work``, when given, collects the operations the
    lanes needed (straw2 draws, perm-choose hashes, is_out hashes).  It
    divides by ``weights.weights`` with torch's floor division and reads
    no reciprocal."""
    ln_tab = _ln_u16(xs.device)
    weights = weights.weights
    outs = []
    for s in range(0, xs.shape[0], _PLAIN_CHUNK):
        chunk = xs[s:s + _PLAIN_CHUNK] & M32
        if eng.firstn:
            outs.append(_plain_firstn(eng, chunk, numrep, weights,
                                      osd_weights, ln_tab, work))
        else:
            outs.append(_plain_indep(eng, chunk, numrep, out_size, weights,
                                     osd_weights, ln_tab, work))
    if not outs:
        return torch.empty((0, out_size + (1 if eng.firstn else 0)),
                           dtype=torch.int32, device=xs.device)
    return torch.cat(outs)


# -- engine cache, warm-up ----------------------------------------------

_engine_cache: Dict[tuple, DeviceEngine] = {}
_engine_lock = threading.Lock()


def _engine_key(seg: Segment, weights_vec: Sequence[int]):
    # items and bucket ids fix the packed topology (rows and sizes follow
    # from them); weights stay arguments of every call
    return (tuple((lv.alg, lv.items.tobytes(), lv.ids.tobytes())
                  for lv in seg.outer),
            tuple((lv.alg, lv.items.tobytes(), lv.ids.tobytes())
                  for lv in seg.leaf),
            seg.firstn, seg.recurse, seg.choose_tries, seg.leaf_tries,
            len(weights_vec))


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: "cuda" names the current card, as a
    tensor placed there reports it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_engine(seg: Segment, weights_vec: Sequence[int],
                   device: torch.device) -> DeviceEngine:
    """The engine for this segment's topology on ``device``, built at
    first use and kept (at most 16)."""
    device = _indexed(torch.device(device))
    key = (_engine_key(seg, weights_vec), str(device))
    with _engine_lock:
        eng = _engine_cache.get(key)
        if eng is None:
            if len(_engine_cache) >= 16:
                _engine_cache.clear()
            eng = _engine_cache[key] = DeviceEngine(seg, device)
        return eng


def engine_is_warm(cr, weights_vec: Sequence[int], result_max: int,
                   device: DeviceLike = DEFAULT_DEVICE) -> bool:
    """True when every segment of this rule has a built engine on
    ``device`` and, for CUDA, the kernels' library is loaded — so a
    call routed there pays no build."""
    dev = torch.device(device)
    if dev.type == "cuda" and _lib is None:
        return False
    dev = _indexed(dev)
    segs = cr.segments if isinstance(cr, CompiledRule) else [cr]
    for seg in segs:
        if _seg_numrep(seg, result_max) is None:
            continue
        if (_engine_key(seg, weights_vec), str(dev)) not in _engine_cache:
            return False
    return True


def warmup(map_: CrushMap, ruleno: int, result_max: int,
           weights_vec: Sequence[int],
           device: DeviceLike = DEFAULT_DEVICE) -> bool:
    """Build the kernels' library (nvcc, on CUDA) and the device engines
    for (map, rule), outside any event loop, so that engine="auto" can
    route large batches to the device without a build stall.  Returns
    False if the rule isn't vectorizable."""
    cr = compile_rule(map_, ruleno)
    if cr is None:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        _library()
    for seg in cr.segments:
        if _seg_numrep(seg, result_max) is not None:
            _device_engine(seg, weights_vec, dev)
    return True


# -- the straw2 winner grid ---------------------------------------------

def crush_straw2_winners(items: torch.Tensor, weights: torch.Tensor,
                         xs: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """[X, R] int64 winning item ids of one straw2 bucket (items/weights
    [B] int64) for inputs xs [X] and draw indices rs [R] (int64), on
    their device.  A CUDA tensor launches the kernel of
    csrc/crush_map.cu (one thread per (x, r); each block computes the
    weights' reciprocals into shared memory first) or raises; a CPU
    tensor runs the plain version."""
    for name, t in (("items", items), ("weights", weights), ("xs", xs),
                    ("rs", rs)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-d int64, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != xs.device:
            raise ValueError(f"{name} on {t.device}, xs on {xs.device}")
    if items.shape != weights.shape or items.shape[0] < 1:
        raise ValueError("items and weights must be [B], B >= 1")
    if xs.device.type == "cpu":
        return straw2_winners_plain(items, weights, xs, rs)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    X, R = xs.shape[0], rs.shape[0]
    out = torch.empty((X, R), dtype=torch.int64, device=xs.device)
    if X == 0 or R == 0:
        return out
    items32 = items.to(torch.int32)
    weights = weights.contiguous()
    xs, rs = xs.contiguous(), rs.contiguous()
    lib = _library()
    tables = _ln_tables(xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.crush_straw2_winners(
            items32.data_ptr(), weights.data_ptr(), items.shape[0],
            tables.data_ptr(), xs.data_ptr(), X, rs.data_ptr(), R,
            out.data_ptr(), stream)
    _check_launch(lib, rc, "crush_straw2_winners")
    global crush_straw2_winners_launches
    with _count_lock:
        crush_straw2_winners_launches += 1
    return out


def straw2_winners_plain(items: torch.Tensor, weights: torch.Tensor,
                         xs: torch.Tensor, rs: torch.Tensor,
                         work: Optional[Dict[str, int]] = None
                         ) -> torch.Tensor:
    """Plain torch version of ``crush_straw2_winners``: hash32_3(x, item,
    r), a gather into the 64 Ki-entry ln table, the truncating division
    and the first-max argmax, over [x, r, item] in passes of 4096 x."""
    ln_tab = _ln_u16(xs.device)
    outs = []
    for s in range(0, xs.shape[0], 4096):
        x = xs[s:s + 4096] & M32
        u = t_hash32_3(x[:, None, None], (items & M32)[None, None, :],
                       (rs & M32)[None, :, None]) & 0xFFFF
        ln = ln_tab[u] - _LN_ONE
        w = torch.broadcast_to(weights, ln.shape)
        draw = torch.where(
            w > 0, -torch.div(-ln, w.clamp(min=1), rounding_mode="floor"),
            torch.full_like(ln, S64_MIN))
        _count(work, "straw2_draws", (w > 0).sum())
        outs.append(items[draw.argmax(dim=-1)])
    if not outs:
        return torch.empty((0, rs.shape[0]), dtype=torch.int64,
                           device=xs.device)
    return torch.cat(outs)


def straw2_winners(items, weights, xs, rs,
                   device: DeviceLike = DEFAULT_DEVICE) -> np.ndarray:
    """Straw2 winner grid: items/weights [B] bucket contents, xs [X]
    inputs, rs [R] draw indices -> [X, R] winning item ids (numpy),
    computed on ``device`` (the kernel on CUDA, the plain version on
    "cpu").  Raises ValueError on a weight of 2^32 or more."""
    dev = resolve_device(device)
    weights = _u32_weights(weights)

    def t(a):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, np.int64))).to(dev)
    out = crush_straw2_winners(t(items), t(weights), t(xs), t(rs))
    devstats.note_launch("crush_winners",
                         (len(items), out.shape[0], out.shape[1]))
    return out.cpu().numpy()
