"""Bit-exact host CRUSH mapper: bucket chooses, descent loops, rule VM.

Reference parity: crush/mapper.c — bucket_perm_choose (:73), list (:140),
tree (:193), straw (:225), straw2 (:300), is_out (:378),
crush_choose_firstn (:414), crush_choose_indep (:600), crush_do_rule (:793).
This is the semantic ground truth the batched engines
(ops/crush_kernel.py, csrc/crush_map.cu) must match, and the fallback
for tunable combinations they do not support.  Golden-vector tests
(tests/golden/) pin it bit-for-bit to the reference C.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ceph_tpu_torch.crush.constants import (BUCKET_LIST, BUCKET_STRAW,
                                      BUCKET_STRAW2, BUCKET_TREE,
                                      BUCKET_UNIFORM, CRUSH_ITEM_NONE,
                                      CRUSH_ITEM_UNDEF, RULE_CHOOSE_FIRSTN,
                                      RULE_CHOOSE_INDEP,
                                      RULE_CHOOSELEAF_FIRSTN,
                                      RULE_CHOOSELEAF_INDEP, RULE_EMIT,
                                      RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                                      RULE_SET_CHOOSE_LOCAL_TRIES,
                                      RULE_SET_CHOOSE_TRIES,
                                      RULE_SET_CHOOSELEAF_STABLE,
                                      RULE_SET_CHOOSELEAF_TRIES,
                                      RULE_SET_CHOOSELEAF_VARY_R, RULE_TAKE,
                                      S64_MIN)
from ceph_tpu_torch.crush.hashfn import hash32_2, hash32_3, hash32_4
from ceph_tpu_torch.crush.lntable import ln_u16_table
from ceph_tpu_torch.crush.types import Bucket, CrushMap

_LN = None


def _ln16(u: int) -> int:
    global _LN
    if _LN is None:
        _LN = ln_u16_table()
    return int(_LN[u])


def _div64_trunc(a: int, b: int) -> int:
    """C div64_s64: truncation toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


# -- bucket chooses ----------------------------------------------------------

def bucket_perm_choose(b: Bucket, x: int, r: int) -> int:
    """Random-permutation choose (mapper.c:73-130).  The reference caches the
    partial permutation on the bucket; the result is a pure function of
    (bucket, x, r%size) so we compute it statelessly."""
    size = b.size
    pr = r % size
    if pr == 0:
        s = hash32_3(x, b.id & 0xFFFFFFFF, 0) % size
        return b.items[s]
    perm = list(range(size))
    for p in range(pr + 1):
        if p < size - 1:
            i = hash32_3(x, b.id & 0xFFFFFFFF, p) % (size - p)
            if i:
                perm[p + i], perm[p] = perm[p], perm[p + i]
    return b.items[perm[pr]]


def bucket_list_choose(b: Bucket, x: int, r: int) -> int:
    for i in range(b.size - 1, -1, -1):
        w = hash32_4(x, b.items[i] & 0xFFFFFFFF, r, b.id & 0xFFFFFFFF)
        w &= 0xFFFF
        w = (w * b.sum_weights[i]) >> 16
        if w < b.item_weights[i]:
            return b.items[i]
    return b.items[0]


def bucket_tree_choose(b: Bucket, x: int, r: int) -> int:
    n = len(b.node_weights) >> 1  # root
    while not (n & 1):
        w = b.node_weights[n]
        t = (hash32_4(x, n, r, b.id & 0xFFFFFFFF) * w) >> 32
        h = 0
        nn = n
        while (nn & 1) == 0:
            h += 1
            nn >>= 1
        left = n - (1 << (h - 1))
        if t < b.node_weights[left]:
            n = left
        else:
            n = n + (1 << (h - 1))
    return b.items[n >> 1]


def bucket_straw_choose(b: Bucket, x: int, r: int) -> int:
    high, high_draw = 0, 0
    for i in range(b.size):
        draw = hash32_3(x, b.items[i] & 0xFFFFFFFF, r)
        draw &= 0xFFFF
        draw *= b.straws[i]
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return b.items[high]


def bucket_straw2_choose(b: Bucket, x: int, r: int) -> int:
    """The hot loop (mapper.c:300-344): exponential-minimum sampling with
    fixed-point ln — this exact math is what the CUDA kernel batches."""
    high, high_draw = 0, 0
    for i in range(b.size):
        w = b.item_weights[i]
        if w:
            u = hash32_3(x, b.items[i] & 0xFFFFFFFF, r) & 0xFFFF
            ln = _ln16(u) - 0x1000000000000
            draw = _div64_trunc(ln, w)
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return b.items[high]


def crush_bucket_choose(b: Bucket, x: int, r: int) -> int:
    assert b.size > 0
    if b.alg == BUCKET_UNIFORM:
        return bucket_perm_choose(b, x, r)
    if b.alg == BUCKET_LIST:
        return bucket_list_choose(b, x, r)
    if b.alg == BUCKET_TREE:
        return bucket_tree_choose(b, x, r)
    if b.alg == BUCKET_STRAW:
        return bucket_straw_choose(b, x, r)
    if b.alg == BUCKET_STRAW2:
        return bucket_straw2_choose(b, x, r)
    return b.items[0]


def is_out(map_: CrushMap, weight: Sequence[int], item: int, x: int) -> bool:
    """Weight-fraction rejection (mapper.c:378-392)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (hash32_2(x, item) & 0xFFFF) >= w


# -- descent loops -----------------------------------------------------------

def choose_firstn(map_: CrushMap, bucket: Bucket, weight: Sequence[int],
                  x: int, numrep: int, type_: int, out: List[int],
                  outpos: int, out_size: int, tries: int, recurse_tries: int,
                  local_retries: int, local_fallback_retries: int,
                  recurse_to_leaf: bool, vary_r: int, stable: int,
                  out2: Optional[List[int]], parent_r: int) -> int:
    """Depth-first descent with retries (mapper.c:414-593)."""
    count = out_size
    rep = 0 if stable else outpos
    item = 0
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_ = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_.size >> 1)
                            and flocal > local_fallback_retries):
                        item = bucket_perm_choose(in_, x, r)
                    else:
                        item = crush_bucket_choose(in_, x, r)
                    if item >= map_.max_devices:
                        skip_rep = True
                        break
                    if item < 0:
                        sub = map_.bucket(item)
                        itemtype = sub.type if sub else -1
                    else:
                        itemtype = 0
                    if itemtype != type_:
                        if item >= 0 or map_.bucket(item) is None:
                            skip_rep = True
                            break
                        in_ = map_.bucket(item)
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            got = choose_firstn(
                                map_, map_.bucket(item), weight, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0,
                                local_retries, local_fallback_retries,
                                False, vary_r, stable, None, sub_r)
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject:
                        if itemtype == 0:
                            reject = is_out(map_, weight, item, x)
                        else:
                            reject = False
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def choose_indep(map_: CrushMap, bucket: Bucket, weight: Sequence[int],
                 x: int, left: int, numrep: int, type_: int, out: List[int],
                 outpos: int, tries: int, recurse_tries: int,
                 recurse_to_leaf: bool, out2: Optional[List[int]],
                 parent_r: int) -> None:
    """Breadth-first positionally-stable descent for EC (mapper.c:600-780)."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_ = bucket
            while True:
                r = rep + parent_r
                if (in_.alg == BUCKET_UNIFORM
                        and in_.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_.size == 0:
                    break
                item = crush_bucket_choose(in_, x, r)
                if item >= map_.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                if item < 0:
                    sub = map_.bucket(item)
                    itemtype = sub.type if sub else -1
                else:
                    itemtype = 0
                if itemtype != type_:
                    if item >= 0 or map_.bucket(item) is None:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_ = map_.bucket(item)
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        choose_indep(map_, map_.bucket(item), weight, x, 1,
                                     numrep, 0, out2, rep, recurse_tries, 0,
                                     False, None, r)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and is_out(map_, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


# -- rule VM -----------------------------------------------------------------

def do_rule(map_: CrushMap, ruleno: int, x: int, result_max: int,
            weight: Sequence[int]) -> List[int]:
    """Execute one placement rule (mapper.c:793-999); returns result vector."""
    # reference casts to __u32: negative ruleno is rejected, never indexed
    if not (0 <= ruleno < len(map_.rules)) or map_.rules[ruleno] is None:
        return []
    # reference callers always pass result_max >= 1; its scratch math would
    # overflow on 0, we just answer "no mapping"
    if result_max <= 0:
        return []
    rule = map_.rules[ruleno]
    t = map_.tunables
    choose_tries = t.choose_total_tries + 1
    choose_leaf_tries = 0
    local_retries = t.choose_local_tries
    local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    result: List[int] = []
    w: List[int] = [0] * result_max
    o: List[int] = [0] * result_max
    c: List[int] = [0] * result_max
    wsize = 0

    for step in rule.steps:
        firstn = False
        if step.op == RULE_TAKE:
            a1 = step.arg1
            if (0 <= a1 < map_.max_devices) or (
                    a1 < 0 and map_.bucket(a1) is not None):
                w[0] = a1
                wsize = 1
        elif step.op == RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif step.op == RULE_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                local_retries = step.arg1
        elif step.op == RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                local_fallback_retries = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif step.op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSE_FIRSTN,
                         RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_INDEP):
            if wsize == 0:
                continue
            firstn = step.op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSE_FIRSTN)
            recurse_to_leaf = step.op in (RULE_CHOOSELEAF_FIRSTN,
                                          RULE_CHOOSELEAF_INDEP)
            osize = 0
            for i in range(wsize):
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                bucket = map_.bucket(w[i]) if w[i] < 0 else None
                if bucket is None:
                    continue
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    # out/out2 views start at osize like the C pointer math
                    sub_out = [0] * (result_max - osize)
                    sub_out2 = [0] * (result_max - osize)
                    got = choose_firstn(
                        map_, bucket, weight, x, numrep, step.arg2,
                        sub_out, 0, result_max - osize,
                        choose_tries, recurse_tries,
                        local_retries, local_fallback_retries,
                        recurse_to_leaf, vary_r, stable, sub_out2, 0)
                    o[osize:osize + got] = sub_out[:got]
                    c[osize:osize + got] = sub_out2[:got]
                    osize += got
                else:
                    out_size = min(numrep, result_max - osize)
                    sub_out = [0] * out_size
                    sub_out2 = [0] * out_size
                    choose_indep(
                        map_, bucket, weight, x, out_size, numrep,
                        step.arg2, sub_out, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, sub_out2, 0)
                    o[osize:osize + out_size] = sub_out
                    c[osize:osize + out_size] = sub_out2
                    osize += out_size
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w, o = o, w
            wsize = osize
        elif step.op == RULE_EMIT:
            for i in range(wsize):
                if len(result) >= result_max:
                    break
                result.append(w[i])
            wsize = 0
    return result
