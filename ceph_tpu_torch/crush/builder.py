"""CRUSH map construction: buckets with derived per-alg state.

Reference parity: crush/builder.c — crush_make_{uniform,list,tree,straw,
straw2}_bucket (:330-620) including straw length calculation
(crush_calc_straw :439, both straw_calc_version 0 and 1) and tree
node-weight propagation (:366-397).
"""

from __future__ import annotations

import math
from typing import List, Optional

from ceph_tpu_torch.crush.constants import (BUCKET_LIST, BUCKET_STRAW,
                                      BUCKET_STRAW2, BUCKET_TREE,
                                      BUCKET_UNIFORM, HASH_RJENKINS1)
from ceph_tpu_torch.crush.types import Bucket, CrushMap


def _calc_depth(size: int) -> int:
    if size == 0:
        return 0
    depth, t = 1, size - 1
    while t:
        t >>= 1
        depth += 1
    return depth


def _tree_node(i: int) -> int:
    return ((i + 1) << 1) - 1


def _height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _parent(n: int) -> int:
    h = _height(n)
    if n & (1 << (h + 1)):
        return n - (1 << h)
    return n + (1 << h)


def calc_straws(item_weights: List[int], straw_calc_version: int) -> List[int]:
    """Straw lengths for the legacy straw bucket (builder.c:439-556)."""
    size = len(item_weights)
    straws = [0] * size
    # reverse = indices sorted ascending by weight, stable (insertion sort)
    reverse = sorted(range(size), key=lambda i: (item_weights[i], i))
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        w_i = item_weights[reverse[i]]
        if straw_calc_version == 0:
            if w_i == 0:
                straws[reverse[i]] = 0
                i += 1
                continue
            straws[reverse[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            if item_weights[reverse[i]] == item_weights[reverse[i - 1]]:
                continue
            wbelow += (float(item_weights[reverse[i - 1]]) - lastw) * numleft
            j = i
            while j < size:
                if item_weights[reverse[j]] == item_weights[reverse[i]]:
                    numleft -= 1
                else:
                    break
                j += 1
            wnext = numleft * (item_weights[reverse[i]]
                               - item_weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = float(item_weights[reverse[i - 1]])
        else:
            if w_i == 0:
                straws[reverse[i]] = 0
                i += 1
                numleft -= 1
                continue
            straws[reverse[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            wbelow += (float(item_weights[reverse[i - 1]]) - lastw) * numleft
            numleft -= 1
            wnext = numleft * (item_weights[reverse[i]]
                               - item_weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = float(item_weights[reverse[i - 1]])
    return straws


def make_bucket(map_: CrushMap, alg: int, type_: int, items: List[int],
                weights: Optional[List[int]] = None, bucket_id: int = 0,
                hash_: int = HASH_RJENKINS1) -> Bucket:
    """Build a bucket with all derived state and register it in the map.

    ``weights`` are 16.16 fixed; for uniform buckets all items share
    weights[0] (reference crush_make_uniform_bucket semantics).
    """
    size = len(items)
    weights = list(weights or [0x10000] * size)
    b = Bucket(id=bucket_id, alg=alg, hash=hash_, type=type_,
               items=list(items))
    if alg == BUCKET_UNIFORM:
        w = weights[0] if size else 0
        b.item_weights = [w] * size
        b.weight = w * size
    elif alg == BUCKET_LIST:
        b.item_weights = weights
        total = 0
        for w in weights:
            total += w
            b.sum_weights.append(total)
        b.weight = total
    elif alg == BUCKET_TREE:
        depth = _calc_depth(size)
        num_nodes = 1 << depth if size else 0
        b.node_weights = [0] * num_nodes
        total = 0
        for i, w in enumerate(weights):
            node = _tree_node(i)
            b.node_weights[node] = w
            total += w
            for _ in range(1, depth):
                node = _parent(node)
                b.node_weights[node] += w
        b.weight = total
        b.item_weights = weights
    elif alg == BUCKET_STRAW:
        b.item_weights = weights
        b.weight = sum(weights)
        b.straws = calc_straws(weights, map_.tunables.straw_calc_version)
    elif alg == BUCKET_STRAW2:
        b.item_weights = weights
        b.weight = sum(weights)
    else:
        raise ValueError(f"unknown bucket alg {alg}")
    map_.add_bucket(b)
    for it in items:
        if it >= 0:
            map_.max_devices = max(map_.max_devices, it + 1)
    return b


def reweight_item(map_: CrushMap, b: Bucket, item: int, weight: int) -> None:
    """Adjust one item's weight, recomputing derived state
    (reference: crush_bucket_adjust_item_weight, builder.c:830-1130)."""
    map_._invalidate_kernel_cache()
    pos = b.items.index(item)
    if b.alg == BUCKET_UNIFORM:
        b.item_weights = [weight] * b.size
        b.weight = weight * b.size
        return
    old = b.item_weights[pos]
    b.item_weights[pos] = weight
    b.weight += weight - old
    if b.alg == BUCKET_LIST:
        total = 0
        b.sum_weights = []
        for w in b.item_weights:
            total += w
            b.sum_weights.append(total)
    elif b.alg == BUCKET_TREE:
        depth = _calc_depth(b.size)
        node = _tree_node(pos)
        b.node_weights[node] = weight
        diff = weight - old
        for _ in range(1, depth):
            node = _parent(node)
            b.node_weights[node] += diff
    elif b.alg == BUCKET_STRAW:
        b.straws = calc_straws(b.item_weights,
                               map_.tunables.straw_calc_version)


def make_replicated_rule(map_: CrushMap, name: str, root_name: str = "default",
                         failure_domain: str = "host") -> int:
    """take root; chooseleaf_firstn 0 <domain>; emit — what
    CrushWrapper::add_simple_ruleset builds (CrushWrapper.cc)."""
    from ceph_tpu_torch.crush.constants import (RULE_CHOOSELEAF_FIRSTN, RULE_EMIT,
                                          RULE_TAKE)
    from ceph_tpu_torch.crush.types import Rule, RuleStep
    root_id = _find_name(map_, root_name)
    dom = _find_type(map_, failure_domain)
    rule = Rule(ruleset=len(map_.rules), type=1, min_size=1, max_size=10,
                steps=[RuleStep(RULE_TAKE, root_id),
                       RuleStep(RULE_CHOOSELEAF_FIRSTN, 0, dom),
                       RuleStep(RULE_EMIT)])
    rid = map_.add_rule(rule)
    map_.rule_name_map[rid] = name
    return rid


def make_erasure_rule(map_: CrushMap, name: str, size: int,
                      failure_domain: str = "host",
                      root_name: str = "default") -> int:
    """take root; chooseleaf_indep <size> <domain>; emit — positionally
    stable placement for EC (ErasureCodeInterface create_ruleset role,
    src/erasure-code/ErasureCodeInterface.h:181)."""
    from ceph_tpu_torch.crush.constants import (RULE_CHOOSELEAF_INDEP, RULE_EMIT,
                                          RULE_SET_CHOOSELEAF_TRIES,
                                          RULE_SET_CHOOSE_TRIES, RULE_TAKE)
    from ceph_tpu_torch.crush.types import Rule, RuleStep
    root_id = _find_name(map_, root_name)
    dom = _find_type(map_, failure_domain)
    rule = Rule(ruleset=len(map_.rules), type=3, min_size=3,
                max_size=max(size, 3),
                steps=[RuleStep(RULE_SET_CHOOSELEAF_TRIES, 5),
                       RuleStep(RULE_SET_CHOOSE_TRIES, 100),
                       RuleStep(RULE_TAKE, root_id),
                       RuleStep(RULE_CHOOSELEAF_INDEP, size, dom),
                       RuleStep(RULE_EMIT)])
    rid = map_.add_rule(rule)
    map_.rule_name_map[rid] = name
    return rid


def _find_name(map_: CrushMap, name: str) -> int:
    for iid, n in map_.name_map.items():
        if n == name:
            return iid
    raise KeyError(f"no crush item named {name!r}")


def _find_type(map_: CrushMap, type_name: str) -> int:
    for tid, n in map_.type_map.items():
        if n == type_name:
            return tid
    raise KeyError(f"no crush type named {type_name!r}")


def build_hierarchy(map_: CrushMap, n_osds: int, osds_per_host: int,
                    alg: int = BUCKET_STRAW2, hosts_per_rack: int = 0,
                    osd_weight: int = 0x10000, root_name: str = "default"
                    ) -> Bucket:
    """Convenience: osds -> hosts (-> racks) -> root, registering names.

    Mirrors what CrushWrapper::build_simple_crush_map produces for tests.
    """
    hosts = []
    for h in range((n_osds + osds_per_host - 1) // osds_per_host):
        items = list(range(h * osds_per_host,
                           min((h + 1) * osds_per_host, n_osds)))
        hb = make_bucket(map_, alg, 1, items, [osd_weight] * len(items))
        map_.name_map[hb.id] = f"host{h}"
        hosts.append(hb)
        for o in items:
            map_.name_map[o] = f"osd.{o}"
    level = hosts
    if hosts_per_rack:
        racks = []
        for r in range((len(hosts) + hosts_per_rack - 1) // hosts_per_rack):
            group = hosts[r * hosts_per_rack:(r + 1) * hosts_per_rack]
            rb = make_bucket(map_, alg, 2, [g.id for g in group],
                             [g.weight for g in group])
            map_.name_map[rb.id] = f"rack{r}"
            racks.append(rb)
        level = racks
    root = make_bucket(map_, alg, 10, [b.id for b in level],
                       [b.weight for b in level])
    map_.name_map[root.id] = root_name
    return root
