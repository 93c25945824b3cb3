"""CrushCompiler: the textual crushmap dialect, both directions.

The port's copy of ``ceph_tpu.crush.compiler``: the same text, and the
same map bytes, in both directions.

Reference parity: src/crush/CrushCompiler.cc + src/crush/grammar.h — the
`crushtool -d` / `crushtool -c` text form:

    # begin crush map
    tunable choose_total_tries 50
    device 0 osd.0
    type 0 osd
    type 1 host
    host host0 {
        id -1
        alg straw2
        hash 0  # rjenkins1
        item osd.0 weight 1.000000
    }
    rule replicated_rule {
        ruleset 0
        type replicated
        min_size 1
        max_size 10
        step take default
        step chooseleaf firstn 0 type host
        step emit
    }
    # end crush map

Redesigned without boost::spirit: a line-oriented tokenizer (comments
stripped, braces as block markers) feeding small per-section parsers.
Weights print with 6 decimals so the 16.16 fixed-point values survive
the text round-trip exactly (1/65536 ~ 1.5e-5 > 0.5e-6 print error);
buckets must be defined before they are referenced, like the reference.
"""

from __future__ import annotations

import re
from typing import Dict, List

from ceph_tpu_torch.crush.builder import make_bucket
from ceph_tpu_torch.crush.constants import (
    BUCKET_ALG_NAMES, HASH_RJENKINS1,
    RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP, RULE_EMIT, RULE_SET_CHOOSELEAF_STABLE,
    RULE_SET_CHOOSELEAF_TRIES, RULE_SET_CHOOSELEAF_VARY_R,
    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES, RULE_SET_CHOOSE_LOCAL_TRIES,
    RULE_SET_CHOOSE_TRIES, RULE_TAKE,
)
from ceph_tpu_torch.crush.types import CrushMap, Rule, RuleStep

_ALG_IDS = {name: alg for alg, name in BUCKET_ALG_NAMES.items()}
_RULE_TYPE_NAMES = {1: "replicated", 3: "erasure"}
_RULE_TYPE_IDS = {v: k for k, v in _RULE_TYPE_NAMES.items()}
_SET_STEPS = {
    "set_choose_tries": RULE_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": RULE_SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries": RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": RULE_SET_CHOOSELEAF_STABLE,
}
_SET_STEP_NAMES = {v: k for k, v in _SET_STEPS.items()}
_CHOOSE_STEPS = {
    ("choose", "firstn"): RULE_CHOOSE_FIRSTN,
    ("choose", "indep"): RULE_CHOOSE_INDEP,
    ("chooseleaf", "firstn"): RULE_CHOOSELEAF_FIRSTN,
    ("chooseleaf", "indep"): RULE_CHOOSELEAF_INDEP,
}
_CHOOSE_STEP_NAMES = {v: k for k, v in _CHOOSE_STEPS.items()}

_TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
             "choose_total_tries", "chooseleaf_descend_once",
             "chooseleaf_vary_r", "chooseleaf_stable",
             "straw_calc_version")


class CompileError(ValueError):
    pass


def _w2s(w: int) -> str:
    return f"{w / 0x10000:.6f}"


def _s2w(s: str) -> int:
    return int(round(float(s) * 0x10000))


# ---------------------------------------------------------------- decompile

def decompile(m: CrushMap) -> str:
    """CrushMap -> reference-dialect text (CrushCompiler::decompile)."""
    out: List[str] = ["# begin crush map"]
    for t in _TUNABLES:
        out.append(f"tunable {t} {getattr(m.tunables, t)}")
    out.append("")
    out.append("# devices")
    for dev in range(m.max_devices):
        name = m.name_map.get(dev)
        if name is not None:
            out.append(f"device {dev} {name}")
    out.append("")
    out.append("# types")
    for tid in sorted(m.type_map):
        out.append(f"type {tid} {m.type_map[tid]}")
    out.append("")
    out.append("# buckets")
    # definition must precede reference: emit leaf-most first (reverse
    # id order matches builder output; fall back to dependency sort)
    done: set = set()
    order: List[int] = []

    def visit(bid: int) -> None:
        if bid in done:
            return
        done.add(bid)
        b = m.bucket(bid)
        if b is None:
            return
        for it in b.items:
            if it < 0:
                visit(it)
        order.append(bid)

    for b in m.buckets:
        if b is not None:
            visit(b.id)
    for bid in order:
        b = m.bucket(bid)
        tname = m.type_map.get(b.type, str(b.type))
        out.append(f"{tname} {m.name_of(b.id)} {{")
        out.append(f"\tid {b.id}\t\t# do not change unnecessarily")
        out.append(f"\t# weight {_w2s(b.weight)}")
        out.append(f"\talg {BUCKET_ALG_NAMES[b.alg]}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for it, w in zip(b.items, b.item_weights):
            out.append(f"\titem {m.name_of(it)} weight {_w2s(w)}")
        out.append("}")
    out.append("")
    out.append("# rules")
    for rid, r in enumerate(m.rules):
        if r is None:
            continue
        out.append(f"rule {m.rule_name_map.get(rid, f'rule{rid}')} {{")
        out.append(f"\truleset {r.ruleset}")
        out.append(f"\ttype {_RULE_TYPE_NAMES.get(r.type, str(r.type))}")
        out.append(f"\tmin_size {r.min_size}")
        out.append(f"\tmax_size {r.max_size}")
        for s in r.steps:
            if s.op == RULE_TAKE:
                out.append(f"\tstep take {m.name_of(s.arg1)}")
            elif s.op == RULE_EMIT:
                out.append("\tstep emit")
            elif s.op in _CHOOSE_STEP_NAMES:
                kind, mode = _CHOOSE_STEP_NAMES[s.op]
                tname = m.type_map.get(s.arg2, str(s.arg2))
                out.append(f"\tstep {kind} {mode} {s.arg1} type {tname}")
            elif s.op in _SET_STEP_NAMES:
                out.append(f"\tstep {_SET_STEP_NAMES[s.op]} {s.arg1}")
            else:
                raise CompileError(f"cannot decompile step op {s.op}")
        out.append("}")
    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


# ------------------------------------------------------------------ compile

def compile_text(text: str) -> CrushMap:
    """Reference-dialect text -> CrushMap (CrushCompiler::compile).

    Token-stream parse (newlines are just whitespace, exactly like the
    reference's spirit grammar — `host h { id -1 ... }` on one line is
    valid).  Buckets must be defined before they are referenced (same
    constraint as the reference's single-pass grammar)."""
    m = CrushMap()
    m.type_map = {}
    names: Dict[str, int] = {}          # item name -> id

    toks: List[str] = []
    for raw in text.splitlines():
        line = re.sub(r"#.*", "", raw)
        toks += line.replace("{", " { ").replace("}", " } ").split()

    def expect(i: int, what: str) -> None:
        if i >= len(toks) or toks[i] != what:
            got = toks[i] if i < len(toks) else "<eof>"
            raise CompileError(f"expected {what!r}, got {got!r}")

    def block_body(i: int):
        """toks[i] must be '{'; -> (body tokens, index past '}')."""
        expect(i, "{")
        j = i + 1
        depth = 1
        while j < len(toks):
            if toks[j] == "{":
                depth += 1
            elif toks[j] == "}":
                depth -= 1
                if depth == 0:
                    return toks[i + 1:j], j + 1
            j += 1
        raise CompileError("unterminated block")

    i = 0
    try:
        while i < len(toks):
            t = toks[i]
            if t == "tunable":
                if i + 2 >= len(toks) or toks[i + 1] not in _TUNABLES:
                    raise CompileError(f"bad tunable at {toks[i:i + 3]}")
                setattr(m.tunables, toks[i + 1], int(toks[i + 2]))
                i += 3
            elif t == "device":
                dev = int(toks[i + 1])
                names[toks[i + 2]] = dev
                m.name_map[dev] = toks[i + 2]
                m.max_devices = max(m.max_devices, dev + 1)
                i += 3
            elif t == "type":
                m.type_map[int(toks[i + 1])] = toks[i + 2]
                i += 3
            elif t == "rule":
                name = toks[i + 1]
                body, i = block_body(i + 2)
                _parse_rule(m, name, body, names)
            elif t in m.type_map.values():
                name = toks[i + 1]
                body, i = block_body(i + 2)
                _parse_bucket(m, t, name, body, names)
            else:
                raise CompileError(f"cannot parse at {toks[i:i + 4]}")
    except (IndexError, ValueError) as e:
        # truncated/malformed statements must fail as compile errors,
        # never tracebacks (crushtool -c catches CompileError)
        raise CompileError(f"malformed map text near token {i}: {e}")
    return m


def _parse_bucket(m: CrushMap, type_name: str, name: str,
                  body: List[str], names: Dict[str, int]) -> None:
    type_id = next(t for t, n in m.type_map.items() if n == type_name)
    bucket_id = 0
    alg = "straw2"
    hash_ = HASH_RJENKINS1
    items: List[int] = []
    weights: List[int] = []
    i = 0
    while i < len(body):
        t = body[i]
        if t == "id":
            bucket_id = int(body[i + 1])
            i += 2
        elif t == "alg":
            alg = body[i + 1]
            i += 2
        elif t == "hash":
            hash_ = int(body[i + 1])
            i += 2
        elif t == "item":
            item_name = body[i + 1]
            if item_name not in names:
                raise CompileError(
                    f"bucket {name!r}: item {item_name!r} not defined "
                    f"yet")
            items.append(names[item_name])
            i += 2
            w = 0x10000
            if i + 1 < len(body) and body[i] == "weight":
                w = _s2w(body[i + 1])
                i += 2
            weights.append(w)
        else:
            raise CompileError(f"bucket {name!r}: bad token {t!r}")
    if alg not in _ALG_IDS:
        raise CompileError(f"bucket {name!r}: unknown alg {alg!r}")
    b = make_bucket(m, _ALG_IDS[alg], type_id, items, weights,
                    bucket_id=bucket_id, hash_=hash_)
    names[name] = b.id
    m.name_map[b.id] = name


def _parse_rule(m: CrushMap, name: str, body: List[str],
                names: Dict[str, int]) -> None:
    ruleset = len(m.rules)
    rtype, min_size, max_size = 1, 1, 10
    steps: List[RuleStep] = []
    i = 0
    while i < len(body):
        t = body[i]
        if t == "ruleset":
            ruleset = int(body[i + 1])
            i += 2
        elif t == "type":
            rtype = _RULE_TYPE_IDS.get(body[i + 1])
            if rtype is None:
                try:
                    rtype = int(body[i + 1])
                except ValueError:
                    raise CompileError(
                        f"rule {name!r}: bad type {body[i + 1]!r}")
            i += 2
        elif t == "min_size":
            min_size = int(body[i + 1])
            i += 2
        elif t == "max_size":
            max_size = int(body[i + 1])
            i += 2
        elif t == "step":
            step, i = _parse_step(m, name, body, i + 1, names)
            steps.append(step)
        else:
            raise CompileError(f"rule {name!r}: bad token {t!r}")
    rid = m.add_rule(Rule(ruleset=ruleset, type=rtype, min_size=min_size,
                          max_size=max_size, steps=steps))
    m.rule_name_map[rid] = name


def _parse_step(m: CrushMap, rule: str, body: List[str], i: int,
                names: Dict[str, int]):
    """Parse one step starting at body[i]; -> (RuleStep, next index)."""
    op = body[i]
    if op == "take":
        target = body[i + 1]
        if target not in names:
            raise CompileError(f"rule {rule!r}: take of undefined "
                               f"{target!r}")
        return RuleStep(RULE_TAKE, names[target]), i + 2
    if op == "emit":
        return RuleStep(RULE_EMIT), i + 1
    if op in ("choose", "chooseleaf"):
        # step choose[leaf] firstn|indep N type T
        code = _CHOOSE_STEPS.get((op, body[i + 1]))
        if code is None or i + 4 >= len(body) or body[i + 3] != "type":
            raise CompileError(
                f"rule {rule!r}: bad step {body[i:i + 5]}")
        tid = next((t for t, n in m.type_map.items()
                    if n == body[i + 4]), None)
        if tid is None:
            raise CompileError(
                f"rule {rule!r}: unknown type {body[i + 4]!r}")
        return RuleStep(code, int(body[i + 2]), tid), i + 5
    if op in _SET_STEPS:
        return RuleStep(_SET_STEPS[op], int(body[i + 1])), i + 2
    raise CompileError(f"rule {rule!r}: unknown step {op!r}")
