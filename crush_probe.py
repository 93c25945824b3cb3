#!/usr/bin/env python3
"""Measurements behind the CRUSH and EC kernel rows of PERF.md, one
subcommand each.

    python3 crush_probe.py host-engines [--sizes 16,64,256,1024,4096]
    python3 crush_probe.py sass-ops
    python3 crush_probe.py crush-times
    python3 crush_probe.py gf-ops
    python3 crush_probe.py gf-times

``host-engines`` times the CPU descents of the port on the chip smoke
test's maps (1024 OSDs, 128 hosts x 8; replicated firstn x3, EC indep x6,
and firstn x3 behind 16 racks): the host engine
(``batch_do_rule_arrays(engine="host")``) with its straw2 draws in the
native host library and in numpy alone, and the kernel's plain torch
version on the CPU (``engine="device", device="cpu"``), at batch sizes an
Objecter cork flush or a small pool's priming hands them.  Each time is
the median of repeated calls through the entry point; the results must
be equal.  It runs on any host and times the host's CPU, not a card.

``sass-ops`` builds ``csrc/crush_map.cu`` (nvcc, sm_90a), disassembles
the library with ``cuobjdump -sass`` and, for ``crush_straw2_winners``
and every instantiation of the descent kernel, counts the instructions
that one straw2 draw issues along the path of a drawn item with a
nonzero weight, split by the pipe that executes each instruction on
Hopper, with the CALLs in the item loops (none: no emulated division)
and nvcc's registers and stack frame.  It prints JSON lines.  It needs
the CUDA toolkit, not a card.  What a draw issues is a diagnostic: the
CRUSH kernels' bounds count the hash's operations (chip_smoke.py).

``crush-times`` times every lane variant of the descent kernel on the
card, in turns, on 1M inputs for each of the chip smoke test's three rules
and on its OSDMap pools' PGs, each variant held bit for bit against the
first; then the SM clock under load.  It uses only the kernel module's
public entry points, so a copy of this file run from the root of an older
checkout times that checkout's kernel (at its wrapper's own choice where
it has no lane variants); each row's ``sha256`` of the packed result lets
the two runs be held against each other.

``gf-ops`` does for ``csrc/gf_apply.cu`` what ``sass-ops`` does for the
CRUSH kernels: for every TUNE_SPACE variant it counts, by pipe, the
instructions that the input-row loop of the 16-byte-load path issues per
4-lane word, for each number of output rows the loop serves, and the
floor those instructions set at the encode window; with nvcc's
``-Xptxas -v`` registers and spills.  It needs the
toolkit, not a card.

``gf-times`` times every TUNE_SPACE variant of ``gf_apply`` and
``gf_apply_checksum`` on the card at the shapes the EC batch queue
launches (the encode window and the decode windows), with L2 flushed
before each launch.  It uses only the kernel module's public entry
points, so a copy of this file run from the root of an older checkout
times that checkout's kernel.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np


def _median_s(fn, min_total_s=0.2, min_reps=5):
    fn()
    times = []
    while len(times) < min_reps or sum(times) < min_total_s:
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def host_engine_rows(sizes, plain=True, log=print):
    """Rows of median times of the CPU descents at each batch size on
    chip_smoke's three rules: the host engine with its native straw2
    draws (``native_ms``; when the library is built), the host engine in
    numpy alone (``numpy_ms``) and, with ``plain``, the kernel's plain
    torch version on the CPU (``plain_torch_ms``).  All results must be
    equal."""
    from chip_smoke import crush_maps
    from ceph_tpu_torch import native
    from ceph_tpu_torch.ops import crush_kernel as ck
    rules, w = crush_maps()
    rng = np.random.default_rng(20261017)
    have_native = native.available()
    saved = ck._native_mod
    rows = []

    def host(*args):
        return ck.batch_do_rule_arrays(*args, "host")
    try:
        for name, m, rule, size in rules:
            for n in sizes:
                xs = rng.integers(0, 2**32, n, dtype=np.int64)
                args = (m, rule, xs, size, w)
                ck._native_mod = False
                want = host(*args)
                row = {"rule": name, "inputs": n,
                       "numpy_ms": _median_s(lambda: host(*args)) * 1e3}
                results = []
                if have_native:
                    ck._native_mod = native
                    results.append(("native", host(*args)))
                    row["native_ms"] = _median_s(lambda: host(*args)) * 1e3
                if plain:
                    results.append(("plain torch", ck.batch_do_rule_arrays(
                        *args, "device", "cpu")))
                    row["plain_torch_ms"] = _median_s(
                        lambda: ck.batch_do_rule_arrays(
                            *args, "device", "cpu")) * 1e3
                for label, got in results:
                    if not (np.array_equal(got[0], want[0])
                            and (want[1] is None
                                 or np.array_equal(got[1], want[1]))):
                        raise SystemExit(f"{name} at {n}: {label} differs "
                                         f"from the numpy host engine")
                rows.append(row)
                log(f"{name:20s} {n:6d} inputs: " + ", ".join(
                    f"{k[:-3]} {v:9.3f} ms" for k, v in row.items()
                    if k.endswith("_ms")))
    finally:
        ck._native_mod = saved
    return rows


def host_engines(sizes):
    import torch
    from ceph_tpu_torch import native
    print(f"cpu: {os.cpu_count()} cores, torch {torch.__version__} with "
          f"{torch.get_num_threads()} threads; native library "
          f"{'built' if native.available() else 'unavailable'}, GFNI/"
          f"AVX-512 {native.gf_simd_available()}")
    print(json.dumps({"host_engines": host_engine_rows(sizes)}))


# --------------------------------------------------------------- SASS ops
# Each instruction goes to the pipe that executes it on Hopper.  Results
# per clock and SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0): 64 for 32-bit integer add,
# subtract, shift, bitwise, compare and select (the ALU pipe); 64 for
# integer multiply-add, IMAD, which runs on the FMA pipe beside the ALU;
# 16 for type conversions, MUFU, leading-zero and population counts.  The
# 32 load/store units take one thread's access per clock each.  Four
# schedulers issue one warp instruction per clock each: 128.  Uniform
# datapath (U*) and control instructions take issue slots only.
SM_RATES = {"issue": 128, "alu": 64, "fma": 64, "slow": 16, "mem": 32}
PIPES = (
    ("alu", re.compile(r"^(IADD3|LOP3|SHF|ISETP|SEL|LEA|IMNMX|VIMNMX|PRMT|"
                       r"BMSK|SGXT|PLOP3|P2R|R2P|IABS|FSEL|FSETP|FMNMX|"
                       r"VIADD|MOV|CS2R)\b")),
    ("fma", re.compile(r"^(IMAD|IDP|FFMA|FMUL|FADD|HFMA2|HMUL2|HADD2)\b")),
    ("slow", re.compile(r"^(MUFU|I2F|F2I|F2F|I2I|FRND|FLO|POPC|BREV)\b")),
    ("mem", re.compile(r"^(LD|LDS|LDG|LDGSTS|LDC|LDL|ST|STS|STG|STL|ATOM|"
                       r"ATOMS|ATOMG|RED)\b")),
    ("uniform", re.compile(r"^(U[A-Z0-9]+|S2UR)\b")),
)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_HEX = re.compile(r"\b0x([0-9a-f]+)\b")


def pipe_of(op: str) -> str:
    for name, pat in PIPES:
        if pat.match(op):
            return name
    return "control"        # BRA, BSSY, BSYNC, CALL, RET, S2R, BAR, ...


def functions(sass: str):
    """{function: {address: (instruction without predicate, with it)}}
    from the text ``cuobjdump -sass`` prints."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            raw = m.group(2).strip()
            text = re.sub(r"^@!?U?P[T0-9]+\s+", "", raw)
            cur[int(m.group(1), 16)] = (text, raw)
    return funcs


def _target(text: str) -> int:
    return int(_HEX.search(text.split(None, 1)[1]).group(1), 16)


def _subroutine(insns, addr):
    """The instructions of a called routine, up to its RET (straight-line
    code only)."""
    out = []
    while True:
        text, _ = insns[addr]
        op = text.split()[0]
        if op == "BRA":
            raise ValueError(f"branch at {addr:#x} inside a called routine")
        out.append(text)
        if op == "RET" or op.startswith("RET."):
            return out
        addr += 16


def loop_paths(insns, start: int, stop: int, out_of_line: bool = False):
    """Every path through one iteration of the loop whose body runs from
    ``start`` to the backward branch at ``stop``: each a list of the
    instructions it issues, a called routine's included.  A branch that
    leaves [start, stop] is refused, unless ``out_of_line``: then the
    walk follows it (nvcc places cold blocks after the loop and branches
    back), a branch back to ``start`` also ends an iteration, and a path
    that reaches an EXIT or RET has left the loop and is dropped."""
    paths = []

    def walk(addr, acc, seen):
        while True:
            if addr in seen:
                raise ValueError(f"{addr:#x} twice in one iteration of the "
                                 f"loop at {start:#x}")
            seen = seen | {addr}
            text, raw = insns[addr]
            op = text.split()[0].split(".")[0]
            acc = acc + [text]
            if addr == stop:
                paths.append(acc)
                return
            if op == "BRA":
                target = _target(text)
                if not out_of_line and not addr < target <= stop:
                    raise ValueError(f"branch at {addr:#x} leaves the loop")
                if raw.startswith("@"):
                    walk(addr + 16, acc, seen)
                if out_of_line and target == start:
                    paths.append(acc)
                    return
                addr = target
                continue
            if op == "CALL":
                acc = acc + _subroutine(insns, _target(text))
            elif op in ("EXIT", "RET"):
                if out_of_line:
                    return
                raise ValueError(f"{op} at {addr:#x} inside the loop")
            addr += 16

    walk(start, [], frozenset())
    return paths


def count(path):
    """Instructions of one path by pipe, NOPs left out."""
    by = dict.fromkeys(("alu", "fma", "slow", "mem", "uniform",
                        "control"), 0)
    for text in path:
        op = text.split()[0]
        if op != "NOP":
            by[pipe_of(op.split(".")[0])] += 1
    by["issue"] = sum(by.values())
    return by


def sm_clocks(by) -> float:
    """The least SM clocks one thread's share of these instructions
    takes: the busiest pipe, or issue."""
    return max(by[p] / rate for p, rate in SM_RATES.items())


#: straw2_index (csrc/crush_map.cu) draws two items per iteration of its
#: item loop, so that two hash chains interleave
DRAWS_PER_ITERATION = 2
#: a loop body with at least this many right shifts holds a hash (hash32_3
#: shifts right 30 times); the collision and table loops shift far less
_HASH_SHIFTS = 16
_MAP_KERNEL = re.compile(r"crush_map_kernelILb([01])ELi(\d+)ELb([01])E")


def draw_loops(insns):
    """(start, stop) of each item loop of a straw2 choice: the innermost
    backward branches whose bodies read shared memory (the ln tables) and
    hold a hash's run of right shifts.  A branch back from a block placed
    after a loop into its middle is no loop: its range holds the loop's
    own backward branch, which crosses the range's start."""
    back = {a: _target(t) for a, (t, _) in insns.items()
            if t.split()[0].split(".")[0] == "BRA" and _target(t) < a}
    loops = []
    for a, t in back.items():
        body = [insns[b][0] for b in range(t, a + 16, 16) if b in insns]
        if (any(x.startswith("LDS") for x in body)
                and sum(x.startswith("SHF.R") for x in body)
                >= _HASH_SHIFTS
                and not any(t < b < a and bt < t for b, bt in back.items())):
            loops.append((t, a))
    return [lp for lp in loops
            if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                       for o in loops)]


def draw_cost(sass: str, function: str = "crush_straw2_winners_kernel"):
    """Instructions per drawn item (nonzero weight) of the straw2 choice
    as compiled in the first kernel whose name holds ``function``: its
    item loops (``draw_loops``) draw DRAWS_PER_ITERATION items per
    iteration, each reading the ln tables the same number of times, so a
    path's draws are its shared-memory loads over those of a path that
    draws every item.  The paths that draw every item differ in
    crush_ln's normalisation block (taken when the 16-bit hash + 1 is
    below 0x8000, half of all hash values) and in the compare: the cost
    is their mean, per draw.  ``calls_in_loop`` counts the CALLs in the
    loops' bodies (an emulated division would be one)."""
    funcs = functions(sass)
    name = next(f for f in funcs if function in f)
    insns = funcs[name]
    loops = draw_loops(insns)
    if not loops:
        raise ValueError(f"no straw2 item loop in {name}")
    full, all_paths, calls = [], [], 0
    for start, stop in loops:
        calls += sum(insns[b][0].startswith("CALL")
                     for b in range(start, stop + 16, 16) if b in insns)
        paths = loop_paths(insns, start, stop, out_of_line=True)
        lds = [sum(t.startswith("LDS") for t in p) for p in paths]
        if max(lds) % DRAWS_PER_ITERATION:
            raise ValueError(f"{max(lds)} shared loads in the loop at "
                             f"{start:#x} of {name}: not "
                             f"{DRAWS_PER_ITERATION} draws' worth")
        all_paths += [count(p) for p in paths]
        full += [{k: v / DRAWS_PER_ITERATION for k, v in count(p).items()}
                 for p, n in zip(paths, lds) if n == max(lds)]
    mean = {k: statistics.mean(d[k] for d in full) for k in full[0]}
    return {"function": name,
            "loops": [[hex(a), hex(b)] for a, b in loops],
            "paths": all_paths, "draw_paths": full, "per_draw": mean,
            "sm_clocks_per_draw": sm_clocks(mean), "calls_in_loop": calls,
            "sm_rates": SM_RATES}


def map_kernels(sass: str):
    """{(firstn, lanes, uniform): function name} of crush_map_kernel's
    instantiations in the SASS."""
    out = {}
    for name in functions(sass):
        m = _MAP_KERNEL.search(name)
        if m:
            out[bool(int(m.group(1))), int(m.group(2)),
                bool(int(m.group(3)))] = name
    return out


# ------------------------------------------------------------ gf_apply ops
_GF_KERNEL = re.compile(
    r"gf_apply_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])ELb([01])E")
_WIDE_LOAD = re.compile(r"^LDG\S*\.128\b")


def gf_kernel(funcs, variant, vec=True, checksum=False) -> str:
    """The name of gf_apply_kernel<threads, lanes, rows, vec, checksum>
    among ``functions(sass)``."""
    want = tuple(variant) + (int(vec), int(checksum))
    for name in funcs:
        m = _GF_KERNEL.search(name)
        if m and tuple(map(int, m.groups())) == want:
            return name
    raise ValueError(f"no gf_apply_kernel{want} in the SASS")


def gf_word_cost(funcs, variant, checksum=False):
    """Instructions per 4-lane word and input row of one variant's
    16-byte-load path, as compiled: the input-row loop is the backward
    branch whose body makes 16-byte loads and PRMTs (the table copy
    makes 16-byte loads only, the byte path PRMTs only); each path
    through it serves some number of output rows (its PRMTs over 3 per
    word), and the longest path per row count is kept.  ``per_row`` and ``base`` fit
    the counts of the fewest and the most rows served; loads and stores
    outside the loop (the tables, the epilogue) are left out.  ``funcs``
    is ``functions(sass)``."""
    name = gf_kernel(funcs, variant, True, checksum)
    insns = funcs[name]
    words = variant[1] // 4
    back = [(a, _target(t)) for a, (t, _) in insns.items()
            if t.split()[0].split(".")[0] == "BRA" and _target(t) < a
            and any(_WIDE_LOAD.match(insns[b][0])
                    for b in range(_target(t), a, 16))
            and any(insns[b][0].startswith("PRMT")
                    for b in range(_target(t), a, 16))]
    if len(back) != 1:
        raise ValueError(f"{len(back)} row loops with 16-byte loads in "
                         f"{name}")
    stop, start = back[0]
    by_rows = {}
    for path in loop_paths(insns, start, stop):
        if not any(_WIDE_LOAD.match(t) for t in path):
            continue
        n = count(path)
        rows = round(sum(t.startswith("PRMT") for t in path) / (3 * words))
        if rows not in by_rows or n["issue"] > by_rows[rows]["issue"]:
            by_rows[rows] = n
    if not by_rows:
        raise ValueError(f"no path of {name}'s row loop loads")
    per_word = {rows: {p: c / words for p, c in n.items()}
                for rows, n in sorted(by_rows.items())}
    lo, hi = min(per_word), max(per_word)
    if hi == lo:
        raise ValueError(f"{name}'s row loop serves {lo} rows only")
    per_row = {p: (per_word[hi][p] - per_word[lo][p]) / (hi - lo)
               for p in per_word[hi]}
    base = {p: per_word[lo][p] - lo * per_row[p] for p in per_word[lo]}
    return {"function": name, "loop": [hex(start), hex(stop)],
            "words_per_thread": words, "per_word": per_word,
            "per_row": per_row, "base": base}


def gf_floor_ms(cost, k: int, r: int, L: int, sm_clocks_per_s: float):
    """The least time the row loop's instructions take for [k, L] ->
    [r, L] on the card: L/4 words times k input rows times the SM clocks
    of one word on its busiest pipe, per row tile of the variant (a tile
    serves up to its rows; each tile runs the loop again)."""
    max_rows = max(cost["per_word"])
    clocks = 0.0
    for r0 in range(0, r, max_rows):
        rt = min(max_rows, r - r0)
        by = cost["per_word"].get(rt)
        if by is None:
            by = {p: cost["base"][p] + rt * cost["per_row"][p]
                  for p in cost["base"]}
        clocks += sm_clocks(by)
    return L / 4 * k * clocks / sm_clocks_per_s * 1e3


def ptxas_report(text: str):
    """{function: {registers, stack_frame, spill_stores, spill_loads}}
    from nvcc's ``-Xptxas -v`` output (bytes for all but registers)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            (cur["stack_frame"], cur["spill_stores"],
             cur["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def gf_report(built):
    """{(variant, checksum): row-loop cost} for every TUNE_SPACE variant
    of both entries of a built gf_apply library: ``gf_word_cost`` plus
    ``ptxas``, the registers and spills of its 16-byte-path ("vec") and
    byte-path ("bytes") kernels."""
    from ceph_tpu_torch.ec import kernel
    funcs = functions(disassemble(built.path))
    regs = ptxas_report(built.ptxas)
    out = {}
    for variant in kernel.TUNE_SPACE:
        for checksum in (False, True):
            cost = gf_word_cost(funcs, variant, checksum)
            cost["ptxas"] = {
                ("vec" if vec else "bytes"): regs.get(
                    gf_kernel(funcs, variant, vec, checksum), {})
                for vec in (True, False)}
            out[variant, checksum] = cost
    return out


def gf_ops():
    from chip_smoke import K, M, SM_CLOCKS_PER_S
    from ceph_tpu_torch.common.cuda_build import build
    for (variant, checksum), cost in gf_report(build("gf_apply")).items():
        print(json.dumps({
            "variant": variant,
            "entry": "gf_apply_checksum" if checksum else "gf_apply",
            "per_word": cost["per_word"], "per_row": cost["per_row"],
            "base": cost["base"], "ptxas": cost["ptxas"],
            "floor_ms_encode": gf_floor_ms(cost, K, M, 1 << 22,
                                           SM_CLOCKS_PER_S)}))


def sm_clock_under_load(torch, fn, seconds: float = 1.0):
    """The SM clocks (MHz) nvidia-smi samples every 50 ms while fn()
    runs back to back for ``seconds``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.2)
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    return [int(v) for v in out.split() if v.isdigit()]


def gf_times(torch, dev, reps: int = 15):
    """Median L2-flushed time of every TUNE_SPACE variant of gf_apply and
    gf_apply_checksum at the EC batch queue's windows: the k=8 m=4
    encode at 4 Mi lanes, and the decode matrices that rebuild 2 and 4
    lost data chunks at 1 Mi and 4 Mi lanes.  Then the encode matrix at
    2 Mi lanes with no flush, whose 24 MiB stay in the 50 MB L2: with
    HBM out of the way, what the instructions take."""
    from chip_smoke import K, M, median_ms
    from ceph_tpu_torch.ec import gf256, kernel
    gen = gf256.rs_vandermonde_matrix(K, M)
    mats = [("encode", gen[K:])]
    for lost in ([0, 3], [0, 1, 2, 3]):
        present = [i for i in range(K + M) if i not in lost][:K]
        mats.append((f"decode {len(lost)} lost",
                     gf256.decode_matrix(gen, present, lost)))
    shapes = [(mats[0], 1 << 22)] + [(m, L) for m in mats[1:]
                                     for L in (1 << 20, 1 << 22)]
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(5)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for (label, mat), L in shapes:
        r, k = mat.shape
        ops = kernel.from_reference_matrix(mat, dev)
        data = torch.randint(0, 256, (k, L), dtype=torch.uint8, device=dev,
                             generator=gen_t)
        for cfg in kernel.TUNE_SPACE:
            ms = median_ms(torch, lambda: kernel.gf_apply(ops, data,
                                                          config=cfg),
                           reps, flush)
            c_ms = median_ms(torch, lambda: kernel.gf_apply_checksum(
                ops, data, cfg), reps, flush)
            rows.append({"shape": label, "k": k, "r": r, "L": L,
                         "variant": cfg, "ms": ms, "checksum_ms": c_ms})
    mat = mats[0][1]
    ops = kernel.from_reference_matrix(mat, dev)
    data = torch.randint(0, 256, (K, 1 << 21), dtype=torch.uint8,
                         device=dev, generator=gen_t)
    for cfg in kernel.TUNE_SPACE:
        ms = median_ms(torch, lambda: kernel.gf_apply(ops, data, config=cfg),
                       reps)
        c_ms = median_ms(torch, lambda: kernel.gf_apply_checksum(
            ops, data, cfg), reps)
        rows.append({"shape": "encode, L2-resident", "k": K, "r": M,
                     "L": 1 << 21, "variant": cfg, "ms": ms,
                     "checksum_ms": c_ms})
    return rows


def gf_times_main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gf-times needs a CUDA device")
    from chip_smoke import K, M
    from ceph_tpu_torch.ec import gf256, kernel
    dev = torch.device("cuda")
    for row in gf_times(torch, dev):
        print(json.dumps(row))
    ops = kernel.from_reference_matrix(gf256.rs_vandermonde_matrix(K, M)[K:],
                                       dev)
    data = torch.randint(0, 256, (K, 1 << 22), dtype=torch.uint8,
                         device=dev)
    print(json.dumps({"sm_clock_mhz_under_load": sm_clock_under_load(
        torch, lambda: kernel.gf_apply(ops, data))}))


def disassemble(lib_path: str) -> str:
    from ceph_tpu_torch.common.cuda_build import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout


def crush_report(built):
    """[(label, draw cost, ptxas)] for ``crush_straw2_winners`` and every
    instantiation of the descent kernel in a built crush_map library:
    ``draw_cost`` of its item loops and nvcc's registers, stack frame
    and spills for it."""
    sass = disassemble(built.path)
    regs = ptxas_report(built.ptxas)
    kernels = [("crush_straw2_winners", "crush_straw2_winners_kernel")]
    kernels += [(f"crush_map firstn={int(f)} lanes={g} uniform={int(u)}", n)
                for (f, g, u), n in sorted(map_kernels(sass).items())]
    out = []
    for label, name in kernels:
        cost = draw_cost(sass, name)
        out.append((label, cost, regs.get(cost["function"], {})))
    return out


def sass_ops():
    from ceph_tpu_torch.common.cuda_build import build
    for label, cost, ptxas in crush_report(build("crush_map")):
        print(f"{label}: {len(cost['loops'])} item loops, CALLs in them "
              f"{cost['calls_in_loop']}; per draw {cost['per_draw']}; "
              f"{cost['sm_clocks_per_draw']:.4f} SM clocks; ptxas {ptxas}")
        print(json.dumps({"kernel": label, "ptxas": ptxas} | {
            k: cost[k] for k in ("function", "loops", "per_draw",
                                 "sm_clocks_per_draw", "calls_in_loop")}))


# ------------------------------------------------------------ CRUSH times

def crush_times(torch, cases, reps: int = 7):
    """Median time of every lane variant of ``crush_map`` on each case,
    in turns: variants ascending, then descending; each row's times are
    the means of its two turns.  A tree whose kernel module has no lane
    variants (an older checkout's) is timed at its wrapper's own choice,
    ``"default"``.  A case is a dict with the launch's arguments (eng,
    xs, numrep, out_size, weights, osd_w), its ``name``, and ``want``, the
    packed result every variant must equal (None: the first variant's);
    a row's ``sha256`` digests that result, so runs of two trees can be
    held against each other."""
    from chip_smoke import median_ms
    from ceph_tpu_torch.ops import crush_kernel as ck
    rows = []
    for case in cases:
        args = [case[k] for k in ("eng", "xs", "numrep", "out_size",
                                  "weights", "osd_w")]
        fns = {str(g): (lambda g=g: ck.crush_map(*args, lanes=g))
               for g in getattr(ck, "LANE_VARIANTS", ())}
        fns = fns or {"default": lambda: ck.crush_map(*args)}
        want = case.get("want")
        if want is None:
            want = next(iter(fns.values()))()
        for key, fn in fns.items():
            if not torch.equal(fn().to(want.dtype), want):
                raise ValueError(f"{case['name']}: lanes {key} differ from "
                                 f"the reference result")
        order = list(fns)
        times = {k: [] for k in order}
        for k in order + order[::-1]:
            times[k].append(median_ms(torch, fns[k], reps))
        rows.append({"case": case["name"], "inputs": int(args[1].shape[0]),
                     "sha256": hashlib.sha256(
                         want.to(torch.int32).cpu().numpy().tobytes()
                     ).hexdigest()[:16],
                     "ms": {k: statistics.mean(v) for k, v in times.items()},
                     "turns": times})
    return rows


def crush_cases(torch, dev):
    """The chip smoke test's CRUSH cases: 1M inputs for each of its three
    rules on 1024 OSDs, and its OSDMap's two pools at their PG counts."""
    from chip_smoke import CRUSH_N, build_osdmap, crush_maps
    from ceph_tpu_torch.ops import crush_kernel as ck
    rules, w = crush_maps()
    xs = torch.arange(CRUSH_N, dtype=torch.int64, device=dev)
    osd_w = torch.tensor(w, dtype=torch.int64, device=dev)
    cases = []
    for name, m, rule, size in rules:
        seg = ck.compile_rule(m, rule).segments[0]
        eng = ck._device_engine(seg, w, dev)
        cases.append({"name": name, "eng": eng, "xs": xs, "numrep": size,
                      "out_size": size, "weights": eng.weights(seg),
                      "osd_w": osd_w})
    om = build_osdmap()
    pw = torch.tensor(om.osd_weight, dtype=torch.int64, device=dev)
    for pid in sorted(om.pools):
        pool = om.pools[pid]
        ruleno = om.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
        seg = ck.compile_rule(om.crush, ruleno).segments[0]
        numrep, out_size = ck._seg_numrep(seg, pool.size)
        eng = ck._device_engine(seg, om.osd_weight, dev)
        pps = [pool.raw_pg_to_pps(pg) for pg in om.pg_ids(pid)]
        cases.append({"name": f"pool {om.pool_names[pid]}", "eng": eng,
                      "xs": torch.tensor(pps, dtype=torch.int64, device=dev),
                      "numrep": numrep, "out_size": out_size,
                      "weights": eng.weights(seg), "osd_w": pw})
    return cases


def crush_times_main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("crush-times needs a CUDA device")
    from ceph_tpu_torch.ops import crush_kernel as ck
    dev = torch.device("cuda")
    cases = crush_cases(torch, dev)
    for row, case in zip(crush_times(torch, cases), cases):
        if hasattr(ck, "choose_lanes"):
            row["chosen_lanes"] = ck.choose_lanes(
                row["inputs"], ck.thread_slots(dev),
                case["eng"].straw2_widths)
        print(json.dumps(row))
    c = cases[0]
    print(json.dumps({"sm_clock_mhz_under_load": sm_clock_under_load(
        torch, lambda: ck.crush_map(c["eng"], c["xs"], c["numrep"],
                                    c["out_size"], c["weights"],
                                    c["osd_w"]))}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crush_probe")
    sub = ap.add_subparsers(dest="cmd", required=True)
    h = sub.add_parser("host-engines")
    h.add_argument("--sizes", default="16,64,256,1024,4096")
    sub.add_parser("sass-ops")
    sub.add_parser("gf-ops")
    sub.add_parser("gf-times")
    sub.add_parser("crush-times")
    args = ap.parse_args(argv)
    if args.cmd == "host-engines":
        host_engines([int(s) for s in args.sizes.split(",")])
    elif args.cmd == "sass-ops":
        sass_ops()
    elif args.cmd == "gf-ops":
        gf_ops()
    elif args.cmd == "crush-times":
        crush_times_main()
    else:
        gf_times_main()
    return 0


if __name__ == "__main__":
    sys.exit(main())
