#!/usr/bin/env python3
"""Chip smoke test of the port: ``python3 chip_smoke.py`` on a machine with
one CUDA card, from the root of a checkout.

It drives ceph_tpu_torch's EC write / degraded-read data path, the EC
variant tuner, CRUSH placement up to the OSDMap and osdmaptool, the lrc
and shec codecs, crushtool and psim on the card, and the native host
library on its host, and fails (exit code 1, no result line) on any
fault:

  1. prints the card's name and power limit, builds the kernels
     (csrc/gf_apply.cu and csrc/crush_map.cu, one nvcc each, for sm_90a)
     and the native host library (g++), all three started together, and
     prints each build time; for every CRUSH
     kernel instantiation its registers, stack frame and spills and the
     instructions one straw2 draw issues in the built SASS, by pipe,
     beside the hash's operations that the CRUSH bounds count (fails if
     an item loop holds a CALL: the division is a reciprocal multiply);
     the matrix apply's inner loop per 4-lane word, by pipe, with each
     variant's registers and spills (crush_probe.py);
  2. holds the matrix-apply kernel against its plain PyTorch version on
     the card, bit for bit, at the main path's shapes and at odd ones, and
     against the numpy host path on small inputs; then every TUNE_SPACE
     variant and the checksum probe (gf_apply_checksum) at the same
     shapes, at every lane bucket of the batch queue, for r = 1, 2 and 4
     and a large k, on strided and unaligned windows of wider buffers,
     and the probe on a sum that wraps past 2^31;
  3. drives the main path: an OSD context and ECBatchQueue(mode="on",
     device="cuda"); 64 concurrent 4 MiB objects (RS k=8 m=4) split by the
     codec and encoded through the queue, then two rounds of degraded
     reads that rebuild lost data chunks through the queue with the
     codec's decode matrices.  The kernel's launch count is set to 0 just
     before and read just after, and must equal the queue's launches;
  4. runs the ec_benchmark entry point at 256 MiB, encode and decode;
  5. times the kernel and its plain version at the encode window
     [8, 4 Mi] -> [4, 4 Mi] with CUDA events, and every variant of both
     entries there and at the decode windows [8, 1 Mi] and [8, 4 Mi] ->
     [2, .] and [4, .], L2 flushed (crush_probe.gf_times);
  6. the variant tuner's path, as the JAX package's bench runs it: autotune
     the encode matrix (installed process-wide), then the decode matrix
     for lost chunks {0, 3} (bound to its shape), then encode and decode
     rates by the slope method at 64 MiB and 256 MiB, checked bit for bit
     against the numpy host apply; the probe's launch count is set to 0
     just before and read just after;
  7. CRUSH: 1,000,000 inputs through batch_do_rule_arrays(engine="device")
     for a replicated firstn x3 and an EC indep x6 rule on 1024 OSDs
     (128 hosts x 8) and a firstn x3 rule on the same OSDs behind 16
     racks, with a few OSDs out or reweighted; every row equals the plain
     torch descent on the card, in the lanes per input the wrapper chose
     and in every other lane variant (each timed), a spread sample of
     4096 inputs equals the numpy host engine and the scalar mapper; then
     the straw2 winner grid of the 128-host root against its plain
     version;
  8. the OSDMap: a replicated pool (size 3, pg_num 32768) and an EC pool
     (k=4 m=2, pg_num 16384) on the same 1024 OSDs, some out, reweighted
     or down, through OSDMap.map_pgs_batch(engine="device") and
     osdmaptool --test-map-pgs (its default engine, the device), checked
     against engine="host"; then map_pgs_batch's steps are timed and the
     descent kernel alone at each pool's size, in every lane variant
     (each equal to the plain version), beside its bound there;
  9. the native host library: fails unless it built; gf_matrix_apply
     against the numpy host apply at the queue's host threshold, the
     straw2 draws against the numpy draw over the 128-host root at 65,536
     inputs; then host-clock times of the queue's host path (16 and 64 KiB
     requests) and of the CRUSH host engine (16 to 4096 inputs, the three
     rules of phase 7), native against numpy alone;
 10. Ceph's documented LRC (k=4 m=2 l=3) and SHEC (k=4 m=3 c=2) profiles
     on the card: phase 3's 64 objects through encode, decode with one
     data chunk lost (LRC from its local group, fewer than k chunks) and
     with the most losses each profile repairs; every chunk equal to the
     same codec's on the CPU; the matrix apply's launches set to 0 before
     and read after each step; ec_benchmark with both at 256 MiB; the
     apply's time at the narrow matrices of a 4 MiB object;
 11. crushtool on phase 7's map: -d then -c back to the same bytes;
     --test over 1,000,000 inputs on the default (device) engine, whose
     one crush_map launch is counted; on 65,536 inputs the device report
     equals the host engine's apart from timing;
 12. psim (1024 OSDs, 128 hosts, 32768 PGs, size 3, 1M objects) on the
     device and the host engines: equal reports, one crush_map launch;
 13. times the probe, the descent and the winner grid beside their plain
     versions and bounds, and prints the ``kernels`` line (launches by
     path: the queue, lrc, shec; the CRUSH path, the OSDMap, crushtool,
     psim).

The last line of its output is ``{"ok": true, "device": {...}}``.  It
imports nothing of JAX and nothing of the JAX package.
"""

import asyncio
import concurrent.futures
import contextlib
import io
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# SM clocks the whole card offers per second: 132 SMs x 1.98 GHz (the
# H100 SXM's maximum boost clock).
SM_CLOCKS_PER_S = 132 * 1.98e9
# The CRUSH kernels' bound counts the work, not the kernel: every straw2
# draw and every perm-choose step computes rjenkins hash32_3, 5 mixes of 9
# statements, each a three-input subtract, a shift and an xor, plus the
# seed xor: 136 integer operations, 46 of them xors; an is_out hash32_2 is
# 3 mixes, 82 operations, 28 xors.  Only the xors need the integer ALU
# pipe (LOP3, 64 lanes per SM clock).  A subtract or a shift can also
# issue on the FMA pipe (IMAD, IMAD.SHL; IMAD.HI shifts right by a
# constant), 64 lanes more, and an SM's four schedulers issue 128 lanes
# per clock in all (CUDA C++ Programming Guide, compute capability 9.0).
# So the hashes take at least max(xors / 64, operations / 128) SM clocks;
# the issue term binds.  crush_ln, the compare and the quotient are left
# out.  The hashes are the plain version's ``work`` counts for the same
# inputs.
HASH32_3_OPS, HASH32_3_XORS = 136, 46
HASH32_2_OPS, HASH32_2_XORS = 82, 28
ALU_LANES_PER_SM_CLOCK = 64
ISSUE_LANES_PER_SM_CLOCK = 128

K, M = 8, 4
N_OBJECTS, OBJECT_BYTES = 64, 4 << 20
SEED = 20261017
CRUSH_N = 1_000_000             # inputs per rule (the bench's CRUSH stage)
CRUSH_HOSTS, CRUSH_PER_HOST = 128, 8
SAMPLE = 4096                   # spread sample held against host and scalar


class SmokeFailure(Exception):
    pass


def hash_sm_clocks(ops, xors) -> float:
    """The least SM clocks ``ops`` hash operations take, ``xors`` of
    them on the ALU pipe alone and the rest on either integer pipe."""
    return max(xors / ALU_LANES_PER_SM_CLOCK, ops / ISSUE_LANES_PER_SM_CLOCK)


def crush_ops_ms(work) -> float:
    """The least time the card takes for the hashes a CRUSH kernel's
    inputs need: ``work`` is the plain version's count of straw2 draws,
    perm-choose hashes and is_out hashes."""
    h3 = work.get("straw2_draws", 0) + work.get("perm_hashes", 0)
    h2 = work.get("is_out_hashes", 0)
    return hash_sm_clocks(HASH32_3_OPS * h3 + HASH32_2_OPS * h2,
                          HASH32_3_XORS * h3 + HASH32_2_XORS * h2
                          ) / SM_CLOCKS_PER_S * 1e3


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def median_ms(torch, fn, reps, flush=None):
    """Median CUDA-event time of fn() over reps runs, after two warm-ups;
    with ``flush`` (a large device buffer), L2 is evicted before each.
    Either way the launch queues behind device work, so the events do not
    time the host's launch."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()        # evicts L2; the launch queues behind it
        else:
            torch.cuda._sleep(200_000)      # about 0.1 ms of spinning
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def check_variants(torch, np, gf256, kernel, dev, rng, cases):
    """Every TUNE_SPACE variant of the apply, and the checksum probe,
    against the plain versions at phase 2's shapes; the probe also on a
    sum that wraps.  Returns the probe's mismatch count (0)."""
    t0 = time.perf_counter()
    k2_bad = 0
    for label, mat, L in cases:
        ops = kernel.from_reference_matrix(mat, dev)
        data = torch.from_numpy(
            rng.integers(0, 256, (mat.shape[1], L), dtype=np.uint8)).to(dev)
        want = kernel.gf_apply_plain(ops.bitmat, data)
        want_sum = int(kernel.gf_apply_checksum_plain(ops.bitmat, data))
        for cfg in kernel.TUNE_SPACE:
            got = kernel.gf_apply(ops, data, config=cfg)
            bad = int((got != want).sum().item())
            check(bad == 0, f"variant {cfg} on {label}: {bad} bytes differ")
            got_sum = int(kernel.gf_apply_checksum(ops, data, config=cfg))
            k2_bad += got_sum != want_sum
            check(got_sum == want_sum, f"checksum {cfg} on {label}: "
                                       f"{got_sum} != {want_sum}")
    # windows of wider buffers, as the batch queue passes them, written
    # into a window of a wider output: 16-byte aligned strided rows (the
    # 16-byte path), rows at an odd offset and rows at an odd stride (the
    # byte path)
    enc = gf256.rs_vandermonde_matrix(K, M)[K:]
    ops = kernel.from_reference_matrix(enc, dev)
    for ld, start, width in ((100000, 16, 65536), (100000, 3, 50001),
                             (100003, 0, 40000)):
        big = torch.from_numpy(
            rng.integers(0, 256, (K, ld), dtype=np.uint8)).to(dev)
        seg = big[:, start:start + width]
        want = kernel.gf_apply_plain(ops.bitmat, seg)
        want_sum = int(kernel.gf_apply_checksum_plain(ops.bitmat, seg))
        for cfg in kernel.TUNE_SPACE:
            wide = torch.full((M, ld), 7, dtype=torch.uint8, device=dev)
            kernel.gf_apply(ops, seg, out=wide[:, start:start + width],
                            config=cfg)
            bad = (int((wide[:, start:start + width] != want).sum())
                   + int((wide[:, :start] != 7).sum())
                   + int((wide[:, start + width:] != 7).sum()))
            check(bad == 0, f"variant {cfg} on the window [{start}, "
                            f"{start + width}) of rows {ld} wide: {bad} "
                            f"bytes differ")
            got_sum = int(kernel.gf_apply_checksum(ops, seg, config=cfg))
            k2_bad += got_sum != want_sum
            check(got_sum == want_sum, f"checksum {cfg} on the window "
                                       f"[{start}, {start + width}) of rows "
                                       f"{ld} wide: {got_sum} != {want_sum}")
    # four unit rows copy 4 x 2.2 Mi bytes >= 0xF0: the sum passes 2^31
    ops = kernel.from_reference_matrix(np.eye(4, dtype=np.uint8), dev)
    data = torch.from_numpy(rng.integers(0xF0, 0x100, (4, 2_200_003),
                                         dtype=np.uint8)).to(dev)
    exact = int(data.to(torch.int64).sum())
    wrapped = (exact + 2**31) % 2**32 - 2**31
    check(exact > 2**31 and wrapped < 0, "the wrap case does not wrap")
    for cfg in kernel.TUNE_SPACE:
        got = int(kernel.gf_apply_checksum(ops, data, config=cfg))
        k2_bad += got != wrapped
        check(got == wrapped, f"checksum {cfg} wrap: {got} != {wrapped}")
    check(int(kernel.gf_apply_checksum_plain(ops.bitmat, data)) == wrapped,
          "plain checksum does not wrap")
    print(f"phase variants: {len(kernel.TUNE_SPACE)} variants x "
          f"({len(cases)} cases + 3 windows) bit-exact, checksum equal to "
          f"the plain wrapped sum (wrap case {exact} -> {wrapped}) "
          f"({time.perf_counter() - t0:.3f} s)")
    return k2_bad


def tuner_path(torch, np, gf256, kernel, dev, smi):
    """The JAX package's bench tpu_ec sequence on the port; returns the
    probe's launches on this path."""
    gen = gf256.rs_vandermonde_matrix(K, M)
    present = [1, 2, 4, 5, 6, 7, 8, 9]
    dec = gf256.decode_matrix(gen, present, [0, 3])
    folded = np.random.default_rng(0).integers(
        0, 256, (K, 32 * (1 << 17)), dtype=np.uint8)
    surv = np.concatenate([folded, gf256.host_apply(gen[K:], folded)])
    surv = np.ascontiguousarray(surv[present])
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(7)

    def apply_rate(mat, host_in):
        """MB/s of input by the slope between 64 MiB and 256 MiB probes
        (best of 5 each, installed variant), and the output for host_in."""
        ops = kernel.from_reference_matrix(mat, dev)
        cfg = kernel._resolve_fused_config(ops.mat.shape)
        k = mat.shape[1]
        sizes, times = (1 << 26, 1 << 28), []
        for nbytes in sizes:
            d = torch.randint(0, 256, (k, nbytes // k), dtype=torch.uint8,
                              device=dev, generator=gen_t)
            int(kernel.gf_apply_checksum(ops, d))
            times.append(min(kernel._probe_seconds(ops, d, cfg)
                             for _ in range(5)))
            del d
        rate = (sizes[1] - sizes[0]) / (times[1] - times[0]) / 1e6
        out = kernel.gf_apply(ops, torch.from_numpy(host_in).to(dev))
        return rate, out.cpu().numpy(), cfg, times

    kernel.gf_apply_checksum_launches = 0
    t0 = time.perf_counter()
    tuned = kernel.autotune(gen[K:], length=1 << 24, trials=2,
                            budget_s=120, device=dev)
    print(f"phase tuner: encode winner {tuned} ({time.perf_counter() - t0:.3f}"
          f" s); card {smi}")
    t0 = time.perf_counter()
    dec_tuned = kernel.autotune(dec, length=1 << 24, trials=2, budget_s=60,
                                install="shape", device=dev)
    print(f"phase tuner: decode winner {dec_tuned} "
          f"({time.perf_counter() - t0:.3f} s); card {smi}")
    enc_rate, got, enc_cfg, enc_t = apply_rate(gen[K:], folded)
    check(np.array_equal(got[:, :65536],
                         gf256.host_apply(gen[K:], folded[:, :65536])),
          "tuned encode != numpy host apply")
    dec_rate, got, dec_cfg, dec_t = apply_rate(dec, surv)
    check(np.array_equal(got[:, :65536], folded[[0, 3]][:, :65536]),
          "tuned decode != the lost chunks")
    launches = kernel.gf_apply_checksum_launches
    check(launches > 0, "the tuner path launched no probe")
    print(f"phase tuner: encode {enc_rate:,.1f} MB/s with {enc_cfg} "
          f"(64 MiB {enc_t[0] * 1e3:.4f} ms, 256 MiB {enc_t[1] * 1e3:.4f} "
          f"ms), decode {dec_rate:,.1f} MB/s with {dec_cfg} (64 MiB "
          f"{dec_t[0] * 1e3:.4f} ms, 256 MiB {dec_t[1] * 1e3:.4f} ms); "
          f"bit-exact against the host; probe launches {launches}; "
          f"card {smi}")
    return launches


def _scalar_rows(job):
    """Worker: the scalar mapper over a slice of the sample (runs in a
    spawned process; imports the port's CRUSH host layer only)."""
    map_bytes, ruleno, size, weights, xs = job
    from ceph_tpu_torch.crush.mapper import do_rule
    from ceph_tpu_torch.crush.types import CrushMap
    m = CrushMap.from_bytes(map_bytes)
    return [do_rule(m, ruleno, int(x), size, weights) for x in xs]


def _rows(osds, counts):
    if counts is None:
        return [list(map(int, r)) for r in osds]
    return [list(map(int, r[:c])) for r, c in zip(osds, counts)]


def crush_maps():
    """The bench's CRUSH contract: 1024 OSDs as 128 hosts x 8 with a
    replicated firstn x3 and an EC indep x6 rule, and the same OSDs
    behind 16 racks with a firstn x3 rule; a few OSDs out or at 0x8000."""
    from ceph_tpu_torch.crush.builder import (build_hierarchy,
                                              make_erasure_rule,
                                              make_replicated_rule)
    from ceph_tpu_torch.crush.types import CrushMap
    n = CRUSH_HOSTS * CRUSH_PER_HOST
    m = CrushMap()
    m.max_devices = n
    build_hierarchy(m, n, CRUSH_PER_HOST)
    rep = make_replicated_rule(m, "rep")
    ec = make_erasure_rule(m, "ec", size=6)
    m3 = CrushMap()
    m3.max_devices = n
    build_hierarchy(m3, n, CRUSH_PER_HOST, hosts_per_rack=8)
    rep3 = make_replicated_rule(m3, "rep3")
    w = [0x10000] * n
    for o in (3, 77, 500, 901):
        w[o] = 0
    for o in (10, 300, 640, 1000):
        w[o] = 0x8000
    return [("firstn x3, 2-level", m, rep, 3),
            ("indep x6, 2-level", m, ec, 6),
            ("firstn x3, 3-level", m3, rep3, 3)], w


def _share(bound_ms, ms):
    return f"{bound_ms / ms * 100:.1f}% of bound"


def _variant_line(rows):
    """'4 9.1 ms, 8 ...' from a crush_times row: ms per lane variant."""
    return ", ".join(f"{k} {v:.4f} ms" for k, v in rows["ms"].items())


def crush_path(torch, np, dev, smi):
    from ceph_tpu_torch.ops import crush_kernel as ck
    from crush_probe import crush_times
    rules, w = crush_maps()
    xs = np.arange(CRUSH_N, dtype=np.int64)
    pick = np.linspace(0, CRUSH_N - 1, SAMPLE).astype(np.int64)
    workers = min(8, os.cpu_count() or 1)
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    slots = ck.thread_slots(dev)
    with pool:
        scalar = []
        for _, m, rule, size in rules:
            raw = m.to_bytes()
            scalar.append([pool.submit(_scalar_rows,
                                       (raw, rule, size, w, part.tolist()))
                           for part in np.array_split(xs[pick], workers)])

        # the main path: every rule's 1M inputs through the device engine
        for _, m, rule, size in rules:
            ck.warmup(m, rule, size, w, dev)
        ck.crush_map_launches = 0
        results, walls = [], []
        for _, m, rule, size in rules:
            t0 = time.perf_counter()
            results.append(ck.batch_do_rule_arrays(m, rule, xs, size, w,
                                                   engine="device",
                                                   device=dev))
            walls.append(time.perf_counter() - t0)
        map_launches = ck.crush_map_launches
        check(map_launches == len(rules),
              f"crush_map launched {map_launches} times for {len(rules)} "
              f"rules")

        out = {"map_launches": map_launches, "rules": []}
        total = {"bad": 0, "err": 0, "ms": 0.0, "plain_ms": 0.0,
                 "ops_ms": 0.0, "bytes": 0}
        xs_d = torch.from_numpy(xs).to(dev)
        osd_w = torch.tensor(w, dtype=torch.int64, device=dev)
        for (name, m, rule, size), (osds, counts), wall in zip(
                rules, results, walls):
            seg = ck.compile_rule(m, rule).segments[0]
            eng = ck._device_engine(seg, w, dev)
            wts = eng.weights(seg)
            lanes = ck.choose_lanes(CRUSH_N, slots, eng.straw2_widths)

            def kern():
                return ck.crush_map(eng, xs_d, size, size, wts, osd_w)
            packed = kern()
            ms = median_ms(torch, kern, 5)
            work = {}
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            plain = ck.crush_map_plain(eng, xs_d, size, size, wts, osd_w,
                                       work)
            e1.record()
            torch.cuda.synchronize()
            plain_ms = e0.elapsed_time(e1)
            diff = (packed.to(torch.int64) - plain.to(torch.int64)).abs()
            bad = int((diff != 0).any(dim=1).sum())
            err = int(diff.max())
            host = packed.cpu().numpy()
            check(np.array_equal(host[:, :size], osds)
                  and (counts is None or np.array_equal(host[:, size],
                                                        counts)),
                  f"{name}: the main path's result differs from a "
                  f"direct launch")
            check(bad == 0, f"{name}: {bad} of {CRUSH_N} rows differ from "
                            f"the plain version")
            # every lane variant, held against the plain version and timed
            variants = crush_times(torch, [{
                "name": name, "eng": eng, "xs": xs_d, "numrep": size,
                "out_size": size, "weights": wts, "osd_w": osd_w,
                "want": plain}], reps=5)[0]
            h_osds, h_counts = ck.batch_do_rule_arrays(
                m, rule, xs[pick], size, w, engine="host")
            sub_counts = None if counts is None else counts[pick]
            check(_rows(osds[pick], sub_counts) == _rows(h_osds, h_counts),
                  f"{name}: the sample differs from the numpy host engine")
            nbytes = CRUSH_N * (8 + 4 * packed.shape[1])
            ops_ms = crush_ops_ms(work)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            rule_out = {"rule": name, "lanes": lanes, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "share": bound_ms / ms,
                        "bound_by": ("operations" if ops_ms >= bytes_ms
                                     else "bytes"),
                        "variants_ms": variants["ms"],
                        "main_path_s": wall, "work": work}
            out["rules"].append(rule_out)
            total["bad"] += bad
            total["err"] = max(total["err"], err)
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["ops_ms"] += ops_ms
            total["bytes"] += nbytes
            print(f"phase crush {name}: {CRUSH_N} inputs, main path "
                  f"{wall:.4f} s ({CRUSH_N / wall:,.0f} mappings/s incl. "
                  f"copies); kernel ({lanes} lanes per input) {ms:.4f} ms "
                  f"({CRUSH_N / ms * 1e3:,.0f} mappings/s), plain "
                  f"{plain_ms:.4f} ms ({CRUSH_N / plain_ms * 1e3:,.0f} "
                  f"mappings/s); work {work}; bound {bound_ms:.4f} ms "
                  f"(hash operations {ops_ms:.4f}, bytes {bytes_ms:.4f}), "
                  f"{_share(bound_ms, ms)}; every lane variant: "
                  f"{_variant_line(variants)}; all rows of every variant "
                  f"equal the plain version, the sample the host engine; "
                  f"card {smi}")
        for (name, m, rule, size), (osds, counts), futs in zip(
                rules, results, scalar):
            want = [row for f in futs for row in f.result()]
            sub_counts = None if counts is None else counts[pick]
            check(_rows(osds[pick], sub_counts) == want,
                  f"{name}: the sample differs from the scalar mapper")
        print(f"phase crush: {SAMPLE}-input spread samples of all "
              f"{len(rules)} rules equal the scalar mapper "
              f"({workers} processes)")
    out.update(map_mismatches=total["bad"], map_max_abs_err=total["err"],
               map_ms=total["ms"], map_plain_ms=total["plain_ms"])
    bytes_ms = total["bytes"] / HBM_BYTES_PER_S * 1e3
    out["map_bound_ms"] = max(total["ops_ms"], bytes_ms)
    out["map_bound_by"] = ("operations" if total["ops_ms"] >= bytes_ms
                           else "bytes")

    # the straw2 winner grid of the 128-host root
    m = rules[0][1]
    root = m.bucket(m.rules[rules[0][2]].steps[0].arg1)
    X, R = 65536, 6
    wx = np.random.default_rng(SEED).integers(0, 2**32, X, dtype=np.int64)
    ck.crush_straw2_winners_launches = 0
    grid = ck.straw2_winners(root.items, root.item_weights, wx,
                             np.arange(R), device=dev)
    win_launches = ck.crush_straw2_winners_launches
    check(win_launches == 1, f"straw2_winners launched {win_launches}")

    def t(a):
        return torch.tensor(a, dtype=torch.int64, device=dev)
    items, wts, xd, rd = (t(root.items), t(root.item_weights),
                          torch.from_numpy(wx).to(dev), t(list(range(R))))
    ms = median_ms(torch,
                   lambda: ck.crush_straw2_winners(items, wts, xd, rd), 11)
    work = {}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    plain = ck.straw2_winners_plain(items, wts, xd, rd, work)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    diff = (torch.from_numpy(grid).to(dev) - plain).abs()
    bad = int((diff != 0).sum())
    check(bad == 0, f"straw2 winners: {bad} entries differ from plain")
    ops_ms = crush_ops_ms(work)
    bytes_ms = (X * 8 + R * 8 + 2 * 8 * len(root.items)
                + X * R * 8) / HBM_BYTES_PER_S * 1e3
    out.update(win_launches=win_launches, win_mismatches=bad,
               win_max_abs_err=int(diff.max()), win_ms=ms,
               win_plain_ms=plain_ms, win_bound_ms=max(ops_ms, bytes_ms),
               win_bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               win_shape=f"items [{len(root.items)}], xs [{X}], rs [{R}] "
                         f"-> [{X}, {R}] int64")
    print(f"phase crush straw2_winners [{X}, {R}] over {len(root.items)} "
          f"items: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{max(ops_ms, bytes_ms):.4f} ms (hash operations {ops_ms:.4f}, "
          f"bytes {bytes_ms:.4f}), {_share(max(ops_ms, bytes_ms), ms)}; "
          f"equal to the plain version; card {smi}")
    return out


def build_osdmap():
    """An OSDMap on the CRUSH phase's 1024 OSDs with a replicated pool
    (size 3, pg_num 32768) and an EC k=4 m=2 pool (pg_num 16384): about
    100 PGs per OSD over the pool size, rounded to a power of two.  Then
    four OSDs out, four at 0x8000 and three down."""
    from ceph_tpu_torch.crush.builder import (build_hierarchy,
                                              make_erasure_rule,
                                              make_replicated_rule)
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.msg.types import EntityAddr
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
    from ceph_tpu_torch.osd.types import (OSD_UP, POOL_TYPE_ERASURE,
                                          POOL_TYPE_REPLICATED, PGPool)
    n = CRUSH_HOSTS * CRUSH_PER_HOST
    crush = CrushMap()
    crush.max_devices = n
    build_hierarchy(crush, n, CRUSH_PER_HOST)
    rep = make_replicated_rule(crush, "replicated_rule")
    ec = make_erasure_rule(crush, "ec_rule", size=6)
    m = OSDMap()
    m.fsid = "chip-smoke"
    m.crush = crush
    m.set_max_osd(n)
    inc = Incremental(1)
    for o in range(n):
        inc.new_up[o] = EntityAddr(f"10.0.{o // 256}.{o % 256}", 6800, o + 1)
        inc.new_weight[o] = 0x10000
    inc.new_pools[1] = PGPool(POOL_TYPE_REPLICATED, size=3,
                              crush_ruleset=rep, pg_num=32768)
    inc.new_pool_names[1] = "rbd"
    inc.new_pools[2] = PGPool(POOL_TYPE_ERASURE, size=6, min_size=5,
                              crush_ruleset=ec, pg_num=16384,
                              ec_profile="k4m2")
    inc.new_pool_names[2] = "ec42"
    m.apply_incremental(inc)
    inc = Incremental(2)
    for o in (3, 77, 500, 901):
        inc.new_weight[o] = 0
    for o in (10, 300, 640, 1000):
        inc.new_weight[o] = 0x8000
    for o in (42, 613, 777):
        inc.new_state[o] = OSD_UP
    m.apply_incremental(inc)
    return m


def osdmap_path(torch, np, dev, smi):
    from ceph_tpu_torch.crush.constants import CRUSH_ITEM_NONE
    from ceph_tpu_torch.ops import crush_kernel as ck
    from crush_probe import crush_times
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.tools import osdmaptool
    m = build_osdmap()
    for pid in m.pools:
        m.warmup_placement(pid, dev)
    ck.crush_map_launches = 0
    got, walls = {}, {}
    for pid in sorted(m.pools):
        t0 = time.perf_counter()
        got[pid] = m.map_pgs_batch(pid, "device", dev)
        walls[pid] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "osdmap.bin")
        with open(path, "wb") as f:
            f.write(m.to_bytes())
        reports = {}
        # the tool's default engine is the device descent
        for engine, extra in (("device", []), ("host", ["--engine",
                                                        "host"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = osdmaptool.main([path, "--test-map-pgs", "--json",
                                      "--device", str(dev), *extra])
            check(rc == 0, f"osdmaptool --engine {engine} exit {rc}")
            reports[engine] = json.loads(buf.getvalue())
            if engine == "device":
                launches = ck.crush_map_launches
        check(OSDMap.from_bytes(m.to_bytes()).to_bytes() == m.to_bytes(),
              "the map does not re-encode to the same bytes")
    check(launches == 2 * len(m.pools),
          f"the OSDMap path launched crush_map {launches} times")
    for pid in sorted(m.pools):
        want = m.map_pgs_batch(pid, "host")
        check(got[pid] == want, f"pool {pid}: device placements differ "
                                f"from the host engine's")
    holes = sum(CRUSH_ITEM_NONE in up for _, up, *_ in got[2])
    outs = {3, 77, 500, 901}
    check(not any(o in outs for pid in got for _, up, *_ in got[pid]
                  for o in up), "an out OSD holds a placement")
    check(holes > 0, "no EC up set has a hole for a down OSD")
    for engine, rep in reports.items():
        print(f"phase osdmap osdmaptool --test-map-pgs --engine {engine}: "
              f"{rep['total_pgs']} pgs in {rep['seconds']} s "
              f"({rep['mappings_per_sec']} pg/s), pgs per osd "
              f"{rep['pg_per_osd']}; card {smi}")
    strip = [{k: v for k, v in r.items()
              if k not in ("seconds", "mappings_per_sec")}
             for r in reports.values()]
    check(strip[0] == strip[1], "osdmaptool reports differ between device "
                                "and host")
    print(f"phase osdmap: both pools equal on device and host; {holes} EC "
          f"up sets with holes; crush_map launches {launches}")

    # where map_pgs_batch's time goes: pps, the CRUSH call, the per-pg
    # finish; and the descent kernel alone at the pool's size (these
    # launches come after the count was read)
    osd_w = torch.tensor(m.osd_weight, dtype=torch.int64, device=dev)
    slots = ck.thread_slots(dev)
    pools = []
    for pid in sorted(m.pools):
        pool = m.pools[pid]
        pgs = m.pg_ids(pid)
        t0 = time.perf_counter()
        pps = [pool.raw_pg_to_pps(pg) for pg in pgs]
        t1 = time.perf_counter()
        ruleno = m.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
        raws = ck.batch_do_rule(m.crush, ruleno, pps, pool.size,
                                m.osd_weight, "device", dev)
        t2 = time.perf_counter()
        for pg, raw in zip(pgs, raws):
            m._finish_mapping(pool, pg, raw)
        t3 = time.perf_counter()
        seg = ck.compile_rule(m.crush, ruleno).segments[0]
        numrep, out_size = ck._seg_numrep(seg, pool.size)
        eng = ck._device_engine(seg, m.osd_weight, dev)
        wts = eng.weights(seg)
        xs_d = torch.tensor(pps, dtype=torch.int64, device=dev)
        lanes = ck.choose_lanes(len(pps), slots, eng.straw2_widths)
        k_ms = median_ms(torch, lambda: ck.crush_map(
            eng, xs_d, numrep, out_size, wts, osd_w), 21)
        # the bound at the pool's size, counted as at 1M inputs: the
        # hashes the plain version needs for these inputs
        work = {}
        plain = ck.crush_map_plain(eng, xs_d, numrep, out_size, wts, osd_w,
                                   work)
        packed = ck.crush_map(eng, xs_d, numrep, out_size, wts, osd_w)
        check(torch.equal(packed.to(torch.int64), plain.to(torch.int64)),
              f"pool {pid}: the descent differs from its plain version")
        variants = crush_times(torch, [{
            "name": m.pool_names[pid], "eng": eng, "xs": xs_d,
            "numrep": numrep, "out_size": out_size, "weights": wts,
            "osd_w": osd_w, "want": plain}], reps=11)[0]
        ops_ms = crush_ops_ms(work)
        bytes_ms = len(pps) * (8 + 4 * packed.shape[1]) / HBM_BYTES_PER_S * 1e3
        b_ms = max(ops_ms, bytes_ms)
        pools.append({"pool": m.pool_names[pid], "pgs": len(pps),
                      "lanes": lanes, "ms": k_ms, "bound_ms": b_ms,
                      "share": b_ms / k_ms,
                      "bound_by": ("operations" if ops_ms >= bytes_ms
                                   else "bytes"),
                      "variants_ms": variants["ms"], "work": work})
        print(f"phase osdmap map_pgs_batch pool {pid} "
              f"({m.pool_names[pid]}, {pool.pg_num} pgs): {walls[pid]:.4f} "
              f"s; again in steps: pps {t1 - t0:.4f} s, batch_do_rule "
              f"{t2 - t1:.4f} s, per-pg finish {t3 - t2:.4f} s; crush_map "
              f"kernel alone [{len(pps)}] -> [{len(pps)}, "
              f"{numrep + (1 if seg.firstn else 0)}] ({lanes} lanes per "
              f"input) {k_ms:.4f} ms, equal to the plain version; work "
              f"{work}; bound {b_ms:.4f} ms (hash operations {ops_ms:.4f}, "
              f"bytes {bytes_ms:.4f}), {_share(b_ms, k_ms)}; every lane "
              f"variant, each equal to the plain version: "
              f"{_variant_line(variants)}; card {smi}")
    return launches, pools


def _host_cpu():
    """The host CPU's vendor, family, model and model name (the first
    processor's lines; a virtual machine may hide the name)."""
    keys = ("vendor_id", "cpu family", "model", "model name")
    seen = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key.strip() in keys:
                    seen.setdefault(key.strip(), val.strip())
                if not line.strip():
                    break
    except OSError:
        pass
    return " ".join(f"{k} {seen.get(k, '?')}" for k in keys)


def native_phase(np, dev, smi, sizes=(16, 64, 256, 1024, 4096),
                 draw_inputs=65536):
    """The native host library on the card's host: it must be built;
    gf_matrix_apply against the numpy host apply at the queue's host
    threshold, straw2_winner_rows and _shared against the numpy draw on
    the 128-host root; then the queue's host path and the CRUSH host
    engine, native against numpy alone.  Host times, not device times."""
    from crush_probe import _median_s, host_engine_rows
    from ceph_tpu_torch import native
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.ec import gf256
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
    check(native.available(), f"the native host library did not build: "
                              f"{native.build_info['error']}")
    simd = native.gf_simd_available()
    with open("/proc/self/maps") as f:
        omp = sorted({line.split()[-1] for line in f if "gomp" in line})
    print(f"phase native: library {os.path.basename(native.build_info['path'])}"
          f" (g++ {native.build_info['seconds']:.3f} s, 0 when an earlier "
          f"build was loaded); GFNI/AVX-512 {simd}; host CPU "
          f"{_host_cpu()!r}, {os.cpu_count()} cores; OpenMP runtimes "
          f"mapped: {omp}")
    rng = np.random.default_rng(SEED + 1)
    mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
    chunks = rng.integers(0, 256, (8, 65536), dtype=np.uint8)
    want = gf256.host_apply(mat, chunks)
    check(np.array_equal(native.gf_matrix_apply(mat, chunks), want),
          "native gf_matrix_apply differs from gf256.host_apply")
    check(np.array_equal(native.gf_matrix_apply(mat, chunks,
                                                force_scalar=True), want),
          "native scalar gf_matrix_apply differs from gf256.host_apply")
    rules, _ = crush_maps()
    m = rules[0][1]
    root = m.bucket(m.rules[rules[0][2]].steps[0].arg1)
    items = np.asarray(root.items, np.int64)
    weights = np.asarray(root.item_weights, np.int64)
    weights[5] = 0
    xs = rng.integers(0, 2**32, draw_inputs, dtype=np.int64)
    rs = rng.integers(0, 6, draw_inputs, dtype=np.int64)
    saved = ck._native_mod
    ck._native_mod = False
    try:
        t0 = time.perf_counter()
        want = ck._straw2_draw(items, weights, xs, rs)
        numpy_s = time.perf_counter() - t0
    finally:
        ck._native_mod = saved
    ln = ck._ln()
    rows_i = np.broadcast_to(items, (draw_inputs, items.size))
    rows_w = np.broadcast_to(weights, (draw_inputs, items.size))
    t0 = time.perf_counter()
    got_rows = native.straw2_winner_rows(rows_i, rows_w, xs, rs, ln)
    rows_s = time.perf_counter() - t0
    got_shared = native.straw2_winner_shared(items, weights, xs, rs, ln)
    check(np.array_equal(got_rows, want) and np.array_equal(got_shared, want),
          "native straw2 winners differ from the numpy draw")
    print(f"phase native: gf_matrix_apply [4, 8] x [8, 65536] equal to "
          f"gf256.host_apply (SIMD and scalar); straw2_winner_rows and "
          f"_shared over the {items.size}-host root at {draw_inputs} inputs "
          f"equal the numpy draw (rows {rows_s * 1e3:.3f} ms, numpy "
          f"{numpy_s * 1e3:.3f} ms, host clock)")
    q = ECBatchQueue(Context("osd.0"), mode="off", device=dev)
    out = {"gfni_avx512": simd, "host_cpu": _host_cpu(),
           "build_s": native.build_info["seconds"], "queue_host": []}
    try:
        for nbytes in (16 << 10, 64 << 10):
            c = rng.integers(0, 256, (8, nbytes // 8), dtype=np.uint8)
            check(np.array_equal(q._host_apply(mat, c, nbytes),
                                 gf256.host_apply(mat, c)),
                  "the queue's host path differs from gf256.host_apply")
            nat_ms = _median_s(lambda: q._host_apply(mat, c, nbytes)) * 1e3
            np_ms = _median_s(lambda: gf256.host_apply(mat, c)) * 1e3
            out["queue_host"].append({"bytes": nbytes, "native_ms": nat_ms,
                                      "numpy_ms": np_ms})
            print(f"phase native: the queue's host path, RS k=8 m=4, "
                  f"{nbytes >> 10} KiB request: native {nat_ms:.4f} ms "
                  f"({nbytes / nat_ms / 1e6:.3f} GB/s), numpy "
                  f"{np_ms:.4f} ms ({nbytes / np_ms / 1e6:.3f} GB/s); "
                  f"host clock, host of card {smi}")
    finally:
        asyncio.run(q.stop())
    out["crush_host"] = host_engine_rows(
        sizes, plain=False, log=lambda line: print(
            f"phase native: CRUSH host engine {line} (host clock, host of "
            f"card {smi})"))
    return out


def _max_repair(np, plugin, prof, n, k):
    """The largest number of lost chunks some pattern of ``prof`` still
    repairs, and that pattern with the most data chunks lost (the first
    in order), found on a small object with the CPU codec."""
    from ceph_tpu_torch.ec import ErasureCodeError, factory
    import itertools
    codec = factory(plugin, prof, device="cpu")
    small = codec.encode(set(range(n)), bytes(range(256)) * k)
    for t in range(n, 0, -1):
        best = None
        for lost in itertools.combinations(range(n), t):
            try:
                codec.decode(set(lost), {i: c for i, c in small.items()
                                         if i not in lost})
            except ErasureCodeError:
                continue
            data_lost = sum(i < k for i in lost)
            if best is None or data_lost > best[0]:
                best = (data_lost, set(lost))
        if best is not None:
            return best[1]
    raise SmokeFailure(f"{plugin} {prof}: no pattern repairs")


LRC_SHEC = (("lrc", "k=4 m=2 l=3", {"k": "4", "m": "2", "l": "3"}),
            ("shec", "k=4 m=3 c=2", {"k": "4", "m": "3", "c": "2"}))


def lrc_shec_phase(np, kernel, dev, smi, objects):
    """Ceph's documented LRC and SHEC profiles on the card: every object
    through encode, then decode with one data chunk lost (for LRC from
    its local group alone, fewer than k chunks), then with the most
    losses each profile repairs; every chunk bit-exact against the same
    codec on the CPU; the apply kernel's launches counted per step."""
    from ceph_tpu_torch.ec import factory
    total = sum(len(o) for o in objects)
    out = {}
    for plugin, label, prof in LRC_SHEC:
        card = factory(plugin, prof, device=dev)
        cpu = factory(plugin, prof, device="cpu")
        k, n = card.k, card.get_chunk_count()
        everyone = set(range(n))
        local = card.minimum_to_decode({0}, everyone - {0})
        worst = _max_repair(np, plugin, prof, n, k)
        steps, launches, walls = {}, {}, {}
        kernel.gf_apply_launches = 0
        t0 = time.perf_counter()
        steps["encode"] = [card.encode(everyone, o) for o in objects]
        walls["encode"] = time.perf_counter() - t0
        launches["encode"] = kernel.gf_apply_launches
        cases = {"decode 1 data lost": ({0}, lambda ch: {
                     i: ch[i] for i in local}),
                 f"decode {len(worst)} lost {sorted(worst)}": (worst,
                     lambda ch: {i: c for i, c in ch.items()
                                 if i not in worst})}
        for name, (lost, have) in cases.items():
            kernel.gf_apply_launches = 0
            t0 = time.perf_counter()
            steps[name] = [card.decode(lost, have(ch))
                           for ch in steps["encode"]]
            walls[name] = time.perf_counter() - t0
            launches[name] = kernel.gf_apply_launches
        for name in steps:
            check(launches[name] > 0, f"{plugin} {name}: no gf_apply launch")
        # the plain version: the same codec on the CPU, chunk for chunk
        t0 = time.perf_counter()
        for o, ch in zip(objects, steps["encode"]):
            want = cpu.encode(everyone, o)
            check(all(np.array_equal(ch[i], want[i]) for i in everyone),
                  f"{plugin}: a card chunk differs from the CPU codec's")
        for name, (lost, have) in cases.items():
            for ch, got in zip(steps["encode"], steps[name]):
                want = cpu.decode(lost, have(ch))
                check(all(np.array_equal(got[i], want[i])
                          and np.array_equal(got[i], ch[i]) for i in lost),
                      f"{plugin} {name}: a rebuilt chunk differs from the "
                      f"CPU codec's or the original")
        cpu_s = time.perf_counter() - t0
        check(plugin != "lrc" or len(local) < k,
              f"lrc local repair reads {len(local)} chunks, not fewer "
              f"than k={k}")
        for name in steps:
            print(f"phase {plugin} {label}: {name}: {len(objects)} x "
                  f"{len(objects[0]) >> 20} MiB objects in "
                  f"{walls[name]:.4f} s ({total / walls[name] / 1e9:.3f} "
                  f"GB/s of object data), gf_apply launches "
                  f"{launches[name]}; card {smi}")
        print(f"phase {plugin} {label}: every chunk equals the CPU codec's "
              f"(checked in {cpu_s:.1f} s); one lost data chunk read "
              f"{sorted(local)} ({len(local)} chunks, k={k}); the most "
              f"losses repaired: {len(worst)}")
        out[plugin] = {"launches": launches, "walls": walls,
                       "local_read": sorted(local), "worst": sorted(worst)}
    return out


def narrow_k1_times(torch, np, kernel, dev, smi, flush, L=1 << 20):
    """gf_apply at the matrices shec and LRC launch for a 4 MiB object
    (k=4: 1 MiB chunks), L2 flushed, beside the bytes bound."""
    from ceph_tpu_torch.ec import factory
    shec = factory("shec", LRC_SHEC[1][2], device="cpu")
    lrc = factory("lrc", LRC_SHEC[0][2], device="cpu")
    mats = [("shec encode", shec.generator[shec.k:])]
    mats += [(f"lrc layer {i} ({'global' if i == 0 else 'local'})",
              layer.codec.generator[layer.codec.k:])
             for i, layer in enumerate(lrc.layers)]
    rows = []
    for label, mat in mats:
        r, k = mat.shape
        ops = kernel.from_reference_matrix(mat, dev)
        data = torch.from_numpy(np.random.default_rng(r * 7 + k).integers(
            0, 256, (k, L), dtype=np.uint8)).to(dev)
        check(torch.equal(kernel.gf_apply(ops, data),
                          kernel.gf_apply_plain(ops.bitmat, data)),
              f"gf_apply at {label} differs from the plain version")
        ms = median_ms(torch, lambda: kernel.gf_apply(ops, data), 25, flush)
        b_ms = (k + r) * L / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": label, "k": k, "r": r, "L": L, "ms": ms,
                     "bound_ms": b_ms, "share": b_ms / ms})
        print(f"phase timing: gf_apply at {label} [{k}, {L}] -> [{r}, {L}]"
              f": {ms:.4f} ms, bytes bound {b_ms:.4f} ms, "
              f"{b_ms / ms * 100:.1f}% of it; equal to the plain version; "
              f"card {smi}")
    return rows


def crushtool_phase(np, dev, smi, n_inputs=CRUSH_N, window=65536):
    """crushtool on phase 7's 1024-OSD map: -d, then -c back to equal
    bytes; --test over n_inputs on the default (device) engine; on a
    window of inputs, the device report equal to the host engine's."""
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.tools import crushtool
    rules, _ = crush_maps()
    m = rules[0][1]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "crushmap.bin")
        with open(path, "wb") as f:
            f.write(m.to_bytes())
        txt, back = os.path.join(tmp, "map.txt"), os.path.join(tmp, "b.bin")
        with contextlib.redirect_stdout(io.StringIO()):
            check(crushtool.main(["-d", path, "-o", txt]) == 0,
                  "crushtool -d failed")
            check(crushtool.main(["-c", txt, "-o", back]) == 0,
                  "crushtool -c failed")
        with open(back, "rb") as f:
            check(f.read() == m.to_bytes(),
                  "crushtool -d then -c does not give the map's bytes")
        print(f"phase crushtool: -d / -c of the {m.max_devices}-OSD map "
              f"({os.path.getsize(txt)} bytes of text) gives its "
              f"{len(m.to_bytes())} bytes back")

        def run(max_x, *extra):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = crushtool.main(["--test", path, "--min-x", "0",
                                     "--max-x", str(max_x), "--num-rep",
                                     "3", "--json", "--device", str(dev),
                                     *extra])
            check(rc == 0, f"crushtool --test {extra} exit {rc}")
            return json.loads(buf.getvalue())
        ck.crush_map_launches = 0
        t0 = time.perf_counter()
        full = run(n_inputs - 1)
        wall = time.perf_counter() - t0
        out["launches"] = ck.crush_map_launches
        check(out["launches"] == 1,
              f"crushtool --test launched crush_map {out['launches']} times")
        check(full["inputs"] == n_inputs
              and full["result_size_histogram"] == {"3": n_inputs},
              f"crushtool --test report {full}")
        print(f"phase crushtool --test {n_inputs} inputs (device engine, "
              f"the default): {full['seconds']} s, "
              f"{full['mappings_per_sec']} mappings/s (command wall "
              f"{wall:.3f} s with the build and the report), "
              f"utilization {full['device_utilization']}, crush_map "
              f"launches {out['launches']}; card {smi}")
        dev_rep = run(window - 1)
        host_rep = run(window - 1, "--engine", "host")
        strip = [{k: v for k, v in r.items()
                  if k not in ("seconds", "mappings_per_sec")}
                 for r in (dev_rep, host_rep)]
        check(strip[0] == strip[1], "crushtool --test reports differ "
                                    "between the device and host engines")
        print(f"phase crushtool --test {window} inputs: the device report "
              f"({dev_rep['seconds']} s) equals the host engine's "
              f"({host_rep['seconds']} s) apart from timing; card {smi}")
    out.update(seconds=full["seconds"], rate=full["mappings_per_sec"],
               window_device_s=dev_rep["seconds"],
               window_host_s=host_rep["seconds"])
    return out


def psim_phase(dev, smi, argv=("--osds", "1024", "--hosts", "128", "--pgs",
                               "32768", "--size", "3", "--objects",
                               "1000000")):
    """psim on the device engine and on the host engine: equal reports."""
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.tools import psim
    reports, walls = {}, {}
    for engine in ("device", "host"):
        ck.crush_map_launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = psim.main([*argv, "--engine", engine, "--device", str(dev)])
        walls[engine] = time.perf_counter() - t0
        check(rc == 0, f"psim --engine {engine} exit {rc}")
        reports[engine] = buf.getvalue()
        if engine == "device":
            launches = ck.crush_map_launches
    check(launches == 1, f"psim launched crush_map {launches} times")
    check(reports["device"] == reports["host"],
          "psim reports differ between the device and host engines")
    rep = json.loads(reports["device"])
    print(f"phase psim {' '.join(argv)}: device engine {walls['device']:.3f}"
          f" s (crush_map launches {launches}), host engine "
          f"{walls['host']:.3f} s, equal reports; pg per osd "
          f"{rep['pg_per_osd']}, spread {rep['spread_ratio']:.4f}; card "
          f"{smi}")
    return {"launches": launches, "walls": walls}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    import numpy as np

    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.common.cuda_build import build
    from ceph_tpu_torch.ec import gf256, kernel
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
    from ceph_tpu_torch.tools import ec_benchmark

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)

    # -- phase 1: card, build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from ceph_tpu_torch import native
    t0 = time.perf_counter()
    # the two kernel sources (nvcc) and the native host library (g++),
    # all started together
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        host_lib = pool.submit(native.available)
        builds = list(pool.map(build, ("gf_apply", "crush_map")))
        host_lib.result()
    print(f"phase build: three sources in {time.perf_counter() - t0:.3f} s")
    for built in builds:
        print(f"  {built.name}: nvcc {built.seconds:.3f} s")
    print(f"  native host library: g++ {native.build_info['seconds']:.3f} s"
          f" ({native.build_info['error'] or 'built'})")
    from crush_probe import crush_report, gf_report
    # what the CRUSH kernels issue per straw2 draw, beside the hash's 136
    # operations that the bound counts (1.0625 SM clocks)
    floor = hash_sm_clocks(HASH32_3_OPS, HASH32_3_XORS)
    for label, cost, ptxas in crush_report(builds[1]):
        check(cost["calls_in_loop"] == 0,
              f"{label}: {cost['calls_in_loop']} CALLs in its item loops")
        print(f"phase build: {label}: registers {ptxas.get('registers')}, "
              f"stack frame {ptxas.get('stack_frame')} B, spill stores "
              f"{ptxas.get('spill_stores')} B; one straw2 draw as compiled "
              f"issues {cost['per_draw']} instructions by pipe (mean of "
              f"{len(cost['draw_paths'])} paths through "
              f"{len(cost['loops'])} item loops, no CALL in them): "
              f"{cost['sm_clocks_per_draw']:.4f} SM clocks on the busiest "
              f"pipe, against the hash's {floor:.4f}")
    gf_cost = gf_report(builds[0])
    for (cfg, checksum), c in gf_cost.items():
        vec, byt = c["ptxas"]["vec"], c["ptxas"]["bytes"]
        print(f"phase build: {'gf_apply_checksum' if checksum else 'gf_apply'}"
              f" {cfg}: registers {vec.get('registers')} (16-byte path) / "
              f"{byt.get('registers')} (byte path), spill stores "
              f"{vec.get('spill_stores')} / {byt.get('spill_stores')} B; row "
              f"loop {c['loop']} per 4-lane word and input row, by pipe, "
              f"for each count of output rows served: {c['per_word']}; each "
              f"output row adds {c['per_row']}")

    # -- phase 2: the kernel against its plain version -----------------
    gen = gf256.rs_vandermonde_matrix(K, M)
    cases = [("encode k=8 r=4", gen[K:], 1 << 22)]
    # the batch queue's other lane buckets (ec_queue.LANE_BUCKETS)
    for L in (1 << 14, 1 << 16, 1 << 18, 1 << 20):
        cases.append((f"encode L={L}", gen[K:], L))
    for L in (333, 9000, (1 << 22) + 1):
        cases.append((f"encode odd L={L}", gen[K:], L))
    for lost in ([3], [0, 9], [1, 2, 8, 11]):
        present = [i for i in range(K + M) if i not in lost][:K]
        cases.append((f"decode r={len(lost)}",
                      gf256.decode_matrix(gen, present, lost), 1 << 20))
    cases += [("rs k=2 m=1", gf256.rs_vandermonde_matrix(2, 1)[2:], 65536),
              ("cauchy k=4 m=2", gf256.cauchy_matrix(4, 2)[4:], 100000),
              ("rs k=6 m=3", gf256.rs_vandermonde_matrix(6, 3)[6:], 77777),
              # more output rows than a tile holds: tiles over gridDim.y
              ("k=200 r=50", rng.integers(0, 256, (50, 200), dtype=np.uint8),
               999),
              # tables that fill the shared memory beside the load ring
              ("k=128 r=9", rng.integers(0, 256, (9, 128), dtype=np.uint8),
               4099),
              ("k=254 r=1", rng.integers(0, 256, (1, 254), dtype=np.uint8),
               4099)]
    max_abs_err, mismatches = 0, 0
    t0 = time.perf_counter()
    for label, mat, L in cases:
        ops = kernel.from_reference_matrix(mat, dev)
        data_np = rng.integers(0, 256, (mat.shape[1], L), dtype=np.uint8)
        data = torch.from_numpy(data_np).to(dev)
        got = kernel.gf_apply(ops, data)
        want = kernel.gf_apply_plain(ops.bitmat, data)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16))
                  .abs().max().item())
        bad = int((got != want).sum().item())
        if L <= 10000:
            bad += int((got.cpu().numpy()
                        != gf256.host_apply(mat, data_np)).sum())
        max_abs_err, mismatches = max(max_abs_err, err), mismatches + bad
        print(f"  {label:18s} [{mat.shape[1]}, {L}] -> [{mat.shape[0]}, {L}]"
              f": max_abs_err {err}, mismatched bytes {bad}")
    check(mismatches == 0, f"kernel disagrees with its plain version: "
                           f"{mismatches} bytes")
    print(f"phase kernel_vs_plain: {len(cases)} cases bit-exact "
          f"({time.perf_counter() - t0:.3f} s)")
    k2_mismatches = check_variants(torch, np, gf256, kernel, dev, rng,
                                   cases)

    # -- phase 3: the main path ----------------------------------------
    codec = factory("rs", {"k": str(K), "m": str(M)}, device=dev)
    objects = [rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()
               for _ in range(N_OBJECTS)]
    split = [codec.split_data(o) for o in objects]
    check(all(s.shape == (K, OBJECT_BYTES // K) for s in split),
          "split_data geometry")
    lost1 = [sorted(rng.choice(K, 2, replace=False).tolist())
             for _ in range(N_OBJECTS)]
    lost2 = [sorted(rng.choice(K, 2, replace=False).tolist()
                    + rng.choice(np.arange(K, K + M), 2,
                                 replace=False).tolist())
             for _ in range(N_OBJECTS)]

    async def degraded(q, parity, lost_sets):
        jobs, want = [], []
        for s, p, lost in zip(split, parity, lost_sets):
            full = np.concatenate([s, p])
            present = [i for i in range(K + M) if i not in lost][:K]
            w = [i for i in lost if i < K]
            jobs.append(q.apply(codec.decode_matrix_for(present, w),
                                full[present]))
            want.append(w)
        return await asyncio.gather(*jobs), want

    steps = ("group_fold", "group_device", "group_split")

    def snapshot(q):
        d = q.perf.dump()
        return {k: (d[k]["sum"], d[k]["avgcount"]) for k in steps} | {
            "device_launches": (d["device_launches"], 0)}

    async def drive():
        q = ECBatchQueue(Context("osd.0"), mode="on", device=dev)
        walls, sent, snaps = {}, 0, [snapshot(q)]
        kernel.gf_apply_launches = 0
        t = time.perf_counter()
        parity = await asyncio.gather(
            *[q.apply(gen[K:], s) for s in split])
        walls["encode"] = time.perf_counter() - t
        snaps.append(snapshot(q))
        sent += sum(s.size for s in split)
        t = time.perf_counter()
        rebuilt1, want1 = await degraded(q, parity, lost1)
        walls["degraded_2_data"] = time.perf_counter() - t
        snaps.append(snapshot(q))
        t = time.perf_counter()
        rebuilt2, want2 = await degraded(q, parity, lost2)
        walls["degraded_2_data_2_parity"] = time.perf_counter() - t
        snaps.append(snapshot(q))
        sent += 2 * sum(s.size for s in split)
        launches = kernel.gf_apply_launches
        perf = q.perf.dump()
        await q.stop()
        return (parity, [(rebuilt1, want1), (rebuilt2, want2)], walls,
                sent, launches, perf, snaps)

    parity, rounds, walls, sent, launches, perf, snaps = asyncio.run(drive())
    for (name, wall), a, b in zip(walls.items(), snaps, snaps[1:]):
        groups = b["group_fold"][1] - a["group_fold"][1]
        split_ms = " ".join(
            f"{k[6:]} {(b[k][0] - a[k][0]) * 1e3:.1f} ms" for k in steps)
        print(f"phase main_path {name}: {wall:.4f} s, "
              f"{N_OBJECTS * OBJECT_BYTES / wall / 1e9:.3f} GB/s of object "
              f"data; {groups} groups, "
              f"{b['device_launches'][0] - a['device_launches'][0]} "
              f"launches; executor steps: {split_ms}")
    print(f"  queue perf: { {k: perf[k] for k in ('device_launches', 'device_requests', 'device_bytes', 'host_requests', 'host_bytes')} }"
          f" batch_fill {perf['batch_fill']}")
    check(perf["device_launches"] > 0, "no device launches on the main path")
    check(launches == perf["device_launches"],
          f"kernel launches {launches} != queue device_launches "
          f"{perf['device_launches']}")
    check(perf["host_requests"] == 0,
          f"{perf['host_requests']} requests took the host path")
    check(perf["device_bytes"] == sent,
          f"device_bytes {perf['device_bytes']} != bytes sent {sent}")
    check(perf["device_requests"] == 3 * N_OBJECTS, "device_requests")
    ops = kernel.from_reference_matrix(gen[K:], dev)
    for s, p in zip(split, parity):
        want = kernel.gf_apply_plain(ops.bitmat, torch.from_numpy(s).to(dev))
        check(p.shape == (M, s.shape[1]) and np.array_equal(
            p, want.cpu().numpy()), "parity differs from the plain version")
    for rebuilt, wants in rounds:
        for s, out, w in zip(split, rebuilt, wants):
            check(np.array_equal(out, s[w]),
                  "a degraded read did not rebuild the original bytes")
    print(f"phase main_path: {N_OBJECTS} x {OBJECT_BYTES >> 20} MiB objects "
          f"encoded and rebuilt twice; kernel launches {launches} == "
          f"queue device_launches; parity equals the plain version; "
          f"rebuilt bytes equal the originals")

    # -- phase 4: the ec_benchmark entry point -------------------------
    for argv in (["--workload", "encode"],
                 ["--workload", "decode", "--erasures", "2"]):
        before = kernel.gf_apply_launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ec_benchmark.main(argv + [
                "--plugin", "rs", "-P", "k=8", "-P", "m=4",
                "--size", str(1 << 28), "--json", "--device", "cuda"])
        check(rc == 0, f"ec_benchmark {argv} exit {rc}")
        check(kernel.gf_apply_launches > before,
              f"ec_benchmark {argv} did not launch the kernel")
        for line in buf.getvalue().strip().splitlines():
            print(f"phase ec_benchmark {argv[1]}: {line}")

    # -- phase 5: kernel timing at the encode window -------------------
    L = 1 << 22
    data = torch.from_numpy(
        rng.integers(0, 256, (K, L), dtype=np.uint8)).to(dev)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    ms = median_ms(torch, lambda: kernel.gf_apply(ops, data), 25, flush)
    plain_ms = median_ms(
        torch, lambda: kernel.gf_apply_plain(ops.bitmat, data), 21, flush)
    moved = (K + M) * L
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * (8 * M) * (8 * K) * L / INT8_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    from crush_probe import gf_floor_ms, gf_times, sm_clock_under_load
    floor_ms = gf_floor_ms(gf_cost[kernel.TUNE_SPACE[0], False], K, M, L,
                           SM_CLOCKS_PER_S)
    print(f"phase timing: gf_apply [8, {L}] -> [4, {L}] median {ms:.4f} ms "
          f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f}, int8-MMA ops "
          f"{ops_ms:.4f}), {bound_ms / ms * 100:.1f}% of bound; the row "
          f"loop's SASS instructions take at least {floor_ms:.4f} ms; "
          f"card {smi}")
    clocks = sm_clock_under_load(torch, lambda: kernel.gf_apply(ops, data))
    print(f"phase timing: SM clock while gf_apply runs back to back: "
          f"{clocks} MHz (the floors take {SM_CLOCKS_PER_S / 132 / 1e6:.0f} "
          f"MHz); card {smi}")
    # every variant of both entries at the queue's encode and decode
    # windows, beside each one's bytes bound and instruction floor
    for row in gf_times(torch, dev):
        cfg, r, k, n = row["variant"], row["r"], row["k"], row["L"]
        b_ms = (k + r) * n / HBM_BYTES_PER_S * 1e3
        cb_ms = k * n / HBM_BYTES_PER_S * 1e3
        f_ms = gf_floor_ms(gf_cost[cfg, False], k, r, n, SM_CLOCKS_PER_S)
        fc_ms = gf_floor_ms(gf_cost[cfg, True], k, r, n, SM_CLOCKS_PER_S)
        if row["shape"].endswith("L2-resident"):
            print(f"  {row['shape']} [{k}, {n}] -> [{r}, {n}] variant {cfg}"
                  f": gf_apply {row['ms']:.4f} ms "
                  f"({f_ms / row['ms'] * 100:.1f}% of its {f_ms:.4f} ms "
                  f"instruction floor), "
                  f"gf_apply_checksum {row['checksum_ms']:.4f} ms "
                  f"({fc_ms / row['checksum_ms'] * 100:.1f}% of {fc_ms:.4f} "
                  f"ms); card {smi}")
            continue
        print(f"  {row['shape']} [{k}, {n}] -> [{r}, {n}] variant {cfg}: "
              f"gf_apply {row['ms']:.4f} ms ({b_ms / row['ms'] * 100:.1f}% "
              f"of its {b_ms:.4f} ms bytes bound; instruction floor "
              f"{f_ms:.4f} ms), gf_apply_checksum {row['checksum_ms']:.4f} "
              f"ms ({cb_ms / row['checksum_ms'] * 100:.1f}% of "
              f"{cb_ms:.4f} ms; floor {fc_ms:.4f} ms); card {smi}")

    # -- phase 6: the variant tuner's path -----------------------------
    k2_launches = tuner_path(torch, np, gf256, kernel, dev, smi)

    # -- phase 7: CRUSH placement, 1M inputs per rule ------------------
    crush = crush_path(torch, np, dev, smi)

    # -- phase 8: the OSDMap and osdmaptool ----------------------------
    osdmap_launches, pools = osdmap_path(torch, np, dev, smi)

    # -- phase 9: the native host library ------------------------------
    host = native_phase(np, dev, smi)

    # -- phase 10: the lrc and shec codecs -----------------------------
    codecs = lrc_shec_phase(np, kernel, dev, smi, objects)
    del objects
    for plugin, _, prof in LRC_SHEC:
        for argv in (["--workload", "encode"],
                     ["--workload", "decode", "--erasures", "2"]):
            kernel.gf_apply_launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = ec_benchmark.main(argv + [
                    "--plugin", plugin,
                    *[a for kv in prof.items() for a in ("-P", "=".join(kv))],
                    "--size", str(1 << 28), "--json", "--device", "cuda"])
            check(rc == 0, f"ec_benchmark {plugin} {argv} exit {rc}")
            check(kernel.gf_apply_launches > 0,
                  f"ec_benchmark {plugin} {argv} did not launch the kernel")
            for line in buf.getvalue().strip().splitlines():
                print(f"phase ec_benchmark {plugin} {argv[1]}: {line}; "
                      f"gf_apply launches {kernel.gf_apply_launches}; "
                      f"card {smi}")
    narrow = narrow_k1_times(torch, np, kernel, dev, smi, flush)

    # -- phase 11: crushtool -------------------------------------------
    tool = crushtool_phase(np, dev, smi)

    # -- phase 12: psim ------------------------------------------------
    sim = psim_phase(dev, smi)

    # -- phase 13: the probe's timing, the kernels line -----------------
    cfg0 = kernel.TUNE_SPACE[0]
    k2_ms = median_ms(
        torch, lambda: kernel.gf_apply_checksum(ops, data, cfg0), 25, flush)
    k2_plain_ms = median_ms(
        torch, lambda: kernel.gf_apply_checksum_plain(ops.bitmat, data), 11,
        flush)
    k2_bytes_ms = K * L / HBM_BYTES_PER_S * 1e3
    k2_ops_ms = 2 * (8 * M) * (8 * K) * L / INT8_OPS_PER_S * 1e3
    k2_bound_ms = max(k2_bytes_ms, k2_ops_ms)
    k2_floor_ms = gf_floor_ms(gf_cost[cfg0, True], K, M, L, SM_CLOCKS_PER_S)
    print(f"phase timing: gf_apply_checksum {cfg0} [8, {L}] -> int32 "
          f"median {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, bound "
          f"{k2_bound_ms:.4f} ms (bytes {k2_bytes_ms:.4f}, int8-MMA ops "
          f"{k2_ops_ms:.4f}), {k2_bound_ms / k2_ms * 100:.1f}% of bound; "
          f"instruction floor {k2_floor_ms:.4f} ms; card {smi}")

    print(json.dumps({"host_paths": {"native": host, "crushtool": tool,
                                     "psim": sim}}))
    print(json.dumps({"kernels": [{
        "name": "gf_apply",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ec/kernel.py:135",
        "replaces_function": "_ec_fused_kernel",
        "launches": launches + sum(sum(c["launches"].values())
                                   for c in codecs.values()),
        "launches_by_path": {"queue": launches} | {
            f"{plugin} {step}": n for plugin, c in codecs.items()
            for step, n in c["launches"].items()},
        "narrow_shapes": narrow,
        "mismatches": mismatches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "instruction_floor_ms": floor_ms,
        "shape": f"[{K}, {L}] -> [{M}, {L}] uint8",
    }, {
        "name": "gf_apply_checksum",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ec/kernel.py:237",
        "replaces_function": "_pallas_probe_sum",
        "launches": k2_launches,
        "mismatches": k2_mismatches,
        "max_abs_err": 0 if k2_mismatches == 0 else None,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms,
        "bound_by": "bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
        "library_ms": None,
        "instruction_floor_ms": k2_floor_ms,
        "shape": f"[{K}, {L}] uint8 -> int32 scalar, variant {cfg0}",
    }, {
        "name": "crush_map",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_map.cu",
        "replaces": "ceph_tpu/ops/crush_kernel.py:1019",
        "replaces_function": "JaxEngine._build (fast_map/full_map)",
        "launches": (crush["map_launches"] + osdmap_launches
                     + tool["launches"] + sim["launches"]),
        "launches_by_path": {"batch_do_rule_arrays": crush["map_launches"],
                             "osdmap": osdmap_launches,
                             "crushtool --test": tool["launches"],
                             "psim": sim["launches"]},
        "mismatches": crush["map_mismatches"],
        "max_abs_err": crush["map_max_abs_err"],
        "ms": crush["map_ms"],
        "plain_ms": crush["map_plain_ms"],
        "bound_ms": crush["map_bound_ms"],
        "bound_by": crush["map_bound_by"],
        "library_ms": None,
        "shape": f"3 rules x {CRUSH_N} inputs: xs [{CRUSH_N}] int64 -> "
                 f"osds [{CRUSH_N}, 3 + count | 6 | 3 + count] int32",
        "rules": crush["rules"],
        "pools": pools,
    }, {
        "name": "crush_straw2_winners",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_map.cu",
        "replaces": "ceph_tpu/ops/crush_kernel.py:1520",
        "replaces_function": "_get_winners_fn",
        "launches": crush["win_launches"],
        "mismatches": crush["win_mismatches"],
        "max_abs_err": crush["win_max_abs_err"],
        "ms": crush["win_ms"],
        "plain_ms": crush["win_plain_ms"],
        "bound_ms": crush["win_bound_ms"],
        "bound_by": crush["win_bound_by"],
        "library_ms": None,
        "shape": crush["win_shape"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
