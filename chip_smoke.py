#!/usr/bin/env python3
"""Chip smoke test of the port: ``python3 chip_smoke.py`` on a machine with
one CUDA card, from the root of a checkout.

It drives ceph_tpu_torch's EC write / degraded-read data path, the EC
variant tuner, CRUSH placement up to the OSDMap and osdmaptool, the lrc
and shec codecs, crushtool and psim on the card, the native host
library on its host, the messenger carrying the card's chunks, the
port's object stores holding them, a 3-mon quorum whose OSDMap feeds
placement and rebuild, a cluster of port OSDs that a port client
writes, reads and recovers through (with object classes, striped files
and a write-back cache, and again in mesh mode), the mesh steps alone
and the model checker, and fails (exit code 1, no result line) on any
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
 13. K1's chunks through the messenger: phase 3's 64 objects encoded
     through ECBatchQueue(mode="on") (K1's launches counted from 0, its
     device time by CUDA events), then all 768 chunks of 512 KiB sent as
     MPerf messages from a client to a server messenger on 127.0.0.1
     over TCP with cephx (a keyring made by auth.keyring), each checked on
     receipt against the CPU codec's chunk by sha256; again with 1 in 20
     socket writes failing (each chunk arrives once, in order); again
     by ms_local_delivery (no body encoded); the server's counters read
     through its admin socket; perf_msgr at its defaults and at
     --size 524288; wall, msg/s, MB/s and p50/p99 latency per round
     (host clock);
 14. place, encode, store, lose two OSDs, rebuild: an OSDMap of 16 OSDs
     (one per host, straw2) with a k=8 m=4 EC pool of 128 PGs
     (chooseleaf indep over hosts) places phase 3's 64 object names in
     one map_objects_batch(engine="device") call (one crush_map launch);
     the objects are encoded through ECBatchQueue(mode="on"); each of
     the 768 chunks is written as ObjectId(name, pool, shard=i) into its
     PG's shard collection on the BlockStore (crc32c) of acting[i], one
     store per OSD, through queue_transactions with on_commit, and the
     phase waits for every commit (callbacks in submission order, no
     commit thread error); every store is remounted and every chunk read
     back against the CPU codec's by sha256, with no chunk missing or
     extra; the two OSDs that hold two data chunks of the most objects
     are lost, and every lost data chunk is rebuilt through the queue
     (K1 with the decode matrix) from k chunks read from the other
     stores; then OSD 0's chunks through KStore, FileStore, MemStore and
     a zlib BlockStore (which must keep the random chunks raw), each
     remounted and read back.  D1's and K1's launches are counted from 0
     around each step, with the span of CUDA events around each wrapper
     call (host work included, not kernel time); wall and MB/s per step,
     each store's commit counters and mount seconds (host clock);
 15. a 3-mon quorum's OSDMap through D1 and K1: three port Monitors
     (mon_election_timeout 0.3, mon_lease 1.0, mon_tick_interval 0.5 s,
     reconnect backoff 0.02-0.1 s; each with a FileDB under a temporary
     directory) elect a leader on
     127.0.0.1; an admin MonClient runs osd crush build-simple for 1024
     OSDs in 128 hosts x 8, 128 host messengers send the 1024 MOSDBoots,
     an RS k=8 m=4 profile, a replicated size-3 pool of 32768 PGs and an
     EC pool of 8192 PGs are created; 64 config-key sets, one at a time,
     give the commit latency (p50, p99; the filesystem type printed
     beside); a subscriber on mon c gets the map, equal to each mon's
     stored full map; D1 places phase 3's 64 object names (one launch) and
     maps both pools (one launch each), every row equal to the host
     engine's; K1 encodes the objects through ECBatchQueue(mode="on");
     the three OSDs holding the most shards are reported failed by
     another host and marked out, D1 places the names again (only their
     positions move) and K1 rebuilds every moved shard, each equal to the
     CPU codec's by sha256; the mon's own sweeps (pg_num 16384 on the EC
     pool, reweight-by-utilization) run on its host engine with no
     launch, and the reply's avg_pgs equals the mean of the subscriber's
     D1 census of both pools (two launches); once the quorum has held
     for 2 x mon_lease + the election timeout, the leader shuts down (a
     new leader commits, the subscriber's next map comes from mon c) and
     restarts from its FileDB (back in quorum, every stored value equal);
     fails on an ERROR logged by a mon and on launch counts other than
     those stated (host clock, launches, wrapper spans);
 16. an RS k=8 m=4 pool on 16 port OSDs: three port Monitors (phase 15's
     timers, FileDBs, on an event loop of their own) and 16 port OSDs,
     one per host, each with a crc32c BlockStore and a messenger on
     127.0.0.1 TCP, two shards on thread lanes each (each shard's EC
     batch queue launching from its own executor thread), built by ``osd
     crush build-simple`` and the OSDs' MOSDBoots; a port Rados on the
     card makes an RS pool of 128 PGs and a replicated size-3 pool of
     512 (Ceph's ~100 PGs per OSD); phase 3's 64 objects are
     written into each with all in flight and read back (sha256), every
     EC shard in its acting OSD's store equal to the CPU codec's chunk
     and every replica to the others; the two OSDs holding the most EC
     shards stop and are marked down (once every PG is active again,
     the reads of objects that lost a data shard decode through K1) and
     out (every PG clean again, every
     moved shard rebuilt equal to the CPU codec's).  D1's launches are
     counted by call site (the Objecter's cork flush, each OSD's epoch
     advance, backfill planning) and K1's by queue and step (encode,
     degraded read, rebuild), each step's wrapper count equal to the
     call sites' and the queues'; fails on an ERROR logged by any daemon
     and on counts outside the stated ranges (host clock, launches,
     wrapper spans); after the class step a client step: 4 files of 16
     MiB striped through RadosStriper's default layout onto the
     replicated pool, all in flight, stat, read whole, a window read and
     overwritten, one truncated, one removed (every sub-object gone), the
     rest removed after the checks; then
     a write-back ObjectCacher (the reference's defaults) over 16 EC
     objects takes 256 seeded 16 KiB writes and flushes them by
     read-patch-rewrite (EC pools refuse partial writes; K1 encodes each
     rewrite), every object read back equal to its patched contents, and
     every later EC check holds them; the same on process lanes;
 17. mesh mode: the same 16 OSDs on thread lanes with osd_mesh_mode on
     and the mesh executor over 12 positions on the card, the EC pool
     alone: the 64 objects written (each primary's encode one mesh
     program, one K1 launch with the rows of all 12 positions, the
     sub-ops delivered in process), read, two OSDs stopped, degraded reads
     and the rebuild decoding as mesh programs; every stored and rebuilt
     shard equal to the CPU codec's, the batch queues launching nothing,
     the executor's launches in stated ranges;
 18. D3 and D4 alone: parallel/layout's ec_cluster_step over 12
     positions (3 x 4) at [12, 8, 512 Ki], ec_recover_step over 8 (1 x 8)
     at [64, 8, 512 Ki] with 2 data chunks lost, and mesh_exec's
     _mesh_encode_fn at n = 12, each bit for bit against the same step on
     K1's plain version and timed with L2 flushed beside its bytes bound;
 19. one model-checker run, as tests/test_thrash.py runs its EC seed 101
     (qa.rados_model.run_model, 5 OSDs, RS k=2 m=2, thrashed), which must
     report ok; its K1 and D1 launches counted;
 20. times the probe, the descent and the winner grid beside their plain
     versions and bounds, and prints the ``kernels`` line (launches by
     path: the queue, lrc, shec, the messenger's and the store's encode,
     the store's rebuild, the mon phase's encode and rebuild, the osd
     phase's encode, degraded read, rebuild, class write and client
     cache, the mesh run's encode and recover, the model run; the CRUSH
     path, the OSDMap, crushtool, psim, the store's placement, the mon
     phase's four steps, the osd phase's call sites, the mesh run's and
     the model run's), with a row for each mesh step (D3, D4).

The last line of its output is ``{"ok": true, "device": {...}}``.  It
imports nothing of JAX and nothing of the JAX package.
"""

import asyncio
import concurrent.futures
import contextlib
import errno
import io
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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


MSG_INFLIGHT = 32      # chunks in flight per round: perf_msgr's default
MSG_INJECT = 20        # 1 in 20 socket writes fails (the messenger's own test)


def msgr_keyring(path):
    """Write a keyring made by the port's auth.keyring: the mon key the
    OSD service secret derives from, the client and the OSD."""
    from ceph_tpu_torch.auth.keyring import Keyring
    kr = Keyring()
    kr.add("mon.")
    kr.add("client.smoke", caps={"mon": "allow r", "osd": "allow *"})
    kr.add("osd.0", caps={"mon": "allow profile osd", "osd": "allow *"})
    kr.save(path)


async def chunk_round(chunks, want, *, keyring=None, inject=0, local=False,
                      inflight=MSG_INFLIGHT, asok=None, timeout=120.0):
    """Send every chunk as an ``MPerf`` (tid = its index) from a client
    messenger to a server messenger of the port, both bound on 127.0.0.1,
    at most ``inflight`` unreceived.  The server checks each chunk's
    sha256 against ``want`` and records the order of arrival; with
    ``keyring`` the link runs cephx (authorizer, signed frames), with
    ``inject`` the client fails 1 in ``inject`` socket writes, with
    ``local`` both ends opt into ms_local_delivery.  With ``asok`` the
    server's counters are read back through its admin socket.  Host
    clock."""
    import hashlib

    from ceph_tpu_torch.auth import cephx
    from ceph_tpu_torch.auth.keyring import Keyring
    from ceph_tpu_torch.common.admin_socket import AdminSocket, admin_command
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.msg import (Dispatcher, EntityName, Messenger,
                                    Policy, payload)
    from ceph_tpu_torch.tools.perf_msgr import MPerf
    loop = asyncio.get_running_loop()
    n = len(chunks)
    sent, lat, seen = [0.0] * n, [0.0] * n, bytearray(n)
    order, bad, dup, entities = [], [], [], set()
    window = asyncio.Semaphore(inflight)
    done = loop.create_future()
    ctx_s, ctx_c = Context("osd.0"), Context("client.smoke")
    for ctx in (ctx_s, ctx_c):
        ctx.config.set("ms_initial_backoff", 0.01)
        ctx.config.set("ms_local_delivery", local)
        if keyring:
            ctx.config.set("auth_supported", "cephx")
            ctx.config.set("keyring", keyring)
    ctx_c.config.set("ms_inject_socket_failures", inject)
    perf = ctx_s.perf.create("chunk_sink")
    for key in ("chunks", "bytes", "mismatches", "duplicates"):
        perf.add_u64(key)

    class Sink(Dispatcher):
        def ms_dispatch(self, msg) -> bool:
            if not isinstance(msg, MPerf):
                return False
            t = time.perf_counter()
            tid = msg.tid
            if seen[tid]:
                dup.append(tid)
                perf.inc("duplicates")
                return True
            seen[tid] = 1
            lat[tid] = t - sent[tid]
            order.append(tid)
            entities.add(getattr(msg, "auth_entity", None))
            if hashlib.sha256(msg.data).digest() != want[tid]:
                bad.append(tid)
                perf.inc("mismatches")
            perf.inc("chunks")
            perf.inc("bytes", len(msg.data))
            perf.hinc("recv_latency", lat[tid])
            window.release()
            if len(order) == n and not done.done():
                done.set_result(t)
            return True

    server = Messenger(ctx_s, EntityName.parse("osd.0"))
    server.add_dispatcher(Sink())
    client = Messenger(ctx_c, EntityName.parse("client.smoke"))
    client.set_policy("osd", Policy.lossless_peer())
    handshakes = [0]
    if keyring:
        kr = Keyring.load(keyring)
        svc = cephx.service_secret(kr.get_key("mon."), "osd")
        blob, skey = cephx.issue_ticket(
            svc, "client.smoke", "osd", kr.get_caps("client.smoke"),
            ctx_s.config["auth_ticket_ttl"])

        def authorizer(peer_type):
            handshakes[0] += 1
            az, nonce = cephx.make_authorizer(blob, skey)
            return az, skey, nonce
        client.get_authorizer_cb = authorizer
        server.verify_authorizer_cb = lambda az: cephx.verify_authorizer(
            svc, az)
        server.require_authorizer = True
    sock = None
    try:
        addr = await server.bind("127.0.0.1")
        if asok:
            sock = AdminSocket(ctx_s, asok)
            await sock.start()
        payload.reset_counters()
        t0 = time.perf_counter()
        for tid, data in enumerate(chunks):
            await window.acquire()
            sent[tid] = time.perf_counter()
            client.send_message(MPerf(tid, data), addr, "osd")
        t_end = await asyncio.wait_for(done, timeout)
        await asyncio.sleep(0.2)    # a late duplicate would land here
        counters = payload.counters()
        dump = (await loop.run_in_executor(None, admin_command, asok,
                                           "perf dump") if asok else None)
    finally:
        if sock is not None:
            await sock.stop()
        await client.shutdown()
        await server.shutdown()
    wall = t_end - t0
    ms = sorted(x * 1e3 for x in lat)
    return {"n": n, "order": order, "mismatches": len(bad),
            "duplicates": len(dup), "wall_s": wall,
            "msgs_per_s": n / wall,
            "mb_per_s": sum(len(c) for c in chunks) / wall / 1e6,
            "p50_ms": ms[n // 2], "p99_ms": ms[max(0, int(n * 0.99) - 1)],
            "encode_calls": counters["msg_encode_calls"],
            "local_msgs": client._local_msgs,
            "sock_writes": client._sock_writes,
            "handshakes": handshakes[0], "auth_entities": entities,
            "perf_dump": dump}


def cpu_chunk_digests(objects):
    """The sha256 of each of the k + m chunks of each object, as the CPU
    codec (RS k=8 m=4) encodes it: the reference the card's chunks are
    held against."""
    import hashlib

    from ceph_tpu_torch.ec import factory
    cpu = factory("rs", {"k": str(K), "m": str(M)}, device="cpu")
    out = []
    for o in objects:
        ch = cpu.encode(set(range(K + M)), o)
        out.append([hashlib.sha256(ch[i].tobytes()).digest()
                    for i in range(K + M)])
    return out


@contextlib.contextmanager
def device_timer(torch, module, name, on_card):
    """On a card, replace ``module.name`` by a wrapper that records a
    pair of CUDA events around each call; yields the list of pairs.  The
    span between a pair holds the wrapper's host work as well as its
    kernel."""
    real, events = getattr(module, name), []

    def timed(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real(*args, **kwargs)
        e1.record()
        events.append((e0, e1))
        return res

    if on_card:
        setattr(module, name, timed)
    try:
        yield events
    finally:
        setattr(module, name, real)


def events_ms(torch, events):
    if not events:
        return 0.0
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events)


def chunk_costs(data, reps=15):
    """Host-clock medians (ms) of the per-byte steps a cephx TCP round
    takes for one chunk, each alone in this thread: the body encode and
    decode, crc32 and the HMAC signature (each run once per end), the
    sink's sha256, and one copy of the chunk's bytes."""
    import hashlib
    import zlib

    from ceph_tpu_torch.auth.cephx import sign_payload
    from ceph_tpu_torch.tools.perf_msgr import MPerf
    body = MPerf(0, data).to_bytes()
    steps = {"encode": lambda: MPerf(0, data).to_bytes(),
             "decode": lambda: MPerf.from_bytes(body),
             "crc32": lambda: zlib.crc32(body),
             "sign": lambda: sign_payload(bytes(32), body),
             "sha256": lambda: hashlib.sha256(data).digest(),
             "copy": lambda: bytes(bytearray(body))}
    out = {}
    for name, fn in steps.items():
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times)
    out["copy"] /= 2              # bytearray(body), then bytes(...)
    return out


def messenger_phase(np, kernel, dev, smi, objects, tmpdir,
                    inflight=MSG_INFLIGHT, inject=MSG_INJECT,
                    perf_msgr_argv=((), ("--size", "524288"))):
    """K1's chunks through the port's messenger: every object split and
    encoded through ECBatchQueue on ``dev`` (K1 on a card; its launches
    and device time counted), then each of the k + m chunks sent as an
    MPerf from a client to a server messenger over loopback TCP with
    cephx, checked on receipt against the CPU codec's chunk by sha256;
    the same chunks again with socket failures injected (each arrives
    once, in order), and once more by ms_local_delivery (no body
    encoded); the server's counters read through its admin socket; then
    perf_msgr at each of ``perf_msgr_argv``."""
    import torch

    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.ec import factory, gf256
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
    t0 = time.perf_counter()
    want = [d for ds in cpu_chunk_digests(objects) for d in ds]
    cpu_s = time.perf_counter() - t0
    codec = factory("rs", {"k": str(K), "m": str(M)}, device=dev)
    split = [codec.split_data(o) for o in objects]
    gen = gf256.rs_vandermonde_matrix(K, M)

    async def encode():
        q = ECBatchQueue(Context("osd.0"), device=dev,
                         mode="on" if dev.type == "cuda" else "force")
        try:
            kernel.gf_apply_launches = 0
            t = time.perf_counter()
            parity = await asyncio.gather(
                *[q.apply(gen[K:], s) for s in split])
            return (parity, time.perf_counter() - t,
                    kernel.gf_apply_launches, q.perf.dump())
        finally:
            await q.stop()

    with device_timer(torch, kernel, "gf_apply",
                      dev.type == "cuda") as events:
        parity, enc_wall, launches, qperf = asyncio.run(encode())
    device_ms = events_ms(torch, events)
    check(qperf["host_requests"] == 0,
          f"{qperf['host_requests']} encodes took the host path")
    if dev.type == "cuda":
        check(launches > 0 and launches == qperf["device_launches"]
              == len(events),
              f"gf_apply launches {launches}, queue device_launches "
              f"{qperf['device_launches']}, timed {len(events)}")
    chunks = [row.tobytes() for s, p in zip(split, parity)
              for row in (*s, *p)]
    n = len(chunks)
    check(n == len(objects) * (K + M) and n == len(want), "chunk count")
    print(f"phase messenger encode: {len(objects)} x "
          f"{len(objects[0]) >> 10} KiB objects -> {n} chunks of "
          f"{len(chunks[0]) >> 10} KiB through ECBatchQueue on {dev}: "
          f"{enc_wall:.4f} s, gf_apply launches {launches}, device time "
          f"{device_ms:.4f} ms (CUDA events); CPU codec's sha256s in "
          f"{cpu_s:.2f} s; card {smi}")
    keyring = os.path.join(tmpdir, "keyring")
    msgr_keyring(keyring)
    asok = os.path.join(tmpdir, "osd.0.asok")
    rounds = {
        "cephx": asyncio.run(chunk_round(chunks, want, keyring=keyring,
                                         inflight=inflight, asok=asok)),
        "cephx + injected socket failures": asyncio.run(chunk_round(
            chunks, want, keyring=keyring, inject=inject,
            inflight=inflight)),
        "ms_local_delivery": asyncio.run(chunk_round(
            chunks, want, local=True, inflight=inflight)),
    }
    for label, r in rounds.items():
        check(r["mismatches"] == 0,
              f"{label}: {r['mismatches']} chunks differ from the CPU "
              f"codec's")
        check(r["duplicates"] == 0, f"{label}: {r['duplicates']} chunks "
                                    f"arrived twice")
        check(r["order"] == list(range(n)),
              f"{label}: chunks lost or out of order")
        print(f"phase messenger {label}: {n} chunks, wall "
              f"{r['wall_s']:.4f} s, {r['msgs_per_s']:.1f} msg/s, "
              f"{r['mb_per_s']:.1f} MB/s, latency p50 {r['p50_ms']:.3f} "
              f"ms p99 {r['p99_ms']:.3f} ms (host clock, {inflight} in "
              f"flight); body encodes {r['encode_calls']}, socket writes "
              f"{r['sock_writes']}, local deliveries {r['local_msgs']}, "
              f"cephx handshakes {r['handshakes']}; card {smi}")
    costs = chunk_costs(chunks[0])
    ends = (costs["encode"] + costs["decode"] + 2 * costs["crc32"]
            + 2 * costs["sign"] + costs["sha256"])
    print(f"phase messenger per-chunk steps, one {len(chunks[0]) >> 10} "
          f"KiB chunk alone (host clock medians): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in costs.items())
          + f"; encode + decode + crc32 and signature at both ends + "
          f"sha256 = {ends:.4f} ms of the cephx round's "
          f"{rounds['cephx']['wall_s'] / n * 1e3:.4f} ms per chunk; card "
          f"{smi}")
    tcp, inj, loc = rounds.values()
    check(tcp["auth_entities"] == {"client.smoke"},
          f"cephx entities {tcp['auth_entities']}")
    check(tcp["encode_calls"] == n and inj["encode_calls"] == n,
          "a TCP round did not encode each body exactly once")
    check(inj["handshakes"] > 1, "no socket failure was injected")
    check(loc["encode_calls"] == 0 and loc["local_msgs"] == n,
          f"local delivery: {loc['encode_calls']} encodes, "
          f"{loc['local_msgs']} local messages")
    dump = tcp["perf_dump"]
    check(dump["chunk_sink"]["chunks"] == n
          and dump["chunk_sink"]["mismatches"] == 0,
          f"admin socket perf dump: {dump.get('chunk_sink')}")
    print(f"phase messenger admin socket perf dump (server, cephx round): "
          f"{json.dumps(dump, sort_keys=True)}")
    harness = []
    for argv in perf_msgr_argv:
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.perf_msgr",
             *argv], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0,
              f"perf_msgr {argv}: exit {proc.returncode}: {proc.stderr}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        harness.append(out)
        print(f"phase messenger python -m ceph_tpu_torch.tools.perf_msgr "
              f"{' '.join(argv)}: {json.dumps(out)} (host clock); card "
              f"{smi}")
    return {"launches": launches, "device_ms": device_ms,
            "encode_wall_s": enc_wall, "chunk_costs_ms": costs,
            "rounds": {label: {k: v for k, v in r.items()
                               if k not in ("order", "perf_dump",
                                            "auth_entities")}
                       for label, r in rounds.items()},
            "perf_msgr": harness}


STORE_OSDS = 16        # one OSD per host
STORE_PG_NUM = 128     # Ceph's ~100 PGs per OSD over the pool size: 16 x 100 / 12
STORE_POOL = 3
STORE_WAIT_S = 600.0   # bound on the wait for every commit of a step
#: the commit counters that count (the rest are averages and windows)
COUNTS = ("commit_batches", "txns", "data_fsyncs", "kv_syncs", "fsyncs",
          "fsyncs_saved")


def store_osdmap():
    """An OSDMap of STORE_OSDS OSDs, one per host (straw2), with an RS
    k=8 m=4 EC pool of STORE_PG_NUM PGs whose rule places the 12 chunks by
    chooseleaf indep over hosts, all built by the port's crush/builder."""
    from ceph_tpu_torch.crush.builder import (build_hierarchy,
                                              make_erasure_rule)
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.msg.types import EntityAddr
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
    from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, PGPool
    crush = CrushMap()
    crush.max_devices = STORE_OSDS
    build_hierarchy(crush, STORE_OSDS, 1)
    rule = make_erasure_rule(crush, "ec_rule", size=K + M)
    m = OSDMap()
    m.fsid = "chip-smoke-store"
    m.crush = crush
    m.set_max_osd(STORE_OSDS)
    inc = Incremental(1)
    for o in range(STORE_OSDS):
        inc.new_up[o] = EntityAddr(f"10.1.0.{o}", 6800, o + 1)
        inc.new_weight[o] = 0x10000
    inc.new_pools[STORE_POOL] = PGPool(POOL_TYPE_ERASURE, size=K + M,
                                       min_size=K + 1, crush_ruleset=rule,
                                       pg_num=STORE_PG_NUM, ec_profile="k8m4")
    inc.new_pool_names[STORE_POOL] = "ec84"
    m.apply_incremental(inc)
    return m


class CommitErrors:
    """Records what the stores' commit threads log at ERROR: a commit
    that failed or a callback that raised."""

    def __init__(self):
        import logging
        self.records = []
        self.logger = logging.getLogger("ceph-tpu-torch.store.commit")
        self.handler = logging.Handler(logging.ERROR)
        self.handler.emit = self.records.append

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)

    def check(self, where):
        check(not self.records,
              f"{where}: the commit thread logged "
              f"{[r.getMessage() for r in self.records]}")


async def commit_all(stores, items):
    """Queue one write transaction per item ``(store index, cid, oid,
    data)`` through ``queue_transactions`` with an on_commit callback, as
    the OSD's write path does, and wait for every commit.  Fails when a
    commit thread dies, when the wait passes STORE_WAIT_S or when a
    store's callbacks come out of submission order.  Returns the seconds
    to apply and to the last commit (host clock)."""
    from ceph_tpu_torch.store import Transaction
    loop = asyncio.get_running_loop()
    done = loop.create_future()
    order = [[] for _ in stores]
    left = [len(items)]

    def committed(where, idx):
        order[where].append(idx)
        left[0] -= 1
        if left[0] == 0 and not done.done():
            done.set_result(time.perf_counter())

    t0 = time.perf_counter()
    for idx, (where, cid, oid, data) in enumerate(items):
        stores[where].queue_transactions(
            [Transaction().write(cid, oid, 0, data)],
            on_commit=lambda w=where, i=idx: committed(w, i))
    applied = time.perf_counter() - t0
    if not items:
        done.set_result(t0)
    while not done.done():
        await asyncio.wait({done}, timeout=0.05)
        dead = [i for i, s in enumerate(stores)
                if getattr(s, "_committer", None) is not None
                and s._committer.dead]
        check(not dead, f"the commit threads of stores {dead} died")
        check(time.perf_counter() - t0 < STORE_WAIT_S,
              f"{left[0]} commits still pending after {STORE_WAIT_S} s")
    for s in stores:
        s.sync()
    for where, got in enumerate(order):
        check(got == [i for i, it in enumerate(items) if it[0] == where],
              f"store {where}: commits out of submission order")
    return applied, done.result() - t0


def store_phase(np, kernel, dev, smi, objects, tmpdir, engine="device"):
    """Place, encode, store, lose two OSDs, rebuild: the objects' names
    placed by one ``map_objects_batch`` call (D1 on a card), the objects
    encoded through ECBatchQueue (K1), every chunk written as
    ``ObjectId(name, pool, shard=i)`` into its PG's shard collection on
    the BlockStore of ``acting[i]`` (one per OSD, crc32c), remounted and
    read back against the CPU codec's chunks by sha256; then the two OSDs
    that together hold two data chunks of the most objects are lost and
    every lost data chunk is rebuilt through the queue (K1 with the
    decode matrix) from k chunks read from the stores that remain; last,
    OSD 0's chunks through KStore, FileStore, MemStore and a zlib
    BlockStore, each remounted and read back."""
    import hashlib

    import torch

    from ceph_tpu_torch import native
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.ec import factory, gf256
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
    from ceph_tpu_torch.store import (CollectionId, FileStore, MemStore,
                                      ObjectId, Transaction)
    from ceph_tpu_torch.store.blockstore import BlockStore
    from ceph_tpu_torch.store.kstore import KStore
    on_card = dev.type == "cuda"
    if on_card:
        check(native.available(), "the native library did not build, so "
              "the stores' crc32c would take its pure-Python path")
    n_obj, width = len(objects), K + M
    mib = n_obj * len(objects[0]) / 1e6
    names = [f"rbd_data.smoke.{i:016x}" for i in range(n_obj)]
    walls, out = {}, {}
    t_phase = t0 = time.perf_counter()
    want = cpu_chunk_digests(objects)
    cpu_s = time.perf_counter() - t0
    want_of = {(names[i], s): w for i, ws in enumerate(want)
               for s, w in enumerate(ws)}

    # 1. place: one D1 launch for every name
    m = store_osdmap()
    ck.crush_map_launches = 0
    with device_timer(torch, ck, "crush_map", on_card) as d1_events:
        t0 = time.perf_counter()
        placed = m.map_objects_batch(STORE_POOL, names, engine=engine,
                                     device=dev)
        walls["place"] = time.perf_counter() - t0
    out["d1_launches"] = ck.crush_map_launches
    out["d1_ms"] = events_ms(torch, d1_events)
    if on_card:
        check(out["d1_launches"] == 1 == len(d1_events),
              f"placement: {out['d1_launches']} crush_map launches")
    for pg, acting, _ in placed:
        check(len(acting) == width and len(set(acting)) == width
              and all(0 <= o < STORE_OSDS for o in acting),
              f"{pg}: acting {acting} is not {width} distinct OSDs")
    print(f"phase store place: {n_obj} names -> {len({p for p, _, _ in placed})}"
          f" of {STORE_PG_NUM} PGs on {STORE_OSDS} OSDs in one map_objects_batch "
          f"(engine {engine}): {walls['place']:.4f} s, crush_map launches "
          f"{out['d1_launches']}, wrapper span {out['d1_ms']:.4f} ms (CUDA "
          f"events around the call, host work included); card {smi}")

    def cid(pg, shard):
        return CollectionId.pg(STORE_POOL, pg.seed, shard)

    def oid(i, shard):
        return ObjectId(names[i], pool=STORE_POOL, shard=shard)

    # 2. encode through the queue: K1
    codec = factory("rs", {"k": str(K), "m": str(M)}, device=dev)
    split = [codec.split_data(o) for o in objects]
    gen = gf256.rs_vandermonde_matrix(K, M)
    mode = "on" if on_card else "force"

    async def through_queue(jobs):
        q = ECBatchQueue(Context("osd.0"), device=dev, mode=mode)
        try:
            kernel.gf_apply_launches = 0
            t = time.perf_counter()
            res = await asyncio.gather(*[q.apply(mat, d) for mat, d in jobs])
            return (res, time.perf_counter() - t, kernel.gf_apply_launches,
                    q.perf.dump())
        finally:
            await q.stop()

    def queue_step(label, jobs):
        with device_timer(torch, kernel, "gf_apply", on_card) as events:
            res, wall, launches, qperf = asyncio.run(through_queue(jobs))
        check(qperf["host_requests"] == 0,
              f"{label}: {qperf['host_requests']} requests took the host "
              f"path")
        if on_card:
            check(launches > 0 and launches == qperf["device_launches"]
                  == len(events),
                  f"{label}: gf_apply launches {launches}, queue "
                  f"device_launches {qperf['device_launches']}, timed "
                  f"{len(events)}")
        walls[label] = wall
        out[f"{label}_launches"] = launches
        out[f"{label}_ms"] = events_ms(torch, events)
        return res

    parity = queue_step("encode", [(gen[K:], s) for s in split])
    chunks = [[row.tobytes() for row in (*s, *p)]
              for s, p in zip(split, parity)]
    del split, parity
    print(f"phase store encode: {n_obj} x {len(objects[0]) >> 10} KiB -> "
          f"{n_obj * width} chunks of {len(chunks[0][0]) >> 10} KiB through "
          f"ECBatchQueue on {dev}: {walls['encode']:.4f} s, "
          f"{mib / walls['encode']:.1f} MB/s of object data, gf_apply "
          f"launches {out['encode_launches']}, wrapper spans "
          f"{out['encode_ms']:.4f} ms (CUDA events around each call); CPU codec's sha256s "
          f"in {cpu_s:.2f} s; card {smi}")

    def expected(share):
        return {(c.name, o.name, o.shard) for _, c, o, _ in share}

    def listing(s):
        return {(c.name, o.name, o.shard) for c in s.list_collections()
                for o in s.collection_list(c)}

    def mkcolls(s, share):
        t = Transaction()
        for c in sorted({c for _, c, _, _ in share}, key=lambda c: c.name):
            t.create_collection(c)
        s.apply_transaction(t)

    def read_back(stores, items):
        t = time.perf_counter()
        bad = [(c, o) for w, c, o, _ in items
               if hashlib.sha256(stores[w].read(c, o)).digest()
               != want_of[o.name, o.shard]]
        wall = time.perf_counter() - t
        check(not bad, f"{len(bad)} chunks read back differ from the CPU "
                       f"codec's, first {bad[:3]}")
        return wall

    def counters_since(now, before):
        return {k: v - before.get(k, 0) if k in COUNTS else v
                for k, v in now.items()}

    def counters_line(c):
        if not c:
            return "no commit thread (each call returns after its fsync)"
        return (f"batches {c.get('commit_batches', 0)}, txns "
                f"{c.get('txns', 0)}, fsyncs {c.get('fsyncs', 0)}, fsyncs "
                f"saved {c.get('fsyncs_saved', 0)}")

    # 3. store: every chunk on its OSD's BlockStore
    items = [(osd, cid(pg, s), oid(i, s), chunks[i][s])
             for i, (pg, acting, _) in enumerate(placed)
             for s, osd in enumerate(acting)]
    stored_mb = sum(len(it[3]) for it in items) / 1e6
    paths = [os.path.join(tmpdir, f"osd.{o}") for o in range(STORE_OSDS)]
    stores = []
    with CommitErrors() as errors:
        try:
            for path in paths:
                stores.append(BlockStore(path, csum_type="crc32c"))
                stores[-1].mkfs()
                stores[-1].mount()
            for o, s in enumerate(stores):
                mkcolls(s, [it for it in items if it[0] == o])
            base = [s.commit_counters() for s in stores]
            applied, walls["store"] = asyncio.run(commit_all(stores, items))
            errors.check("store")
            print(f"phase store write: {len(items)} chunks ({stored_mb:.1f} "
                  f"MB) into {STORE_OSDS} BlockStores (crc32c) through "
                  f"queue_transactions with on_commit: applied in "
                  f"{applied:.4f} s, all committed in {walls['store']:.4f} s"
                  f", {stored_mb / walls['store']:.1f} MB/s (host clock); "
                  f"card {smi}")
            out["counters"] = [counters_since(s.commit_counters(), b)
                               for s, b in zip(stores, base)]
            for o, c in enumerate(out["counters"]):
                print(f"  osd.{o}: {sum(it[0] == o for it in items)} chunks;"
                      f" {counters_line(c)}; txns per batch "
                      f"{c.get('txns_per_batch', 0):.2f}, gather window "
                      f"{c.get('gather_window_ms', 0)} ms")

            # 4. remount every store and read every chunk back
            out["mount_s"] = []
            for o, path in enumerate(paths):
                stores[o].umount()
                t = time.perf_counter()
                stores[o] = BlockStore(path, csum_type="crc32c")
                stores[o].mount()
                out["mount_s"].append(time.perf_counter() - t)
            for o, s in enumerate(stores):
                share = [it for it in items if it[0] == o]
                check(listing(s) == expected(share),
                      f"osd.{o}: chunks missing or extra after the remount")
            walls["read"] = read_back(stores, items)
            print(f"phase store remount: {STORE_OSDS} BlockStores mounted in "
                  f"{sum(out['mount_s']):.4f} s (osd.0-{STORE_OSDS - 1}: "
                  f"{', '.join(f'{x:.4f}' for x in out['mount_s'])} s); "
                  f"{len(items)} chunks read back in {walls['read']:.4f} s, "
                  f"{stored_mb / walls['read']:.1f} MB/s, each equal to the "
                  f"CPU codec's (host clock); card {smi}")

            # 5. lose the two OSDs that hold two data chunks of the most
            # objects together; rebuild those chunks from the others
            def both(a, b):
                return sum(a in act[:K] and b in act[:K]
                           for _, act, _ in placed)
            lost = max(((a, b) for a in range(STORE_OSDS)
                        for b in range(a + 1, STORE_OSDS)),
                       key=lambda p: (both(*p), -p[0], -p[1]))
            out["lost"] = list(lost)
            out["objects_losing_two_data"] = both(*lost)
            check(out["objects_losing_two_data"] > 0,
                  "no two OSDs hold two data chunks of one object")
            for o in lost:
                stores[o].umount()
            t = time.perf_counter()
            jobs, wants = [], []
            for i, (pg, acting, _) in enumerate(placed):
                present = [s for s in range(width)
                           if acting[s] not in lost][:K]
                gone = [s for s in range(K) if acting[s] in lost]
                rows = np.stack([np.frombuffer(
                    stores[acting[s]].read(cid(pg, s), oid(i, s)),
                    dtype=np.uint8) for s in present])
                if gone:
                    jobs.append((codec.decode_matrix_for(present, gone),
                                 rows))
                    wants.append([want[i][s] for s in gone])
            walls["rebuild_read"] = time.perf_counter() - t
            rebuilt = queue_step("rebuild", jobs)
            bad = sum(hashlib.sha256(row.tobytes()).digest() != w
                      for res, ws in zip(rebuilt, wants)
                      for row, w in zip(res, ws))
            check(bad == 0, f"{bad} rebuilt chunks differ from the CPU "
                            f"codec's")
            n_lost = sum(len(ws) for ws in wants)
            print(f"phase store rebuild: osd.{lost[0]} and osd.{lost[1]} "
                  f"lost; {n_obj * K} chunks read from the other stores in "
                  f"{walls['rebuild_read']:.4f} s; {n_lost} lost data chunks"
                  f" of {len(jobs)} objects ({out['objects_losing_two_data']}"
                  f" lost two) rebuilt through ECBatchQueue in "
                  f"{walls['rebuild']:.4f} s, gf_apply launches "
                  f"{out['rebuild_launches']}, wrapper spans "
                  f"{out['rebuild_ms']:.4f} ms (CUDA events around each call), each equal to "
                  f"the CPU codec's; card {smi}")
            errors.check("rebuild")
        finally:
            for s in stores:
                if s.mounted:
                    s.umount()

        # 6. OSD 0's chunks through the other backends and compression
        share = [(0, c, o, d) for w, c, o, d in items if w == 0]
        check(share, "osd.0 holds no chunk")
        share_mb = sum(len(it[3]) for it in share) / 1e6
        kinds = {"kstore": KStore, "filestore": FileStore,
                 "memstore": MemStore,
                 "blockstore zlib": lambda p: BlockStore(
                     p, compression="zlib", csum_type="crc32c")}
        out["share"] = {}
        for label, make in kinds.items():
            path = os.path.join(tmpdir, "osd.0-" + label.replace(" ", "-"))
            s = make(path)
            s.mkfs()
            s.mount()
            try:
                mkcolls(s, share)
                base = s.commit_counters()
                applied, wall = asyncio.run(commit_all([s], share))
                errors.check(label)
                counters = counters_since(s.commit_counters(), base)
                s.umount()
                t = time.perf_counter()
                if label != "memstore":
                    s = make(path)      # a fresh instance reads the disk
                s.mount()
                mount = time.perf_counter() - t
                check(listing(s) == expected(share),
                      f"{label}: chunks missing or extra after the remount")
                read = read_back([s], share)
                tagged = None
                if label == "blockstore zlib":
                    tagged = sum(bool(e.alg) for _, c, o, _ in share
                                 for e in s._get_onode(c, o).extents)
                    check(tagged == 0, f"{label}: {tagged} extents of EC "
                                       f"chunks stored compressed")
            finally:
                s.umount()
            out["share"][label] = {"write_s": wall, "mount_s": mount,
                                   "read_s": read, "counters": counters,
                                   "compressed_extents": tagged}
            print(f"phase store osd.0 on {label}: {len(share)} chunks "
                  f"({share_mb:.1f} MB) committed in {wall:.4f} s "
                  f"({share_mb / wall:.1f} MB/s), {counters_line(counters)};"
                  f" mounted in {mount:.4f} s; read back in {read:.4f} s "
                  f"({share_mb / read:.1f} MB/s), each equal to the CPU "
                  f"codec's"
                  + ("" if tagged is None else
                     f"; extents with a compression tag: {tagged}")
                  + f" (host clock); card {smi}")
    out["walls"] = walls
    out["phase_s"] = time.perf_counter() - t_phase
    kernel_ms = out["d1_ms"] + out["encode_ms"] + out["rebuild_ms"]
    print(f"phase store: {out['phase_s']:.3f} s in all (host clock); "
          f"crush_map and gf_apply wrapper spans {kernel_ms:.4f} ms "
          f"(host work included), {kernel_ms / 10 / out['phase_s']:.4f} % "
          f"of it; card {smi}")
    return out


# Cut from the defaults: the mon timers of tests/test_mon.py's FAST_CFG
# (at the defaults one election waits 5 s) and the messenger's reconnect
# backoff (FAST_CFG's start, capped at 0.1 s).  A mon restarted after a
# few seconds down hears its peers only when their reconnect backoff has
# run out (seconds, at the defaults), past the 0.3 s election timeout;
# the reference's elector then lets a deferring peer declare a victory
# from its stale ack set, at an epoch that makes the restarted mon's
# proposals stale, and the mon never rejoins.
MON_CFG = {"mon_election_timeout": 0.3, "mon_lease": 1.0,
           "mon_tick_interval": 0.5, "ms_initial_backoff": 0.02,
           "ms_max_backoff": 0.1}
MON_NAMES = ("a", "b", "c")
MON_OSDS, MON_PER_HOST = 1024, 8        # phase 7's cluster: 128 hosts x 8
# Ceph's ~100 PGs per OSD over the pool size, down to a power of two:
# 1024 x 100 / 3 -> 32768 and 1024 x 100 / 12 -> 8192
MON_REP_PGS, MON_EC_PGS, MON_EC_GROWN = 32768, 8192, 16384
MON_WAIT_S = 120.0     # bound on each wait for the quorum or a map
#: crush_map launches by step: the names, the two pools, the names again
#: after three OSDs go down and out, the two pools again for the
#: reweight census
MON_D1_LAUNCHES = {"place": 1, "pools": 2, "re-place": 1, "census": 2}


class MonErrors:
    """Records what the mons log at ERROR (a dispatch or a command that
    raised, a failed tick)."""

    def __init__(self):
        import logging
        self.records = []
        self.handler = logging.Handler(logging.ERROR)
        self.handler.emit = self.records.append
        self.roots = []

    def watch(self, ctx):
        ctx.log.root.addHandler(self.handler)
        self.roots.append(ctx.log.root)

    def close(self):
        for root in self.roots:
            root.removeHandler(self.handler)

    def check(self, where):
        check(not self.records, f"{where}: a mon logged "
                                f"{[r.getMessage() for r in self.records]}")


def fs_type(path):
    """The type of the filesystem under ``path`` (``stat -f``)."""
    try:
        return subprocess.run(["stat", "-f", "-c", "%T", path],
                              capture_output=True, text=True, timeout=10,
                              check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def mon_store_values(mon):
    """Every committed value a mon stores: the paxos versions and the
    services' keys (the paxos bookkeeping, such as accepted_pn, is each
    mon's own)."""
    out = {}
    for prefix in ("osdmap", "config-key", "auth", "fsmap"):
        for k in mon.store.keys(prefix):
            out[prefix, bytes(k)] = mon.store.get(prefix, k)
    for v in range(mon.paxos.first_committed,
                   mon.paxos.last_committed + 1):
        out["paxos", v] = mon.paxos.get_version(v)
    return out


def mon_phase(np, kernel, dev, smi, objects, tmpdir, engine="device",
              osds=MON_OSDS, per_host=MON_PER_HOST, rep_pgs=MON_REP_PGS,
              ec_pgs=MON_EC_PGS, ec_grown=MON_EC_GROWN):
    """A 3-mon quorum's OSDMap through D1 placement and K1 rebuild.

    Three port Monitors (each with its FileDB under ``tmpdir``) elect a
    leader; an admin MonClient builds the cluster through commands
    (``osd crush build-simple``, one MOSDBoot per OSD from one messenger
    per host, an RS k=8 m=4 profile, a replicated size-3 pool and an EC
    pool); one ``config-key set`` per object times the commit; a second
    MonClient subscribes to the osdmap through mon c and its map must
    equal each mon's stored full map.  On that map D1 places the
    objects' names (one launch) and maps both pools (one launch each),
    every row equal to the host engine's; K1 encodes the objects through
    ECBatchQueue; the three OSDs that hold the most shards are reported
    failed and marked out, D1 places the names again (only their
    positions move) and K1 rebuilds every moved shard, each equal to the
    CPU codec's chunk.  Then the mon's own sweeps (pg_num growth and
    reweight-by-utilization, on the host engine: no launch), whose
    avg_pgs must equal the mean of the subscriber's D1 census; last the
    leader's shutdown (a new leader commits, the subscriber gets the next
    map from mon c) and its restart from its FileDB (back in quorum with
    equal stored values)."""
    import hashlib

    import torch

    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.ec import factory, gf256
    from ceph_tpu_torch.mon import CommandError, Monitor, MonClient, MonMap
    from ceph_tpu_torch.mon.messages import MOSDBoot, MOSDFailure, MOSDMap
    from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
    from ceph_tpu_torch.msg.types import EntityName
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.store.kv import FileDB
    on_card = dev.type == "cuda"
    n_obj, width = len(objects), K + M
    hosts = osds // per_host
    names = [f"rbd_data.mon.{i:016x}" for i in range(n_obj)]
    walls, spans = {}, {}
    out = {"cut": dict(MON_CFG), "osds": osds, "hosts": hosts,
           "d1_launches": {}, "k1_launches": {}}
    errors = MonErrors()
    t_phase = t0 = time.perf_counter()
    want = cpu_chunk_digests(objects)
    walls["cpu_digests"] = time.perf_counter() - t0
    codec = factory("rs", {"k": str(K), "m": str(M)}, device=dev)
    gen = gf256.rs_vandermonde_matrix(K, M)
    mode = "on" if on_card else "force"

    def ctx_of(name):
        ctx = Context(name)
        for k, v in MON_CFG.items():
            ctx.config.set(k, v)
        return ctx

    async def command(client, cmd):
        try:
            return await client.command(cmd, timeout=MON_WAIT_S)
        except CommandError as e:
            raise SmokeFailure(f"{cmd['prefix']}: rc {e.retcode} "
                               f"{e.outs}") from None

    async def wait(cond, what):
        deadline = time.perf_counter() + MON_WAIT_S
        while not cond():
            check(time.perf_counter() < deadline,
                  f"{what}: not after {MON_WAIT_S} s")
            await asyncio.sleep(0.01)

    def leader_of(mons, size=3):
        live = [m for m in mons if m.running and m.is_leader()
                and m.paxos.state == "active" and len(m.quorum) == size]
        return live[0] if len(live) == 1 else None

    def settled(mons):
        """One active leader, every peon holding a lease from it (so its
        lease timer runs), all at one version."""
        leader = leader_of(mons, len(mons))
        return (leader is not None
                and all(x.paxos.is_readable() for x in mons)
                and len({x.paxos.last_committed for x in mons}) == 1
                and len({x.election_epoch for x in mons}) == 1)

    async def stable(mons, what):
        """Wait until ``settled`` has held, with one leader and one
        election epoch, for 2 x mon_lease + mon_election_timeout: no
        lease timeout or election is then still on its way.  Returns the
        seconds to the start of that window."""
        hold = 2 * MON_CFG["mon_lease"] + MON_CFG["mon_election_timeout"]
        t0 = time.perf_counter()
        deadline, since, state = t0 + MON_WAIT_S, None, None
        while True:
            now = time.perf_counter()
            leader = leader_of(mons, len(mons))
            cur = (leader.name, leader.election_epoch) \
                if leader is not None and settled(mons) else None
            if cur is None or cur != state:
                since, state = (now if cur else None), cur
            elif now - since >= hold:
                return since - t0
            check(now < deadline, f"{what}: no stable quorum after "
                                  f"{MON_WAIT_S} s")
            await asyncio.sleep(0.01)

    def off_loop(fn, *args):
        """Host work of the client side (a whole-pool mapping, a
        comparison, sha256s) runs on a worker thread: the three mons share
        this event loop, and a second's stall there outlasts their lease
        (2 x mon_lease) and starts an election."""
        return asyncio.to_thread(fn, *args)

    async def d1(label, fn):
        """One step of D1: its launches counted from 0, each wrapper call
        timed by CUDA events."""
        ck.crush_map_launches = 0
        with device_timer(torch, ck, "crush_map", on_card) as events:
            t = time.perf_counter()
            res = await off_loop(fn)
            walls[label] = time.perf_counter() - t
        out["d1_launches"][label] = ck.crush_map_launches
        spans[label] = events_ms(torch, events)
        if on_card:
            check(ck.crush_map_launches == MON_D1_LAUNCHES[label]
                  == len(events),
                  f"{label}: {ck.crush_map_launches} crush_map launches, "
                  f"{MON_D1_LAUNCHES[label]} stated")
        return res

    async def k1(label, jobs):
        """One step of K1 through ECBatchQueue: launches counted from 0,
        each wrapper call timed."""
        q = ECBatchQueue(Context("osd.0"), device=dev, mode=mode)
        try:
            with device_timer(torch, kernel, "gf_apply", on_card) as events:
                kernel.gf_apply_launches = 0
                t = time.perf_counter()
                res = await asyncio.gather(*[q.apply(mat, d)
                                             for mat, d in jobs])
                walls[label] = time.perf_counter() - t
                launches = kernel.gf_apply_launches
            qperf = q.perf.dump()
        finally:
            await q.stop()
        check(qperf["host_requests"] == 0, f"{label}: "
              f"{qperf['host_requests']} requests took the host path")
        if on_card:
            check(launches > 0 and launches == qperf["device_launches"]
                  == len(events),
                  f"{label}: gf_apply launches {launches}, queue "
                  f"device_launches {qperf['device_launches']}, timed "
                  f"{len(events)}")
        out["k1_launches"][label] = launches
        spans[label] = events_ms(torch, events)
        return res

    async def run():
        mons, msgrs, clients = [], [], []
        paths = {n: os.path.join(tmpdir, f"mon.{n}") for n in MON_NAMES}
        try:
            # 1. quorum
            t = time.perf_counter()
            bound = []
            for n in MON_NAMES:
                ctx = ctx_of(f"mon.{n}")
                errors.watch(ctx)
                msgr = Messenger(ctx, EntityName("mon", n))
                bound.append((ctx, n, msgr, await msgr.bind("127.0.0.1")))
            monmap = MonMap()
            monmap.fsid = "chip-smoke-mon"
            for _, n, _, addr in bound:
                monmap.add(n, addr)
            blob = monmap.to_bytes()
            for ctx, n, msgr, _ in bound:
                mons.append(Monitor(ctx, n, MonMap.from_bytes(blob),
                                    FileDB(paths[n]), msgr))
                await mons[-1].start()
            await wait(lambda: leader_of(mons) is not None, "election")
            leader = leader_of(mons)
            walls["election"] = time.perf_counter() - t
            print(f"phase mon quorum: mons {', '.join(MON_NAMES)} on "
                  f"127.0.0.1, leader mon.{leader.name} active in "
                  f"{walls['election']:.4f} s (election epoch "
                  f"{leader.election_epoch}); config cut from the defaults:"
                  f" {MON_CFG}, auth_supported none (host clock)")

            async def client_of(name, rank=0, dispatcher=None):
                ctx = ctx_of(name)
                type_, _, id_ = name.partition(".")
                msgr = Messenger(ctx, EntityName(type_, id_))
                if dispatcher is not None:
                    msgr.add_dispatcher(dispatcher)   # ahead of the client
                await msgr.bind("127.0.0.1")
                msgrs.append(msgr)
                c = MonClient(ctx, msgr, MonMap.from_bytes(blob))
                c.cur_mon = rank
                clients.append(c)
                return c

            # 2. the cluster through commands and a boot storm
            admin = await client_of("client.admin")
            await command(admin, {"prefix": "osd crush build-simple",
                                  "num_osds": osds,
                                  "osds_per_host": per_host})
            e0 = leader.osdmon.osdmap.epoch
            host_msgrs = []
            for h in range(hosts):
                first = h * per_host
                msgr = Messenger(ctx_of(f"osd.{first}"),
                                 EntityName("osd", str(first)))
                await msgr.bind("127.0.0.1")
                msgrs.append(msgr)
                host_msgrs.append(msgr)
            t = time.perf_counter()
            for h, msgr in enumerate(host_msgrs):
                for o in range(h * per_host, (h + 1) * per_host):
                    msgr.send_message(MOSDBoot(o, msgr.addr),
                                      leader.messenger.addr,
                                      peer_type="mon")
            await wait(lambda: leader.osdmon.osdmap.count_up() == osds,
                       "boot storm")
            walls["boot"] = time.perf_counter() - t
            out["boot_epochs"] = leader.osdmon.osdmap.epoch - e0
            print(f"phase mon boot: {osds} MOSDBoots from {hosts} host "
                  f"messengers, all up in {walls['boot']:.4f} s over "
                  f"{out['boot_epochs']} osdmap epochs (e{e0} -> "
                  f"e{leader.osdmon.osdmap.epoch}; host clock)")
            t = time.perf_counter()
            acks = [await command(admin, c) for c in (
                {"prefix": "osd erasure-code-profile set", "name": "rs84",
                 "profile": {"k": str(K), "m": str(M)}},
                {"prefix": "osd pool create", "pool": "rbd",
                 "pg_num": rep_pgs, "size": 3},
                {"prefix": "osd pool create", "pool": "ec84",
                 "pg_num": ec_pgs, "pool_type": "erasure",
                 "erasure_code_profile": "rs84"})]
            walls["pools_create"] = time.perf_counter() - t
            osdmap = leader.osdmon.osdmap
            rep, ec = osdmap.lookup_pool("rbd"), osdmap.lookup_pool("ec84")
            check(rep >= 0 and ec >= 0 and osdmap.pools[ec].size == width,
                  f"pools: {[a.outs for a in acks]}")
            print(f"phase mon pools: profile rs84 (k={K} m={M}), pool rbd "
                  f"(replicated size 3, {rep_pgs} PGs) and ec84 (erasure, "
                  f"{ec_pgs} PGs) committed in "
                  f"{walls['pools_create']:.4f} s; osdmap e{osdmap.epoch}, "
                  f"full map {len(osdmap.to_bytes())} bytes (host clock)")

            # 3. commit latency: one paxos round per command
            lat = []
            for i, name in enumerate(names):
                val = hashlib.sha256(objects[i]).hexdigest()
                t = time.perf_counter()
                await command(admin, {"prefix": "config-key set",
                                      "key": name, "val": val})
                lat.append(time.perf_counter() - t)
            p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
            out["commit_s"] = {"p50": p50, "p99": p99, "max": max(lat),
                               "n": len(lat)}
            out["fs_type"] = fs_type(tmpdir)
            print(f"phase mon commit: {len(lat)} config-key set, one at a "
                  f"time: p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms, "
                  f"max {max(lat) * 1e3:.3f} ms (host clock); the FileDBs "
                  f"are on {out['fs_type']}")

            # 4. a subscriber through mon c; its map equals every store's
            seen = []

            class MapSeen(Dispatcher):
                def ms_dispatch(self, m):
                    if isinstance(m, MOSDMap):
                        seen.append((str(m.src_name), sorted(m.fulls),
                                     sorted(m.incrementals)))
                    return False

            sub = await client_of("client.sub", 2, MapSeen())
            t = time.perf_counter()
            sub.sub_want("osdmap", 0)
            await sub.wait_for_osdmap(timeout=MON_WAIT_S)
            await wait(lambda: sub.osdmap.epoch
                       == leader.osdmon.osdmap.epoch, "subscriber map")
            walls["subscribe"] = time.perf_counter() - t
            e = sub.osdmap.epoch
            await wait(lambda: all(x.osdmon.osdmap.epoch >= e
                                   for x in mons), "peons' maps")
            mine = sub.osdmap.to_bytes()
            for x in mons:
                check(x.store_get("osdmap", f"full_{e}") == mine,
                      f"the subscriber's e{e} differs from mon.{x.name}'s "
                      f"stored full_{e}")
            print(f"phase mon subscribe: client.sub on mon.c has e{e} in "
                  f"{walls['subscribe']:.4f} s; its {len(mine)} bytes equal "
                  f"full_{e} in the stores of mon.a, mon.b and mon.c")

            # 5. D1 on the subscriber's map, held against the host engine
            m = sub.osdmap
            placed = await d1("place", lambda: m.map_objects_batch(
                ec, names, engine=engine, device=dev))
            check(placed == await off_loop(lambda: OSDMap.from_bytes(
                mine).map_objects_batch(ec, names, engine="host")),
                "place: D1 differs from the host engine")
            for _, acting, _ in placed:
                check(len(acting) == width and len(set(acting)) == width
                      and all(0 <= o < osds for o in acting),
                      f"acting {acting} is not {width} distinct OSDs")

            def both_pools(mp):
                return {p: mp.map_pgs_batch(p, engine=engine, device=dev)
                        for p in (rep, ec)}

            def host_pools(mp):
                hm = OSDMap.from_bytes(mp.to_bytes())
                return {p: hm.map_pgs_batch(p, engine="host")
                        for p in (rep, ec)}

            pools = await d1("pools", lambda: both_pools(m))
            check(pools == await off_loop(host_pools, m),
                  "pools: D1 differs from host")
            print(f"phase mon place: {n_obj} names in one map_objects_batch"
                  f" and pools {rep} ({rep_pgs} PGs) and {ec} ({ec_pgs} PGs)"
                  f" in one map_pgs_batch each (engine {engine}): "
                  f"{walls['place']:.4f} s and {walls['pools']:.4f} s, "
                  f"crush_map launches {out['d1_launches']}, wrapper spans "
                  f"{spans['place']:.4f} and {spans['pools']:.4f} ms (CUDA "
                  f"events around each call, host work included); every "
                  f"row equals the host engine's; card {smi}")

            # 6. K1 encodes the objects
            split = [codec.split_data(o) for o in objects]
            parity = await k1("encode", [(gen[K:], s) for s in split])
            chunks = [np.concatenate([s, p]) for s, p in zip(split, parity)]
            del split, parity
            bad = await off_loop(lambda: sum(
                hashlib.sha256(c[s].tobytes()).digest() != want[i][s]
                for i, c in enumerate(chunks) for s in range(width)))
            check(bad == 0, f"encode: {bad} chunks differ from the CPU "
                            f"codec's")
            print(f"phase mon encode: {n_obj} x {len(objects[0]) >> 10} KiB"
                  f" through ECBatchQueue on {dev} in {walls['encode']:.4f} "
                  f"s, gf_apply launches {out['k1_launches']['encode']}, "
                  f"wrapper spans {spans['encode']:.4f} ms; every chunk "
                  f"equals the CPU codec's; card {smi}")

            # 7. the three OSDs with the most shards go down and out
            load = {}
            for _, acting, _ in placed:
                for o in acting:
                    load[o] = load.get(o, 0) + 1
            lost = sorted(sorted(load, key=lambda o: (-load[o], o))[:3])
            out["lost"] = {o: load[o] for o in lost}
            reporter = next(h for h in range(hosts)
                            if all(o // per_host != h for o in lost))
            t = time.perf_counter()
            for o in lost:
                host_msgrs[reporter].send_message(
                    MOSDFailure(target_osd=o, epoch=sub.osdmap.epoch),
                    leader.messenger.addr, peer_type="mon")
            for o in lost:
                await command(admin, {"prefix": "osd out", "id": o})
            await wait(lambda: all(not sub.osdmap.is_up(o)
                                   and not sub.osdmap.is_in(o)
                                   for o in lost), "down and out")
            walls["down_out"] = time.perf_counter() - t
            e_out = sub.osdmap.epoch
            replaced = await d1("re-place", lambda: m.map_objects_batch(
                ec, names, engine=engine, device=dev))
            check(replaced == await off_loop(lambda: OSDMap.from_bytes(
                m.to_bytes()).map_objects_batch(ec, names, engine="host")),
                "re-place: D1 differs from the host engine")
            jobs, wants, moved = [], [], 0
            for i, ((_, old, _), (_, new, _)) in enumerate(
                    zip(placed, replaced)):
                gone = [s for s in range(width) if old[s] in lost]
                for s in range(width):
                    if s in gone:
                        check(new[s] not in lost and new[s] >= 0,
                              f"{names[i]}: shard {s} on {new[s]}")
                    else:
                        check(new[s] == old[s], f"{names[i]}: shard {s} "
                              f"moved {old[s]} -> {new[s]}, not from a "
                              f"lost OSD")
                if gone:
                    present = [s for s in range(width) if s not in gone][:K]
                    jobs.append((codec.decode_matrix_for(present, gone),
                                 chunks[i][present]))
                    wants.append([want[i][s] for s in gone])
                    moved += len(gone)
            check(jobs, "no shard sat on the three OSDs")
            rebuilt = await k1("rebuild", jobs)
            bad = sum(hashlib.sha256(row.tobytes()).digest() != w
                      for res, ws in zip(rebuilt, wants)
                      for row, w in zip(res, ws))
            check(bad == 0, f"{bad} rebuilt shards differ from the CPU "
                            f"codec's")
            out["moved_shards"] = moved
            print(f"phase mon down_out: osd {lost} ({out['lost']} shards) "
                  f"reported failed by osd.{reporter * per_host}'s host and "
                  f"marked out; the subscriber has them down and out at "
                  f"e{e_out} in {walls['down_out']:.4f} s (host clock); D1 "
                  f"re-placed the names in {walls['re-place']:.4f} s, "
                  f"launches {out['d1_launches']['re-place']}: only their "
                  f"{moved} positions moved; K1 rebuilt the {moved} shards "
                  f"of {len(jobs)} objects in {walls['rebuild']:.4f} s, "
                  f"gf_apply launches {out['k1_launches']['rebuild']}, "
                  f"wrapper spans {spans['rebuild']:.4f} ms, each equal to "
                  f"the CPU codec's; card {smi}")

            # 8. the mon's own sweeps (host engine) against D1's census
            ck.crush_map_launches = 0
            t = time.perf_counter()
            await command(admin, {"prefix": "osd pool set", "pool": "ec84",
                                  "var": "pg_num", "val": ec_grown})
            walls["pg_num"] = time.perf_counter() - t
            check(ck.crush_map_launches == 0,
                  "the pg_num sweep launched crush_map")
            e_grown = leader.osdmon.osdmap.epoch
            await wait(lambda: sub.osdmap.epoch >= e_grown, "grown map")
            check(sub.osdmap.pools[ec].pg_num == ec_grown, "pg_num")
            census = await d1("census", lambda: both_pools(sub.osdmap))
            check(census == await off_loop(host_pools, sub.osdmap),
                  "census: D1 differs from host")
            per_osd = {}
            for rows in census.values():
                for _pg, _up, _upp, acting, _actp in rows:
                    for o in acting:
                        if o >= 0:
                            per_osd[o] = per_osd.get(o, 0) + 1
            avg = sum(per_osd.values()) / len(per_osd)
            ck.crush_map_launches = 0
            t = time.perf_counter()
            ack = await command(admin,
                                {"prefix": "osd reweight-by-utilization"})
            walls["reweight"] = time.perf_counter() - t
            check(ck.crush_map_launches == 0,
                  "the reweight sweep launched crush_map")
            reply = json.loads(ack.outs)
            check(reply["avg_pgs"] == avg, f"reweight avg_pgs "
                  f"{reply['avg_pgs']} != the census's {avg}")
            out["sweeps"] = {"avg_pgs": avg,
                             "reweighted": len(reply["reweighted"])}
            print(f"phase mon sweeps: osd pool set ec84 pg_num {ec_grown} "
                  f"in {walls['pg_num']:.4f} s and osd "
                  f"reweight-by-utilization in {walls['reweight']:.4f} s "
                  f"(the mon's host engine, no launch; host clock); "
                  f"avg_pgs {avg} equals the mean of the subscriber's D1 "
                  f"census of both pools ({walls['census']:.4f} s, "
                  f"launches {out['d1_launches']['census']}, wrapper spans "
                  f"{spans['census']:.4f} ms); {len(reply['reweighted'])} "
                  f"OSDs reweighted; card {smi}")

            # 9. the leader fails over, then restarts from its FileDB.  A
            # stable quorum first: the reweight sweep holds the leader's
            # loop past the peons' lease, and elections that overlap a
            # shutdown or a restart can wedge the reference's elector
            # (peons left without a lease timer; a restarted mon whose
            # epoch the others drop as stale)
            t = time.perf_counter()
            await stable(mons, "before the failover")
            walls["settle"] = time.perf_counter() - t
            leader = leader_of(mons)
            e_before = sub.osdmap.epoch
            seen.clear()
            old = leader
            t = time.perf_counter()
            await old.shutdown()
            rest = [x for x in mons if x is not old]
            await wait(lambda: leader_of(rest, 2) is not None, "failover")
            walls["failover_leader"] = time.perf_counter() - t
            leader = leader_of(rest, 2)
            await command(admin, {"prefix": "config-key set",
                                  "key": "failover", "val": "1"})
            walls["failover_commit"] = time.perf_counter() - t
            for o in lost:      # the OSDs come back: the next map
                h = host_msgrs[o // per_host]
                h.send_message(MOSDBoot(o, h.addr), leader.messenger.addr,
                               peer_type="mon")
            await wait(lambda: all(sub.osdmap.is_up(o) for o in lost),
                       "the next map through mon c")
            check(sub.osdmap.epoch > e_before and seen
                  and all(src == "mon.c" for src, _, _ in seen),
                  f"the subscriber's next maps came from {seen}")
            print(f"phase mon failover: after {walls['settle']:.4f} s "
                  f"waiting for a quorum that holds for 2 x mon_lease + the"
                  f" election timeout, mon.{old.name} shut down; "
                  f"mon.{leader.name} leads after "
                  f"{walls['failover_leader']:.4f} s, a config-key set "
                  f"commits after {walls['failover_commit']:.4f} s; the "
                  f"subscriber got e{e_before + 1}-e{sub.osdmap.epoch} from"
                  f" mon.c (host clock)")
            t = time.perf_counter()
            ctx = ctx_of(f"mon.{old.name}")
            errors.watch(ctx)
            back = Monitor(ctx, old.name, MonMap.from_bytes(blob),
                           FileDB(paths[old.name]),
                           Messenger(ctx, EntityName("mon", old.name)))
            await back.start()
            mons = [back, *rest]
            # seconds to back in quorum: to the start of the stable window
            walls["restart"] = time.perf_counter() - t \
                + await stable(mons, "restart")
            values = [mon_store_values(x) for x in mons]
            check(values[0] == values[1] == values[2],
                  "the mons' stored values differ after the restart")
            got = await command(admin, {"prefix": "config-key get",
                                        "key": names[-1]})
            check(got.outs == hashlib.sha256(objects[-1]).hexdigest(),
                  "config-key get after the restart")
            out["last_committed"] = back.paxos.last_committed
            print(f"phase mon restart: mon.{old.name} from its FileDB back "
                  f"in quorum in {walls['restart']:.4f} s, last_committed "
                  f"{back.paxos.last_committed} on all three and "
                  f"{len(values[0])} stored values equal (host clock)")
            errors.check("mon")
        finally:
            for c in clients:
                c.stop()
            for x in mons:
                if x.running:
                    await x.shutdown()
            for msgr in msgrs:
                await msgr.shutdown()

    try:
        asyncio.run(run())
    finally:
        errors.close()
    out["walls"] = walls
    out["spans_ms"] = spans
    out["phase_s"] = time.perf_counter() - t_phase
    kernel_ms = sum(spans.values())
    print(f"phase mon: {out['phase_s']:.3f} s in all (host clock); "
          f"crush_map launches {out['d1_launches']}, gf_apply launches "
          f"{out['k1_launches']}; their wrapper spans {kernel_ms:.4f} ms "
          f"(host work included), {kernel_ms / 10 / out['phase_s']:.4f} % "
          f"of the phase; card {smi}")
    return out


OSD_N = 16             # one OSD per host (phase 14's cluster)
# Ceph's ~100 PGs per OSD over the pool size, down to a power of two:
# 16 x 100 / 12 -> 128 and 16 x 100 / 3 -> 512
OSD_EC_PGS, OSD_REP_PGS = 128, 512
#: the cuts from the package's defaults: two shards per OSD on thread
#: lanes (16 OSDs share one process: each OSD's shards are threads with
#: event loops of their own, each with its own EC batch queue, so K1 is
#: launched from several threads at once); a 20 s heartbeat grace (in the
#: boot storm one OSD's loop waited up to 8 s for the interpreter lock,
#: past the default 6 s, and live OSDs reported each other down);
#: warnings only on stderr.  The failed OSDs are marked down and out by
#: command, so no timer paces the phase
OSD_CFG = {"osd_op_num_shards": 2, "osd_shard_lanes": "thread",
           "osd_heartbeat_grace": 20.0, "log_level": 0}
OSD_WAIT_S = 180.0     # bound on each wait for boot, clean PGs, recovery
#: stated before the phase first ran on the card: crush_map launches by
#: call site and gf_apply launches by step, (least, most)
OSD_D1_RANGES = {"objecter": (2, 12), "epoch": (150, 3000),
                 "backfill": (0, 400), "cls objecter": (0, 4),
                 "client objecter": (0, 16)}
OSD_K1_RANGES = {"encode": (8, 64), "degraded read": (1, 64),
                 "rebuild": (1, 200), "cls write": (2, 32),
                 "client cache": (1, 96)}
#: the process-lane run: the same cluster with each OSD's two shards as
#: worker processes (32 of them), each hosting its slice of the PGs in a
#: MemStore of its own and launching K1 and D1 from a CUDA context of its
#: own; each OSD's parent keeps the messenger, the mon session and the
#: maps and hosts no PGs.  Stated before the run first ran on the card:
#: crush_map launches by call site and process, gf_apply launches by step
#: (summed over the workers), and the least number of workers that
#: launch K1 at the EC write
OSD_LANE_D1_RANGES = {"objecter": (2, 12), "parent epoch": (150, 3000),
                      "lane epoch": (300, 6000), "backfill": (0, 400),
                      "cls objecter": (0, 4), "client objecter": (0, 16)}
OSD_LANE_K1_RANGES = {"encode": (8, 96), "degraded read": (8, 96),
                      "rebuild": (1, 300), "cls write": (2, 32),
                      "client cache": (1, 96)}
OSD_LANE_K1_WORKERS = 12
#: the process-lane run's cuts from the defaults beside OSD_CFG: rings and
#: extent pools sized for 4 MiB objects (the default 4 MiB ring cannot
#: carry a 4 MiB write's frame, and a full 4 MiB extent pool falls back to
#: inline frames)
OSD_LANE_CUT = {"osd_lane_ring_bytes": "16m",
                "osd_lane_extent_pool_bytes": "64m"}
#: and a quarter of the PGs: 16 parents' loops share this process's
#: interpreter and route every ring hop, and at each epoch each parent
#: primes every PG of both pools, which it does not host (the JAX
#: package's behaviour, kept), with 32 workers busy on the same 8 host
#: cores; at 128 + 512 one of eight runs on the card stalled those loops
#: past a peering query's 10 s and a worker logged "peering failed".  Cut
#: from 64 + 256 to keep the whole script within 600 s once the mesh run,
#: the model run and the client steps joined it (607 s at 64 + 256 on an
#: NVIDIA H100 80GB HBM3 at 700 W)
OSD_LANE_EC_PGS, OSD_LANE_REP_PGS = 32, 128
#: the class step, run after the replicated read on both lane backends:
#: the first OSD_CLS_REWRITES EC objects rewritten by ``[OP_CALL
#: version.inc {ver eq 0}, OP_WRITEFULL]`` vectors, all in flight (the
#: RGW object-version fence on an EC pool: K1 encodes each staged
#: write_full at its primary); an RGW bucket index of one entry per
#: replicated object, listed in pages of OSD_CLS_PAGE.  The step's
#: entries in the ranges above ("cls write", "cls objecter": the
#: Objecter's placements while the step runs) were stated before it first
#: ran on the card
OSD_CLS_REWRITES = 16
OSD_CLS_PAGE = 16
#: the client step, run after the class step on both lane backends: a
#: striped file set on the replicated pool through RadosStriper's default
#: layout (512 KiB stripe unit, 1 stripe, 4 MiB objects), all files in
#: flight, then stat, whole and window reads, a window overwrite, one file
#: truncated and one removed (the rest removed after the checks, so the
#: recovery after the out moves what it moved before); and a write-back
#: ObjectCacher (the
#: reference's defaults) over the OSD_CACHE_OBJECTS EC objects after the
#: class step's, taking OSD_CACHE_WRITES writes of OSD_CACHE_WRITE bytes
#: at seeded offsets within each object's first OSD_CACHE_WINDOW bytes,
#: then flushed: EC pools refuse partial writes, so its writer reads the
#: whole object, patches it and rewrites it (as the RBD service does for
#: EC images; K1 encodes each rewrite at its primary).  The step's entries
#: in the ranges above ("client cache": K1 at the cache's writes and
#: flush; "client objecter") were stated before it first ran on the card
OSD_CLIENT_FILES, OSD_CLIENT_FILE_BYTES = 4, 16 << 20
OSD_CACHE_OBJECTS, OSD_CACHE_WRITES = 16, 256
OSD_CACHE_WRITE, OSD_CACHE_WINDOW = 16 << 10, 128 << 10
#: the mesh-mode run (osd_mesh_mode=on): the same 16 OSDs on thread lanes
#: (process lanes refuse mesh mode) with the mesh executor installed over
#: MESH_POSITIONS positions on the card, the EC pool alone (mesh mode
#: changes only the EC path).  Stated before it first ran on the card:
#: crush_map launches by call site; the executor's launches (an object's
#: encode is one launch of one K1 with the rows of all 12 positions;
#: each recover launch one K1); the batch queues launch nothing
MESH_POSITIONS = 12
OSD_MESH_D1_RANGES = {"objecter": (1, 12), "epoch": (50, 3000),
                      "backfill": (0, 400)}
OSD_MESH_RANGES = {"encode launches": (64, 96), "encode k1": (64, 96),
                   "recover launches": (1, 400), "recover k1": (1, 400)}


def chunk_digests(objects, k, m):
    """The sha256 of each of the k + m chunks of each object, as the CPU
    codec (RS) encodes it."""
    import hashlib

    from ceph_tpu_torch.ec import factory
    cpu = factory("rs", {"k": str(k), "m": str(m)}, device="cpu")
    out = []
    for o in objects:
        ch = cpu.encode(set(range(k + m)), o)
        out.append([hashlib.sha256(ch[i].tobytes()).digest()
                    for i in range(k + m)])
    return out


class DaemonErrors(MonErrors):
    """Records what the mons, the OSDs and the client log at ERROR."""

    def check(self, where):
        check(not self.records, f"{where}: a daemon logged "
                                f"{[r.getMessage() for r in self.records]}")


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def smi_query(*args):
    """``nvidia-smi`` with ``args``: its output, or why it failed."""
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def gpu_used_mib():
    """The card's used memory in MiB, or None."""
    try:
        return float(smi_query("--query-gpu=memory.used",
                               "--format=csv,noheader,nounits").split()[0])
    except (ValueError, IndexError):
        return None


def osd_phase(np, kernel, dev, smi, objects, tmpdir, osds=OSD_N, k=K, m=M,
              ec_pgs=OSD_EC_PGS, rep_pgs=OSD_REP_PGS, queue_mode="auto",
              lanes="thread", mesh_positions=0,
              client_files=OSD_CLIENT_FILES,
              client_file_bytes=OSD_CLIENT_FILE_BYTES):
    """An RS k=8 m=4 pool on 16 port OSDs, written, read and recovered
    through the port's own daemons.

    Three port Monitors (FileDBs under ``tmpdir``) and ``osds`` port OSDs,
    one per host, each with its own crc32c BlockStore under ``tmpdir`` and
    its own messenger on 127.0.0.1 TCP, on ``dev``; the cluster is built by
    ``osd crush build-simple`` and the OSDs' own MOSDBoots.  A port
    ``Rados`` on ``dev`` makes an RS pool (failure domain host) and a
    replicated size-3 pool, writes every object into each with all of them
    in flight, reads them back (sha256), checks every EC shard in its
    acting OSD's store against the CPU codec's chunk and every replica
    against the others; then stops the two OSDs holding the most EC
    shards, marks them down (degraded reads decode through K1) and out,
    waits for every PG to be clean again and checks every rebuilt shard
    against the CPU codec's.  D1 runs at the Objecter's cork flush, at
    each OSD's epoch advance and at backfill planning; K1 at the
    primaries' encode, the degraded reads' decode and the rebuild, in the
    OSDs' EC batch queues.  Fails on an ERROR logged by any
    daemon, on a mismatch, and on launch counts outside the stated
    ranges.

    With ``lanes="process"`` each OSD's shards are worker processes that
    host every PG in stores of their own: the phase reads PG states,
    launch counts and ERROR records from the workers (``lane_state``),
    checks shards through reads (every object after the write, the
    degraded reads, every object again after recovery), counts D1 by
    process, fails if a parent launches K1 or a worker dies, and prints
    each worker's device memory.

    With ``mesh_positions`` the OSDs run in mesh mode (``osd_mesh_mode``
    on, thread lanes) with the mesh executor installed over that many
    positions on ``dev``, and only the EC pool is made (``rep_pgs`` 0):
    the primaries' encodes, degraded reads and rebuilds run as mesh
    programs (K1 launches in the executor's thread), the sub-ops reach
    co-located OSDs in process, and the batch queues must launch
    nothing.  Without it, both pools get a class step and a client step
    (a striped file set on the replicated pool, a write-back cache over
    EC objects) after the replicated read."""
    import hashlib

    import torch

    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.mon import Monitor, MonMap
    from ceph_tpu_torch.msg.messenger import Messenger
    from ceph_tpu_torch.msg.types import EntityName
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.osd import OSD
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.osd.types import ObjectLocator
    from ceph_tpu_torch.store.blockstore import BlockStore
    from ceph_tpu_torch.store.kv import FileDB
    from ceph_tpu_torch.store.types import CollectionId, ObjectId
    from ceph_tpu_torch.parallel import mesh_exec
    on_card = dev.type == "cuda"
    proc = lanes == "process"
    mesh = mesh_positions > 0
    check(not (mesh and (proc or rep_pgs)),
          "mesh mode runs on thread lanes with the EC pool alone")
    tag = "osd-mesh" if mesh else "osd-lanes" if proc else "osd"
    d1_ranges = (OSD_MESH_D1_RANGES if mesh else OSD_LANE_D1_RANGES if proc
                 else OSD_D1_RANGES)
    k1_ranges = {} if mesh else OSD_LANE_K1_RANGES if proc else OSD_K1_RANGES
    n_obj, width = len(objects), k + m
    size = len(objects[0])
    total = n_obj * size
    names = [f"rbd_data.osd.{i:016x}" for i in range(n_obj)]
    cut = dict(OSD_CFG, osd_shard_lanes=lanes, **(OSD_LANE_CUT if proc
                                                   else {}))
    if mesh:
        cut["osd_mesh_mode"] = "on"
    cfg = dict(MON_CFG, **cut)
    if queue_mode != "auto":
        cfg["osd_ec_batch_device"] = queue_mode
    walls, spans, out = {}, {}, {"cut": cut, "osds": osds}
    lats = {}              # step -> each op's latency (host clock)
    if proc:
        out["worker_mib"] = {}
    group_steps = ("group_fold", "group_device", "group_split")
    errors = DaemonErrors()
    if proc:
        import logging
        # a parent logs a worker's death there
        errors.roots.append(logging.getLogger("ceph-tpu-torch.osd.lanes"))
        errors.roots[-1].addHandler(errors.handler)
    t_phase = t0 = time.perf_counter()
    want = chunk_digests(objects, k, m)
    digests = [hashlib.sha256(o).digest() for o in objects]
    walls["cpu_digests"] = time.perf_counter() - t0
    # the EC pool's objects as the class and client steps leave them
    # (the class step rewrites the first OSD_CLS_REWRITES, the client
    # step's cache patches the next OSD_CACHE_OBJECTS): what every later
    # EC check holds reads and rebuilt shards against
    ec_objects, ec_digests, ec_want = list(objects), list(digests), list(want)

    def ctx_of(name):
        ctx = Context(name)
        for key, v in cfg.items():
            ctx.config.set(key, v)
        errors.watch(ctx)
        return ctx

    async def wait(cond, what):
        deadline = time.perf_counter() + OSD_WAIT_S
        while True:
            await poll_lanes()
            if cond():
                return
            check(time.perf_counter() < deadline,
                  f"{what}: not after {OSD_WAIT_S} s")
            await asyncio.sleep(0.1 if proc else 0.02)

    live = {}              # osd id -> OSD
    state = {"epoch_lost": 0, "backfill_lost": 0,
             # the Objecter's placements while a step of its own runs
             "objecter_sites": {} if mesh else {"cls objecter": 0,
                                                "client objecter": 0}}
    queue_launches = {}    # (osd, queue index) -> launches so far
    #: (osd, lane) -> that worker's last ``lane_state``; a stopped OSD's
    #: workers keep their last one
    lane_state = {}

    async def poll_lanes():
        """Every live OSD's workers' ``lane_state``; fails on a dead
        worker."""
        if not proc:
            return
        keys, handles = [], []
        for i, o in live.items():
            for lane in o.shards.process_lanes or ():
                check(not lane.dead, f"osd.{i} lane {lane.idx}: its worker "
                                     f"died")
                keys.append((i, lane.idx))
                handles.append(lane)
        await asyncio.wait_for(asyncio.gather(
            *[lane.wait_ready() for lane in handles]), OSD_WAIT_S)
        lane_state.update(zip(keys, await asyncio.gather(
            *[lane.admin_rpc({"prefix": "lane_state"}) for lane in handles])))

    def k1_counts():
        if proc:
            for (i, j), r in lane_state.items():
                for name, n in r["queue_launches"].items():
                    queue_launches[i, f"lane{j}/{name}"] = n
        for i, o in live.items():
            for j, q in o.ec_queues().items():
                queue_launches[i, j] = q.launches
        return dict(queue_launches)

    def lane_sum(key, site=None):
        return sum(r[key][site] if site else r[key]
                   for r in lane_state.values())

    def d1_sites():
        objecter = state["admin"].objecter.crush_batches
        sub = dict(state["objecter_sites"])
        if "site_from" in state:      # a step with a site of its own runs
            site, since = state["site_from"]
            sub[site] += objecter - since
        sites = {"objecter": objecter - sum(sub.values()), **sub,
                 "epoch": state["epoch_lost"] + sum(
                     o.crush_batches["epoch"] for o in live.values()),
                 "backfill": state["backfill_lost"] + sum(
                     o.crush_batches["backfill"] for o in live.values())}
        if proc:
            sites["parent epoch"] = sites.pop("epoch")
            sites["lane epoch"] = lane_sum("crush_batches", "epoch")
            sites["backfill"] += lane_sum("crush_batches", "backfill")
            sites = {site: sites[site] for site in OSD_LANE_D1_RANGES}
        return sites

    def enter_site(site):
        state["site_from"] = (site, state["admin"].objecter.crush_batches)

    def leave_site():
        site, since = state.pop("site_from")
        state["objecter_sites"][site] += (
            state["admin"].objecter.crush_batches - since)

    def mesh_counts():
        ex = mesh_exec.current()
        if not mesh or ex is None:
            return {}
        return {"encode launches": ex.encode_launches,
                "encode k1": ex.k1_encode,
                "recover launches": ex.recover_launches,
                "recover k1": ex.k1_recover,
                "in-process sub-ops": ex.inproc_subops,
                "encode busy s": ex.busy_s["encode"],
                "recover busy s": ex.busy_s["recover"]}

    def queue_perf(key):
        """(sum, count) of one of the OSDs' ec_batch_queue figures."""
        s = n = 0
        for o in live.values():
            d = o.ctx.perf.dump().get("ec_batch_queue", {}).get(key, {})
            s += d.get("sum", 0)
            n += d.get("avgcount", 0)
        return s, n

    def settled(clean=True):
        """Every live OSD at the client's map epoch and every PG's
        primary active there (and clean, with no pg_temp left, unless
        ``clean`` is false: a degraded PG is active too)."""
        mp = state["admin"].monc.osdmap
        if any(o.osdmap.epoch < mp.epoch for o in live.values()):
            return False
        if clean and mp.pg_temp:
            return False
        want = sum(p.pg_num for p in mp.pools.values())
        if proc:
            states = {}
            for (i, _), r in lane_state.items():
                if i not in live:
                    continue
                if r["osdmap_epoch"] < mp.epoch:
                    return False
                states.update(r["primaries"])
            return len(states) == want and all(
                st == "active" and (fully or not clean)
                for st, fully in states.values())
        primaries = 0
        for o in live.values():
            for pg in list(o.pgs.values()):
                if pg.is_primary():
                    if pg.state != "active" or (
                            clean and not pg.is_fully_clean()):
                        return False
                    primaries += 1
        return primaries == want

    def placement(pool_id):
        """Each object's PG and acting set, on a copy of the client's map
        (lookups there prime the copy's cache on the host engine: the
        Objecter's cache and launches stay as they were)."""
        mp = OSDMap.from_bytes(state["admin"].monc.osdmap.to_bytes())
        pool = mp.pools[pool_id]
        loc = ObjectLocator(pool_id)
        res = []
        for name in names:
            pg = pool.raw_pg_to_pg(mp.object_locator_to_pg(name, loc))
            res.append((pg, list(mp.pg_to_acting_osds(pg)[0])))
        return res

    def rebuilt_in_place():
        from ceph_tpu_torch.store.objectstore import (NoSuchCollection,
                                                     NoSuchObject)
        for j, ((pg, acting), (_, before)) in enumerate(
                zip(placement(state["ec_pool"]), state["ec_place"])):
            for i in range(width):
                if acting[i] != before[i]:
                    if acting[i] not in live:
                        return False
                    try:
                        live[acting[i]].store.stat(
                            CollectionId.pg(state["ec_pool"], pg.seed, i),
                            ObjectId(names[j], pool=state["ec_pool"]))
                    except (NoSuchCollection, NoSuchObject):
                        return False
        return True

    def stored(o, pool_id, pg, shard, name):
        data = live[o].store.read(CollectionId.pg(pool_id, pg.seed, shard),
                                  ObjectId(name, pool=pool_id))
        return hashlib.sha256(bytes(data)).digest()

    async def step(label, coros):
        """Run ``coros`` all at once: the wall and each one's latency
        (host clock), K1's launches by queue and D1's by call site over
        the step, and the wrapper spans (CUDA events)."""
        await poll_lanes()
        k1_0, d1_0, mesh_0 = k1_counts(), d1_sites(), mesh_counts()
        fill_0, walls_0 = queue_perf("batch_fill"), {
            key: queue_perf(key)[0] for key in group_steps}
        w_k1, w_d1 = kernel.gf_apply_launches, ck.crush_map_launches
        lw_0 = {key: (r["pid"], r["gf_apply_launches"],
                      r["crush_map_launches"])
                for key, r in lane_state.items()}
        lat = []

        async def one(c):
            t = time.perf_counter()
            res = await c
            lat.append(time.perf_counter() - t)
            return res

        with device_timer(torch, kernel, "gf_apply", on_card) as k1_ev, \
                device_timer(torch, ck, "crush_map", on_card) as d1_ev:
            t = time.perf_counter()
            res = await asyncio.gather(*[one(c) for c in coros])
            walls[label] = time.perf_counter() - t
        lats[label] = lat
        await poll_lanes()
        k1_1, d1_1 = k1_counts(), d1_sites()
        fill_1 = queue_perf("batch_fill")
        k1 = {q: n - k1_0.get(q, 0) for q, n in k1_1.items()}
        spans[label] = events_ms(torch, k1_ev) + events_ms(torch, d1_ev)
        s = {"wall_s": walls[label], "p50_ms": _pct(lat, 50) * 1e3,
             "k1_span_ms": events_ms(torch, k1_ev),
             "d1_span_ms": events_ms(torch, d1_ev),
             "p99_ms": _pct(lat, 99) * 1e3, "k1": sum(k1.values()),
             "k1_queues": {f"osd.{o}/{j}": n
                           for (o, j), n in sorted(k1.items()) if n},
             "d1": {site: n - d1_0[site] for site, n in d1_1.items()},
             "batch_fill": (fill_1[0] - fill_0[0])
             / max(1, fill_1[1] - fill_0[1]),
             "groups_s": {key: queue_perf(key)[0] - walls_0[key]
                          for key in group_steps}}
        if mesh:
            s["mesh"] = {key: n - mesh_0[key]
                         for key, n in mesh_counts().items()}
            s["mesh_k1"] = s["mesh"]["encode k1"] + s["mesh"]["recover k1"]
        w_k1 = kernel.gf_apply_launches - w_k1
        w_d1 = ck.crush_map_launches - w_d1
        if proc:
            # the wrappers' own counts in the workers, by worker pid
            lw = {r["pid"]: (r["gf_apply_launches"] - lw_0.get(key, (0, 0, 0))[1],
                             r["crush_map_launches"] - lw_0.get(key, (0, 0, 0))[2])
                  for key, r in lane_state.items()}
            s["parent_k1"] = w_k1
            s["lane_k1"] = sum(n for n, _ in lw.values())
            s["lane_d1"] = sum(n for _, n in lw.values())
            s["k1_workers"] = sum(n > 0 for n, _ in lw.values())
            s["d1_workers"] = sum(n > 0 for _, n in lw.values())
        if on_card and proc:
            check(w_k1 == 0 == len(k1_ev),
                  f"{label}: a parent launched gf_apply {w_k1} times")
            check(s["lane_k1"] == s["k1"],
                  f"{label}: the workers' gf_apply launches "
                  f"{s['lane_k1']}, their queues' {s['k1']}")
            check(w_d1 == s["d1"]["objecter"] + s["d1"]["cls objecter"]
                  + s["d1"]["client objecter"] + s["d1"]["parent epoch"]
                  == len(d1_ev),
                  f"{label}: crush_map launches in this process {w_d1}, "
                  f"by call site {s['d1']}, timed {len(d1_ev)}")
            check(s["lane_d1"] == s["d1"]["lane epoch"]
                  + s["d1"]["backfill"],
                  f"{label}: the workers' crush_map launches "
                  f"{s['lane_d1']}, by call site {s['d1']}")
        elif on_card:
            mesh_k1 = s.get("mesh_k1", 0)
            check(w_k1 == s["k1"] + mesh_k1 == len(k1_ev),
                  f"{label}: gf_apply launches {w_k1}, the queues' "
                  f"{s['k1']}, the mesh executor's {mesh_k1}, timed "
                  f"{len(k1_ev)}")
            check(w_d1 == sum(s["d1"].values()) == len(d1_ev),
                  f"{label}: crush_map launches {w_d1}, by call site "
                  f"{s['d1']}, timed {len(d1_ev)}")
        out[label] = s
        return res

    def report(label, n_bytes, note=""):
        s = out[label]
        where = (f" from {s['k1_workers']} worker processes (the parents "
                 f"{s['parent_k1']}), spans not measured (in the workers)"
                 if proc else f", wrapper spans {s['k1_span_ms']:.4f} ms")
        if mesh:
            where += f"; the mesh executor {s['mesh']}"
        print(f"phase {tag} {label}: {s['wall_s']:.4f} s, "
              f"{n_bytes / s['wall_s'] / 1e6:.1f} MB/s of object data, op "
              f"p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms; "
              f"gf_apply {s['k1']} launches {s['k1_queues']}{where}; "
              f"crush_map by call site {s['d1']}, wrapper spans in this "
              f"process {s['d1_span_ms']:.4f} ms (each launch and its "
              f"fetch on an event loop){note} (host clock)")

    # the mons run on an event loop of their own, as separate daemons do:
    # on the OSDs' loop, a second's stall there outlasts their lease
    mons = []
    mon_loop = asyncio.new_event_loop()
    mon_thread = threading.Thread(target=mon_loop.run_forever,
                                  name="mons", daemon=True)
    mon_thread.start()

    def on_mons(coro):
        return asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(coro, mon_loop))

    async def start_osd(i, blob):
        ctx = ctx_of(f"osd.{i}")
        store = BlockStore(os.path.join(tmpdir, f"osd.{i}"),
                           csum_type="crc32c")
        store.mkfs()
        msgr = Messenger(ctx, EntityName("osd", str(i)))
        await msgr.bind("127.0.0.1")
        osd = OSD(ctx, i, store, msgr, MonMap.from_bytes(blob), device=dev)
        await osd.start()
        return osd

    async def start_mons():
        bound = []
        for n in MON_NAMES:
            ctx = ctx_of(f"mon.{n}")
            msgr = Messenger(ctx, EntityName("mon", n))
            bound.append((ctx, n, msgr, await msgr.bind("127.0.0.1")))
        monmap = MonMap()
        monmap.fsid = "chip-smoke-osd"
        for _, n, _, addr in bound:
            monmap.add(n, addr)
        blob = monmap.to_bytes()
        for ctx, n, msgr, _ in bound:
            mons.append(Monitor(
                ctx, n, MonMap.from_bytes(blob),
                FileDB(os.path.join(tmpdir, f"mon.{n}")), msgr))
            await mons[-1].start()
        return blob

    async def stop_mons():
        for x in mons:
            if x.running:
                await x.shutdown()

    def lane_memory(when):
        """The workers' device memory, printed: nvidia-smi's per-process
        lines (a container may show its own pids, or none), and the card's
        used memory over what it was before the OSDs started, per
        worker."""
        text = smi_query("--query-compute-apps=pid,used_memory",
                         "--format=csv").strip()
        print(f"phase {tag} {when}: nvidia-smi --query-compute-apps="
              f"pid,used_memory --format=csv:\n{text}")
        used, workers = gpu_used_mib(), sum(1 for (i, _) in lane_state
                                            if i in live)
        if used is None or state.get("used_mib") is None or not workers:
            return
        per = (used - state["used_mib"]) / workers
        out["worker_mib"][when] = per
        print(f"phase {tag} {when}: the card's used memory {used:.0f} MiB, "
              f"{used - state['used_mib']:.0f} MiB over the "
              f"{state['used_mib']:.0f} MiB before the OSDs started: "
              f"{per:.1f} MiB per worker over {workers} workers; card {smi}")

    async def read_all(io, label, what, sources):
        got = await asyncio.gather(*[io.read(n) for n in names])
        check([hashlib.sha256(g).digest() for g in got] == sources,
              f"{label}: {what} read back differs from its source")

    async def cls_step(ec_io, rep_io):
        """Class calls through the cluster, each vector sent as ``IoCtx``
        sends ``exec``'s: a version-guarded rewrite of the first EC
        objects with new contents (all in flight; K1 encodes each staged
        write_full at its primary), the same guard again carrying the
        first contents (each answers -ECANCELED, the new contents stay),
        the versions read back; lock, refcount and an omap-staging rbd
        method on EC; an RGW bucket index on the replicated pool, one
        prepare + complete pair per object, all in flight, then listed in
        pages, its header read and checked.  Fails on any other
        answer."""
        from ceph_tpu_torch.client import ObjectOperationError
        from ceph_tpu_torch.osd.messages import OP_CALL, OP_WRITEFULL, OSDOp
        n = min(OSD_CLS_REWRITES, n_obj)
        rng = np.random.default_rng(SEED + 16)
        new = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
               for _ in range(n)]
        guard = json.dumps({"conds": [{"cond": "eq", "ver": 0}]}).encode()

        async def guarded(name, data):
            """The reply's result (an error raised carries it)."""
            try:
                reply = await ec_io._op(name, [
                    OSDOp(OP_CALL, name="version.inc", data=guard),
                    OSDOp(OP_WRITEFULL, length=len(data), data=data)])
            except ObjectOperationError as e:
                return e.retcode
            return reply.result

        async def call(io, oid, method, req=None):
            """(result, outdata) of one class call."""
            inbl = b"" if req is None else json.dumps(req).encode()
            try:
                return 0, await io.exec(oid, *method.split("."), inbl)
            except ObjectOperationError as e:
                return e.retcode, b""

        enter_site("cls objecter")
        t = time.perf_counter()
        got = await step("cls write", [guarded(names[j], new[j])
                                       for j in range(n)])
        check(got == [0] * n, f"cls write: the guarded rewrites answered "
                              f"{got}")
        t_cpu = time.perf_counter()
        ec_want[:n] = chunk_digests(new, k, m)
        ec_objects[:n] = new
        ec_digests[:n] = [hashlib.sha256(o).digest() for o in new]
        walls["cls cpu_digests"] = time.perf_counter() - t_cpu
        got = await step("cls replay", [guarded(names[j], objects[j])
                                        for j in range(n)])
        check(got == [-errno.ECANCELED] * n,
              f"cls replay: the guard sent again answered {got}")
        got = await asyncio.gather(*[ec_io.read(names[j]) for j in range(n)])
        check([hashlib.sha256(g).digest() for g in got] == ec_digests[:n],
              "cls: a guarded object read back differs from its new "
              "contents")
        vers = await asyncio.gather(*[call(ec_io, names[j], "version.read")
                                      for j in range(n)])
        vers = [json.loads(v) for _, v in vers]
        check(all(v["ver"] == 1 and len(v["tag"]) == 16
                  and int(v["tag"], 16) >= 0 for v in vers),
              f"cls: version.read gave {vers[:2]}")

        # lock, refcount and an omap-staging method on an EC object
        oid = names[n % n_obj]

        xattr_lat = []

        async def xattr_calls():
            """In order, each call's latency kept apart."""
            req = {"name": "smoke", "type": "exclusive", "entity": "a",
                   "cookie": "c"}
            got = []
            for o, method, r in (
                    (oid, "lock.lock", req),
                    (oid, "lock.lock", dict(req, entity="b")),
                    (oid, "lock.get_info", {"name": "smoke"}),
                    (oid, "refcount.get", {"tag": "a"}),
                    (oid, "refcount.get", {"tag": "b"}),
                    (oid, "refcount.put", {"tag": "a"}),
                    (oid, "refcount.read", None),
                    ("rbd_directory", "rbd.dir_add", {"name": "img"})):
                t_call = time.perf_counter()
                got.append(await call(ec_io, o, method, r))
                xattr_lat.append(time.perf_counter() - t_call)
            return got

        (got,) = await step("cls xattr", [xattr_calls()])
        lats["cls xattr"] = xattr_lat
        out["cls xattr"].update(p50_ms=_pct(xattr_lat, 50) * 1e3,
                                p99_ms=_pct(xattr_lat, 99) * 1e3)
        rcs = [r for r, _ in got]
        check(rcs == [0, -errno.EBUSY, 0, 0, 0, 0, 0, -errno.EOPNOTSUPP],
              f"cls xattr: lock, refcount and rbd.dir_add answered {rcs}")
        check(list(json.loads(got[2][1])["lockers"]) == ["a/c"],
              f"cls xattr: lock.get_info gave {got[2][1]}")
        check(json.loads(got[5][1]) == {"deleted": False}
              and json.loads(got[6][1]) == ["#implicit", "b"],
              f"cls xattr: refcount left {got[6][1]}")

        # the bucket index: one entry per replicated object
        index = ".dir.chip-smoke"
        rc, _ = await call(rep_io, index, "rgw.bucket_init")
        check(rc == 0, f"cls index: bucket_init answered {rc}")

        async def pair(j):
            rc1, _ = await call(rep_io, index, "rgw.bucket_prepare_op",
                                {"tag": f"t{j}", "op": "put",
                                 "key": names[j], "ts": float(j)})
            rc2, out2 = await call(rep_io, index, "rgw.bucket_complete_op",
                                   {"tag": f"t{j}", "op": "put",
                                    "key": names[j],
                                    "entry": {"size": size, "mtime": 0.0,
                                              "etag": digests[j].hex()}})
            return rc1, rc2, out2

        got = await step("cls index", [pair(j) for j in range(n_obj)])
        check(all(g == (0, 0, b'{"removed": true}') for g in got),
              f"cls index: prepare/complete answered {set(got)}")
        listed, marker, pages = [], "", 0
        while True:
            rc, out_l = await call(rep_io, index, "rgw.bucket_list",
                                   {"marker": marker,
                                    "max_keys": OSD_CLS_PAGE})
            check(rc == 0, f"cls index: bucket_list answered {rc}")
            page = json.loads(out_l)
            pages += 1
            listed += [e["key"] for e in page["entries"]]
            marker = page["marker"]
            if not page["truncated"]:
                break
        check(listed == sorted(names), f"cls index: bucket_list gave "
                                       f"{len(listed)} keys in {pages} pages")
        _, hdr = await call(rep_io, index, "rgw.bucket_read_header")
        hdr = json.loads(hdr)
        check(hdr == {"entries": n_obj, "bytes": n_obj * size},
              f"cls index: the header is {hdr}")
        _, chk = await call(rep_io, index, "rgw.bucket_check")
        chk = json.loads(chk)
        check(chk["actual"] == chk["header"] == hdr and not chk["pending"],
              f"cls index: bucket_check found {chk}")
        wall = time.perf_counter() - t
        leave_site()
        labels = ("cls write", "cls replay", "cls xattr", "cls index")
        lat = [x for label in labels for x in lats[label]]
        s = out["cls"] = {
            "wall_s": wall, "p50_ms": _pct(lat, 50) * 1e3,
            "p99_ms": _pct(lat, 99) * 1e3, "ops": len(lat),
            "k1": out["cls write"]["k1"],
            "d1_objecter": state["objecter_sites"]["cls objecter"],
            "rewrites": n, "index_entries": n_obj, "pages": pages}
        report("cls write", n * size,
               f"; {n} EC objects rewritten under version.inc {{ver eq 0}}, "
               f"each read back equal to its new contents at ver 1")
        for label, what in (
                ("cls replay", f"{n} vectors, the guard sent again with "
                               f"the first contents: each -ECANCELED, the "
                               f"new contents stay"),
                ("cls xattr", f"lock.lock a (b: -EBUSY, get_info a/c), "
                              f"refcount.get a, b, put a (left "
                              f"#implicit, b) on {oid}; rbd.dir_add on EC "
                              f"-EOPNOTSUPP"),
                ("cls index", f"{n_obj} bucket_prepare_op + "
                              f"bucket_complete_op pairs on one index "
                              f"object; listed in {pages} pages of "
                              f"{OSD_CLS_PAGE}, header {hdr}, bucket_check "
                              f"clean")):
            x = out[label]
            print(f"phase {tag} {label}: {x['wall_s']:.4f} s, op p50 "
                  f"{x['p50_ms']:.2f} ms, p99 {x['p99_ms']:.2f} ms; "
                  f"gf_apply {x['k1']} launches; crush_map by call site "
                  f"{x['d1']}; {what} (host clock)")
        print(f"phase {tag} cls: {wall:.4f} s in all; op p50 "
              f"{s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms over "
              f"{len(lat)} ops ({n} guarded rewrites, {n} replays, "
              f"{len(xattr_lat)} xattr-class calls, {n_obj} index updates "
              f"of a prepare + complete pair each); "
              f"gf_apply {s['k1']} launches at the guarded rewrite; "
              f"crush_map {s['d1_objecter']} launches at the Objecter "
              f"(host clock); card {smi}")

    async def client_step(ec_io, rep_io):
        """The rest of the client through the cluster: a striped file set
        on the replicated pool (all files in flight; stat, whole and
        window reads, a window overwrite, a truncate, a remove), then a
        write-back cache over EC objects, flushed by read-patch-rewrite.
        Fails on any content that differs from the one kept here."""
        from ceph_tpu_torch.client import ObjectOperationError
        from ceph_tpu_torch.client.object_cacher import ObjectCacher
        from ceph_tpu_torch.client.rados_striper import (
            DEFAULT_LAYOUT, RadosStriper, StripedObjectNotFound)
        rng = np.random.default_rng(SEED + 32)
        enter_site("client objecter")
        t_all = time.perf_counter()
        st = RadosStriper(rep_io)
        files = {f"smoke-file.{i}": rng.integers(
            0, 256, client_file_bytes, dtype=np.uint8).tobytes()
            for i in range(client_files)}
        await step("client files write", [st.write(name, data)
                                          for name, data in files.items()])
        stats = await asyncio.gather(*[st.stat(name) for name in files])
        check(all(x == {"size": client_file_bytes,
                        "stripe_unit": DEFAULT_LAYOUT.stripe_unit,
                        "stripe_count": DEFAULT_LAYOUT.stripe_count,
                        "object_size": DEFAULT_LAYOUT.object_size}
                  for x in stats), f"client files: stat gave {stats[:1]}")
        got = await step("client files read", [st.read(name)
                                               for name in files])
        check(got == list(files.values()),
              "client files: a file read back differs from its source")
        names_f = list(files)
        edit_lat = []
        win = min(1 << 20, client_file_bytes // 4)
        off = client_file_bytes // 3 + 4097

        async def edits():
            """A window read, a window overwrite, a truncate and a
            remove, in turn, each one's latency kept apart."""
            f0, f1, f2 = names_f[0], names_f[1 % len(names_f)], \
                names_f[-1]
            t = time.perf_counter()
            got = await st.read(f0, length=win, offset=off)
            edit_lat.append(time.perf_counter() - t)
            check(got == files[f0][off:off + win],
                  "client files: a window read differs")
            patch = rng.integers(0, 256, win, dtype=np.uint8).tobytes()
            t = time.perf_counter()
            await st.write(f0, patch, offset=off + 17)
            edit_lat.append(time.perf_counter() - t)
            files[f0] = (files[f0][:off + 17] + patch
                         + files[f0][off + 17 + win:])
            keep = client_file_bytes // 2 + 12345
            t = time.perf_counter()
            await st.truncate(f1, keep)
            edit_lat.append(time.perf_counter() - t)
            files[f1] = files[f1][:keep]
            t = time.perf_counter()
            await st.remove(f2)
            edit_lat.append(time.perf_counter() - t)
            del files[f2]

        await step("client files edit", [edits()])
        out["client files edit"].update(p50_ms=_pct(edit_lat, 50) * 1e3,
                                        p99_ms=_pct(edit_lat, 99) * 1e3)
        for name, data in files.items():
            check((await st.stat(name))["size"] == len(data)
                  and await st.read(name) == data,
                  f"client files: {name} after the edits differs")
        try:
            await st.stat(names_f[-1])
            check(False, "client files: a removed file still stats")
        except StripedObjectNotFound:
            pass
        left = [o for o in await rep_io.list_objects()
                if o.startswith(names_f[-1] + ".")]
        check(not left, f"client files: the removed file left {left}")
        # the rest go too: recovery after the out moves the objects the
        # earlier steps left, and no files
        await asyncio.gather(*[st.remove(name) for name in files])

        # the write-back cache over EC objects
        targets = [names[(OSD_CLS_REWRITES + j) % n_obj]
                   for j in range(min(OSD_CACHE_OBJECTS, n_obj))]
        index = {name: names.index(name) for name in targets}
        locks = {}

        async def reader(oid, off, length):
            try:
                return await ec_io.read(oid, length=length, offset=off)
            except ObjectOperationError as e:
                if e.retcode == -errno.ENOENT:
                    return b""
                raise

        async def writer(oid, off, data):
            """EC pools refuse partial writes: read the whole object,
            patch it and rewrite it, one rewrite at a time per object."""
            async with locks.setdefault(oid, asyncio.Lock()):
                cur = bytearray(await ec_io.read(oid))
                cur.extend(b"\0" * max(0, off + len(data) - len(cur)))
                cur[off:off + len(data)] = data
                await ec_io.write_full(oid, bytes(cur))

        cache = ObjectCacher(reader, writer)
        cache.start()
        window = min(OSD_CACHE_WINDOW, size)
        slots = window // OSD_CACHE_WRITE
        patched = {name: bytearray(ec_objects[j])
                   for name, j in index.items()}
        writes = []
        for _ in range(OSD_CACHE_WRITES):
            name = targets[int(rng.integers(len(targets)))]
            off_w = int(rng.integers(slots)) * OSD_CACHE_WRITE
            data = rng.integers(0, 256, OSD_CACHE_WRITE,
                                dtype=np.uint8).tobytes()
            writes.append((name, off_w, data))
            patched[name][off_w:off_w + len(data)] = data
        cache_lat = []

        async def cache_writes():
            for name, off_w, data in writes:
                t = time.perf_counter()
                await cache.write(name, off_w, data)
                cache_lat.append(time.perf_counter() - t)

        await step("client cache write", [cache_writes()])
        out["client cache write"].update(
            p50_ms=_pct(cache_lat, 50) * 1e3,
            p99_ms=_pct(cache_lat, 99) * 1e3)
        await step("client cache flush", [cache.flush_all()])
        await cache.stop()
        got = await asyncio.gather(*[ec_io.read(name) for name in targets])
        check(got == [bytes(patched[name]) for name in targets],
              "client cache: an EC object read back differs from its "
              "patched contents")
        t_cpu = time.perf_counter()
        for name, j in index.items():
            ec_objects[j] = bytes(patched[name])
            ec_digests[j] = hashlib.sha256(ec_objects[j]).digest()
        for j, d in zip(index.values(),
                        chunk_digests([ec_objects[j]
                                       for j in index.values()], k, m)):
            ec_want[j] = d
        walls["client cpu_digests"] = time.perf_counter() - t_cpu
        leave_site()
        wall = time.perf_counter() - t_all
        file_bytes = client_files * client_file_bytes
        s = out["client"] = {
            "wall_s": wall, "files": client_files,
            "file_bytes": client_file_bytes,
            "cache_objects": len(targets), "cache_writes": len(writes),
            "cache_stats": dict(cache.stats),
            "k1_cache": out["client cache write"]["k1"]
            + out["client cache flush"]["k1"],
            "d1_objecter": state["objecter_sites"]["client objecter"]}
        report("client files write", file_bytes,
               f"; {client_files} files of {client_file_bytes} B striped "
               f"over {DEFAULT_LAYOUT.object_size} B objects "
               f"({DEFAULT_LAYOUT.stripe_unit} B stripe unit), all in "
               f"flight, each stat equal")
        report("client files read", file_bytes, "; each equal")
        report("client files edit", win,
               f"; a {win} B window read and overwritten, one file cut to "
               f"half, one removed with every sub-object")
        report("client cache write", len(writes) * OSD_CACHE_WRITE,
               f"; {len(writes)} writes of {OSD_CACHE_WRITE} B into the "
               f"cache over {len(targets)} EC objects (first {window} B "
               f"of each)")
        report("client cache flush", len(writes) * OSD_CACHE_WRITE,
               f"; flush_all by read-patch-rewrite, every object read "
               f"back equal to its patched contents; cache stats "
               f"{s['cache_stats']}")
        print(f"phase {tag} client: {wall:.4f} s in all; gf_apply "
              f"{s['k1_cache']} launches at the cache's writes and flush; "
              f"crush_map {s['d1_objecter']} launches at the Objecter "
              f"(host clock); card {smi}")

    async def run():
        try:
            # 1. three mons, the cluster by command, the OSDs' own boots
            t = time.perf_counter()
            blob = await on_mons(start_mons())
            if mesh:
                # the OSDs' start() registers on this executor
                mesh_exec.disable()
                mesh_exec.enable(devices=[dev] * mesh_positions)
            kernel.gf_apply_launches = 0      # the phase's counts from 0
            ck.crush_map_launches = 0
            admin = state["admin"] = Rados(
                ctx_of("client.admin"), MonMap.from_bytes(blob), device=dev)
            await admin.connect()
            await admin.mon_command({"prefix": "osd crush build-simple",
                                     "num_osds": osds, "osds_per_host": 1})
            if proc and on_card:
                state["used_mib"] = gpu_used_mib()
                print(f"phase {tag} boot: shared memory for the rings "
                      f"(df -h /dev/shm): " + subprocess.run(
                          ["df", "-h", "/dev/shm"], capture_output=True,
                          text=True).stdout.strip().replace("\n", "; "))
            started = await asyncio.gather(*[start_osd(i, blob)
                                             for i in range(osds)])
            live.update(enumerate(started))
            await wait(lambda: admin.monc.osdmap is not None
                       and all(admin.monc.osdmap.is_up(i)
                               and admin.monc.osdmap.is_in(i)
                               for i in range(osds)), "OSDs up and in")
            walls["up_in"] = time.perf_counter() - t
            if proc:
                await poll_lanes()
                walls["lanes_ready"] = time.perf_counter() - t
                print(f"phase {tag} boot: {len(lane_state)} lane workers "
                      f"answer lane_state after {walls['lanes_ready']:.4f} "
                      f"s, on {sorted({r['device'] for r in lane_state.values()})}, "
                      f"pids {sorted(r['pid'] for r in lane_state.values())} "
                      f"(host clock)")
            o0 = live[0]
            print(f"phase {tag} boot: 3 mons and {osds} OSDs (one per host, "
                  f"crc32c BlockStores, TCP on 127.0.0.1, device "
                  f"{o0.device}, CRUSH engine {o0.crush_engine}) up and in "
                  f"after {walls['up_in']:.4f} s; {o0.shards.num_shards} "
                  f"shards on {o0.shards.active_backend} lanes per OSD, EC "
                  f"queue mode {o0.ec_queue.mode}; config cut from the "
                  f"defaults: {cut} (host clock)")
            if mesh:
                ex = mesh_exec.current()
                check(sorted(ex.osds) == list(range(osds)),
                      f"mesh mode: {sorted(ex.osds)} registered")
                print(f"phase {tag} boot: the mesh executor over "
                      f"{len(ex.devices)} positions on "
                      f"{sorted({str(d) for d in ex.devices})}, "
                      f"{len(ex.osds)} OSDs registered")
            await admin.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "rs",
                "profile": {"plugin": "rs", "k": str(k), "m": str(m)}})
            await admin.pool_create("ec", pg_num=ec_pgs,
                                    pool_type="erasure",
                                    erasure_code_profile="rs")
            if rep_pgs:
                await admin.pool_create("rep", pg_num=rep_pgs, size=3)
            await wait(settled, "every PG active+clean")
            walls["clean"] = time.perf_counter() - t
            out["boot"] = {"up_in_s": walls["up_in"],
                           "clean_s": walls["clean"],
                           "epoch": admin.monc.osdmap.epoch,
                           "d1": d1_sites()}
            print(f"phase {tag} boot: pools ec (RS k={k} m={m}, {ec_pgs} "
                  f"PGs) and rep (size 3, {rep_pgs} PGs, 0: none); every PG "
                  f"active+clean after {walls['clean']:.4f} s at "
                  f"e{out['boot']['epoch']}; batched placements by call "
                  f"site {out['boot']['d1']} (host clock)")
            if proc and on_card:
                lane_memory("after boot")
            ec_pool = admin.monc.osdmap.lookup_pool("ec")
            ec_io = admin.open_ioctx("ec")

            # 2-3. the EC write, every object in flight; read back; every
            # stored shard against the CPU codec's chunk
            await step("ec write", [ec_io.write_full(n, o)
                                    for n, o in zip(names, objects)])
            got = await step("ec read", [ec_io.read(n) for n in names])
            check([hashlib.sha256(g).digest() for g in got] == digests,
                  "an EC object read back differs from its source")
            ec_place = state["ec_place"] = placement(ec_pool)
            state["ec_pool"] = ec_pool
            if proc:
                shards_note = ("the shards live in the workers' stores: "
                               "checked through reads")
            else:
                bad = sum(stored(acting[i], ec_pool, pg, i, names[j])
                          != want[j][i]
                          for j, (pg, acting) in enumerate(ec_place)
                          for i in range(width))
                check(bad == 0, f"{bad} stored EC shards differ from the "
                                f"CPU codec's chunks")
                shards_note = (f"all {n_obj * width} stored shards equal "
                               f"the CPU codec's chunks")
            report("ec write", total)
            s = out["ec write"]
            print(f"phase {tag} ec write: batch_fill {s['batch_fill']:.3f} "
                  f"requests per launch; the queues' executor walls "
                  f"{ {key: round(v, 4) for key, v in s['groups_s'].items()} }"
                  f" s; {shards_note}")
            report("ec read", total)

            if rep_pgs:
                # 4. the replicated pool: three equal replicas of each
                rep_pool = admin.monc.osdmap.lookup_pool("rep")
                rep_io = admin.open_ioctx("rep")
                await step("rep write", [rep_io.write_full(n, o)
                                         for n, o in zip(names, objects)])
                got = await step("rep read", [rep_io.read(n) for n in names])
                check([hashlib.sha256(g).digest() for g in got] == digests,
                      "a replicated object read back differs from its "
                      "source")
                if not proc:
                    bad = sum({stored(o, rep_pool, pg, -1, names[j])
                               for o in acting} != {digests[j]}
                              or len(acting) != 3
                              for j, (pg, acting) in enumerate(
                                  placement(rep_pool)))
                    check(bad == 0, f"{bad} objects' replicas differ")
                report("rep write", total, "" if proc
                       else "; three equal replicas of each")
                report("rep read", total)

                # 5. object classes: the guarded EC rewrite, xattr classes
                # on EC, an RGW bucket index on the replicated pool; then
                # the striped file set and the write-back cache
                await cls_step(ec_io, rep_io)
                await client_step(ec_io, rep_io)

            # 6. stop the two OSDs holding the most EC shards; mark them
            # down: reads of objects that lost a data shard decode
            held = {}
            for _, acting in ec_place:
                for o in acting:
                    held[o] = held.get(o, 0) + 1
            lost = sorted(sorted(held, key=lambda o: (-held[o], o))[:2])
            await poll_lanes()      # the stopped workers' last counts
            k1_counts()
            for o in lost:
                osd = live.pop(o)
                state["epoch_lost"] += osd.crush_batches["epoch"]
                state["backfill_lost"] += osd.crush_batches["backfill"]
                await osd.shutdown()
            # both in one proposal, so one epoch re-peers the PGs
            await asyncio.gather(*[admin.mon_command(
                {"prefix": "osd down", "id": o}) for o in lost])
            await wait(lambda: not any(admin.monc.osdmap.is_up(o)
                                       for o in lost), "the two OSDs down")
            # the reads are timed once every PG has peered without them
            # (active, degraded): a read of a PG still peering waits, and
            # one served in an interval that closes is sent again
            t = time.perf_counter()
            await wait(lambda: settled(clean=False), "every PG active")
            walls["repeer"] = time.perf_counter() - t
            hit = [j for j, (_, acting) in enumerate(ec_place)
                   if any(acting[i] in lost for i in range(k))]
            got = await step("degraded read",
                             [ec_io.read(names[j]) for j in hit])
            check([hashlib.sha256(g).digest() for g in got]
                  == [ec_digests[j] for j in hit],
                  "a degraded read differs from its source")
            report("degraded read", len(hit) * size,
                   f"; osd.{lost[0]} and osd.{lost[1]} ({held[lost[0]]} and "
                   f"{held[lost[1]]} shards) stopped and marked down, every "
                   f"PG active again after {walls['repeer']:.4f} s, then "
                   f"{len(hit)} objects that lost a data shard read back "
                   f"equal")

            # 7. out: backfill rebuilds the lost shards elsewhere
            async def recover():
                await asyncio.gather(*[admin.mon_command(
                    {"prefix": "osd out", "id": o}) for o in lost])
                await wait(lambda: not any(admin.monc.osdmap.is_in(o)
                                           for o in lost), "the two out")
                await wait(settled, "recovery to active+clean")
                if not proc:
                    # and every moved shard landed on its new OSD
                    await wait(rebuilt_in_place,
                               "every moved shard rebuilt")

            await step("recovery", [recover()])
            moved = bad = 0
            for j, ((pg, acting), (_, before)) in enumerate(
                    zip(placement(ec_pool), ec_place)):
                for i in range(width):
                    if acting[i] != before[i]:
                        moved += 1
                        check(acting[i] not in lost,
                              f"{names[j]} shard {i} still on a lost OSD")
                        if not proc:
                            bad += stored(acting[i], ec_pool, pg, i,
                                          names[j]) != ec_want[j][i]
            check(moved > 0, "no shard moved after two OSDs went out")
            check(bad == 0, f"{bad} rebuilt shards differ from the CPU "
                            f"codec's chunks")
            if proc:
                # every object read back after recovery, from the
                # rebuilt shards' new homes among the rest
                t = time.perf_counter()
                await read_all(ec_io, "after recovery", "an EC object",
                               ec_digests)
                if rep_pgs:
                    await read_all(rep_io, "after recovery",
                                   "a replicated object", digests)
                walls["read after recovery"] = time.perf_counter() - t
                if on_card:
                    lane_memory("after recovery")
            s = out["recovery"]
            s["moved_shards"] = moved
            s["epochs"] = admin.monc.osdmap.epoch - out["boot"]["epoch"]
            report("recovery", moved * (size // k),
                   f"; {moved} shards moved, " + (
                       f"then every object read back equal in "
                       f"{walls['read after recovery']:.4f} s"
                       if proc else "each rebuilt equal to the CPU codec's "
                       "chunk") + f"; {s['epochs']} epochs since the pools "
                   f"were clean")
            out["lost"] = lost
            out["d1_launches"] = d1_sites()
            await poll_lanes()      # the workers' counts at the end
            out["k1_by_queue"] = {f"osd.{o}/{j}": n for (o, j), n in
                                  sorted(k1_counts().items())}
            if proc:
                lane_errors = {f"osd.{i}/lane{j}": r["errors"]
                               for (i, j), r in lane_state.items()
                               if r["errors"]}
                check(not lane_errors, f"lane workers logged {lane_errors}")
                out["lane_wrappers"] = {
                    "gf_apply": lane_sum("gf_apply_launches"),
                    "crush_map": lane_sum("crush_map_launches")}
                out["workers"] = len(lane_state)
                out["lane_devices"] = sorted(
                    {r["device"] for r in lane_state.values()})
            errors.check(tag)
        finally:
            if "admin" in state:
                await state["admin"].shutdown()
            for o in list(live.values()):
                await o.shutdown()
            await on_mons(stop_mons())
            if mesh:
                out["mesh_counts"] = mesh_counts()
                out["recover_stripes"] = dict(
                    mesh_exec.current().rec_stripes)
                print(f"phase {tag} recover launches by stripes stacked: "
                      f"{dict(sorted(out['recover_stripes'].items()))}")
                mesh_exec.disable()

    try:
        asyncio.run(run())
    finally:
        mon_loop.call_soon_threadsafe(mon_loop.stop)
        mon_thread.join(30)
        mon_loop.close()
        errors.close()
    d1 = out["d1_launches"]
    out["d1_wrapper"] = ck.crush_map_launches
    out["k1_wrapper"] = kernel.gf_apply_launches
    if proc:
        # this process launches only the Objecter's and the parents'
        # placements; the workers every K1 and the rest of D1
        out["d1_wrapper"] += out["lane_wrappers"]["crush_map"]
        out["k1_wrapper"] += out["lane_wrappers"]["gf_apply"]
    if mesh:
        # every K1 of the phase in the executor, none from the queues
        k1 = {"mesh encode": out["mesh_counts"]["encode k1"],
              "mesh recover": out["mesh_counts"]["recover k1"]}
    else:
        k1 = {"encode": out["ec write"]["k1"],
              "degraded read": out["degraded read"]["k1"],
              "rebuild": out["recovery"]["k1"],
              "cls write": out["cls write"]["k1"],
              "client cache": out["client"]["k1_cache"]}
    out["k1_launches"] = k1
    if on_card:
        check(out["d1_wrapper"] == sum(d1.values()),
              f"crush_map launches {out['d1_wrapper']}, by call site {d1}")
        queues = sum(out["k1_by_queue"].values())
        check(out["k1_wrapper"] == queues + (sum(k1.values()) if mesh
                                              else 0),
              f"gf_apply launches {out['k1_wrapper']}, by queue "
              f"{out['k1_by_queue']}, the mesh executor's {k1 if mesh else 0}")
        if mesh:
            counts = out["mesh_counts"]
            check(queues == 0, f"mesh mode: the batch queues launched "
                               f"{out['k1_by_queue']}")
            check(counts["in-process sub-ops"] > 0,
                  "mesh mode: no sub-op was delivered in process")
            for key, (lo, hi) in OSD_MESH_RANGES.items():
                check(lo <= counts[key] <= hi,
                      f"mesh mode: {key} {counts[key]}, stated {lo}-{hi}")
        for site, (lo, hi) in d1_ranges.items():
            check(lo <= d1[site] <= hi, f"crush_map launches at {site}: "
                                        f"{d1[site]}, stated {lo}-{hi}")
        for label, (lo, hi) in k1_ranges.items():
            check(lo <= k1[label] <= hi, f"gf_apply launches at {label}: "
                                         f"{k1[label]}, stated {lo}-{hi}")
        if proc:
            workers = out["ec write"]["k1_workers"]
            check(workers >= OSD_LANE_K1_WORKERS,
                  f"gf_apply launched from {workers} workers at the EC "
                  f"write, stated at least {OSD_LANE_K1_WORKERS}")
    out["walls"] = walls
    out["spans_ms"] = spans
    out["phase_s"] = time.perf_counter() - t_phase
    kernel_ms = sum(spans.values())
    print(f"phase {tag}: {out['phase_s']:.3f} s in all (host clock); "
          f"crush_map launches by call site {d1}, gf_apply launches by step "
          f"{k1}; their wrapper spans {kernel_ms:.4f} ms (host work "
          f"included), {kernel_ms / 10 / out['phase_s']:.4f} % of the "
          f"phase; card {smi}")
    return out


#: the client step's entries in the host-paths line
CLIENT_STEPS = ("client", "client files write", "client files read",
                "client files edit", "client cache write",
                "client cache flush")
MESH_LANES = 512 << 10        # bytes per chunk row in the mesh steps alone
MESH_RECOVER_STRIPES = 64
MESH_RECOVER_LOST = (1, 4)


def mesh_steps_phase(torch, np, gf256, dev, smi, flush,
                     rec_stripes=()):
    """D3 and D4 alone on the card, each held bit for bit against the same
    step with K1's plain version (``plain=True``) and timed by median CUDA
    events with L2 flushed, beside its bytes bound (inputs read once,
    outputs written once; moves between positions on one device move no
    bytes): ``ec_cluster_step`` over 12 positions (3 x 4) at [12, 8,
    512 Ki]; ``ec_recover_step`` over 8 positions (1 x 8: one survivor
    each) at [64, 8, 512 Ki], 2 data chunks lost, also against the
    original data; ``_mesh_recover_fn`` over the mesh run's 12 positions
    (3 x 4) at the stripe counts that run stacked (``rec_stripes``: 1 and
    the largest), padded as ``MeshExecutor._rec_launch`` pads them, its
    bound counting the stripes alone, with the pad's cost at one stripe
    (a 1 x 8 mesh needs none; also staged from the host); and
    ``_mesh_encode_fn`` at n = 12, k = 8, 512 Ki lanes (reading the k
    data rows), also against the data rows.  Returns one row per
    step."""
    from ceph_tpu_torch.ec import kernel
    from ceph_tpu_torch.parallel import layout, mesh_exec
    rng = np.random.default_rng(SEED + 48)
    gen = gf256.rs_vandermonde_matrix(K, M)
    L = MESH_LANES
    rows = []

    def row(name, step, plain, x, out_bytes, in_bytes, extra):
        got, want = step(x), plain(x)
        if isinstance(got, tuple):
            pairs = [(got[0].gather(), want[0].gather()), (got[1], want[1])]
        else:
            pairs = [(got.gather(), want.gather())]
        bad = sum(int((a != b).sum().item()) for a, b in pairs)
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()
                      .item()) for a, b in pairs)
        k1 = step.k1_launches / step.runs
        ms = median_ms(torch, lambda: step(x), 25, flush)
        plain_ms = median_ms(torch, lambda: plain(x), 5, flush)
        bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        r = {"name": name, "mismatches": bad, "max_abs_err": err,
             "k1_per_run": k1, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "bytes", **extra}
        rows.append(r)
        check(bad == 0, f"{name}: {bad} bytes differ from the plain step")
        print(f"phase mesh steps {name}: {extra['shape']} over "
              f"{extra['mesh']}: {bad} mismatched bytes against the plain "
              f"step; K1 launches per run {k1:g}; median {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bytes bound {bound_ms:.4f} ms "
              f"({bound_ms / ms * 100:.1f}% of bound); card {smi}")
        return got

    positions = [dev] * MESH_POSITIONS
    mesh = layout.make_mesh(MESH_POSITIONS, devices=positions)
    data = torch.from_numpy(rng.integers(0, 256, (MESH_POSITIONS, K, L),
                                         dtype=np.uint8)).to(dev)
    x = layout.host_sharded(mesh, data, ("host", None, "shard"))
    row("ec_cluster_step", layout.ec_cluster_step(mesh, gen[K:]),
        layout.ec_cluster_step(mesh, gen[K:], plain=True), x,
        MESH_POSITIONS * M * L, data.numel(),
        {"mesh": dict(mesh.shape),
         "shape": f"[{MESH_POSITIONS}, {K}, {L}] -> [{MESH_POSITIONS}, "
                  f"{M}, {L}] uint8 + scrub [{M}]"})

    mesh8 = layout.make_mesh(K, devices=[dev] * K)
    B = MESH_RECOVER_STRIPES
    lost = list(MESH_RECOVER_LOST)
    stripes = torch.from_numpy(rng.integers(0, 256, (K, B * L),
                                            dtype=np.uint8)).to(dev)
    parity = kernel.gf_apply(kernel.from_reference_matrix(gen[K:], dev),
                             stripes)
    full = torch.cat([stripes, parity]).view(K + M, B, L).permute(1, 0, 2)
    present = [i for i in range(K + M) if i not in lost][:K]
    surv = full[:, present, :].contiguous()
    dec = gf256.decode_matrix(gen, present, lost)
    xs = layout.host_sharded(mesh8, surv, ("host", "shard", None))
    got = row("ec_recover_step", layout.ec_recover_step(mesh8, dec, K),
              layout.ec_recover_step(mesh8, dec, K, plain=True), xs,
              B * len(lost) * L, surv.numel(),
              {"mesh": dict(mesh8.shape),
               "shape": f"[{B}, {K}, {L}] -> [{B}, {len(lost)}, {L}] "
                        f"uint8 + scrub [{len(lost)}], lost {lost}"})
    check(torch.equal(got[0].gather(), full[:, lost, :]),
          "ec_recover_step: the rebuilt chunks differ from the data")

    # _mesh_recover_fn as the mesh run calls it: 8 survivors over the 12
    # positions (3 x 4), B stripes padded to Bp, a host-row multiple; at
    # B = 1 (a degraded read) and at the largest B the run stacked
    positions = (layout.position_device(dev),) * MESH_POSITIONS
    dec_bytes = np.ascontiguousarray(dec, np.uint8).tobytes()
    fn, host = mesh_exec._mesh_recover_fn(K, len(lost), dec_bytes,
                                          positions)
    pfn, _ = mesh_exec._mesh_recover_fn(K, len(lost), dec_bytes,
                                        positions, True)
    for b in sorted({1, max(rec_stripes, default=1)}):
        d = torch.from_numpy(rng.integers(0, 256, (K, b * L),
                                          dtype=np.uint8)).to(dev)
        p = kernel.gf_apply(kernel.from_reference_matrix(gen[K:], dev), d)
        f = torch.cat([d, p]).view(K + M, b, L).permute(1, 0, 2)
        bp = host * mesh_exec._pow2_at_least(-(-b // host))
        inp = torch.zeros((bp, K, L), dtype=torch.uint8, device=dev)
        inp[:b] = f[:, present, :]
        extra = {"mesh": {"host": host, "shard": MESH_POSITIONS // host},
                 "stripes": b, "padded_stripes": bp,
                 "shape": f"[{b}, {K}, {L}] padded to [{bp}, {K}, {L}] "
                          f"-> [{bp}, {len(lost)}, {L}] uint8 + scrub "
                          f"[{len(lost)}], lost {lost}"}
        if b == 1 and host > 1:
            # what the pad costs: the same stripe on a 1 x 8 mesh (no
            # pad), and both staged from the host as _rec_launch stages
            one, _ = mesh_exec._mesh_recover_fn(K, len(lost), dec_bytes,
                                                positions[:K])
            x1 = inp[:1].contiguous()
            h1, hp = x1.cpu(), inp.cpu()
            extra["unpadded_ms"] = median_ms(torch, lambda: one(x1), 25,
                                             flush)
            extra["staged_ms"] = median_ms(torch, lambda: fn(hp), 25,
                                           flush)
            extra["unpadded_staged_ms"] = median_ms(
                torch, lambda: one(h1), 25, flush)
            print(f"phase mesh steps mesh_recover B=1: padded to {bp} "
                  f"stripes against 1 x {K} unpadded "
                  f"{extra['unpadded_ms']:.4f} ms; staged from the host "
                  f"{extra['staged_ms']:.4f} ms against "
                  f"{extra['unpadded_staged_ms']:.4f} ms; card {smi}")
        got = row(f"mesh_recover B={b}", fn, pfn, inp, b * len(lost) * L,
                  b * K * L, extra)
        check(torch.equal(got[0].gather()[:b], f[:, lost, :]),
              f"mesh_recover B={b}: the rebuilt chunks differ from the "
              f"data")

    dev0 = layout.position_device(dev)
    gen_bytes = np.ascontiguousarray(gen, np.uint8).tobytes()
    fn, _ = mesh_exec._mesh_encode_fn(K + M, K, gen_bytes,
                                      (dev0,) * (K + M))
    pfn, _ = mesh_exec._mesh_encode_fn(K + M, K, gen_bytes,
                                       (dev0,) * (K + M), True)
    inp = torch.zeros((K + M, L), dtype=torch.uint8, device=dev)
    inp[:K] = stripes[:, :L]
    got = row("mesh_encode", fn, pfn, inp, (K + M) * L, K * L,
              {"mesh": {"shard": K + M},
               "shape": f"[{K + M}, {L}] -> [{K + M}, {L}] uint8 "
                        f"(data rows in, each position its shard out)"})
    check(torch.equal(got.gather()[:K], stripes[:, :L])
          and torch.equal(got.gather()[K:], parity[:, :L]),
          "mesh_encode: the shards differ from the data and its parity")
    return rows


def model_phase(kernel, ck, smi):
    """One model-checker run on the card, as tests/test_thrash.py runs its
    EC seed: ``run_model(101, rounds=50, n_osds=5, pool_kw={"pool_type":
    "erasure", "k": 2, "m": 2})`` (writes, deletes, reads and snapshots
    raced against OSD kills, restarts, out/in flaps and false down marks,
    every read checked against the model) on the port's Cluster at its
    default device; fails unless it reports ok and D1 ran.  K1's and D1's
    launches in the run are the wrappers' counts (its OSDs' queues; the
    Objecter's and the OSDs' placements).  The checker's objects are at
    most 4 KiB, so each EC chunk is below the batch queue's device
    threshold and takes its host apply: K1 launches 0 times here."""
    from ceph_tpu_torch.qa.rados_model import run_model
    k1_0, d1_0 = kernel.gf_apply_launches, ck.crush_map_launches
    t = time.perf_counter()
    res = asyncio.run(run_model(101, rounds=50, n_osds=5, pool_kw={
        "pool_type": "erasure", "k": 2, "m": 2}))
    wall = time.perf_counter() - t
    out = {"result": res, "wall_s": wall,
           "k1": kernel.gf_apply_launches - k1_0,
           "d1": ck.crush_map_launches - d1_0}
    print(f"phase model: run_model(101, rounds=50, n_osds=5, RS k=2 m=2) "
          f"{json.dumps(res)} in {wall:.3f} s; gf_apply {out['k1']} "
          f"launches, crush_map {out['d1']} (host clock); card {smi}")
    check(res["ok"], f"model: the checker failed: {res['failures']}")
    check(out["d1"] > 0, f"model: crush_map launched {out['d1']} times")
    return out


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

    # -- phase 13: K1's chunks through the messenger ---------------------
    tmpdir = tempfile.mkdtemp(prefix="smoke")
    try:
        msgr = messenger_phase(np, kernel, dev, smi, objects, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    # -- phase 14: place, encode, store, lose two OSDs, rebuild ----------
    tmpdir = tempfile.mkdtemp(prefix="smoke-store")
    try:
        store = store_phase(np, kernel, dev, smi, objects, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    # -- phase 15: a 3-mon quorum's OSDMap through D1 and K1 -------------
    tmpdir = tempfile.mkdtemp(prefix="smoke-mon")
    try:
        mon = mon_phase(np, kernel, dev, smi, objects, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    # -- phase 16: an RS k=8 m=4 pool on 16 port OSDs -------------------
    tmpdir = tempfile.mkdtemp(prefix="smoke-osd")
    try:
        osd = osd_phase(np, kernel, dev, smi, objects, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    # the same on process lanes: 32 worker processes host the PGs
    tmpdir = tempfile.mkdtemp(prefix="smoke-osd-lanes")
    try:
        lanes = osd_phase(np, kernel, dev, smi, objects, tmpdir,
                          ec_pgs=OSD_LANE_EC_PGS, rep_pgs=OSD_LANE_REP_PGS,
                          lanes="process")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    # -- phase 17: mesh mode on the same cluster's EC pool -----------------
    tmpdir = tempfile.mkdtemp(prefix="smoke-osd-mesh")
    try:
        meshed = osd_phase(np, kernel, dev, smi, objects, tmpdir, rep_pgs=0,
                           mesh_positions=MESH_POSITIONS)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    del objects
    # -- phase 18: D3 and D4 alone, against their plain versions ---------
    rec_stripes = meshed["recover_stripes"]
    mesh_steps = {r["name"]: r for r in mesh_steps_phase(
        torch, np, gf256, dev, smi, flush, rec_stripes)}
    # -- phase 19: one model-checker run ----------------------------------
    from ceph_tpu_torch.ops import crush_kernel as ck
    model = model_phase(kernel, ck, smi)

    # -- phase 20: the probe's timing, the kernels line -----------------
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
                                     "psim": sim, "messenger": msgr,
                                     "store": store, "mon": mon,
                                     "osd": {key: osd[key] for key in (
                                         "boot", "ec write", "ec read",
                                         "rep write", "rep read", "cls",
                                         "cls write", "cls replay",
                                         "cls xattr", "cls index",
                                         *CLIENT_STEPS,
                                         "degraded read", "recovery",
                                         "phase_s", "lost")},
                                     "osd lanes": {key: lanes[key] for key in (
                                         "boot", "ec write", "ec read",
                                         "rep write", "rep read", "cls",
                                         "cls write", "cls replay",
                                         "cls xattr", "cls index",
                                         *CLIENT_STEPS,
                                         "degraded read", "recovery",
                                         "phase_s", "lost", "workers",
                                         "worker_mib", "walls")},
                                     "osd mesh": {key: meshed[key] for key in (
                                         "boot", "ec write", "ec read",
                                         "degraded read", "recovery",
                                         "phase_s", "lost", "mesh_counts",
                                         "walls")},
                                     "model": model}}))
    print(json.dumps({"kernels": [{
        "name": "gf_apply",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ec/kernel.py:135",
        "replaces_function": "_ec_fused_kernel",
        "launches": launches + msgr["launches"] + sum(
            sum(c["launches"].values()) for c in codecs.values())
        + store["encode_launches"] + store["rebuild_launches"]
        + sum(mon["k1_launches"].values())
        + sum(osd["k1_launches"].values())
        + sum(lanes["k1_launches"].values())
        + sum(meshed["k1_launches"].values()) + model["k1"],
        "launches_by_path": {"queue": launches} | {
            f"{plugin} {step}": n for plugin, c in codecs.items()
            for step, n in c["launches"].items()} | {
            "messenger encode": msgr["launches"],
            "store encode": store["encode_launches"],
            "store rebuild": store["rebuild_launches"]} | {
            f"mon {step}": n for step, n in mon["k1_launches"].items()} | {
            f"osd {step}": n for step, n in osd["k1_launches"].items()} | {
            f"osd lanes {step}": n
            for step, n in lanes["k1_launches"].items()} | {
            f"osd {step}": n for step, n in meshed["k1_launches"].items()} | {
            "model": model["k1"]},
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
                     + tool["launches"] + sim["launches"]
                     + store["d1_launches"]
                     + sum(mon["d1_launches"].values())
                     + sum(osd["d1_launches"].values())
                     + sum(lanes["d1_launches"].values())
                     + sum(meshed["d1_launches"].values()) + model["d1"]),
        "launches_by_path": {"batch_do_rule_arrays": crush["map_launches"],
                             "osdmap": osdmap_launches,
                             "crushtool --test": tool["launches"],
                             "psim": sim["launches"],
                             "store placement": store["d1_launches"]} | {
            f"mon {step}": n for step, n in mon["d1_launches"].items()} | {
            f"osd {site}": n for site, n in osd["d1_launches"].items()} | {
            f"osd lanes {site}": n
            for site, n in lanes["d1_launches"].items()} | {
            f"osd mesh {site}": n
            for site, n in meshed["d1_launches"].items()} | {
            "model": model["d1"]},
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
    }] + [{
        "name": name,
        "route": "cuda: K1 launches and in-process collectives",
        "source": src,
        "replaces": replaces,
        "replaces_function": fn_name,
        "launches": launches,
        "launches_by_path": {"osd mesh": launches},
        "k1_per_launch": mesh_steps[name]["k1_per_run"],
        "mismatches": mesh_steps[name]["mismatches"],
        "max_abs_err": mesh_steps[name]["max_abs_err"],
        "ms": mesh_steps[name]["ms"],
        "plain_ms": mesh_steps[name]["plain_ms"],
        "bound_ms": mesh_steps[name]["bound_ms"],
        "bound_by": mesh_steps[name]["bound_by"],
        "library_ms": None,
        "mesh": mesh_steps[name]["mesh"],
        "shape": mesh_steps[name]["shape"],
        **{key: mesh_steps[name][key] for key in (
            "stripes", "padded_stripes", "unpadded_ms", "staged_ms",
            "unpadded_staged_ms") if key in mesh_steps[name]},
    } for name, src, replaces, fn_name, launches in (
        ("ec_cluster_step", "ceph_tpu_torch/parallel/layout.py",
         "ceph_tpu/parallel/layout.py:65", "ec_cluster_step (D3)", 0),
        ("ec_recover_step", "ceph_tpu_torch/parallel/layout.py",
         "ceph_tpu/parallel/layout.py:101", "ec_recover_step (D3)", 0),
        *[(f"mesh_recover B={b}", "ceph_tpu_torch/parallel/mesh_exec.py",
           "ceph_tpu/parallel/mesh_exec.py:58",
           "_mesh_recover_fn (D4) over ec_recover_step (D3, "
           "ceph_tpu/parallel/layout.py:101)",
           # the run's launches of one stripe, and of more than one (timed
           # at the most the run stacked)
           sum(n for sb, n in rec_stripes.items() if (sb == 1) == (b == 1)))
          for b in sorted({1, max(rec_stripes, default=1)})],
        ("mesh_encode", "ceph_tpu_torch/parallel/mesh_exec.py",
         "ceph_tpu/parallel/mesh_exec.py:86", "_mesh_encode_fn (D4)",
         meshed["mesh_counts"]["encode launches"]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
