#!/usr/bin/env python3
"""Chip smoke test of the port: ``python3 chip_smoke.py`` on a machine with
one CUDA card, from the root of a checkout.

It drives ceph_tpu_torch's EC write / degraded-read data path on the card
and fails (exit code 1, no result line) on any fault:

  1. prints the card's name and power limit, builds the matrix-apply
     kernel (csrc/gf_apply.cu, nvcc for sm_90a) and prints the build time
     and nvcc's register and shared-memory report;
  2. holds the kernel against its plain PyTorch version on the card, bit
     for bit, at the main path's shapes and at odd ones, and against the
     numpy host path on small inputs;
  3. drives the main path: an OSD context and ECBatchQueue(mode="on",
     device="cuda"); 64 concurrent 4 MiB objects (RS k=8 m=4) split by the
     codec and encoded through the queue, then two rounds of degraded
     reads that rebuild lost data chunks through the queue with the
     codec's decode matrices.  The kernel's launch count is set to 0 just
     before and read just after, and must equal the queue's launches;
  4. runs the ec_benchmark entry point at 256 MiB, encode and decode;
  5. times the kernel and its plain version at the encode window
     [8, 4 Mi] -> [4, 4 Mi] with CUDA events and prints the ``kernels``
     line.

The last line of its output is ``{"ok": true, "device": {...}}``.  It
imports nothing of JAX and nothing of the JAX package.
"""

import asyncio
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

K, M = 8, 4
N_OBJECTS, OBJECT_BYTES = 64, 4 << 20
SEED = 20261017


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


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
    t0 = time.perf_counter()
    built = build("gf_apply")
    print(f"phase build: gf_apply nvcc {built.seconds:.3f} s "
          f"(load {time.perf_counter() - t0:.3f} s)")
    for line in built.ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # -- phase 2: the kernel against its plain version -----------------
    gen = gf256.rs_vandermonde_matrix(K, M)
    cases = [("encode k=8 r=4", gen[K:], 1 << 22)]
    for L in (333, 9000, (1 << 22) + 1):
        cases.append((f"encode odd L={L}", gen[K:], L))
    for lost in ([3], [0, 9], [1, 2, 8, 11]):
        present = [i for i in range(K + M) if i not in lost][:K]
        cases.append((f"decode r={len(lost)}",
                      gf256.decode_matrix(gen, present, lost), 1 << 20))
    cases += [("rs k=2 m=1", gf256.rs_vandermonde_matrix(2, 1)[2:], 65536),
              ("cauchy k=4 m=2", gf256.cauchy_matrix(4, 2)[4:], 100000),
              ("rs k=6 m=3", gf256.rs_vandermonde_matrix(6, 3)[6:], 77777)]
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

    def median_ms(fn, reps):
        fn()
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()        # evicts L2; the launch queues behind it
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    ms = median_ms(lambda: kernel.gf_apply(ops, data), 25)
    plain_ms = median_ms(lambda: kernel.gf_apply_plain(ops.bitmat, data), 21)
    moved = (K + M) * L
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * (8 * M) * (8 * K) * L / INT8_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"phase timing: gf_apply [8, {L}] -> [4, {L}] median {ms:.4f} ms "
          f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f}, int8-MMA ops "
          f"{ops_ms:.4f}), {bound_ms / ms * 100:.1f}% of bound; card {smi}")

    print(json.dumps({"kernels": [{
        "name": "gf_apply",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ec/kernel.py:135",
        "replaces_function": "_ec_fused_kernel",
        "launches": launches,
        "mismatches": mismatches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": f"[{K}, {L}] -> [{M}, {L}] uint8",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
