"""Erasure-code benchmark CLI (the port's copy of
``ceph_tpu.tools.ec_benchmark``).

Reference parity: src/test/erasure-code/ceph_erasure_code_benchmark.cc
(:40-63 options, :150-187 encode/decode loops) — same contract:
--plugin/--size/--iterations/--workload encode|decode/--erasures/
--parameter k=v; prints "<seconds>\t<KiB>" like the reference, plus an
optional json summary line.  ``--device`` (default cuda) names the torch
device of the codec's matrix applies.

    python -m ceph_tpu_torch.tools.ec_benchmark --plugin rs \
        --workload encode --size $((1<<24)) --iterations 10 -P k=8 -P m=4
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ec_benchmark")
    ap.add_argument("--plugin", default="rs")
    ap.add_argument("--workload", choices=["encode", "decode"],
                    default="encode")
    ap.add_argument("--size", type=int, default=1 << 20,
                    help="total bytes per iteration")
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--erasures", type=int, default=1)
    ap.add_argument("-P", "--parameter", action="append", default=[],
                    help="profile k=v (k, m, technique, backend, ...)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the matrix applies (cuda, cpu)")
    args = ap.parse_args(argv)

    from ceph_tpu_torch.ec.registry import factory
    profile = dict(kv.split("=", 1) for kv in args.parameter)
    codec = factory(args.plugin, profile, device=args.device)
    k, m = codec.get_data_chunk_count(), codec.get_coding_chunk_count()
    n = k + m

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, args.size, dtype=np.uint8).tobytes()
    want_all = set(range(n))

    # warm once (the first device call builds the kernel library)
    chunks = codec.encode(want_all, data)

    t0 = time.perf_counter()
    if args.workload == "encode":
        for _ in range(args.iterations):
            chunks = codec.encode(want_all, data)
    else:
        erased = list(range(args.erasures))
        have = {i: c for i, c in chunks.items() if i not in erased}
        for _ in range(args.iterations):
            out = codec.decode(set(erased), have)
        # verify the reconstruction (reference --verify flavor)
        for e in erased:
            if not np.array_equal(out[e], chunks[e]):
                raise RuntimeError(f"bad decode of chunk {e}")
    dt = time.perf_counter() - t0

    total_kib = args.size * args.iterations / 1024
    print(f"{dt:.6f}\t{int(total_kib)}")
    if args.json:
        print(json.dumps({
            "plugin": args.plugin, "workload": args.workload,
            "device": args.device,
            "k": k, "m": m, "iterations": args.iterations,
            "bytes_per_iter": args.size,
            "seconds": round(dt, 6),
            "mb_per_sec": round(args.size * args.iterations / dt / 1e6, 2),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
