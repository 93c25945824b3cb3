"""Run ``chip_smoke.py`` and print the wall of each of its phases.

    python3 smoke_walls.py [DIR]

runs ``python3 chip_smoke.py`` in DIR (default: the directory of this
file), passes its output on with each line stamped by the seconds since
the start, and prints as its last line one JSON object: the seconds of
each phase, from the previous phase's last line to its own last line,
and the total (host clock).  A phase is named by the word after
``phase`` at the start of a line; any other line counts to the phase
before it, and the lines before the first phase to ``start``.  It reads
only the output, so it times any version of the script.  Exits with
chip_smoke's code.

    python3 smoke_walls.py --osd-phase DIR

runs DIR's phase 16 alone on the card (``chip_smoke.osd_phase`` at its
defaults, thread lanes, after building DIR's kernels) and prints one
``CMP`` JSON line of its walls (EC write and read, replicated write,
every PG clean, recovery, the phase) with the card's name and power
limit.  To compare two trees on one card, unpack each (``git archive``)
into a git-ignored directory and run A, B, B, A in one call, removing
DIR/ceph_tpu_torch/_build before each so that every run builds cold.
"""
import json
import os
import re
import subprocess
import sys
import time

PHASE = re.compile(r"phase (\w+)")


def phase_walls(stamped, total):
    """``[(seconds, line)]`` of one run and its total seconds ->
    ``{phase: seconds}`` in the order the phases first appear, with
    ``end`` for the time after the last line."""
    walls, name, mark, last = {}, "start", 0.0, 0.0
    for t, line in stamped:
        m = PHASE.match(line)
        key = m.group(1) if m else name
        if key != name:
            walls[name] = walls.get(name, 0.0) + last - mark
            name, mark = key, last
        last = t
    walls[name] = walls.get(name, 0.0) + last - mark
    walls["end"] = total - last
    return walls


def osd_phase(tree):
    """DIR's phase 16 alone; prints its ``CMP`` line."""
    import concurrent.futures
    import shutil
    import tempfile
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    from ceph_tpu_torch import native
    from ceph_tpu_torch.common.cuda_build import build
    from ceph_tpu_torch.ec import kernel
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        host = pool.submit(native.available)
        list(pool.map(build, ("gf_apply", "crush_map")))
        host.result()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rng = np.random.default_rng(cs.SEED)
    objects = [rng.integers(0, 256, cs.OBJECT_BYTES,
                            dtype=np.uint8).tobytes()
               for _ in range(cs.N_OBJECTS)]
    tmp = tempfile.mkdtemp(prefix="osd-phase")
    try:
        out = cs.osd_phase(np, kernel, torch.device("cuda"), smi, objects,
                           tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("CMP", json.dumps({"tree": os.path.basename(tree),
                             "ec_write_s": out["ec write"]["wall_s"],
                             "ec_read_s": out["ec read"]["wall_s"],
                             "rep_write_s": out["rep write"]["wall_s"],
                             "clean_s": out["boot"]["clean_s"],
                             "recovery_s": out["recovery"]["wall_s"],
                             "phase_s": out["phase_s"], "card": smi}),
          flush=True)
    return 0


def main(argv):
    if argv[:1] == ["--osd-phase"]:
        return osd_phase(argv[1])
    where = argv[0] if argv else os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    stamped = []
    with subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=where,
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            stamped.append((t, line.rstrip("\n")))
            print(f"{t:9.3f} {line}", end="", flush=True)
    total = time.perf_counter() - t0
    walls = phase_walls(stamped, total)
    print(json.dumps({"rc": proc.returncode, "total_s": total,
                      "phases_s": walls}))
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
