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


def main(argv):
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
