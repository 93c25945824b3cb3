"""The port's process lanes (``ceph_tpu_torch.osd.lanes``) against the JAX
package's, and the device seam across the spawn.

- the three ``test_process_lane_*`` cluster cases of ``tests/test_shards.py``
  (replicated read/write, an EC write burst, observability with a worker
  killed) run once per package with equal observations: every ``IoCtx``
  outcome and the stores at each cluster stop.  The port runs on the CPU;
  its workers learn the device from the spawn spec, since the default
  that ``cpu_defaults`` patches lives in the parent only.  The reference's
  workers are spawned interpreters that never see the in-memory
  ``backoff`` repair, so a ``sitecustomize.py`` first on their
  ``PYTHONPATH`` installs it (the file stays as it is);
- ``test_process_lanes_forced_inline_under_sim_loop`` in both packages;
- the spawn spec carries the parent OSD's device (and a card's kernel
  libraries are built before the spawn); a spec without one raises; a
  worker keeps each map it applies for its interval walks;
- chip_smoke's process-lane run at a small size on the CPU.

Each test holds itself to a deadline of 60 s or less (``deadline``).
Tolerance 0: outcomes and counts are compared exactly.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import signal
import types

import numpy as np
import pytest

from test_torch_osd import PORT, REF, ROOT, run_case

import chip_smoke


@contextlib.contextmanager
def deadline(seconds: float):
    """Fail the enclosed block with ``TimeoutError`` after ``seconds``
    (SIGALRM; the main thread only)."""
    def expire(signum, frame):
        raise TimeoutError(f"not done after {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


#: installs the reference's ``backoff`` with ``BackoffGiveUp``'s base list
#: repaired, as ``test_torch_osd.install_ref_backoff`` does in one process
SITECUSTOMIZE = '''
import importlib.abc
import importlib.util
import os
import sys

_BAD = "class BackoffGiveUp(TimeoutError, asyncio.TimeoutError):"


class _Loader(importlib.abc.Loader):
    def __init__(self, path):
        self.path = path

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        with open(self.path) as f:
            src = f.read()
        assert src.count(_BAD) == 1
        src = src.replace(_BAD, "class BackoffGiveUp(TimeoutError):")
        exec(compile(src, self.path, "exec"), module.__dict__)


class _Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name != "ceph_tpu.common.backoff" or not path:
            return None
        f = os.path.join(list(path)[0], "backoff.py")
        return importlib.util.spec_from_file_location(
            name, f, loader=_Loader(f))


sys.meta_path.insert(0, _Finder())
'''


def ref_workers(tmp_path, monkeypatch) -> None:
    """Every interpreter spawned from here on imports the repaired
    reference ``backoff``."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    paths = [str(site), str(ROOT)]
    if os.environ.get("PYTHONPATH"):
        paths.append(os.environ["PYTHONPATH"])
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(paths))


LANE_CASES = ("test_process_lane_minicluster_replicated_rw",
              "test_process_lane_minicluster_ec_write_burst",
              "test_process_lane_observability_attribution_and_cluster_scrape")


@pytest.mark.parametrize("case", LANE_CASES)
def test_process_lane_case_matches_reference(case, tmp_path, monkeypatch):
    ref_workers(tmp_path, monkeypatch)
    with deadline(60):
        want = run_case("test_shards", case, REF)
        got = run_case("test_shards", case, PORT)
    assert got == want


@pytest.mark.parametrize("root", (REF, PORT))
def test_process_lanes_forced_inline_under_sim_loop(root):
    with deadline(30):
        run_case("test_shards",
                 "test_process_lanes_forced_inline_under_sim_loop", root)


def _spawned_specs(monkeypatch, device):
    """Start one ProcessLane of an OSD on ``device`` with the spawn
    replaced by a recorder; returns (contexts asked for, specs, builds
    before each spawn)."""
    from test_torch_osd_messages import _no_card_check, _osd

    from ceph_tpu_torch.osd import lanes
    _no_card_check(monkeypatch)
    osd = _osd(device=device, cfg={"osd_op_num_shards": 2,
                                   "osd_shard_lanes": "process"})
    kinds, specs, built = [], [], []
    r, w = os.pipe()

    class Process:
        exitcode = None

        def __init__(self, target, args, daemon, name):
            assert target is lanes.lane_main and daemon
            specs.append(args[0])
            self.sentinel = r

        def start(self):
            pass

        def is_alive(self):
            return False

        def join(self, timeout=None):
            pass

    def get_context(kind):
        kinds.append(kind)
        return types.SimpleNamespace(Process=Process)

    monkeypatch.setattr(lanes.multiprocessing, "get_context", get_context)
    monkeypatch.setattr(lanes, "_build_kernels",
                        lambda: built.append(len(specs)))

    async def run():
        lane = lanes.ProcessLane(osd.shards, 0)
        lane.start()
        await lane.stop()

    try:
        asyncio.run(run())
    finally:
        os.close(r)
        os.close(w)
    return kinds, specs, built


@pytest.mark.parametrize("device", ("cpu", "cuda"))
def test_the_spawn_spec_carries_the_parents_device(monkeypatch, device):
    """A worker is spawned (a fork would inherit the parent's CUDA state)
    with the parent OSD's device in its spec; on a card the parent builds
    the kernel libraries before the spawn, so 32 workers never run nvcc
    at once."""
    kinds, specs, built = _spawned_specs(monkeypatch, device)
    assert kinds == ["spawn"]
    assert [s["device"] for s in specs] == [device]
    assert built == ([0] if device == "cuda" else [])


def test_a_spec_without_a_device_raises():
    """The worker never falls back to a device of its own."""
    from ceph_tpu_torch.osd.laneipc import ShmRing
    from ceph_tpu_torch.osd.lanes import LaneRuntime
    rings = [ShmRing(capacity=1 << 12, create=True) for _ in range(2)]
    spec = {"whoami": 3, "lane": 1, "num_lanes": 2, "cfg": {},
            "to_lane": rings[0].name, "from_lane": rings[1].name,
            "ring_bytes": 1 << 12}
    rt = LaneRuntime(spec, None, None)
    try:
        with pytest.raises(ValueError, match="names no device"):
            asyncio.run(rt.run())
        assert rt.osd is None
    finally:
        for ring in (rt.to_lane, rt.from_lane):
            ring.close()
        for ring in rings:
            ring.close()
            ring.unlink()


def test_a_worker_keeps_each_map_it_is_sent_for_the_interval_walks():
    """The map a worker applies is the one ``get_map`` returns for its
    epoch later, primed by the advance (the daemon keeps its maps so with
    the sharded plane): decoded anew from the store, each epoch an interval
    walk passes would prime every pool again, and a worker's loop stalled
    for seconds on the walks of the PGs an out creates."""
    from test_torch_osd_messages import _osd, _port_map

    from ceph_tpu_torch.osd.laneipc import FRAME_MAP, pack_frame
    from ceph_tpu_torch.osd.lanes import LaneRuntime
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
    osd = _osd(cfg={"osd_op_num_shards": 1})
    osd.store.mount()
    rt = LaneRuntime.__new__(LaneRuntime)
    rt.osd = osd
    m1 = _port_map()
    m2 = OSDMap.from_bytes(m1.to_bytes())
    m2.apply_incremental(Incremental(m1.epoch + 1))

    async def run():
        applied = []
        for m in (m1, m2):
            rt._handle_frame(pack_frame(FRAME_MAP, m.to_bytes()))
            applied.append(osd.osdmap)
        for pg in list(osd.pgs.values()):
            pg.stop()
        return applied

    first, second = asyncio.run(run())
    assert (first.epoch, second.epoch) == (m1.epoch, m1.epoch + 1)
    assert osd.get_map(m1.epoch) is first


#: chip_smoke's process-lane run, cut for the CPU: 8 OSDs (16 workers),
#: RS k=2 m=2, a few PGs, 64 KiB objects, the queue forced onto the plain
#: apply, the host CRUSH engine at every call site.  At the card's 16 OSDs
#: the 32 workers and 16 parents share 8 host cores here: peering queries
#: then outwait their 10 s and the workers log ERROR
#: ("peering failed"), which fails the run as it should on the card
LANES_SMALL = {"osds": 8, "k": 2, "m": 2, "ec_pgs": 8, "rep_pgs": 16,
               "queue_mode": "force", "lanes": "process",
               "client_files": 3, "client_file_bytes": 3 << 19}


def test_chip_smoke_process_lane_run_on_the_cpu(tmp_path, capsys):
    """The process-lane run at 8 OSDs: every read, degraded read and read
    after recovery equals its source (the EC objects' the class step
    rewrote), D1 is counted by process, K1 by the workers' queues, every
    worker on the parent's device."""
    import torch

    from ceph_tpu_torch.ec import kernel
    from ceph_tpu_torch.ops import crush_kernel as ck
    rng = np.random.default_rng(19)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(6)]
    with deadline(60):
        out = chip_smoke.osd_phase(np, kernel, torch.device("cpu"), "cpu",
                                   objects, str(tmp_path), **LANES_SMALL)
    assert set(out["d1_launches"]) == set(chip_smoke.OSD_LANE_D1_RANGES)
    d1 = out["d1_launches"]
    assert d1["objecter"] >= 2
    # each parent primes every pool per epoch though it hosts no PG, and
    # each of its two workers does again
    assert d1["lane epoch"] == 2 * d1["parent epoch"] > 0
    assert out["d1_wrapper"] == 0 == ck.crush_map_launches
    assert all(n > 0 for n in out["k1_launches"].values())
    assert out["k1_wrapper"] == 0
    assert out["workers"] == 2 * LANES_SMALL["osds"]
    assert out["lane_devices"] == ["cpu"]
    assert out["recovery"]["moved_shards"] > 0
    # the class step: a guarded rewrite of every EC object, encoded in the
    # workers' queues, and a bucket index of every replicated object
    assert out["cls"]["rewrites"] == out["cls"]["index_entries"] == 6
    assert out["k1_launches"]["cls write"] == out["cls"]["k1"] > 0
    assert out["cls write"]["parent_k1"] == 0
    text = capsys.readouterr().out
    assert out["k1_launches"]["client cache"] == out["client"]["k1_cache"] > 0
    for step in ("boot", "ec write", "ec read", "rep write", "rep read",
                 "cls write", "cls replay", "cls xattr", "cls index", "cls",
                 *chip_smoke.CLIENT_STEPS, "degraded read", "recovery"):
        assert f"phase osd-lanes {step}:" in text, step
