"""chip_smoke's services step, on the CPU at a small size.

The script's thread-lane OSD phase on 6 OSDs (RS k=2 m=2; the queue
forced onto the plain apply, the host CRUSH engine at every call site)
with the services step: an RBD image on the EC pool written
object-aligned, then by small read-modify-writes, a snapshot and more
writes; a journaled image replayed by rbd-mirror onto a secondary on the
EC pool; an MDS and a CephFS file set on the EC data pool; an S3 gateway
with SigV4; a mgr whose dashboard agrees with ``pg dump``.  The image,
its snapshot, the secondary and the files read back equal to their
models after writing, degraded (two OSDs down) and after recovery, and
every stored EC shard of their objects equals the CPU codec's chunk
after writing and after recovery.  Tolerance 0.
"""

from __future__ import annotations

import numpy as np

import chip_smoke
from test_torch_client import SMALL

#: the services step cut for the CPU: 256 KiB image objects, 1 MiB of
#: image written, small mirror, files and S3 objects
SERVICES_SMALL = {"image_bytes": 4 << 20, "order": 18,
                  "image_written": 1 << 20, "rmw_writes": 12,
                  "rmw_bytes": 4 << 10, "snap_writes": 4,
                  "mirror_bytes": 512 << 10, "mirror_writes": 4,
                  "files": 3, "file_bytes": 300 << 10,
                  "s3_objects": 4, "s3_bytes": 64 << 10}


def test_chip_smoke_services_step_on_the_cpu(tmp_path, capsys):
    import torch

    from ceph_tpu_torch.ec import kernel
    from ceph_tpu_torch.ops import crush_kernel as ck
    assert set(SERVICES_SMALL) == set(chip_smoke.SERVICES)
    rng = np.random.default_rng(21)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(8)]
    out = chip_smoke.osd_phase(np, kernel, torch.device("cpu"), "cpu",
                               objects, str(tmp_path), **SMALL,
                               services=SERVICES_SMALL)
    svc = out["services"]
    k1 = out["k1_launches"]
    # every part that writes the EC pool encodes through the queues
    for part in ("services rbd", "services rbd rmw", "services mirror",
                 "services cephfs"):
        assert k1[part] == svc["k1"][part] > 0, part
    assert k1["services degraded read"] > 0
    assert set(out["d1_launches"]) == set(chip_smoke.OSD_D1_RANGES) | set(
        chip_smoke.SERVICES_D1_RANGES)
    assert out["d1_launches"]["services objecter"] == svc["d1_objecter"]
    assert out["d1_wrapper"] == 0 == ck.crush_map_launches
    # 4 image objects, 2 of the mirror, one per file left (two of three)
    assert svc["ec_objects"] == 4 + 2 + 2
    assert svc["mirror_applied"][-1] == SERVICES_SMALL["mirror_writes"]
    assert svc["gc_removed"] >= 1
    assert svc["pools"] == [1, 2] and svc["pg_states"] == 16 + 32
    text = capsys.readouterr().out
    for step in chip_smoke.SERVICES_STEPS:
        assert f"phase osd {step}:" in text, step
