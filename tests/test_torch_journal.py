"""The port's journal (``ceph_tpu_torch.journal``) against the JAX
package's.

Every ``Journaler`` method runs on a seeded sequence in both packages,
each on a cluster of its own (three OSDs, a replicated pool: the journal
is omap and ``cls journal`` calls, which EC pools refuse): ``create``,
``exists``, ``append`` (payloads of seeded sizes, rotating data objects
at a small object size), ``replay`` from seeded positions, a second
handle recovering the append position, ``register_client``,
``commit`` (forward, and backward, which the class refuses),
``get_commit``, ``tail_seq``, ``trim``, ``unregister_client`` and
``remove``.  What each call returned, the header object's omap and every
data object's bytes after each step must be equal.  The reference runs
with the repaired ``backoff``, the port on the CPU.  Tolerance 0.
"""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import (PORT, REF, cpu_defaults,  # noqa: E402
                            install_ref_backoff)

OBJECT_SIZE = 700          # bytes: a few appends rotate the data object


async def _state(io, objecter):
    """The journal's header omap and every data object's digest."""
    names = sorted(n for n in await io.list_objects()
                   if n.startswith("journal"))
    out = []
    for n in names:
        try:
            data = await io.read(n)
        except objecter.ObjectOperationError as e:
            out.append((n, e.retcode))
            continue
        omap = {}
        if n.startswith("journal."):
            omap = dict(await io.omap_get(n))
        out.append((n, hashlib.sha256(data).hexdigest()[:16],
                    sorted(omap.items())))
    return out


def run_sequence(root, seed):
    with pytest.MonkeyPatch.context() as mp:
        if root == REF:
            install_ref_backoff(mp)
        else:
            cpu_defaults(mp)
        Cluster = importlib.import_module(root + ".qa.cluster").Cluster
        journal = importlib.import_module(root + ".journal")
        objecter = importlib.import_module(root + ".client.objecter")

        async def run():
            rng = np.random.default_rng(seed)
            cl = Cluster()
            admin = await cl.start(3)
            await admin.pool_create("j", pg_num=8)
            io = admin.open_ioctx("j")
            jid = f"img{seed}"
            jr = journal.Journaler(io, jid, object_size=OBJECT_SIZE)
            log = [("exists", await jr.exists())]
            await jr.create()
            log.append(("exists", await jr.exists()))
            log.append(("tail", await jr.tail_seq()))
            for c in ("a", "b"):
                await jr.register_client(c)
            for step in range(40):
                op = rng.choice(["append", "append", "append", "replay",
                                 "commit", "tail", "reopen", "trim"])
                if op == "append":
                    n = int(rng.integers(0, 300))
                    log.append((op, await jr.append(
                        rng.integers(0, 256, n, dtype=np.uint8).tobytes())))
                elif op == "replay":
                    frm = int(rng.integers(0, 12))
                    log.append((op, frm, [
                        (e.seq, hashlib.sha256(e.payload).hexdigest()[:8])
                        async for e in jr.replay(frm)]))
                elif op == "commit":
                    c = "ab"[int(rng.integers(2))]
                    seq = int(rng.integers(0, await jr.tail_seq() + 1))
                    try:
                        await jr.commit(c, seq)
                        log.append((op, c, seq, "ok"))
                    except objecter.ObjectOperationError as e:
                        log.append((op, c, seq, e.retcode))
                    log.append(("get_commit", c, await jr.get_commit(c)))
                elif op == "tail":
                    log.append((op, await jr.tail_seq()))
                elif op == "reopen":
                    jr = journal.Journaler(io, jid, object_size=OBJECT_SIZE)
                    log.append((op, await jr.append(b"reopened")))
                else:
                    log.append((op, await jr.trim()))
                log.append(("state", await _state(io, objecter)))
            await jr.unregister_client("b")
            log.append(("trim", await jr.trim()))
            log.append(("state", await _state(io, objecter)))
            await jr.remove()
            log.append(("exists", await jr.exists()))
            log.append(("state", await _state(io, objecter)))
            await cl.stop()
            return log
        return asyncio.run(run())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_every_journaler_method_matches_the_reference(seed):
    want = run_sequence(REF, seed)
    got = run_sequence(PORT, seed)
    assert got == want
    kinds = {x[0] for x in got}
    assert {"append", "replay", "commit", "trim", "state"} <= kinds
    assert any(x[0] == "trim" and x[1] > 0 for x in got)


def test_the_port_journal_is_its_own():
    import ceph_tpu.journal as ref
    import ceph_tpu_torch.journal as port
    assert port.__all__ == ref.__all__
    assert port.Journaler is not ref.Journaler
    assert port.Journaler.__module__ == "ceph_tpu_torch.journal.journaler"
