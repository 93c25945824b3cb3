"""The port's shared-memory ring and lane envelopes (``ceph_tpu_torch.osd.
laneipc`` and the codecs of ``osd.lanes``) against the JAX package's.

- every case of ``tests/test_laneipc.py`` runs once per package (the
  reference's source as it is, and read as the port's);
- the same message gives the same envelope and out-frame bytes in both
  packages, and each package decodes the other's;
- a ring segment written by one package reads in the other, frame by
  frame, bursts and extent frees included.

Tolerance 0: bytes are compared exactly.
"""

from __future__ import annotations

import importlib

import pytest

from test_torch_osd import BOTH, PORT, REF, TESTS, cases, port_source, \
    run_case
from test_torch_osd_lanes import deadline


def _port_module_file(tmp_path, monkeypatch):
    """The port reading of ``test_laneipc`` as a file on ``sys.path``: a
    spawned child imports the function it runs by module name."""
    (tmp_path / "_port_test_laneipc.py").write_text(
        port_source((TESTS / "test_laneipc.py").read_text()))
    monkeypatch.syspath_prepend(str(tmp_path))


@pytest.mark.parametrize("root", BOTH)
@pytest.mark.parametrize("case", cases("test_laneipc"))
def test_laneipc_case_in_both_packages(case, root, tmp_path, monkeypatch):
    if root == PORT:
        _port_module_file(tmp_path, monkeypatch)
    with deadline(60):
        run_case("test_laneipc", case, root)


def _pkg(root, name):
    return importlib.import_module(f"{root}.{name}")


def _op_message(root):
    """One client write as each package builds it, transport stamps set."""
    types = _pkg(root, "msg.types")
    msgs = _pkg(root, "osd.messages")
    m = msgs.MOSDOp(pgid=_pkg(root, "osd.types").PGId(3, 2), oid="obj-a",
                    tid=7, ops=[msgs.OSDOp(msgs.OP_WRITEFULL,
                                           data=b"payload-bytes" * 9)])
    m.src_name = types.EntityName("client", "4711")
    m.src_addr = types.EntityAddr("127.0.0.1", 6801, nonce=99)
    m.recv_stamp = 123.5
    m.transport_id = 17
    m.throttle_cost = 256
    return m


def _reply(root):
    msgs = _pkg(root, "osd.messages")
    r = msgs.MOSDOpReply(9, 0, map_epoch=5)
    r.src_name = _pkg(root, "msg.types").EntityName("osd", "3")
    return r


def _frozen_clock(monkeypatch, root):
    lanes = _pkg(root, "osd.lanes")
    monkeypatch.setattr(lanes.time, "monotonic", lambda: 4242.25)
    monkeypatch.setattr(lanes.time, "time", lambda: 1.7e9)
    return lanes


def test_envelopes_are_byte_identical_across_packages(monkeypatch):
    """The message envelope, the out frame (with and without its routing
    pgid) and the fast-path forward envelope: the same bytes from both
    packages for the same message."""
    got = {}
    for root in BOTH:
        lanes = _frozen_clock(monkeypatch, root)
        types = _pkg(root, "msg.types")
        pgid = _pkg(root, "osd.types").PGId(1, 4)
        addr = types.EntityAddr("127.0.0.1", 6805, nonce=3)
        got[root] = (
            lanes.encode_msg_envelope(_op_message(root)),
            lanes.encode_out_frame(_reply(root), addr, "client"),
            lanes.encode_out_frame(_reply(root), addr, "osd", pgid=pgid),
            lanes._encode_fwd_envelope(
                204, types.EntityName("osd", "2"), b"wire"))
    assert got[PORT] == got[REF]


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_each_package_decodes_the_others_envelopes(writer, reader,
                                                   monkeypatch):
    w = _frozen_clock(monkeypatch, writer)
    r = _frozen_clock(monkeypatch, reader)
    m = r.decode_msg_envelope(w.encode_msg_envelope(_op_message(writer)))
    assert type(m).__module__ == f"{reader}.osd.messages"
    assert (m.tid, m.oid, m.ops[0].data) == (7, "obj-a", b"payload-bytes" * 9)
    assert (m.recv_stamp, m.transport_id, m.throttle_cost) == (123.5, 17, 256)
    assert (str(m.src_name), m.src_addr.port, m.src_addr.nonce) == \
        ("client.4711", 6801, 99)
    assert r.encode_msg_envelope(m) == \
        w.encode_msg_envelope(_op_message(writer))
    addr = _pkg(writer, "msg.types").EntityAddr("127.0.0.1", 6805, nonce=3)
    frame = w.encode_out_frame(_reply(writer), addr, "client")
    reply, got_addr, peer_type, t_send = r.decode_out_frame(frame)
    assert (reply.tid, peer_type, t_send) == (9, "client", 4242.25)
    assert (got_addr.port, got_addr.nonce) == (6805, 3)
    assert r.encode_out_frame(reply, got_addr, peer_type) == frame


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_a_ring_written_by_one_package_reads_in_the_other(writer, reader):
    w, r = _pkg(writer, "osd.laneipc"), _pkg(reader, "osd.laneipc")
    assert (w.FRAME_MSG, w.FRAME_BURST, w.FRAME_EXTFREE) == \
        (r.FRAME_MSG, r.FRAME_BURST, r.FRAME_EXTFREE)
    ring = w.ShmRing(capacity=512, create=True)
    peer = r.ShmRing(name=ring.name)
    try:
        frames = [w.pack_frame(w.FRAME_MSG, bytes([i]) * (7 + 13 * i))
                  for i in range(6)]
        burst = w.pack_bursts(frames[:3], ring.capacity)
        assert burst == r.pack_bursts(frames[:3], ring.capacity)
        free = w.pack_frame(w.FRAME_EXTFREE,
                            w.pack_extfree([("pool-a", 1, 3, 4096)]))
        sent = burst + frames[3:] + [free]
        for _ in range(3):              # wrap the 512-byte ring
            for f in sent:
                assert ring.try_push(f)
                assert peer.try_pop() == f
        peer.advertise_waiting(True)
        assert ring.peer_waiting()
        kind, body = r.unpack_frame(sent[0])
        assert kind == r.FRAME_BURST
        assert r.unpack_burst(body) == frames[:3]
        kind, body = r.unpack_frame(free)
        assert r.unpack_extfree(body) == w.unpack_extfree(body)
    finally:
        peer.close()
        ring.close()
        ring.unlink()


def test_the_port_copies_the_frame_kinds():
    ref, port = _pkg(REF, "osd.laneipc"), _pkg(PORT, "osd.laneipc")
    kinds = [n for n in ref.__all__ if n.startswith("FRAME_")]
    assert len(kinds) == 12
    assert {n: getattr(port, n) for n in kinds} == \
        {n: getattr(ref, n) for n in kinds}
    assert port.__all__ == ref.__all__
