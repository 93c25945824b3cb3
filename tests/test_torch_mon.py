"""The port's monitor (``ceph_tpu_torch.mon``) and ``osd/shards`` against
the JAX package's.

- bytes: the corpus bins of the 17 mon messages and of ``MonMap`` decode
  in the port and re-encode to the same bytes; messages the port encodes
  decode in the reference to equal fields;
- the mon-only cases of ``tests/test_mon.py`` (the ones that need no OSD
  cluster) run in both packages with equal outcomes: command replies,
  epochs, up and in sets, maps with ``created``/``modified`` masked;
- the OSDMonitor's commands, the PG, log and FS services and the admin
  socket: the same commands on the same maps give equal replies, and the
  mon's placement sweeps run on the CRUSH host engine (no device launch);
- ``osd/shards``: the cluster-free cases of ``tests/test_shards.py`` in
  both packages, and a send from a foreign thread through the port
  messenger's ``_post_home``;
- across the packages over loopback TCP: a MonClient of one package
  against a 3-mon quorum of the other, with cephx off and on, and mixed
  quorums (2 + 1 and 1 + 2) that elect, commit through a leader of
  either package, survive the leader's shutdown and store equal values
  for every committed version;
- chip_smoke's mon phase at a small size on the CPU.

Tolerance 0: bytes, replies and epochs are compared exactly.  Every
test bounds its waits with ``asyncio.wait_for``.
"""

import asyncio
import errno
import importlib
import json
import pathlib
import random
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke

CORPUS = pathlib.Path(__file__).parent / "corpus"

FAST_CFG = {
    "mon_election_timeout": 0.3,
    "mon_lease": 1.0,
    "mon_tick_interval": 0.5,
    "ms_initial_backoff": 0.02,
}

MESSAGES = ("MMonElection", "MMonPaxos", "MMonCommand", "MMonCommandAck",
            "MMonSubscribe", "MMonSubscribeAck", "MMonGetMap", "MMonMap",
            "MOSDMap", "MOSDBoot", "MOSDFailure", "MOSDAlive", "MPGTemp",
            "MPGStats", "MLog", "MAuth", "MAuthReply")


def _pkg(root):
    m = importlib.import_module
    mon = m(root + ".mon")
    kv = m(root + ".store.kv")
    osdmap = m(root + ".osd.osdmap")
    types = m(root + ".msg.types")
    return SimpleNamespace(
        root=root, Context=m(root + ".common.context").Context,
        Monitor=mon.Monitor, MonClient=mon.MonClient,
        CommandError=mon.CommandError, MonMap=mon.MonMap,
        msgs=m(root + ".mon.messages"),
        Messenger=m(root + ".msg.messenger").Messenger,
        MPing=m(root + ".msg.message").MPing,
        EntityName=types.EntityName, EntityAddr=types.EntityAddr,
        MemDB=kv.MemDB, FileDB=kv.FileDB, OSDMap=osdmap.OSDMap,
        PGId=m(root + ".osd.types").PGId,
        Keyring=m(root + ".auth.keyring").Keyring,
        shards=m(root + ".osd.shards"), payload=m(root + ".msg.payload"),
        admin_socket=m(root + ".common.admin_socket"),
        crush_kernel=m(root + ".ops.crush_kernel"))


REF, PORT = _pkg("ceph_tpu"), _pkg("ceph_tpu_torch")
BOTH = (REF, PORT)


def _run(coro, timeout=60.0):
    async def bounded():
        return await asyncio.wait_for(coro, timeout)
    return asyncio.run(bounded())


def _ctx(p, name, cfg=None):
    ctx = p.Context(name)
    for k, v in {**FAST_CFG, **(cfg or {})}.items():
        ctx.config.set(k, v)
    return ctx


async def start_mons(pkgs, stores=None, cfg=None):
    """Boot one mon per entry of ``pkgs`` (a package each: mixed quorums
    take both) on ephemeral loopback ports; returns (monmap bytes, mons).
    Each mon gets the monmap decoded in its own package."""
    bound = []
    for i, p in enumerate(pkgs):
        name = chr(ord("a") + i)
        ctx = _ctx(p, f"mon.{name}", cfg)
        msgr = p.Messenger(ctx, p.EntityName("mon", name))
        addr = await msgr.bind()
        bound.append((p, ctx, name, msgr, addr))
    first = pkgs[0]
    monmap = first.MonMap()
    monmap.fsid = "fsid-test"
    for _, _, name, _, addr in bound:
        monmap.add(name, first.EntityAddr(addr.host, addr.port, addr.nonce))
    blob = monmap.to_bytes()
    mons = []
    for i, (p, ctx, name, msgr, _) in enumerate(bound):
        store = stores[i] if stores else p.MemDB()
        mon = p.Monitor(ctx, name, p.MonMap.from_bytes(blob), store, msgr)
        await mon.start()
        mons.append(mon)
    return blob, mons


async def wait_quorum(mons, size=None, timeout=15.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        leaders = [m for m in mons if m.is_leader()
                   and m.paxos.state == "active"]
        if len(leaders) == 1 and (size is None
                                  or len(leaders[0].quorum) == size):
            return leaders[0]
        if loop.time() > deadline:
            raise TimeoutError(f"no quorum: {[(m.name, m.state, m.paxos.state) for m in mons]}")
        await asyncio.sleep(0.02)


async def wait_for(cond, timeout=10.0, what="condition"):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.02)


async def make_client(p, blob, name="client.admin", cfg=None):
    ctx = _ctx(p, name, cfg)
    type_, _, id_ = name.partition(".")
    msgr = p.Messenger(ctx, p.EntityName(type_, id_))
    await msgr.bind()
    return p.MonClient(ctx, msgr, p.MonMap.from_bytes(blob)), msgr


async def stop_all(mons, extra_msgrs=()):
    for m in mons:
        if m.running:
            await m.shutdown()
    for ms in extra_msgrs:
        await ms.shutdown()


async def cmd(client, c, **kw):
    """(retcode, outs, outbl) of a command, a denial included."""
    try:
        ack = await client.command(c, **kw)
    except client_error(client) as e:
        return e.retcode, e.outs, b""
    return ack.retcode, ack.outs, ack.outbl


def client_error(client):
    return importlib.import_module(
        type(client).__module__.rsplit(".", 1)[0]).CommandError


def masked_map(p, blob):
    """A map's bytes with its clock stamps zeroed (``created`` comes from
    the mon's first proposal and ``modified`` from each commit)."""
    m = p.OSDMap.from_bytes(blob)
    m.created = m.modified = 0.0
    return m.to_bytes()


# ------------------------------------------------------------------ bytes

@pytest.mark.parametrize("dotted", [f"mon.messages.{n}" for n in MESSAGES]
                         + ["mon.monmap.MonMap"])
def test_corpus_bins_reencode_byte_identically(dotted):
    blob = (CORPUS / f"ceph_tpu.{dotted}.bin").read_bytes()
    mod, _, name = dotted.rpartition(".")
    port_cls = getattr(importlib.import_module(f"ceph_tpu_torch.{mod}"),
                       name)
    ref_cls = getattr(importlib.import_module(f"ceph_tpu.{mod}"), name)
    assert port_cls.STRUCT_V == ref_cls.STRUCT_V == blob[0]
    assert getattr(port_cls, "TYPE", None) == getattr(ref_cls, "TYPE", None)
    obj = port_cls.from_bytes(blob)
    assert obj.to_bytes() == blob
    assert port_cls.from_bytes(ref_cls.from_bytes(blob).to_bytes()) \
        .to_bytes() == blob


def test_message_codes_are_registered_per_package():
    for name in MESSAGES:
        pc, rc = getattr(PORT.msgs, name), getattr(REF.msgs, name)
        assert pc.TYPE == rc.TYPE and pc.PRIORITY == rc.PRIORITY
        assert importlib.import_module("ceph_tpu_torch.msg.message") \
            .message_class(pc.TYPE) is pc
        assert importlib.import_module("ceph_tpu.msg.message") \
            .message_class(rc.TYPE) is rc
    assert PORT.msgs.MMonElection.TYPE == 100
    assert PORT.msgs.MAuthReply.TYPE == 117


def _samples(p, rng):
    """One instance of each of the 17 types with seeded random fields."""
    M = p.msgs

    def addr():
        return p.EntityAddr(f"10.0.{rng.randrange(256)}.{rng.randrange(256)}",
                            rng.randrange(65536), rng.getrandbits(48))

    def blob(n=64):
        return rng.randbytes(rng.randrange(n))

    pg_temp = {p.PGId(rng.randrange(9), rng.randrange(4096)):
               [rng.randrange(-1, 64) for _ in range(rng.randrange(1, 5))]
               for _ in range(rng.randrange(4))}
    stats = [{"pgid": f"{rng.randrange(5)}.{rng.randrange(99):x}",
              "state": rng.choice(["active+clean", "peering"]),
              "num_objects": rng.randrange(1000),
              "num_bytes": rng.getrandbits(40)}
             for _ in range(rng.randrange(4))]
    return [
        M.MMonElection(rng.randrange(1, 4), rng.getrandbits(32),
                       rng.randrange(-1, 5),
                       [rng.randrange(5) for _ in range(rng.randrange(4))]),
        M.MMonPaxos(rng.randrange(1, 8), rng.getrandbits(64),
                    rng.getrandbits(32), rng.getrandbits(32),
                    {rng.getrandbits(32): blob() for _ in range(3)},
                    rng.getrandbits(64), rng.random() * 5,
                    rng.getrandbits(32)),
        M.MMonCommand({"prefix": "osd pool create", "pool": "p",
                       "pg_num": rng.randrange(1, 999)},
                      rng.getrandbits(64), blob()),
        M.MMonCommandAck(rng.getrandbits(64), -rng.randrange(200),
                         "é€ outs", blob(), rng.randrange(-1, 3)),
        M.MMonSubscribe({"osdmap": rng.getrandbits(32),
                         "monmap": rng.getrandbits(32)}),
        M.MMonSubscribeAck(), M.MMonGetMap(), M.MMonMap(blob(256)),
        M.MOSDMap({rng.getrandbits(32): blob() for _ in range(2)},
                  {rng.getrandbits(32): blob(512)}),
        M.MOSDBoot(rng.randrange(1024), addr(), rng.getrandbits(32)),
        M.MOSDFailure(rng.randrange(1024), rng.random() < 0.5,
                      rng.getrandbits(32), rng.random() * 30),
        M.MOSDAlive(rng.randrange(1024), rng.getrandbits(32)),
        M.MPGTemp(rng.randrange(1024), pg_temp),
        M.MPGStats(rng.randrange(1024), rng.getrandbits(32), stats,
                   {"statfs": {"total": rng.getrandbits(40), "used": 7}}),
        M.MLog([{"stamp": rng.random(), "who": "osd.3", "level": "WRN",
                 "message": "slow"}]),
        M.MAuth("client.admin", rng.randrange(1, 3), blob(16), blob(32),
                ["mon", "osd"], rng.getrandbits(64)),
        M.MAuthReply(rng.randrange(1, 3), -rng.randrange(20), blob(16),
                     blob(), rng.getrandbits(64)),
    ]


def _fields(msg):
    skip = {"seq", "src_name", "src_addr", "recv_stamp", "connection",
            "transport_id", "_wire", "_span", "_lane_sent_mono"}
    out = {}
    for k, v in vars(msg).items():
        if k in skip:
            continue
        if k == "pg_temp":
            v = {(pg.pool, pg.seed, pg.shard): o for pg, o in v.items()}
        elif hasattr(v, "encode_payload"):
            v = v.to_bytes()
        out[k] = v
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_port_encoded_messages_decode_in_the_reference(seed):
    port_msgs = _samples(PORT, random.Random(seed))
    ref_msgs = _samples(REF, random.Random(seed))
    assert [type(m).__name__ for m in port_msgs] == list(MESSAGES)
    for pm, rm in zip(port_msgs, ref_msgs):
        wire = pm.to_bytes()
        assert wire == rm.to_bytes()
        assert pm.wire_bytes() == rm.wire_bytes()
        back = type(rm).from_bytes(wire)
        assert _fields(back) == _fields(pm)
        assert type(pm).from_bytes(rm.to_bytes()).to_bytes() == wire


def test_monmap_ranks_and_bytes_match():
    rng = random.Random(5)
    for _ in range(10):
        mm = {p.root: (p, p.MonMap()) for p in BOTH}
        names = rng.sample("abcdefgh", rng.randrange(1, 6))
        for p, m in mm.values():
            m.fsid = "fsid-x"
            for n in names:
                m.add(n, p.EntityAddr("127.0.0.1", 6789 + ord(n), 1))
            m.remove(names[0])
        r, q = mm["ceph_tpu"][1], mm["ceph_tpu_torch"][1]
        assert q.to_bytes() == r.to_bytes()
        assert (q.names(), q.quorum_size(), q.epoch) == \
            (r.names(), r.quorum_size(), r.epoch)
        for n in names:
            assert q.rank_of(n) == r.rank_of(n)


# ------------------------------------- the mon-only cases of test_mon.py

async def _single_mon_bootstrap_and_commands(p):
    blob, mons = await start_mons([p])
    leader = await wait_quorum(mons)
    assert leader.osdmon.osdmap.epoch >= 1      # create_initial committed
    client, cmsgr = await make_client(p, blob)
    out = {"status": json.loads((await client.command(
        {"prefix": "status"})).outs)}
    assert out["status"]["fsid"] == "fsid-test"
    out["acks"] = [await cmd(client, c) for c in (
        {"prefix": "osd crush build-simple", "num_osds": 4,
         "osds_per_host": 2},
        {"prefix": "osd pool create", "pool": "data", "pg_num": 8},
        {"prefix": "osd pool ls"}, {"prefix": "bogus"})]
    assert "created" in out["acks"][1][1] and "data" in out["acks"][2][1]
    assert out["acks"][3][0] == -errno.EINVAL
    rc, outs, outbl = await cmd(client, {"prefix": "osd dump"})
    m = p.OSDMap.from_bytes(outbl)
    assert m.lookup_pool("data") >= 0 and m.max_osd == 4
    out["dump"] = (rc, outs, masked_map(p, outbl))
    await stop_all(mons, [cmsgr])
    return out


async def _osd_boot_failure_and_subscription(p):
    blob, mons = await start_mons([p])
    await wait_quorum(mons)
    client, cmsgr = await make_client(p, blob)
    await client.command({"prefix": "osd crush build-simple",
                          "num_osds": 3, "osds_per_host": 1})
    osd_msgrs = []
    for i in range(3):
        om = p.Messenger(_ctx(p, f"osd.{i}"), p.EntityName("osd", str(i)))
        await om.bind()
        om.send_message(p.msgs.MOSDBoot(
            i, p.EntityAddr("10.0.0.1", 6800 + i, i + 1)),
            client.monmap.addr_of_rank(0), peer_type="mon")
        osd_msgrs.append(om)
    m = await client.wait_for_osdmap(timeout=10)
    await wait_for(lambda: client.osdmap.count_up() == 3, what="3 up")
    m = client.osdmap
    out = {"up": [m.is_up(o) for o in range(3)], "epoch": m.epoch}
    osd_msgrs[1].send_message(
        p.msgs.MOSDFailure(target_osd=2, epoch=m.epoch),
        client.monmap.addr_of_rank(0), peer_type="mon")
    await wait_for(lambda: not client.osdmap.is_up(2), what="osd.2 down")
    out["after"] = ([client.osdmap.is_up(o) for o in range(3)],
                    [client.osdmap.is_in(o) for o in range(3)],
                    client.osdmap.epoch)
    assert client.osdmap.is_in(2)               # down but not yet out
    await stop_all(mons, osd_msgrs + [cmsgr])
    return out


async def _three_mon_election_and_commit(p):
    blob, mons = await start_mons([p] * 3)
    leader = await wait_quorum(mons)
    assert leader.rank == 0                     # lowest rank wins
    peons = [m for m in mons if m is not leader]
    out = {"leader": leader.rank, "quorum": leader.quorum,
           "peons": [m.state for m in peons]}
    client, cmsgr = await make_client(p, blob)
    out["acks"] = [await cmd(client, c) for c in (
        {"prefix": "osd crush build-simple", "num_osds": 2,
         "osds_per_host": 1},
        {"prefix": "osd pool create", "pool": "p3", "pg_num": 4})]
    await wait_for(lambda: all(m.osdmon.osdmap.lookup_pool("p3") >= 0
                               for m in peons), what="peons replicate")
    out["peon_epochs"] = [m.osdmon.osdmap.epoch for m in peons]
    await stop_all(mons, [cmsgr])
    return out


async def _command_to_peon_redirects(p):
    blob, mons = await start_mons([p] * 3)
    await wait_quorum(mons)
    client, cmsgr = await make_client(p, blob)
    client.cur_mon = 2          # deliberately talk to a peon first
    ack = await client.command({"prefix": "quorum_status"})
    assert client.cur_mon == 0  # followed the leader hint
    out = {"cur_mon": client.cur_mon, "quorum": json.loads(ack.outs)}
    await stop_all(mons, [cmsgr])
    return out


async def _leader_failover(p):
    blob, mons = await start_mons([p] * 3)
    leader = await wait_quorum(mons)
    client, cmsgr = await make_client(p, blob)
    await client.command({"prefix": "osd crush build-simple",
                          "num_osds": 2, "osds_per_host": 1})
    await client.command(
        {"prefix": "osd pool create", "pool": "before", "pg_num": 4})
    await leader.shutdown()
    rest = [m for m in mons if m is not leader]
    new_leader = await wait_quorum(rest, timeout=30)
    assert new_leader.rank == 1
    out = {"new_leader": new_leader.rank,
           "before": new_leader.osdmon.osdmap.lookup_pool("before")}
    ack = await client.command(
        {"prefix": "osd pool create", "pool": "after", "pg_num": 4},
        timeout=30)
    # a retry racing the failover may find the pool already committed
    # by the dead leader: both outcomes are right
    out["after"] = ack.retcode == 0 and ("created" in ack.outs
                                         or "exists" in ack.outs)
    assert out["after"]
    await stop_all(rest, [cmsgr])
    return out


async def _mon_restart_preserves_state(p, store_kind="mem", tmpdir=None):
    stores = [p.MemDB() if store_kind == "mem"
              else p.FileDB(str(tmpdir / p.root))]
    blob, mons = await start_mons([p], stores=stores)
    await wait_quorum(mons)
    client, cmsgr = await make_client(p, blob)
    await client.command({"prefix": "osd crush build-simple",
                          "num_osds": 2, "osds_per_host": 1})
    await client.command({"prefix": "osd pool create",
                          "pool": "persist", "pg_num": 4})
    epoch_before = mons[0].osdmon.osdmap.epoch
    committed = mons[0].paxos.last_committed
    values = chip_smoke.mon_store_values(mons[0])
    await mons[0].shutdown()
    store = stores[0] if store_kind == "mem" \
        else p.FileDB(str(tmpdir / p.root))
    ctx = _ctx(p, "mon.a")
    msgr = p.Messenger(ctx, p.EntityName("mon", "a"))
    mon2 = p.Monitor(ctx, "a", p.MonMap.from_bytes(blob), store, msgr)
    await mon2.start()
    leader = await wait_quorum([mon2])
    assert leader.osdmon.osdmap.epoch >= epoch_before
    assert leader.osdmon.osdmap.lookup_pool("persist") >= 0
    after = chip_smoke.mon_store_values(leader)
    assert all(after[k] == v for k, v in values.items()
               if k[0] != "paxos" or k[1] <= committed)
    out = {"epoch_before": epoch_before,
           "epoch_after": leader.osdmon.osdmap.epoch,
           "committed": (committed, leader.paxos.last_committed)}
    await stop_all([mon2], [cmsgr])
    return out


async def _subscription_before_first_commit_bootstraps(p):
    blob, mons = await start_mons([p])
    mon = mons[0]
    monc, msgr = await make_client(p, blob)
    sub = {"_addr": msgr.addr, "_type": "client", "osdmap": 0}
    saved_epoch = mon.osdmon.osdmap.epoch
    mon.osdmon.osdmap.epoch = 0
    mon._push_maps_to(sub)
    assert sub["osdmap"] == 0, \
        "cursor must not advance past an unserved epoch-0 push"
    mon.osdmon.osdmap.epoch = saved_epoch
    await wait_quorum(mons)
    monc.sub_want("osdmap", 0)
    got = await monc.wait_for_osdmap(timeout=10)
    assert got.epoch >= 1
    out = {"cursor": sub["osdmap"], "epoch": got.epoch}
    await stop_all(mons, [msgr])
    return out


async def _monclient_rerequests_full_on_unbridgeable_incrementals(p):
    class _Rec:
        def __init__(self):
            self.sent = []

        def send_message(self, msg, addr, peer_type=None):
            self.sent.append(msg)

    blob, mons = await start_mons([p])
    await wait_quorum(mons)
    monc, msgr = await make_client(p, blob)
    monc._subs["osdmap"] = 5
    rec = _Rec()
    monc.messenger = rec            # capture the re-subscription
    m = p.msgs.MOSDMap()
    m.incrementals[7] = b"\x00"     # no base: cannot chain onto None
    monc._handle_osdmap(m)
    assert monc._subs["osdmap"] == 0, "must reset to request full map"
    assert rec.sent, "must re-send the subscription"
    out = {"subs": dict(monc._subs),
           "sent": [(type(s).__name__, s.what) for s in rec.sent]}
    await stop_all(mons, [msgr])
    return out


async def _osdmap_msg_shared_across_subscribers(p):
    blob, mons = await start_mons([p])
    leader = await wait_quorum(mons)
    client, cmsgr = await make_client(p, blob)
    await client.command({"prefix": "osd crush build-simple",
                          "num_osds": 4})
    await client.command({"prefix": "osd setmaxosd", "num": 8})
    e = leader.osdmon.osdmap.epoch
    assert e >= 2
    m1 = leader.osdmon.build_osdmap_msg(1, e)
    m2 = leader.osdmon.build_osdmap_msg(1, e)
    assert m1 is m2                      # one message per range
    assert leader.osdmon.osdmap_msgs_shared >= 1
    p.payload.reset_counters()
    w1, w2 = m1.wire_bytes(), m2.wire_bytes()
    assert w1 is w2                      # one encode per range
    enc = p.payload.counters()["msg_encode_calls"]
    m3 = leader.osdmon.build_osdmap_msg(e, e)
    assert m3 is not m1 and leader.osdmon.build_osdmap_msg(e, e) is m3
    out = {"epoch": e, "encodes": enc,
           "incs": sorted(m1.incrementals), "fulls": sorted(m1.fulls),
           "shared": leader.osdmon.osdmap_msgs_shared}
    assert enc == 1
    await stop_all(mons, [cmsgr])
    return out


MON_CASES = {
    "single_mon_bootstrap_and_commands": _single_mon_bootstrap_and_commands,
    "osd_boot_failure_and_subscription": _osd_boot_failure_and_subscription,
    "three_mon_election_and_commit": _three_mon_election_and_commit,
    "command_to_peon_redirects": _command_to_peon_redirects,
    "leader_failover": _leader_failover,
    "mon_restart_preserves_state": _mon_restart_preserves_state,
    "subscription_before_first_commit_bootstraps":
        _subscription_before_first_commit_bootstraps,
    "monclient_rerequests_full_on_unbridgeable_incrementals":
        _monclient_rerequests_full_on_unbridgeable_incrementals,
    "osdmap_msg_shared_across_subscribers":
        _osdmap_msg_shared_across_subscribers,
}


@pytest.mark.parametrize("case", list(MON_CASES))
def test_mon_case_matches_reference(case):
    fn = MON_CASES[case]
    assert _run(fn(PORT)) == _run(fn(REF))


def test_mon_restart_from_a_filedb_matches_reference(tmp_path):
    """The restart case with each mon's store a FileDB reopened from its
    directory (the chip phase restarts its old leader so)."""
    assert _run(_mon_restart_preserves_state(PORT, "file", tmp_path)) == \
        _run(_mon_restart_preserves_state(REF, "file", tmp_path))


# ----------------------------------------------------- OSDMonitor commands

async def _boot(p, leader, ids):
    """MOSDBoot for each id from one osd messenger, each with a fixed
    address (the map records the boot's address, not the sender's)."""
    om = p.Messenger(_ctx(p, "osd.0"), p.EntityName("osd", "0"))
    await om.bind()
    for i in ids:
        om.send_message(p.msgs.MOSDBoot(
            i, p.EntityAddr("10.0.0.1", 6800 + i, i + 1)),
            leader.messenger.addr, peer_type="mon")
    await wait_for(lambda: all(leader.osdmon.osdmap.is_up(i) for i in ids),
                   what="osds up")
    return om


def _normalized(p, c, res):
    rc, outs, outbl = res
    if rc == 0 and c.get("prefix") in ("osd dump", "osd getmap"):
        outbl = masked_map(p, outbl)
    return rc, outs, outbl


SCRIPTS = {
    "pools": [
        {"prefix": "osd erasure-code-profile set", "name": "p22",
         "profile": {"k": 2, "m": 2}},
        {"prefix": "osd erasure-code-profile set", "name": "p22",
         "profile": {"k": 2, "m": 2}},
        {"prefix": "osd erasure-code-profile get", "name": "p22"},
        {"prefix": "osd erasure-code-profile get", "name": "nope"},
        {"prefix": "osd erasure-code-profile ls"},
        {"prefix": "osd pool create", "pool": "r", "pg_num": 16, "size": 3},
        {"prefix": "osd pool create", "pool": "e", "pg_num": 8,
         "pool_type": "erasure", "erasure_code_profile": "p22"},
        {"prefix": "osd pool create", "pool": "r", "pg_num": 16},
        {"prefix": "osd pool create", "pool": "bad", "pg_num": 8,
         "pool_type": "erasure", "erasure_code_profile": "p22", "k": 3},
        {"prefix": "osd pool create", "pool": "e2", "pg_num": 4,
         "pool_type": "erasure", "erasure_code_profile": "fresh", "k": 2,
         "m": 1, "plugin": "jerasure"},
        {"prefix": "osd pool ls"},
        {"prefix": "osd erasure-code-profile rm", "name": "p22"},
        {"prefix": "osd erasure-code-profile set", "name": "p22",
         "profile": {"k": 4, "m": 2}},
        {"prefix": "osd pool delete", "pool": "e2"},
        {"prefix": "osd pool delete", "pool": "e2"},
        {"prefix": "osd erasure-code-profile set", "name": "fresh",
         "profile": {"k": 3, "m": 1}},
        {"prefix": "osd erasure-code-profile set", "name": "fresh",
         "profile": {"k": 3, "m": 1}, "force": True},
        {"prefix": "osd erasure-code-profile rm", "name": "fresh"},
        {"prefix": "osd erasure-code-profile rm", "name": "fresh"},
        {"prefix": "osd dump"},
        {"prefix": "osd getmap", "epoch": 3},
        {"prefix": "osd getmap", "epoch": 999},
    ],
    "pg_num": [
        {"prefix": "osd pool create", "pool": "r", "pg_num": 16},
        {"prefix": "osd pool set", "pool": "r", "var": "pg_num",
         "val": 64},
        {"prefix": "osd pool set", "pool": "r", "var": "pg_num",
         "val": 32},
        {"prefix": "osd pool set", "pool": "r", "var": "bogus", "val": 1},
        {"prefix": "osd pool set", "pool": "r", "var": "size",
         "val": "x"},
        {"prefix": "osd pool set", "pool": "nope", "var": "size",
         "val": 2},
        {"prefix": "osd pool set", "pool": "r", "var": "min_size",
         "val": 1},
        {"prefix": "osd pool set", "pool": "r", "var": "quota_max_bytes",
         "val": 1 << 20},
        *({"prefix": "osd out", "id": i} for i in range(6)),
        # a dead rule: every osd out, so the growth would map nothing
        {"prefix": "osd pool set", "pool": "r", "var": "pg_num",
         "val": 128},
        {"prefix": "osd dump"},
    ],
    "reweight": [
        {"prefix": "osd pool create", "pool": "r", "pg_num": 64},
        {"prefix": "osd erasure-code-profile set", "name": "p",
         "profile": {"k": 2, "m": 1}},
        {"prefix": "osd pool create", "pool": "e", "pg_num": 32,
         "pool_type": "erasure", "erasure_code_profile": "p"},
        {"prefix": "osd reweight-by-utilization", "oload": 100},
        {"prefix": "osd reweight-by-utilization"},
        {"prefix": "osd reweight-by-utilization", "oload": 101},
        {"prefix": "osd tree"},
        {"prefix": "osd dump"},
    ],
    "tree_flags_weights": [
        {"prefix": "osd tree"},
        {"prefix": "osd set", "key": "noout"},
        {"prefix": "osd set", "key": "noout"},
        {"prefix": "osd set", "key": "noscrub"},
        {"prefix": "osd unset", "key": "noout"},
        {"prefix": "osd set", "key": "nothing"},
        {"prefix": "osd stat"},
        {"prefix": "osd reweight", "id": 1, "weight": 0.5},
        {"prefix": "osd reweight", "id": 1, "weight": 1.5},
        {"prefix": "osd reweight", "id": 99, "weight": 0.5},
        {"prefix": "osd primary-affinity", "id": 2, "weight": 0.25},
        {"prefix": "osd primary-affinity", "id": 99, "weight": 0.25},
        {"prefix": "osd out", "id": 3},
        {"prefix": "osd in", "id": 3},
        {"prefix": "osd out", "id": 99},
        {"prefix": "osd down", "id": 4},
        {"prefix": "osd setmaxosd", "num": 8},
        {"prefix": "osd tree"},
        {"prefix": "osd ls"},
        {"prefix": "osd dump"},
    ],
    "lost": [
        {"prefix": "osd lost", "id": 2},
        {"prefix": "osd lost", "id": 2, "yes_i_really_mean_it": True},
        {"prefix": "osd lost", "id": 99, "yes_i_really_mean_it": True},
        {"prefix": "osd down", "id": 2},
        {"prefix": "osd lost", "id": 2, "yes_i_really_mean_it": True},
        {"prefix": "osd dump"},
    ],
    "snaps": [
        {"prefix": "osd pool create", "pool": "r", "pg_num": 8},
        {"prefix": "osd pool mksnap", "pool": "r", "snap": "s1"},
        {"prefix": "osd pool mksnap", "pool": "r", "snap": "s1"},
        {"prefix": "osd pool mksnap", "pool": "r", "snap": "s2"},
        {"prefix": "osd pool lssnap", "pool": "r"},
        {"prefix": "osd pool rmsnap", "pool": "r", "snap": "s1"},
        {"prefix": "osd pool rmsnap", "pool": "r", "snap": "s1"},
        {"prefix": "osd pool mksnap", "pool": "nope", "snap": "s"},
        {"prefix": "osd pool selfmanaged-mksnap", "pool": "r"},
        {"prefix": "osd pool selfmanaged-rmsnap", "pool": "r",
         "snapid": 3},
        {"prefix": "osd pool selfmanaged-rmsnap", "pool": "r",
         "snapid": 2},
        {"prefix": "osd pool lssnap", "pool": "r"},
        {"prefix": "osd dump"},
    ],
    "tiers": [
        {"prefix": "osd pool create", "pool": "base", "pg_num": 8},
        {"prefix": "osd pool create", "pool": "hot", "pg_num": 8},
        {"prefix": "osd erasure-code-profile set", "name": "p",
         "profile": {"k": 2, "m": 1}},
        {"prefix": "osd pool create", "pool": "cold", "pg_num": 8,
         "pool_type": "erasure", "erasure_code_profile": "p"},
        {"prefix": "osd tier add", "pool": "base", "tierpool": "base"},
        {"prefix": "osd tier add", "pool": "base", "tierpool": "cold"},
        {"prefix": "osd tier add", "pool": "base", "tierpool": "hot"},
        {"prefix": "osd tier add", "pool": "base", "tierpool": "hot"},
        {"prefix": "osd tier cache-mode", "pool": "hot", "mode": "proxy"},
        {"prefix": "osd tier cache-mode", "pool": "base",
         "mode": "writeback"},
        {"prefix": "osd tier cache-mode", "pool": "hot",
         "mode": "writeback"},
        {"prefix": "osd tier set-overlay", "pool": "base",
         "overlaypool": "cold"},
        {"prefix": "osd tier set-overlay", "pool": "base",
         "overlaypool": "hot"},
        {"prefix": "osd tier remove", "pool": "base", "tierpool": "hot"},
        {"prefix": "osd tier remove-overlay", "pool": "base"},
        {"prefix": "osd tier remove", "pool": "base", "tierpool": "cold"},
        {"prefix": "osd tier remove", "pool": "base", "tierpool": "hot"},
        {"prefix": "osd tier add", "pool": "nope", "tierpool": "hot"},
        {"prefix": "osd dump"},
    ],
    "crush_and_misc": [
        {"prefix": "osd crush build-simple", "num_osds": 8,
         "osds_per_host": 4},
        {"prefix": "osd bogus"},
        {"prefix": "mon dump"},
        {"prefix": "osd dump"},
    ],
}


def _engines(monkeypatch):
    """Record the engine of every batched CRUSH call the port makes."""
    ck = PORT.crush_kernel
    seen, real = [], ck.batch_do_rule_arrays

    def spy(map_, ruleno, xs, result_max, weights, engine="device",
            *args, **kw):
        seen.append(engine)
        return real(map_, ruleno, xs, result_max, weights, engine, *args,
                    **kw)

    monkeypatch.setattr(ck, "batch_do_rule_arrays", spy)
    return seen


async def _script(p, steps):
    blob, mons = await start_mons([p])
    leader = await wait_quorum(mons)
    client, cmsgr = await make_client(p, blob)
    await client.command({"prefix": "osd crush build-simple",
                          "num_osds": 6, "osds_per_host": 2})
    om = await _boot(p, leader, range(6))
    out = []
    for c in steps:
        res = _normalized(p, c, await cmd(client, c))
        if c["prefix"] == "mon dump":
            res = res[:2]           # the monmap holds ephemeral ports
        out.append((c["prefix"], *res))
    await stop_all(mons, [cmsgr, om])
    return out


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_osd_monitor_commands_match_reference(script, monkeypatch):
    engines = _engines(monkeypatch)
    ck, kernel = PORT.crush_kernel, importlib.import_module(
        "ceph_tpu_torch.ec.kernel")
    before = (ck.crush_map_launches, ck.crush_straw2_winners_launches,
              kernel.gf_apply_launches)
    got = _run(_script(PORT, SCRIPTS[script]))
    want = _run(_script(REF, SCRIPTS[script]))
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert got == want
    # the mon maps on the CRUSH host engine: nothing reaches a kernel
    assert set(engines) <= {"host"}
    assert (ck.crush_map_launches, ck.crush_straw2_winners_launches,
            kernel.gf_apply_launches) == before
    if script in ("pg_num", "reweight"):
        assert engines, "the sweep did not run"
    if script == "pg_num":
        assert got[-2][1:3] == (-errno.EINVAL, "pg_num growth would leave "
                                               "every pg unmapped")
    if script == "reweight":
        avg = json.loads(got[4][2])["avg_pgs"]
        assert avg > 0 and got[3][1] == -errno.EINVAL


def test_pg_scrub_waits_for_the_osd_messages_module():
    """``pg scrub`` imports ``osd.messages`` (MPGScrub) lazily; the port
    brings that module with the OSD core, so until then its mon answers
    EIO naming the module where the reference parses the pgid."""
    async def run(p):
        steps = [{"prefix": "pg scrub", "pgid": "zz"},
                 {"prefix": "pg deep-scrub", "pgid": "1.0"}]
        return await _script(p, steps)
    ref = _run(run(REF))
    assert [r[1] for r in ref] == [-errno.EINVAL, -errno.ENOENT]
    port = _run(run(PORT))
    assert [r[1] for r in port] == [-errno.EIO, -errno.EIO]
    assert all("ceph_tpu_torch.osd.messages" in r[2] for r in port)


# ------------------------------------- PGMonitor, LogMonitor, FSMonitor

def _pg_rows(pool, pg_num, epoch, objects, errors=0, state="active+clean"):
    return [{"pgid": f"{pool}.{s:x}", "state": state,
             "num_objects": objects, "num_bytes": objects * 4096,
             "scrub_errors": errors if s == 0 else 0, "log_version": s}
            for s in range(pg_num)]


def _strip_stamps(x):
    if isinstance(x, dict):
        return {k: _strip_stamps(v) for k, v in x.items() if k != "stamp"}
    if isinstance(x, list):
        return [_strip_stamps(v) for v in x]
    return x


async def _services(p, tmpdir):
    sock = str(tmpdir / f"{p.root}.asok")
    blob, mons = await start_mons([p], cfg={"admin_socket": sock})
    leader = await wait_quorum(mons)
    client, cmsgr = await make_client(p, blob)
    await client.command({"prefix": "osd crush build-simple",
                          "num_osds": 4, "osds_per_host": 2})
    om = await _boot(p, leader, range(4))
    out = []
    for c in ({"prefix": "osd pool create", "pool": "r", "pg_num": 4,
               "size": 2},
              {"prefix": "osd pool create", "pool": "q", "pg_num": 2},
              {"prefix": "osd pool set", "pool": "q",
               "var": "quota_max_objects", "val": 10},
              {"prefix": "health"}, {"prefix": "pg stat"}):
        out.append(await cmd(client, c))
    addr = leader.messenger.addr
    e = leader.osdmon.osdmap.epoch
    for osd in range(2):
        rows = _pg_rows(1, 4, e, 5 + osd) if osd == 0 else \
            _pg_rows(2, 2, e, 8, errors=1, state="active+clean+inconsistent")
        om.send_message(p.msgs.MPGStats(osd, e, rows, {
            "num_pgs": len(rows), "statfs": {"total": 1 << 30,
                                             "used": (osd + 1) << 20,
                                             "free": (1 << 30) - (1 << 20)}}),
            addr, peer_type="mon")
    # a late report from an older epoch must not overwrite the rows
    om.send_message(p.msgs.MPGStats(3, e - 1, _pg_rows(1, 4, e - 1, 99),
                                    {}), addr, peer_type="mon")
    om.send_message(p.msgs.MLog([
        {"stamp": 1.5 + i, "who": f"osd.{i}", "level": lvl,
         "message": f"event {i}"}
        for i, lvl in enumerate(("INF", "WRN", "ERR"))]), addr,
        peer_type="mon")
    await wait_for(lambda: len(leader.logmon.recent) == 3
                   and len(leader.pgmon.pg_stats) == 6
                   and 3 in leader.pgmon.osd_stats, what="reports")
    # the quota check flips FLAG_FULL_QUOTA on pool q (16 objects >= 10)
    await wait_for(lambda: leader.osdmon.osdmap.pools[2].flags != 0,
                   what="quota flag")
    out.append(leader.osdmon.osdmap.pools[2].flags)
    for c in ({"prefix": "health"}, {"prefix": "df"},
              {"prefix": "osd df"}, {"prefix": "pg stat"},
              {"prefix": "pg dump"}, {"prefix": "log last", "num": 2},
              {"prefix": "status"}, {"prefix": "quorum_status"},
              {"prefix": "mds boot", "name": "mds.x",
               "addr": "127.0.0.1:7777/1", "rank": 0},
              {"prefix": "mds dump"},
              {"prefix": "config-key set", "key": "k1", "val": "v1"},
              {"prefix": "config-key get", "key": "k1"},
              {"prefix": "config-key get", "key": "k2"},
              {"prefix": "config-key ls"},
              {"prefix": "config-key rm", "key": "k1"},
              {"prefix": "config-key ls"}):
        rc, outs, outbl = await cmd(client, c)
        try:
            outs = _strip_stamps(json.loads(outs))
        except ValueError:
            pass
        out.append((c["prefix"], rc, outs, outbl))
    assert leader.fsmon.epoch >= 1
    assert b"mds.x" in leader.store_get("fsmap",
                                        f"full_{leader.fsmon.epoch}")
    loop = asyncio.get_running_loop()
    for c in ("mon_status", "log last 1"):
        out.append(await loop.run_in_executor(
            None, p.admin_socket.admin_command, sock, c))
    await stop_all(mons, [cmsgr, om])
    return out


def test_pg_log_and_fs_services_match_reference(tmp_path):
    got = _run(_services(PORT, tmp_path))
    want = _run(_services(REF, tmp_path))
    assert got == want
    health = next(o for o in got if isinstance(o, tuple)
                  and o[0] == "health")
    assert health[2]["status"] == "HEALTH_ERR"
    assert got[-2]["quorum"] == [0] and got[-1][0]["who"] == "osd.2"


# ------------------------------------------------------------ osd/shards

@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.root)
def test_shard_index_stable_and_covering(p):
    n = 4
    seen = set()
    for pool in range(4):
        for seed in range(64):
            pgid = p.PGId(pool, seed)
            i = p.shards.shard_index(pgid, n)
            assert 0 <= i < n
            seen.add(i)
            assert p.shards.shard_index(pgid, n) == i
            assert p.shards.shard_index(pgid.with_shard(2), n) == i
            assert i == REF.shards.shard_index(REF.PGId(pool, seed), n)
    assert seen == set(range(n))
    assert p.shards.shard_index(p.PGId(1, 2), 1) == 0


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.root)
def test_courier_fifo_and_batched_wakeups(p):
    async def run():
        c = p.shards.Courier(asyncio.get_running_loop(), "t")
        flushes, got = [], []
        c.on_flush = flushes.append
        for i in range(10):
            c.post(got.append, i)
        assert got == []                # nothing ran synchronously
        await asyncio.sleep(0)
        return got, flushes
    assert _run(run()) == (list(range(10)), [10])   # FIFO, one drain


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.root)
def test_courier_cross_thread_post(p):
    async def run():
        c = p.shards.Courier(asyncio.get_running_loop(), "x")
        got = []
        done = threading.Event()

        def producer():
            for i in range(50):
                c.post(got.append, i)
            done.set()

        t = threading.Thread(target=producer)
        t.start()
        await wait_for(lambda: done.is_set() and len(got) == 50,
                       what="cross-thread posts")
        t.join()
        return got
    assert _run(run()) == list(range(50))


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.root)
def test_resolve_future_from_a_foreign_thread(p):
    async def run():
        loop = asyncio.get_running_loop()
        same, other = loop.create_future(), loop.create_future()
        p.shards.resolve_future(same, 1)
        assert same.result() == 1
        t = threading.Thread(target=p.shards.resolve_future,
                             args=(other, None, ValueError("x")))
        t.start()
        t.join()
        with pytest.raises(ValueError):
            await asyncio.wait_for(other, 5)
    _run(run())


def test_post_home_sends_from_a_foreign_thread():
    """A send made on another thread than the messenger's home loop
    takes ``_post_home`` (the port's ``osd.shards.Courier``) and
    arrives, in order, once each."""
    class Collect:
        def __init__(self):
            self.got = []

        def ms_dispatch(self, m):
            self.got.append(m.note)
            return True

    async def run():
        a = PORT.Messenger(_ctx(PORT, "osd.1"), PORT.EntityName("osd", "1"))
        b = PORT.Messenger(_ctx(PORT, "osd.2"), PORT.EntityName("osd", "2"))
        col = Collect()
        b.add_dispatcher(col)
        await a.bind()
        await b.bind()

        def shard_thread():
            for i in range(20):
                a.send_message(PORT.MPing(f"x{i}"), b.addr)

        t = threading.Thread(target=shard_thread)
        t.start()
        t.join()
        await wait_for(lambda: len(col.got) == 20, what="20 pings")
        await asyncio.sleep(0.05)
        assert a._out_courier is not None and a._xthread_msgs == 20
        await a.shutdown()
        await b.shutdown()
        return col.got
    assert _run(run()) == [f"x{i}" for i in range(20)]


# ------------------------------------------ quorums across the packages

def _keyring(tmpdir):
    """One keyring file both packages read: the mon master key, an admin,
    a read-only client and an osd."""
    kr = REF.Keyring()
    kr.add("mon.")
    kr.add("client.admin", caps={"mon": "allow *", "osd": "allow *"})
    kr.add("client.readonly", caps={"mon": "allow r", "osd": "allow *"})
    kr.add("osd.0", caps={"mon": "allow profile osd", "osd": "allow *"})
    path = str(tmpdir / "keyring")
    kr.save(path)
    return path


async def _client_against_quorum(mon_pkg, client_pkg, tmpdir, cephx):
    """A MonClient of ``client_pkg`` drives a 3-mon quorum of
    ``mon_pkg``: what each entity may do, the map it learns, and (with
    cephx) what an unauthenticated client is refused."""
    cfg = {}
    if cephx:
        cfg = {"auth_supported": "cephx", "keyring": _keyring(tmpdir)}
    blob, mons = await start_mons([mon_pkg] * 3, cfg=cfg)
    leader = await wait_quorum(mons, size=3)
    out = {}
    admin, amsgr = await make_client(client_pkg, blob, cfg=cfg)
    await admin.authenticate()
    ro, romsgr = await make_client(client_pkg, blob, "client.readonly",
                                   cfg=cfg)
    await ro.authenticate()
    steps = [
        (admin, {"prefix": "osd crush build-simple", "num_osds": 4,
                 "osds_per_host": 2}),
        (admin, {"prefix": "osd pool create", "pool": "p", "pg_num": 8}),
        (admin, {"prefix": "config-key set", "key": "k", "val": "v"}),
        (admin, {"prefix": "config-key get", "key": "k"}),
        (ro, {"prefix": "osd pool ls"}),
        (ro, {"prefix": "osd pool create", "pool": "nope", "pg_num": 8}),
        (ro, {"prefix": "auth ls"}),
        (admin, {"prefix": "auth get-or-create", "entity": "client.new",
                 "caps": {"mon": "allow r"}}),
        (admin, {"prefix": "auth get", "entity": "client.new"}),
        (admin, {"prefix": "auth get", "entity": "client.ghost"}),
        (admin, {"prefix": "auth ls"}),
    ]
    rcs = []
    for who, c in steps:
        rc, outs, _ = await cmd(who, c, timeout=15)
        if c["prefix"] in ("auth get-or-create", "auth get") and rc == 0:
            # a key is random: compare what it may do, never its bytes
            kr = client_pkg.Keyring.loads(outs)
            assert len(kr.get_key(c["entity"])) > 0
            outs = kr.get_caps(c["entity"])
        elif c["prefix"] == "auth ls" and rc == 0:
            outs = json.loads(outs)
        rcs.append((c["prefix"], rc, outs))
    out["steps"] = rcs
    admin.sub_want("osdmap", 0)
    m = await admin.wait_for_osdmap(timeout=10)
    await wait_for(lambda: admin.osdmap.lookup_pool("p") >= 0,
                   what="pool in the client's map")
    assert admin.osdmap.to_bytes() == leader.store_get(
        "osdmap", f"full_{admin.osdmap.epoch}")
    out["map"] = masked_map(client_pkg, admin.osdmap.to_bytes())
    extra = [amsgr, romsgr]
    if cephx:
        sneak, smsgr = await make_client(client_pkg, blob, "client.sneak")
        out["sneak"] = (await cmd(sneak, {"prefix": "status"},
                                  timeout=3))[:2]
        extra.append(smsgr)
    admin.stop()
    ro.stop()
    await stop_all(mons, extra)
    return out


@pytest.mark.parametrize("cephx", [False, True], ids=["plain", "cephx"])
@pytest.mark.parametrize("direction", ["port_client_ref_mons",
                                       "ref_client_port_mons"])
def test_monclient_against_the_other_packages_quorum(tmp_path, direction,
                                                     cephx):
    client, mon = (PORT, REF) if direction == "port_client_ref_mons" \
        else (REF, PORT)
    across = _run(_client_against_quorum(mon, client, tmp_path, cephx))
    alone = _run(_client_against_quorum(mon, mon, tmp_path, cephx))
    assert across == alone
    rcs = [s[1] for s in across["steps"]]
    if cephx:
        # the read-only key may look, not write, not read the auth db
        assert rcs[4:7] == [0, -errno.EACCES, -errno.EACCES]
        assert across["steps"][8][2] == {"mon": "allow r"}
        assert across["sneak"][0] in (-errno.EACCES, -errno.ETIMEDOUT)
    else:
        assert all(rc == 0 for rc in rcs[:9])
    assert rcs[9] == -errno.ENOENT


async def _mixed(pkgs, tmpdir):
    """A quorum of mons from both packages: elect, commit through the
    leader, shut it down, commit through the new leader (the other
    package), restart the old one from its store; every mon stores equal
    values for every committed version."""
    stores = [p.FileDB(str(tmpdir / f"mon{i}")) for i, p in enumerate(pkgs)]
    # reconnects capped at 0.1 s, as chip_smoke's mon phase has them: a
    # restarted mon must hear its peers' acks within the election timeout
    cfg = {"ms_max_backoff": 0.1}
    blob, mons = await start_mons(pkgs, stores=stores, cfg=cfg)
    leader = await wait_quorum(mons, size=3)
    assert leader.rank == 0
    client, cmsgr = await make_client(PORT, blob)
    for c in ({"prefix": "osd crush build-simple", "num_osds": 6,
               "osds_per_host": 2},
              {"prefix": "osd pool create", "pool": "r", "pg_num": 16},
              {"prefix": "config-key set", "key": "a", "val": "1"}):
        await client.command(c)
    om = await _boot(pkgs[0], leader, range(6))

    def settled(group):
        lc = {m.paxos.last_committed for m in group}
        return len(lc) == 1 and all(m.paxos.state == "active"
                                    for m in group)

    await wait_for(lambda: settled(mons), what="peons caught up")
    first = [chip_smoke.mon_store_values(m) for m in mons]
    assert first[0] == first[1] == first[2]
    await leader.shutdown()
    rest = mons[1:]
    new_leader = await wait_quorum(rest, size=2, timeout=30)
    assert new_leader.rank == 1 and type(new_leader) is not type(leader)
    for c in ({"prefix": "osd pool create", "pool": "s", "pg_num": 8},
              {"prefix": "config-key set", "key": "b", "val": "2"},
              {"prefix": "osd out", "id": 3}):
        rc, outs, _ = await cmd(client, c, timeout=30)
        assert rc == 0, (c, outs)
    await wait_for(lambda: settled(rest), timeout=30, what="survivors agree")
    second = [chip_smoke.mon_store_values(m) for m in rest]
    assert second[0] == second[1]
    # committed versions never change
    assert all(second[0][k] == v for k, v in first[0].items()
               if k[0] == "paxos")
    # the old leader comes back from its FileDB and catches up
    p0 = pkgs[0]
    ctx = _ctx(p0, "mon.a", cfg)
    msgr = p0.Messenger(ctx, p0.EntityName("mon", "a"))
    back = p0.Monitor(ctx, "a", p0.MonMap.from_bytes(blob),
                      p0.FileDB(str(tmpdir / "mon0")), msgr)
    await back.start()
    mons = [back, *rest]
    await wait_quorum(mons, size=3, timeout=30)
    await wait_for(lambda: settled(mons), timeout=15, what="all agree")
    third = [chip_smoke.mon_store_values(m) for m in mons]
    assert third[0] == third[1] == third[2]
    out = {"versions": mons[0].paxos.last_committed,
           "osdmap": masked_map(PORT, new_leader.store_get(
               "osdmap", f"full_{new_leader.osdmon.osdmap.epoch}")),
           "keys": sorted(k for p, k in third[0] if p == "config-key")}
    await stop_all(mons, [cmsgr, om])
    return out


@pytest.mark.parametrize("layout", ["ref,port,ref", "port,ref,port"])
def test_mixed_quorum_elects_commits_and_fails_over(tmp_path, layout):
    pkgs = [REF if x == "ref" else PORT for x in layout.split(",")]
    out = _run(_mixed(pkgs, tmp_path), timeout=90)
    assert out["keys"] == [b"a", b"b"]
    m = PORT.OSDMap.from_bytes(out["osdmap"])
    assert m.lookup_pool("s") >= 0 and not m.is_in(3)


# ----------------------------------------- chip_smoke's mon phase, small

# The phase at a small size: 32 OSDs of one per host and 8 objects.  An
# RS k=8 m=4 rule over hosts needs 12 hosts; with few hosts per position
# CRUSH's indep retries can move a position besides the lost OSDs' (8
# names on 16-24 hosts, or 4 names on 32), and the phase checks that only
# those move, as holds for its 64 names on 1024 OSDs in 128 hosts.
SMALL = {"osds": 32, "per_host": 1, "rep_pgs": 64, "ec_pgs": 32,
         "ec_grown": 64}


def test_chip_smoke_mon_phase_on_the_cpu(tmp_path, capsys):
    """The script's mon phase on the CPU (the queue forced onto the plain
    apply, the host CRUSH engine): the quorum elects, the boots and the
    pools commit, the subscriber's map equals every mon's stored bytes,
    only the lost OSDs' positions move, every moved shard is rebuilt
    equal to the CPU codec's, avg_pgs equals the census, the leader
    fails over and comes back with equal stored values."""
    import torch

    from ceph_tpu_torch.ec import kernel
    rng = np.random.default_rng(15)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(8)]
    out = chip_smoke.mon_phase(np, kernel, torch.device("cpu"), "cpu",
                               objects, str(tmp_path), engine="host",
                               **SMALL)
    assert set(out["d1_launches"]) == set(chip_smoke.MON_D1_LAUNCHES)
    assert sum(out["d1_launches"].values()) == 0
    assert sum(out["k1_launches"].values()) == 0
    assert out["commit_s"]["n"] == 8 and out["boot_epochs"] >= 1
    assert out["moved_shards"] == sum(out["lost"].values()) > 0
    assert out["sweeps"]["avg_pgs"] > 0
    assert out["phase_s"] < 30
    text = capsys.readouterr().out
    for step in ("quorum", "boot", "pools", "commit", "subscribe", "place",
                 "encode", "down_out", "sweeps", "failover", "restart"):
        assert f"phase mon {step}:" in text, step


def test_chip_smoke_mon_phase_fails_on_an_error_from_a_mon(tmp_path,
                                                           monkeypatch):
    """A mon that logs at ERROR fails the phase, though every command and
    check of the phase passed: here the leader's tick raises (the mon
    logs "tick failed" and goes on)."""
    import torch

    from ceph_tpu_torch.ec import kernel
    from ceph_tpu_torch.mon.osd_monitor import OSDMonitor

    def broken(self):
        raise RuntimeError("down-out aging failed")

    monkeypatch.setattr(OSDMonitor, "tick", broken)
    rng = np.random.default_rng(16)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(8)]
    with pytest.raises(chip_smoke.SmokeFailure, match="tick failed"):
        chip_smoke.mon_phase(np, kernel, torch.device("cpu"), "cpu",
                             objects, str(tmp_path), engine="host",
                             **SMALL)


def _collateral_moves(osds, per_host, pg_num, n_names):
    """The phase's placement step on the host engine, without the mons:
    the map ``osd crush build-simple`` and ``osd pool create`` give (rule
    1 is the pool's chooseleaf indep rule over hosts), the names placed,
    the three OSDs holding the most shards down and out, the names
    placed again; returns (positions on the lost OSDs, other positions
    that moved)."""
    from ceph_tpu_torch.crush.builder import (build_hierarchy,
                                              make_erasure_rule,
                                              make_replicated_rule)
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.osd.osdmap import Incremental
    from ceph_tpu_torch.osd.types import OSD_UP, POOL_TYPE_ERASURE, PGPool
    crush = CrushMap()
    crush.max_devices = osds
    build_hierarchy(crush, osds, per_host)
    make_replicated_rule(crush, "replicated_rule")
    rule = make_erasure_rule(crush, "ec_ec84", 12)
    m = PORT.OSDMap()
    m.crush = crush
    m.set_max_osd(osds)
    inc = Incremental(1)
    for o in range(osds):
        inc.new_up[o] = PORT.EntityAddr("10.0.0.1", 6800, o + 1)
        inc.new_weight[o] = 0x10000
    inc.new_pools[2] = PGPool(POOL_TYPE_ERASURE, size=12, min_size=9,
                              crush_ruleset=rule, pg_num=pg_num,
                              ec_profile="rs84")
    m.apply_incremental(inc)
    names = [f"rbd_data.mon.{i:016x}" for i in range(n_names)]
    placed = m.map_objects_batch(2, names, engine="host")
    load = {}
    for _, acting, _ in placed:
        for o in acting:
            load[o] = load.get(o, 0) + 1
    lost = sorted(load, key=lambda o: (-load[o], o))[:3]
    inc = Incremental(2)
    for o in lost:
        inc.new_weight[o] = 0
        inc.new_state[o] = OSD_UP
    m.apply_incremental(inc)
    assert all(not m.is_up(o) and not m.is_in(o) for o in lost)
    again = m.map_objects_batch(2, names, engine="host")
    on_lost = sum(a[s] in lost for _, a, _ in placed for s in range(12))
    other = sum(a[s] not in lost and a[s] != b[s]
                for (_, a, _), (_, b, _) in zip(placed, again)
                for s in range(12))
    return on_lost, other


@pytest.mark.parametrize("osds,per_host,pg_num,n_names,want", [
    (1024, 8, 8192, 64, (15, 0)),     # chip_smoke's phase 15
    (32, 1, 32, 8, (18, 0)),          # SMALL
    (24, 1, 32, 8, (19, 1)), (20, 1, 32, 8, (20, 2)),
    (16, 1, 32, 8, (21, 7)), (32, 1, 32, 4, (9, 2))])
def test_only_the_lost_positions_move_at_the_phase_sizes(osds, per_host,
                                                         pg_num, n_names,
                                                         want):
    """The phase fails when a position off the three lost OSDs moves.
    CRUSH's indep retries can move one when few hosts serve the 12
    positions; at the phase's sizes none moves."""
    assert _collateral_moves(osds, per_host, pg_num, n_names) == want
