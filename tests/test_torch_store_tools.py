"""The port's offline store tools (``ceph_tpu_torch.tools.objectstore_tool``
and ``kvstore_tool``) against the JAX package's.

Each tool runs in both packages over byte-identical copies of one store
(written by the reference) and must print the same standard output and
standard error and return the same code, op by op; the stores the two
leave behind must stay byte-identical.  A PG exported by either
package's ``objectstore_tool`` is the same bytes, and it imports through
the other package's tool into a filestore, a blockstore or a kstore with
every object equal.  The port's tools also run as modules
(``python -m``).  Tolerance 0: text and bytes are compared exactly.
"""

import importlib
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("ceph_tpu", "ceph_tpu_torch")


def _tools(root):
    m = importlib.import_module
    return (m(root + ".tools.objectstore_tool"),
            m(root + ".tools.kvstore_tool"), m(root + ".store"))


TOOLS = {root: _tools(root) for root in PKGS}


def _build_store(path, kind="blockstore"):
    """A reference store with two PGs: three objects with data, an xattr
    and omap in 1.4, and one shard object in 2.0s1."""
    st = TOOLS["ceph_tpu"][2]
    s = st.ObjectStore.create(kind, path)
    s.mkfs()
    s.mount()
    cid = st.CollectionId.pg(1, 4)
    s.apply_transaction(st.Transaction().create_collection(cid))
    for i in range(3):
        o = st.ObjectId(f"obj{i}", pool=1)
        s.apply_transaction(st.Transaction().write(cid, o, 0, b"D" * (100 + i))
                            .setattr(cid, o, "_", b"m")
                            .omap_setheader(cid, o, b"hdr" * i)
                            .omap_setkeys(cid, o, {b"k": bytes([i])}))
    ec = st.CollectionId.pg(2, 0, shard=1)
    s.apply_transaction(st.Transaction().create_collection(ec)
                        .write(ec, st.ObjectId("chunk", pool=2, shard=1), 0,
                               bytes(range(256)) * 40))
    s.umount()


def _tree(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = fh.read()
    return out


def _fingerprint(s, cid):
    out = []
    for oid in s.collection_list(cid):
        hdr, omap = s.omap_get(cid, oid)
        out.append((oid.name, oid.pool, oid.shard, s.read(cid, oid),
                    sorted(s.getattrs(cid, oid).items()), hdr,
                    sorted(omap.items())))
    return out


def _run(capsys, fn, argv):
    rc = fn(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.fixture
def copies(tmp_path):
    """One reference blockstore, copied once per package."""
    src = str(tmp_path / "src")
    _build_store(src)
    out = {}
    for root in PKGS:
        out[root] = str(tmp_path / root)
        shutil.copytree(src, out[root])
    return out


OST_OPS = [
    ["--op", "list-pgs"],
    ["--op", "list"],
    ["--op", "list", "--pgid", "1.4"],
    ["--op", "list", "--pgid", "2.0s1_head"],
    ["--op", "info", "--pgid", "1.4", "--object", "obj1"],
    ["--op", "info", "--pgid", "1.4", "--object", "nope"],
    ["--op", "statfs"],
    ["--op", "remove", "--pgid", "1.4", "--object", "obj0"],
    ["--op", "list", "--pgid", "1.4"],
    ["--op", "remove", "--pgid", "2.0s1"],
    ["--op", "list-pgs"],
]


def test_objectstore_tool_prints_the_same(copies, capsys, tmp_path):
    """The same ops in order, each package's tool on its own copy: equal
    output and codes, and the stores stay byte-identical."""
    outs = {}
    for root in PKGS:
        ost = TOOLS[root][0]
        outs[root] = [_run(capsys, ost.main,
                           ["--data-path", copies[root], *op])
                      for op in OST_OPS]
        dump = str(tmp_path / f"{root}.bytes")
        outs[root].append(_run(capsys, ost.main, [
            "--data-path", copies[root], "--op", "get-bytes", "--pgid",
            "1.4", "--object", "obj2", "--file", dump]))
        with open(dump, "rb") as f:
            outs[root].append(f.read())
    assert outs["ceph_tpu_torch"] == outs["ceph_tpu"]
    got = outs["ceph_tpu_torch"]
    assert got[0] == (0, "1.4\n2.0s1\n", "")
    assert got[2][1].count("obj") == 3 and got[8][1].count("obj") == 2
    assert got[5][0] == 1 and "not found" in got[5][2]
    assert got[-1] == b"D" * 102
    assert _tree(copies["ceph_tpu_torch"]) == _tree(copies["ceph_tpu"])


@pytest.mark.parametrize("target", ["filestore", "blockstore", "kstore"])
@pytest.mark.parametrize("exporter,importer", [
    ("ceph_tpu", "ceph_tpu_torch"), ("ceph_tpu_torch", "ceph_tpu")],
    ids=["ref-to-port", "port-to-ref"])
def test_pg_export_crosses_packages_and_backends(copies, capsys, tmp_path,
                                                 exporter, importer,
                                                 target):
    blobs = {}
    for root in PKGS:
        blobs[root] = str(tmp_path / f"{root}.export")
        rc, out, err = _run(capsys, TOOLS[root][0].main, [
            "--data-path", copies[root], "--op", "export", "--pgid", "1.4",
            "--file", blobs[root]])
        assert rc == 0 and out.startswith("exported 1.4")
    with open(blobs["ceph_tpu"], "rb") as f:
        ref_blob = f.read()
    with open(blobs["ceph_tpu_torch"], "rb") as f:
        assert f.read() == ref_blob          # the same export bytes
    st = TOOLS[importer][2]
    dst = str(tmp_path / "dst")
    d = st.ObjectStore.create(target, dst)
    d.mkfs()
    argv = ["--data-path", dst, "--type", target, "--op", "import",
            "--file", blobs[exporter]]
    assert _run(capsys, TOOLS[importer][0].main, argv) == (
        0, "imported pg 1.4\n", "")
    # a second import is refused, alike in both packages
    again = [_run(capsys, TOOLS[root][0].main, argv) for root in PKGS]
    assert again[0] == again[1] and again[0][0] == 1
    cid = st.CollectionId.pg(1, 4)
    s = st.ObjectStore.create(target, dst)
    s.mount()
    got = _fingerprint(s, cid)
    s.umount()
    src = TOOLS["ceph_tpu"][2].ObjectStore.create("blockstore",
                                                  copies["ceph_tpu"])
    src.mount()
    want = _fingerprint(src, TOOLS["ceph_tpu"][2].CollectionId.pg(1, 4))
    src.umount()
    assert got == want and len(got) == 3


def test_import_refuses_a_foreign_file(tmp_path, capsys):
    bad = str(tmp_path / "junk")
    with open(bad, "wb") as f:
        f.write(b"\x05\x00\x00\x00hello")
    outs = []
    for root in PKGS:
        dst = str(tmp_path / f"fs-{root}")
        TOOLS[root][2].ObjectStore.create("filestore", dst).mkfs()
        outs.append(_run(capsys, TOOLS[root][0].main, [
            "--data-path", dst, "--type", "filestore", "--op", "import",
            "--file", bad]))
    assert outs[0] == outs[1] == (1, "", "not a pg export file\n")


def _kv_db(path):
    st = TOOLS["ceph_tpu"][2]
    db = st.FileDB(path)
    t = db.create_transaction()
    for i in range(5):
        t.set("p", f"k{i}", bytes([i]) * (i + 1))
    t.set("meta", b"\x00\xffbin", b"binary key").set("q", "only", b"")
    db.submit(t)
    db.close()


KV_OPS = [["list"], ["list", "p"], ["list", "none"], ["get", "p", "k3"],
          ["get", "meta", "0x00ff62696e"], ["get", "p", "missing"],
          ["stats"], ["rm", "p", "k0"], ["list", "p"], ["stats"],
          ["compact"], ["stats"]]


def test_kvstore_tool_prints_the_same(tmp_path, capsys):
    src = str(tmp_path / "src")
    _kv_db(src)
    outs = {}
    for root in PKGS:
        path = str(tmp_path / root)
        shutil.copytree(src, path)
        kvt = TOOLS[root][1]
        outs[root] = [_run(capsys, kvt.main, [path, *op]) for op in KV_OPS]
        out_file = str(tmp_path / f"{root}.val")
        outs[root].append(_run(capsys, kvt.main, [
            path, "get", "p", "k4", "--out", out_file])[0])
        with open(out_file, "rb") as f:
            outs[root].append(f.read())
        outs[root].append(_tree(path))
    assert outs["ceph_tpu_torch"] == outs["ceph_tpu"]
    got = outs["ceph_tpu_torch"]
    assert got[3] == (0, "03030303\n", "")
    assert got[5] == (1, "", "(no such key)\n")
    assert got[-2] == b"\x04" * 5


def test_kvstore_tool_on_a_blockstore_db(copies, capsys):
    outs = [[_run(capsys, TOOLS[root][1].main,
                  [os.path.join(copies[root], "db"), *op])
             for op in (["list"], ["list", "C"], ["stats"])]
            for root in PKGS]
    assert outs[0] == outs[1]
    assert "meta\tb'csum_type'" in outs[1][0][1]


def test_port_tools_run_as_modules(copies, capsys):
    """``python -m`` of each port tool prints what the reference's main
    prints in-process."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = {
        "objectstore_tool": ["--data-path", copies["ceph_tpu_torch"],
                             "--op", "list"],
        "kvstore_tool": [os.path.join(copies["ceph_tpu_torch"], "db"),
                         "stats"],
    }
    for tool, argv in runs.items():
        proc = subprocess.run(
            [sys.executable, "-m", f"ceph_tpu_torch.tools.{tool}", *argv],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        ref = importlib.import_module(f"ceph_tpu.tools.{tool}")
        ref_argv = [a.replace(copies["ceph_tpu_torch"], copies["ceph_tpu"])
                    for a in argv]
        assert (proc.returncode, proc.stdout, proc.stderr) == \
            _run(capsys, ref.main, ref_argv)
