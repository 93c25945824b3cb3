"""The port imports neither JAX nor the JAX package.

Every module of ceph_tpu_torch/, chip_smoke.py, crush_probe.py and
smoke_walls.py is walked with ``ast``:
no ``import jax``/``jaxlib``/``ceph_tpu`` (``ceph_tpu_torch`` is the port
itself).  Then the package is imported in a fresh interpreter, which
must end with no ``jax`` in ``sys.modules``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")
#: the common/, auth/ and msg/ modules and perf_msgr, each at the
#: reference's path
SLICE6 = ("common/envutil.py", "common/config.py", "common/logging.py",
          "common/tracer.py", "common/lockdep.py", "common/op_tracker.py",
          "common/wpq.py", "common/qos.py", "common/metrics.py",
          "common/backoff.py", "common/admin_socket.py",
          "common/context.py", "auth/__init__.py", "auth/caps.py",
          "auth/keyring.py", "auth/cephx.py", "msg/__init__.py",
          "msg/payload.py", "msg/message.py", "msg/messenger.py",
          "tools/perf_msgr.py", "version.py")
#: the compressor/ and store/ modules and the two store tools
SLICE7 = ("compressor/registry.py", "compressor/__init__.py",
          "store/types.py", "store/wal.py", "store/kv.py", "store/commit.py",
          "store/objectstore.py", "store/memstore.py", "store/filestore.py",
          "store/kstore.py", "store/blockstore.py", "store/__init__.py",
          "tools/objectstore_tool.py", "tools/kvstore_tool.py")
#: the monitor and the shard plumbing the mon client and the messenger use
SLICE8 = ("mon/monmap.py", "mon/messages.py", "osd/shards.py",
          "mon/elector.py", "mon/paxos.py", "mon/monitor.py",
          "mon/osd_monitor.py", "mon/auth_monitor.py", "mon/pg_monitor.py",
          "mon/fs_monitor.py", "mon/client.py", "mon/__init__.py")

#: the object classes
SLICE12 = tuple(f"cls/{m}.py" for m in (
    "__init__", "lock", "version", "refcount", "rbd", "journal", "numops",
    "rgw", "log", "timeindex", "user", "statelog", "replica_log",
    "inotable"))


#: mesh mode and the rest of the client
SLICE13 = ("parallel/__init__.py", "parallel/layout.py",
           "parallel/mesh_exec.py", "services/__init__.py",
           "services/striper.py", "client/object_cacher.py",
           "client/rados_striper.py", "qa/rados_model.py")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "crush_probe.py"),
           os.path.join(ROOT, "smoke_walls.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ceph_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_sources_exist():
    srcs = _sources()
    for script in ("chip_smoke.py", "crush_probe.py", "smoke_walls.py"):
        assert os.path.join(ROOT, script) in srcs and os.path.exists(
            os.path.join(ROOT, script))
    assert len(srcs) > 15
    # every subpackage the port has is in the walk
    for mod in ("ec/kernel.py", "crush/mapper.py", "ops/crush_kernel.py",
                "osd/osdmap.py", "msg/types.py", "tools/osdmaptool.py",
                "common/encoding.py", "native/__init__.py", "ec/lrc.py",
                "ec/shec.py", "crush/compiler.py", "tools/crushtool.py",
                "tools/psim.py", "common/crc.py", "common/xxhash.py",
                *SLICE6, *SLICE7, *SLICE8, *SLICE12, *SLICE13):
        assert os.path.join(ROOT, "ceph_tpu_torch", mod) in srcs, mod


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, pkgutil, importlib, ceph_tpu_torch\n"
            "for m in pkgutil.walk_packages(ceph_tpu_torch.__path__, "
            "'ceph_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'ceph_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice6_modules_mirror_the_reference_and_import_alone():
    """Each module of the slice sits at its reference's path, and
    importing the messenger, auth and the context in a fresh interpreter
    loads neither JAX nor the JAX package."""
    for mod in SLICE6:
        assert os.path.exists(os.path.join(ROOT, "ceph_tpu", mod)), mod
    code = ("import sys\n"
            "import ceph_tpu_torch.msg, ceph_tpu_torch.auth\n"
            "import ceph_tpu_torch.common.context\n"
            "import ceph_tpu_torch.tools.perf_msgr\n"
            "from ceph_tpu_torch.common.backoff import BackoffGiveUp\n"
            "assert issubclass(BackoffGiveUp, TimeoutError)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'ceph_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice7_modules_mirror_the_reference_and_import_alone():
    """Each store and compressor module sits at its reference's path, and
    importing the store, the compressor and the two tools in a fresh
    interpreter loads neither JAX nor the JAX package."""
    for mod in SLICE7:
        assert os.path.exists(os.path.join(ROOT, "ceph_tpu", mod)), mod
    code = ("import sys\n"
            "import ceph_tpu_torch.store, ceph_tpu_torch.compressor\n"
            "import ceph_tpu_torch.store.blockstore\n"
            "import ceph_tpu_torch.store.kstore\n"
            "import ceph_tpu_torch.tools.objectstore_tool\n"
            "import ceph_tpu_torch.tools.kvstore_tool\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'ceph_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice8_modules_mirror_the_reference_and_import_alone():
    """Each mon module and osd/shards sits at its reference's path, and
    importing the mon (its services too) in a fresh interpreter loads
    neither JAX nor the JAX package, nor the OSD modules that shards.py
    and osd_monitor.py import only on their lane, extent and scrub
    paths."""
    assert len(SLICE8) == 12
    for mod in SLICE8:
        assert os.path.exists(os.path.join(ROOT, "ceph_tpu", mod)), mod
    code = ("import sys\n"
            "import ceph_tpu_torch.mon, ceph_tpu_torch.osd.shards\n"
            "import ceph_tpu_torch.mon.auth_monitor\n"
            "import ceph_tpu_torch.mon.pg_monitor\n"
            "import ceph_tpu_torch.mon.fs_monitor\n"
            "lazy = [n for n in ('lanes', 'extents', 'messages') if\n"
            "        'ceph_tpu_torch.osd.' + n in sys.modules]\n"
            "assert not lazy, lazy\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'ceph_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice12_modules_mirror_the_reference_and_import_alone():
    """The port's cls/ holds every module of the reference's, at the same
    paths; importing it registers every class and loads neither JAX, the
    JAX package, nor the OSD's messages, which the staging calls import
    only when a method writes."""
    ref = sorted(f for f in os.listdir(os.path.join(ROOT, "ceph_tpu", "cls"))
                 if f.endswith(".py"))
    assert sorted(m.split("/")[1] for m in SLICE12) == ref
    code = ("import sys\n"
            "import ceph_tpu_torch.cls as cls\n"
            "assert len(cls._METHODS) == 65, len(cls._METHODS)\n"
            "assert 'ceph_tpu_torch.osd.messages' not in sys.modules\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'ceph_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_smoke_walls_splits_the_output_by_phase():
    """Each phase runs from the previous phase's last line to its own;
    an indented line counts to the phase before it, the lines before
    the first phase to ``start``, and a phase seen again adds up."""
    sys.path.insert(0, ROOT)
    try:
        import smoke_walls
    finally:
        sys.path.remove(ROOT)
    stamped = [(1.0, "card: x"), (3.0, "phase build: 2 s"),
               (4.0, "phase main_path encode"), (4.5, "  osd.0: 1"),
               (6.0, "phase store place"), (7.0, "phase main_path again")]
    assert smoke_walls.phase_walls(stamped, 7.25) == {
        "start": 1.0, "build": 2.0, "main_path": 2.5, "store": 1.5,
        "end": 0.25}
    assert smoke_walls.phase_walls([], 2.0) == {"start": 0.0, "end": 2.0}


def test_smoke_walls_runs_the_script_and_passes_its_code_on(tmp_path):
    """Run against a directory whose chip_smoke.py prints two phases and
    exits 3: the lines come back stamped, the last line is the JSON of
    the phases' walls, and the exit code is the script's."""
    (tmp_path / "chip_smoke.py").write_text(
        "import sys\nprint('card: none')\nprint('phase one: a')\n"
        "print('phase two: b')\nsys.exit(3)\n")
    run = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "smoke_walls.py"),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=60)
    assert run.returncode == 3
    lines = run.stdout.splitlines()
    assert [ln.split(None, 1)[1] for ln in lines[:-1]] == [
        "card: none", "phase one: a", "phase two: b"]
    last = json.loads(lines[-1])
    assert last["rc"] == 3 and last["total_s"] > 0
    assert list(last["phases_s"]) == ["start", "one", "two", "end"]
    assert abs(sum(last["phases_s"].values()) - last["total_s"]) < 1e-6


def test_slice13_modules_mirror_the_reference_and_import_alone():
    """Mesh mode (parallel/), the striper service, the write-back cache,
    the striped client and the model checker sit at their reference's
    paths; importing them in a fresh interpreter loads neither JAX nor
    the JAX package, and the services package exports the striper
    alone (the reference's also exports rbd, not ported yet)."""
    for mod in SLICE13:
        assert os.path.exists(os.path.join(ROOT, "ceph_tpu", mod)), mod
    code = ("import sys\n"
            "import ceph_tpu_torch.parallel.mesh_exec\n"
            "import ceph_tpu_torch.parallel.layout\n"
            "import ceph_tpu_torch.services as services\n"
            "import ceph_tpu_torch.client.object_cacher\n"
            "import ceph_tpu_torch.client.rados_striper\n"
            "import ceph_tpu_torch.qa.rados_model\n"
            "assert sorted(services.__all__) == ['Extent', 'Layout', "
            "'extents_by_object', 'file_to_extents']\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'ceph_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
