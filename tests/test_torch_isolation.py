"""The port imports neither JAX nor the JAX package.

Every module of ceph_tpu_torch/, chip_smoke.py and crush_probe.py is
walked with ``ast``:
no ``import jax``/``jaxlib``/``ceph_tpu`` (``ceph_tpu_torch`` is the port
itself).  Then the package is imported in a fresh interpreter, which
must end with no ``jax`` in ``sys.modules``.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "crush_probe.py")]
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
    for script in ("chip_smoke.py", "crush_probe.py"):
        assert os.path.join(ROOT, script) in srcs and os.path.exists(
            os.path.join(ROOT, script))
    assert len(srcs) > 15
    # every subpackage the port has is in the walk
    for mod in ("ec/kernel.py", "crush/mapper.py", "ops/crush_kernel.py",
                "osd/osdmap.py", "msg/types.py", "tools/osdmaptool.py",
                "common/encoding.py", "native/__init__.py", "ec/lrc.py",
                "ec/shec.py", "crush/compiler.py", "tools/crushtool.py",
                "tools/psim.py", "common/crc.py", "common/xxhash.py"):
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
