"""The port's crushtool and psim against the JAX package's, field for field.

``ceph_tpu_torch.tools.crushtool`` (``--build``, ``-d``, ``-c``, ``--test``)
and ``ceph_tpu_torch.tools.psim`` run in-process beside
``ceph_tpu.tools.crushtool`` and ``ceph_tpu.tools.psim`` on the same
arguments.  The port's ``--test`` and psim run on ``--device cpu`` (the
CUDA descent's plain torch version) and on ``--engine host``; each JSON
report must equal the reference's without its timing fields (``seconds``,
``mappings_per_sec``), and the text report line for line apart from its
timing line.  Sizes stay small (≤ 1024 inputs, ≤ 64 OSDs): the plain
torch descent is slow on the CPU.
"""

import contextlib
import io
import json

import pytest

from ceph_tpu.tools import crushtool as ref_crushtool
from ceph_tpu.tools import psim as ref_psim
from ceph_tpu_torch.tools import crushtool, psim

TIMING = ("seconds", "mappings_per_sec")
ENGINES = {"device-cpu": ["--device", "cpu"], "host": ["--engine", "host"]}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _strip(report):
    return {k: v for k, v in report.items() if k not in TIMING}


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """Map files written by the reference's --build: 64 OSDs 4 per host,
    and 8 OSDs 2 per host, where an EC rule of 6 over 4 hosts leaves
    holes; each also as the port writes it."""
    d = tmp_path_factory.mktemp("crushtool")
    out = {}
    for name, n, per in (("64x4", 64, 4), ("8x2", 8, 2)):
        ref_path, path = str(d / f"{name}.ref.bin"), str(d / f"{name}.bin")
        argv = ["--build", str(n), "--osds-per-host", str(per)]
        rc, _ = _run(ref_crushtool.main, argv + ["-o", ref_path])
        assert rc == 0
        rc, text = _run(crushtool.main, argv + ["-o", path])
        assert rc == 0 and text.startswith(f"built crush map: {n} osds")
        out[name] = (ref_path, path)
    return out


@pytest.mark.parametrize("name", ["64x4", "8x2"])
def test_build_writes_the_reference_bytes(maps, name):
    ref_path, path = maps[name]
    with open(ref_path, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["64x4", "8x2"])
def test_decompile_and_compile_match_reference(maps, name, tmp_path):
    ref_path, _ = maps[name]
    rc, ref_text = _run(ref_crushtool.main, ["-d", ref_path])
    assert rc == 0
    rc, text = _run(crushtool.main, ["-d", ref_path])
    assert rc == 0 and text == ref_text
    txt = tmp_path / "map.txt"
    assert crushtool.main(["-d", ref_path, "-o", str(txt)]) == 0
    assert txt.read_text() == ref_text
    out, ref_out = tmp_path / "map.bin", tmp_path / "map.ref.bin"
    rc, said = _run(crushtool.main, ["-c", str(txt), "-o", str(out)])
    rc_ref, ref_said = _run(ref_crushtool.main,
                            ["-c", str(txt), "-o", str(ref_out)])
    assert rc == rc_ref == 0
    assert said.replace(str(out), "") == ref_said.replace(str(ref_out), "")
    with open(ref_path, "rb") as f:
        assert out.read_bytes() == ref_out.read_bytes() == f.read()


def test_compile_error_exits_like_reference(tmp_path, capsys):
    bad = tmp_path / "bad.txt"
    bad.write_text("type 0 osd\nroot r { id -1 alg straw2 item ghost }\n")
    assert crushtool.main(["-c", str(bad), "-o", str(tmp_path / "x")]) == 1
    port_err = capsys.readouterr().err
    assert ref_crushtool.main(["-c", str(bad),
                               "-o", str(tmp_path / "y")]) == 1
    assert port_err == capsys.readouterr().err
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name,rule,rep,lo,hi", [
    ("64x4", 0, 3, 0, 1023), ("64x4", 1, 6, 100, 611),
    ("8x2", 1, 6, 0, 255), ("8x2", 0, 5, 7, 300)])
def test_test_json_report_matches_reference(maps, engine, name, rule, rep,
                                            lo, hi):
    ref_path, path = maps[name]
    argv = ["--test", ref_path, "--rule", str(rule), "--num-rep", str(rep),
            "--min-x", str(lo), "--max-x", str(hi), "--json"]
    rc, ref_out = _run(ref_crushtool.main, argv)
    assert rc == 0
    rc, out = _run(crushtool.main, argv + ENGINES[engine])
    assert rc == 0
    got, want = json.loads(out), json.loads(ref_out)
    assert _strip(got) == _strip(want)
    assert list(got) == list(want)          # the reference's field order
    assert got["inputs"] == hi - lo + 1 and got["seconds"] > 0


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_test_text_report_matches_reference(maps, engine):
    ref_path, _ = maps["8x2"]
    argv = ["--test", ref_path, "--rule", "1", "--num-rep", "6",
            "--max-x", "511"]
    _, ref_out = _run(ref_crushtool.main, argv)
    _, out = _run(crushtool.main, argv + ENGINES[engine])

    def lines(text):
        return [ln for ln in text.splitlines() if not ln.startswith("timing")]
    assert lines(out) == lines(ref_out)
    assert "result size == 6:\t512/512" in out


def test_test_defaults_to_the_device_engine_on_cuda(maps):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(crushtool.main, ["--test", maps["64x4"][0], "--max-x", "15"])


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("osds,hosts,pgs,size,objects", [
    (64, 16, 1024, 3, 100000), (32, 2, 256, 3, 5000),
    (24, 8, 512, 2, 77777)])
def test_psim_report_matches_reference(engine, osds, hosts, pgs, size,
                                       objects):
    argv = ["--osds", str(osds), "--hosts", str(hosts), "--pgs", str(pgs),
            "--size", str(size), "--objects", str(objects)]
    rc, ref_out = _run(ref_psim.main, argv + ["--engine", "host"])
    assert rc == 0
    rc, out = _run(psim.main, argv + ENGINES[engine])
    assert rc == 0
    assert out == ref_out
    rep = json.loads(out)
    assert rep["osds"] == osds and rep["pgs"] == pgs


def test_psim_simulate_defaults_to_the_device_engine_on_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    m = psim.build_map(16, 4, 64, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psim.simulate(m, 1000)
