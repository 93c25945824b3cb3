"""The port's erasure-code benchmark CLI (ceph_tpu_torch/tools/ec_benchmark.py)
with ``--device cpu`` at a small size: the reference's output contract
("<seconds>\\t<KiB>", then the --json line) for encode and decode."""

import json

import pytest

from ceph_tpu_torch.tools import ec_benchmark


@pytest.mark.parametrize("argv", [
    ["--workload", "encode"],
    ["--workload", "decode", "--erasures", "2"],
    ["--workload", "decode", "--erasures", "4", "--iterations", "2"],
])
def test_cli_output_contract(argv, capsys):
    size = 1 << 16
    rc = ec_benchmark.main(argv + ["--plugin", "rs", "-P", "k=8", "-P", "m=4",
                                   "--size", str(size), "--json",
                                   "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    secs, kib = lines[0].split("\t")
    assert float(secs) > 0
    iters = int(argv[argv.index("--iterations") + 1]) \
        if "--iterations" in argv else 1
    assert int(kib) == size * iters // 1024
    summary = json.loads(lines[1])
    assert summary["k"] == 8 and summary["m"] == 4
    assert summary["workload"] == argv[1]
    assert summary["device"] == "cpu"
    assert summary["bytes_per_iter"] == size


def test_cli_host_backend_profile(capsys):
    assert ec_benchmark.main(["--plugin", "isa", "-P", "k=4", "-P", "m=2",
                              "-P", "backend=host", "--size", "8192",
                              "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
