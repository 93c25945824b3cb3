"""Card-only checks of the port: the CUDA kernel against its plain version
on the card, and the batch queue's device path on CUDA.

Marked ``gpu``.  Whether a card is present is decided inside the
``cuda`` fixture, so every worker collects the same tests; without a
card each test skips with the reason.  Run them on a card with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest`` (the
suite's conftest.py imports jax, which a machine that runs only the port
need not have).  The kernel's output
is integer bytes, so every comparison is exact: no tolerance.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import gf256, kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _check(ops, data):
    got = kernel.gf_apply(ops, data)
    want = kernel.gf_apply_plain(ops.bitmat, data)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("k,r,L", [(8, 4, 1 << 20), (8, 4, 333),
                                   (8, 4, 9000), (2, 1, 64), (6, 3, 4097),
                                   (200, 50, 999), (1, 1, 1)])
def test_kernel_matches_plain_on_card(cuda, k, r, L):
    rng = np.random.default_rng(k * 1000 + r + L)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (k, L), dtype=np.uint8))
    got = _check(kernel.from_reference_matrix(mat, cuda), data.to(cuda))
    if L <= 10000:
        assert np.array_equal(got.cpu().numpy(),
                              gf256.host_apply(mat, data.numpy()))


@pytest.mark.parametrize("start,width", [(0, 65536), (16, 40000),
                                         (3, 1000), (7, 50001)])
def test_kernel_on_strided_windows(cuda, start, width):
    rng = np.random.default_rng(start)
    mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
    big = torch.from_numpy(
        rng.integers(0, 256, (8, 100003), dtype=np.uint8)).to(cuda)
    _check(kernel.from_reference_matrix(mat, cuda),
           big[:, start:start + width])


def test_kernel_counts_launches_and_rejects_layouts(cuda):
    mat = gf256.rs_vandermonde_matrix(4, 2)[4:]
    ops = kernel.from_reference_matrix(mat, cuda)
    data = torch.zeros((4, 1024), dtype=torch.uint8, device=cuda)
    before = kernel.gf_apply_launches
    kernel.gf_apply(ops, data)
    assert kernel.gf_apply_launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gf_apply(ops, data[:, ::2])
    with pytest.raises(ValueError):
        kernel.gf_apply(ops, data.cpu())


def test_queue_device_path_on_card(cuda):
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue

    async def run():
        q = ECBatchQueue(Context("osd.0"), mode="on", device=cuda,
                         min_device_bytes=256)
        mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
        rng = np.random.default_rng(0)
        ins = [rng.integers(0, 256, (8, 3000 + 16 * i), dtype=np.uint8)
               for i in range(6)]
        before = kernel.gf_apply_launches
        outs = await asyncio.gather(*[q.apply(mat, c) for c in ins])
        for c, o in zip(ins, outs):
            assert np.array_equal(o, gf256.host_apply(mat, c))
        d = q.perf.dump()
        assert d["host_requests"] == 0 and d["device_requests"] == 6
        assert kernel.gf_apply_launches - before == d["device_launches"]
        await q.stop()
    asyncio.run(run())


def test_kernel_writes_strided_out_window(cuda):
    rng = np.random.default_rng(5)
    mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
    ops = kernel.from_reference_matrix(mat, cuda)
    big = torch.from_numpy(
        rng.integers(0, 256, (8, 100000), dtype=np.uint8)).to(cuda)
    wide = torch.full((4, 120000), 7, dtype=torch.uint8, device=cuda)
    kernel.gf_apply(ops, big[:, 16:65552], out=wide[:, 4096:69632])
    want = kernel.gf_apply_plain(ops.bitmat, big[:, 16:65552])
    torch.cuda.synchronize()
    assert torch.equal(wide[:, 4096:69632], want)
    assert bool((wide[:, :4096] == 7).all()) and \
        bool((wide[:, 69632:] == 7).all())


@pytest.mark.parametrize("fault", ["refused_launch", "failed_build"])
def test_queue_device_failure_reaches_callers_on_card(cuda, monkeypatch,
                                                      fault):
    """On CUDA a failed group raises to its callers; it never turns into
    host work."""
    from ceph_tpu_torch.common import cuda_build
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue

    if fault == "refused_launch":
        class Refusing:
            @staticmethod
            def gf_apply(*args):
                return 1                    # cudaErrorInvalidValue

            @staticmethod
            def gf_apply_error_string(code):
                return b"invalid argument"
        monkeypatch.setattr(kernel, "_library", lambda: Refusing)
    else:
        def no_nvcc(name):
            raise RuntimeError("nvcc not found")
        monkeypatch.setattr(kernel, "_lib", None)
        monkeypatch.setattr(cuda_build, "build", no_nvcc)

    async def run():
        q = ECBatchQueue(Context("osd.0"), mode="on", device=cuda,
                         min_device_bytes=256)
        mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
        ins = [np.full((8, 4096), i, dtype=np.uint8) for i in range(3)]
        outs = await asyncio.gather(*[q.apply(mat, c) for c in ins],
                                    return_exceptions=True)
        assert all(isinstance(o, RuntimeError) for o in outs), outs
        d = q.perf.dump()
        assert d["host_requests"] == 0 and d["device_requests"] == 0
        await q.stop()
    asyncio.run(run())
