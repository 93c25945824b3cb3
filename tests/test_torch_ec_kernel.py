"""The port's GF(2^8) matrix apply (ceph_tpu_torch/ec/kernel.py) against
the JAX package's.

The same numpy-seeded inputs go through the port on the CPU (the plain
PyTorch version) and through the reference: ``gf256.host_apply``,
``ceph_tpu.ec.kernel.matrix_apply`` and the Pallas kernel in interpret
mode.  All of the arithmetic is integer, so every comparison is exact:
no tolerance.  A numpy model of the CUDA kernel's arithmetic (its
tables, selectors and byte-permute lookups, word by word) checks the
kernel's method without a card; the kernel itself is held against the
plain version in test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ceph_tpu.ec import gf256 as ref_gf256
from ceph_tpu.ec import kernel as ref_kernel

from ceph_tpu_torch.common import devstats
from ceph_tpu_torch.ec import gf256, kernel

SHAPES = [(1, 2, 64), (4, 8, 1024), (3, 5, 333), (4, 8, 8192), (3, 5, 9000)]


def _case(r, k, L, seed):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    chunks = rng.integers(0, 256, (k, L), dtype=np.uint8)
    return mat, chunks


def _decode_case(k, m, lost, L, seed):
    """A decode matrix from the reference (rows rebuilding `lost` from the
    first k survivors) and the survivors' bytes."""
    gen = ref_gf256.rs_vandermonde_matrix(k, m)
    present = [i for i in range(k + m) if i not in lost][:k]
    mat = ref_gf256.decode_matrix(gen, present, list(lost))
    rng = np.random.default_rng(seed)
    return mat, rng.integers(0, 256, (k, L), dtype=np.uint8)


def prmt(a, b, sel):
    """PTX ``prmt.b32`` in its default mode, on uint32 arrays: byte n of
    the result is byte ``(sel >> 4n) & 7`` of the 8 bytes b:a.  A set bit
    3 in a selector nibble would replicate that byte's sign bit instead;
    the kernel keeps it clear, and this model refuses it."""
    a, b, sel = (np.asarray(v, np.uint64) for v in (a, b, sel))
    v = (b << np.uint64(32)) | a
    d = np.zeros(np.broadcast(a, b, sel).shape, np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(15)
        assert not (nib & np.uint64(8)).any(), "selector bit 3 set"
        d |= ((v >> (np.uint64(8) * nib)) & np.uint64(0xFF)) \
            << np.uint64(8 * n)
    return d.astype(np.uint32)


def selectors(x):
    """The kernel's selectors of the 3-, 3- and 2-bit fields of each byte
    of the uint32 words x: y = (x >> s) & m, then y + (y >> 12), which
    puts the fields of bytes 0, 2, 1, 3 into the low four nibbles."""
    x = np.asarray(x, np.uint32)
    out = []
    for shift, mask in ((0, 0x07070707), (3, 0x07070707), (6, 0x03030303)):
        y = (x >> np.uint32(shift)) & np.uint32(mask)
        out.append(y + (y >> np.uint32(12)))
    return out


def emulate_cuda_kernel(tables, chunks, lanes=16):
    """What csrc/gf_apply.cu computes, in numpy, word by word: lanes go
    ``lanes`` to a thread, and lanes past L load as zeros (the masked
    ragged tail).  For each input row j the selectors of every 4-lane
    word are made once; each output row i XORs the three prmt lookups
    into its accumulator (bytes in the order 0, 2, 1, 3), and each output
    word is restored by prmt(acc, 0, 0x3120) before the masked store."""
    r, k, _ = tables.shape
    L = chunks.shape[1]
    width = -(-L // lanes) * lanes
    x = np.zeros((k, width), np.uint8)
    x[:, :L] = chunks
    xw = x.view("<u4")
    tw = np.ascontiguousarray(tables).view("<u4")       # [r, k, 8] words
    acc = np.zeros((r, width // 4), np.uint32)
    for j in range(k):
        s0, s1, s2 = selectors(xw[j])
        for i in range(r):
            t = tw[i, j]
            acc[i] ^= (prmt(t[0], t[1], s0) ^ prmt(t[2], t[3], s1)
                       ^ prmt(t[4], 0, s2))
    out = prmt(acc, 0, 0x3120).astype("<u4").view(np.uint8)
    return out.reshape(r, width)[:, :L]


@pytest.mark.parametrize("r,k,L", SHAPES)
def test_matrix_apply_matches_reference_host_and_xla(r, k, L):
    mat, chunks = _case(r, k, L, seed=r * 100 + k + L)
    got = kernel.matrix_apply(mat, device="cpu")(chunks)
    assert got.dtype == np.uint8 and got.shape == (r, L)
    assert np.array_equal(got, ref_gf256.host_apply(mat, chunks))
    assert np.array_equal(got, ref_kernel.matrix_apply(mat)(chunks))


@pytest.mark.parametrize("r,k,L", SHAPES)
def test_matrix_apply_matches_reference_pallas_interpret(r, k, L):
    mat, chunks = _case(r, k, L, seed=7 + L)
    bm = jnp.asarray(ref_gf256.expand_to_bitmatrix(mat), jnp.int8)
    want = np.asarray(ref_kernel._apply_bitmatrix_pallas(
        bm, jnp.asarray(chunks), interpret=True))
    assert np.array_equal(kernel.matrix_apply(mat, device="cpu")(chunks),
                          want)


@pytest.mark.parametrize("lost", [(0,), (1, 5), (0, 2, 9), (3, 4, 8, 11)])
def test_decode_matrices_match_reference(lost):
    mat, surv = _decode_case(8, 4, lost, 9000, seed=len(lost))
    got = kernel.matrix_apply(mat, device="cpu")(surv)
    assert np.array_equal(got, ref_gf256.host_apply(mat, surv))
    assert np.array_equal(got, ref_kernel.matrix_apply(mat)(surv))


def test_prmt_tables_multiply_every_coefficient_and_byte():
    """All 65,536 (c, b) pairs through the tables and the kernel's
    arithmetic against the reference's field multiplication."""
    coeffs = np.arange(256, dtype=np.uint8)[:, None]
    tables = kernel.prmt_tables(coeffs)
    assert tables.shape == (256, 1, 32) and tables.dtype == np.uint8
    assert not tables[:, :, 20:].any()
    got = emulate_cuda_kernel(tables, np.arange(256, dtype=np.uint8)[None])
    want = np.array([[ref_gf256.gf_mul(c, b) for b in range(256)]
                     for c in range(256)], np.uint8)
    assert np.array_equal(got, want)


def test_selectors_pack_fields_in_lane_order_0_2_1_3():
    """Every byte value in every lane: nibble n of the selector holds the
    field of lane (0, 2, 1, 3)[n], bit 3 clear."""
    b = np.arange(256, dtype=np.uint32)
    for lane in range(4):
        for other in (0, 0xFF):
            x = np.full(256, other * 0x01010101, np.uint32)
            x &= ~np.uint32(0xFF << (8 * lane))
            x |= b << np.uint32(8 * lane)
            fields = [b & 7, (b >> 3) & 7, b >> 6]
            pos = (0, 2, 1, 3).index(lane)
            for sel, field in zip(selectors(x), fields):
                nib = (sel >> np.uint32(4 * pos)) & np.uint32(15)
                assert np.array_equal(nib, field)


@pytest.mark.parametrize("r,k,L", SHAPES + [(2, 8, 17), (1, 1, 1),
                                            (55, 200, 333)])
def test_prmt_emulation_matches_reference(r, k, L):
    mat, chunks = _case(r, k, L, seed=11 + L)
    assert np.array_equal(emulate_cuda_kernel(kernel.prmt_tables(mat), chunks),
                          ref_gf256.host_apply(mat, chunks))


@pytest.mark.parametrize("lost", [(0,), (1, 5), (0, 2, 9), (3, 4, 8, 11),
                                  (1, 2, 10)])
def test_prmt_emulation_on_decode_matrices(lost):
    mat, surv = _decode_case(8, 4, lost, 4099, seed=3 + len(lost))
    assert np.array_equal(emulate_cuda_kernel(kernel.prmt_tables(mat), surv),
                          ref_gf256.host_apply(mat, surv))


def test_prmt_emulation_matches_pallas_interpret():
    mat, chunks = _case(4, 8, 1000, seed=17)
    bm = jnp.asarray(ref_gf256.expand_to_bitmatrix(mat), jnp.int8)
    want = np.asarray(ref_kernel._apply_bitmatrix_pallas(
        bm, jnp.asarray(chunks), interpret=True))
    assert np.array_equal(
        emulate_cuda_kernel(kernel.prmt_tables(mat), chunks, lanes=32), want)


def test_from_reference_matrix_operands():
    mat = ref_gf256.rs_vandermonde_matrix(8, 4)[8:]
    ops = kernel.from_reference_matrix(mat, "cpu")
    assert np.array_equal(ops.mat, mat)
    assert ops.tables.device.type == "cpu"
    assert np.array_equal(ops.tables.numpy(), kernel.prmt_tables(mat))
    assert np.array_equal(ops.bitmat.numpy(),
                          ref_gf256.expand_to_bitmatrix(mat))
    with pytest.raises(ValueError):
        kernel.from_reference_matrix(np.zeros((3,), np.uint8), "cpu")
    with pytest.raises(ValueError):
        kernel.from_reference_matrix(np.zeros((200, 60), np.uint8), "cpu")


def test_plain_version_takes_the_reference_bitmatrix():
    mat, chunks = _case(4, 8, 1000, seed=5)
    bm = torch.from_numpy(ref_gf256.expand_to_bitmatrix(mat))
    got = kernel.gf_apply_plain(bm, torch.from_numpy(chunks))
    assert np.array_equal(got.numpy(), ref_gf256.host_apply(mat, chunks))


def test_port_gf256_is_a_faithful_copy():
    for k, m in [(2, 1), (8, 4), (6, 3)]:
        assert np.array_equal(gf256.rs_vandermonde_matrix(k, m),
                              ref_gf256.rs_vandermonde_matrix(k, m))
        assert np.array_equal(gf256.cauchy_matrix(k, m),
                              ref_gf256.cauchy_matrix(k, m))
    assert np.array_equal(gf256.mul_table(), ref_gf256.mul_table())
    gen = gf256.rs_vandermonde_matrix(8, 4)
    assert np.array_equal(gf256.decode_matrix(gen, [1, 2, 3, 4, 5, 6, 7, 8],
                                              [0, 11]),
                          ref_gf256.decode_matrix(gen, [1, 2, 3, 4, 5, 6, 7, 8],
                                                  [0, 11]))


def test_wrapper_rejects_bad_layouts():
    mat, chunks = _case(4, 8, 256, seed=1)
    ops = kernel.from_reference_matrix(mat, "cpu")
    data = torch.from_numpy(chunks)
    with pytest.raises(ValueError):
        kernel.gf_apply(ops, data[:7])                 # wrong k
    with pytest.raises(ValueError):
        kernel.gf_apply(ops, data.to(torch.int32))     # wrong dtype
    with pytest.raises(ValueError):
        kernel.gf_apply(ops, data[0])                  # not 2-D


def test_strided_window_input_on_cpu():
    """A window of a wider buffer (row stride > L), as the batch queue
    passes it, gives the same bytes as a contiguous copy."""
    mat, chunks = _case(4, 8, 5000, seed=2)
    ops = kernel.from_reference_matrix(mat, "cpu")
    seg = torch.from_numpy(chunks)[:, 1000:3048]
    assert not seg.is_contiguous()
    assert np.array_equal(kernel.gf_apply(ops, seg).numpy(),
                          ref_gf256.host_apply(mat, chunks[:, 1000:3048]))


def test_wrapper_writes_into_a_strided_out_window():
    """``out`` as the batch queue passes it: a window of a wider output
    buffer receives the result, and the bytes around it are untouched."""
    mat, chunks = _case(4, 8, 5000, seed=3)
    ops = kernel.from_reference_matrix(mat, "cpu")
    wide = torch.full((4, 6000), 7, dtype=torch.uint8)
    got = kernel.gf_apply(ops, torch.from_numpy(chunks)[:, :2048],
                          out=wide[:, 512:2560])
    assert got.data_ptr() == wide[:, 512:2560].data_ptr()
    want = ref_gf256.host_apply(mat, chunks[:, :2048])
    assert np.array_equal(wide[:, 512:2560].numpy(), want)
    assert (wide[:, :512] == 7).all() and (wide[:, 2560:] == 7).all()
    with pytest.raises(ValueError, match="out must be"):
        kernel.gf_apply(ops, torch.from_numpy(chunks), out=wide[:, :100])
    with pytest.raises(ValueError, match="out must be"):
        kernel.gf_apply(ops, torch.from_numpy(chunks)[:, :100],
                        out=wide[:, :100].to(torch.int16))


def test_cpu_path_does_not_count_kernel_launches():
    mat, chunks = _case(4, 8, 512, seed=4)
    before = kernel.gf_apply_launches
    kernel.matrix_apply(mat, device="cpu")(chunks)
    assert kernel.gf_apply_launches == before


def test_device_call_books_launch_signature():
    mat, chunks = _case(2, 4, 300, seed=6)
    ap = kernel.MatrixApply(mat, device="cpu")
    before = devstats.counters()["launches"].get("ec_apply", 0)
    out = ap.device_call(torch.from_numpy(chunks))
    assert isinstance(out, torch.Tensor) and out.shape == (2, 300)
    assert devstats.counters()["launches"]["ec_apply"] == before + 1


def test_matrix_apply_caches_per_matrix_and_device():
    mat = ref_gf256.rs_vandermonde_matrix(4, 2)[4:]
    assert kernel.matrix_apply(mat, "cpu") is kernel.matrix_apply(
        mat.copy(), torch.device("cpu"))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """No device argument means CUDA; with no card the entry points
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mat = ref_gf256.rs_vandermonde_matrix(4, 2)[4:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.matrix_apply(mat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.MatrixApply(mat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.from_reference_matrix(mat)
    from ceph_tpu_torch.ec.registry import factory
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory("rs", {"k": "4", "m": "2"})
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
    for mode in ("on", "auto", "force"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ECBatchQueue(Context("osd.0"), mode=mode)
    from ceph_tpu_torch.tools import ec_benchmark
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_benchmark.main(["--size", "4096", "-P", "k=2", "-P", "m=1"])
    with pytest.raises(ValueError):
        kernel.matrix_apply(mat, device="meta")
