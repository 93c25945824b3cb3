"""GF(2^8) matrix apply: a hand-written CUDA kernel and its plain version.

The port's counterpart of ``ceph_tpu/ec/kernel.py``.  ``out[r, L]`` is the
product, over GF(2^8), of an (r x k) code matrix with k rows of L bytes:
parity rows of the generator for an encode, rows of a decode matrix for
a degraded read or a rebuild.

  * ``gf_apply`` is the wrapper.  On a CUDA tensor it launches the kernel
    of ``csrc/gf_apply.cu`` (the split-nibble table method; it replaces
    the TPU kernel ``ceph_tpu/ec/kernel.py:_ec_fused_kernel``) or raises.
    On a CPU tensor, and only there, it runs the plain version.
  * ``gf_apply_plain`` is the plain PyTorch version.  It mirrors the JAX
    package's ``_apply_bitmatrix``: unpack the k byte rows to 8k bit-planes,
    multiply by the (8r x 8k) 0/1 bit-matrix, take each sum mod 2, repack.
    The CPU tests run it, and the chip smoke test holds the kernel against
    it on the card.
  * ``from_reference_matrix`` turns a JAX-package numpy matrix into the
    operands both need, on one device: the kernel's nibble tables and the
    plain version's bit-matrix.  ``MatrixApply`` builds them once per
    matrix; ``matrix_apply`` caches one per (matrix, device).

The JAX package's variant selection (``set_fused_config``, ``TUNE_SPACE``,
``autotune``: TPU tile, plane layout and pack engine) has no counterpart
yet; tuning over this kernel's own variants is later work.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from ceph_tpu_torch.common import devstats
from ceph_tpu_torch.common.device import (DEFAULT_DEVICE, DeviceLike,
                                          resolve_device)
from ceph_tpu_torch.ec import gf256

#: launches of the CUDA kernel, counted where ``gf_apply`` launches it and
#: nowhere else (a run sets it to 0 and reads it to show which path ran)
gf_apply_launches = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib = None


class MatrixOperands(NamedTuple):
    """One code matrix's operands, all on one device."""
    mat: np.ndarray          # [r, k] uint8, the GF(2^8) matrix (host)
    tables: torch.Tensor     # [r, k, 32] uint8 nibble tables (the kernel's)
    bitmat: torch.Tensor     # [8r, 8k] uint8 0/1 bit-matrix (the plain version's)


def nibble_tables(mat: np.ndarray) -> np.ndarray:
    """[r, k] GF(2^8) matrix -> [r, k, 32] product tables: for coefficient
    c, bytes 0..15 hold c*x and bytes 16..31 hold c*(x << 4), x < 16, so
    that c*b = t[b & 15] ^ t[16 + (b >> 4)] (ISA-L's ec_init_tables)."""
    mul = gf256.mul_table()
    x = np.arange(16)
    m = np.asarray(mat, np.uint8)[:, :, None]
    return np.ascontiguousarray(
        np.concatenate([mul[m, x], mul[m, x << 4]], axis=2), np.uint8)


def from_reference_matrix(mat_np: np.ndarray,
                          device: DeviceLike = DEFAULT_DEVICE
                          ) -> MatrixOperands:
    """The port's operands for a JAX-package matrix (generator rows,
    ``decode_matrix_for`` rows), on ``device``."""
    mat = np.ascontiguousarray(mat_np, np.uint8)
    if mat.ndim != 2 or mat.shape[0] < 1 or mat.shape[1] < 1 \
            or mat.shape[0] + mat.shape[1] > 255:
        raise ValueError(f"code matrix must be [r, k] with r, k >= 1 and "
                         f"r + k <= 255, got shape {mat.shape}")
    dev = resolve_device(device)
    tables = torch.from_numpy(nibble_tables(mat)).to(dev)
    bitmat = torch.from_numpy(gf256.expand_to_bitmatrix(mat)).to(dev)
    return MatrixOperands(mat, tables, bitmat)


def gf_apply_plain(bitmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [8r, 8k] bit-matrix, [k, L] uint8 -> [r, L].

    The product runs in float32, because the card has no integer matmul
    in PyTorch.  It is exact: the operands are 0 or 1 (exact in TF32 as
    well) and every sum is at most 8k <= 2040."""
    k, L = data.shape
    r = bitmat.shape[0] // 8
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data[:, None, :] >> shifts[None, :, None]) & 1).reshape(8 * k, L)
    acc = torch.matmul(bitmat.float(), bits.float())
    planes = (acc.to(torch.int32) & 1).to(torch.uint8).reshape(r, 8, L)
    out = planes[:, 0]
    for b in range(1, 8):
        out = out | (planes[:, b] << b)
    return out


def _library():
    """The kernel's library, built from csrc/gf_apply.cu at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ceph_tpu_torch.common.cuda_build import build
            lib = build("gf_apply").lib
            lib.gf_apply.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p]
            lib.gf_apply.restype = ctypes.c_int
            lib.gf_apply_error_string.argtypes = [ctypes.c_int]
            lib.gf_apply_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def gf_apply(ops: MatrixOperands, data: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r, L] = ops.mat @ data over GF(2^8), on data's device.

    ``data`` is [k, L] uint8 with contiguous lanes; its rows may be
    strided (a window of a wider buffer).  ``out``, when given, is an
    [r, L] uint8 tensor on the same device, laid out the same way, that
    receives the result; otherwise it is allocated.  A CUDA tensor
    launches the kernel, a CPU tensor runs the plain version; any other
    layout or device raises."""
    r, k = ops.mat.shape
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"data must be [k={k}, L] uint8, got "
                         f"{data.dtype} {tuple(data.shape)}")
    if data.device != ops.tables.device:
        raise ValueError(f"data on {data.device}, matrix operands on "
                         f"{ops.tables.device}")
    L = data.shape[1]
    if out is None:
        out = torch.empty((r, L), dtype=torch.uint8, device=data.device)
    elif (out.dtype != torch.uint8 or tuple(out.shape) != (r, L)
          or out.device != data.device):
        raise ValueError(f"out must be [r={r}, L={L}] uint8 on "
                         f"{data.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if data.device.type == "cpu":
        return out.copy_(gf_apply_plain(ops.bitmat, data))
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if L > 1 and (data.stride(1) != 1 or out.stride(1) != 1):
        raise ValueError(f"lanes must be contiguous (stride 1), got "
                         f"strides {data.stride()} and {out.stride()}")
    if L == 0:
        return out
    lib = _library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_apply(ops.tables.data_ptr(), r, k, data.data_ptr(),
                          data.stride(0), out.data_ptr(), out.stride(0), L,
                          stream)
    if rc != 0:
        raise RuntimeError(f"gf_apply launch failed: CUDA error {rc} "
                           f"({lib.gf_apply_error_string(rc).decode()})")
    global gf_apply_launches
    with _count_lock:
        gf_apply_launches += 1
    return out


class MatrixApply:
    """A GF(2^8) matrix apply bound to one code matrix and one device:
    out = mat @ chunks over the field.

    Used for both encode (parity rows of the generator) and decode (rows
    from gf256.decode_matrix).  ``__call__`` takes and returns numpy;
    ``device_call`` takes and returns tensors on the device.
    """

    def __init__(self, mat: np.ndarray, device: DeviceLike = DEFAULT_DEVICE):
        self.ops = from_reference_matrix(mat, device)
        self.mat = self.ops.mat
        self.device = self.ops.tables.device
        # launch-signature identity (common/devstats): one per matrix
        self._sig = (self.mat.shape, hash(self.mat.tobytes()))

    def __call__(self, chunks) -> np.ndarray:
        host = np.ascontiguousarray(chunks, np.uint8)
        if not host.flags.writeable:       # torch.from_numpy wants writable
            host = host.copy()
        out = self.device_call(torch.from_numpy(host).to(self.device))
        return out.cpu().numpy()

    def device_call(self, chunks: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """On-device variant for callers that keep data on the device;
        ``out`` as in ``gf_apply``."""
        devstats.note_launch("ec_apply", (self._sig, tuple(chunks.shape)))
        return gf_apply(self.ops, chunks, out)


@lru_cache(maxsize=256)
def _cached_apply(mat_bytes: bytes, r: int, k: int,
                  device: str) -> MatrixApply:
    return MatrixApply(np.frombuffer(mat_bytes, np.uint8).reshape(r, k),
                       device)


def matrix_apply(mat: np.ndarray,
                 device: DeviceLike = DEFAULT_DEVICE) -> MatrixApply:
    """The cached ``MatrixApply`` for (mat, device)."""
    dev = resolve_device(device)
    mat = np.ascontiguousarray(mat, np.uint8)
    return _cached_apply(mat.tobytes(), mat.shape[0], mat.shape[1],
                         str(dev))
