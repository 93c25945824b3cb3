"""GF(2^8) matrix apply: a hand-written CUDA kernel and its plain version.

The port's counterpart of ``ceph_tpu/ec/kernel.py``.  ``out[r, L]`` is the
product, over GF(2^8), of an (r x k) code matrix with k rows of L bytes:
parity rows of the generator for an encode, rows of a decode matrix for
a degraded read or a rebuild.

  * ``gf_apply`` is the wrapper.  On a CUDA tensor it launches the kernel
    of ``csrc/gf_apply.cu`` (product tables looked up by byte permute in
    registers; it replaces the TPU kernel
    ``ceph_tpu/ec/kernel.py:_ec_fused_kernel``) or raises.
    On a CPU tensor, and only there, it runs the plain version.
  * ``gf_apply_checksum`` is the variant tuner's probe: the same apply
    with the output summed on the device (``out.astype(int32).sum()``,
    wrapped mod 2^32), so one scalar crosses to the host.  It replaces
    ``_pallas_probe_sum``; ``gf_apply_checksum_plain`` is its plain
    version.
  * ``gf_apply_segments`` applies one matrix to many strided segments in
    one launch of the same source's segments kernel: a segment's k input
    rows may lie in several blocks (a mesh position's block each) and its
    r output rows in another, with per-row byte sums of the output as an
    epilogue.  It is the device half of the mesh steps (``parallel/``),
    whose JAX programs (``ceph_tpu/parallel/layout.py``,
    ``mesh_exec.py``) it replaces; ``gf_apply_segments_plain`` is its
    plain version.
  * ``gf_apply_plain`` is the plain PyTorch version.  It mirrors the JAX
    package's ``_apply_bitmatrix``: unpack the k byte rows to 8k bit-planes,
    multiply by the (8r x 8k) 0/1 bit-matrix, take each sum mod 2, repack.
    The CPU tests run it, and the chip smoke test holds the kernel against
    it on the card.
  * ``from_reference_matrix`` turns a JAX-package numpy matrix into the
    operands both need, on one device: the kernel's byte-permute tables
    and the plain version's bit-matrix.  ``MatrixApply`` builds them once
    per matrix; ``matrix_apply`` caches one per (matrix, device).

Variant selection follows the JAX package's (``set_fused_config``,
``_resolve_fused_config``, ``TUNE_SPACE``, ``autotune``), over this
kernel's own axes: (threads per block, lanes per thread, output rows per
block), every one built for sm_90a in the same nvcc run.  The TPU's axes
(tile, plane layout, pack engine) do not exist here.  The config is
resolved at every launch, outside anything cached, so a later
``set_fused_config`` reaches every later call; a shape-bound winner (the
decode pass) is keyed by the (r, k) matrix shape, which the reference's
[8r, 8k] bit-matrix shape stands for one to one.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
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
#: launches of the checksum probe, counted where ``gf_apply_checksum``
#: launches it
gf_apply_checksum_launches = 0
#: launches of the segments kernel, counted where ``gf_apply_segments``
#: launches it
gf_apply_segments_launches = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib = None


#: variant space of csrc/gf_apply.cu (GF_TUNE_SPACE): (threads per block,
#: lanes per thread, output rows per block); the first is the champion
#: default
TUNE_SPACE = [
    (128, 16, 4),
    (256, 16, 4),
    (64, 16, 4),
    (512, 16, 4),
    (128, 16, 8),
    (256, 16, 8),
]

_EC_THREADS, _EC_LANES, _EC_ROWS = TUNE_SPACE[0]

#: per-matrix-shape overrides, keyed by the (r, k) code matrix shape:
#: encode (parity rows of the generator) and decode (rebuild matrices)
#: present different shapes, and a decode autotune pass installs here
#: without clobbering the encode winner
_EC_SHAPE_CFG: dict = {}


def set_fused_config(threads: int = None, lanes: int = None,
                     rows: int = None, shape: tuple = None) -> dict:
    """Set the kernel variant (autotune).  With ``shape`` (an (r, k)
    matrix shape) the config binds to that matrix shape only, its unset
    fields taken from the current process-wide values; without it the
    process-wide defaults change.  A variant not in TUNE_SPACE raises."""
    global _EC_THREADS, _EC_LANES, _EC_ROWS
    base = (_EC_SHAPE_CFG.get(tuple(shape), (_EC_THREADS, _EC_LANES,
                                             _EC_ROWS))
            if shape is not None else (_EC_THREADS, _EC_LANES, _EC_ROWS))
    cfg = (int(threads) if threads else base[0],
           int(lanes) if lanes else base[1],
           int(rows) if rows else base[2])
    if cfg not in TUNE_SPACE:
        raise ValueError(f"variant {cfg} is not in TUNE_SPACE {TUNE_SPACE}")
    if shape is not None:
        _EC_SHAPE_CFG[tuple(shape)] = cfg
        return {"threads": cfg[0], "lanes": cfg[1], "rows": cfg[2],
                "shape": tuple(shape)}
    _EC_THREADS, _EC_LANES, _EC_ROWS = cfg
    return {"threads": cfg[0], "lanes": cfg[1], "rows": cfg[2]}


def _resolve_fused_config(shape: tuple) -> tuple:
    """(threads, lanes, rows) for one launch on an (r, k) matrix:
    shape-bound winner first, process-wide defaults otherwise."""
    return _EC_SHAPE_CFG.get(tuple(shape),
                             (_EC_THREADS, _EC_LANES, _EC_ROWS))


class MatrixOperands(NamedTuple):
    """One code matrix's operands, all on one device."""
    mat: np.ndarray          # [r, k] uint8, the GF(2^8) matrix (host)
    tables: torch.Tensor     # [r, k, 32] uint8 prmt tables (the kernel's)
    bitmat: torch.Tensor     # [8r, 8k] uint8 0/1 bit-matrix (the plain version's)


def prmt_tables(mat: np.ndarray) -> np.ndarray:
    """[r, k] GF(2^8) matrix -> [r, k, 32] byte-permute tables: for
    coefficient c, bytes 0..7 hold c*i and bytes 8..15 hold c*(i << 3)
    (i < 8), bytes 16..19 hold c*(i << 6) (i < 4), and bytes 20..31 are 0;
    so that c*b = t[b & 7] ^ t[8 + ((b >> 3) & 7)] ^ t[16 + (b >> 6)]."""
    mul = gf256.mul_table()
    m = np.asarray(mat, np.uint8)[:, :, None]
    i8, i4 = np.arange(8), np.arange(4)
    t = np.zeros(m.shape[:2] + (32,), np.uint8)
    t[:, :, 0:8] = mul[m, i8]
    t[:, :, 8:16] = mul[m, i8 << 3]
    t[:, :, 16:20] = mul[m, i4 << 6]
    return t


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
    tables = torch.from_numpy(prmt_tables(mat)).to(dev)
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


def gf_apply_checksum_plain(bitmat: torch.Tensor,
                            data: torch.Tensor) -> torch.Tensor:
    """Plain version of the probe: ``gf_apply_plain(...)`` summed as int32
    with two's-complement wraparound (XLA's int32 sum; ``torch.sum`` of
    int32 returns int64 and does not wrap).  A 0-d int32 tensor."""
    s = gf_apply_plain(bitmat, data).to(torch.int64).sum()
    return ((s + 2**31) % 2**32 - 2**31).to(torch.int32)


def _library():
    """The kernel's library, built from csrc/gf_apply.cu at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ceph_tpu_torch.common.cuda_build import build
            lib = build("gf_apply").lib
            vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.gf_apply.argtypes = [vp, ci, ci, vp, cll, vp, cll, cll,
                                     ci, ci, ci, vp]
            lib.gf_apply.restype = ci
            lib.gf_apply_checksum.argtypes = [vp, ci, ci, vp, cll, cll,
                                              ci, ci, ci, vp, vp]
            lib.gf_apply_checksum.restype = ci
            lib.gf_apply_segments.argtypes = [vp, ci, ci, vp, ci, vp, ci,
                                              vp, ci, ci, vp]
            lib.gf_apply_segments.restype = ci
            lib.gf_tune_space.argtypes = [vp, ci]
            lib.gf_tune_space.restype = ci
            lib.gf_apply_error_string.argtypes = [ci]
            lib.gf_apply_error_string.restype = ctypes.c_char_p
            buf = (ctypes.c_int * (3 * 16))()
            n = lib.gf_tune_space(ctypes.addressof(buf), 16)
            built = [tuple(buf[3 * i:3 * i + 3]) for i in range(min(n, 16))]
            if built != TUNE_SPACE:
                raise RuntimeError(f"csrc/gf_apply.cu builds {built}, "
                                   f"TUNE_SPACE is {TUNE_SPACE}")
            _lib = lib
        return _lib


def _variant(ops: MatrixOperands, config: Optional[tuple]) -> tuple:
    cfg = (tuple(config) if config is not None
           else _resolve_fused_config(ops.mat.shape))
    if cfg not in TUNE_SPACE:
        raise ValueError(f"variant {cfg} is not in TUNE_SPACE {TUNE_SPACE}")
    return cfg


def _check_data(ops: MatrixOperands, data: torch.Tensor) -> None:
    r, k = ops.mat.shape
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"data must be [k={k}, L] uint8, got "
                         f"{data.dtype} {tuple(data.shape)}")
    if data.device != ops.tables.device:
        raise ValueError(f"data on {data.device}, matrix operands on "
                         f"{ops.tables.device}")


def gf_apply(ops: MatrixOperands, data: torch.Tensor,
             out: Optional[torch.Tensor] = None,
             config: Optional[tuple] = None) -> torch.Tensor:
    """out[r, L] = ops.mat @ data over GF(2^8), on data's device.

    ``data`` is [k, L] uint8 with contiguous lanes; its rows may be
    strided (a window of a wider buffer).  ``out``, when given, is an
    [r, L] uint8 tensor on the same device, laid out the same way, that
    receives the result; otherwise it is allocated.  ``config`` names a
    TUNE_SPACE variant; by default it is resolved for this (r, k) at
    this launch (``_resolve_fused_config``).  A CUDA tensor launches the
    kernel, a CPU tensor runs the plain version; any other layout or
    device raises."""
    r, k = ops.mat.shape
    _check_data(ops, data)
    cfg = _variant(ops, config)
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
                          *cfg, stream)
    if rc != 0:
        raise RuntimeError(f"gf_apply launch failed: CUDA error {rc} "
                           f"({lib.gf_apply_error_string(rc).decode()})")
    global gf_apply_launches
    with _count_lock:
        gf_apply_launches += 1
    return out


def gf_apply_checksum(ops: MatrixOperands, data: torch.Tensor,
                      config: Optional[tuple] = None) -> torch.Tensor:
    """The probe: the int32 sum, wrapped mod 2^32, of the bytes of
    ``ops.mat @ data`` over GF(2^8), as a 0-d int32 tensor on data's
    device; the product itself is never written.  ``data`` and
    ``config`` as in ``gf_apply``.  A CUDA tensor launches the kernel's
    checksum entry, a CPU tensor runs the plain version."""
    r, k = ops.mat.shape
    _check_data(ops, data)
    cfg = _variant(ops, config)
    if data.device.type == "cpu":
        return gf_apply_checksum_plain(ops.bitmat, data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    L = data.shape[1]
    if L > 1 and data.stride(1) != 1:
        raise ValueError(f"lanes must be contiguous (stride 1), got "
                         f"strides {data.stride()}")
    total = torch.empty((), dtype=torch.int32, device=data.device)
    lib = _library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_apply_checksum(ops.tables.data_ptr(), r, k,
                                   data.data_ptr(), data.stride(0), L,
                                   *cfg, total.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gf_apply_checksum launch failed: CUDA error "
                           f"{rc} ({lib.gf_apply_error_string(rc).decode()})")
    global gf_apply_checksum_launches
    with _count_lock:
        gf_apply_checksum_launches += 1
    return total


#: segments and input blocks one segments launch carries in its parameter
#: space (csrc/gf_apply.cu kMaxSegments, kMaxInputs)
SEGMENT_CAP = 32
SEGMENT_INPUT_CAP = 64


class Segment(NamedTuple):
    """One segment of a ``gf_apply_segments`` launch: ``out[s, i, l] = XOR_j
    mat[i, j] * in[s, j, l]``, where the k input rows are the rows of
    ``inputs`` in order.  Each input is a [stripes, rows, lanes] uint8
    view, ``out`` a [stripes, r, lanes] one, all with the same stripes
    and lanes; ``sum`` adds the segment's output bytes into the launch's
    per-row sums."""
    inputs: tuple
    out: torch.Tensor
    sum: bool = True


def _merge_blocks(records: list) -> list:
    """Fold input blocks that continue one another at one row stride into
    one record: the blocks of positions laid side by side in one buffer."""
    out = [list(records[0])]
    for ptr, row, stripe, rows in records[1:]:
        last = out[-1]
        step = row if last[1] == 0 else last[1]
        if last[3] == 1 and rows == 1:
            step = ptr - last[0]
        if (step > 0 and (row in (0, step)) and (last[1] in (0, step))
                and last[2] == stripe
                and ptr == last[0] + last[3] * step):
            last[1] = step
            last[3] += rows
        else:
            out.append([ptr, row, stripe, rows])
    return out


def _segment_plan(r: int, k: int, segments, device) -> tuple:
    """Check every segment as the kernel takes it and plan its launches:
    (the segments with work as ([stripes, rows, lanes] inputs, output,
    sum) views, [(segs, blocks)] launch records, one entry per launch the
    caps allow).  The kernel and its plain version run on the same
    checks.  Each tensor's shape and strides are read once: this runs on
    every step."""
    views, launches, segs, blocks = [], [], [], []
    for seg in segments:
        out = seg.out if seg.out.dim() != 2 else seg.out.unsqueeze(0)
        if out.dim() != 3:
            raise ValueError("a segment takes [stripes, rows, lanes] inputs "
                             "and output")
        S, rr, L = out.shape
        ins, recs, rows = [], [], 0
        for t in (out,) + tuple(seg.inputs):
            if t.dim() == 2:
                t = t.unsqueeze(0)
            sh = t.shape
            if (len(sh) != 3 or t.dtype != torch.uint8
                    or t.device != device or sh[0] != S or sh[2] != L):
                raise ValueError(
                    f"segment tensors must be [stripes={S}, rows, "
                    f"lanes={L}] uint8 on {device}, got {t.dtype} "
                    f"{tuple(sh)} on {t.device}")
            st = t.stride()
            if L > 1 and st[2] != 1 and sh[0] * sh[1]:
                raise ValueError("segment lanes must be contiguous "
                                 "(stride 1)")
            if t is not out:
                ins.append(t)
                rows += sh[1]
                if sh[1]:
                    recs.append([t.data_ptr(), st[1] if sh[1] > 1 else 0,
                                 st[0] if S > 1 else 0, sh[1]])
        if rr != r or rows != k:
            raise ValueError(f"a segment of a [{r}, {k}] matrix takes {k} "
                             f"input rows and {r} output rows, got {rows} "
                             f"and {rr}")
        if S * L == 0:
            continue
        if L >= 1 << 31:
            raise ValueError(f"a segment of {L} lanes: at most 2^31 - 1")
        recs = _merge_blocks(recs)
        if len(recs) > SEGMENT_INPUT_CAP:
            raise ValueError(f"a segment of {len(recs)} input blocks: at "
                             f"most {SEGMENT_INPUT_CAP}")
        views.append((ins, out, seg.sum))
        if len(segs) == SEGMENT_CAP \
                or len(blocks) + len(recs) > SEGMENT_INPUT_CAP:
            launches.append((segs, blocks))
            segs, blocks = [], []
        ost = out.stride()
        segs.append([out.data_ptr(), ost[1] if r > 1 else 0,
                     ost[0] if S > 1 else 0, L, S, len(blocks),
                     len(recs), int(bool(seg.sum))])
        blocks.extend(recs)
    if segs:
        launches.append((segs, blocks))
    return views, launches


def gf_apply_segments_plain(bitmat: torch.Tensor, segments,
                            sums: bool = False) -> Optional[torch.Tensor]:
    """Plain version of ``gf_apply_segments``, on the same checks: each
    segment's input rows gathered, ``gf_apply_plain`` over its stripes
    side by side, the result written into its output; with ``sums``, the
    int64 [r] per-row byte sums of the summed segments' outputs, mod
    2^32."""
    r, k = bitmat.shape[0] // 8, bitmat.shape[1] // 8
    views, _ = _segment_plan(r, k, segments, bitmat.device)
    total = torch.zeros(r, dtype=torch.int64, device=bitmat.device) \
        if sums else None
    for ins, out, summed in views:
        S, _, L = out.shape
        data = torch.cat(ins, dim=1).permute(1, 0, 2).reshape(k, S * L)
        res = gf_apply_plain(bitmat, data)                     # [r, S*L]
        out.copy_(res.view(r, S, L).permute(1, 0, 2))
        if sums and summed:
            total += res.sum(dim=1, dtype=torch.int64)
    return total % (1 << 32) if sums else None


def gf_apply_segments(ops: MatrixOperands,
                      segments, sums: bool = False) -> Optional[torch.Tensor]:
    """Apply ``ops.mat`` to every ``Segment`` of ``segments`` in launches
    of csrc/gf_apply.cu's segments kernel, writing each segment's output
    in place.  With ``sums``, returns the int64 [r] per-row sums of the
    summed segments' output bytes, mod 2^32, on the matrix's device
    (else None).

    A launch carries at most ``SEGMENT_CAP`` segments and
    ``SEGMENT_INPUT_CAP`` input blocks (blocks that continue one another
    at one row stride count once); more make more launches, each
    counted.  A segment of more input blocks than that raises.  Segments
    of no stripes or no lanes are skipped.  Tensors on the CPU run the
    plain version; on CUDA the kernel launches or the call raises."""
    r, k = ops.mat.shape
    dev = ops.tables.device
    if dev.type == "cpu":
        return gf_apply_segments_plain(ops.bitmat, segments, sums)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _, launches = _segment_plan(r, k, segments, dev)
    if not launches:
        return torch.zeros(r, dtype=torch.int64, device=dev) if sums else None
    # the low word of each int64 counter gathers the uint32 sum and the
    # high word stays 0, so its value is the sum mod 2^32; the first
    # launch zeroes them
    total = torch.empty(r, dtype=torch.int64, device=dev) if sums else None
    lib = _library()
    global gf_apply_segments_launches
    # the device guard only where the launch's card is not current
    with (contextlib.nullcontext() if dev.index in (None,
          torch.cuda.current_device()) else torch.cuda.device(dev)):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, (segs, blocks) in enumerate(launches):
            seg_arr = np.asarray(segs, np.int64).reshape(-1, 8)
            blk_arr = np.asarray(blocks, np.int64).reshape(-1, 4)
            rc = lib.gf_apply_segments(
                ops.tables.data_ptr(), r, k, seg_arr.ctypes.data,
                len(seg_arr), blk_arr.ctypes.data, len(blk_arr),
                total.data_ptr() if sums else None, 2, int(i == 0), stream)
            if rc != 0:
                raise RuntimeError(
                    f"gf_apply_segments launch failed: CUDA error {rc} "
                    f"({lib.gf_apply_error_string(rc).decode()})")
            with _count_lock:
                gf_apply_segments_launches += 1
    return total


def _probe_seconds(ops: MatrixOperands, data: torch.Tensor,
                   cfg: tuple) -> float:
    """One probe and its one-scalar fetch: on a card, CUDA events around
    the launch and the scalar's copy to pinned host memory, both in
    stream order (so no host-side gap is timed); the host clock on the
    CPU."""
    if data.device.type == "cuda":
        host = torch.empty((), dtype=torch.int32, pin_memory=True)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        host.copy_(gf_apply_checksum(ops, data, cfg), non_blocking=True)
        e1.record()
        e1.synchronize()
        int(host)
        return e0.elapsed_time(e1) / 1e3
    t0 = time.perf_counter()
    int(gf_apply_checksum(ops, data, cfg))
    return time.perf_counter() - t0


def autotune(mat: np.ndarray, length: int = 1 << 25, trials: int = 3,
             budget_s: Optional[float] = None, install: str = "global",
             device: DeviceLike = DEFAULT_DEVICE) -> dict:
    """Time every TUNE_SPACE variant on ``device`` and install the
    winner.  Returns {threads, lanes, rows, rate_mb_s[, shape]}.

    ``install="global"`` sets the process-wide default (the encode
    pass); ``install="shape"`` binds the winner to THIS matrix's (r, k)
    shape only (the decode pass must not clobber the encode winner).

    Each variant is timed by the SLOPE between operands of ``length//4``
    and ``length`` input bytes (marginal bytes/second), each warmed once
    and then given the best of ``trials`` probes (``gf_apply_checksum``
    plus its one-scalar fetch), so fixed per-call costs cancel.  With
    ``budget_s``, a variant is only STARTED when the worst variant cost
    seen so far still fits the remaining budget.  When no slope is
    positive (noise swamped every one), TUNE_SPACE[0] is installed with
    ``"note": "slope-noise fallback"``.

    Unlike the JAX package's tuner, which skips a variant that raises,
    this one catches nothing: every TUNE_SPACE entry is built for sm_90a
    and must run, so a failed build or launch is a fault and raises."""
    if install not in ("global", "shape"):
        raise ValueError(f"install must be 'global' or 'shape', got "
                         f"{install!r}")
    t_start = time.monotonic()
    ops = from_reference_matrix(mat, device)
    r, k = ops.mat.shape
    rng = np.random.default_rng(3)
    sizes = (length // 4, length)
    datas = [torch.from_numpy(
        rng.integers(0, 256, (k, n // k), dtype=np.uint8)).to(ops.tables.device)
        for n in sizes]
    best = None
    worst_cost = 0.0
    for cfg in TUNE_SPACE:
        elapsed = time.monotonic() - t_start
        if budget_s is not None and elapsed + worst_cost > budget_s:
            break
        t_var = time.monotonic()
        times = []
        for d in datas:
            int(gf_apply_checksum(ops, d, cfg))          # warm
            times.append(min(_probe_seconds(ops, d, cfg)
                             for _ in range(trials)))
        worst_cost = max(worst_cost, time.monotonic() - t_var)
        if times[1] <= times[0]:
            continue                  # noise swamped the slope
        rate = (sizes[1] - sizes[0]) / (times[1] - times[0]) / 1e6
        if best is None or rate > best["rate_mb_s"]:
            best = {"threads": cfg[0], "lanes": cfg[1], "rows": cfg[2],
                    "rate_mb_s": round(rate, 1)}
    shape = (r, k) if install == "shape" else None
    if best:
        set_fused_config(best["threads"], best["lanes"], best["rows"],
                         shape=shape)
    else:
        t, la, ro = TUNE_SPACE[0]
        set_fused_config(t, la, ro, shape=shape)
        best = {"threads": t, "lanes": la, "rows": ro, "rate_mb_s": None,
                "note": "slope-noise fallback"}
    if shape is not None:
        best["shape"] = shape
    return best


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
        cfg = _resolve_fused_config(self.mat.shape)
        devstats.note_launch("ec_apply",
                             (self._sig, tuple(chunks.shape), cfg))
        return gf_apply(self.ops, chunks, out, cfg)


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
