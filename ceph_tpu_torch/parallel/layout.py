"""Device-mesh layout for the distributed data plane.

The reference moves erasure-coded shards between OSD processes over its
Messenger (src/osd/ECBackend.cc fan-out of MOSDECSubOpWrite; src/msg/ NCC-less
custom transport).  The device-native equivalent for co-located OSD shards
is a device mesh:

  * axis "host"  — data parallelism over independent stripes/PGs (the
    reference's "objects hash to PGs" axis, OSDMap.cc:1470)
  * axis "shard" — the byte dimension of a stripe, striped across devices
    (the reference's Striper/ECUtil stripe axis, osdc/Striper.h:31)

Parity fan-out is a ring permute (the MOSDECSubOpWrite hop), scrub
aggregation a sum over positions (the PGMap stat roll-up).  The live OSD
device-mesh execution mode (osd_mesh_mode=on) lives in
ceph_tpu_torch/parallel/mesh_exec.py, which runs the same gather +
row-block encode INSIDE the EC write path and hands shard bytes to
co-located OSDs in process.

The port's copy of ``ceph_tpu.parallel.layout``.  The JAX package's mesh
is a jax device mesh and its steps are ``shard_map`` programs under
``jax.jit`` in one process.  Here a mesh is a grid of *positions* in one
process, each bound to a ``torch.device``; entries may repeat (twelve
positions on one card), and a step is host code over per-position blocks:

  * a ``Sharded`` tensor holds one block per position, on that position's
    device; positions on one device hold views of one buffer, and a block
    bound for another device moves with ``.to(device, non_blocking=True)``
    (written for several cards, run on one);
  * ``all_gather`` is a concatenation onto each position's device,
    ``ppermute`` a reassignment of blocks between positions, ``psum`` a
    sum that wraps mod 2^32 as the JAX package's uint32 sums do;
  * the per-stripe bit-matrix apply (the JAX package's ``vmap`` of
    ``_apply_bitmatrix``) and its scrub sum are ONE launch per device of
    ``gf_apply_segments`` (csrc/gf_apply.cu): one segment per position
    block (per host row for the recover step, whose survivor rows lie in
    the row's position blocks), read where the blocks lie and written
    into one output buffer per device, with the per-row byte sums as the
    kernel's epilogue.  On the CPU the same code runs its plain version.

The steps take the GF(2^8) matrix (the kernels' operand) where the JAX
package's take the expanded bit-matrix.  A scrub is an int64 tensor of
values mod 2^32 (the JAX package's is uint32).  ``shard_map_check_kwargs``,
glue between jax versions, has no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec import kernel as ec_kernel
from ceph_tpu_torch.ec.kernel import Segment, matrix_apply

#: a partition spec: one mesh axis name (or None: not split) per dimension
Spec = Tuple[Optional[str], ...]
Pos = Tuple[int, ...]


def position_device(dev) -> torch.device:
    """``dev`` as a position's device: a bare ``cuda`` names the current
    card, so positions given as ``cuda`` and ``cuda:0`` fold together."""
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def default_devices() -> List[torch.device]:
    """One position per visible card (the JAX package's ``jax.devices()``):
    none on a host without one."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Positions in a grid, one ``torch.device`` each (``devices`` is an
    object array of the grid's shape), with one name per grid axis."""

    def __init__(self, devices: np.ndarray, axes: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = position_device(devices[pos])
        if grid.ndim != len(axes):
            raise ValueError(f"a {grid.ndim}-d grid needs {grid.ndim} axis "
                             f"names, got {tuple(axes)}")
        self.devices = grid
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.size = grid.size

    def positions(self) -> List[Pos]:
        return list(np.ndindex(self.devices.shape))

    def by_device(self) -> Dict[torch.device, List[Pos]]:
        """The positions on each device, in grid order."""
        out: Dict[torch.device, List[Pos]] = {}
        for pos in self.positions():
            out.setdefault(self.devices[pos], []).append(pos)
        return out


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("host", "shard"),
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over the first n positions of ``devices`` (default: one per
    visible card): 'host' x 'shard', shard innermost so the stripe axis
    holds neighbouring positions."""
    devs = list(devices) if devices is not None else default_devices()
    n = n_devices or len(devs)
    if n < 1 or n > len(devs):
        raise ValueError(f"a mesh of {n} positions needs {n} devices, "
                         f"have {len(devs)}")
    devs = devs[:n]
    shard = 1
    for cand in (8, 4, 2, 1):
        if n % cand == 0 and cand <= n:
            shard = cand
            break
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // shard, shard), axes)


class Sharded:
    """A global tensor of ``shape`` laid over ``mesh`` by ``spec``:
    ``blocks[pos]`` is position ``pos``'s block, on its device.  A
    dimension whose spec entry is None is whole on every position.
    ``base`` is the global tensor whose slices the blocks are, where
    ``host_sharded`` laid it on one device; else None."""

    def __init__(self, mesh: Mesh, spec: Spec, shape: tuple,
                 blocks: Dict[Pos, torch.Tensor],
                 base: Optional[torch.Tensor] = None):
        self.mesh = mesh
        self.spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.shape = tuple(shape)
        self.blocks = blocks
        self.base = base

    def index(self, pos: Pos) -> tuple:
        """Position ``pos``'s slice of the global tensor."""
        idx = []
        for dim, axis in zip(self.shape, self.spec):
            if axis is None:
                idx.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            c = pos[self.mesh.axis_names.index(axis)]
            step = dim // n
            idx.append(slice(c * step, (c + 1) * step))
        return tuple(idx)

    def gather(self) -> torch.Tensor:
        """The global tensor, assembled on the first position's device."""
        dev = self.mesh.devices.flat[0]
        first = next(iter(self.blocks.values()))
        out = torch.empty(self.shape, dtype=first.dtype, device=dev)
        done = set()
        for pos, blk in self.blocks.items():
            idx = self.index(pos)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:       # replicated dims: one copy is enough
                done.add(key)
                # a copy to the host waits for its data
                out[idx].copy_(blk, non_blocking=dev.type == "cuda")
        return out


def move_to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: itself (a view) on its own device, else a staged
    copy (one to the host waits for its data)."""
    if t.device == dev:
        return t
    return t.to(dev, non_blocking=dev.type == "cuda")


def host_sharded(mesh: Mesh, x, spec: Spec) -> Sharded:
    """Lay a global tensor (or numpy array) over ``mesh`` by ``spec``.
    When every position is on one device, ``x`` moves there once and each
    block is a view of it."""
    x = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    for dim, axis in zip(x.shape, spec):
        if axis is not None and dim % mesh.shape[axis]:
            raise ValueError(f"dimension {dim} does not split over "
                             f"{mesh.shape[axis]} positions of {axis!r}")
    devs = set(mesh.devices.flat)
    base = move_to(x, next(iter(devs))) if len(devs) == 1 else None
    x = x if base is None else base
    out = Sharded(mesh, spec, tuple(x.shape), {}, base)
    for pos in mesh.positions():
        out.blocks[pos] = move_to(x[out.index(pos)], mesh.devices[pos])
    return out


class Step:
    """A built mesh step: calling it runs it.  ``runs`` counts its runs,
    ``seg_launches`` the ``gf_apply_segments`` launches they made on a
    card (one per device and run).  A ``plain`` step applies the
    kernel's plain version on every device: the step's plain version,
    which a card's run is held against."""

    def __init__(self, name: str, fn, plain: bool = False):
        self.name = name
        self._fn = fn
        self.plain = plain
        self.runs = 0
        self.seg_launches = 0

    def __call__(self, *args):
        self.runs += 1
        return self._fn(*args)

    def apply(self, mat_apply, segments: List[Segment],
              sums: bool = True) -> Optional[torch.Tensor]:
        """``gf_apply_segments`` over ``segments`` (plain version on the
        CPU): one launch unless they pass its caps, each launch counted;
        with ``sums``, returns the int64 per-row sums of the summed
        segments' outputs, mod 2^32."""
        ops = mat_apply.ops
        if self.plain:
            return ec_kernel.gf_apply_segments_plain(ops.bitmat, segments,
                                                     sums)
        before = ec_kernel.gf_apply_segments_launches
        sums = ec_kernel.gf_apply_segments(ops, segments, sums)
        self.seg_launches += ec_kernel.gf_apply_segments_launches - before
        return sums


def _wrap32(sums: List[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """psum of per-device sums mod 2^32: their total mod 2^32 (one device's
    sums as they are)."""
    if len(sums) == 1 and sums[0].device == dev:
        return sums[0]
    total = sums[0].to(dev)
    for s in sums[1:]:
        total = total + s.to(dev)
    return total % (1 << 32)


def _place(mesh: Mesh, x, spec: Spec) -> Sharded:
    return x if isinstance(x, Sharded) else host_sharded(mesh, x, spec)


def ec_cluster_step(mesh: Mesh, mat: np.ndarray,
                    plain: bool = False) -> Step:
    """Build the multi-position EC data-plane step.

    Input  data [B, k, L] uint8: B stripes over 'host', bytes L over
    'shard'.  Per step: encode parity (the [m, k] parity matrix
    ``mat``), ring-shift parity one position along 'shard' (the shard
    fan-out hop), and sum a per-chunk crc-proxy over every position (the
    scrub roll-up).  Returns (parity, scrub): parity [B, m, L] laid out
    like the data, scrub [m] (int64, mod 2^32) on the first position's
    device.
    """
    mat = np.ascontiguousarray(mat, np.uint8)
    m, k = mat.shape
    n_shard = mesh.shape["shard"]
    groups = mesh.by_device()
    applies = {dev: matrix_apply(mat, dev) for dev in groups}
    spec = ("host", None, "shard")
    n_host = mesh.shape["host"]

    def run(data):
        x = _place(mesh, data, spec)
        B, kk, L = x.shape
        if kk != k:
            raise ValueError(f"data has {kk} chunks, the matrix takes {k}")
        parity: Dict[Pos, torch.Tensor] = {}
        sums = []
        whole = None
        if len(groups) == 1:
            # on one device the parity is one [B, m, L] buffer laid out
            # like the data, each position's block a view of it
            whole = torch.empty((B, m, L), dtype=torch.uint8,
                                device=mesh.devices.flat[0])
            tiles = whole.view(n_host, B // n_host, m, n_shard,
                               L // n_shard).permute(0, 3, 1, 2, 4)
            parity = {(h, s): blk for h, row in enumerate(tiles.unbind(0))
                      for s, blk in enumerate(row.unbind(0))}
        for dev, positions in groups.items():
            if whole is not None and x.base is not None:
                # the position blocks are slices of one buffer: one
                # segment reads it and writes the parity where it lies
                segs = [Segment((x.base,), whole)]
            else:
                segs = []
                for p in positions:
                    blk = x.blocks[p]                   # [b, k, Ls]
                    if whole is None:
                        parity[p] = torch.empty(
                            (blk.shape[0], m, blk.shape[2]),
                            dtype=torch.uint8, device=dev)
                    segs.append(Segment((blk,), parity[p]))
            sums.append(step.apply(applies[dev], segs))
        # the shard fan-out hop: each position hands its parity slice to
        # the next ring position (ECBackend's MOSDECSubOpWrite to the next
        # shard OSD)
        rotated = {(h, s): move_to(parity[h, (s - 1) % n_shard],
                                 mesh.devices[h, s])
                   for h, s in parity}
        scrub = _wrap32(sums, mesh.devices.flat[0])
        return Sharded(mesh, spec, (B, m, L), rotated), scrub

    step = Step("ec_cluster_step", run, plain)
    return step


def ec_recover_step(mesh: Mesh, mat: np.ndarray, n_surv: int,
                    plain: bool = False) -> Step:
    """Build the multi-position EC RECOVERY step — the data-plane analog
    of ECBackend::continue_recovery_op (osd/ECBackend.cc:484): the
    primary gathers k survivor shards (MOSDECSubOpRead fan-in) and
    decodes the lost chunks.

    Mesh layout is the OSD placement itself: each 'shard' position holds
    ITS OWN chunks of every stripe — input surv [B, n_surv, L] laid
    (host, shard, -): the chunk AXIS is distributed, so no position can
    decode alone.  The step gathers the survivor chunks along 'shard'
    and decodes with the [n_want, n_surv] decode matrix ``mat``;
    the rebuilt chunks are then available at every shard position of the
    host row (replicate-on-recover: positions of a row on one device
    share one view), and a sum over 'host' rolls up a scrub digest of the
    reconstruction.  Returns (rebuilt [B, n_want, L], scrub [n_want]).

    Requires n_surv % mesh.shape['shard'] == 0 (each position holds an
    equal slice of the survivor set).
    """
    assert n_surv % mesh.shape["shard"] == 0, \
        (n_surv, dict(mesh.shape))
    mat = np.ascontiguousarray(mat, np.uint8)
    n_want = mat.shape[0]
    if mat.shape[1] != n_surv:
        raise ValueError(f"decode matrix {mat.shape} for {n_surv} "
                         f"survivors")
    n_host, n_shard = mesh.shape["host"], mesh.shape["shard"]
    groups = mesh.by_device()
    applies = {dev: matrix_apply(mat, dev) for dev in groups}
    spec = ("host", "shard", None)

    def run(surv):
        x = _place(mesh, surv, spec)
        B, _, L = x.shape
        b_loc = B // n_host
        lost: Dict[Pos, torch.Tensor] = {}
        sums, summed = [], set()
        for dev, positions in groups.items():
            rows = sorted({h for h, _ in positions})
            # the rebuilt chunks of this device's host rows: one buffer
            rebuilt = torch.empty((len(rows) * b_loc, n_want, L),
                                  dtype=torch.uint8, device=dev)
            segs = []
            for r, h in enumerate(rows):
                # the gather along 'shard': the row's survivor rows are its
                # positions' blocks, read where they lie (a block of
                # another device moves here first)
                ins = tuple(move_to(x.blocks[h, s], dev)
                            for s in range(n_shard))
                out = rebuilt[r * b_loc:(r + 1) * b_loc]
                # a host row spread over devices enters the scrub once
                segs.append(Segment(ins, out, h not in summed))
                summed.add(h)
                for p in positions:
                    if p[0] == h:
                        lost[p] = out
            sums.append(step.apply(applies[dev], segs))
        scrub = _wrap32(sums, mesh.devices.flat[0])
        return Sharded(mesh, ("host", None, None), (B, n_want, L),
                       lost), scrub

    step = Step("ec_recover_step", run, plain)
    return step
