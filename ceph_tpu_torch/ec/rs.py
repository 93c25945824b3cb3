"""Reed-Solomon / Cauchy codecs — the 'jerasure' and 'isa' plugin equivalents.

The port's copy of ``ceph_tpu.ec.rs``.  Reference parity:
ErasureCodeJerasure techniques reed_sol_van, reed_sol_r6_op, cauchy_orig,
cauchy_good, plus the RAID-6 bit-matrix techniques liberation and
blaum_roth (ec/bitmatrix.py; liber8tion rejects loudly — see that module)
(src/erasure-code/jerasure/ErasureCodeJerasure.h:91-243) and
ErasureCodeIsa (src/erasure-code/isa/ErasureCodeIsa.cc:107-115,144-155,
277-331).  All matrix techniques share one execution engine: a GF(2^8)
matrix apply on the codec's torch device (ceph_tpu_torch/ec/kernel.py:
the CUDA kernel on a card, its plain PyTorch version on the CPU), or the
numpy host path for a profile with ``backend=host``.  'technique' only
selects the generator matrix.  Profile strings keep the JAX package's
keys and meanings.

Decode-matrix caching mirrors ErasureCodeIsaTableCache
(src/erasure-code/isa/ErasureCodeIsaTableCache.cc): keyed by the erasure
signature, bounded LRU.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np

from ceph_tpu_torch.common.device import resolve_device
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError
from ceph_tpu_torch.ec.registry import register

_TECHNIQUES = ("reed_sol_van", "cauchy_orig", "cauchy_good", "liberation",
               "blaum_roth", "liber8tion", "reed_sol_r6_op")


class _MatrixCodec(ErasureCode):
    """Shared engine for any systematic [(k+m) x k] generator matrix."""

    DEFAULT_TECHNIQUE = "reed_sol_van"

    def __init__(self, **kw):
        super().__init__(**kw)
        self._k = 0
        self._m = 0
        self.technique = self.DEFAULT_TECHNIQUE
        self.generator: np.ndarray = None
        self._decode_cache: OrderedDict = OrderedDict()
        self._decode_cache_size = 64
        #: the resolved torch device of the matrix applies; None for a
        #: backend=host profile
        self.device = None

    @property
    def k(self) -> int:
        return self._k

    @property
    def m(self) -> int:
        return self._m

    def _parse(self, profile: Dict[str, str]) -> None:
        try:
            self._k = int(profile.get("k", 2))
            self._m = int(profile.get("m", 1))
        except ValueError as e:
            raise ErasureCodeError(f"bad k/m in profile: {e}")
        if self._k < 1 or self._m < 1:
            raise ErasureCodeError(f"k={self._k} m={self._m} must be >= 1")
        if self._k + self._m > 255:
            raise ErasureCodeError("k+m must be <= 255 over GF(2^8)")
        self.technique = profile.get("technique", self.DEFAULT_TECHNIQUE)
        if self.technique not in _TECHNIQUES:
            raise ErasureCodeError(
                f"technique {self.technique!r} not in {_TECHNIQUES}")
        self.device = (None if profile.get("backend", "tpu") == "host"
                       else resolve_device(self.requested_device))
        self._bitengine = None
        if self.technique in ("liberation", "blaum_roth", "liber8tion"):
            self._parse_bitmatrix(profile)
        else:
            self.generator = self._make_generator()

    def _parse_bitmatrix(self, profile: Dict[str, str]) -> None:
        """RAID-6 bit-matrix techniques (ErasureCodeJerasure.cc:305-483):
        m is fixed at 2, w and packetsize come from the profile, and the
        code is built + MDS-verified by ec/bitmatrix.py.  liber8tion is
        rejected loudly — see that module's docstring."""
        from ceph_tpu_torch.ec import bitmatrix as bm
        if self.technique == "liber8tion":
            raise ErasureCodeError(
                "technique 'liber8tion' is not supported: its w=8 "
                "bit-matrices exist only as a searched table in Plank's "
                "paper (jerasure liber8tion.c — an unpopulated submodule "
                "in the reference tree); refusing to substitute different "
                "parity bytes. Use technique=liberation (w prime) or "
                "cauchy_good instead.")
        if self._m != 2:
            raise ErasureCodeError(
                f"technique {self.technique!r} is RAID-6 only: m must be "
                f"2, not {self._m}")
        try:
            # technique-dependent default w: liberation needs w prime
            # (reference DEFAULT_W=7); blaum_roth needs w+1 prime, and
            # since we reject the reference's legacy w=7 tolerance the
            # default must be a valid 6
            default_w = "7" if self.technique == "liberation" else "6"
            w = int(profile.get("w", default_w))
            ps = int(profile.get("packetsize", "2048"))
        except ValueError as e:
            raise ErasureCodeError(f"bad w/packetsize in profile: {e}")
        if self.technique == "liberation":
            mat = bm.liberation_bitmatrix(self._k, w)
        else:
            # reference tolerates w=7 (w+1=8 not prime) for Firefly compat
            # (ErasureCodeJerasureBlaumRoth::check_w) — we do not: the
            # construction genuinely requires w+1 prime, so w=7 errors here
            mat = bm.blaum_roth_bitmatrix(self._k, w)
        self._bitengine = bm.BitMatrixEngine(self._k, w, ps, mat)
        self.generator = None   # no GF(2^8) generator: the bit-matrix
        #                         engine encodes on the host

    def _make_generator(self) -> np.ndarray:
        if self.technique in ("reed_sol_van", "reed_sol_r6_op"):
            return gf256.rs_vandermonde_matrix(self._k, self._m)
        # cauchy_orig/cauchy_good: plain GF(2^8) Cauchy — one matrix
        # apply engine serves every technique, so the bit-matrix
        # scheduling those jerasure techniques hand-coded on CPU has no
        # counterpart here.
        return gf256.cauchy_matrix(self._k, self._m)

    def get_chunk_size(self, object_size: int) -> int:
        if self._bitengine is None:
            return super().get_chunk_size(object_size)
        from ceph_tpu_torch.ec.bitmatrix import align_up, lcm
        from ceph_tpu_torch.ec.interface import CHUNK_ALIGN
        per = (object_size + self._k - 1) // self._k
        return align_up(per, lcm(self._bitengine.chunk_align(), CHUNK_ALIGN))

    # -- engine --------------------------------------------------------------
    def _apply(self, mat: np.ndarray, chunks: np.ndarray) -> np.ndarray:
        if self.device is not None:
            from ceph_tpu_torch.ec.kernel import matrix_apply
            return matrix_apply(mat, self.device)(chunks)
        return gf256.host_apply(mat, chunks)

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        assert data_chunks.shape[0] == self._k
        if self._bitengine is not None:
            return self._bitengine.encode(data_chunks)
        return self._apply(self.generator[self._k:], data_chunks)

    def decode_matrix_for(self, present: Sequence[int],
                          want: Sequence[int]) -> np.ndarray:
        """The cached [len(want), k] decode matrix reconstructing `want`
        chunk ids from the first k `present` ids — the rows a batching
        dispatcher (osd/ec_queue.py, parallel/mesh_exec.py) applies
        itself so concurrent degraded reads / rebuild decodes sharing a
        survivor set fold into one device launch.  Raises
        ErasureCodeError when no such matrix exists (non-MDS want)."""
        key = (tuple(present), tuple(want))
        mat = self._decode_cache.get(key)
        if mat is None:
            try:
                mat = gf256.decode_matrix(self.generator, list(present),
                                          list(want))
            except ValueError as e:
                raise ErasureCodeError(f"cannot decode {list(want)}: {e}")
            self._decode_cache[key] = mat
            if len(self._decode_cache) > self._decode_cache_size:
                self._decode_cache.popitem(last=False)
        else:
            self._decode_cache.move_to_end(key)
        return mat

    def decode_chunks(self, want: Sequence[int],
                      chunks: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        if self._bitengine is not None:
            return self._bitengine.decode(list(want), chunks)
        present = sorted(chunks)[:self._k]
        mat = self.decode_matrix_for(present, want)
        src = np.stack([np.asarray(chunks[i], np.uint8) for i in present])
        out = self._apply(mat, src)
        return {w: out[i] for i, w in enumerate(want)}


@register("rs")
@register("jerasure")
class RSCodec(_MatrixCodec):
    """Default RS-Vandermonde codec (plugin names 'rs' and 'jerasure')."""
    DEFAULT_TECHNIQUE = "reed_sol_van"


@register("isa")
class IsaCodec(_MatrixCodec):
    """ISA-L equivalent; same engine, ISA-style technique names."""
    DEFAULT_TECHNIQUE = "reed_sol_van"

    def _parse(self, profile: Dict[str, str]) -> None:
        profile = dict(profile)
        profile.setdefault("technique",
                           profile.pop("isa_technique", "reed_sol_van"))
        if profile["technique"] == "cauchy":
            profile["technique"] = "cauchy_good"
        super()._parse(profile)
