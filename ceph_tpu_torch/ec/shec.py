"""SHEC: shingled erasure code — overlapping sparse parities.

Reference parity: ErasureCodeShec
(src/erasure-code/shec/ErasureCodeShec.cc, 823 lines;
technique multiple-SHEC).  Profile k/m/c: m parity chunks, each covering a
width-ceil(k*c/m) shingle of the data chunks, giving durability ~c while
reading fewer chunks on single-failure recovery.  c == m degenerates to
plain RS.

The parity rows are a Cauchy row restricted to the shingle window, so the
generator is sparse; decode uses the rowspan solve (gf256.express_rows)
over whatever chunks are present — the moral equivalent of the reference's
decode-matrix search with its table cache.

The port's copy of ``ceph_tpu.ec.shec``: the matrix applies run on the
codec's torch device (``ceph_tpu_torch/ec/kernel.py``: the CUDA kernel on
a card, its plain PyTorch version on the CPU), or on the numpy host path
for a profile with ``backend=host``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence, Set

import numpy as np

from ceph_tpu_torch.common.device import resolve_device
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError
from ceph_tpu_torch.ec.registry import register


@register("shec")
class SHECCodec(ErasureCode):

    def __init__(self, **kw):
        super().__init__(**kw)
        self._k = 0
        self._m = 0
        self._c = 0
        self.generator: np.ndarray = None
        #: the resolved torch device of the matrix applies; None for a
        #: backend=host profile
        self.device = None
        self._decode_cache: OrderedDict = OrderedDict()

    @property
    def k(self) -> int:
        return self._k

    @property
    def m(self) -> int:
        return self._m

    def _parse(self, profile: Dict[str, str]) -> None:
        try:
            self._k = int(profile.get("k", 4))
            self._m = int(profile.get("m", 3))
            self._c = int(profile.get("c", 2))
        except ValueError as e:
            raise ErasureCodeError(f"shec: bad k/m/c: {e}")
        if not (1 <= self._c <= self._m):
            raise ErasureCodeError(
                f"shec: need 1 <= c={self._c} <= m={self._m}")
        if self._k < 1 or self._k + self._m > 255:
            raise ErasureCodeError("shec: need 1 <= k and k+m <= 255")
        self.device = (None if profile.get("backend", "tpu") == "host"
                       else resolve_device(self.requested_device))
        self.generator = self._make_generator()

    def _make_generator(self) -> np.ndarray:
        k, m, c = self._k, self._m, self._c
        width = min(k, -(-k * c // m))          # ceil(k*c/m), the shingle
        g = np.zeros((k + m, k), np.uint8)
        g[:k] = gf256.identity(k)
        for j in range(m):
            start = (j * k) // m
            for t in range(width):
                i = (start + t) % k             # shingles wrap for balance
                g[k + j, i] = gf256.gf_inv((k + j) ^ i)
        return g

    def parity_coverage(self, j: int):
        """Data chunk ids parity j covers (for tests/introspection)."""
        return [i for i in range(self._k) if self.generator[self._k + j, i]]

    # -- data path -----------------------------------------------------------
    def _apply(self, mat: np.ndarray, chunks: np.ndarray) -> np.ndarray:
        if self.device is not None:
            from ceph_tpu_torch.ec.kernel import matrix_apply
            return matrix_apply(mat, self.device)(chunks)
        return gf256.host_apply(mat, chunks)

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        return self._apply(self.generator[self._k:], data_chunks)

    def decode_chunks(self, want: Sequence[int],
                      chunks: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        present = sorted(chunks)
        key = (tuple(present), tuple(want))
        mat = self._decode_cache.get(key)
        if mat is None:
            try:
                mat = gf256.express_rows(self.generator[present],
                                         self.generator[list(want)])
            except ValueError as e:
                raise ErasureCodeError(f"shec: cannot decode {want}: {e}")
            self._decode_cache[key] = mat
            if len(self._decode_cache) > 64:
                self._decode_cache.popitem(last=False)
        src = np.stack([np.asarray(chunks[i], np.uint8) for i in present])
        out = self._apply(mat, src)
        return {w: out[i] for i, w in enumerate(want)}

    # -- decode planning -----------------------------------------------------
    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]) -> Set[int]:
        """Smallest chunk set that actually decodes: greedy by sparsity with
        a rank check, the point of SHEC's partial-read recovery."""
        if want_to_read <= available:
            return set(want_to_read)
        missing = set(want_to_read) - available
        # grow sparsest-first until the missing rows enter the rowspan of
        # the chosen rows, then prune back to a minimal read set
        keep: Set[int] = set(want_to_read & available)
        found = None
        chosen = set(keep)
        if self._decodable(chosen, missing):
            found = chosen
        else:
            candidates = sorted(
                available - chosen,
                key=lambda cid: (int(np.count_nonzero(self.generator[cid])),
                                 cid))
            for cid in candidates:
                chosen = chosen | {cid}
                if self._decodable(chosen, missing):
                    found = chosen
                    break
        if found is None:
            raise ErasureCodeError(
                f"shec: cannot decode {sorted(missing)} from "
                f"{sorted(available)}")
        for cid in sorted(found - keep):
            if self._decodable(found - {cid}, missing):
                found = found - {cid}
        return found

    def _decodable(self, have: Set[int], missing: Set[int]) -> bool:
        if not have:
            return False
        try:
            gf256.express_rows(self.generator[sorted(have)],
                               self.generator[sorted(missing)])
            return True
        except ValueError:
            return False
