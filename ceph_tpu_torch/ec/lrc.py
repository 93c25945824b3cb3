"""Locally-repairable codes: layered sub-codecs with cheap local repair.

Reference parity: ErasureCodeLrc
(src/erasure-code/lrc/ErasureCodeLrc.h:61,126-133, .cc 848
lines).  Two profile forms, like the reference:

  * generic: ``mapping`` (chunk layout string) + ``layers`` (list of
    [select_string, sub_profile]) — each layer is an independent sub-codec
    over the positions its select string marks, 'D' = layer data input,
    'c' = layer coding output, '_' = not in this layer.
  * k/m/l shorthand (reference parse_kml): a global RS(k, m) layer plus one
    local XOR-parity per group of ``l`` chunks; requires (k+m) % l == 0 and
    adds (k+m)/l local-parity chunks.  Layout: [D*k, G*m, L*(k+m)/l] — the
    reference interleaves locals into the mapping string instead; the layout
    differs, the repair capability is the same.

Decode iterates layers to a fixpoint so a single lost chunk is repaired from
its l-wide local group (the whole point of LRC), falling back to the global
layer; minimum_to_decode_with_cost picks the cheapest covering layer
(reference minimum_to_decode_with_cost for low-cost repair).

The port's copy of ``ceph_tpu.ec.lrc``: every layer's sub-codec is built
on the LRC codec's requested device, so a codec asked for on the CPU
never reaches for a card, and one on ``cuda`` runs each layer's matrix
applies in the CUDA kernel.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from ceph_tpu_torch.common.device import DEFAULT_DEVICE, DeviceLike
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError
from ceph_tpu_torch.ec.registry import factory, register


class _Layer:
    def __init__(self, select: str, profile: Dict[str, str],
                 device: DeviceLike = DEFAULT_DEVICE):
        self.select = select
        self.data_pos = [i for i, ch in enumerate(select) if ch == "D"]
        self.code_pos = [i for i, ch in enumerate(select) if ch == "c"]
        prof = dict(profile)
        prof["k"] = str(len(self.data_pos))
        prof["m"] = str(len(self.code_pos))
        self.codec = factory(prof.pop("plugin", "rs"), prof, device=device)
        self.positions = self.data_pos + self.code_pos

    def encode_into(self, chunks: Dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[p] for p in self.data_pos])
        parity = self.codec.encode_chunks(data)
        for i, p in enumerate(self.code_pos):
            chunks[p] = parity[i]

    def try_repair(self, chunks: Dict[int, np.ndarray],
                   missing: Set[int]) -> bool:
        """Repair any missing chunk covered by this layer if >= k of the
        layer's positions are present.  Returns True on progress."""
        mine = set(self.positions)
        lost = missing & mine
        if not lost:
            return False
        have = {i: p for i, p in enumerate(self.positions)
                if p in chunks}
        if len(have) < self.codec.k:
            return False
        local = {i: chunks[p] for i, p in have.items()}
        want_local = {i for i, p in enumerate(self.positions) if p in lost}
        try:
            out = self.codec.decode(want_local, local)
        except ErasureCodeError:
            return False
        for i in want_local:
            chunks[self.positions[i]] = out[i]
            missing.discard(self.positions[i])
        return True


@register("lrc")
class LRCCodec(ErasureCode):

    def __init__(self, **kw):
        super().__init__(**kw)
        self.mapping = ""
        self.layers: List[_Layer] = []
        self._k = 0
        self._m = 0

    @property
    def k(self) -> int:
        return self._k

    @property
    def m(self) -> int:
        return self._m

    def _parse(self, profile: Dict[str, str]) -> None:
        if "layers" in profile:
            self.mapping = profile.get("mapping", "")
            if not self.mapping:
                raise ErasureCodeError("lrc: 'layers' requires 'mapping'")
            layers = profile["layers"]
            if isinstance(layers, str):
                layers = json.loads(layers)
            self.layers = []
            for sel, sub in layers:
                if isinstance(sub, str):
                    sub = dict(kv.split("=", 1)
                               for kv in sub.split() if "=" in kv)
                if len(sel) != len(self.mapping):
                    raise ErasureCodeError(
                        f"lrc: layer select {sel!r} length != mapping")
                self.layers.append(_Layer(sel, sub,
                                          self.requested_device))
            self._k = sum(1 for ch in self.mapping if ch == "D")
            self._m = len(self.mapping) - self._k
        else:
            self._parse_kml(profile)
        covered = set()
        for layer in self.layers:
            covered.update(layer.code_pos)
        coding_pos = {i for i, ch in enumerate(self.mapping) if ch != "D"}
        if covered != coding_pos:
            raise ErasureCodeError(
                f"lrc: coding positions {sorted(coding_pos - covered)} "
                "produced by no layer")

    def _parse_kml(self, profile: Dict[str, str]) -> None:
        try:
            k = int(profile.get("k", 4))
            m = int(profile.get("m", 2))
            l = int(profile.get("l", 3))
        except ValueError as e:
            raise ErasureCodeError(f"lrc: bad k/m/l: {e}")
        if (k + m) % l != 0:
            raise ErasureCodeError(f"lrc: (k+m)={k + m} not divisible by l={l}")
        groups = (k + m) // l
        total = k + m + groups
        self._k = k
        self._m = m + groups
        # layout: k data, m global parity, then one local parity per group
        self.mapping = "D" * k + "_" * (m + groups)
        # sub-codec options (technique/backend/...) propagate to every layer
        sub = {key: v for key, v in profile.items()
               if key not in ("k", "m", "l", "plugin", "mapping", "layers")}
        sub.setdefault("technique", "reed_sol_van")
        glob_sel = "D" * k + "c" * m + "_" * groups
        self.layers = [_Layer(glob_sel, dict(sub), self.requested_device)]
        for g in range(groups):
            sel = ["_"] * total
            for pos in range(g * l, (g + 1) * l):
                sel[pos] = "D"
            sel[k + m + g] = "c"
            self.layers.append(_Layer("".join(sel), dict(sub),
                                      self.requested_device))

    # -- data path -----------------------------------------------------------
    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        total = len(self.mapping)
        data_pos = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        chunks: Dict[int, np.ndarray] = {
            p: data_chunks[i] for i, p in enumerate(data_pos)}
        for layer in self.layers:
            layer.encode_into(chunks)
        coding_pos = [i for i in range(total) if i not in set(data_pos)]
        return np.stack([chunks[p] for p in coding_pos])

    def decode_chunks(self, want: Sequence[int],
                      chunks: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        # map external chunk ids (data first, then coding) to positions
        pos_of = self._position_map()
        state = {pos_of[c]: np.asarray(v, np.uint8)
                 for c, v in chunks.items()}
        missing = {pos_of[w] for w in want if pos_of[w] not in state}
        progress = True
        while missing and progress:
            progress = False
            for layer in self.layers:
                if layer.try_repair(state, missing):
                    progress = True
        if missing:
            raise ErasureCodeError(
                f"lrc: cannot repair positions {sorted(missing)}")
        return {w: state[pos_of[w]] for w in want}

    def _position_map(self) -> Dict[int, int]:
        """chunk id (data 0..k-1 then coding) -> mapping position."""
        data_pos = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        coding_pos = [i for i in range(len(self.mapping))
                      if self.mapping[i] != "D"]
        order = data_pos + coding_pos
        return {cid: p for cid, p in enumerate(order)}

    # -- decode planning -----------------------------------------------------
    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]) -> Set[int]:
        if want_to_read <= available:
            return set(want_to_read)
        plan = self._plan(want_to_read, available,
                          {c: 1 for c in available})
        if plan is None:
            raise ErasureCodeError("lrc: no layer combination can decode")
        return plan

    def minimum_to_decode_with_cost(self, want_to_read: Set[int],
                                    available: Dict[int, int]) -> Set[int]:
        plan = self._plan(want_to_read, set(available), available)
        if plan is None:
            raise ErasureCodeError("lrc: no layer combination can decode")
        return plan

    def _plan(self, want: Set[int], available: Set[int],
              cost: Dict[int, int]):
        """Cheapest covering layer per missing chunk; None if impossible."""
        pos_of = self._position_map()
        chunk_of = {p: c for c, p in pos_of.items()}
        need: Set[int] = set(want & available)
        missing = [pos_of[w] for w in want if w not in available]
        for pos in missing:
            best: Tuple[int, Set[int]] = None
            for layer in self.layers:
                if pos not in layer.positions:
                    continue
                srcs = {chunk_of[p] for p in layer.positions
                        if p != pos and chunk_of[p] in available}
                if len(srcs) < layer.codec.k:
                    continue
                chosen = set(sorted(srcs, key=lambda c: (cost[c], c))
                             [:layer.codec.k])
                total = sum(cost[c] for c in chosen)
                if best is None or total < best[0]:
                    best = (total, chosen)
            if best is None:
                # multi-layer cascade: fall back to everything available
                if len(available) >= self._k:
                    return set(available)
                return None
            need |= best[1]
        return need
