"""Fixed-point log2 used by straw2: crush_ln(x) = 2^44 * log2(x+1).

Reference parity: crush/mapper.c:246-288 (crush_ln) over the lookup tables in
crush/crush_ln_table.h, which document themselves as
    RH_LH_tbl[2k]   = 2^48 / (1.0 + k/128.0)
    RH_LH_tbl[2k+1] = 2^48 * log2(1.0 + k/128.0)
    LL_tbl[k]       = 2^48 * log2(1.0 + k/2^15)
The table CONSTANTS are behavioral ground truth: the reference's historical
generator deviates from the documented formulas in ways that matter for
bit-exactness (RH is ceil() not round; LH is floor(); LL matches
2^48*log2(1+k/2^15) only at the range endpoints and carries a generator
artifact in between).  We therefore carry the 514 constants as extracted
golden DATA (_ln_tables.json, produced by tests/golden/generate.py from the
reference header, pinned by the ln_fnv checksum in the golden corpus) and
keep the formula derivations below as validators for the rows that do obey
the documented math.
"""

from __future__ import annotations

import decimal
import json
import pathlib
from functools import lru_cache

import numpy as np

_SCALE48 = 1 << 48
_DATA = pathlib.Path(__file__).parent / "_ln_tables.json"


def _log2_fixed(num: int, den: int, scale: int = _SCALE48,
                rounding=decimal.ROUND_FLOOR) -> int:
    """floor/round(scale * log2(num/den)) via high-precision decimal."""
    assert num > 0 and den > 0
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        v = (decimal.Decimal(num).ln() - decimal.Decimal(den).ln()) \
            / decimal.Decimal(2).ln() * scale
        return int(v.to_integral_value(rounding=rounding))


@lru_cache(maxsize=1)
def _tables():
    d = json.loads(_DATA.read_text())
    return (np.array(d["rh"], np.int64), np.array(d["lh"], np.int64),
            np.array(d["ll"], np.int64))


def rh_lh_tables():
    """RH[k] ~ ceil(2^48*128/(128+k)), LH[k] ~ floor(2^48*log2(1+k/128))."""
    rh, lh, _ = _tables()
    return rh, lh


def ll_table():
    """LL[k] ~ 2^48*log2(1+k/2^15) (exact only at endpoints; see module doc)."""
    return _tables()[2]


def derived_rh(k: int) -> int:
    """Documented-formula RH row (ceil), for validation tests."""
    num = _SCALE48 * 128
    den = 128 + k
    return -((-num) // den)


def crush_ln(xin: int) -> int:
    """Scalar bit-exact crush_ln (mapper.c:246-288)."""
    rh_tbl, lh_tbl = rh_lh_tables()
    ll_tbl = ll_table()
    x = (xin + 1) & 0xFFFFFFFF
    iexpon = 15
    if not (x & 0x18000):
        # count bits needed so bit 15 becomes the MSB of x&0x1ffff
        v = x & 0x1FFFF
        bits = 16 - v.bit_length()  # == __builtin_clz(v) - 16 for v < 2^17
        x = (x << bits) & 0xFFFFFFFF
        iexpon = 15 - bits
    idx = (x >> 8)            # in [0x80, 0x100]
    k = idx - 128
    rh = int(rh_tbl[k])
    lh = int(lh_tbl[k])
    xl64 = (x * rh) >> 48     # ~ 2^15 + xf, xf < 2^8
    result = iexpon << 44
    ll = int(ll_tbl[xl64 & 0xFF])
    result += (lh + ll) >> 4  # >> (48 - 12 - 32)
    return result


@lru_cache(maxsize=1)
def ln_u16_table() -> np.ndarray:
    """Precomputed crush_ln(u) for every 16-bit draw u in [0, 0xffff].

    straw2 only ever calls crush_ln on u & 0xffff, so the whole function
    collapses to one 64K-entry table — this is what the plain torch engine
    gathers from (ops/crush_kernel.py) and what the host mapper uses for
    speed.
    """
    return np.array([crush_ln(u) for u in range(0x10000)], np.int64)
