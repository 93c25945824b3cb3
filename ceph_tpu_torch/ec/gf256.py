"""GF(2^8) arithmetic and erasure-code matrix construction (host side).

The port's copy of ``ceph_tpu.ec.gf256``, which is pure numpy: the port
keeps its own so that it imports nothing of the JAX package.  The field
uses the conventional polynomial 0x11d (x^8+x^4+x^3+x^2+1), the same
field ISA-L and jerasure w=8 use.

A multiply by a *constant* c in GF(2^8) is a linear map over GF(2) on the
8 bits of the operand, i.e. an 8x8 bit-matrix M_c with column j =
bits(c * x^j).  An (m x k) GF(2^8) code matrix therefore expands to an
(8m x 8k) GF(2) bit-matrix (``expand_to_bitmatrix``), which is the operand
of the plain PyTorch matrix apply in ceph_tpu_torch/ec/kernel.py.  The
CUDA kernel beside it looks products up in small tables by byte
permute instead (``kernel.prmt_tables``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np

POLY = 0x11D


@lru_cache(maxsize=1)
def _tables():
    """log/exp tables for the 0x11d field; generator 2 is primitive."""
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[0:255]
    return exp, log


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = _tables()
    return int(exp[log[a] + log[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf256 inverse of 0")
    exp, log = _tables()
    return int(exp[255 - log[a]])


def gf_div(a: int, b: int) -> int:
    return gf_mul(a, gf_inv(b)) if a else 0


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    exp, log = _tables()
    return int(exp[(log[a] * n) % 255])


@lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 product table (64 KiB) for vectorized host encode."""
    exp, log = _tables()
    a = np.arange(256)
    t = exp[(log[a][:, None] + log[a][None, :]) % 255].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


# -- matrix algebra over GF(2^8) (numpy uint8 matrices) ----------------------

def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product via the mul table + XOR reduction."""
    t = mul_table()
    prods = t[a[:, :, None], b[None, :, :]]           # [r, inner, c]
    return np.bitwise_xor.reduce(prods, axis=1).astype(np.uint8)


def mat_vec(a: np.ndarray, v: np.ndarray) -> np.ndarray:
    return mat_mul(a, v.reshape(-1, 1)).ravel()


def mat_inv(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion; raises ValueError if singular."""
    n = a.shape[0]
    assert a.shape == (n, n)
    aug = np.concatenate([a.astype(np.uint8),
                          np.eye(n, dtype=np.uint8)], axis=1)
    t = mul_table()
    for col in range(n):
        piv = None
        for r in range(col, n):
            if aug[r, col]:
                piv = r
                break
        if piv is None:
            raise ValueError("singular matrix over GF(2^8)")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = t[inv, aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= t[int(aug[r, col]), aug[col]]
    return aug[:, n:].copy()


def identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


# -- code matrix construction ------------------------------------------------

def rs_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """Systematic RS generator [(k+m) x k]: top k rows identity.

    Built like ISA-L gf_gen_rs_matrix (reference
    src/erasure-code/isa/ErasureCodeIsa.cc:297-303 calls it for
    technique reed_sol_van): start from the Vandermonde matrix
    V[i, j] = i**j (gf_pow) and normalize so the top block is I, which keeps
    any k of the k+m rows invertible for k+m <= 255.
    """
    n = k + m
    if n > 255:
        raise ValueError("k+m must be <= 255 for GF(2^8) RS")
    v = np.zeros((n, k), np.uint8)
    for i in range(n):
        for j in range(k):
            v[i, j] = gf_pow(i, j) if i else (1 if j == 0 else 0)
    top_inv = mat_inv(v[:k])
    return mat_mul(v, top_inv)


def cauchy_matrix(k: int, m: int) -> np.ndarray:
    """Systematic Cauchy generator [(k+m) x k] (ISA-L gf_gen_cauchy1_matrix
    shape; reference src/erasure-code/isa/ErasureCodeIsa.cc:305-311).  Parity
    row i, col j = 1/((k+i) ^ j); every square minor of a Cauchy matrix is
    nonsingular, so any k rows of [I; C] decode.
    """
    if k + m > 255:
        raise ValueError("k+m must be <= 255 for GF(2^8) Cauchy")
    g = np.zeros((k + m, k), np.uint8)
    g[:k] = identity(k)
    for i in range(m):
        for j in range(k):
            g[k + i, j] = gf_inv((k + i) ^ j)
    return g


def decode_matrix(gen: np.ndarray, present: Sequence[int],
                  want: Sequence[int]) -> np.ndarray:
    """Rows that reconstruct `want` chunk ids from the first k `present` ids.

    gen is the systematic [(k+m) x k] generator.  Mirrors the decode-table
    construction in ErasureCodeIsa::erasure_code_create_decode_matrix
    (reference src/erasure-code/isa/ErasureCodeIsa.cc:397-443): invert the
    survivor submatrix, then compose with the generator rows of the wanted
    chunks.
    """
    k = gen.shape[1]
    rows = list(present)[:k]
    if len(rows) < k:
        raise ValueError(f"need {k} chunks, have {len(rows)}")
    sub = gen[rows]                     # [k, k]
    inv = mat_inv(sub)                  # data = inv @ survivors
    out = np.zeros((len(want), k), np.uint8)
    for i, w in enumerate(want):
        out[i] = mat_mul(gen[w:w + 1], inv)[0]
    return out


def express_rows(rows: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Return M (t x n) with M @ rows == targets over GF(2^8), or raise
    ValueError if some target row is outside the rowspan of `rows`.

    This is the exact condition for decodability from partial chunks: chunk w
    (= G[w] . data) is computable from chunks H iff G[w] is in
    rowspan(G[H]) — needed by sparse codes (SHEC) where fewer than k chunks
    can suffice for a local repair.
    """
    n, k = rows.shape
    t_cnt = targets.shape[0]
    assert targets.shape[1] == k
    tbl = mul_table()
    aug = np.concatenate([rows.T.astype(np.uint8),
                          targets.T.astype(np.uint8)], axis=1)  # k x (n+t)
    pivots = []
    row = 0
    for col in range(n):
        piv = None
        for r in range(row, k):
            if aug[r, col]:
                piv = r
                break
        if piv is None:
            continue
        if piv != row:
            aug[[row, piv]] = aug[[piv, row]]
        inv = gf_inv(int(aug[row, col]))
        aug[row] = tbl[inv, aug[row]]
        for r in range(k):
            if r != row and aug[r, col]:
                aug[r] ^= tbl[int(aug[r, col]), aug[row]]
        pivots.append((row, col))
        row += 1
        if row == k:
            break
    for r in range(row, k):
        if aug[r, n:].any():
            raise ValueError("target chunks not in rowspan (undecodable)")
    out = np.zeros((t_cnt, n), np.uint8)
    for prow, pcol in pivots:
        out[:, pcol] = aug[prow, n:]
    return out


# -- GF(2) bit-matrix expansion (the plain version's operand) ---------------------------

@lru_cache(maxsize=4096)
def _const_bitmatrix(c: int) -> bytes:
    """8x8 GF(2) matrix of 'multiply by c'; column j = bits(c * x^j)."""
    m = np.zeros((8, 8), np.uint8)
    for j in range(8):
        prod = gf_mul(c, 1 << j)
        for i in range(8):
            m[i, j] = (prod >> i) & 1
    return m.tobytes()


def expand_to_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """[(r x c) GF(2^8)] -> [(8r x 8c) GF(2)] block matrix of M_c blocks."""
    r, c = mat.shape
    out = np.zeros((8 * r, 8 * c), np.uint8)
    for i in range(r):
        for j in range(c):
            blk = np.frombuffer(_const_bitmatrix(int(mat[i, j])),
                                np.uint8).reshape(8, 8)
            out[8 * i:8 * i + 8, 8 * j:8 * j + 8] = blk
    return out


# -- host (numpy) encode path: ground truth for the kernel -------------------

def host_apply(mat: np.ndarray, chunks: np.ndarray) -> np.ndarray:
    """Apply an (r x k) GF(2^8) matrix to k chunks of bytes: out[r, L].

    This is the semantic ground truth the CUDA kernel
    (ceph_tpu_torch/ec/kernel.py) must match bit-for-bit; it is also the
    host path of the codecs (profile backend=host) and of the EC batch
    queue's small lone requests.
    """
    t = mul_table()
    r, k = mat.shape
    assert chunks.shape[0] == k
    out = np.zeros((r, chunks.shape[1]), np.uint8)
    for i in range(r):
        acc = out[i]
        for j in range(k):
            coeff = int(mat[i, j])
            if coeff:
                acc ^= t[coeff, chunks[j]]
    return out
