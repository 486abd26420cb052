"""Exact negacyclic NTT over CRT primes — the replacement for the reference FFT.

The reference computes negacyclic torus-polynomial products with a double-precision
real FFT (`gpuParallel/fft_processor_fftw.cu:135-189` on CPU, cuFFT batched plans in
`gpuParallel/cudaFFTTest.cu` / `boot-gates.cu:2531-2536` on GPU), tolerating small
floating-point rounding noise. This module instead
computes the convolution **exactly** with number-theoretic transforms over two
~30-bit primes and CRT recombination to Torus32 (int32 wrap). This is bit-exact
integer math built entirely from uint32 adds/multiplies, and it adds
*zero* transform noise to ciphertexts (strictly better than the reference).

Value ranges: the only products we ever need are `decomposed * torus32` convolutions
with |decomp| <= Bg/2 = 512 summed over N <= 1024 terms, so |result| < 2^51 <
p1*p2/2 ~ 2^58.5. The CRT lift is therefore exact.

Algorithms: merged-twist negacyclic NTT (psi-powers folded into the butterfly
twiddles, Longa-Naehrig style), DIF forward (natural -> bit-reversed) and DIT
inverse (bit-reversed -> natural), so no bit-reversal permutations are needed.
All twiddle/fixed-operand multiplications use Shoup precomputation; generic
multiplications use Montgomery REDC. Everything is pure uint32 with wraparound.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# Two NTT-friendly primes < 2^30 with 2^24 | p-1 (so any N <= 2^23 works).
P1 = 998244353   # 119 * 2^23 + 1, generator 3
P2 = 754974721   # 45  * 2^24 + 1, generator 11
GENERATORS = {P1: 3, P2: 11}
PRIMES = (P1, P2)

# np (not jnp) so importing the library never touches a device backend
_U16 = np.uint32(0xFFFF)


# --------------------------------------------------------------------------
# uint32 modular primitives (jit-safe, shape polymorphic)
# --------------------------------------------------------------------------

def umulhi(a, b):
    """High 32 bits of the 64-bit product of two uint32 arrays (exact)."""
    a0 = a & _U16
    a1 = a >> 16
    b0 = b & _U16
    b1 = b >> 16
    # all partial products fit in uint32: (2^16-1)^2 + 2^16 - 1 < 2^32
    t = a1 * b0 + ((a0 * b0) >> 16)
    t2 = a0 * b1 + (t & _U16)
    return a1 * b1 + (t >> 16) + (t2 >> 16)


def add_mod(a, b, p: int):
    s = a + b
    return s - jnp.uint32(p) * (s >= jnp.uint32(p))


def sub_mod(a, b, p: int):
    return a - b + jnp.uint32(p) * (a < b)


def mul_mod_shoup(x, w, w_shoup, p: int):
    """x*w mod p where w is fixed and w_shoup = floor(w * 2^32 / p). Output in [0, p)."""
    q = umulhi(x, w_shoup)
    r = x * w - q * jnp.uint32(p)  # in [0, 2p)
    return r - jnp.uint32(p) * (r >= jnp.uint32(p))


def shoup(w: np.ndarray, p: int) -> np.ndarray:
    """Shoup precomputation floor(w * 2^32 / p) for a numpy array of values < p."""
    return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(p)).astype(np.uint32)


def _mont_constants(p: int):
    p_inv = pow(p, -1, 1 << 32)
    p_inv_neg = ((1 << 32) - p_inv) & 0xFFFFFFFF
    r2 = (1 << 64) % p
    return p_inv_neg, r2


def mont_mul(a, b, p: int):
    """Montgomery product a*b*2^-32 mod p for uint32 arrays, output in [0, p)."""
    p_inv_neg, _ = _mont_constants(p)
    t_lo = a * b
    t_hi = umulhi(a, b)
    m = t_lo * jnp.uint32(p_inv_neg)
    t = t_hi + umulhi(m, jnp.uint32(p)) + (t_lo != 0).astype(jnp.uint32)
    return t - jnp.uint32(p) * (t >= jnp.uint32(p))


def mul_mod(a, b, p: int):
    """Generic a*b mod p via Montgomery (both operands arbitrary in [0, p))."""
    _, r2 = _mont_constants(p)
    a_mont = mont_mul(a, jnp.uint32(r2), p)  # a * 2^32 mod p
    return mont_mul(a_mont, b, p)


def i32_to_residue(x, p: int):
    """Signed int32 array -> residue of the signed value mod p, in [0, p).

    Signed representatives are consistent with the CRT lift in crt_to_i32
    (the lift recovers the signed value, then wraps mod 2^32)."""
    x = jnp.asarray(x, jnp.int32)
    r = jax.lax.rem(x, jnp.int32(p))
    r = r + jnp.int32(p) * (r < 0).astype(jnp.int32)
    return r.astype(jnp.uint32)


def small_to_residue(x, p: int):
    """int32 values already in (-p, p) -> residue in [0, p). Cheap (hot path)."""
    x = jnp.asarray(x, jnp.int32)
    r = x + jnp.int32(p) * (x < 0).astype(jnp.int32)
    return r.astype(jnp.uint32)


# --------------------------------------------------------------------------
# Twiddle tables
# --------------------------------------------------------------------------

def _bit_reverse(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


@functools.lru_cache(maxsize=None)
def ntt_tables(N: int, p: int):
    """Precomputed merged-twist twiddle tables for size-N negacyclic NTT mod p.

    Returns dict of numpy uint32 arrays:
      psi_br / psi_br_shoup       : forward table, psi^brv(i), length N
      ipsi_br / ipsi_br_shoup     : inverse table, psi^-brv(i), length N
      n_inv / n_inv_shoup         : scalar N^-1 for the final inverse stage
      ipsi1_ninv / ..._shoup      : ipsi_br[1] * N^-1 (folded last-stage twiddle)
    """
    assert N & (N - 1) == 0
    bits = N.bit_length() - 1
    g = GENERATORS[p]
    psi = pow(g, (p - 1) // (2 * N), p)
    assert pow(psi, 2 * N, p) == 1 and pow(psi, N, p) == p - 1
    ipsi = pow(psi, -1, p)

    psi_br = np.zeros(N, dtype=np.uint32)
    ipsi_br = np.zeros(N, dtype=np.uint32)
    for i in range(N):
        r = _bit_reverse(i, bits)
        psi_br[i] = pow(psi, r, p)
        ipsi_br[i] = pow(ipsi, r, p)
    n_inv = pow(N, -1, p)
    ipsi1_ninv = (int(ipsi_br[1]) * n_inv) % p

    def sh(x):
        return shoup(np.asarray(x, dtype=np.uint32), p)

    return dict(
        psi_br=psi_br, psi_br_shoup=sh(psi_br),
        ipsi_br=ipsi_br, ipsi_br_shoup=sh(ipsi_br),
        n_inv=np.uint32(n_inv), n_inv_shoup=sh(np.array([n_inv]))[0],
        ipsi1_ninv=np.uint32(ipsi1_ninv), ipsi1_ninv_shoup=sh(np.array([ipsi1_ninv]))[0],
    )


# --------------------------------------------------------------------------
# Forward / inverse transforms (vectorized over leading axes)
# --------------------------------------------------------------------------

def ntt_forward(x, N: int, p: int):
    """Negacyclic forward NTT mod p. Input uint32 [..., N] in [0,p), natural order.
    Output uint32 [..., N] in [0,p), bit-reversed order (matching ntt_inverse)."""
    tabs = ntt_tables(N, p)
    psi = tabs["psi_br"]
    psi_sh = tabs["psi_br_shoup"]
    batch = x.shape[:-1]
    m, t = 1, N
    while m < N:
        t //= 2
        xr = x.reshape(batch + (m, 2, t))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        s = jnp.asarray(psi[m:2 * m]).reshape((1,) * len(batch) + (m, 1))
        s_sh = jnp.asarray(psi_sh[m:2 * m]).reshape((1,) * len(batch) + (m, 1))
        wv = mul_mod_shoup(v, s, s_sh, p)
        x = jnp.stack([add_mod(u, wv, p), sub_mod(u, wv, p)], axis=-2).reshape(batch + (N,))
        m *= 2
    return x


def ntt_inverse(x, N: int, p: int):
    """Negacyclic inverse NTT mod p. Input bit-reversed [..., N], output natural,
    scaled by N^-1 (i.e. exact inverse of ntt_forward)."""
    tabs = ntt_tables(N, p)
    ipsi = tabs["ipsi_br"]
    ipsi_sh = tabs["ipsi_br_shoup"]
    batch = x.shape[:-1]
    t, m = 1, N
    while m > 2:
        h = m // 2
        xr = x.reshape(batch + (h, 2, t))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        s = jnp.asarray(ipsi[h:2 * h]).reshape((1,) * len(batch) + (h, 1))
        s_sh = jnp.asarray(ipsi_sh[h:2 * h]).reshape((1,) * len(batch) + (h, 1))
        x = jnp.stack(
            [add_mod(u, v, p), mul_mod_shoup(sub_mod(u, v, p), s, s_sh, p)],
            axis=-2,
        ).reshape(batch + (N,))
        t *= 2
        m = h
    # final stage (m == 2): fold N^-1 into both branches
    xr = x.reshape(batch + (1, 2, N // 2))
    u = xr[..., 0, :]
    v = xr[..., 1, :]
    lo = mul_mod_shoup(add_mod(u, v, p), jnp.uint32(tabs["n_inv"]),
                       jnp.uint32(tabs["n_inv_shoup"]), p)
    hi = mul_mod_shoup(sub_mod(u, v, p), jnp.uint32(tabs["ipsi1_ninv"]),
                       jnp.uint32(tabs["ipsi1_ninv_shoup"]), p)
    return jnp.concatenate([lo, hi], axis=-1).reshape(batch + (N,))


# --------------------------------------------------------------------------
# Row-major transforms (transform axis = -2, lanes = batch)
#
# Butterflies slice a major axis only; the minor axis carries the batch.
# This is the layout of the blind rotate's XLA scan.
# --------------------------------------------------------------------------

def ntt_forward_rows(x, N: int, p: int):
    """Forward negacyclic NTT along axis -2. x: uint32[..., N, L] in [0, p).
    Output bit-reversed along axis -2."""
    tabs = ntt_tables(N, p)
    psi = tabs["psi_br"]
    psi_sh = tabs["psi_br_shoup"]
    lead = x.shape[:-2]
    L = x.shape[-1]
    nb = len(lead)
    m, t = 1, N
    while m < N:
        t //= 2
        xr = x.reshape(lead + (m, 2, t, L))
        u = xr[..., 0, :, :]
        v = xr[..., 1, :, :]
        s = jnp.asarray(psi[m:2 * m]).reshape((1,) * nb + (m, 1, 1))
        s_sh = jnp.asarray(psi_sh[m:2 * m]).reshape((1,) * nb + (m, 1, 1))
        wv = mul_mod_shoup(v, s, s_sh, p)
        x = jnp.stack([add_mod(u, wv, p), sub_mod(u, wv, p)], axis=-3)
        x = x.reshape(lead + (N, L))
        m *= 2
    return x


def ntt_inverse_rows(x, N: int, p: int):
    """Inverse of ntt_forward_rows (input bit-reversed along -2, output natural)."""
    tabs = ntt_tables(N, p)
    ipsi = tabs["ipsi_br"]
    ipsi_sh = tabs["ipsi_br_shoup"]
    lead = x.shape[:-2]
    L = x.shape[-1]
    nb = len(lead)
    t, m = 1, N
    while m > 2:
        h = m // 2
        xr = x.reshape(lead + (h, 2, t, L))
        u = xr[..., 0, :, :]
        v = xr[..., 1, :, :]
        s = jnp.asarray(ipsi[h:2 * h]).reshape((1,) * nb + (h, 1, 1))
        s_sh = jnp.asarray(ipsi_sh[h:2 * h]).reshape((1,) * nb + (h, 1, 1))
        x = jnp.stack(
            [add_mod(u, v, p), mul_mod_shoup(sub_mod(u, v, p), s, s_sh, p)],
            axis=-3,
        ).reshape(lead + (N, L))
        t *= 2
        m = h
    xr = x.reshape(lead + (1, 2, N // 2, L))
    u = xr[..., 0, :, :]
    v = xr[..., 1, :, :]
    lo = mul_mod_shoup(add_mod(u, v, p), jnp.uint32(tabs["n_inv"]),
                       jnp.uint32(tabs["n_inv_shoup"]), p)
    hi = mul_mod_shoup(sub_mod(u, v, p), jnp.uint32(tabs["ipsi1_ninv"]),
                       jnp.uint32(tabs["ipsi1_ninv_shoup"]), p)
    return jnp.concatenate([lo, hi], axis=-2).reshape(lead + (N, L))


# --------------------------------------------------------------------------
# Pure-numpy forward transform (keygen / key-import path)
#
# Key conversion (BK -> NTT domain) is one-shot host work; doing it in numpy
# keeps XLA (and its compile time) entirely off the keygen path.
# --------------------------------------------------------------------------

def ntt_forward_np(x: np.ndarray, N: int, p: int) -> np.ndarray:
    """Numpy twin of ntt_forward: uint64 in [0,p) [..., N] natural order ->
    uint32 [..., N] bit-reversed order. Exact (uint64 modmuls)."""
    tabs = ntt_tables(N, p)
    psi = tabs["psi_br"].astype(np.uint64)
    x = np.ascontiguousarray(x, np.uint64)
    batch = x.shape[:-1]
    m = 1
    while m < N:
        xr = x.reshape(batch + (m, 2, N // (2 * m)))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        s = psi[m:2 * m].reshape((1,) * len(batch) + (m, 1))
        wv = (v * s) % p
        x = np.stack([(u + wv) % p, (u - wv + p) % p], axis=-2).reshape(batch + (N,))
        m *= 2
    return x.astype(np.uint32)


def i32_to_residue_np(x: np.ndarray, p: int) -> np.ndarray:
    """Numpy twin of i32_to_residue: signed int32 -> uint64 residue in [0, p)."""
    return (np.asarray(x).astype(np.int64) % p).astype(np.uint64)


# --------------------------------------------------------------------------
# CRT recombination to Torus32
# --------------------------------------------------------------------------

_INV_P1_MOD_P2 = pow(P1, -1, P2)
_M_MOD_2_32 = (P1 * P2) & 0xFFFFFFFF
_T_HALF = (P2 - 1) // 2
_R1_HALF = (P1 + 1) // 2
_INV_P1_SHOUP = int((_INV_P1_MOD_P2 << 32) // P2)


def crt_to_i32(r1, r2):
    """Exact CRT lift (r1 mod P1, r2 mod P2) -> signed value mod 2^32 (int32).

    Valid for |true value| < P1*P2/2 (~2^58.5); our convolutions stay < 2^51.
    Garner: v = r1 + P1 * ((r2 - r1) * P1^-1 mod P2), then subtract P1*P2 when the
    representative lies in the upper half (exact comparison, no float rounding).
    """
    # r1 < P1 may exceed P2 (P1 > P2), so reduce r1 mod P2 first.
    r1p2 = r1 - jnp.uint32(P2) * (r1 >= jnp.uint32(P2))
    diff = sub_mod(r2, r1p2, P2)
    t = mul_mod_shoup(diff, jnp.uint32(_INV_P1_MOD_P2), jnp.uint32(_INV_P1_SHOUP), P2)
    rep_lo = r1 + jnp.uint32(P1) * t  # mod 2^32 wrap, exact
    upper = (t > jnp.uint32(_T_HALF)) | ((t == jnp.uint32(_T_HALF)) & (r1 >= jnp.uint32(_R1_HALF)))
    rep_lo = rep_lo - jnp.uint32(_M_MOD_2_32) * upper.astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(rep_lo, jnp.int32)


# --------------------------------------------------------------------------
# Reference-grade convenience: exact negacyclic polynomial multiply
# --------------------------------------------------------------------------

@jax.jit
def negacyclic_polymul_i32(a, b):
    """Exact negacyclic product of int32 polynomials mod 2^32 (wrap), [..., N].

    Semantics match `torusPolynomialMultKaratsuba`/the FFT path of the reference
    (`gpuParallel/multiplication.cu:126`, `fft_processor_fftw.cu:194-200`) but with
    exact integer arithmetic. `a` coefficients must be "small" ints (|a| < 2^20)
    so products fit the CRT range; this holds for every TFHE use (decomposed or
    key polynomials times torus polynomials).
    """
    N = a.shape[-1]
    out = None
    residues = []
    for p in PRIMES:
        ar = i32_to_residue(a, p)
        br = i32_to_residue(b, p)
        fa = ntt_forward(ar, N, p)
        fb = ntt_forward(br, N, p)
        prod = mul_mod(fa, fb, p)
        residues.append(ntt_inverse(prod, N, p))
    return crt_to_i32(residues[0], residues[1])
