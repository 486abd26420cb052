"""Bootstrapped boolean gate API (batched).

The 14 classic gates of the reference (`gpuParallel/boot-gates.cu:98-448`), the
coalesced n-bit variants (`bootsAND_16`, `boot-gates.cu:595`), the compound
gates (`bootsANDXOR_16`/`bootsXORXOR_16`, `boot-gates.cu:759,846`; paper
section V-A3), and MUX (`boot-gates.cu:2631-2843`).

Design: a gate is an affine combination of input batches followed by
one batched bootstrap. ALL two-input gates share one compiled kernel (the gate
constants are dynamic scalars), and a compound gate is just "stack two affine
images on the batch axis before the bootstrap", so there is no `_16_2_vector`
style variant explosion. Arbitrary leading batch shapes are supported; a batch
of gates over B bits costs one bootstrap kernel of batch B.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .core.lwe import (LweCiphertext, lwe_concat, lwe_negate,
                       noiseless_trivial)
from .core import bootstrap as bs

# Torus constants (modSwitchToTorus32(x, Msize))
_1_8 = 1 << 29   # modSwitchToTorus32(1, 8)
_1_4 = 1 << 30   # modSwitchToTorus32(1, 4)
MU = _1_8        # output amplitude of every bootstrapped gate
MU16 = 1 << 28   # ±1/16: the compressor-internal bit amplitude (see septets)

# gate -> (constant, coef_a, coef_b); phase>0 => output 1/8
# (constants from boot-gates.cu:106,132,158,198,224,283,309,335,361,387,420,436)
GATE_TABLE = {
    "NAND":  (+_1_8, -1, -1),
    "OR":    (+_1_8, +1, +1),
    "AND":   (-_1_8, +1, +1),
    "XOR":   (+_1_4, +2, +2),
    "XNOR":  (-_1_4, -2, -2),
    "NOR":   (-_1_8, -1, -1),
    "ANDNY": (-_1_8, -1, +1),   # not(a) and b
    "ANDYN": (-_1_8, +1, -1),   # a and not(b)
    "ORNY":  (+_1_8, -1, +1),   # not(a) or b
    "ORYN":  (+_1_8, +1, -1),   # a or not(b)
}


@jax.jit
def _affine2(x: LweCiphertext, y: LweCiphertext, const, ca, cb) -> LweCiphertext:
    """(0, const) + ca*x + cb*y with int32 wrap (the gate affine stage)."""
    const = jnp.asarray(const, jnp.int32)
    ca = jnp.asarray(ca, jnp.int32)
    cb = jnp.asarray(cb, jnp.int32)
    a = ca[..., None] * x.a + cb[..., None] * y.a
    b = const + ca * x.b + cb * y.b
    cv = ca.astype(jnp.float32) ** 2 * x.cv + cb.astype(jnp.float32) ** 2 * y.cv
    return LweCiphertext(a, b, cv)


@jax.jit
def _gate2_jit(x: LweCiphertext, y: LweCiphertext, const, ca, cb, mu, cloud):
    """Whole gate (flatten -> affine -> bootstrap -> unflatten) as ONE program
    — a single dispatch."""
    shape = x.batch_shape
    B = 1
    for s in shape:
        B *= s
    t = _affine2(x.reshape(B), y.reshape(B), const, ca, cb)
    out = bs.bootstrap(t, mu, cloud)
    return out.reshape(shape)


@jax.jit
def _gate2_pair_jit(x1, y1, x2, y2, c1, a1, b1, c2, a2, b2, cloud):
    shape = x1.batch_shape
    B = 1
    for s in shape:
        B *= s
    t1 = _affine2(x1.reshape(B), y1.reshape(B), c1, a1, b1)
    t2 = _affine2(x2.reshape(B), y2.reshape(B), c2, a2, b2)
    t = lwe_concat([t1, t2], axis=0)
    out = bs.bootstrap(t, jnp.int32(MU), cloud)
    return out[:B].reshape(shape), out[B:].reshape(shape)


# Flat-batch size above which a gate call is split into repeated dispatches of
# the same compiled chunk program, so every traced program has a bounded
# size (the reference's memory-driven batching, bootsLimit,
# boot-gates.cu:2869-2907). Kept from the first design; not measured on the
# H100.
GATE_CHUNK = 256


def _flat_batch(ct: LweCiphertext) -> int:
    B = 1
    for s in ct.batch_shape:
        B *= s
    return B


def _bucket(B: int) -> int:
    """Round a flat batch up to the next power of two.

    Keeps the number of DISTINCT compiled gate programs logarithmic in
    workload size: without it, tree-reduction circuits (multiplier/matmul
    accumulation) emit a different remainder batch at every level and every
    matrix size, and each one compiles anew. Padded rows are trivial zeros;
    cost is bounded by 2x on the padded tail chunk only."""
    return 1 << max(B - 1, 0).bit_length()


def _pad_flat(ct: LweCiphertext, Bp: int) -> LweCiphertext:
    """Pad a flat-batched ciphertext with trivial zeros up to batch Bp."""
    B = ct.batch_shape[0]
    if Bp == B:
        return ct
    return lwe_concat([ct, noiseless_trivial(jnp.int32(0), ct.n, (Bp - B,))], axis=0)


def gate2(name: str, x: LweCiphertext, y: LweCiphertext, cloud,
          mu: int = MU) -> LweCiphertext:
    """Generic bootstrapped 2-input gate; batch shapes must match.

    mu: output message amplitude (MU for standard ±1/8 bits; MU16 for
    compressor-internal ±1/16 bits — see the septet section below)."""
    const, ca, cb = GATE_TABLE[name]
    B = _flat_batch(x)
    if B > GATE_CHUNK:
        shape = x.batch_shape
        xf, yf = x.reshape(B), y.reshape(B)
        outs = [gate2(name, xf[s:min(s + GATE_CHUNK, B)],
                      yf[s:min(s + GATE_CHUNK, B)], cloud, mu)
                for s in range(0, B, GATE_CHUNK)]
        return lwe_concat(outs, axis=0).reshape(shape)
    Bp = _bucket(B)
    if Bp != B:
        shape = x.batch_shape
        out = _gate2_jit(_pad_flat(x.reshape(B), Bp), _pad_flat(y.reshape(B), Bp),
                         jnp.int32(const), jnp.int32(ca), jnp.int32(cb),
                         jnp.int32(mu), cloud)
        return out[:B].reshape(shape)
    return _gate2_jit(x, y, jnp.int32(const), jnp.int32(ca), jnp.int32(cb),
                      jnp.int32(mu), cloud)


def gate2_pair(name1: str, name2: str, x1, y1, x2, y2, cloud):
    """Compound gate: two gates, ONE batched bootstrap (paper section V-A3).

    Returns (out1, out2). The reference's bootsANDXOR_16 is
    gate2_pair('AND','XOR', a,b, a,b).
    """
    c1, a1, b1 = GATE_TABLE[name1]
    c2, a2, b2 = GATE_TABLE[name2]
    B = _flat_batch(x1)
    if 2 * B > GATE_CHUNK:
        half = GATE_CHUNK // 2
        shape = x1.batch_shape
        flats = [v.reshape(B) for v in (x1, y1, x2, y2)]
        outs1, outs2 = [], []
        for s in range(0, B, half):
            e = min(s + half, B)
            o1, o2 = gate2_pair(name1, name2, flats[0][s:e], flats[1][s:e],
                                flats[2][s:e], flats[3][s:e], cloud)
            outs1.append(o1)
            outs2.append(o2)
        return (lwe_concat(outs1, axis=0).reshape(shape),
                lwe_concat(outs2, axis=0).reshape(shape))
    Bp = _bucket(B)
    if Bp != B:
        shape = x1.batch_shape
        o1, o2 = _gate2_pair_jit(
            _pad_flat(x1.reshape(B), Bp), _pad_flat(y1.reshape(B), Bp),
            _pad_flat(x2.reshape(B), Bp), _pad_flat(y2.reshape(B), Bp),
            jnp.int32(c1), jnp.int32(a1), jnp.int32(b1),
            jnp.int32(c2), jnp.int32(a2), jnp.int32(b2), cloud)
        return o1[:B].reshape(shape), o2[:B].reshape(shape)
    return _gate2_pair_jit(x1, y1, x2, y2,
                           jnp.int32(c1), jnp.int32(a1), jnp.int32(b1),
                           jnp.int32(c2), jnp.int32(a2), jnp.int32(b2), cloud)


# ---- the classic named gates --------------------------------------------

def AND(x, y, cloud):   return gate2("AND", x, y, cloud)
def OR(x, y, cloud):    return gate2("OR", x, y, cloud)
def NAND(x, y, cloud):  return gate2("NAND", x, y, cloud)
def NOR(x, y, cloud):   return gate2("NOR", x, y, cloud)
def XOR(x, y, cloud):   return gate2("XOR", x, y, cloud)
def XNOR(x, y, cloud):  return gate2("XNOR", x, y, cloud)
def ANDNY(x, y, cloud): return gate2("ANDNY", x, y, cloud)
def ANDYN(x, y, cloud): return gate2("ANDYN", x, y, cloud)
def ORNY(x, y, cloud):  return gate2("ORNY", x, y, cloud)
def ORYN(x, y, cloud):  return gate2("ORYN", x, y, cloud)


def NOT(x: LweCiphertext, cloud=None) -> LweCiphertext:
    """Negation, no bootstrap (ref boot-gates.cu:244-249)."""
    return lwe_negate(x)


def COPY(x: LweCiphertext, cloud=None) -> LweCiphertext:
    return LweCiphertext(x.a, x.b, x.cv)


def CONSTANT(value, n: int, batch_shape=()) -> LweCiphertext:
    """Trivial ciphertext of a boolean constant (ref boot-gates.cu:265-270)."""
    value = jnp.asarray(value, jnp.int32)
    mu = jnp.where(value != 0, jnp.int32(_1_8), jnp.int32(-_1_8))
    return noiseless_trivial(mu, n, batch_shape)


# ---- 3-input bootstrapped gates (extension) ------------------------------
#
# The torus encoding (bits at ±1/8, boot-gates.cu:100) admits 3-input gates
# in ONE bootstrap: for three bit samples the affine a+b+c has phase
# (2k-3)/8 for k ones, so its sign is the MAJORITY (= the full-adder carry),
# and 2*(a+b+c) has phase (2k-3)/4 whose sign is the negated 3-way parity
# (= the full-adder sum, up to a free negation). This is the same move the
# reference's own gates already make (XOR rides coefficient 2 with a 1/4
# margin, boot-gates.cu:198), extended to three inputs: a full adder costs 2
# bootstraps instead of the reference's 5 gates (paper section V-A3), and a
# comparator stage costs 1 (cin' = MUX(a^b, a, cin) == MAJ(a, not b, cin)).
# Noise: the affine sums three bootstrapped samples instead of two — margin
# distances are unchanged (1/8 for MAJ like AND, 1/4 for the parity like
# XOR), amplitudes grow by sqrt(3/2); validated by tools/noise_stats.py and
# the CI noise-regression test.

@jax.jit
def _affine3(x, y, z, const, ca, cb, cc) -> LweCiphertext:
    const = jnp.asarray(const, jnp.int32)
    ca = jnp.asarray(ca, jnp.int32)
    cb = jnp.asarray(cb, jnp.int32)
    cc = jnp.asarray(cc, jnp.int32)
    a = ca[..., None] * x.a + cb[..., None] * y.a + cc[..., None] * z.a
    b = const + ca * x.b + cb * y.b + cc * z.b
    cv = (ca.astype(jnp.float32) ** 2 * x.cv + cb.astype(jnp.float32) ** 2 * y.cv
          + cc.astype(jnp.float32) ** 2 * z.cv)
    return LweCiphertext(a, b, cv)


@jax.jit
def _maj3_jit(x, y, z, cloud):
    shape = x.batch_shape
    B = 1
    for s in shape:
        B *= s
    t = _affine3(x.reshape(B), y.reshape(B), z.reshape(B),
                 jnp.int32(0), jnp.int32(1), jnp.int32(1), jnp.int32(1))
    return bs.bootstrap(t, jnp.int32(MU), cloud).reshape(shape)


def MAJ(x: LweCiphertext, y: LweCiphertext, z: LweCiphertext, cloud) -> LweCiphertext:
    """Majority of three bits in ONE bootstrap: sign(a+b+c)."""
    B = _flat_batch(x)
    if B > GATE_CHUNK:
        shape = x.batch_shape
        xf, yf, zf = x.reshape(B), y.reshape(B), z.reshape(B)
        outs = [MAJ(xf[s:min(s + GATE_CHUNK, B)], yf[s:min(s + GATE_CHUNK, B)],
                    zf[s:min(s + GATE_CHUNK, B)], cloud)
                for s in range(0, B, GATE_CHUNK)]
        return lwe_concat(outs, axis=0).reshape(shape)
    Bp = _bucket(B)
    if Bp != B:
        shape = x.batch_shape
        out = _maj3_jit(_pad_flat(x.reshape(B), Bp), _pad_flat(y.reshape(B), Bp),
                        _pad_flat(z.reshape(B), Bp), cloud)
        return out[:B].reshape(shape)
    return _maj3_jit(x, y, z, cloud)


@jax.jit
def _xor3_jit(x, y, z, cloud):
    shape = x.batch_shape
    B = 1
    for s in shape:
        B *= s
    t = _affine3(x.reshape(B), y.reshape(B), z.reshape(B),
                 jnp.int32(0), jnp.int32(2), jnp.int32(2), jnp.int32(2))
    return lwe_negate(bs.bootstrap(t, jnp.int32(MU), cloud)).reshape(shape)


def XOR3(x: LweCiphertext, y: LweCiphertext, z: LweCiphertext, cloud) -> LweCiphertext:
    """3-way parity in ONE bootstrap: not(sign(2*(a+b+c)))."""
    B = _flat_batch(x)
    if B > GATE_CHUNK:
        shape = x.batch_shape
        xf, yf, zf = x.reshape(B), y.reshape(B), z.reshape(B)
        outs = [XOR3(xf[s:min(s + GATE_CHUNK, B)], yf[s:min(s + GATE_CHUNK, B)],
                     zf[s:min(s + GATE_CHUNK, B)], cloud)
                for s in range(0, B, GATE_CHUNK)]
        return lwe_concat(outs, axis=0).reshape(shape)
    Bp = _bucket(B)
    if Bp != B:
        shape = x.batch_shape
        out = _xor3_jit(_pad_flat(x.reshape(B), Bp), _pad_flat(y.reshape(B), Bp),
                        _pad_flat(z.reshape(B), Bp), cloud)
        return out[:B].reshape(shape)
    return _xor3_jit(x, y, z, cloud)


@jax.jit
def _fa3_jit(a: LweCiphertext, b: LweCiphertext, c: LweCiphertext, cloud):
    """Full adder as ONE program / ONE bootstrap batch (2 rows per bit):
    rows [0,B) the carry image a+b+c, rows [B,2B) the sum image 2*(a+b+c);
    one combined key switch; the sum half is negated afterwards (free)."""
    shape = a.batch_shape
    B = 1
    for s in shape:
        B *= s
    af, bf, cf = a.reshape(B), b.reshape(B), c.reshape(B)
    u_c = _affine3(af, bf, cf, jnp.int32(0), jnp.int32(1), jnp.int32(1), jnp.int32(1))
    u_s = _affine3(af, bf, cf, jnp.int32(0), jnp.int32(2), jnp.int32(2), jnp.int32(2))
    t = lwe_concat([u_c, u_s], axis=0)
    t = _pad_flat(t, _bucket(2 * B))
    out = bs.bootstrap(t, jnp.int32(MU), cloud)
    carry = out[:B].reshape(shape)
    ssum = lwe_negate(out[B:2 * B]).reshape(shape)
    return ssum, carry


def full_adder(a: LweCiphertext, b: LweCiphertext, cin: LweCiphertext, cloud):
    """(sum, carry) of a+b+cin in 2 bootstraps riding ONE batched kernel +
    one key switch — vs 5 gates in the reference's bitwise adder
    (taskLevelParallelAdd_bitwise, main.cu:821-890) and 4 bootstraps for the
    XOR/XOR/MUX form. The workhorse of every adder-heavy circuit."""
    B = _flat_batch(a)
    if 2 * B > GATE_CHUNK:
        half = GATE_CHUNK // 2
        shape = a.batch_shape
        af, bf, cf = a.reshape(B), b.reshape(B), cin.reshape(B)
        sums, carries = [], []
        for s in range(0, B, half):
            e = min(s + half, B)
            si, ci = full_adder(af[s:e], bf[s:e], cf[s:e], cloud)
            sums.append(si)
            carries.append(ci)
        return (lwe_concat(sums, axis=0).reshape(shape),
                lwe_concat(carries, axis=0).reshape(shape))
    return _fa3_jit(a, b, cin, cloud)


def MUX(a: LweCiphertext, b: LweCiphertext, c: LweCiphertext, cloud) -> LweCiphertext:
    """a ? b : c with two bootstraps batched as ONE kernel + one key switch
    (ref bootsMUX, boot-gates.cu:403-448; fused GPU variant :2631-2843)."""
    B = _flat_batch(a)
    if 2 * B > GATE_CHUNK:
        half = GATE_CHUNK // 2
        shape = a.batch_shape
        af, bf, cf = a.reshape(B), b.reshape(B), c.reshape(B)
        outs = [MUX(af[s:min(s + half, B)], bf[s:min(s + half, B)],
                    cf[s:min(s + half, B)], cloud)
                for s in range(0, B, half)]
        return lwe_concat(outs, axis=0).reshape(shape)
    Bp = _bucket(B)
    if Bp != B:
        shape = a.batch_shape
        out = _mux_jit(_pad_flat(a.reshape(B), Bp), _pad_flat(b.reshape(B), Bp),
                       _pad_flat(c.reshape(B), Bp), cloud)
        return out[:B].reshape(shape)
    return _mux_jit(a, b, c, cloud)


@jax.jit
def _mux_jit(a: LweCiphertext, b: LweCiphertext, c: LweCiphertext, cloud) -> LweCiphertext:
    shape = a.batch_shape
    B = 1
    for s in shape:
        B *= s
    af, bf, cf = a.reshape(B), b.reshape(B), c.reshape(B)
    # AND(a, b) image and AND(not a, c) image
    t1 = _affine2(af, bf, jnp.int32(-_1_8), jnp.int32(1), jnp.int32(1))
    t2 = _affine2(af, cf, jnp.int32(-_1_8), jnp.int32(-1), jnp.int32(1))
    t = lwe_concat([t1, t2], axis=0)
    a_ext, b_ext, cv = bs.bootstrap_woks(t, jnp.int32(MU), cloud)
    # temp = (0, 1/8) + u1 + u2 over the extracted params, then one key switch
    a_sum = a_ext[:B] + a_ext[B:]
    b_sum = jnp.int32(_1_8) + b_ext[:B] + b_ext[B:]
    cv_sum = cv[:B] + cv[B:]
    out = bs.key_switch(a_sum, b_sum, cloud.ks_table, cv_sum, cloud.params)
    return out.reshape(shape)


# ---- 7:3 column compressors at ±1/16 (extension) -------------------------
#
# The 3-input trick above generalizes: at amplitude ±1/16 (MU16) the affine
# sum of SEVEN bit samples has phase (2k-7)/16 for k ones — eight distinct,
# non-aliasing levels — and the three binary digits of the popcount k fall
# out of the SAME sum under the coefficient ladder the reference's own XOR
# already rides (boot-gates.cu:198):
#
#     sign(1*u) = bit2 (k>=4),  sign(2*u) = NOT bit1,  sign(4*u) = NOT bit0
#
# (the x2/x4 images alias the torus exactly onto the lower digit classes).
# So a 7:3 compressor costs THREE bootstraps to remove FOUR bits from a
# carry-save column — 0.75 bootstraps/bit vs the full adder's 2.0 — and the
# NOTs are free (per-row output amplitude -MU16 in the shared batch).
# Margins: every image has effective margin/amplitude 1/16 (vs 1/8 for the
# standard gates) with a sqrt(7) affine amplification; at the 110-bit
# parameter set that is z ~ 6 sigma per image (validated empirically by
# tools/noise_stats.py --septet), beating the 2^-25 failure budget of
# standard TFHE gates. Used by arith._wallace_sum_bits for all carry-save
# reductions (multipliers, dot products, vector sums).

def trivial16_zero(n: int, batch_shape=()) -> LweCiphertext:
    """Trivial '0' at amplitude 1/16 (phase -1/16) — the compressor's
    padding slot."""
    return noiseless_trivial(jnp.int32(-MU16), n, batch_shape)


@jax.jit
def _bs_images_jit(t: LweCiphertext, mu, cloud) -> LweCiphertext:
    """One dispatch: bootstrap a flat image batch with per-row output
    amplitudes (negative mu folds a NOT into the test vector for free)."""
    return bs.bootstrap(t, mu, cloud)


def bootstrap_images(t: LweCiphertext, mu, cloud) -> LweCiphertext:
    """Chunked bootstrap of a flat batch of pre-built gate images.

    t: flat [M] affine images; mu: int32 [M] per-image output amplitude.
    The compressor levels of arith._wallace_sum_bits funnel ALL their
    heterogeneous images (septet digit extractions, full-adder pairs,
    recodes) through this single entry point as one batch."""
    B = t.batch_shape[0]
    mu = np.asarray(mu, np.int32)
    outs = []
    for s in range(0, B, GATE_CHUNK):
        e = min(s + GATE_CHUNK, B)
        chunk, muc = t[s:e], mu[s:e]
        Bp = _bucket(e - s)
        if Bp != e - s:
            chunk = _pad_flat(chunk, Bp)
            muc = np.concatenate([muc, np.full(Bp - (e - s), MU, np.int32)])
        outs.append(_bs_images_jit(chunk, jnp.asarray(muc), cloud)[:e - s])
    return lwe_concat(outs, axis=0) if len(outs) > 1 else outs[0]


@jax.jit
def _fa16_jit(a: LweCiphertext, b: LweCiphertext, c: LweCiphertext,
              mu_sum, mu_carry, cloud):
    """Full adder on ±1/16 bits as ONE program / ONE bootstrap batch:
    carry = sign(u), sum = NOT sign(4u) (coeff 4 — at 1/16 the parity rides
    two doublings); the NOT is folded by emitting amplitude -mu_sum."""
    shape = a.batch_shape
    B = 1
    for s in shape:
        B *= s
    af, bf, cf = a.reshape(B), b.reshape(B), c.reshape(B)
    u_c = _affine3(af, bf, cf, jnp.int32(0), jnp.int32(1), jnp.int32(1), jnp.int32(1))
    u_s = _affine3(af, bf, cf, jnp.int32(0), jnp.int32(4), jnp.int32(4), jnp.int32(4))
    t = lwe_concat([u_c, u_s], axis=0)
    mu = jnp.concatenate([jnp.broadcast_to(mu_carry, (B,)),
                          jnp.broadcast_to(-mu_sum, (B,))]).astype(jnp.int32)
    Bp = _bucket(2 * B)
    t = _pad_flat(t, Bp)
    mu = jnp.concatenate([mu, jnp.full((Bp - 2 * B,), MU, jnp.int32)])
    out = bs.bootstrap(t, mu, cloud)
    return out[B:2 * B].reshape(shape), out[:B].reshape(shape)


def full_adder16(a: LweCiphertext, b: LweCiphertext, cin: LweCiphertext,
                 cloud, mu_sum: int = MU16, mu_carry: int = MU16):
    """(sum, carry) of three ±1/16 bits; output amplitudes selectable so the
    final ripple of a carry-save reduction re-encodes its result bits to the
    standard ±1/8 (mu_sum=MU) at zero extra cost."""
    B = _flat_batch(a)
    if 2 * B > GATE_CHUNK:
        half = GATE_CHUNK // 2
        shape = a.batch_shape
        af, bf, cf = a.reshape(B), b.reshape(B), cin.reshape(B)
        sums, carries = [], []
        for s in range(0, B, half):
            e = min(s + half, B)
            si, ci = full_adder16(af[s:e], bf[s:e], cf[s:e], cloud,
                                  mu_sum, mu_carry)
            sums.append(si)
            carries.append(ci)
        return (lwe_concat(sums, axis=0).reshape(shape),
                lwe_concat(carries, axis=0).reshape(shape))
    return _fa16_jit(a, b, cin, jnp.int32(mu_sum), jnp.int32(mu_carry), cloud)


# ---- fused parallel-prefix combine level ---------------------------------

@jax.jit
def _prefix_level_jit(gi, gs, pi, ps, cloud):
    """One parallel-prefix (g, p) combine level as ONE program:
    g' = g_hi OR (p_hi AND g_lo) = MUX(p_hi, g_lo, g_hi), p' = p_hi AND p_lo.
    All three bootstrap images (two MUX halves + the p AND) ride one batch;
    the MUX halves are post-summed and everything key-switches together."""
    shape = gi.batch_shape
    B = 1
    for s in shape:
        B *= s
    gif, gsf, pif, psf = (v.reshape(B) for v in (gi, gs, pi, ps))
    t1 = _affine2(pif, gsf, jnp.int32(-_1_8), jnp.int32(1), jnp.int32(1))   # AND(p_hi, g_lo)
    t2 = _affine2(pif, gif, jnp.int32(-_1_8), jnp.int32(-1), jnp.int32(1))  # AND(not p_hi, g_hi)
    t3 = _affine2(pif, psf, jnp.int32(-_1_8), jnp.int32(1), jnp.int32(1))   # AND(p_hi, p_lo)
    t = _pad_flat(lwe_concat([t1, t2, t3], axis=0), _bucket(3 * B))
    a_ext, b_ext, cv = bs.bootstrap_woks(t, jnp.int32(MU), cloud)
    a_sum = a_ext[:B] + a_ext[B:2 * B]
    b_sum = jnp.int32(_1_8) + b_ext[:B] + b_ext[B:2 * B]
    cv_sum = cv[:B] + cv[B:2 * B]
    a_all = jnp.concatenate([a_sum, a_ext[2 * B:3 * B]], axis=0)
    b_all = jnp.concatenate([b_sum, b_ext[2 * B:3 * B]], axis=0)
    cv_all = jnp.concatenate([cv_sum, cv[2 * B:3 * B]], axis=0)
    out = bs.key_switch(a_all, b_all, cloud.ks_table, cv_all, cloud.params)
    return out[:B].reshape(shape), out[B:].reshape(shape)


def prefix_combine(g_hi, g_lo, p_hi, p_lo, cloud):
    """(g, p) o (g', p') — the carry-operator combine of parallel-prefix
    adders/comparators, one dispatch for batches within a chunk.

    Inputs are padded to a power-of-two flat batch BEFORE the jit so the
    per-level slice widths (nbits-d for d = 1, 2, 4, ...) collapse onto a
    logarithmic number of compiled programs (every distinct shape compiles
    anew)."""
    B = _flat_batch(g_hi)
    if 3 * B > GATE_CHUNK:
        # throughput regime: keep the fused 3-images-one-KS structure by
        # chunking the batch (a MUX+AND fallback would triple the KS cost)
        third = GATE_CHUNK // 3
        shape = g_hi.batch_shape
        flats = [v.reshape(B) for v in (g_hi, g_lo, p_hi, p_lo)]
        gs, ps = [], []
        for s in range(0, B, third):
            e = min(s + third, B)
            gi, pi = prefix_combine(flats[0][s:e], flats[1][s:e],
                                    flats[2][s:e], flats[3][s:e], cloud)
            gs.append(gi)
            ps.append(pi)
        return (lwe_concat(gs, axis=0).reshape(shape),
                lwe_concat(ps, axis=0).reshape(shape))
    Bp = _bucket(B)
    if Bp != B:
        shape = g_hi.batch_shape
        go, po = _prefix_level_jit(
            _pad_flat(g_hi.reshape(B), Bp), _pad_flat(g_lo.reshape(B), Bp),
            _pad_flat(p_hi.reshape(B), Bp), _pad_flat(p_lo.reshape(B), Bp),
            cloud)
        return go[:B].reshape(shape), po[:B].reshape(shape)
    return _prefix_level_jit(g_hi, g_lo, p_hi, p_lo, cloud)
