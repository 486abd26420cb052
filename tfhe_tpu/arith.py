"""Encrypted integer arithmetic circuits (batched, LSB-first, two's complement).

Ports every circuit of the reference's arithmetic layer to batched bootstrapped gates:
- bitwise ripple adder        <- taskLevelParallelAdd_bitwise (main.cu:821-890)
- number-wise carry-save add  <- taskLevelParallelAdd (main.cu:619-652)
- two's complement            <- twosComplement (cpuParallel/Cipher.cpp:300-311)
- subtraction                 <- operator- (Cipher.cpp:342-345)
- shift-and-add multiplier    <- multiplyLweSamples (main.cu:1483-1579), with
                                 the triangle AND matrix in ONE bootstrap batch
                                 and a Wallace carry-save reduction in place of
                                 the log-tree (paper section V-B2)
- comparison (>, <=, ==)      <- Cipher.cpp:597-644
- minimum / compare_bit       <- Cipher.cpp:313-340
- absolute                    <- Cipher.cpp:483-505
- division (restoring)        <- divInternal / operator/ (Cipher.cpp:508-558)
- addSign (cond. negate)      <- Cipher.cpp:560-577
- shifts                      <- leftShift/innerRightShift etc.

An n-bit integer is an LweCiphertext batch with trailing axis nbits (bit i =
2^i). All circuits accept arbitrary leading batch shapes, so "vector ops" are
the same circuits on a bigger batch (the reference's `_vector` variants).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import gates
from .core.lwe import LweCiphertext, lwe_concat, lwe_stack, lwe_take
from .core.crypt import lwe_encrypt, lwe_phase
from .numeric import mod_switch_to_torus32
from .params import TfheParams

_1_8 = gates._1_8


# --------------------------------------------------------------- encode / io

def encrypt_int(sk, value, nbits: int, seed: int = 0) -> LweCiphertext:
    """Encrypt integers as nbits LSB-first encrypted bits
    (ref convertNumberToBits, main.cu:524-548). value: int or int array."""
    value = np.asarray(value, np.int64)
    bits = (value[..., None] >> np.arange(nbits)) & 1
    from .core.crypt import encrypt_bits
    return encrypt_bits(sk, bits.astype(np.int32), seed=seed)


def decrypt_int(sk, ct: LweCiphertext, signed: bool = True) -> np.ndarray:
    """Decrypt an integer ciphertext (ref decryptCheck, main.cu:2203-2222)."""
    from .core.crypt import decrypt_bits
    bits = decrypt_bits(sk, ct).astype(np.int64)
    nbits = bits.shape[-1]
    val = np.sum(bits * (1 << np.arange(nbits)), axis=-1)
    if signed:
        val = val - (bits[..., -1] << nbits)
    return val


def trivial_bits(bits, n: int, batch_shape=None) -> LweCiphertext:
    """Noiseless trivial encryption of constant bits (default: keep shape)."""
    bits = jnp.asarray(bits, jnp.int32)
    if batch_shape is None:
        batch_shape = bits.shape
    bits = jnp.broadcast_to(bits, batch_shape)
    return gates.CONSTANT(bits, n, bits.shape)


def zero_like_bits(x: LweCiphertext, batch_shape) -> LweCiphertext:
    return gates.CONSTANT(jnp.zeros(batch_shape, jnp.int32), x.n, batch_shape)


# ------------------------------------------------------- whole-circuit jit

import functools

import jax

_CIRCUIT_JITS: dict = {}


def circuit(fn=None, *, static_argnums=()):
    """Whole-circuit jit: the ENTIRE decorated circuit — every gate batch,
    kernel launch and inter-stage affine — becomes ONE XLA program.

    Eager serial circuits pay a Python dispatch and a host re-entry per
    gate stage. Inside one program the kernels run back to back on the
    device with no host round-trips (the H100 A/B is in PERF.md).

    The jit cache is keyed by (function, config.policy_fingerprint()) so a
    routing-flag flip (the A/B benches mutate flags between calls) retraces
    instead of reusing the stale route; jax.jit adds the shape/dtype keying.
    Off by default on CPU backends (config.circuit_jit_enabled): the test
    suite's per-shape compile would dwarf its eager run. Calls with kwargs
    fall back to the eager path (internal call sites are positional)."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            from .config import circuit_jit_enabled, policy_fingerprint
            if kwargs or not circuit_jit_enabled():
                return f(*args, **kwargs)
            key = (f, policy_fingerprint())
            j = _CIRCUIT_JITS.get(key)
            if j is None:
                j = jax.jit(f, static_argnums=static_argnums)
                _CIRCUIT_JITS[key] = j
            return j(*args)
        wrapper.__wrapped__ = f
        return wrapper

    return deco(fn) if fn is not None else deco


# --------------------------------------------------------------- adders

def _latency_policy(numbers: int, nbits: int) -> bool:
    """Prefix-vs-ripple adder dispatch; policy + measured A/B live in
    config.lookahead_enabled. `numbers` = independent integers in the batch."""
    from .config import lookahead_enabled
    return lookahead_enabled(numbers, nbits)


def _latency_bound(a: LweCiphertext) -> bool:
    nbits = a.batch_shape[-1]
    return _latency_policy(gates._flat_batch(a) // max(nbits, 1), nbits)


@circuit
def add(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Bitwise ripple-carry adder, the reference's fastest (GPU_1)
    (taskLevelParallelAdd_bitwise, main.cu:821-890), rebuilt on the 2-bootstrap
    full adder (gates.full_adder): per bit, ONE batched bootstrap kernel (sum
    + carry images) and one key switch — vs the reference's 5 gates / 3
    sequential bootstraps per bit. Result has the same nbits (overflow
    dropped, matching the reference). Latency-bound small batches take the
    Kogge-Stone prefix adder instead (add_fast)."""
    if _latency_bound(a):
        return add_fast(a, b, cloud)
    nbits = a.batch_shape[-1]
    # bit 0: sum = XOR, carry = AND, one compound bootstrap
    c0, s0 = gates.gate2_pair("AND", "XOR", a[..., 0], b[..., 0], a[..., 0], b[..., 0], cloud)
    sums = [s0]
    carry = c0
    for i in range(1, nbits):
        si, carry = gates.full_adder(a[..., i], b[..., i], carry, cloud)
        sums.append(si)
    return lwe_stack(sums, axis=-1)


@circuit
def add_fast(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Kogge-Stone parallel-prefix adder: log2(nbits)+2 batched stages
    instead of nbits dependent full-adder stages.

    Stage 0 computes (g, p) = (AND, XOR) in one compound bootstrap; each
    prefix level combines (g,p)[i] with (g,p)[i-d] for all i >= d in ONE
    fused program (gates.prefix_combine: both MUX halves and the p-AND share
    a bootstrap batch and a key switch); the final sums are one XOR batch.
    The reference has no sub-linear adder (its GPU_1 ripple is
    main.cu:821-890) — this is where batching a whole level into one
    dispatch beats per-gate launch latency."""
    g, p = gates.gate2_pair("AND", "XOR", a, b, a, b, cloud)
    c = _prefix_carry_chain(g, p, cloud)
    # c_i is the carry OUT of bit i: sum_0 = p_0, sum_i = p_i ^ c_{i-1}
    s_rest = gates.XOR(p[..., 1:], c[..., :-1], cloud)
    return lwe_concat([p[..., :1], s_rest], axis=-1)


def _prefix_carry_chain(g: LweCiphertext, p: LweCiphertext, cloud) -> LweCiphertext:
    """Kogge-Stone all-prefix carries: returns c with c_i = carry out of
    bit i given per-bit (generate, propagate). log2(nbits) fused levels."""
    nbits = g.batch_shape[-1]
    d = 1
    while d < nbits:
        g_new, p_new = gates.prefix_combine(
            g[..., d:], g[..., :-d], p[..., d:], p[..., :-d], cloud)
        g = lwe_concat([g[..., :d], g_new], axis=-1)
        p = lwe_concat([p[..., :d], p_new], axis=-1)
        d *= 2
    return g


def _cmp_carry_tree(g: LweCiphertext, p: LweCiphertext, cloud) -> LweCiphertext:
    """Final carry only (for comparisons): pairwise (g,p) combine tree,
    log2(nbits) levels of nbits/2^k fused combines."""
    while g.batch_shape[-1] > 1:
        R = g.batch_shape[-1]
        half = R // 2
        g2, p2 = gates.prefix_combine(
            g[..., 1:2 * half:2], g[..., 0:2 * half:2],
            p[..., 1:2 * half:2], p[..., 0:2 * half:2], cloud)
        if R % 2:
            g = lwe_concat([g2, g[..., 2 * half:]], axis=-1)
            p = lwe_concat([p2, p[..., 2 * half:]], axis=-1)
        else:
            g, p = g2, p2
    return g[..., 0]


def _or_scan_excl(x: LweCiphertext, cloud) -> LweCiphertext:
    """Exclusive running OR along the bit axis (Kogge-Stone inclusive scan
    shifted by one): r_i = x_0 | ... | x_{i-1}. log2(nbits) OR batches."""
    r = x
    nbits = x.batch_shape[-1]
    d = 1
    while d < nbits:
        r_new = gates.OR(r[..., d:], r[..., :-d], cloud)
        r = lwe_concat([r[..., :d], r_new], axis=-1)
        d *= 2
    zero = zero_like_bits(x, x.batch_shape[:-1] + (1,))
    return lwe_concat([zero, r[..., :-1]], axis=-1)


@jax.jit
def _gpun_stage_jit(result, tempb, cloud):
    """One carry-save iteration (compound ANDXOR + carry shift) as one program."""
    and_out, xor_out = gates.gate2_pair("AND", "XOR", result, tempb, result, tempb, cloud)
    # tempb = and_out << 1 with encrypted FALSE at bit 0 (main.cu:656-700)
    zero = gates.CONSTANT(jnp.zeros(result.batch_shape[:-1] + (1,), jnp.int32),
                          result.a.shape[-1], result.batch_shape[:-1] + (1,))
    return xor_out, lwe_concat([zero, and_out[..., :-1]], axis=-1)


@circuit
def add_numberwise(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Number-wise carry-save adder (GPU_n, taskLevelParallelAdd main.cu:619-652):
    nbits iterations of one compound ANDXOR bootstrap over all bits, each
    iteration fused into one program (when it fits one gate chunk)."""
    nbits = a.batch_shape[-1]
    flat = 1
    for s in a.batch_shape:
        flat *= s
    fused = 2 * flat <= gates.GATE_CHUNK
    result = a
    tempb = b
    for _ in range(nbits):
        if fused:
            result, tempb = _gpun_stage_jit(result, tempb, cloud)
        else:
            and_out, xor_out = gates.gate2_pair("AND", "XOR", result, tempb, result, tempb, cloud)
            zero = zero_like_bits(a, a.batch_shape[:-1] + (1,))
            tempb = lwe_concat([zero, and_out[..., :-1]], axis=-1)
            result = xor_out
    return result


@circuit
def twos_complement(a: LweCiphertext, cloud) -> LweCiphertext:
    """-a (ref twosComplement, Cipher.cpp:300-311): scan with a reach-one
    signal, one compound (XOR, OR) bootstrap per bit; latency-bound batches
    use the log-depth prefix-OR scan instead."""
    nbits = a.batch_shape[-1]
    if _latency_bound(a):
        return gates.XOR(a, _or_scan_excl(a, cloud), cloud)
    reach = zero_like_bits(a, a.batch_shape[:-1])
    outs = []
    for i in range(nbits):
        out_i, reach = gates.gate2_pair("XOR", "OR", a[..., i], reach, reach, a[..., i], cloud)
        outs.append(out_i)
    return lwe_stack(outs, axis=-1)


@circuit
def sub(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """a - b (ref Cipher.cpp:342-345 computes a + twos_complement(b); here
    the identity a - b = a + not(b) + 1 folds the complement into the ripple
    chain's carry-in — the NOT is a free negation, halving the bootstrap
    count vs the reference's circuit while computing the same function.
    Latency-bound batches take the prefix form: (g, p) = (a&~b, a xnor b)
    with the carry-in folded into g_0 (a|~b), so a-b costs the same depth
    as a+b."""
    nbits = a.batch_shape[-1]
    if _latency_bound(a):
        g, p = gates.gate2_pair("ANDYN", "XNOR", a, b, a, b, cloud)
        g0 = gates.ORYN(a[..., :1], b[..., :1], cloud)     # carry-in = 1
        c = _prefix_carry_chain(lwe_concat([g0, g[..., 1:]], axis=-1), p, cloud)
        s0 = gates.NOT(p[..., :1])                         # p_0 ^ 1, free
        s_rest = gates.XOR(p[..., 1:], c[..., :-1], cloud)
        return lwe_concat([s0, s_rest], axis=-1)
    nb = gates.NOT(b)
    carry = gates.CONSTANT(jnp.ones(a.batch_shape[:-1], jnp.int32), a.n,
                           a.batch_shape[:-1])
    sums = []
    for i in range(nbits):
        si, carry = gates.full_adder(a[..., i], nb[..., i], carry, cloud)
        sums.append(si)
    return lwe_stack(sums, axis=-1)


def left_shift(a: LweCiphertext, k: int) -> LweCiphertext:
    """a << k with trivial FALSE fill (ref leftShift..., main.cu:1359-1481)."""
    if k == 0:
        return a
    zero = zero_like_bits(a, a.batch_shape[:-1] + (k,))
    return lwe_concat([zero, a[..., :-k]], axis=-1)


def right_shift_arith(a: LweCiphertext, k: int, cloud=None) -> LweCiphertext:
    """Arithmetic right shift, sign-extended (ref innerRightShift,
    Cipher.cpp:455-481).

    With `cloud` given, also applies the reference's negative-rounding
    correction (Cipher.cpp:470-480): add `sign ? 1 : 0` so negative operands
    shift like positives ("keeping the negative numbers like positive
    numbers"); the MUX also refreshes the replicated sign bit's noise.
    Without `cloud` the shift is the bootstrap-free sign extension only
    (floor semantics — the reference's first loop, Cipher.cpp:461-466).
    """
    if k == 0:
        return a
    nbits = a.batch_shape[-1]
    sign = a[..., nbits - 1:nbits]
    exts = lwe_concat([sign] * k, axis=-1)
    shifted = lwe_concat([a[..., k:], exts], axis=-1)
    if cloud is None:
        return shifted
    one = gates.CONSTANT(1, a.n, sign.batch_shape)
    zero = gates.CONSTANT(0, a.n, sign.batch_shape)
    lsb = gates.MUX(sign, one, zero, cloud)               # sign ? 1 : 0
    to_add = lwe_concat(
        [lsb, zero_like_bits(a, a.batch_shape[:-1] + (nbits - 1,))], axis=-1)
    return add(shifted, to_add, cloud)


# --------------------------------------------------------------- multiplier

@circuit
def mul(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Shift-and-add multiplication, nbits-bit truncated result
    (ref multiplyLweSamples, main.cu:1483-1579):

    1. the triangle partial-product ANDs in ONE bootstrap batch,
    2. Wallace carry-save reduction of the weighted product bits
       (`_wallace_sum_bits` — the batched form of the reference's
       log2-tree accumulation, paper Fig. 4),
    3. one final ripple add.
    """
    nbits = a.batch_shape[-1]
    # partial products, TRUNCATION-AWARE: bit j of a times bit i of b lands at
    # column i+j, so only the nbits*(nbits+1)/2 triangle pairs with i+j < nbits
    # are bootstrapped (136 vs 256 ANDs at 16 bits) — the reference computes
    # the full iBits^2 matrix (main.cu:1524-1526). The products feed the
    # Wallace compressor directly as (bit, column) pairs; no row scatter.
    ja, ib, cols = _mul_triangle(nbits)
    lhs = lwe_take(a, ja, axis=-1)                                  # [..., P]
    rhs = lwe_take(b, ib, axis=-1)                                  # [..., P]
    sep = _septet_enabled(nbits, cloud.params)
    pp = gates.gate2("AND", lhs, rhs, cloud,
                     mu=gates.MU16 if sep else gates.MU)            # [..., P]
    return _wallace_sum_bits(pp, cols, nbits, cloud,
                             amp=np.full(len(cols), 16 if sep else 8))


def _mul_triangle(nbits: int):
    """Static (bit-of-a, bit-of-b, column) index plan for a truncated
    nbits x nbits product: only pairs with i + j < nbits contribute below the
    2^nbits cut (the reference computes the full iBits^2 matrix,
    main.cu:1524-1526)."""
    pairs = [(i, j) for i in range(nbits) for j in range(nbits - i)]
    return (np.array([j for (_, j) in pairs]),
            np.array([i for (i, _) in pairs]),
            np.array([i + j for (i, j) in pairs]))


@circuit
def dot(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Fused inner product along axis -2: sum_k a[..., k, :] * b[..., k, :]
    mod 2^nbits. All K products' triangle partial-product ANDs run as ONE
    bootstrap batch, and the union of weighted product bits feeds ONE Wallace
    compressor with ONE final carry-propagate adder — where mul-then-sum pays
    a full ripple adder per product (K extra carry chains per output element)
    before re-compressing the results. Same truncated semantics as the
    reference's per-element multiply + log-tree accumulation
    (BOOTS_matrixMultiplication, main.cu:2342-2462); the carry-save fusion
    across the contraction has no reference counterpart."""
    K, nbits = a.batch_shape[-2], a.batch_shape[-1]
    ja, ib, cols = _mul_triangle(nbits)
    lhs = lwe_take(a, ja, axis=-1)                     # [..., K, P]
    rhs = lwe_take(b, ib, axis=-1)
    sep = _septet_enabled(nbits, cloud.params)
    pp = gates.gate2("AND", lhs, rhs, cloud,
                     mu=gates.MU16 if sep else gates.MU)            # [..., K, P]
    lead = a.batch_shape[:-2]
    flat = pp.reshape(lead + (K * len(cols),))
    return _wallace_sum_bits(flat, np.tile(cols, K), nbits, cloud,
                             amp=np.full(K * len(cols), 16 if sep else 8))


def _dadda_targets(max_count: int):
    """Dadda's height sequence 2, 3, 4, 6, 9, 13, ... — each level only
    compresses down to the next target, which provably needs the minimum
    number of levels and avoids the carry-dribble tail of naive Wallace
    (columns re-opened by a single incoming carry)."""
    t = [2]
    while t[-1] < max_count:
        t.append((t[-1] * 3) // 2)
    return t


def _dadda_plan(cc: np.ndarray, nbits: int, target: int):
    """Static schedule of one Dadda level: per column (LSB first, tracking the
    carries the level itself sends upward), pick just enough full adders
    (reduce a column by 2) and at most one half adder (reduce by 1) to bring
    the post-level height to <= target. A half adder is a full adder whose
    third input is the trivial-zero slot (index -1)."""
    xi, yi, zi, keep = [], [], [], []
    carry_in = 0
    for c in range(nbits):
        idx = np.flatnonzero(cc == c)
        m = len(idx)
        r = max(0, m + carry_in - target)            # height excess to remove
        k_fa = min(r // 2, m // 3)
        k_ha = min(r - 2 * k_fa, (m - 3 * k_fa) // 2)
        p = 0
        for _ in range(k_fa):
            xi.append(idx[p]); yi.append(idx[p + 1]); zi.append(idx[p + 2])
            p += 3
        for _ in range(k_ha):
            xi.append(idx[p]); yi.append(idx[p + 1]); zi.append(-1)
            p += 2
        keep.extend(idx[p:])
        carry_in = k_fa + k_ha                       # new bits entering c+1
    return (np.array(xi, np.int64), np.array(yi, np.int64),
            np.array(zi, np.int64), np.array(keep, np.int64))


def _septet_enabled(nbits: int, params: TfheParams | None = None) -> bool:
    """7:3 compressor levels, width-aware; policy + measured A/B in
    config.septet_enabled.

    Noise-model demotion (beats even a forced TFHE_TPU_SEPTET=1): when the
    active noise-accounting model (config.noise_model) certifies fewer than
    5 live ±1/16 inputs per image at z >= 5 (phasesim.max_live16 — e.g. the
    worst-case-constant "tracked" model, where full septets sit at z = 4.1),
    the whole reduction is demoted to the ±1/8 full-adder domain (z >= 12.3).

    NOTE: _wallace_sum_bits overrides a forced-off whenever the input already
    holds ±1/16-encoded bits (has16) — the FA tree cannot consume MU16 bits,
    so the septet ENGINE runs there regardless; its level planner still caps
    group liveness at max_live16, so the certificate holds either way."""
    if params is not None:
        from .utils.phasesim import max_live16
        if max_live16(params) < 5:
            return False
    from .config import septet_enabled
    return septet_enabled(nbits)


def _wallace_sum_bits(cur: LweCiphertext, cc: np.ndarray, nbits: int,
                      cloud, amp: np.ndarray | None = None) -> LweCiphertext:
    """Carry-save reduction of weighted bits to one number (±1/8 outputs).

    cur: [..., M] encrypted bits; cc: static int[M] column of each bit;
    amp: static int[M] in {8, 16} — the amplitude class of each bit (±1/8
    standard gates, ±1/16 compressor-internal; None = all 8). Dispatches to
    the 7:3 septet compressor or the full-adder Dadda tree per the width +
    noise-model policy (_septet_enabled)."""
    # bits already in the ±1/16 compressor encoding force the septet ENGINE
    # (the FA tree only understands ±1/8) even under TFHE_TPU_SEPTET=0 or a
    # demoting noise model; the engine's level planner still caps group
    # liveness at phasesim.max_live16, so the z >= 5 certificate holds.
    has16 = amp is not None and (np.asarray(amp) == 16).any()
    if has16 or _septet_enabled(nbits, cloud.params):
        return _wallace_sum_bits_septet(cur, cc, nbits, cloud, amp)
    return _wallace_sum_bits_fa(cur, cc, nbits, cloud)


def _lwe_scale(ct: LweCiphertext, k: int) -> LweCiphertext:
    """Public integer scaling (torus wrap); variance scales by k^2."""
    return LweCiphertext(jnp.int32(k) * ct.a, jnp.int32(k) * ct.b,
                         jnp.float32(k * k) * ct.cv)


def _lwe_slot_sum(ct: LweCiphertext) -> LweCiphertext:
    """Sum ciphertexts over the LAST batch axis (the compressor slot axis)."""
    return LweCiphertext(ct.a.sum(axis=-2), ct.b.sum(axis=-1),
                         ct.cv.sum(axis=-1))


def _compress_level_plan(cc: np.ndarray, amp: np.ndarray, nbits: int,
                         max_live: int = 7):
    """Greedy static schedule of one septet-compressor level.

    Per column: bits at ±1/16 go 7 at a time into septets (>=5 justifies a
    trivial-padded group: 3 bootstraps remove >=2 bits), triples of the
    remainder into a ±1/16 full adder; bits at ±1/8 (fresh user inputs) go
    through ±1/8 full adders whose outputs are emitted at ±1/16, converting
    them into the compressor domain. A column that is stuck >2 high with a
    mix the rules can't group (e.g. two ±1/16 + two ±1/8) converts its ±1/8
    bits (half-adder for a pair, recode bootstrap for a single) so the next
    level can combine. Returns (sept [G,7], fa16 [G,3], fa8 [G,3], rec8 [R],
    keep [K]) index lists; -1 marks a trivial-zero pad slot.

    max_live caps the LIVE inputs of every ±1/16 group so each image's
    z-score under the active noise model stays >= 5 (phasesim.max_live16);
    when max_live < 5, septet grouping is non-viable (a padded group needs
    >= 5 live bits for its 3 bootstraps to pay) and ±1/16 bits reduce via
    3-way fa16 only (z = 6.2 even under the tracked model)."""
    assert max_live >= 3, (
        f"no safe ±1/16 grouping exists at max_live={max_live}; "
        "the active noise model cannot certify the compressor domain")
    sept, fa16, fa8, rec8, keep = [], [], [], [], []
    gsz = min(7, max_live)
    for c in range(nbits):
        i16 = list(np.flatnonzero((cc == c) & (amp == 16)))
        i8 = list(np.flatnonzero((cc == c) & (amp == 8)))
        grouped = False
        while max_live >= 5 and len(i16) >= 5:
            g, i16 = i16[:gsz], i16[gsz:]
            sept.append(g + [-1] * (7 - len(g)))
            grouped = True
        if len(i16) >= 3:
            fa16.append(i16[:3])
            i16 = i16[3:]
            grouped = True
        while len(i8) >= 3:
            fa8.append(i8[:3])
            i8 = i8[3:]
            grouped = True
        if not grouped and len(i16) + len(i8) > 2:
            if len(i8) >= 2:
                fa8.append(i8[:2] + [-1])
                i8 = i8[2:]
            elif len(i8) == 1:
                rec8.append(i8.pop())
        keep.extend(i16 + i8)
    return sept, fa16, fa8, rec8, keep


def _wallace_sum_bits_septet(cur: LweCiphertext, cc: np.ndarray, nbits: int,
                             cloud, amp: np.ndarray | None) -> LweCiphertext:
    """7:3 compressor reduction: every level gathers its septet digit images
    (coefficients 1/2/4 over one 7-way affine — see gates.py's septet
    section), full-adder pairs, and recodes into ONE flat bootstrap batch
    with per-image output amplitudes, so compression costs 0.75 bootstraps
    per removed bit instead of the full adder's 2. Carries above column
    nbits-1 never become images (mod-2^nbits truncation for free); a septet
    whose upper digits all fall off the top compresses 7 bits to 1 with a
    single parity bootstrap."""
    from .utils.phasesim import max_live16
    cap = max_live16(cloud.params)
    cc = np.asarray(cc)
    amp = (np.full(len(cc), 8) if amp is None else np.asarray(amp)).copy()
    while len(cc) and np.bincount(cc, minlength=nbits).max() > 2:
        sept, fa16, fa8, rec8, keep = _compress_level_plan(cc, amp, nbits, cap)
        M = len(cc)
        lead = cur.batch_shape[:-1]
        curz16 = lwe_concat(
            [cur, gates.trivial16_zero(cur.n, lead + (1,))], axis=-1)
        curz8 = lwe_concat(
            [cur, zero_like_bits(cur, lead + (1,))], axis=-1)
        parts, mus, ocols = [], [], []

        def emit(u, coeff, mu, cols, live):
            """Append scaled images for the live subset of a group batch."""
            lv = np.flatnonzero(live)
            if not lv.size:
                return
            sub = u if lv.size == u.batch_shape[-1] else lwe_take(u, lv, -1)
            parts.append(_lwe_scale(sub, coeff) if coeff != 1 else sub)
            mus.append(np.full(lv.size, mu, np.int32))
            ocols.append(np.asarray(cols)[lv])

        if sept:
            idx = np.asarray(sept)                     # [G, 7], -1 pads
            scols = cc[idx[:, 0]]
            u = _lwe_slot_sum(lwe_take(curz16, np.where(idx < 0, M, idx), -1))
            emit(u, 4, -gates.MU16, scols, scols < nbits)          # digit 0
            emit(u, 2, -gates.MU16, scols + 1, scols + 1 < nbits)  # digit 1
            emit(u, 1, +gates.MU16, scols + 2, scols + 2 < nbits)  # digit 2
        if fa16:
            idx = np.asarray(fa16)                     # [G, 3]
            fcols = cc[idx[:, 0]]
            u = _lwe_slot_sum(lwe_take(curz16, idx, -1))
            emit(u, 4, -gates.MU16, fcols, fcols < nbits)          # sum
            emit(u, 1, +gates.MU16, fcols + 1, fcols + 1 < nbits)  # carry
        if fa8:
            idx = np.asarray(fa8)                      # [G, 3], -1 pads
            fcols = cc[idx[:, 0]]
            u = _lwe_slot_sum(lwe_take(curz8, np.where(idx < 0, M, idx), -1))
            emit(u, 2, -gates.MU16, fcols, fcols < nbits)          # sum
            emit(u, 1, +gates.MU16, fcols + 1, fcols + 1 < nbits)  # carry
        if rec8:
            emit(lwe_take(cur, np.asarray(rec8), -1), 1, +gates.MU16,
                 cc[np.asarray(rec8)], np.ones(len(rec8), bool))
        assert parts, "compressor level planned no work"

        big = lwe_concat(parts, axis=-1)
        Mimg = big.batch_shape[-1]
        Bl = 1
        for s in lead:
            Bl *= s
        mu_img = np.concatenate(mus)
        out = gates.bootstrap_images(
            big.reshape((Bl * Mimg,)), np.tile(mu_img, Bl), cloud
        ).reshape(lead + (Mimg,))
        keep = np.asarray(keep, np.int64)
        if keep.size:
            cur = lwe_concat([out, lwe_take(cur, keep, -1)], axis=-1)
            cc = np.concatenate([np.concatenate(ocols), cc[keep]])
            amp = np.concatenate(
                [np.full(Mimg, 16), amp[keep]])
        else:
            cur, cc, amp = out, np.concatenate(ocols), np.full(Mimg, 16)

    if (amp == 8).all():
        # nothing entered the ±1/16 domain: assemble rows and use the
        # standard ±1/8 ripple (identical to the FA path's termination)
        return _assemble_two_rows_add(cur, cc, nbits, cloud)

    if (amp == 8).any():
        # stray ±1/8 leftovers in otherwise-converted columns: recode
        i8 = np.flatnonzero(amp == 8)
        lead = cur.batch_shape[:-1]
        Bl = 1
        for s in lead:
            Bl *= s
        rec = gates.bootstrap_images(
            lwe_take(cur, i8, -1).reshape((Bl * i8.size,)),
            np.full(Bl * i8.size, gates.MU16, np.int32), cloud
        ).reshape(lead + (i8.size,))
        keep = np.flatnonzero(amp == 16)
        cur = lwe_concat([rec, lwe_take(cur, keep, -1)], axis=-1)
        cc = np.concatenate([cc[i8], cc[keep]])

    # <=2 bits per column, all ±1/16: one final ripple; the sum images are
    # emitted at ±1/8 so the result is standard-encoded for free
    r0, r1 = _two_row_plan(cc, nbits)
    lead = cur.batch_shape[:-1]
    curz = lwe_concat([cur, gates.trivial16_zero(cur.n, lead + (1,))], axis=-1)
    row0 = lwe_take(curz, r0, axis=-1)
    row1 = lwe_take(curz, r1, axis=-1)
    Bl = 1
    for s in lead:
        Bl *= s
    if _latency_policy(Bl, nbits):
        # latency-bound: recode both rows to ±1/8 in ONE bootstrap batch and
        # use the log-depth prefix adder (depth 1+log2(nbits)+2 vs nbits)
        both = lwe_concat([row0, row1], axis=-1)
        rec = gates.bootstrap_images(
            both.reshape((Bl * 2 * nbits,)),
            np.full(Bl * 2 * nbits, gates.MU, np.int32), cloud
        ).reshape(lead + (2 * nbits,))
        return add_fast(rec[..., :nbits], rec[..., nbits:], cloud)
    sums = []
    carry = gates.trivial16_zero(cur.n, lead)
    for i in range(nbits):
        si, carry = gates.full_adder16(row0[..., i], row1[..., i], carry,
                                       cloud, mu_sum=gates.MU,
                                       mu_carry=gates.MU16)
        sums.append(si)
    return lwe_stack(sums, axis=-1)


def _two_row_plan(cc: np.ndarray, nbits: int):
    """Scatter M weighted bits (<=2 per column) into two per-column row index
    vectors; index M is the pad slot (callers append their pad ciphertext at
    position M before gathering)."""
    M = len(cc)
    r0 = np.full(nbits, M, np.int64)
    r1 = np.full(nbits, M, np.int64)
    for p in range(M):
        c = cc[p]
        if r0[c] == M:
            r0[c] = p
        elif r1[c] == M:
            r1[c] = p
    return r0, r1


def _assemble_two_rows_add(cur: LweCiphertext, cc: np.ndarray, nbits: int,
                           cloud) -> LweCiphertext:
    """Termination shared by both reduction paths when all bits are ±1/8:
    two trivial-zero-filled rows + one standard ripple add."""
    M = len(cc)
    r0, r1 = _two_row_plan(cc, nbits)
    curz = lwe_concat(
        [cur, zero_like_bits(cur, cur.batch_shape[:-1] + (1,))], axis=-1)
    row0 = lwe_take(curz, r0, axis=-1)
    if (r1 == M).all():
        return row0
    return add(row0, lwe_take(curz, r1, axis=-1), cloud)


def _wallace_sum_bits_fa(cur: LweCiphertext, cc: np.ndarray, nbits: int,
                         cloud) -> LweCiphertext:
    """Wallace-tree carry-save reduction of weighted bits, then ONE final
    ripple add — the batched replacement for the reference's pairwise
    log-tree accumulation (main.cu:1547-1569, `_tree_sum_rows` below).

    cur: [..., M] encrypted bits; cc: static int[M] column (bit position) of
    each. Every level compresses all column triples with ONE batched
    `gates.full_adder` call (sum stays in its column, carry moves up one;
    carries out of column nbits-1 are 2^nbits multiples and are DROPPED
    before they cost a bootstrap — the mod-2^nbits truncation semantics of
    the reference's tree). There is no carry chain inside a level, so the
    serial depth collapses from O(log2 R * nbits) dependent dispatches to
    O(log_{3/2} R) batched levels + one ripple add, and the bootstrap count
    is bounded by 2 per bit removed (strictly fewer than the pairwise tree,
    which bootstraps full nbits-wide adders even over known-trivial columns).
    All bit plumbing is static gathers (lwe_take) — one device op per level
    per field."""
    targets = _dadda_targets(int(np.bincount(cc, minlength=nbits).max()))
    for target in reversed(targets[:-1] or [2]):
        if np.bincount(cc, minlength=nbits + 1).max() <= 2:
            break
        xi, yi, zi, keep = _dadda_plan(cc, nbits, target)
        if not xi.size:
            continue
        # z index -1 = trivial-zero slot (half adder as FA with zero carry-in)
        curz = lwe_concat(
            [cur, zero_like_bits(cur, cur.batch_shape[:-1] + (1,))], axis=-1)
        s, c = gates.full_adder(lwe_take(cur, xi, -1), lwe_take(cur, yi, -1),
                                lwe_take(curz, zi, -1), cloud)
        scols = cc[xi]
        live = np.flatnonzero(scols + 1 < nbits)   # carries above nbits drop
        parts, ncc = [s], [scols]
        if live.size:
            parts.append(lwe_take(c, live, -1))
            ncc.append(scols[live] + 1)
        if keep.size:
            parts.append(lwe_take(cur, keep, -1))
            ncc.append(cc[keep])
        cur = lwe_concat(parts, axis=-1)
        cc = np.concatenate(ncc)
    assert np.bincount(cc, minlength=nbits + 1).max() <= 2, \
        "Dadda schedule under-delivered"
    return _assemble_two_rows_add(cur, cc, nbits, cloud)


def _csa_reduce_rows(rows: LweCiphertext, cloud) -> LweCiphertext:
    """Carry-save reduction of equal-width rows over axis -2: flattens the
    rows into (bit, column) pairs and runs the Wallace compressor
    (`_wallace_sum_bits`). Same mod-2^nbits truncated sum as the reference's
    pairwise log-tree, ~nbits/2 x fewer serial stages, and no bootstraps on
    carries that fall off the top."""
    R, nbits = rows.batch_shape[-2], rows.batch_shape[-1]
    if R == 1:
        return rows[..., 0, :]
    lead = rows.batch_shape[:-2]
    flat = rows.reshape(lead + (R * nbits,))
    cols = np.tile(np.arange(nbits), R)
    return _wallace_sum_bits(flat, cols, nbits, cloud)


def _tree_sum_rows(rows: LweCiphertext, add_fn, cloud) -> LweCiphertext:
    """Log-tree reduction over axis -2 (main.cu:1547-1569), keeping the rows
    as ONE tensor (halved by slicing each level — no per-row stack loops).
    Kept as the reference-shaped alternative; the default reduction is
    `_csa_reduce_rows` (same bootstraps, ~nbits/2 x fewer serial stages)."""
    R = rows.batch_shape[-2]
    while R > 1:
        half = R // 2
        summed = add_fn(rows[..., :half, :], rows[..., half:2 * half, :], cloud)
        if R % 2:
            rows = lwe_concat([summed, rows[..., 2 * half:, :]], axis=-2)
        else:
            rows = summed
        R = (R + 1) // 2
    return rows[..., 0, :]


@circuit(static_argnums=(1,))
def mul_plain(a: LweCiphertext, value: int, cloud) -> LweCiphertext:
    """a * public integer constant, mod 2^nbits. Where the reference would
    multiply by a plaintext (e.g. the public row count n in the linreg normal
    equations, paper section VI-G), the partial-product selection is static:
    NO AND bootstraps — the constant's set bits contribute copies of a's bits
    directly into the Wallace compressor."""
    nbits = a.batch_shape[-1]
    value = int(value) & ((1 << nbits) - 1)
    shifts = [s for s in range(nbits) if (value >> s) & 1]
    if not shifts:
        return zero_like_bits(a, a.batch_shape)
    if len(shifts) == 1:
        return left_shift(a, shifts[0])
    pairs = [(j, s + j) for s in shifts for j in range(nbits - s)]
    bits = lwe_take(a, np.array([j for (j, _) in pairs]), axis=-1)
    cols = np.array([c for (_, c) in pairs])
    return _wallace_sum_bits(bits, cols, nbits, cloud)


@circuit
def mul_mux(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """MUX-based shift-and-add multiplier — the reference CPU framework's
    alternative `mul` (ref mulBinary path inside Cipher::mul,
    cpuParallel/Cipher.cpp:126-176): partial product i is
    MUX(b_i, a << i, 0) (one batched MUX for the whole triangle), then the
    same Wallace reduction as `mul`."""
    nbits = a.batch_shape[-1]
    # truncation-aware like `mul`: only triangle positions i+j < nbits
    pairs = [(i, j) for i in range(nbits) for j in range(nbits - i)]
    sel = lwe_take(b, np.array([i for (i, _) in pairs]), axis=-1)   # [..., P]
    val = lwe_take(a, np.array([j for (_, j) in pairs]), axis=-1)
    zeros = zero_like_bits(a, val.batch_shape)
    ppm = gates.MUX(sel, val, zeros, cloud)                         # [..., P]
    cols = np.array([i + j for (i, j) in pairs])
    return _wallace_sum_bits(ppm, cols, nbits, cloud)


@circuit(static_argnums=(3,))
def mul_full(a: LweCiphertext, b: LweCiphertext, cloud, out_bits: int) -> LweCiphertext:
    """Shift-and-add multiply with an explicit output width (zero-extends
    inputs; used by Karatsuba for full-width half-products)."""
    nbits = a.batch_shape[-1]
    pad = out_bits - nbits
    if pad > 0:
        za = zero_like_bits(a, a.batch_shape[:-1] + (pad,))
        a = lwe_concat([a, za], axis=-1)
        b = lwe_concat([b, za], axis=-1)
    return mul(a, b, cloud)


@circuit
def mul_karatsuba(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Karatsuba multiplication (ref karatMasterSuba, main.cu:1867-2089;
    cpuParallel OMP-task variant cloud.cpp:77-131; paper section V-B2).

    Splits nbits = 2h, batches the three half-multiplies (a0*b0, a1*b1,
    (a0+a1)*(b0+b1)) as ONE vector multiply - the reference's key trick of
    concatenating them into a single coalesced multiply - then recombines:
    result = d1*2^2h + (d2-d1-d0)*2^h + d0, truncated to nbits.
    """
    nbits = a.batch_shape[-1]
    assert nbits % 2 == 0, "karatsuba needs even bit width"
    h = nbits // 2
    w = nbits + 2                      # width that fits (a0+a1)*(b0+b1)
    a0, a1 = a[..., :h], a[..., h:]
    b0, b1 = b[..., :h], b[..., h:]

    def zext(x, width):
        pad = width - x.batch_shape[-1]
        return lwe_concat([x, zero_like_bits(x, x.batch_shape[:-1] + (pad,))], axis=-1)

    sa = add(zext(a0, h + 1), zext(a1, h + 1), cloud)      # a0 + a1, h+1 bits
    sb = add(zext(b0, h + 1), zext(b1, h + 1), cloud)
    # one batched multiply for all three products (leading axis 3)
    lhs = lwe_stack([zext(a0, w), zext(a1, w), zext(sa, w)], axis=-2)
    rhs = lwe_stack([zext(b0, w), zext(b1, w), zext(sb, w)], axis=-2)
    prods = mul(lhs, rhs, cloud)                           # [..., 3, w]
    d0, d1, d2 = prods[..., 0, :], prods[..., 1, :], prods[..., 2, :]
    mid = sub(sub(d2, d1, cloud), d0, cloud)               # d2 - d1 - d0
    # result (mod 2^nbits) = d0 + mid<<h + d1<<2h; 2h >= nbits so d1 drops out
    out = add(d0[..., :nbits],
              left_shift(mid[..., :nbits], h)[..., :nbits] if h else mid[..., :nbits],
              cloud)
    return out


# --------------------------------------------------------------- comparisons

def compare_bit(result, ai, bi, cloud):
    """One comparator stage (ref Cipher::compare_bit, Cipher.cpp:335-340):
    result' = MUX(XNOR(a,b), result, a), which equals MAJ(a, not b, result)
    — ONE bootstrap instead of the reference's XNOR+MUX (3)."""
    return gates.MAJ(ai, gates.NOT(bi), result, cloud)


@circuit
def minimum(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Minimum of two (positive) numbers (ref minimum, Cipher.cpp:313-333)."""
    nbits = a.batch_shape[-1]
    if _latency_bound(a):
        g, p = gates.gate2_pair("ANDYN", "XNOR", a, b, a, b, cloud)
        cmp = _cmp_carry_tree(g, p, cloud)                 # unsigned a > b
    else:
        cmp = zero_like_bits(a, a.batch_shape[:-1])
        for i in range(nbits):
            cmp = compare_bit(cmp, a[..., i], b[..., i], cloud)
    # cmp == 1 iff b larger? (ref: 0 if a larger, 1 if b larger) -> out = MUX(cmp, b, a)
    cmps = lwe_stack([cmp] * nbits, axis=-1)
    return gates.MUX(cmps, b, a, cloud)


@circuit
def gt(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Signed a > b -> 1-bit ciphertext (ref Cipher::operator>,
    Cipher.cpp:597-608, whose stage a ^ ((a^cin) & (b^cin)) needs 4 gates).
    Here each stage is cin' = MUX(a^b, a, cin) == MAJ(a, not b, cin) — ONE
    bootstrap — and the signed fixup (a_msb ^ b_msb) ^ cin is one XOR3.
    Latency-bound batches reduce the carry with the pairwise (g,p) combine
    tree (log2(nbits) fused levels) instead of the linear MAJ chain."""
    nbits = a.batch_shape[-1]
    if _latency_bound(a):
        g, p = gates.gate2_pair("ANDYN", "XNOR", a, b, a, b, cloud)
        cin = _cmp_carry_tree(g, p, cloud)
    else:
        cin = zero_like_bits(a, a.batch_shape[:-1])
        for i in range(nbits):
            cin = gates.MAJ(a[..., i], gates.NOT(b[..., i]), cin, cloud)
    return gates.XOR3(a[..., nbits - 1], b[..., nbits - 1], cin, cloud)


@circuit
def le(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """a <= b (ref Cipher::operator<=, Cipher.cpp:610-614)."""
    return gates.NOT(gt(a, b, cloud))


@circuit
def eq(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """a == b (ref Cipher::operator==, Cipher.cpp:633-644), with a log-depth
    OR tree instead of the reference's sequential OR chain."""
    x = gates.XOR(a, b, cloud)                             # [..., nbits]
    R = x.batch_shape[-1]
    while R > 1:
        half = R // 2
        ored = gates.OR(x[..., :half], x[..., half:2 * half], cloud)
        x = lwe_concat([ored, x[..., 2 * half:]], axis=-1) if R % 2 else ored
        R = (R + 1) // 2
    return gates.NOT(x[..., 0])


# --------------------------------------------------------------- signed ops

@circuit
def absolute(a: LweCiphertext, cloud) -> LweCiphertext:
    """|a| (ref absolute, Cipher.cpp:483-505): (a + sign_mask) ^ sign_mask."""
    nbits = a.batch_shape[-1]
    sign = a[..., nbits - 1]
    mask = lwe_stack([sign] * nbits, axis=-1)
    res = add(mask, a, cloud)
    return gates.XOR(res, mask, cloud)


@circuit
def add_sign(x: LweCiphertext, sign, cloud) -> LweCiphertext:
    """Conditionally negate x when sign==1 (ref addSign, Cipher.cpp:560-577)."""
    nbits = x.batch_shape[-1]
    if _latency_bound(x):
        res = gates.XOR(x, _or_scan_excl(x, cloud), cloud)
    else:
        reach = zero_like_bits(x, x.batch_shape[:-1])
        result = []
        for i in range(nbits - 1):
            r_i = gates.XOR(x[..., i], reach, cloud)
            reach = gates.OR(reach, x[..., i], cloud)
            result.append(r_i)
        result.append(gates.XOR(x[..., nbits - 1], reach, cloud))
        res = lwe_stack(result, axis=-1)
    signs = lwe_stack([sign] * nbits, axis=-1)
    return gates.MUX(signs, res, x, cloud)


@circuit
def div(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Signed division via restoring division on absolutes
    (ref operator/ + divInternal, Cipher.cpp:508-558)."""
    nbits = a.batch_shape[-1]
    abs_a = absolute(a, cloud)
    abs_b = absolute(b, cloud)
    # -|b| hoisted out of the loop (the reference's divInternal recomputes the
    # subtraction's complement every round, Cipher.cpp:526-558; it is loop
    # invariant — hoisting halves the per-iteration bootstrap count)
    neg_b = twos_complement(abs_b, cloud)
    # PA register: [remainder(nbits) | quotient-in-progress], LSB half = abs_a
    pa_lo = abs_a                                  # bits [0, nbits)
    pa_hi = zero_like_bits(a, a.batch_shape)       # bits [nbits, 2nbits)
    for _ in range(nbits):
        # PA <<= 1 across the 2*nbits register
        pa_hi = lwe_concat([pa_lo[..., nbits - 1:nbits], pa_hi[..., :-1]], axis=-1)
        zero1 = zero_like_bits(a, a.batch_shape[:-1] + (1,))
        pa_lo = lwe_concat([zero1, pa_lo[..., :-1]], axis=-1)
        temp_p = add(pa_hi, neg_b, cloud)
        neg = temp_p[..., nbits - 1]               # 1 if tempP < 0
        bit = gates.NOT(neg)
        pa_lo = lwe_concat([bit.reshape(bit.batch_shape + (1,)), pa_lo[..., 1:]], axis=-1)
        negs = lwe_stack([neg] * nbits, axis=-1)
        pa_hi = gates.MUX(negs, pa_hi, temp_p, cloud)
    quotient = pa_lo
    sign = gates.XOR(a[..., nbits - 1], b[..., nbits - 1], cloud)
    return add_sign(quotient, sign, cloud)
