"""Integer arithmetic circuits vs plain int semantics (toy params, 4-bit)."""
import numpy as np
import pytest

import tfhe_tpu as tt
from tfhe_tpu import arith

NB = 4
MASK = (1 << NB) - 1


def _signed(v):
    v = v & MASK
    return v - (1 << NB) if v & (1 << (NB - 1)) else v


def test_add_ripple(toy_keys):
    sk = toy_keys
    a = np.array([3, 7, -8, 5, 0], np.int64)
    b = np.array([2, 1, 3, -5, 0], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=21)
    cb = arith.encrypt_int(sk, b, NB, seed=22)
    out = arith.decrypt_int(sk, arith.add(ca, cb, sk.cloud))
    want = np.array([_signed(x + y) for x, y in zip(a, b)])
    np.testing.assert_array_equal(out, want)


def test_add_numberwise(toy_keys):
    sk = toy_keys
    a = np.array([3, 6], np.int64)
    b = np.array([4, 7], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=23)
    cb = arith.encrypt_int(sk, b, NB, seed=24)
    out = arith.decrypt_int(sk, arith.add_numberwise(ca, cb, sk.cloud))
    want = np.array([_signed(x + y) for x, y in zip(a, b)])
    np.testing.assert_array_equal(out, want)


def test_sub_and_neg(toy_keys):
    sk = toy_keys
    a = np.array([5, 2], np.int64)
    b = np.array([3, 7], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=25)
    cb = arith.encrypt_int(sk, b, NB, seed=26)
    out = arith.decrypt_int(sk, arith.sub(ca, cb, sk.cloud))
    np.testing.assert_array_equal(out, [_signed(x - y) for x, y in zip(a, b)])
    neg = arith.decrypt_int(sk, arith.twos_complement(ca, sk.cloud))
    np.testing.assert_array_equal(neg, [_signed(-x) for x in a])


def test_mul(toy_keys):
    sk = toy_keys
    a = np.array([3, 5], np.int64)
    b = np.array([2, 3], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=27)
    cb = arith.encrypt_int(sk, b, NB, seed=28)
    out = arith.decrypt_int(sk, arith.mul(ca, cb, sk.cloud))
    np.testing.assert_array_equal(out, [_signed(x * y) for x, y in zip(a, b)])


def test_mul_plain(toy_keys):
    sk = toy_keys
    a = np.array([3, 5, -2], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=29)
    for k in (0, 1, 2, 3, 5, 7):
        out = arith.decrypt_int(sk, arith.mul_plain(ca, k, sk.cloud))
        np.testing.assert_array_equal(out, [_signed(x * k) for x in a])


def test_comparisons(toy_keys):
    sk = toy_keys
    a = np.array([3, -2, 5, 4], np.int64)
    b = np.array([2, 4, 5, 7], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=29)
    cb = arith.encrypt_int(sk, b, NB, seed=30)
    gt = tt.decrypt_bits(sk, arith.gt(ca, cb, sk.cloud))
    np.testing.assert_array_equal(gt, (a > b).astype(np.int32))
    le = tt.decrypt_bits(sk, arith.le(ca, cb, sk.cloud))
    np.testing.assert_array_equal(le, (a <= b).astype(np.int32))
    eqr = tt.decrypt_bits(sk, arith.eq(ca, cb, sk.cloud))
    np.testing.assert_array_equal(eqr, (a == b).astype(np.int32))


def test_abs_min(toy_keys):
    sk = toy_keys
    a = np.array([-3, 4], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=31)
    out = arith.decrypt_int(sk, arith.absolute(ca, sk.cloud))
    np.testing.assert_array_equal(out, np.abs(a))
    b = np.array([2, 6], np.int64)
    cb = arith.encrypt_int(sk, b, NB, seed=32)
    mn = arith.decrypt_int(sk, arith.minimum(
        arith.encrypt_int(sk, np.abs(a), NB, seed=33), cb, sk.cloud))
    np.testing.assert_array_equal(mn, np.minimum(np.abs(a), b))


@pytest.mark.slow
def test_div(toy_keys):
    sk = toy_keys
    a = np.array([6, -7], np.int64)
    b = np.array([2, 3], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=34)
    cb = arith.encrypt_int(sk, b, NB, seed=35)
    out = arith.decrypt_int(sk, arith.div(ca, cb, sk.cloud))
    want = np.array([int(x / y) for x, y in zip(a, b)])  # trunc toward zero
    np.testing.assert_array_equal(out, want)


def test_shifts(toy_keys):
    sk = toy_keys
    a = np.array([3, -4], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=36)
    ls = arith.decrypt_int(sk, arith.left_shift(ca, 1))
    np.testing.assert_array_equal(ls, [_signed(x << 1) for x in a])
    rs = arith.decrypt_int(sk, arith.right_shift_arith(ca, 1))
    np.testing.assert_array_equal(rs, [x >> 1 for x in a])
    # with the reference's negative-rounding correction (Cipher.cpp:470-480):
    # the reference adds sign?1:0 UNCONDITIONALLY for negative operands, so
    # exact multiples also get +1 (-4 >> 1 -> -2+1 = -1) and -3 >> 1 -> -1;
    # i.e. the result is (x>>1)+(x<0), not round-toward-zero division
    a2 = np.array([3, -4, -3, -7], np.int64)
    ca2 = arith.encrypt_int(sk, a2, NB, seed=37)
    rs2 = arith.decrypt_int(sk, arith.right_shift_arith(ca2, 1, sk.cloud))
    np.testing.assert_array_equal(rs2, [(x >> 1) + (1 if x < 0 else 0) for x in a2])


def test_mul_mux(toy_keys):
    """MUX-based multiplier variant (ref Cipher::mul MUX path)."""
    sk = toy_keys
    a = np.array([3, -2], np.int64)
    b = np.array([2, 3], np.int64)
    ca = arith.encrypt_int(sk, a, NB, seed=31)
    cb = arith.encrypt_int(sk, b, NB, seed=32)
    out = arith.decrypt_int(sk, arith.mul_mux(ca, cb, sk.cloud))
    want = np.array([_signed(x * y) for x, y in zip(a, b)])
    np.testing.assert_array_equal(out, want)


def test_cipher_increment_iadd(toy_keys):
    """CipherInt increment / += (ref Cipher::operator++ / +=)."""
    from tfhe_tpu.cipher import CipherInt
    sk = toy_keys
    x = CipherInt.encrypt(sk, 5, nbits=NB, seed=41)
    y = CipherInt.encrypt(sk, -3, nbits=NB, seed=42)
    assert int(x.increment().decrypt(sk)) == 6
    x += y
    assert int(x.decrypt(sk)) == 2


def test_random_circuit_vs_plaintext(toy_keys):
    """Property test: a random boolean circuit evaluated homomorphically
    matches plaintext evaluation (the reference's differential methodology
    generalized)."""
    sk = toy_keys
    rng = np.random.RandomState(99)
    from tfhe_tpu import gates
    import tfhe_tpu as tt
    B = 6
    wires_p = [rng.randint(0, 2, size=B).astype(np.int32) for _ in range(3)]
    wires_c = [tt.encrypt_bits(sk, w, seed=200 + i) for i, w in enumerate(wires_p)]
    ops = {"AND": np.logical_and, "OR": np.logical_or,
           "XOR": np.logical_xor, "NAND": lambda x, y: ~(x & y) & 1,
           "ANDYN": lambda x, y: x & (1 - y)}
    names = list(ops)
    for step in range(6):
        i, j = rng.randint(0, len(wires_p), size=2)
        name = names[rng.randint(0, len(names))]
        wires_p.append(np.asarray(ops[name](wires_p[i], wires_p[j]), np.int32) & 1)
        wires_c.append(gates.gate2(name, wires_c[i], wires_c[j], sk.cloud))
    for w_p, w_c in zip(wires_p, wires_c):
        np.testing.assert_array_equal(tt.decrypt_bits(sk, w_c), w_p)


def test_add_chain_under_real_noise():
    """Deep carry chains under real gaussian noise (PARAMS_SMALL_NOISY):
    the 2-bootstrap full adder's 3-input affines (MAJ carry, x2-amplified
    XOR3 sum — the noisiest phase in the framework) must survive a 7-stage
    chain at reference noise levels."""
    import tfhe_tpu as tt
    from tests.conftest import _cached_keys
    sk = _cached_keys(tt.PARAMS_SMALL_NOISY, (314, 1592, 657))
    rng = np.random.RandomState(3)
    a = rng.randint(0, 1 << 6, size=4)
    b = rng.randint(0, 1 << 6, size=4)
    ca = arith.encrypt_int(sk, a, 8, seed=71)
    cb = arith.encrypt_int(sk, b, 8, seed=72)
    out = arith.decrypt_int(sk, arith.add(ca, cb, sk.cloud), signed=False)
    np.testing.assert_array_equal(out, a + b)


def test_prefix_vs_ripple_paths_agree(toy_keys):
    """The Kogge-Stone prefix circuits (auto-selected at small batches) and
    the ripple circuits compute identical results for add/sub/gt/minimum/
    twos_complement/add_sign on random signed inputs."""
    import os
    sk = toy_keys
    nb = 8
    a = np.array([37, -61, 0, -128], np.int64)
    b = np.array([-41, 23, -1, 127], np.int64)
    ca = arith.encrypt_int(sk, a, nb, seed=81)
    cb = arith.encrypt_int(sk, b, nb, seed=82)

    def run():
        return (
            arith.decrypt_int(sk, arith.add(ca, cb, sk.cloud)),
            arith.decrypt_int(sk, arith.sub(ca, cb, sk.cloud)),
            np.asarray(tt.decrypt_bits(sk, arith.gt(ca, cb, sk.cloud))),
            arith.decrypt_int(sk, arith.twos_complement(ca, sk.cloud)),
        )

    os.environ["TFHE_TPU_LOOKAHEAD"] = "1"
    try:
        fast = run()
    finally:
        os.environ["TFHE_TPU_LOOKAHEAD"] = "0"
    try:
        ripple = run()
    finally:
        del os.environ["TFHE_TPU_LOOKAHEAD"]
    for f, r in zip(fast, ripple):
        np.testing.assert_array_equal(f, r)
    m = (1 << nb) - 1

    def signed(v):
        v = int(v) & m
        return v - (1 << nb) if v & (1 << (nb - 1)) else v

    np.testing.assert_array_equal(fast[0], [signed(x + y) for x, y in zip(a, b)])
    np.testing.assert_array_equal(fast[1], [signed(x - y) for x, y in zip(a, b)])
    np.testing.assert_array_equal(fast[2], (a > b).astype(int))
    np.testing.assert_array_equal(fast[3], [signed(-x) for x in a])


def test_septet_mul_under_real_noise():
    """The 7:3 compressor's ±1/16 margins (4x tighter than standard gates)
    must survive real gaussian noise: a 16-bit multiply routes ~130 partial
    products through septet/FA16 levels at PARAMS_SMALL_NOISY."""
    import tfhe_tpu as tt
    from tests.conftest import _cached_keys
    sk = _cached_keys(tt.PARAMS_SMALL_NOISY, (314, 1592, 657))
    rng = np.random.RandomState(5)
    a = rng.randint(0, 1 << 7, size=2)
    b = rng.randint(0, 1 << 7, size=2)
    ca = arith.encrypt_int(sk, a, 16, seed=73)
    cb = arith.encrypt_int(sk, b, 16, seed=74)
    out = arith.decrypt_int(sk, arith.mul(ca, cb, sk.cloud), signed=False)
    np.testing.assert_array_equal(out, a * b)


def test_whole_circuit_jit_matches_eager(toy_keys):
    """The whole-circuit jit path (arith.circuit, the accelerator default)
    must compute exactly what the eager dispatch computes. CPU-compile cost
    bounds this to ONE small circuit; chip_smoke.py runs it at full size."""
    import jax
    from tfhe_tpu import config
    sk = toy_keys
    a = np.array([5, 9], np.int64)
    b = np.array([3, 6], np.int64)
    ca = arith.encrypt_int(sk, a, 4, seed=31)
    cb = arith.encrypt_int(sk, b, 4, seed=32)
    eager = arith.decrypt_int(sk, arith.add(ca, cb, sk.cloud), signed=False)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        jitted = arith.decrypt_int(sk, arith.add(ca, cb, sk.cloud), signed=False)
    np.testing.assert_array_equal(jitted, eager)
    np.testing.assert_array_equal(jitted, (a + b) % 16)
