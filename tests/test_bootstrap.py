"""Differential tests: every stage of the batched JAX pipeline must be
BIT-IDENTICAL to the numpy oracle (both use exact integer arithmetic).

This is a stronger check than the reference ever had: its GPU/CPU paths only
matched after decryption because of FFT rounding (SURVEY.md section 4.3)."""
import numpy as np
import jax.numpy as jnp
import pytest

import tfhe_tpu as tt
from tfhe_tpu import oracle
from tfhe_tpu.core import bootstrap as bs
from tfhe_tpu.core.lwe import LweCiphertext


def test_rotate_matches_oracle(toy_keys):
    params = toy_keys.params
    N = params.N
    rng = np.random.RandomState(5)
    x = rng.randint(-(2 ** 31), 2 ** 31, size=(7, 2, N)).astype(np.int32)
    amounts = rng.randint(0, 2 * N, size=7).astype(np.int32)
    got = np.asarray(bs.negacyclic_rotate(jnp.asarray(x), jnp.asarray(amounts)))
    for b in range(7):
        for c in range(2):
            want = oracle.mul_by_xai(int(amounts[b]), x[b, c])
            np.testing.assert_array_equal(got[b, c], want)


def test_decompose_matches_oracle(toy_keys):
    params = toy_keys.params
    rng = np.random.RandomState(6)
    x = rng.randint(-(2 ** 31), 2 ** 31, size=(5, params.k + 1, params.N)).astype(np.int32)
    got = np.asarray(bs.gadget_decompose(jnp.asarray(x), params))
    for b in range(5):
        for c in range(params.k + 1):
            want = oracle.decompose(x[b, c], params)
            np.testing.assert_array_equal(
                got[b, c * params.bk_l:(c + 1) * params.bk_l], want)


def test_extern_product_matches_oracle(toy_keys):
    sk = toy_keys
    params = sk.params
    rng = np.random.RandomState(7)
    B = 3
    acc = rng.randint(-(2 ** 31), 2 ** 31, size=(B, params.k + 1, params.N)).astype(np.int32)
    j = 2
    dec = bs.gadget_decompose(jnp.asarray(acc), params)
    got = np.asarray(bs.extern_product_ntt(
        dec, sk.cloud.bk_ntt[j], sk.cloud.bk_ntt_shoup[j], params))
    for b in range(B):
        want = oracle.extern_product(acc[b], params, sk.bk_raw[j])
        np.testing.assert_array_equal(got[b], want)


def test_full_bootstrap_matches_oracle(toy_keys):
    sk = toy_keys
    params = sk.params
    rng = np.random.RandomState(8)
    B = 4
    a = rng.randint(-(2 ** 31), 2 ** 31, size=(B, params.n)).astype(np.int32)
    b = rng.randint(-(2 ** 31), 2 ** 31, size=(B,)).astype(np.int32)
    mu = 1 << 29
    ct = LweCiphertext(jnp.asarray(a), jnp.asarray(b), jnp.zeros(B, jnp.float32))
    out = bs.bootstrap(ct, jnp.int32(mu), sk.cloud)
    got_a, got_b = np.asarray(out.a), np.asarray(out.b)
    for i in range(B):
        want_a, want_b = oracle.bootstrap(a[i], b[i], mu, sk.bk_raw,
                                          sk.ks_a, sk.ks_b, params)
        np.testing.assert_array_equal(got_a[i], want_a)
        assert got_b[i] == want_b


def test_encrypt_decrypt_roundtrip(toy_keys):
    sk = toy_keys
    bits = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    ct = tt.encrypt_bits(sk, bits, seed=1)
    out = tt.decrypt_bits(sk, ct)
    np.testing.assert_array_equal(out, bits)
