"""Native C++ engine vs numpy oracle vs JAX pipeline (all exact, bit-identical)."""
import numpy as np
import jax.numpy as jnp
import pytest

import tfhe_tpu as tt
from tfhe_tpu import oracle

native_ref = pytest.importorskip("tfhe_tpu.native_ref")

try:
    native_ref.build()
    HAVE_NATIVE = True
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="no g++ toolchain")


def test_native_polymul():
    rng = np.random.RandomState(0)
    N = 128
    a = rng.randint(-512, 512, size=N).astype(np.int32)
    b = rng.randint(-(2 ** 31), 2 ** 31, size=N).astype(np.int32)
    got = native_ref.polymul(a, b)
    want = oracle.negacyclic_polymul(a, b)
    np.testing.assert_array_equal(got, want)


def test_native_bootstrap_matches_jax(toy_keys):
    sk = toy_keys
    params = sk.params
    rng = np.random.RandomState(1)
    B = 4
    a = rng.randint(-(2 ** 31), 2 ** 31, size=(B, params.n)).astype(np.int32)
    b = rng.randint(-(2 ** 31), 2 ** 31, size=(B,)).astype(np.int32)
    mu = 1 << 29

    na, nb = native_ref.bootstrap_batch(sk, a, b, mu)

    from tfhe_tpu.core import bootstrap as bs
    from tfhe_tpu.core.lwe import LweCiphertext
    ct = LweCiphertext(jnp.asarray(a), jnp.asarray(b), jnp.zeros(B, jnp.float32))
    out = bs.bootstrap(ct, jnp.int32(mu), sk.cloud)
    np.testing.assert_array_equal(na, np.asarray(out.a))
    np.testing.assert_array_equal(nb, np.asarray(out.b))


def test_native_gate_truth_table(toy_keys):
    sk = toy_keys
    A = np.array([0, 0, 1, 1], np.int32)
    B_ = np.array([0, 1, 0, 1], np.int32)
    ca = tt.encrypt_bits(sk, A, seed=71)
    cb = tt.encrypt_bits(sk, B_, seed=72)
    oa, ob = native_ref.gate2_batch(
        sk, "AND", np.asarray(ca.a), np.asarray(ca.b), np.asarray(cb.a), np.asarray(cb.b))
    from tfhe_tpu.core.lwe import LweCiphertext
    out = LweCiphertext(jnp.asarray(oa), jnp.asarray(ob), jnp.zeros(4, jnp.float32))
    np.testing.assert_array_equal(tt.decrypt_bits(sk, out), A & B_)


def test_native_ripple_add(toy_keys):
    """Native C++ adder vs plain int semantics and vs the JAX adder's output
    decryption (same circuit, cpuParallel Cipher::operator+ twin)."""
    sk = toy_keys
    from tfhe_tpu import arith
    from tfhe_tpu.core.lwe import LweCiphertext
    nb = 4
    a = np.array([3, 7, -8], np.int64)
    b = np.array([2, 1, 3], np.int64)
    ca = arith.encrypt_int(sk, a, nb, seed=91)
    cb = arith.encrypt_int(sk, b, nb, seed=92)
    oa, ob = native_ref.ripple_add(
        sk, np.asarray(ca.a), np.asarray(ca.b), np.asarray(cb.a), np.asarray(cb.b))
    out = LweCiphertext(jnp.asarray(oa), jnp.asarray(ob),
                        jnp.zeros(ob.shape, jnp.float32))
    got = arith.decrypt_int(sk, out)
    want = np.array([5, -8, -5])  # mod-16 two's complement of a+b
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [1, 3, 65, 300])
def test_bootstrap_matches_native_batch_sizes(toy_keys, B):
    """bootstrap() is bit-identical to the native engine at every batch
    size, including one above the chunk size (bootstrap.LANE_MAX_BATCH)."""
    from tfhe_tpu.core import bootstrap as bs
    from tfhe_tpu.core.lwe import LweCiphertext
    sk = toy_keys
    rng = np.random.RandomState(100 + B)
    a = rng.randint(-(2 ** 31), 2 ** 31, size=(B, sk.params.n)).astype(np.int32)
    b = rng.randint(-(2 ** 31), 2 ** 31, size=(B,)).astype(np.int32)
    mu = 1 << 29
    na, nb = native_ref.bootstrap_batch(sk, a, b, mu)
    ct = LweCiphertext(jnp.asarray(a), jnp.asarray(b), jnp.zeros(B, jnp.float32))
    out = bs.bootstrap(ct, jnp.int32(mu), sk.cloud)
    np.testing.assert_array_equal(np.asarray(out.a), na)
    np.testing.assert_array_equal(np.asarray(out.b), nb)
