"""Differential tests against the REFERENCE'S OWN compiled code.

libref_oracle.so (native/Makefile) compiles the reference's CPU translation
units in place from /root/reference/gpuParallel — keygen
(lweKeyGen/tGswKeyGen/tfhe_createLweBootstrappingKey), encryption
(bootsSymEncrypt), the non-FFT bootstrap chain (tfhe_bootstrap,
lwe-bootstrapping-functions.cu:159-182, over exact-integer Karatsuba,
multiplication.cu:126-176) and the tfhe_io serializer. These tests require
the JAX pipeline to be BYTE-IDENTICAL to that code's output, so no
oracle is authored by this repository alone — the reference
implementation itself now attests keys, ciphertexts, every pipeline stage
(blind-rotate+extract, key switch), whole gates, MUX, and the wire format.
"""
import os

import numpy as np
import pytest

import tfhe_tpu as tt
from tfhe_tpu import ref_oracle as ro
from tfhe_tpu.core import crypt
from tfhe_tpu.core.keys import keygen_reference
from tfhe_tpu.core.lwe import LweCiphertext

pytestmark = pytest.mark.skipif(
    not ro.available(), reason="reference checkout not present")

SEED = (314, 1592, 657)


@pytest.fixture(scope="session")
def oracle():
    ro.init(SEED)
    return ro


@pytest.fixture(scope="session")
def sk(oracle):
    """Framework keyset from the same seed (reference-PRNG path)."""
    return keygen_reference(tt.PARAMS_110, seed=SEED)


@pytest.fixture(scope="session")
def ref_bits(oracle):
    """Reference-encrypted bits [1,0,1,1,0,1,0,0] (PRNG stream after keygen)."""
    bits = np.array([1, 0, 1, 1, 0, 1, 0, 0], np.int32)
    a, b = ro.encrypt_bits(bits)
    return bits, a, b


def _ct(a, b):
    import jax.numpy as jnp
    a = np.atleast_2d(np.asarray(a, np.int32))
    b = np.atleast_1d(np.asarray(b, np.int32))
    return LweCiphertext(jnp.asarray(a), jnp.asarray(b),
                         jnp.zeros(b.shape, jnp.float32))


def test_keygen_byte_identical(oracle, sk):
    """The reference's own keygen code == the framework's reference-PRNG keys."""
    lwe, tlwe, ks_a, ks_b, bk = ro.get_keys()
    np.testing.assert_array_equal(lwe, sk.lwe_key)
    np.testing.assert_array_equal(tlwe, sk.tlwe_key)
    np.testing.assert_array_equal(bk, sk.bk_raw)
    np.testing.assert_array_equal(ks_a, sk.ks_a)
    np.testing.assert_array_equal(ks_b, sk.ks_b)


def test_encrypt_decrypt_cross(oracle, sk, ref_bits):
    """Reference-encrypted ciphertexts decrypt identically on both sides."""
    bits, a, b = ref_bits
    ct = _ct(a, b)
    np.testing.assert_array_equal(crypt.decrypt_bits(sk, ct), bits)
    for i in range(len(bits)):
        assert ro.decrypt(a[i], b[i]) == bits[i]


def test_gates_byte_identical(oracle, sk, ref_bits):
    """Whole-gate differential: framework gate output == the output of the
    reference's own tfhe_bootstrap for every gate type, byte for byte."""
    from tfhe_tpu import gates

    bits, a, b = ref_bits
    x = _ct(a[[0, 1]], b[[0, 1]])   # bits (1, 0)
    y = _ct(a[[2, 4]], b[[2, 4]])   # bits (1, 0)
    for name, op in (("AND", lambda p, q: p & q), ("OR", lambda p, q: p | q),
                     ("XOR", lambda p, q: p ^ q), ("NAND", lambda p, q: 1 - (p & q)),
                     ("NOR", lambda p, q: 1 - (p | q)),
                     ("XNOR", lambda p, q: 1 - (p ^ q))):
        got = gates.gate2(name, x, y, sk.cloud)
        ga, gb = np.asarray(got.a), np.asarray(got.b)
        for j, (i1, i2) in enumerate(((0, 2), (1, 4))):
            wa, wb = ro.gate(name, a[i1], b[i1], a[i2], b[i2])
            np.testing.assert_array_equal(ga[j], wa, err_msg=f"{name} a row {j}")
            assert int(gb[j]) == wb, f"{name} b row {j}"
            assert ro.decrypt(wa, wb) == op(bits[i1], bits[i2])


def test_pipeline_stages_byte_identical(oracle, sk, ref_bits):
    """Stage-level differential on a raw input sample: blind-rotate+extract
    (tfhe_bootstrap_woKS) and key switch (lweKeySwitch) separately."""
    import jax.numpy as jnp
    from tfhe_tpu.core import bootstrap as bs
    from tfhe_tpu import gates

    bits, a, b = ref_bits
    # the AND affine image of (bit0, bit2) as the bootstrap input
    const, cfa, cfb = gates.GATE_TABLE["AND"]
    x = _ct(a[[0]], b[[0]])
    y = _ct(a[[2]], b[[2]])
    tv = gates._affine2(x, y, jnp.int32(const), jnp.int32(cfa), jnp.int32(cfb))

    a_ext, b_ext, cv = bs.bootstrap_woks(tv, jnp.int32(gates.MU), sk.cloud)
    wa_ext, wb_ext = ro.bootstrap_woks(np.asarray(tv.a)[0], int(np.asarray(tv.b)[0]),
                                       int(gates.MU))
    np.testing.assert_array_equal(np.asarray(a_ext)[0], wa_ext)
    assert int(np.asarray(b_ext)[0]) == wb_ext

    out = bs.key_switch(a_ext, b_ext, sk.cloud.ks_table, cv, sk.params)
    wa, wb = ro.keyswitch(wa_ext, wb_ext)
    np.testing.assert_array_equal(np.asarray(out.a)[0], wa)
    assert int(np.asarray(out.b)[0]) == wb


def test_mux_byte_identical(oracle, sk, ref_bits):
    """MUX differential (two woKS bootstraps + add + single key switch,
    boot-gates.cu:407-448)."""
    from tfhe_tpu import gates

    bits, a, b = ref_bits
    sel, p, q = 0, 2, 3          # bits 1, 1, 1
    sel2 = 4                     # bit 0
    for s in (sel, sel2):
        got = gates.MUX(_ct(a[[s]], b[[s]]), _ct(a[[p]], b[[p]]),
                        _ct(a[[q]], b[[q]]), sk.cloud)
        wa, wb = ro.mux(a[s], b[s], a[p], b[p], a[q], b[q])
        np.testing.assert_array_equal(np.asarray(got.a)[0], wa)
        assert int(np.asarray(got.b)[0]) == wb
        want = bits[p] if bits[s] else bits[q]
        assert ro.decrypt(wa, wb) == want


def test_chained_gates_byte_identical(oracle, sk, ref_bits):
    """Composition: feed a gate output into another gate on both sides."""
    from tfhe_tpu import gates

    bits, a, b = ref_bits
    x = _ct(a[[0]], b[[0]])
    y = _ct(a[[2]], b[[2]])
    g1 = gates.AND(x, y, sk.cloud)
    w1a, w1b = ro.gate("AND", a[0], b[0], a[2], b[2])
    g2 = gates.XOR(g1, _ct(a[[3]], b[[3]]), sk.cloud)
    w2a, w2b = ro.gate("XOR", w1a, w1b, a[3], b[3])
    np.testing.assert_array_equal(np.asarray(g2.a)[0], w2a)
    assert int(np.asarray(g2.b)[0]) == w2b
    assert ro.decrypt(w2a, w2b) == (bits[0] & bits[2]) ^ bits[3]


def test_reference_serializer_byte_identical(oracle, tmp_path):
    """The reference's OWN tfhe_io writer produces byte-identical key files to
    the golden fixtures (written by the independent builder serializer) —
    i.e. the committed fixtures are exactly what the reference would write."""
    import hashlib

    sums = {}
    with open(os.path.join(os.path.dirname(__file__), "fixtures", "SHA256SUMS")) as f:
        for line in f:
            digest, name = line.split()
            sums[name] = digest
    spath = str(tmp_path / "secret.key")
    cpath = str(tmp_path / "cloud.key")
    ro.write_keyset_files(spath, cpath)
    for path, name in ((spath, "secret.key"), (cpath, "cloud.key")):
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        assert got == sums[name], f"{name}: reference serializer bytes diverge"
