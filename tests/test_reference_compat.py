"""Golden-file cross-validation against the reference implementation.

The fixture generator (native/ref_fixtures.cpp) reproduces the reference
apps' key generation and encryption draw for draw with the reference's own
libstdc++ PRNG (`std::default_random_engine` seeded `{314,1592,657}`,
`gpuParallel/main.cu:2724-2726`, `cpuParallel/main.cpp:20-23`) and writes
`secret.key` / `cloud.key` / `cloud.data` in the reference tfhe_io wire
format with an *independent* C++ serializer (not tfhe_tpu.io).

Committed pins (tests/fixtures/): the full `cloud.data` bytes and SHA256 of
all three files, so the exact reference-PRNG bytes are frozen in git. These
tests close the loop the reference itself used for GPU-vs-CPU validation
(SURVEY.md section 4.3): same keys + same inputs => identical ciphertexts.
"""
import hashlib
import io as pyio
import os

import numpy as np
import pytest

import tfhe_tpu as tt
from tfhe_tpu import io as tio
from tfhe_tpu import native_ref, ref_keygen
from tfhe_tpu.core import crypt
from tfhe_tpu.core.keys import keygen_reference

HERE = os.path.dirname(os.path.abspath(__file__))
FIXED = os.path.join(HERE, "fixtures")
CACHE = os.path.join(HERE, "_fixture_cache")

BITSIZE, P1, P2 = 16, 2017, 42


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _committed_sums():
    sums = {}
    with open(os.path.join(FIXED, "SHA256SUMS")) as f:
        for line in f:
            digest, name = line.split()
            sums[name] = digest
    return sums


@pytest.fixture(scope="session")
def fixture_dir():
    """Generate (or reuse) the reference-PRNG fixture files; verify the bytes
    match the committed SHA256 pins."""
    sums = _committed_sums()
    names = ["secret.key", "cloud.key", "cloud.data"]
    if not all(os.path.exists(os.path.join(CACHE, n)) for n in names):
        ref_keygen.generate_fixture_files(CACHE, BITSIZE, P1, P2)
    for n in names:
        got = _sha256(os.path.join(CACHE, n))
        assert got == sums[n], f"{n}: generated bytes diverge from committed pin"
    return CACHE


@pytest.fixture(scope="session")
def ref_sk(fixture_dir):
    with open(os.path.join(fixture_dir, "secret.key"), "rb") as f:
        return tio.import_secret_keyset(f)


@pytest.fixture(scope="session")
def ref_ct(fixture_dir, ref_sk):
    with open(os.path.join(fixture_dir, "cloud.data"), "rb") as f:
        return tio.import_ciphertexts(f, 2 * BITSIZE, ref_sk.params.n)


def test_committed_cloud_data_matches_generated(fixture_dir):
    with open(os.path.join(FIXED, "cloud.data"), "rb") as f:
        committed = f.read()
    with open(os.path.join(fixture_dir, "cloud.data"), "rb") as f:
        generated = f.read()
    assert committed == generated


def test_secret_keyset_loads_and_decrypts(ref_sk, ref_ct):
    """io.py reads the C++-written secret.key; ciphertexts decrypt to the
    plaintexts the reference app encrypted (cpuParallel/main.cpp:38-51)."""
    params = ref_sk.params
    assert (params.n, params.N, params.k) == (500, 1024, 1)
    assert (params.bk_l, params.bk_Bgbit, params.ks_basebit, params.ks_t) == (2, 10, 2, 8)
    bits = np.asarray(crypt.decrypt_bits(ref_sk, ref_ct))
    v1 = sum(int(bits[i]) << i for i in range(BITSIZE))
    v2 = sum(int(bits[BITSIZE + i]) << i for i in range(BITSIZE))
    assert (v1, v2) == (P1, P2)


def test_keygen_reference_matches_file_keys(ref_sk):
    """In-process reference-PRNG keygen == keys loaded from the fixture file."""
    sk = keygen_reference(tt.PARAMS_110)
    np.testing.assert_array_equal(sk.lwe_key, ref_sk.lwe_key)
    np.testing.assert_array_equal(sk.tlwe_key, ref_sk.tlwe_key)
    np.testing.assert_array_equal(sk.bk_raw, ref_sk.bk_raw)
    np.testing.assert_array_equal(sk.ks_a, ref_sk.ks_a)
    np.testing.assert_array_equal(sk.ks_b, ref_sk.ks_b)


def test_cloud_keyset_loads(fixture_dir, ref_sk):
    with open(os.path.join(fixture_dir, "cloud.key"), "rb") as f:
        params, cloud = tio.import_cloud_keyset(f)
    assert params == ref_sk.params
    np.testing.assert_array_equal(np.asarray(cloud.ks_table),
                                  np.asarray(ref_sk.cloud.ks_table))
    np.testing.assert_array_equal(np.asarray(cloud.bk_ntt),
                                  np.asarray(ref_sk.cloud.bk_ntt))


def test_python_writer_byte_identical(fixture_dir):
    """tfhe_tpu.io writers produce byte-identical files to the independent C++
    serializer (two implementations of tfhe_io.cu's format agree)."""
    sk = keygen_reference(tt.PARAMS_110)
    buf = pyio.BytesIO()
    tio.export_secret_keyset(buf, sk)
    with open(os.path.join(fixture_dir, "secret.key"), "rb") as f:
        assert buf.getvalue() == f.read()
    buf = pyio.BytesIO()
    tio.export_cloud_keyset(buf, sk)
    with open(os.path.join(fixture_dir, "cloud.key"), "rb") as f:
        assert buf.getvalue() == f.read()


def test_encrypt_stream_continuation(ref_ct):
    """ref_encrypt_bits continues the engine stream exactly like the reference
    app: re-derived ciphertexts == cloud.data bytes."""
    lwe_key, *_ = ref_keygen.keygen_raw()
    bits = [(P1 >> i) & 1 for i in range(BITSIZE)] + \
           [(P2 >> i) & 1 for i in range(BITSIZE)]
    a, b = ref_keygen.encrypt_bits(lwe_key, bits)
    np.testing.assert_array_equal(a, np.asarray(ref_ct.a))
    np.testing.assert_array_equal(b, np.asarray(ref_ct.b))


def test_gates_on_reference_ciphertexts(ref_sk, ref_ct):
    """North star: the JAX pipeline under reference keys is ciphertext-exact
    vs the independent native CPU engine, and decrypts to the truth table.

    AND / XOR over the low bit-pairs of (2017, 42): the JAX gate output and
    the native C++ engine output must agree bit for bit (both exact integer
    pipelines under identical keys — the differential mechanism the reference
    used for its own GPU port, SURVEY.md section 4.3)."""
    from tfhe_tpu import gates

    npairs = 2
    x = ref_ct[:npairs]
    y = ref_ct[BITSIZE:BITSIZE + npairs]
    xa, xb = np.asarray(x.a), np.asarray(x.b)
    ya, yb = np.asarray(y.a), np.asarray(y.b)

    for gate, op in (("AND", lambda p, q: p & q), ("XOR", lambda p, q: p ^ q)):
        got = gates.gate2(gate, x, y, ref_sk.cloud)
        want_a, want_b = native_ref.gate2_batch(ref_sk, gate, xa, xb, ya, yb)
        np.testing.assert_array_equal(np.asarray(got.a), want_a)
        np.testing.assert_array_equal(np.asarray(got.b), want_b)
        bits = crypt.decrypt_bits(ref_sk, got)
        truth = [op((P1 >> i) & 1, (P2 >> i) & 1) for i in range(npairs)]
        np.testing.assert_array_equal(bits, truth)
