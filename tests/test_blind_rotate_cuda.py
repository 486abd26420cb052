"""The CUDA blind rotate's Python side: its operand tables against ntt.py,
shape checks, routing, and (on a GPU) the kernel against the XLA scan."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tfhe_tpu import ntt
from tfhe_tpu.core import bootstrap as bs
from tfhe_tpu.ops import blind_rotate_cuda as brc


@pytest.mark.parametrize("N", [128, 1024])
def test_kernel_tables_match_ntt(N):
    tab = brc.kernel_tables(N)
    stride = 4 * N + 4
    assert tab.dtype == np.uint32 and tab.shape == (2 * stride + 8,)
    for q, p in enumerate(ntt.PRIMES):
        t = ntt.ntt_tables(N, p)
        blk = tab[q * stride:(q + 1) * stride]
        for s, key in enumerate(("psi_br", "psi_br_shoup", "ipsi_br", "ipsi_br_shoup")):
            np.testing.assert_array_equal(blk[s * N:(s + 1) * N], t[key])
        assert list(blk[4 * N:]) == [t["n_inv"], t["n_inv_shoup"], t["ipsi1_ninv"],
                                     t["ipsi1_ninv_shoup"]]
    consts = [int(v) for v in tab[2 * stride:]]
    assert consts[:2] == list(ntt.PRIMES)
    # the constants lift residues exactly as ntt.crt_to_i32 does
    p1, p2, inv, inv_sh, m_mod, t_half, r1_half, _ = consts
    assert (p1 * inv) % p2 == 1 and inv_sh == (inv << 32) // p2
    assert m_mod == (p1 * p2) % (1 << 32)
    assert (t_half, r1_half) == ((p2 - 1) // 2, (p1 + 1) // 2)


def test_wrapper_rejects_mismatched_shapes(toy_keys):
    params, cloud = toy_keys.params, toy_keys.cloud
    acc = jnp.zeros((2, params.k + 1, params.N), jnp.int32)
    with pytest.raises(ValueError):
        brc.blind_rotate(acc, jnp.zeros((2, params.n + 1), jnp.int32),
                         cloud.bk_ntt, cloud.bk_ntt_shoup, params)
    with pytest.raises(ValueError):
        brc.blind_rotate(acc, jnp.zeros((2, params.n), jnp.int32),
                         cloud.bk_ntt[:-1], cloud.bk_ntt_shoup[:-1], params)


def test_gpu_routing_raises_without_library(toy_keys, monkeypatch, tmp_path):
    """On a GPU the blind rotate is the kernel; if it cannot be built the
    call raises instead of falling back to the scan."""
    params, cloud = toy_keys.params, toy_keys.cloud
    monkeypatch.setattr(brc, "_SO", str(tmp_path / "missing.so"))
    monkeypatch.setattr(brc, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    brc._register.cache_clear()
    acc = jnp.zeros((1, params.k + 1, params.N), jnp.int32)
    bara = jnp.zeros((1, params.n), jnp.int32)
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            bs.blind_rotate_device(acc, bara, cloud, params)
    finally:
        brc._register.cache_clear()


def test_cpu_routing_is_the_scan(toy_keys):
    params, cloud = toy_keys.params, toy_keys.cloud
    rng = np.random.RandomState(9)
    acc = jnp.asarray(rng.randint(-(2 ** 31), 2 ** 31, size=(2, params.k + 1, params.N)),
                      jnp.int32)
    bara = jnp.asarray(rng.randint(0, 2 * params.N, size=(2, params.n)), jnp.int32)
    got = bs.blind_rotate_device(acc, bara, cloud, params)
    want = bs.blind_rotate(acc, bara, cloud.bk_ntt, cloud.bk_ntt_shoup, params)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 65, 300])
def test_kernel_matches_scan_on_gpu(gpu, toy_keys, B):
    params, cloud = toy_keys.params, toy_keys.cloud
    rng = np.random.RandomState(B)
    acc = jnp.asarray(rng.randint(-(2 ** 31), 2 ** 31, size=(B, params.k + 1, params.N)),
                      jnp.int32)
    bara = jnp.asarray(rng.randint(0, 2 * params.N, size=(B, params.n)), jnp.int32)
    got = brc.blind_rotate(acc, bara, cloud.bk_ntt, cloud.bk_ntt_shoup, params)
    want = bs.blind_rotate(acc, bara, cloud.bk_ntt, cloud.bk_ntt_shoup, params)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
