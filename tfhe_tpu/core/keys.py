"""Key generation: secret keyset, bootstrapping key, key-switch key, cloud keyset.

Mirrors the reference keygen pipeline (`tfhe_gate_bootstrapping.cu:57-70`,
`lwe-bootstrapping-functions.cu:185-229`, `lwe-keyswitch-functions.cu:886-938`)
with a device cloud-key layout:

- The bootstrapping key is stored **in NTT domain per CRT prime** with Shoup
  precomputation (`bk_ntt`, `bk_ntt_shoup`: uint32[n, n_primes, kpl, k+1, N]),
  replacing the reference's host->device complex-FFT upload
  (`main.cu:165-213`, one cufftDoubleComplex buffer).
- The key-switch key is stored as an **int8 limb-planes matrix** so the whole
  key switch becomes one int8 MXU matmul against a one-hot digit matrix,
  replacing the reference's 84M-entry gather table (`main.cu:364-407`) and its
  per-bit replication. b is appended as an extra column.

All randomness is drawn from a jax threefry PRNG seeded deterministically, so
fixed seeds reproduce keys bit-exactly on any backend (the reference's fixed
{314,1592,657} seed semantics, `main.cu:2724-2726`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..params import TfheParams
from .. import ntt
from ..numeric import dtot32, to_u32, uniform_torus32


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class CloudKey:
    """Evaluation keys (device arrays). Pytree; `params` is static metadata."""
    params: TfheParams
    # bootstrapping key in NTT domain: uint32[n, n_primes, kpl, k+1, N]
    bk_ntt: jnp.ndarray
    bk_ntt_shoup: jnp.ndarray
    # key-switch table, int8 limb planes: [rows, n_limbs * pad_cols] where
    # rows = n_extract * t * (base-1) (C-order over (i, j, h-1)) and
    # column block l holds limb l of [a[0..n-1], b, 0-pad...].
    ks_table: jnp.ndarray

    @property
    def ks_pad_cols(self) -> int:
        return self.ks_table.shape[1] // 4


jax.tree_util.register_dataclass(
    CloudKey,
    data_fields=("bk_ntt", "bk_ntt_shoup", "ks_table"),
    meta_fields=("params",),
)


@dataclass
class SecretKeySet:
    """Secret keys + host-side raw key material (for oracle tests / serialization)."""
    params: TfheParams
    lwe_key: np.ndarray          # int32[n] in {0,1}
    tlwe_key: np.ndarray         # int32[k, N] in {0,1}
    bk_raw: np.ndarray           # int32[n, kpl, k+1, N]
    ks_a: np.ndarray             # int32[n_ext, t, base, n]
    ks_b: np.ndarray             # int32[n_ext, t, base]
    cloud: CloudKey
    seed: Any = None

    @property
    def extracted_key(self) -> np.ndarray:
        """TLWE key flattened to the extracted-LWE key (ref tLweExtractKey)."""
        return self.tlwe_key.reshape(-1)


def _seed_to_key(seed) -> jax.Array:
    if isinstance(seed, (tuple, list)):
        k = jax.random.PRNGKey(int(seed[0]) & 0x7FFFFFFF)
        for s in seed[1:]:
            k = jax.random.fold_in(k, int(s) & 0x7FFFFFFF)
        return k
    return jax.random.PRNGKey(int(seed) & 0x7FFFFFFF)


def _batched_small_polymul(small, torus):
    """Exact negacyclic product of {0,1}/small-int polys with torus polys.

    small: int32[..., N] with |coef| small; torus: int32[..., N]. Broadcasts.
    """
    return ntt.negacyclic_polymul_i32(small, torus)


def generate_bootstrapping_key(key, lwe_key, tlwe_key, params: TfheParams):
    """TGSW encryptions of each LWE key bit (ref lwe-bootstrapping-functions.cu:185-229).

    Returns int32[n, kpl, k+1, N].
    """
    n, N, k, l, kpl = params.n, params.N, params.k, params.bk_l, params.kpl
    k_a, k_noise = jax.random.split(key)
    # uniform mask polynomials for every row of every TGSW sample
    a = uniform_torus32(k_a, (n, kpl, k, N))  # int32
    if params.bk_stdev > 0.0:
        noise_f = jax.random.normal(k_noise, (n, kpl, N), dtype=jnp.float32) * params.bk_stdev
        noise = dtot32(noise_f)
    else:
        noise = jnp.zeros((n, kpl, N), jnp.int32)
    # b = noise + sum_j s_j (x) a_j   (tLweSymEncryptZero, tlwe-functions.cu:26-39)
    s = tlwe_key.astype(jnp.int32)  # [k, N]
    prods = _batched_small_polymul(s[None, None, :, :], a)  # [n, kpl, k, N]
    b = noise + jnp.sum(prods, axis=2, dtype=jnp.int32)
    bk = jnp.concatenate([a, b[:, :, None, :]], axis=2)  # [n, kpl, k+1, N]

    # add message * H on the block diagonal (tGswAddMuIntH, tgsw-functions.cu:114-123)
    msg = lwe_key.astype(jnp.int32)  # [n]
    upd = jnp.zeros((n, kpl, k + 1), jnp.int32)
    for bloc in range(k + 1):
        for p in range(l):
            upd = upd.at[:, bloc * l + p, bloc].set(msg * jnp.int32(params.h[p]))
    bk = bk.at[:, :, :, 0].add(upd)
    return bk


def bk_to_ntt_np(bk_raw: np.ndarray, params: TfheParams) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy BK -> NTT-domain conversion (no XLA on the keygen path)."""
    N = params.N
    outs, shoups = [], []
    for p in ntt.PRIMES:
        f = ntt.ntt_forward_np(ntt.i32_to_residue_np(bk_raw, p), N, p)
        outs.append(f)
        shoups.append(ntt.shoup(f, p))
    return np.stack(outs, axis=1), np.stack(shoups, axis=1)


def cloud_from_raw(params: TfheParams, bk_raw: np.ndarray, ks_a: np.ndarray,
                   ks_b: np.ndarray) -> CloudKey:
    """Build the device CloudKey layouts from raw host key material.

    Shared by keygen, the reference-PRNG keygen, and tfhe_io key import —
    the analog of the reference's key upload (`main.cu:50-507`),
    minus its per-bit KS replication (broadcasting instead). All conversion
    is numpy; only the final placement touches the accelerator.
    """
    import jax.numpy as jnp

    bk_ntt, bk_shoup = bk_to_ntt_np(np.asarray(bk_raw), params)
    ks_table = ks_to_limb_table(np.asarray(ks_a), np.asarray(ks_b), params)
    return CloudKey(
        params=params,
        bk_ntt=jnp.asarray(bk_ntt),
        bk_ntt_shoup=jnp.asarray(bk_shoup),
        ks_table=jnp.asarray(ks_table),
    )


def generate_keyswitch_key(key, ext_key, lwe_key, params: TfheParams):
    """Key-switch key from the extracted key to the LWE key
    (ref lweCreateKeySwitchKey, lwe-keyswitch-functions.cu:886-938).

    Returns (ks_a int32[n_ext, t, base, n], ks_b int32[n_ext, t, base]).
    """
    n, n_ext, t, basebit = params.n, params.n_extract, params.ks_t, params.ks_basebit
    base = params.ks_base
    sizeks = n_ext * t * (base - 1)
    k_a, k_noise = jax.random.split(key)

    # recentered gaussian noise vector (ref :897-906)
    if params.ks_stdev > 0.0:
        noise = jax.random.normal(k_noise, (sizeks,), dtype=jnp.float32) * params.ks_stdev
        noise = noise - jnp.mean(noise)
        noise_t = dtot32(noise)
    else:
        noise_t = jnp.zeros((sizeks,), jnp.int32)

    a = uniform_torus32(k_a, (sizeks, n))  # int32
    # message for row (i, j, h): ext_key[i] * h * 2^(32-(j+1)*basebit)
    hvals = jnp.arange(1, base, dtype=jnp.int32)  # [base-1]
    shifts = jnp.array([1 << (32 - (j + 1) * basebit) for j in range(t)], jnp.int32)  # [t]
    mess = (ext_key.astype(jnp.int32)[:, None, None] * hvals[None, None, :]
            * shifts[None, :, None])  # [n_ext, t, base-1]
    mess = mess.reshape(sizeks)
    b = mess + noise_t + jnp.sum(a * lwe_key.astype(jnp.int32)[None, :], axis=1, dtype=jnp.int32)

    a = a.reshape(n_ext, t, base - 1, n)
    b = b.reshape(n_ext, t, base - 1)
    # prepend the unused trivial h=0 row (ref :915)
    ks_a = jnp.concatenate([jnp.zeros((n_ext, t, 1, n), jnp.int32), a], axis=2)
    ks_b = jnp.concatenate([jnp.zeros((n_ext, t, 1), jnp.int32), b], axis=2)
    return ks_a, ks_b


def ks_to_limb_table(ks_a: np.ndarray, ks_b: np.ndarray, params: TfheParams) -> np.ndarray:
    """Pack the KS key into the int8 limb-plane matmul table.

    Rows: (i, j, h-1) C-order, h in [1, base). Columns: 4 limb planes of
    [a_0..a_{n-1}, b, pad...] padded to a multiple of 128 lanes.
    Signed base-256 digits with carry so that sum_l d_l * 2^(8l) == v (mod 2^32).
    """
    n = params.n
    n_ext, t, base = ks_a.shape[0], ks_a.shape[1], ks_a.shape[2]
    rows = n_ext * t * (base - 1)
    pad_cols = _pad_to(n + 1, 128)
    full = np.zeros((rows, pad_cols), np.uint32)
    full[:, :n] = ks_a[:, :, 1:, :].reshape(rows, n).view(np.uint32)
    full[:, n] = ks_b[:, :, 1:].reshape(rows).view(np.uint32)

    # signed digits via borrow-save: bytes of v + 0x80808080, each minus 128,
    # satisfy sum_l d_l * 2^(8l) == v (mod 2^32) with d_l in [-128, 127]
    w = full + np.uint32(0x80808080)  # uint32 wrap
    limbs = np.empty((rows, 4, pad_cols), np.int8)
    for l in range(4):
        limbs[:, l, :] = (((w >> np.uint32(8 * l)) & np.uint32(255))
                          .astype(np.int16) - np.int16(128)).astype(np.int8)
    return limbs.reshape(rows, 4 * pad_cols)


import functools


@functools.partial(jax.jit, static_argnums=(0,))
def _keygen_core(params: TfheParams, root):
    """The whole keygen dataflow as ONE jitted program (one compile)."""
    k_lwe, k_tlwe, k_bk, k_ks = jax.random.split(root, 4)
    lwe_key = jax.random.randint(k_lwe, (params.n,), 0, 2, dtype=jnp.int32)
    tlwe_key = jax.random.randint(k_tlwe, (params.k, params.N), 0, 2, dtype=jnp.int32)
    bk_raw = generate_bootstrapping_key(k_bk, lwe_key, tlwe_key, params)
    ext_key = tlwe_key.reshape(params.n_extract)
    ks_a, ks_b = generate_keyswitch_key(k_ks, ext_key, lwe_key, params)
    return lwe_key, tlwe_key, bk_raw, ks_a, ks_b


def keygen_reference(params: TfheParams, seed=(314, 1592, 657)) -> SecretKeySet:
    """Keygen with the reference's exact PRNG (native C++, ~2 s, no XLA).

    Keys are byte-identical to what the reference binaries produce from the
    same seed (`main.cu:2724-2726` -> `tfhe_gate_bootstrapping.cu:57-68`);
    see native/ref_fixtures.cpp for the draw-order derivation."""
    from .. import ref_keygen

    assert ref_keygen.params_match_reference(params), (
        "reference-PRNG keygen only exists for the reference parameter set")
    lwe_key, tlwe_key, ks_a, ks_b, bk_raw = ref_keygen.keygen_raw(seed)
    return SecretKeySet(
        params=params, lwe_key=lwe_key, tlwe_key=tlwe_key, bk_raw=bk_raw,
        ks_a=ks_a, ks_b=ks_b,
        cloud=cloud_from_raw(params, bk_raw, ks_a, ks_b), seed=seed)


def keygen(params: TfheParams, seed=(314, 1592, 657), method: str = "auto") -> SecretKeySet:
    """Generate a full secret keyset + cloud keyset (ref tfhe_gate_bootstrapping.cu:57-70).

    method:
      "reference" — the reference's std::default_random_engine draw order via
        native C++ (keys byte-identical to the reference's; reference param
        set only; no XLA involvement, ~2 s).
      "threefry"  — jax threefry derivation (any param set; deterministic
        across backends). The derivation program runs on the CPU backend,
        so the keys never depend on the accelerator.
      "auto"      — "reference" when the param set matches the reference and
        the native toolchain is available, else "threefry".
    """
    from .. import ref_keygen

    if method == "auto":
        method = "threefry"
        if ref_keygen.params_match_reference(params):
            try:
                ref_keygen.build()
                method = "reference"
            except Exception as e:
                # Key derivation is environment-dependent on the auto path:
                # the same (params, seed) yields different (mutually
                # undecryptable) keys depending on toolchain availability.
                # Surface that loudly instead of diverging silently.
                import warnings
                warnings.warn(
                    "keygen(method='auto'): native reference-PRNG build failed "
                    f"({e!r}); falling back to threefry key derivation. Keys "
                    "will NOT match reference-PRNG keys generated elsewhere — "
                    "pass method='reference' or 'threefry' explicitly when "
                    "cross-environment determinism matters.")
    if method == "reference":
        return keygen_reference(params, seed)

    root = _seed_to_key(seed)
    if jax.default_backend() != "cpu":
        cpu0 = jax.local_devices(backend="cpu")[0]
        with jax.default_device(cpu0):
            out = _keygen_core(params, jax.device_put(root, cpu0))
    else:
        out = _keygen_core(params, root)
    lwe_key, tlwe_key, bk_raw_np, ks_a_np, ks_b_np = map(np.asarray, out)

    return SecretKeySet(
        params=params,
        lwe_key=lwe_key,
        tlwe_key=tlwe_key,
        bk_raw=bk_raw_np,
        ks_a=ks_a_np,
        ks_b=ks_b_np,
        cloud=cloud_from_raw(params, bk_raw_np, ks_a_np, ks_b_np),
        seed=seed,
    )
