"""The fused blind rotate as a CUDA kernel, called through the JAX FFI.

native/blind_rotate.cu runs the whole n-iteration CMux loop of
core/bootstrap.py:blind_rotate in one launch, one thread block per
ciphertext, bit-identical to the XLA scan. This module builds it with nvcc
into <checkout>/build on first use (or `python -m tfhe_tpu.ops.blind_rotate_cuda`),
registers it, and lays out its operands: the cloud key's bk_ntt /
bk_ntt_shoup as they are, plus one uint32 table of the twiddles and CRT
constants taken from ntt.py, so the kernel holds no constants of its own.

On a GPU, a kernel that cannot be built or loaded raises; nothing falls
back to the scan.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp

from .. import ntt
from ..params import TfheParams

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "blind_rotate.cu")
_SO = os.path.join(_ROOT, "build", "libtfhe_blind_rotate.so")
TARGET = "tfhe_blind_rotate"
# (k+1, l, N) shapes the library is compiled for (native/blind_rotate.cu).
INSTANCES = frozenset({(2, 2, 128), (2, 2, 256), (2, 2, 1024), (2, 3, 1024)})


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA blind rotate needs the CUDA toolkit "
            "(on PATH or under /usr/local/cuda)")
    return path


def build(force: bool = False) -> str:
    """Compile native/blind_rotate.cu for sm_90a if the library is missing or
    older than its source; returns the library path."""
    if (not force and os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(tmp, _SO)
    return _SO


@functools.lru_cache(maxsize=1)
def _register() -> None:
    lib = ctypes.CDLL(build())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.TfheBlindRotate), platform="CUDA")


@functools.lru_cache(maxsize=None)
def kernel_tables(N: int) -> np.ndarray:
    """uint32 operand of twiddles and CRT constants, from ntt.py.

    Per prime (ntt.PRIMES order), 4N + 4 words: psi_br, psi_br_shoup,
    ipsi_br, ipsi_br_shoup, then n_inv, n_inv_shoup, ipsi1_ninv,
    ipsi1_ninv_shoup. Then 8 words: P1, P2, P1^-1 mod P2 and its Shoup
    word, P1*P2 mod 2^32, and the two upper-half thresholds of
    ntt.crt_to_i32, then 0."""
    parts = []
    for p in ntt.PRIMES:
        t = ntt.ntt_tables(N, p)
        parts += [t["psi_br"], t["psi_br_shoup"], t["ipsi_br"], t["ipsi_br_shoup"],
                  np.array([t["n_inv"], t["n_inv_shoup"], t["ipsi1_ninv"],
                            t["ipsi1_ninv_shoup"]], np.uint32)]
    parts.append(np.array([ntt.P1, ntt.P2, ntt._INV_P1_MOD_P2, ntt._INV_P1_SHOUP,
                           ntt._M_MOD_2_32, ntt._T_HALF, ntt._R1_HALF, 0], np.uint32))
    out = np.concatenate(parts).astype(np.uint32)
    out.setflags(write=False)
    return out


def blind_rotate(acc: jnp.ndarray, bara: jnp.ndarray, bk_ntt: jnp.ndarray,
                 bk_shoup: jnp.ndarray, params: TfheParams) -> jnp.ndarray:
    """Drop-in for core.bootstrap.blind_rotate on a GPU.

    acc: int32[B, k+1, N]; bara: int32[B, n]; bk_ntt / bk_shoup:
    uint32[n, 2, kpl, k+1, N]. Returns int32[B, k+1, N]."""
    B, k1, N = acc.shape
    want_bk = (params.n, len(ntt.PRIMES), params.kpl, params.k + 1, params.N)
    if (k1, N) != (params.k + 1, params.N) or bara.shape != (B, params.n):
        raise ValueError(f"acc {acc.shape} / bara {bara.shape} do not match {params}")
    if bk_ntt.shape != want_bk or bk_shoup.shape != want_bk:
        raise ValueError(f"bootstrapping key {bk_ntt.shape}, want {want_bk}")
    if (k1, params.bk_l, N) not in INSTANCES:
        raise ValueError(f"no CUDA blind rotate compiled for (k+1, l, N) = {(k1, params.bk_l, N)}")
    _register()
    call = jax.ffi.ffi_call(TARGET, jax.ShapeDtypeStruct(acc.shape, jnp.int32),
                            vmap_method="sequential")
    return call(acc.astype(jnp.int32), bara.astype(jnp.int32), bk_ntt, bk_shoup,
                jnp.asarray(kernel_tables(N)),
                l=np.int32(params.bk_l), bgbit=np.int32(params.bk_Bgbit),
                offset=np.uint32(params.decomp_offset),
                half_bg=np.int32(params.halfBg))


if __name__ == "__main__":
    print(build(force=True))
