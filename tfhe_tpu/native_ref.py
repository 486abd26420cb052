"""ctypes bindings for the native C++ exact TFHE engine (native/tfhe_ref.cpp).

Builds the shared library on first use (g++ -O3 -fopenmp) and exposes
bootstrap/gate evaluation over numpy arrays. This is the host-side twin of the
reference's CPU framework (cpuParallel/) and the fast differential oracle for
the JAX pipeline.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from .params import TfheParams

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "tfhe_ref.cpp")
_SO = os.path.join(_NATIVE_DIR, "libtfhe_ref.so")


class _ParamsC(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int32), ("N", ctypes.c_int32), ("k", ctypes.c_int32),
                ("l", ctypes.c_int32), ("Bgbit", ctypes.c_int32),
                ("basebit", ctypes.c_int32), ("t", ctypes.c_int32)]


def build(force: bool = False) -> str:
    """Compile the native library if needed; returns the .so path."""
    if force or not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
               "-std=c++17", _SRC, "-o", _SO]
        subprocess.run(cmd, check=True, capture_output=True)
    return _SO


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(build())
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.tfhe_polymul.argtypes = [i32p, i32p, i32p, ctypes.c_int]
    lib.tfhe_bootstrap_batch.argtypes = [
        ctypes.POINTER(_ParamsC), i32p, i32p, ctypes.c_int32, i32p, i32p, i32p,
        ctypes.c_int, i32p, i32p]
    lib.tfhe_gate2_batch.argtypes = [
        ctypes.POINTER(_ParamsC), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, ctypes.c_int32, i32p, i32p, i32p,
        ctypes.c_int, i32p, i32p]
    lib.tfhe_ripple_add.argtypes = [
        ctypes.POINTER(_ParamsC), i32p, i32p, i32p, i32p,
        ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p, i32p]
    lib.tfhe_native_num_threads.restype = ctypes.c_int
    return lib


def _pc(params: TfheParams) -> _ParamsC:
    return _ParamsC(params.n, params.N, params.k, params.bk_l, params.bk_Bgbit,
                    params.ks_basebit, params.ks_t)


def polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    N = a.shape[-1]
    out = np.empty(N, np.int32)
    _lib().tfhe_polymul(np.ascontiguousarray(a, np.int32),
                        np.ascontiguousarray(b, np.int32), out, N)
    return out


def bootstrap_batch(sk, in_a: np.ndarray, in_b: np.ndarray, mu: int) -> tuple:
    """Exact batched gate bootstrap using the host keys of a SecretKeySet."""
    params = sk.params
    batch = in_b.shape[0]
    out_a = np.empty((batch, params.n), np.int32)
    out_b = np.empty(batch, np.int32)
    p = _pc(params)
    _lib().tfhe_bootstrap_batch(
        ctypes.byref(p),
        np.ascontiguousarray(in_a, np.int32), np.ascontiguousarray(in_b, np.int32),
        np.int32(mu),
        np.ascontiguousarray(sk.bk_raw, np.int32),
        np.ascontiguousarray(sk.ks_a, np.int32),
        np.ascontiguousarray(sk.ks_b, np.int32),
        batch, out_a, out_b)
    return out_a, out_b


def gate2_batch(sk, name: str, xa, xb, ya, yb) -> tuple:
    """Native bootstrapped 2-input gate batch (gate table from tfhe_tpu.gates)."""
    from .gates import GATE_TABLE, MU
    const, ca, cb = GATE_TABLE[name]
    params = sk.params
    batch = xb.shape[0]
    out_a = np.empty((batch, params.n), np.int32)
    out_b = np.empty(batch, np.int32)
    p = _pc(params)
    _lib().tfhe_gate2_batch(
        ctypes.byref(p), np.int32(const), np.int32(ca), np.int32(cb),
        np.ascontiguousarray(xa, np.int32), np.ascontiguousarray(xb, np.int32),
        np.ascontiguousarray(ya, np.int32), np.ascontiguousarray(yb, np.int32),
        np.int32(MU),
        np.ascontiguousarray(sk.bk_raw, np.int32),
        np.ascontiguousarray(sk.ks_a, np.int32),
        np.ascontiguousarray(sk.ks_b, np.int32),
        batch, out_a, out_b)
    return out_a, out_b


def ripple_add(sk, xa, xb, ya, yb) -> tuple:
    """Native n-bit ripple-carry addition of encrypted integer batches
    (cpuParallel Cipher::operator+ twin). xa: [batch, nbits, n]; xb: [batch, nbits]."""
    params = sk.params
    batch, nbits = xb.shape
    out_a = np.empty((batch, nbits, params.n), np.int32)
    out_b = np.empty((batch, nbits), np.int32)
    p = _pc(params)
    _lib().tfhe_ripple_add(
        ctypes.byref(p),
        np.ascontiguousarray(xa, np.int32), np.ascontiguousarray(xb, np.int32),
        np.ascontiguousarray(ya, np.int32), np.ascontiguousarray(yb, np.int32),
        nbits, batch,
        np.ascontiguousarray(sk.bk_raw, np.int32),
        np.ascontiguousarray(sk.ks_a, np.int32),
        np.ascontiguousarray(sk.ks_b, np.int32),
        out_a, out_b)
    return out_a, out_b


def num_threads() -> int:
    return _lib().tfhe_native_num_threads()
