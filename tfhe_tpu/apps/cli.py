"""Experiment driver CLI — mirrors the reference GPU app's argv interface
(`gpuParallel/main.cu:2714-2798`: ./main <bitSize> <a> <b> <vLength>) and its
experiment suite (gates / compound / addition / multiplication / vector /
matrix), with decrypt-oracle verification after every step (testCipher,
main.cu:491-507).

Usage:
  python -m tfhe_tpu.apps.cli <bitSize> <a> <b> <vLength> [--experiments ...]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import jax

import tfhe_tpu as tt
from tfhe_tpu.config import enable_compile_cache
from tfhe_tpu import arith, gates, linalg


def _check(name, got, want):
    ok = np.array_equal(np.asarray(got), np.asarray(want))
    print(f"  {name:28s} -> {got} (expected {want}) {'OK' if ok else 'FAIL'}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("bitSize", type=int)
    ap.add_argument("a", type=int)
    ap.add_argument("b", type=int)
    ap.add_argument("vLength", type=int, nargs="?", default=4)
    ap.add_argument("--params", choices=["110", "toy", "small"], default="110")
    ap.add_argument("--experiments", nargs="*",
                    default=["gates", "add", "mul", "vector", "matrix"])
    args = ap.parse_args(argv)
    enable_compile_cache()

    if args.params != "110":
        from tfhe_tpu.apps import force_cpu_backend
        force_cpu_backend()
    params = {"110": tt.PARAMS_110, "toy": tt.PARAMS_TOY, "small": tt.PARAMS_SMALL}[args.params]
    nb, L = args.bitSize, args.vLength
    mask = (1 << nb) - 1

    def signed(v):
        v &= mask
        return v - (1 << nb) if v & (1 << (nb - 1)) else v

    print(f"keygen (seed 314/1592/657, lambda=110 params={args.params})...")
    t0 = time.time()
    sk = tt.keygen(params, seed=(314, 1592, 657))
    print(f"  {time.time()-t0:.1f} s")

    ca = arith.encrypt_int(sk, args.a, nb, seed=1)
    cb = arith.encrypt_int(sk, args.b, nb, seed=2)
    ok = True

    if "gates" in args.experiments:
        print("== gate + compound gate (test_AND_XOR_CompoundGate_Addition, main.cu:893) ==")
        t0 = time.time()
        g_and, g_xor = gates.gate2_pair("AND", "XOR", ca, cb, ca, cb, sk.cloud)
        jax.block_until_ready(g_and.b)
        print(f"  {nb}-bit AND||XOR compound batch: {time.time()-t0:.3f} s")
        ok &= _check("AND", arith.decrypt_int(sk, g_and, signed=False),
                     (args.a & args.b) & mask)
        ok &= _check("XOR", arith.decrypt_int(sk, g_xor, signed=False),
                     (args.a ^ args.b) & mask)

    if "add" in args.experiments:
        print("== addition (GPU_1 bitwise + GPU_n numberwise) ==")
        for name, fn in (("add(GPU_1)", arith.add), ("add(GPU_n)", arith.add_numberwise)):
            t0 = time.time()
            s = fn(ca, cb, sk.cloud)
            jax.block_until_ready(s.b)
            dt = time.time() - t0
            ok &= _check(f"{name} [{dt:.2f}s]", arith.decrypt_int(sk, s), signed(args.a + args.b))

    if "mul" in args.experiments:
        print("== multiplication (naive + karatsuba) ==")
        for name, fn in (("mul(naive)", arith.mul), ("mul(karatsuba)", arith.mul_karatsuba)):
            t0 = time.time()
            m = fn(ca, cb, sk.cloud)
            jax.block_until_ready(m.b)
            dt = time.time() - t0
            ok &= _check(f"{name} [{dt:.2f}s]", arith.decrypt_int(sk, m), signed(args.a * args.b))

    if "vector" in args.experiments:
        print(f"== vector ops (length {L}) ==")
        rng = np.random.RandomState(7)
        va = rng.randint(0, 1 << (nb - 2), size=L)
        vb = rng.randint(0, 1 << (nb - 2), size=L)
        cva = arith.encrypt_int(sk, va, nb, seed=3)
        cvb = arith.encrypt_int(sk, vb, nb, seed=4)
        t0 = time.time()
        vs = linalg.vector_add(cva, cvb, sk.cloud)
        jax.block_until_ready(vs.b)
        dt = time.time() - t0
        ok &= _check(f"vector add [{dt:.2f}s]", arith.decrypt_int(sk, vs),
                     [signed(int(x + y)) for x, y in zip(va, vb)])
        t0 = time.time()
        vm = linalg.vector_mul(cva, cvb, sk.cloud)
        jax.block_until_ready(vm.b)
        dt = time.time() - t0
        ok &= _check(f"vector mul [{dt:.2f}s]", arith.decrypt_int(sk, vm),
                     [signed(int(x * y)) for x, y in zip(va, vb)])

    if "matrix" in args.experiments:
        d = max(2, int(L ** 0.5))
        print(f"== {d}x{d} matrix multiply (flattened tree + Cannon) ==")
        rng = np.random.RandomState(8)
        ma = rng.randint(0, 4, size=(d, d))
        mb = rng.randint(0, 4, size=(d, d))
        cma = arith.encrypt_int(sk, ma, nb, seed=5)
        cmb = arith.encrypt_int(sk, mb, nb, seed=6)
        want = np.vectorize(signed)(ma @ mb)
        t0 = time.time()
        mm = linalg.matmul(cma, cmb, sk.cloud)
        jax.block_until_ready(mm.b)
        ok &= _check(f"matmul [{time.time()-t0:.2f}s]",
                     arith.decrypt_int(sk, mm).tolist(), want.tolist())
        t0 = time.time()
        mc = linalg.cannon_matmul(cma, cmb, sk.cloud)
        jax.block_until_ready(mc.b)
        ok &= _check(f"cannon [{time.time()-t0:.2f}s]",
                     arith.decrypt_int(sk, mc).tolist(), want.tolist())

    print("ALL OK" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
