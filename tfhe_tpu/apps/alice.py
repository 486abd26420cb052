"""Key generator / encryptor ("Alice") — mirrors cpuParallel/main.cpp:11-82.

Generates the secret + cloud keysets with the reference's fixed seed, writes
`secret.key` / `cloud.key`, encrypts the two argv integers bit-by-bit, and
writes them to `cloud.data` — the reference's client/cloud trust split.

Usage: python -m tfhe_tpu.apps.alice <a> <b> [--bits 16] [--dir .]
"""
from __future__ import annotations

import argparse
import os

import tfhe_tpu as tt
from tfhe_tpu.config import enable_compile_cache
from tfhe_tpu import arith, io as tio


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=int)
    ap.add_argument("b", type=int)
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--dir", default=".")
    ap.add_argument("--params", choices=["110", "toy"], default="110")
    args = ap.parse_args(argv)
    enable_compile_cache()

    if args.params == "toy":
        from tfhe_tpu.apps import force_cpu_backend
        force_cpu_backend()
    params = tt.PARAMS_110 if args.params == "110" else tt.PARAMS_TOY
    # reference seed semantics (main.cu:2724-2726, cpuParallel/main.cpp:21-22)
    sk = tt.keygen(params, seed=(314, 1592, 657))

    os.makedirs(args.dir, exist_ok=True)
    with open(os.path.join(args.dir, "secret.key"), "wb") as f:
        tio.export_secret_keyset(f, sk)
    with open(os.path.join(args.dir, "cloud.key"), "wb") as f:
        tio.export_cloud_keyset(f, sk)

    ca = arith.encrypt_int(sk, args.a, args.bits, seed=1)
    cb = arith.encrypt_int(sk, args.b, args.bits, seed=2)
    with open(os.path.join(args.dir, "cloud.data"), "wb") as f:
        tio.export_ciphertexts(f, ca)
        tio.export_ciphertexts(f, cb)
    print(f"wrote secret.key, cloud.key, cloud.data ({args.bits}-bit a={args.a} b={args.b})")


if __name__ == "__main__":
    main()
