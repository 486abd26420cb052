"""Decryptor — mirrors the reference's verify step (cpuParallel/verif.cpp-style).

Loads `secret.key` + `answer.data`, decrypts, prints the integer.

Usage: python -m tfhe_tpu.apps.verify [--bits 16] [--dir .] [--unsigned]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

import tfhe_tpu as tt
from tfhe_tpu.config import enable_compile_cache
from tfhe_tpu import io as tio


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--dir", default=".")
    ap.add_argument("--unsigned", action="store_true")
    ap.add_argument("--platform", choices=["auto", "cpu"], default="auto",
                    help="auto = JAX's default backend; cpu for toy params")
    args = ap.parse_args(argv)
    enable_compile_cache()
    if args.platform == "cpu":
        from tfhe_tpu.apps import force_cpu_backend
        force_cpu_backend()

    key_path = os.path.join(args.dir, "secret.key")
    with open(key_path, "rb") as f:
        sk = tio.import_secret_keyset(f)
    with open(os.path.join(args.dir, "answer.data"), "rb") as f:
        ct = tio.import_ciphertexts(f, args.bits, sk.params.n)

    from tfhe_tpu.core.crypt import decrypt_bits
    bits = decrypt_bits(sk, ct).astype(np.int64)
    val = int(np.sum(bits * (1 << np.arange(args.bits))))
    if not args.unsigned and bits[-1]:
        val -= 1 << args.bits
    print(val)
    return val


if __name__ == "__main__":
    main()
