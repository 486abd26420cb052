"""Evaluator ("cloud") — mirrors cpuParallel/cloud.cpp.

Loads `cloud.key` + `cloud.data` (no secret key!), evaluates the requested
encrypted circuit, and writes `answer.data`.

Usage: python -m tfhe_tpu.apps.cloud [--op add|mul|min|gt] [--bits 16] [--dir .]
"""
from __future__ import annotations

import argparse
import os
import time

import jax

import tfhe_tpu as tt
from tfhe_tpu.config import enable_compile_cache
from tfhe_tpu import arith, io as tio


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", default="add",
                    choices=["add", "add_numberwise", "sub", "mul", "karatsuba",
                             "div", "min", "gt", "eq"])
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--dir", default=".")
    ap.add_argument("--platform", choices=["auto", "cpu"], default="auto",
                    help="auto = JAX's default backend; cpu for toy params")
    args = ap.parse_args(argv)
    enable_compile_cache()
    if args.platform == "cpu":
        from tfhe_tpu.apps import force_cpu_backend
        force_cpu_backend()

    key_path = os.path.join(args.dir, "cloud.key")
    with open(key_path, "rb") as f:
        params, cloud = tio.import_cloud_keyset(f)
    with open(os.path.join(args.dir, "cloud.data"), "rb") as f:
        ca = tio.import_ciphertexts(f, args.bits, params.n)
        cb = tio.import_ciphertexts(f, args.bits, params.n)

    ops = {
        "add": arith.add,
        "add_numberwise": arith.add_numberwise,
        "sub": arith.sub,
        "mul": arith.mul,
        "karatsuba": arith.mul_karatsuba,
        "div": arith.div,
        "min": arith.minimum,
        "gt": arith.gt,
        "eq": arith.eq,
    }
    t0 = time.time()
    out = ops[args.op](ca, cb, cloud)
    jax.block_until_ready(out.b)
    print(f"{args.op}: {time.time() - t0:.3f} s")

    with open(os.path.join(args.dir, "answer.data"), "wb") as f:
        tio.export_ciphertexts(f, out)
    print("wrote answer.data")


if __name__ == "__main__":
    main()
