#!/usr/bin/env python
"""Benchmark the full Cipher-API surface (ops the reference never published
numbers for: comparisons, division, absolute value, minimum, two's complement
— cpuParallel/Cipher.cpp). Decrypt-verifies every op; merges a `cipher_api`
table into out/bench_tables.json (or the given path).
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import jax

import tfhe_tpu as tt
from tfhe_tpu.config import enable_compile_cache
from tfhe_tpu import arith


def timed(fn, *args, n=3):
    out = fn(*args)
    np.asarray(out.b)          # hard sync (see bench_suite._sync)
    best = None
    for _ in range(n):
        t0 = time.time()
        out = fn(*args)
        np.asarray(out.b)
        best = min(best, time.time() - t0) if best else time.time() - t0
    return best, out


def main(out_path=os.path.join(ROOT, "out", "bench_tables.json")):
    enable_compile_cache()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    nb = 16
    sk = tt.keygen(tt.PARAMS_110, seed=(314, 1592, 657))
    av, bv = 1234, 567
    ca = arith.encrypt_int(sk, av, nb, seed=21)
    cb = arith.encrypt_int(sk, bv, nb, seed=22)
    rows = {}

    def rec(name, fn, want, decrypt=arith.decrypt_int):
        dt, out = timed(fn)
        got = decrypt(sk, out)
        got = int(got) if np.ndim(got) == 0 else int(np.asarray(got).reshape(-1)[0])
        assert got == want, f"{name}: {got} != {want}"
        rows[name] = round(dt, 3)
        print(f"  {name:18s} {dt:7.3f}s", flush=True)
        _persist()   # checkpoint per op: a timeout on divide keeps the rest

    def _persist():
        report = {}
        if os.path.exists(out_path):
            with open(out_path) as f:
                report = json.load(f)
        report.setdefault("cipher_api_16bit", {}).update(rows)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)

    rec("compare_gt", lambda: arith.gt(ca, cb, sk.cloud), 1,
        decrypt=lambda s, o: tt.decrypt_bits(s, o))
    rec("equal", lambda: arith.eq(ca, cb, sk.cloud), 0,
        decrypt=lambda s, o: tt.decrypt_bits(s, o))
    rec("twos_complement", lambda: arith.twos_complement(ca, sk.cloud), -av)
    rec("absolute", lambda: arith.absolute(
        arith.twos_complement(ca, sk.cloud), sk.cloud), av)
    rec("subtract", lambda: arith.sub(ca, cb, sk.cloud), av - bv)
    rec("minimum", lambda: arith.minimum(ca, cb, sk.cloud), bv)
    rec("mul_mux", lambda: arith.mul_mux(ca, cb, sk.cloud),
        ((av * bv) & 0xFFFF) - ((1 << 16) if (av * bv) & 0x8000 else 0))
    rec("divide", lambda: arith.div(ca, cb, sk.cloud), av // bv)

    _persist()
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
