#!/usr/bin/env python
"""Linear-regression application benchmark — paper Table X parity.

Runs the paper's section VI-G workload end-to-end on encrypted data at a
published configuration (dataset 1: 200 rows x 10 attributes) and records a
`linreg` section into out/bench_tables.json next to Table X's GPU minutes
(binary 53.91 min, numerical 163.38 min).

The reference never released this code; the app (tfhe_tpu/apps/linreg.py)
reconstructs the computation the paper describes — normal-equation terms by
homomorphic sums/products, then encrypted division — with the 10 attribute
columns fitted as ONE batched regression (leading batch axis; the batched
analog of the paper running per-attribute fits).

Verification: every encrypted result is decrypted and compared against a
plaintext twin that applies the identical fixed-width circuit semantics
(mod-2^nbits signed truncation at each step, C-style truncated division) —
the decrypt-oracle method of main.cu:491-507.

Usage: python tools/bench_linreg.py [--rows 200] [--attrs 10] [--bits 16]
                                    [--variant binary numerical]
"""
import argparse
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
from tfhe_tpu.apps import linreg

REF_GPU_MIN = {"binary": 53.91, "numerical": 163.38}   # Table X, 200x10


def _signed(v, nb):
    v = int(v) & ((1 << nb) - 1)
    return v - (1 << nb) if v & (1 << (nb - 1)) else v


def _twin_div(num, den, nb):
    """Plaintext twin of arith.div: the exact width-limited restoring loop
    (Cipher.cpp:508-577 semantics) — including its division-by-zero output
    (the restore never fires, so the quotient bits come out all ones) and
    the mod-2^nb sign-bit compare, then the XOR-sign conditional negate."""
    m = (1 << nb) - 1
    num, den = _signed(num, nb), _signed(den, nb)
    an = (-num if num < 0 else num) & m
    ad = (-den if den < 0 else den) & m
    neg_b = (-ad) & m
    P, A = 0, an
    for _ in range(nb):
        P = ((P << 1) | (A >> (nb - 1))) & m
        A = (A << 1) & m
        temp = (P + neg_b) & m
        neg = (temp >> (nb - 1)) & 1            # sign bit of the mod-2^nb sum
        A |= 1 - neg
        if not neg:
            P = temp
    q = A
    if (num < 0) != (den < 0):                  # addSign: conditional negate
        q = (-q) & m
    return _signed(q, nb)


def _twin(xs, ys, nb, binary):
    """Plaintext circuit twin: same widths, same truncation, per attribute."""
    n_rows = xs.shape[1]
    m = (1 << nb) - 1
    out = []
    for a in range(xs.shape[0]):
        x, y = xs[a].astype(np.int64), ys.astype(np.int64)
        sx = int(np.sum(x)) & m
        sy = int(np.sum(y)) & m
        sxy = int(np.sum((x * y) & m)) & m if not binary else int(np.sum(np.where(x != 0, y, 0))) & m
        sxx = int(np.sum((x * x) & m)) & m if not binary else sx
        n_sxy = (n_rows * sxy) & m
        n_sxx = (n_rows * sxx) & m
        sx_sy = (sx * sy) & m
        sx_sx = (sx * sx) & m
        num = (n_sxy - sx_sy) & m
        den = (n_sxx - sx_sx) & m
        b1 = _twin_div(num, den, nb)
        b1_sx = (b1 * sx) & m
        b0_num = (sy - b1_sx) & m
        b0 = _twin_div(b0_num, n_rows & m, nb)
        out.append((b1, b0))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200)
    ap.add_argument("--attrs", type=int, default=10)
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--variant", nargs="*", default=["binary"])
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "bench_tables.json"))
    ap.add_argument("--params", default="110", choices=["110", "toy"],
                    help="'toy' = noiseless small ring for a CPU smoke run "
                         "of the full bench path (no ref comparison)")
    args = ap.parse_args(argv)
    R, A, nb = args.rows, args.attrs, args.bits

    enable_compile_cache()
    if args.params == "toy":
        # CPU smoke mode: CPU for toy params
        jax.config.update("jax_platforms", "cpu")
    print(f"device: {jax.devices()[0]}", flush=True)
    t0 = time.time()
    params = tt.PARAMS_110 if args.params == "110" else tt.PARAMS_TOY
    sk = tt.keygen(params, seed=(314, 1592, 657))
    print(f"keygen: {time.time()-t0:.1f}s", flush=True)

    rng = np.random.RandomState(7)
    ys = rng.randint(0, 1 << 6, size=R)          # 6-bit fixed-point targets

    rows = {}
    for variant in args.variant:
        binary = variant == "binary"
        if binary:
            xs = rng.randint(0, 2, size=(A, R))
            from tfhe_tpu.core.crypt import encrypt_bits
            cx = encrypt_bits(sk, xs.astype(np.int32), seed=92)
            cy_b = arith.encrypt_int(sk, np.broadcast_to(ys, (A, R)), nb, seed=93)
            t0 = time.time()
            b1, b0 = linreg.linear_regression_binary(cx, cy_b, sk.cloud)
            got1 = np.asarray(arith.decrypt_int(sk, b1))
            got0 = np.asarray(arith.decrypt_int(sk, b0))
            dt = time.time() - t0
        else:
            xs = rng.randint(0, 1 << 6, size=(A, R))
            cx = arith.encrypt_int(sk, xs, nb, seed=94)
            cy_b = arith.encrypt_int(sk, np.broadcast_to(ys, (A, R)), nb, seed=95)
            t0 = time.time()
            b1, b0 = linreg.linear_regression(cx, cy_b, sk.cloud)
            got1 = np.asarray(arith.decrypt_int(sk, b1))
            got0 = np.asarray(arith.decrypt_int(sk, b0))
            dt = time.time() - t0
        want = _twin(xs, ys, nb, binary)
        for a in range(A):
            assert (int(got1[a]), int(got0[a])) == want[a], \
                f"{variant} attr {a}: got ({got1[a]}, {got0[a]}), want {want[a]}"
        # Toy-ring smoke runs are wiring checks, not measurements: never
        # attach the Table-X reference or a speedup to them.
        ref = (REF_GPU_MIN.get(variant)
               if (R, A) == (200, 10) and args.params == "110" else None)
        rows[variant] = {
            "s": round(dt, 1), "minutes": round(dt / 60, 2),
            "rows": R, "attrs": A, "bits": nb,
            "ref_gpu_min": ref,
            "speedup": round(ref * 60 / dt, 2) if ref else None}
        print(f"  linreg {variant} {R}x{A} ({nb}-bit): {dt:.1f}s = {dt/60:.2f} min "
              f"(ref {ref} min) — all {A} fits decrypt-verified", flush=True)
        # persist after EVERY variant: a timeout on the slow numerical run
        # must not lose the already-measured binary row
        if args.params == "110":
            report = {}
            if os.path.exists(args.out):
                with open(args.out) as f:
                    report = json.load(f)
            report.setdefault("linreg", {}).update(rows)
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2)
            print(f"wrote {args.out}")

    if args.params != "110":
        print("toy params: smoke run only, not recording into", args.out)


if __name__ == "__main__":
    main()
