#!/usr/bin/env python
"""Empirical gate noise statistics — production health check.

Runs N bootstrapped gates with REAL noise (the 110-bit parameter set), decrypts
with the secret key, and reports (a) the failure count and (b) the distribution
of the decrypted phase error relative to the +-1/8 target — the empirical
counterpart of the noise-variance bookkeeping the pipeline carries in `cv`
(and of the reference's decrypt-oracle eyeball checks, main.cu:491-507).

Usage: python tools/noise_stats.py [total_gates] [batch]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import jax

import tfhe_tpu as tt
from tfhe_tpu.config import enable_compile_cache
from tfhe_tpu import gates
from tfhe_tpu.core.crypt import decrypt_phase


def main():
    enable_compile_cache()
    total = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    params = tt.PARAMS_110
    sk = tt.keygen(params, seed=(314, 1592, 657))
    rng = np.random.RandomState(42)

    mu = float(1 << 29)  # 1/8 target amplitude
    failures = 0
    max_rel_err = 0.0
    errs = []
    done = 0
    round_i = 0
    while done < total:
        a = rng.randint(0, 2, size=batch).astype(np.int32)
        b = rng.randint(0, 2, size=batch).astype(np.int32)
        ca = tt.encrypt_bits(sk, a, seed=1000 + round_i)
        cb = tt.encrypt_bits(sk, b, seed=2000 + round_i)
        out = gates.AND(ca, cb, sk.cloud)
        got = tt.decrypt_bits(sk, out)
        want = a & b
        failures += int(np.sum(got != want))
        phase = decrypt_phase(sk, out).astype(np.float64)
        target = np.where(want != 0, mu, -mu)
        rel = np.abs(phase - target) / mu
        errs.append(rel)
        max_rel_err = max(max_rel_err, float(rel.max()))
        done += batch
        round_i += 1
        print(f"  {done}/{total} gates, failures={failures}, "
              f"max |phase err|/mu so far = {max_rel_err:.4f}", flush=True)

    rel = np.concatenate(errs)
    print(f"\ngates: {done}   failures: {failures} "
          f"(rate {failures/done:.2e})")
    print(f"|phase error|/mu: mean {rel.mean():.4f}  p99 {np.percentile(rel, 99):.4f}  "
          f"max {rel.max():.4f}   (failure threshold: 1.0 == 1/8 on the torus; "
          f"2.0 would flip the sign)")

    # --- deep-circuit noise: 3-input-gate adder chains ---------------------
    # The 2-bootstrap full adder (gates.full_adder) sums THREE bootstrapped
    # samples per affine and amplifies the sum image x2 — the noisiest phase
    # anywhere in the framework (margin 1/4 like XOR, amplitude sqrt(3/2)
    # of the old 2-input path). Exercise 31 chained carry stages (32-bit
    # adds) across a batch and report result-bit phase stats.
    from tfhe_tpu import arith
    nb, pairs = 32, 64
    av = rng.randint(0, 1 << (nb - 2), size=pairs)
    bv = rng.randint(0, 1 << (nb - 2), size=pairs)
    ca = arith.encrypt_int(sk, av, nb, seed=7000)
    cb = arith.encrypt_int(sk, bv, nb, seed=7001)
    out = arith.add(ca, cb, sk.cloud)
    got = np.asarray(arith.decrypt_int(sk, out, signed=False))
    add_fail = int(np.sum(got != (av + bv)))
    phase = decrypt_phase(sk, out).astype(np.float64)
    want_bits = ((av + bv)[:, None] >> np.arange(nb)[None, :]) & 1
    target = np.where(want_bits != 0, mu, -mu)
    rel2 = np.abs(phase - target) / mu
    print(f"\nadder chains: {pairs} x {nb}-bit adds ({pairs * (nb - 1)} MUX-carry "
          f"stages): {add_fail} wrong sums")
    print(f"result-bit |phase error|/mu: mean {rel2.mean():.4f}  "
          f"p99 {np.percentile(rel2, 99):.4f}  max {rel2.max():.4f}")


def septet_margins(total=4096, batch=256):
    """Empirical noise margins of the 7:3 compressor (gates.py septet
    section) at the 110-bit parameter set.

    The septet's three digit images ride one 7-way affine of ±1/16
    bootstrapped bits with coefficients 1/2/4; every image has effective
    margin/amplitude 1/16 (4x tighter than a standard gate's 1/8 over
    sqrt(2) inputs). Reports, per image class: the affine phase-error
    distribution (in units of its decision margin), the implied sigma, and
    the end-to-end digit failure count after the actual bootstraps.
    """
    from tfhe_tpu import arith, gates
    from tfhe_tpu.core.lwe import LweCiphertext

    params = tt.PARAMS_110
    sk = tt.keygen(params, seed=(314, 1592, 657))
    rng = np.random.RandomState(43)
    mu16 = float(gates.MU16)
    margins = {1: mu16, 2: 2 * mu16, 4: 4 * mu16}   # 1/16, 1/8, 1/4
    worst = {1: 0.0, 2: 0.0, 4: 0.0}
    sigs = {1: [], 2: [], 4: []}
    fails = 0
    done = 0
    r = 0
    while done < total:
        bits = rng.randint(0, 2, size=(batch, 7)).astype(np.int32)
        ct = tt.encrypt_bits(sk, bits, seed=5000 + r)
        # realistic compressor inputs: post-bootstrap ±1/16 bits
        ct16 = gates.gate2("OR", ct, ct, sk.cloud, mu=gates.MU16)
        u = arith._lwe_slot_sum(ct16)
        k = bits.sum(axis=1)
        digits = np.stack([k & 1, (k >> 1) & 1, (k >> 2) & 1], axis=0)
        for coeff, digit_row, sgn in ((4, 0, -1), (2, 1, -1), (1, 2, +1)):
            img = arith._lwe_scale(u, coeff)
            phase = decrypt_phase(sk, img).astype(np.int64)
            want = np.int64(coeff) * (2 * k.astype(np.int64) - 7) * int(mu16)
            err = ((phase - want + (1 << 31)) % (1 << 32)) - (1 << 31)
            rel = np.abs(err) / margins[coeff]
            worst[coeff] = max(worst[coeff], float(rel.max()))
            sigs[coeff].append(err / margins[coeff])
            out = gates.bootstrap_images(
                img, np.full(batch, sgn * gates.MU16, np.int32), sk.cloud)
            got = tt.decrypt_bits(sk, out)
            fails += int(np.sum(got != digits[digit_row]))
        done += batch
        r += 1
        print(f"  {done}/{total} septets, digit failures={fails}, "
              f"worst |err|/margin: c1={worst[1]:.3f} c2={worst[2]:.3f} "
              f"c4={worst[4]:.3f}", flush=True)
    for coeff in (1, 2, 4):
        e = np.concatenate(sigs[coeff])
        sig = float(e.std())
        print(f"coeff {coeff}: sigma = {sig:.4f} margins -> z = {1.0/sig:.2f} "
              f"(pre-modswitch), max |err|/margin = {worst[coeff]:.3f}")
    print(f"end-to-end digit failures: {fails} / {3 * done} images "
          f"(rate {fails / (3 * done):.2e})")


if __name__ == "__main__":
    if "--septet" in sys.argv:
        sys.argv.remove("--septet")
        septet_margins(int(sys.argv[1]) if len(sys.argv) > 1 else 4096,
                       int(sys.argv[2]) if len(sys.argv) > 2 else 256)
    else:
        main()
