#!/usr/bin/env python
"""Full benchmark suite — reproduces the reference paper's experiment tables.

Mirrors the experiment drivers of `gpuParallel/main.cu:893-2711` (gate batches,
compound gates, adders, multipliers, vector ops, matrix multiply) and reports
side-by-side against the published GTX-1080 numbers in BASELINE.md (paper
Tables IV-IX). Every measurement decrypt-verifies its result against plain
int semantics before being recorded (the reference's decrypt-oracle method,
`main.cu:491-507`).

Usage:
  python tools/bench_suite.py [--exp gates add mul vector matmul]
                              [--out out/bench_tables.json]

Writes a JSON report and prints a markdown summary.
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
from tfhe_tpu import arith, gates, linalg
from tfhe_tpu.config import enable_compile_cache

# Reference GPU numbers (GTX 1080; BASELINE.md, paper Tables IV-IX), seconds.
REF_GPU = {
    "gate_batch": {2: 0.02274, 4: 0.02163, 8: 0.03058, 16: 0.04406, 32: 0.07050},
    # Table IV per-phase decomposition (ms -> s): (BS, KS, misc)
    "gate_phases": {2: (0.01964, 0.00265, 0.00045), 4: (0.01886, 0.00269, 0.00008),
                    8: (0.02783, 0.00269, 0.00006), 16: (0.04070, 0.00291, 0.00044),
                    32: (0.06674, 0.00334, 0.00042)},
    "add_bitwise": {16: 0.98, 24: 1.47, 32: 1.99},
    "add_numberwise": {16: 0.94, 24: 2.55, 32: 4.44},
    "mul_naive": {16: 11.16, 24: 22.08, 32: 33.99},
    "mul_karatsuba": {16: 7.6708, 32: 24.62},
    "vector_add_16bit": {4: 1.27, 8: 1.78, 16: 2.82, 32: 5.41},
    "vector_add_32bit": {4: 2.56, 8: 3.58, 16: 5.70, 32: 11.22},   # Table VI
    "vector_mul_16bit": {4: 24.6, 8: 45.0, 16: 84.0, 32: 160.8},  # minutes->s (Table VIII)
    "vector_mul_32bit": {4: 96.6, 8: 177.6, 16: 337.2, 32: 647.4},  # Table VIII
    "matmul_16bit": {2: 51.6, 4: 354.0, 8: 2637.0, 16: 11173.8},  # Table IX (s)
}


import contextlib


@contextlib.contextmanager
def _env(key, value):
    prev = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if prev is None:
            del os.environ[key]
        else:
            os.environ[key] = prev


def _sync(out):
    """Hard sync: device->host fetch of the result."""
    np.asarray(out.b if hasattr(out, "b") else out)


def _timed(fn, *args, warmup=True):
    """Compile+run once (warmup), then time one execution."""
    if warmup:
        out = fn(*args)
        _sync(out)
    t0 = time.time()
    out = fn(*args)
    _sync(out)
    return time.time() - t0, out


def _signed(v, nb):
    v = int(v) & ((1 << nb) - 1)
    return v - (1 << nb) if v & (1 << (nb - 1)) else v


def _timed_chain(fn, x, y, iters=20):
    """Steady-state latency of a *dependent* gate chain: warm the chain
    (compiles AND output-layout recompiles), then time `iters` serially
    dependent calls (out <- fn(out, y)) ending with a device->host fetch
    inside the timed region.

    This is the latency a gate has inside a circuit (the adders/multipliers
    run exactly such chains), the reference's measurement conditions."""
    out = fn(x, y)
    for _ in range(3):   # warm the chained signature (jit + layouts)
        out = fn(out, y)
    np.asarray(out.b)
    t0 = time.time()
    for _ in range(iters):
        out = fn(out, y)
    np.asarray(out.b)    # fetch = hard sync inside the timed region
    return (time.time() - t0) / iters, out


def bench_gates(sk, report):
    """Table IV: one coalesced AND batch of n bits, n in {2,4,8,16,32}.

    `s` is steady-state chained-gate latency (see _timed_chain); the
    single-dispatch wall time is kept as `single_shot_s`."""
    rows = {}
    for nb in (2, 4, 8, 16, 32):
        rng = np.random.RandomState(nb)
        a = rng.randint(0, 2, size=nb).astype(np.int32)
        b = rng.randint(0, 2, size=nb).astype(np.int32)
        ca = tt.encrypt_bits(sk, a, seed=100 + nb)
        cb = tt.encrypt_bits(sk, b, seed=200 + nb)
        fn = lambda x, y: gates.AND(x, y, sk.cloud)
        dt1, out = _timed(fn, ca, cb)
        dt, out = _timed_chain(fn, ca, cb)
        # chain of 11 ANDs with constant b: out = a & b after the chain
        got = tt.decrypt_bits(sk, out)
        assert np.array_equal(got, a & b), f"gate batch {nb} mismatch"
        ref = REF_GPU["gate_batch"].get(nb)
        rows[nb] = {"s": round(dt, 5), "single_shot_s": round(dt1, 5),
                    "ref_gpu_s": ref,
                    "speedup": round(ref / dt, 2) if ref else None}
        print(f"  AND batch {nb:3d} bits: {dt*1e3:8.1f} ms steady / {dt1*1e3:.1f} ms single  (ref GPU {ref*1e3 if ref else 0:.1f} ms)", flush=True)
    report["gate_batch"] = rows


def bench_phases(sk, report):
    """Table IV parity: per-phase gate decomposition (blind rotate + extract /
    key switch / misc) for each width, measured as steady-state chained
    latencies of each phase alone (the reference brackets the same phases at
    lwe-bootstrapping-functions-fft.cu:1941-1968)."""
    import jax.numpy as jnp
    from tfhe_tpu.core import bootstrap as bs
    from tfhe_tpu.core.lwe import LweCiphertext

    rows = {}
    const, cfa, cfb = gates.GATE_TABLE["AND"]

    @jax.jit
    def woks_step(dep, tv, cloud):
        x = LweCiphertext(tv.a, tv.b + 0 * dep[: tv.b.shape[0]], tv.cv)
        a_ext, b_ext, cv = bs.bootstrap_woks(x, jnp.int32(gates.MU), cloud)
        return b_ext

    @jax.jit
    def ks_step(dep, a_ext, b_ext, cv, cloud):
        out = bs.key_switch(a_ext + (0 * dep)[:, None], b_ext,
                            cloud.ks_table, cv, cloud.params)
        return out.b

    def chain(step, dep0, iters=20):
        dep = step(dep0)
        for _ in range(3):
            dep = step(dep)
        np.asarray(dep)
        t0 = time.time()
        for _ in range(iters):
            dep = step(dep)
        np.asarray(dep)
        return (time.time() - t0) / iters

    for nb in (2, 4, 8, 16, 32):
        rng = np.random.RandomState(nb)
        a = rng.randint(0, 2, size=nb).astype(np.int32)
        b = rng.randint(0, 2, size=nb).astype(np.int32)
        ca = tt.encrypt_bits(sk, a, seed=1500 + nb)
        cb = tt.encrypt_bits(sk, b, seed=1600 + nb)
        tv = gates._affine2(ca, cb, jnp.int32(const), jnp.int32(cfa), jnp.int32(cfb))
        a_ext, b_ext, cv = jax.jit(
            lambda t, c: bs.bootstrap_woks(t, jnp.int32(gates.MU), c))(tv, sk.cloud)
        jax.block_until_ready(b_ext)

        dep0 = jnp.zeros((nb,), jnp.int32)
        t_bs = chain(lambda d: woks_step(d, tv, sk.cloud), dep0)
        t_ks = chain(lambda d: ks_step(d, a_ext, b_ext, cv, sk.cloud), dep0)
        t_full, out = _timed_chain(lambda x, y: gates.AND(x, y, sk.cloud), ca, cb)
        assert np.array_equal(tt.decrypt_bits(sk, out), a & b)
        misc = max(t_full - t_bs - t_ks, 0.0)
        rbs, rks, rmisc = REF_GPU["gate_phases"][nb]
        rows[nb] = {"bs_s": round(t_bs, 5), "ks_s": round(t_ks, 5),
                    "misc_s": round(misc, 5), "total_s": round(t_full, 5),
                    "ref_gpu_bs_s": rbs, "ref_gpu_ks_s": rks, "ref_gpu_misc_s": rmisc}
        print(f"  phases {nb:3d} bits: BS {t_bs*1e3:7.1f} ms  KS {t_ks*1e3:6.1f} ms  "
              f"misc {misc*1e3:5.1f} ms  total {t_full*1e3:7.1f} ms  "
              f"(ref BS {rbs*1e3:.1f} KS {rks*1e3:.2f})", flush=True)
    report["gate_phases"] = rows


def bench_compound(sk, report):
    """Fig. 5c: compound gate (AND||XOR in ONE bootstrap batch) vs 2 sequential
    gates, 16-bit operands."""
    nb = 16
    rng = np.random.RandomState(9)
    a = rng.randint(0, 2, size=nb).astype(np.int32)
    b = rng.randint(0, 2, size=nb).astype(np.int32)
    ca = tt.encrypt_bits(sk, a, seed=1300)
    cb = tt.encrypt_bits(sk, b, seed=1400)

    def compound(x, y):
        return gates.gate2_pair("AND", "XOR", x, y, x, y, sk.cloud)

    def sequential(x, y):
        return gates.AND(x, y, sk.cloud), gates.XOR(x, y, sk.cloud)

    def chain2(fn, iters=30):
        o1, o2 = fn(ca, cb)
        for _ in range(3):
            o1, o2 = fn(o1, o2)
        np.asarray(o1.b), np.asarray(o2.b)
        t0 = time.time()
        for _ in range(iters):
            o1, o2 = fn(o1, o2)
        np.asarray(o1.b), np.asarray(o2.b)   # hard sync inside timed region
        return (time.time() - t0) / iters, (o1, o2)

    dt_c1, (g_and, g_xor) = _timed_multi(compound, ca, cb)
    assert np.array_equal(tt.decrypt_bits(sk, g_and), a & b)
    assert np.array_equal(tt.decrypt_bits(sk, g_xor), a ^ b)
    dt_c, _ = chain2(compound)
    dt_s1, _ = _timed_multi(sequential, ca, cb)
    dt_s, _ = chain2(sequential)
    report["compound_gate"] = {
        "compound_s": round(dt_c, 4), "sequential_2_gates_s": round(dt_s, 4),
        "compound_single_shot_s": round(dt_c1, 4),
        "sequential_single_shot_s": round(dt_s1, 4),
        "ref_gpu_compound_s": 0.02, "ref_gpu_sequential_s": 0.04}
    print(f"  AND||XOR compound: {dt_c*1e3:.1f} ms   2 sequential: {dt_s*1e3:.1f} ms  "
          f"(single-shot {dt_c1*1e3:.1f} / {dt_s1*1e3:.1f} ms)", flush=True)


def _timed_multi(fn, *args):
    out = fn(*args)
    for o in out:
        _sync(o)
    t0 = time.time()
    out = fn(*args)
    for o in out:
        _sync(o)
    return time.time() - t0, out


def bench_add(sk, report):
    """Table V: n-bit addition, bitwise (GPU_1) and number-wise (GPU_n)."""
    rows = {}
    for nb in (16, 24, 32):
        rng = np.random.RandomState(nb)
        a, b = [int(x) for x in rng.randint(0, 1 << (nb - 2), size=2)]
        ca = arith.encrypt_int(sk, a, nb, seed=300 + nb)
        cb = arith.encrypt_int(sk, b, nb, seed=400 + nb)
        dt1, out1 = _timed(lambda x, y: arith.add(x, y, sk.cloud), ca, cb)
        assert int(arith.decrypt_int(sk, out1)) == _signed(a + b, nb)
        dtn, outn = _timed(lambda x, y: arith.add_numberwise(x, y, sk.cloud), ca, cb)
        assert int(arith.decrypt_int(sk, outn)) == _signed(a + b, nb)
        r1, rn = REF_GPU["add_bitwise"].get(nb), REF_GPU["add_numberwise"].get(nb)
        rows[nb] = {"bitwise_s": round(dt1, 3), "numberwise_s": round(dtn, 3),
                    "ref_bitwise_s": r1, "ref_numberwise_s": rn,
                    "speedup_bitwise": round(r1 / dt1, 2) if r1 else None}
        # A/B the serial-depth lever (round-3 Kogge-Stone prefix adder vs the
        # 2-bootstrap ripple) so the auto policy's win/loss is a recorded fact
        for flag, key in (("0", "ab_ripple_s"), ("1", "ab_prefix_s")):
            with _env("TFHE_TPU_LOOKAHEAD", flag):
                dtab, outab = _timed(lambda x, y: arith.add(x, y, sk.cloud), ca, cb)
            assert int(arith.decrypt_int(sk, outab)) == _signed(a + b, nb)
            rows[nb][key] = round(dtab, 3)
        print(f"  add {nb}-bit: GPU_1 {dt1:6.3f}s (ref {r1}s)  GPU_n {dtn:6.3f}s (ref {rn}s)  "
              f"[A/B ripple {rows[nb]['ab_ripple_s']}s prefix {rows[nb]['ab_prefix_s']}s]", flush=True)
    report["add"] = rows


def bench_mul(sk, report):
    """Table VII: n-bit multiplication, naive shift-add and Karatsuba."""
    rows = {}
    for nb in (16, 24, 32):
        rng = np.random.RandomState(nb)
        a, b = [int(x) for x in rng.randint(0, 1 << (nb // 2 - 1), size=2)]
        ca = arith.encrypt_int(sk, a, nb, seed=500 + nb)
        cb = arith.encrypt_int(sk, b, nb, seed=600 + nb)
        dtn, outn = _timed(lambda x, y: arith.mul(x, y, sk.cloud), ca, cb)
        assert int(arith.decrypt_int(sk, outn)) == _signed(a * b, nb)
        dtk, outk = _timed(lambda x, y: arith.mul_karatsuba(x, y, sk.cloud), ca, cb)
        assert int(arith.decrypt_int(sk, outk)) == _signed(a * b, nb)
        rn, rk = REF_GPU["mul_naive"].get(nb), REF_GPU["mul_karatsuba"].get(nb)
        rows[nb] = {"naive_s": round(dtn, 3), "karatsuba_s": round(dtk, 3),
                    "ref_naive_s": rn, "ref_karatsuba_s": rk,
                    "speedup_naive": round(rn / dtn, 2) if rn else None}
        if nb in (16, 24, 32):
            # A/B: the 7:3 septet compressor vs the pure full-adder tree,
            # both FORCED (naive_s above is whatever the width-aware default
            # dispatch picks at this commit).
            with _env("TFHE_TPU_SEPTET", "0"):
                dtf, outf = _timed(lambda x, y: arith.mul(x, y, sk.cloud), ca, cb)
            assert int(arith.decrypt_int(sk, outf)) == _signed(a * b, nb)
            rows[nb]["naive_fa_s"] = round(dtf, 3)
            with _env("TFHE_TPU_SEPTET", "1"):
                dts, outs = _timed(lambda x, y: arith.mul(x, y, sk.cloud), ca, cb)
            assert int(arith.decrypt_int(sk, outs)) == _signed(a * b, nb)
            rows[nb]["naive_septet_s"] = round(dts, 3)
        print(f"  mul {nb}-bit: naive {dtn:7.3f}s (ref {rn}s)  karatsuba {dtk:7.3f}s (ref {rk}s)", flush=True)
    report["mul"] = rows


def bench_vector(sk, report):
    """Tables VI+VIII, BOTH width columns (16- and 32-bit) over lengths 4..32,
    plus BASELINE config 4's 64-element vector add + compare (the paper
    publishes no GPU compare number; the measured row stands alone)."""
    for nb in (16, 32):
        rows_add, rows_mul = {}, {}
        for L in (4, 8, 16, 32):
            rng = np.random.RandomState(L + nb)
            va = rng.randint(0, 1 << (nb - 2), size=L)
            vb = rng.randint(0, 1 << (nb - 2), size=L)
            cva = arith.encrypt_int(sk, va, nb, seed=700 + L + nb)
            cvb = arith.encrypt_int(sk, vb, nb, seed=800 + L + nb)
            dta, outa = _timed(lambda x, y: linalg.vector_add(x, y, sk.cloud), cva, cvb)
            assert np.array_equal(arith.decrypt_int(sk, outa),
                                  [_signed(int(x + y), nb) for x, y in zip(va, vb)])
            ra = REF_GPU[f"vector_add_{nb}bit"].get(L)
            rows_add[L] = {"s": round(dta, 3), "ref_gpu_s": ra,
                           "speedup": round(ra / dta, 2) if ra else None}
            print(f"  vec add  {nb}b L={L:2d}: {dta:7.3f}s (ref {ra}s)", flush=True)
        for L in (4, 8, 16, 32):
            rng = np.random.RandomState(L + nb)
            va = rng.randint(0, 1 << (nb // 2 - 1), size=L)
            vb = rng.randint(0, 1 << (nb // 2 - 1), size=L)
            cva = arith.encrypt_int(sk, va, nb, seed=900 + L + nb)
            cvb = arith.encrypt_int(sk, vb, nb, seed=1000 + L + nb)
            dtm, outm = _timed(lambda x, y: linalg.vector_mul(x, y, sk.cloud), cva, cvb)
            assert np.array_equal(arith.decrypt_int(sk, outm),
                                  [_signed(int(x * y), nb) for x, y in zip(va, vb)])
            rm = REF_GPU[f"vector_mul_{nb}bit"].get(L)
            rows_mul[L] = {"s": round(dtm, 3), "ref_gpu_s": rm,
                           "speedup": round(rm / dtm, 2) if rm else None}
            print(f"  vec mul  {nb}b L={L:2d}: {dtm:7.3f}s (ref {rm}s)", flush=True)
        suffix = "" if nb == 16 else "_32bit"
        report["vector_add" + suffix] = rows_add
        report["vector_mul" + suffix] = rows_mul

    # BASELINE config 4: 64-element vector add + compare, 16-bit
    nb, L = 16, 64
    rng = np.random.RandomState(64)
    va = rng.randint(0, 1 << (nb - 2), size=L)
    vb = rng.randint(0, 1 << (nb - 2), size=L)
    cva = arith.encrypt_int(sk, va, nb, seed=7164)
    cvb = arith.encrypt_int(sk, vb, nb, seed=7264)
    dta, outa = _timed(lambda x, y: linalg.vector_add(x, y, sk.cloud), cva, cvb)
    assert np.array_equal(arith.decrypt_int(sk, outa),
                          [_signed(int(x + y), nb) for x, y in zip(va, vb)])
    dtc, outc = _timed(lambda x, y: arith.gt(x, y, sk.cloud), cva, cvb)
    got = tt.decrypt_bits(sk, outc)
    assert np.array_equal(got, (va > vb).astype(np.int32))
    report["vector64"] = {"add_s": round(dta, 3), "compare_s": round(dtc, 3),
                          "elements": L, "bits": nb, "ref_gpu_s": None}
    print(f"  vec64 16b: add {dta:.3f}s  compare {dtc:.3f}s", flush=True)


def bench_matmul(sk, report):
    """Table IX: DxD 16-bit matrix multiply (flattened-tree + Cannon).
    Sizes via BENCH_MATMUL_SIZES (default "2,4"; 8/16 take minutes)."""
    nb = 16
    # keep rows from partial reruns; normalize JSON-loaded string keys to int
    # so re-running a recorded size replaces it instead of duplicating '2'/2
    rows = {int(k): v for k, v in report.get("matmul", {}).items()}
    sizes = tuple(int(v) for v in os.environ.get("BENCH_MATMUL_SIZES", "2,4").split(","))
    for D in sizes:
        rng = np.random.RandomState(D)
        ma = rng.randint(0, 16, size=(D, D))
        mb = rng.randint(0, 16, size=(D, D))
        cma = arith.encrypt_int(sk, ma, nb, seed=1100 + D)
        cmb = arith.encrypt_int(sk, mb, nb, seed=1200 + D)
        want = [[_signed(int(v), nb) for v in row] for row in (ma @ mb)]
        # D >= 8 runs take minutes: single timed run (gate programs are
        # power-of-two bucketed, so smaller sizes warm the same programs).
        # Cannon twin measured through BENCH_CANNON_MAX (default 8; Table IX
        # is the Cannon column). Set BENCH_CANNON_MAX=16 to measure the full
        # 16x16 Cannon when hardware time allows; below the cap the per-round
        # circuits are identical, so tree stands in.
        big = D >= 8
        dtf, outf = _timed(lambda x, y: linalg.matmul(x, y, sk.cloud), cma, cmb,
                           warmup=not big)
        assert arith.decrypt_int(sk, outf).tolist() == want
        if D <= int(os.environ.get("BENCH_CANNON_MAX", "8")):
            dtc, outc = _timed(lambda x, y: linalg.cannon_matmul(x, y, sk.cloud),
                               cma, cmb, warmup=not big)
            assert arith.decrypt_int(sk, outc).tolist() == want
        else:
            dtc = None
        rr = REF_GPU["matmul_16bit"].get(D)
        rows[D] = {"tree_s": round(dtf, 3),
                   "cannon_s": round(dtc, 3) if dtc else None,
                   "ref_gpu_s": rr, "speedup_tree": round(rr / dtf, 2) if rr else None}
        print(f"  matmul {D}x{D}: tree {dtf:8.3f}s  cannon {dtc or 0:8.3f}s (ref {rr}s)", flush=True)
        # persist after EVERY size: a timeout at 16x16 must not lose 2/4/8
        report["matmul"] = rows
        _flush_report(report)
    report["matmul"] = rows


EXPS = {"gates": bench_gates, "compound": bench_compound, "phases": bench_phases,
        "add": bench_add, "mul": bench_mul, "vector": bench_vector,
        "matmul": bench_matmul}

_OUT_PATH = None   # set by main(); lets long experiments checkpoint mid-run


def _flush_report(report):
    if _OUT_PATH:
        with open(_OUT_PATH, "w") as f:
            json.dump(report, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", nargs="*", default=list(EXPS))
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "bench_tables.json"))
    args = ap.parse_args(argv)
    global _OUT_PATH
    _OUT_PATH = args.out
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    enable_compile_cache()

    print(f"device: {jax.devices()[0]}", flush=True)
    t0 = time.time()
    sk = tt.keygen(tt.PARAMS_110, seed=(314, 1592, 657))
    print(f"keygen: {time.time()-t0:.1f}s", flush=True)

    report = {"device": str(jax.devices()[0]),
              "params": "110-bit (n=500, N=1024, k=1, l=2, Bg=1024, t=8, basebit=2)"}
    if os.path.exists(args.out):      # merge: allow per-experiment reruns
        with open(args.out) as f:
            prev = json.load(f)
        prev.update(report)
        report = prev
    for name in args.exp:
        print(f"== {name} ==", flush=True)
        EXPS[name](sk, report)
        with open(args.out, "w") as f:     # incremental: survive timeouts
            json.dump(report, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
