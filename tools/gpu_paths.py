#!/usr/bin/env python
"""Measure the blind-rotate and whole-circuit-jit choices on one GPU.

    python tools/gpu_paths.py [--rounds 3] [--trace DIR]

1. Blind rotate, CUDA kernel vs XLA scan, end to end: AND at B=256
   (gates._gate2_jit) and add16 at batch 1 (one whole-circuit program).
   Each path is compiled once; then the compiled programs run in turns
   (kernel, scan, scan, kernel) --rounds times.
2. Whole-circuit jit vs eager, add16 and div16 at batch 1 (default blind
   rotate): the first call (compile + run) and the median steady call.
3. With --trace: one profiler trace per program of a steady call (scan AND,
   kernel AND, kernel add16); prints the device's kernel and memcpy counts,
   kernels per CMux iteration, and the device idle share of the call.

Every result is decrypt-checked; the card's name and power limit come first.
"""
import argparse
import glob
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import jax
import jax.numpy as jnp

import tfhe_tpu as tt
from tfhe_tpu import arith, config, gates
from tfhe_tpu.config import enable_compile_cache
from tfhe_tpu.core import bootstrap as bs


def _scan_route(acc, bara, cloud, params):
    return bs.blind_rotate(acc, bara, cloud.bk_ntt, cloud.bk_ntt_shoup, params)


def compile_with(route, fn, *args):
    """AOT-compile fn(*args) with `route` as the blind rotate; returns
    (compile seconds, executable)."""
    saved = bs.blind_rotate_device
    bs.blind_rotate_device = route
    jax.clear_caches()
    try:
        t0 = time.perf_counter()
        exe = jax.jit(fn).lower(*args).compile()
        return time.perf_counter() - t0, exe
    finally:
        bs.blind_rotate_device = saved
        jax.clear_caches()


def run_s(exe, *args):
    t0 = time.perf_counter()
    out = exe(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def trace_summary(exe, args, logdir, n_iter):
    run_s(exe, *args)
    with jax.profiler.trace(logdir):
        with jax.profiler.TraceAnnotation("window"):
            run_s(exe, *args)
    path = max(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True),
               key=os.path.getmtime)
    pd = jax.profiler.ProfileData.from_file(path)
    win = None
    dev = []
    lines = {}
    for plane in pd.planes:
        for line in plane.lines:
            for ev in line.events:
                if ev.name == "window":
                    win = (ev.start_ns, ev.end_ns)
        if plane.name.startswith("/device:GPU:0"):
            for line in plane.lines:
                if "stream" not in line.name.lower():
                    continue
                evs = list(line.events)
                lines[line.name] = len(evs)
                dev += [(ev.start_ns, ev.end_ns, ev.name) for ev in evs]
    memcpy = [e for e in dev if "memcpy" in e[2].lower() or "memset" in e[2].lower()]
    kernels = len(dev) - len(memcpy)
    busy, end = 0.0, None
    for s, e, _ in sorted(dev):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    w0, w1 = win if win else (min(d[0] for d in dev), max(d[1] for d in dev))
    return {"stream_lines": lines, "kernels": kernels, "memcpy": len(memcpy),
            "kernels_per_cmux_iter": kernels / n_iter,
            "memcpy_per_cmux_iter": len(memcpy) / n_iter,
            "window_s": (w1 - w0) * 1e-9, "device_busy_s": busy * 1e-9,
            "idle_share": 1.0 - busy / (w1 - w0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("gpu_paths: needs an NVIDIA GPU")
    enable_compile_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"device_kind {jax.devices()[0].device_kind}", flush=True)

    sk = tt.keygen(tt.PARAMS_110, seed=(314, 1592, 657), method="reference")
    cloud = sk.cloud
    n = sk.params.n
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2, size=256).astype(np.int32)
    y = rng.randint(0, 2, size=256).astype(np.int32)
    ca, cb = tt.encrypt_bits(sk, x, seed=1), tt.encrypt_bits(sk, y, seed=2)
    const, c_a, c_b = (jnp.int32(v) for v in gates.GATE_TABLE["AND"])
    and_args = (ca, cb, const, c_a, c_b, jnp.int32(gates.MU), cloud)
    ia, ib = arith.encrypt_int(sk, 1234, 16, seed=3), arith.encrypt_int(sk, 567, 16, seed=4)
    add_args = (ia, ib, cloud)

    # 1. kernel vs scan, compiled once each, then in turns
    progs = {}
    for route_name, route in (("kernel", bs.blind_rotate_device), ("scan", _scan_route)):
        for prog, fn, a in (("AND_B256", gates._gate2_jit, and_args),
                            ("add16_b1", arith.add.__wrapped__, add_args)):
            ct, exe = compile_with(route, fn, *a)
            progs[(prog, route_name)] = (exe, a)
            print(f"compile {prog} {route_name}: {ct:.3f} s", flush=True)
    times = {k: [] for k in progs}
    for prog in ("AND_B256", "add16_b1"):
        for _ in range(args.rounds):
            for route_name in ("kernel", "scan", "scan", "kernel"):
                exe, a = progs[(prog, route_name)]
                dt, out = run_s(exe, *a)
                times[(prog, route_name)].append(dt)
        for route_name in ("kernel", "scan"):
            exe, a = progs[(prog, route_name)]
            out = exe(*a)
            if prog == "AND_B256":
                assert np.array_equal(tt.decrypt_bits(sk, out), x & y), (prog, route_name)
            else:
                assert int(arith.decrypt_int(sk, out)) == 1801, (prog, route_name)
            ts = times[(prog, route_name)]
            print(f"{prog} {route_name}: median {statistics.median(ts):.6f} s "
                  f"min {min(ts):.6f} max {max(ts):.6f} over {len(ts)} (decrypt ok)", flush=True)
    same = [np.array_equal(np.asarray(progs[(p, "kernel")][0](*progs[(p, "kernel")][1]).a),
                           np.asarray(progs[(p, "scan")][0](*progs[(p, "scan")][1]).a))
            for p in ("AND_B256", "add16_b1")]
    print(f"kernel == scan end to end (a): {same}", flush=True)

    # 2. whole-circuit jit vs eager, batch 1
    ja, jb = arith.encrypt_int(sk, 1234, 16, seed=5), arith.encrypt_int(sk, 56, 16, seed=6)
    for name, fn, a, want in (("add16", arith.add, (ia, ib), 1801),
                              ("div16", arith.div, (ja, jb), 1234 // 56)):
        for mode in ("0", "1"):
            with config.overrides(TFHE_TPU_CIRCUIT_JIT=mode):
                first, out = run_s(fn, *a, cloud)
                steady = [run_s(fn, *a, cloud)[0] for _ in range(args.rounds)]
            assert int(arith.decrypt_int(sk, out)) == want, (name, mode)
            print(f"{name} {'jit' if mode == '1' else 'eager'}: first call {first:.3f} s, "
                  f"steady median {statistics.median(steady):.6f} s "
                  f"(min {min(steady):.6f}) (decrypt ok)", flush=True)

    # 3. traces
    if args.trace:
        for key in (("AND_B256", "scan"), ("AND_B256", "kernel"), ("add16_b1", "kernel")):
            exe, a = progs[key]
            d = os.path.join(args.trace, "_".join(key))
            print(f"trace {key}: {trace_summary(exe, a, d, n)}", flush=True)


if __name__ == "__main__":
    main()
