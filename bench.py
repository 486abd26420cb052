#!/usr/bin/env python
"""Headline benchmark: gate-bootstrap throughput on NVIDIA GPUs.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Fails without a GPU. Baseline: the reference GPU's best reported
gate-bootstrap throughput, ~454 bootstraps/s (32-bit coalesced gate batch in
70.50 ms on a GTX 1080, paper Table IV; see BASELINE.md).

BENCH_BATCH (default 256 per device) and BENCH_ITERS (default 5) size the run.
"""
import json
import os
import sys
import time

import numpy as np
import jax

import tfhe_tpu as tt
from tfhe_tpu import gates
from tfhe_tpu.config import enable_compile_cache

BASELINE_BOOTSTRAPS_PER_SEC = 454.0  # reference GPU, 32-bit gate batch (Table IV)


def main():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: needs an NVIDIA GPU; JAX found {devs[0].platform!r}", file=sys.stderr)
        return 1
    enable_compile_cache()
    n_dev = len(devs)
    batch = int(os.environ.get("BENCH_BATCH", str(256 * n_dev)))
    iters = int(os.environ.get("BENCH_ITERS", "5"))

    t0 = time.time()
    sk = tt.keygen(tt.PARAMS_110, seed=(314, 1592, 657), method="reference")
    print(f"# keygen: {time.time()-t0:.1f}s on {n_dev} x {devs[0].device_kind}", file=sys.stderr)

    rng = np.random.RandomState(0)
    bits_a = rng.randint(0, 2, size=batch).astype(np.int32)
    bits_b = rng.randint(0, 2, size=batch).astype(np.int32)
    ca = tt.encrypt_bits(sk, bits_a, seed=1)
    cb = tt.encrypt_bits(sk, bits_b, seed=2)

    if n_dev > 1:
        # DP-shard the gate batch over the devices (bit coalescing across cards)
        from tfhe_tpu.parallel import make_mesh, sharded_gate2
        mesh = make_mesh(n_dev)
        run = lambda x, y: sharded_gate2("AND", x, y, sk.cloud, mesh)
    else:
        run = lambda x, y: gates.AND(x, y, sk.cloud)

    t0 = time.time()
    out = run(ca, cb)
    jax.block_until_ready(out)
    print(f"# first AND batch (compile+run): {time.time()-t0:.1f}s", file=sys.stderr)
    want = bits_a & bits_b
    assert np.array_equal(tt.decrypt_bits(sk, out), want), "AND gate decryption mismatch!"

    # warm the chained signature before timing
    out = run(out, cb)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = run(out, cb)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / iters
    thr = batch / dt
    # integrity: the chained output must still decrypt to a & b (AND idempotent)
    assert np.array_equal(tt.decrypt_bits(sk, out), want), "chained AND mismatch!"
    print(f"# {batch} bootstraps in {dt*1000:.1f} ms -> {thr:.1f} bootstraps/s", file=sys.stderr)

    print(json.dumps({
        "metric": "gate_bootstraps_per_sec",
        "value": round(thr, 2),
        "unit": "bootstraps/s",
        "vs_baseline": round(thr / BASELINE_BOOTSTRAPS_PER_SEC, 3),
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": n_dev},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
