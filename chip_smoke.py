#!/usr/bin/env python
"""Smoke test of the bootstrapping pipeline on NVIDIA GPUs, at PARAMS_110.

    python chip_smoke.py              # one card
    python chip_smoke.py --devices 4  # four cards: the sharded paths only

One card, in one process: device check; reference-PRNG keygen; a 256-gate
AND batch, decrypt-checked and bit-identical to the native C++ engine;
add/mul/div at 16 bits on one integer each, decrypt-checked, plus the native
engine's 5-gate ripple adder run gate by gate and compared bit for bit; the
CUDA blind rotate against the XLA scan at B=256 and B=1.

Four cards: DP gates, a whole sharded multiply, Cannon on a 2x2 mesh and the
tensor-parallel key switch on a 2x2 mesh, each compared bit for bit with the
same work on one card.

Every check raises on failure, so the exit code is non-zero and the last
line is not printed. Without a GPU it exits non-zero before any work. The
last line of stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""
import argparse
import json
import subprocess
import sys
import time

SEED = (314, 1592, 657)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def same_ct(got, want, what, cv=True):
    """Ciphertexts: a and b exactly equal; cv (float32 bookkeeping) to 1e-6."""
    import numpy as np
    check(np.array_equal(np.asarray(got.a), np.asarray(want.a)), f"{what}: a differs")
    check(np.array_equal(np.asarray(got.b), np.asarray(want.b)), f"{what}: b differs")
    if cv:
        np.testing.assert_allclose(np.asarray(got.cv), np.asarray(want.cv), rtol=1e-6,
                                   err_msg=f"{what}: cv differs")


def peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def device_phase(want_count):
    import jax
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX found {d.platform!r}")
    if len(devs) < want_count:
        raise SystemExit(f"chip_smoke: --devices {want_count} but JAX found {len(devs)}")
    print(f"device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line)
    return devs


def keys_phase():
    import jax
    import tfhe_tpu as tt
    dt, sk = timed(lambda: tt.keygen(tt.PARAMS_110, seed=SEED, method="reference"))
    c = sk.cloud
    bk = c.bk_ntt.nbytes + c.bk_ntt_shoup.nbytes
    print(f"keys: reference keygen {dt:.3f} s; cloud key on device {bk + c.ks_table.nbytes} "
          f"bytes (bk_ntt+bk_ntt_shoup {bk}, ks_table {c.ks_table.nbytes}); "
          f"peak_bytes_in_use {peak_bytes(jax.devices()[0])}")
    return sk


def gate_phase(sk):
    import numpy as np
    import jax.numpy as jnp
    import tfhe_tpu as tt
    from tfhe_tpu import gates, native_ref

    B, iters = 256, 5
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2, size=B).astype(np.int32)
    y = rng.randint(0, 2, size=B).astype(np.int32)
    ca, cb = tt.encrypt_bits(sk, x, seed=1), tt.encrypt_bits(sk, y, seed=2)
    first, out = timed(gates.AND, ca, cb, sk.cloud)
    t0 = time.perf_counter()
    for _ in range(iters):
        o = gates.AND(ca, cb, sk.cloud)
    o.b.block_until_ready()
    steady = (time.perf_counter() - t0) / iters
    check(np.array_equal(tt.decrypt_bits(sk, out), x & y), "AND B=256 decrypts wrong")
    na, nb = native_ref.gate2_batch(sk, "AND", np.asarray(ca.a[:8]), np.asarray(ca.b[:8]),
                                    np.asarray(cb.a[:8]), np.asarray(cb.b[:8]))
    check(np.array_equal(np.asarray(out.a[:8]), na) and np.array_equal(np.asarray(out.b[:8]), nb),
          "AND outputs differ from native_ref.gate2_batch")
    const, c_a, c_b = gates.GATE_TABLE["AND"]
    ma = gates._gate2_jit.lower(ca, cb, jnp.int32(const), jnp.int32(c_a), jnp.int32(c_b),
                                jnp.int32(gates.MU), sk.cloud).compile().memory_analysis()
    print(f"gate AND B={B}: first call (compile+run) {first:.3f} s, steady {steady:.6f} s "
          f"= {B / steady:.1f} bootstraps/s; 256/256 decrypt ok; 8/8 a,b == native_ref")
    print(f"gate memory_analysis: argument {ma.argument_size_in_bytes} output "
          f"{ma.output_size_in_bytes} temp {ma.temp_size_in_bytes} code "
          f"{ma.generated_code_size_in_bytes} bytes")


def ripple_add_5gate(a, b, cloud):
    """native_ref.ripple_add's circuit (5 gates per bit), gate by gate."""
    from tfhe_tpu import gates
    from tfhe_tpu.core.lwe import lwe_stack
    sums = [gates.XOR(a[..., 0], b[..., 0], cloud)]
    carry = gates.AND(a[..., 0], b[..., 0], cloud)
    for i in range(1, a.batch_shape[-1]):
        t0 = gates.XOR(a[..., i], carry, cloud)
        t1 = gates.XOR(b[..., i], carry, cloud)
        t = gates.AND(t0, t1, cloud)
        sums.append(gates.XOR(a[..., i], t1, cloud))
        carry = gates.XOR(t, carry, cloud)
    return lwe_stack(sums, axis=-1)


def circuit_phase(sk):
    import numpy as np
    from tfhe_tpu import arith, native_ref

    nb = 16

    def signed(v):
        v &= (1 << nb) - 1
        return v - (1 << nb) if v >> (nb - 1) else v

    cases = (("add16", arith.add, 1234, 567, 1234 + 567),
             ("mul16", arith.mul, 123, 45, 123 * 45),
             ("div16", arith.div, 1234, 56, 1234 // 56))
    for k, (name, fn, a, b, want) in enumerate(cases):
        ca = arith.encrypt_int(sk, a, nb, seed=10 + 2 * k)
        cb = arith.encrypt_int(sk, b, nb, seed=11 + 2 * k)
        first, out = timed(fn, ca, cb, sk.cloud)
        steady, out = timed(fn, ca, cb, sk.cloud)
        got = int(arith.decrypt_int(sk, out))
        check(got == signed(want), f"{name}: {got} != {signed(want)}")
        print(f"{name} batch 1: first call (compile+run) {first:.3f} s, steady {steady:.6f} s; "
              f"{a} op {b} = {got} ok")
        if name == "add16":
            _, out5 = timed(ripple_add_5gate, ca, cb, sk.cloud)
            check(int(arith.decrypt_int(sk, out5)) == signed(want), "5-gate add decrypts wrong")
            na, nbv = native_ref.ripple_add(sk, np.asarray(ca.a)[None], np.asarray(ca.b)[None],
                                            np.asarray(cb.a)[None], np.asarray(cb.b)[None])
            check(np.array_equal(np.asarray(out5.a), na[0])
                  and np.array_equal(np.asarray(out5.b), nbv[0]),
                  "5-gate ripple add differs from native_ref.ripple_add")
            print("add16 (native 5-gate ripple circuit on the card): a,b == native_ref.ripple_add")


def kernel_phase(sk):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import tfhe_tpu as tt
    from tfhe_tpu import gates
    from tfhe_tpu.core import bootstrap as bs
    from tfhe_tpu.ops import blind_rotate_cuda

    def rotate(fn):
        return jax.jit(lambda acc, bara, c: fn(acc, bara, c.bk_ntt, c.bk_ntt_shoup, c.params))

    kern, scan = rotate(blind_rotate_cuda.blind_rotate), rotate(bs.blind_rotate)
    for B in (256, 1):
        rng = np.random.RandomState(B)
        bits = rng.randint(0, 2, size=(2, B)).astype(np.int32)
        x = tt.encrypt_bits(sk, bits[0], seed=20 + B)
        y = tt.encrypt_bits(sk, bits[1], seed=30 + B)
        const, c_a, c_b = gates.GATE_TABLE["AND"]
        t = gates._affine2(x, y, jnp.int32(const), jnp.int32(c_a), jnp.int32(c_b))
        acc, bara = bs._prepare_acc(t, jnp.int32(gates.MU), sk.cloud)
        tk0, got = timed(kern, acc, bara, sk.cloud)
        ts0, want = timed(scan, acc, bara, sk.cloud)
        tk, _ = timed(kern, acc, bara, sk.cloud)
        ts, _ = timed(scan, acc, bara, sk.cloud)
        check(np.array_equal(np.asarray(got), np.asarray(want)),
              f"CUDA blind rotate != XLA scan at B={B}")
        print(f"blind rotate B={B}: CUDA kernel == XLA scan (all {got.size} accumulator words); "
              f"first call kernel {tk0:.3f} s / scan {ts0:.3f} s; "
              f"steady kernel {tk:.6f} s / scan {ts:.6f} s")


def multi_phase(sk, n_dev):
    """The sharded paths on n_dev cards against the same work on one card."""
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    import tfhe_tpu as tt
    from tfhe_tpu import arith, gates
    from tfhe_tpu.core.lwe import LweCiphertext
    from tfhe_tpu.parallel import mesh as pm
    from tfhe_tpu.parallel.cannon import cannon_matmul_mesh, make_mesh2d

    check(n_dev == 4, "the multi-card path runs on exactly 4 devices")

    def spread(ct, what):
        shards = ct.b.addressable_shards
        devs = {s.device for s in shards}
        sizes = {s.data.size for s in shards}
        check(len(devs) == n_dev and sizes == {ct.b.size // n_dev},
              f"{what}: output is not split evenly over {n_dev} devices")

    B = 1024
    rng = np.random.RandomState(4)
    x = rng.randint(0, 2, size=B).astype(np.int32)
    y = rng.randint(0, 2, size=B).astype(np.int32)
    ca, cb = tt.encrypt_bits(sk, x, seed=41), tt.encrypt_bits(sk, y, seed=42)
    _, want = timed(gates.AND, ca, cb, sk.cloud)
    check(np.array_equal(tt.decrypt_bits(sk, want), x & y), "one-card AND decrypts wrong")

    mesh = pm.make_mesh(n_dev)
    dt, got = timed(pm.sharded_gate2, "AND", ca, cb, sk.cloud, mesh)
    same_ct(got, want, "DP AND")
    spread(got, "DP AND")
    print(f"DP AND B={B} over {n_dev} cards ({B // n_dev} each): == one card ({dt:.3f} s incl. compile)")

    nb = 16
    va = np.array([123, -45, 77, 6], np.int64)
    vb = np.array([45, 67, -89, 101], np.int64)
    xa, xb = arith.encrypt_int(sk, va, nb, seed=43), arith.encrypt_int(sk, vb, nb, seed=44)
    _, want = timed(arith.mul, xa, xb, sk.cloud)
    dt, got = timed(pm.sharded_circuit, arith.mul, (xa, xb), sk.cloud, mesh)
    same_ct(got, want, "sharded mul16")
    spread(got, "sharded mul16")
    check(np.array_equal(arith.decrypt_int(sk, got), (va * vb).astype(np.int16)),
          "sharded mul16 decrypts wrong")
    print(f"sharded_circuit(arith.mul) 16-bit, one number per card: == one card ({dt:.3f} s)")

    d = 2
    ma = rng.randint(0, 16, size=(d, d))
    mb = rng.randint(0, 16, size=(d, d))
    cma, cmb = arith.encrypt_int(sk, ma, nb, seed=45), arith.encrypt_int(sk, mb, nb, seed=46)
    dt, got = timed(cannon_matmul_mesh, cma, cmb, sk.cloud, make_mesh2d(d))
    idx = (np.arange(d)[:, None] + np.arange(d)[None, :])
    rows, cols = np.arange(d)[:, None], np.arange(d)[None, :]
    acc = None
    for r in range(d):   # the mesh's rounds, as one batch per round on one card
        k = (idx + r) % d
        a_r = jax.tree.map(lambda v: v[rows, k], cma)
        b_r = jax.tree.map(lambda v: v[k, cols], cmb)
        prod = arith.mul(a_r, b_r, sk.cloud)
        acc = prod if acc is None else arith.add(acc, prod, sk.cloud)
    same_ct(got, acc, "Cannon 2x2")
    spread(got, "Cannon 2x2")
    check(np.array_equal(arith.decrypt_int(sk, got), ma @ mb), "Cannon 2x2 decrypts wrong")
    print(f"cannon_matmul_mesh 2x2: == the same rounds on one card ({dt:.3f} s)")

    mesh2 = pm.make_mesh2d_dp_ks(2, 2)
    ks_sharded = jax.device_put(sk.cloud.ks_table, NamedSharding(mesh2, P("ks", None)))
    rows_per = {s.data.shape[0] for s in ks_sharded.addressable_shards}
    check(rows_per == {sk.cloud.ks_table.shape[0] // 2}, "KS table not row-split over ks")
    cloud2 = type(sk.cloud)(params=sk.cloud.params, bk_ntt=sk.cloud.bk_ntt,
                            bk_ntt_shoup=sk.cloud.bk_ntt_shoup, ks_table=ks_sharded)
    _, want = timed(gates.AND, ca, cb, sk.cloud)
    dt, got = timed(pm.sharded_gate2_tp_ks, "AND", ca, cb, cloud2, mesh2)
    # cv: this path books the worst-case key-switch variance (ks_finalize
    # without nnz), so only a and b are compared.
    same_ct(got, want, "TP key switch AND", cv=False)
    spread(got, "TP key switch AND")
    print(f"sharded_gate2_tp_ks 2x2 dp x ks: a,b == one card ({dt:.3f} s)")
    for dev in jax.devices()[:n_dev]:
        print(f"  {dev}: peak_bytes_in_use {peak_bytes(dev)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 = run only the multi-card path")
    args = ap.parse_args(argv)

    devs = device_phase(args.devices)
    from tfhe_tpu.config import enable_compile_cache
    enable_compile_cache()
    sk = keys_phase()
    if args.devices == 4:
        multi_phase(sk, 4)
    else:
        gate_phase(sk)
        circuit_phase(sk)
        kernel_phase(sk)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
