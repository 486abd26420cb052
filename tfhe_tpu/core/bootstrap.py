"""Batched gate bootstrapping: blind rotate -> sample extract -> key switch.

This is a batched JAX re-design of the reference's fused fullGPU pipeline
(`gpuParallel/boot-gates.cu:2120-2629` bootstrapAndKeySwitch_n_Bit):

- ONE batched pipeline instead of the reference's three code generations; the
  batch axis plays the role of bit coalescing (paper section V-A2).
- The 500-iteration blind rotate is a `lax.scan` whose body does:
  negacyclic rotate (gather) -> gadget decompose (shift/mask) -> forward NTT
  (2 CRT primes) -> Shoup pointwise multiply-accumulate against the NTT-domain
  BK -> inverse NTT -> CRT lift -> accumulate. Exact integer math throughout;
  zero transform noise (the reference tolerates double-precision FFT rounding).
- Sample extract is a flip/negate (ref lwe.cu:40-56).
- On a GPU the whole blind rotate is one CUDA kernel (ops/blind_rotate_cuda):
  one thread block per ciphertext runs all n iterations with the
  accumulator and the NTT working set in shared memory, bit-identical to
  the scan.
- Key switch is ONE int8 matmul of a one-hot digit matrix against the
  packed KS table (replaces the gather loop `lwe-keyswitch-functions.cu:955-989`
  and the GPU kernels at :2364-2479).
- Everything stays on device: the reference round-trips `b` and `u_b` through
  the host every gate (`boot-gates.cu:2864-2867, 2602-2615`); here there are no
  host transfers inside a gate.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import TfheParams
from .. import ntt
from ..numeric import to_u32, to_i32, mod_switch_from_torus32
from .lwe import LweCiphertext


# ------------------------------------------------------------------ pieces

def negacyclic_rotate(x: jnp.ndarray, amount: jnp.ndarray) -> jnp.ndarray:
    """X^amount * x in Z[X]/(X^N+1), batched.

    x: int32[B, C, N]; amount: int32[B] in [0, 2N). Matches
    torusPolynomialMulByXai (ref toruspolynomial-functions.cu:492-520).
    """
    N = x.shape[-1]
    i = jnp.arange(N, dtype=jnp.int32)
    d = i[None, :] - amount[:, None]
    d = d + jnp.int32(2 * N) * (d < 0)          # [B, N] in [0, 2N)
    neg = d >= N
    idx = d - jnp.int32(N) * neg                # [B, N] in [0, N)
    take = jnp.take_along_axis(
        x, jnp.broadcast_to(idx[:, None, :], x.shape), axis=-1
    )
    return jnp.where(neg[:, None, :], -take, take)


def gadget_decompose(x: jnp.ndarray, params: TfheParams) -> jnp.ndarray:
    """Signed gadget decomposition with the offset trick.

    x: int32[B, k+1, N] -> int32[B, kpl, N], row order c*l + p
    (ref tGswTorus32PolynomialDecompH, tgsw-functions.cu:296-340;
    tGswTLweDecompH row order :263-270).
    """
    l, Bgbit = params.bk_l, params.bk_Bgbit
    u = to_u32(x) + jnp.uint32(params.decomp_offset)        # [B, k+1, N]
    digs = []
    for p in range(l):
        shift = 32 - (p + 1) * Bgbit
        d = ((u >> jnp.uint32(shift)) & jnp.uint32(params.maskMod))
        digs.append(to_i32(d) - jnp.int32(params.halfBg))
    dec = jnp.stack(digs, axis=2)                            # [B, k+1, l, N]
    B = x.shape[0]
    return dec.reshape(B, params.kpl, params.N)


def extern_product_ntt(dec: jnp.ndarray, bk_j: jnp.ndarray, bk_sh_j: jnp.ndarray,
                       params: TfheParams) -> jnp.ndarray:
    """Sum_row dec_row (x) bk_row -> TLWE delta, exact via CRT NTT.

    dec: int32[B, kpl, N]; bk_j/bk_sh_j: uint32[n_primes, kpl, k+1, N] (NTT domain).
    Returns int32[B, k+1, N]. (ref tGswFFTExternMulToTLwe, tgsw-fft-operations.cu:124-265)

    The transforms run in layout [kpl, N, B] (batch minor), so every
    butterfly is a static slice along a major axis.
    """
    N, kpl, k = params.N, params.kpl, params.k
    dec_t = dec.transpose(1, 2, 0)                           # [kpl, N, B]
    residues = []
    for pi, p in enumerate(ntt.PRIMES):
        d = ntt.small_to_residue(dec_t, p)
        dhat = ntt.ntt_forward_rows(d, N, p)                 # [kpl, N, B]
        w = bk_j[pi].transpose(0, 2, 1)                      # [kpl, N, k+1]
        wsh = bk_sh_j[pi].transpose(0, 2, 1)
        outs = []
        for c in range(k + 1):
            s = ntt.mul_mod_shoup(dhat[0], w[0, :, c, None], wsh[0, :, c, None], p)
            for r in range(1, kpl):
                s = ntt.add_mod(
                    s, ntt.mul_mod_shoup(dhat[r], w[r, :, c, None], wsh[r, :, c, None], p), p)
            outs.append(s)
        prod = jnp.stack(outs, axis=0)                       # [k+1, N, B]
        residues.append(ntt.ntt_inverse_rows(prod, N, p))
    delta_t = ntt.crt_to_i32(residues[0], residues[1])       # [k+1, N, B]
    return delta_t.transpose(2, 0, 1)                        # [B, k+1, N]


def blind_rotate(acc: jnp.ndarray, bara: jnp.ndarray, bk_ntt: jnp.ndarray,
                 bk_shoup: jnp.ndarray, params: TfheParams) -> jnp.ndarray:
    """CMux chain over the n LWE key bits (ref tfhe_blindRotate + the fused loop
    boot-gates.cu:2543-2583). acc: int32[B, k+1, N]; bara: int32[B, n].

    Pure-XLA path: the path on CPU, and the reference the CUDA kernel is
    checked against bit for bit."""

    def step(acc, xs):
        bk_j, bk_sh_j, bara_j = xs
        rot = negacyclic_rotate(acc, bara_j)
        dec = gadget_decompose(rot - acc, params)
        delta = extern_product_ntt(dec, bk_j, bk_sh_j, params)
        # barai == 0 is automatically a no-op: decompose(0) == 0 exactly
        # thanks to the offset trick, so delta == 0.
        return acc + delta, None

    acc, _ = jax.lax.scan(step, acc, (bk_ntt, bk_shoup, bara.T))
    return acc


# Chunk size of one bootstrap program: the analog of the reference's
# bootsLimit memory batching (boot-gates.cu:2869-2907). Kept from the first
# design; not measured on the H100.
LANE_MAX_BATCH = 256


def blind_rotate_device(acc: jnp.ndarray, bara: jnp.ndarray, cloud,
                        params: TfheParams) -> jnp.ndarray:
    """The blind rotate of the default backend: the fused CUDA kernel on a
    GPU, the XLA scan elsewhere. On a GPU a kernel that cannot be built or
    loaded raises; it never gives way to the scan."""
    if jax.default_backend() == "gpu":
        from ..ops import blind_rotate_cuda
        return blind_rotate_cuda.blind_rotate(
            acc, bara, cloud.bk_ntt, cloud.bk_ntt_shoup, params)
    return blind_rotate(acc, bara, cloud.bk_ntt, cloud.bk_ntt_shoup, params)


def sample_extract(acc: jnp.ndarray, params: TfheParams):
    """Extract the constant coefficient as an LWE sample over the extracted key
    (ref tLweExtractLweSampleIndex, lwe.cu:40-56, index=0).

    acc: int32[B, k+1, N] -> (a_ext int32[B, k*N], b_ext int32[B]).
    """
    k, N = params.k, params.N
    B = acc.shape[0]
    head = acc[:, :k, :1]                                    # [B, k, 1]
    tail = -jnp.flip(acc[:, :k, 1:], axis=-1)                # [B, k, N-1]
    a_ext = jnp.concatenate([head, tail], axis=-1).reshape(B, k * N)
    b_ext = acc[:, k, 0]
    return a_ext, b_ext


def ks_onehot(a_ext: jnp.ndarray, params: TfheParams,
              with_nnz: bool = False):
    """Digit-decompose a_ext columns into the one-hot KS matmul operand.

    a_ext: int32[B, C] (any column slice of the extracted sample) ->
    int8[B, C * t * (base-1)], row order (i, j, h-1) matching ks_to_limb_table
    (ref digit extraction lwe-keyswitch-functions.cu:106-118).

    with_nnz=True also returns the per-sample count of nonzero digits
    (int32[B]) for the reference's per-digit cv accumulation
    (lweKeySwitchTranslate_fromArray, lwe-keyswitch-functions.cu:119-125:
    only rows with aij != 0 contribute a ks-sample variance)."""
    t, basebit, base = params.ks_t, params.ks_basebit, params.ks_base
    B = a_ext.shape[0]
    aibar = to_u32(a_ext) + jnp.uint32(params.ks_prec_offset)        # [B, C]
    digs = jnp.stack(
        [(aibar >> jnp.uint32(32 - (j + 1) * basebit)) & jnp.uint32(base - 1)
         for j in range(t)],
        axis=-1,
    )                                                                 # [B, C, t]
    hvals = jnp.arange(1, base, dtype=jnp.uint32)
    onehot = (digs[..., None] == hvals).astype(jnp.int8)              # [B, C, t, base-1]
    if with_nnz:
        nnz = jnp.sum((digs != 0).astype(jnp.int32), axis=(1, 2))     # [B]
        return onehot.reshape(B, -1), nnz
    return onehot.reshape(B, -1)


def ks_finalize(sums: jnp.ndarray, b_ext: jnp.ndarray, cv: jnp.ndarray,
                params: TfheParams, nnz=None) -> LweCiphertext:
    """Recombine int8 limb-plane partial sums into the key-switched sample.

    sums: int32[B, 4 * pad_cols] (possibly psum-reduced across a mesh axis).
    nnz: optional int32[B] count of nonzero digits — the reference adds one
    ks-sample variance per nonzero digit (lwe-keyswitch-functions.cu:119-125);
    without it the worst case n_extract*t is assumed."""
    n = params.n
    B = sums.shape[0]
    s = sums.reshape(B, 4, sums.shape[1] // 4)
    r = (s[:, 0]
         + (s[:, 1] << jnp.int32(8))
         + (s[:, 2] << jnp.int32(16))
         + (s[:, 3] << jnp.int32(24)))                                # int32 wrap
    a_out = -r[:, :n]
    b_out = b_ext - r[:, n]
    digits = (nnz.astype(jnp.float32) if nnz is not None
              else jnp.float32(params.n_extract * params.ks_t))
    cv_out = cv + digits * jnp.float32(params.ks_stdev ** 2)
    return LweCiphertext(a_out, b_out, jnp.broadcast_to(cv_out, b_out.shape))


def key_switch(a_ext: jnp.ndarray, b_ext: jnp.ndarray, ks_table: jnp.ndarray,
               cv: jnp.ndarray, params: TfheParams) -> LweCiphertext:
    """Key switch via one-hot int8 matmul (int32 accumulation, exact).

    a_ext: int32[B, n_ext]; b_ext: int32[B]; ks_table from ks_to_limb_table.
    result = (0, b_ext) - sum_{i,j} ks[i][j][digit_ij]
    (ref lweKeySwitchTranslate_fromArray, lwe-keyswitch-functions.cu:101-127).
    """
    onehot, nnz = ks_onehot(a_ext, params, with_nnz=True)
    sums = jnp.matmul(onehot, ks_table, preferred_element_type=jnp.int32)
    return ks_finalize(sums, b_ext, cv, params, nnz=nnz)


# ------------------------------------------------------------------ pipeline

def _chunked_over_batch(impl, x: LweCiphertext, chunk: int):
    """Run `impl` (ct-chunk -> pytree) over equal chunks of the flat batch with
    ONE compiled body (lax.map) plus a remainder call, then concatenate.

    The analog of the reference's bootsLimit GPU-memory batching
    (boot-gates.cu:2869-2907): it bounds the key-switch one-hot operand
    (B x 24576 int8) of one program.

    Reachable from direct `bootstrap` calls and shard_map local bodies with
    an oversized per-device batch: the gate layer (gates.py) already chunks
    every workload to GATE_CHUNK before bootstrap is called."""
    B = x.b.shape[0]
    if B <= chunk:
        return impl(x)
    n_full, rem = divmod(B, chunk)
    head = LweCiphertext(
        x.a[: n_full * chunk].reshape(n_full, chunk, -1),
        x.b[: n_full * chunk].reshape(n_full, chunk),
        x.cv[: n_full * chunk].reshape(n_full, chunk))
    if n_full > 1:
        outs = jax.lax.map(impl, head)
    else:
        outs = jax.tree.map(lambda v: v[None], impl(x[:chunk]))
    parts = [jax.tree.map(lambda v: v.reshape((n_full * chunk,) + v.shape[2:]), outs)]
    if rem:
        parts.append(impl(x[n_full * chunk:]))
    return jax.tree.map(lambda *vs: jnp.concatenate(vs, axis=0), *parts)


def _prepare_acc(x: LweCiphertext, mu, cloud):
    """Mod-switch + rotated test-vector accumulator (shared by all paths)."""
    params: TfheParams = cloud.params
    N, k = params.N, params.k
    B = x.b.shape[0]
    Nx2 = 2 * N

    barb = mod_switch_from_torus32(x.b, Nx2)                 # [B]
    bara = mod_switch_from_torus32(x.a, Nx2)                 # [B, n]

    # testvector = X^{2N-barb} * [mu, mu, ..., mu]
    mu_arr = jnp.broadcast_to(jnp.asarray(mu, jnp.int32), (B,))
    tv = jnp.broadcast_to(mu_arr[:, None, None], (B, 1, N)).astype(jnp.int32)
    amt = jnp.where(barb == 0, 0, jnp.int32(Nx2) - barb)
    tvb = negacyclic_rotate(tv, amt)[:, 0]                   # [B, N]

    acc = jnp.concatenate(
        [jnp.zeros((B, k, N), jnp.int32), tvb[:, None, :]], axis=1
    )
    return acc, bara


def bootstrap_woks(x: LweCiphertext, mu, cloud) -> tuple:
    """Bootstrap without key switch: returns extracted (a_ext, b_ext, cv)
    (ref tfhe_bootstrap_woKS_FFT, lwe-bootstrapping-functions-fft.cu:1834-1880).

    x: flat batch [B]. mu: int32 scalar (the output message amplitude).
    """
    B = x.b.shape[0]
    if B > LANE_MAX_BATCH:
        return _chunked_over_batch(
            lambda c: bootstrap_woks(c, mu, cloud), x, LANE_MAX_BATCH)
    params: TfheParams = cloud.params
    acc, bara = _prepare_acc(x, mu, cloud)
    acc = blind_rotate_device(acc, bara, cloud, params)
    a_ext, b_ext = sample_extract(acc, params)
    cv = jnp.full((B,), _bootstrap_variance(params), jnp.float32)
    return a_ext, b_ext, cv


def bootstrap(x: LweCiphertext, mu, cloud) -> LweCiphertext:
    """Full gate bootstrap (ref tfhe_bootstrap_FFT, lwe-bootstrapping-functions-fft.cu:1884).

    Batches beyond LANE_MAX_BATCH run the whole pipeline (blind rotate +
    extract + key switch) chunk-by-chunk with one compiled body."""
    B = x.b.shape[0]
    if B > LANE_MAX_BATCH:
        return _chunked_over_batch(lambda c: bootstrap(c, mu, cloud), x, LANE_MAX_BATCH)
    a_ext, b_ext, cv = bootstrap_woks(x, mu, cloud)
    return key_switch(a_ext, b_ext, cloud.ks_table, cv, cloud.params)


def _bootstrap_variance(params: TfheParams) -> float:
    """Post-blind-rotate variance estimate (standard TFHE noise formula)."""
    l, Bg, N, k, n = params.bk_l, params.Bg, params.N, params.k, params.n
    eps2 = (2.0 ** (-2 * l * params.bk_Bgbit)) / 4.0
    var_bk = params.bk_stdev ** 2
    return float(n * ((k + 1) * l * N * (Bg / 2.0) ** 2 * var_bk + (1 + k * N) * eps2))
