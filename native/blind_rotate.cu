// Fused blind rotate for NVIDIA Hopper (sm_90a), called from JAX through the
// XLA FFI (tfhe_tpu/ops/blind_rotate_cuda.py builds and registers it).
//
// One thread block per ciphertext runs the whole n-iteration CMux loop of
// core/bootstrap.py:blind_rotate. The accumulator ((k+1)*N int32) and the
// NTT working set (2 primes x kpl polynomials) stay in shared memory across
// all iterations; each iteration reads its bootstrapping-key slice from
// global memory, where all blocks share it through L2. The reference
// launched 3 kernels and 2 cuFFT plans per iteration instead
// (boot-gates.cu:2543-2583).
//
// The arithmetic is the exact two-prime NTT of tfhe_tpu/ntt.py: the same
// primes, merged-psi twiddles (passed in from Python), DIF forward into
// bit-reversed order, DIT inverse with N^-1 folded into the last stage,
// Shoup products and Garner CRT. Every step keeps canonical residues, so
// the result is bit-identical to the XLA scan.

#include <cstddef>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kPrimes = 2;
// Threads per block. 1024 beat 512 at every batch from 1 to 512 on an H100
// (PERF.md): the stages are latency-bound, and more warps hide it.
constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// x*w mod p for fixed w with wsh = floor(w * 2^32 / p) (ntt.mul_mod_shoup).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w, uint32_t wsh,
                                              uint32_t p) {
  const uint32_t q = __umulhi(x, wsh);
  const uint32_t r = x * w - q * p;
  return r >= p ? r - p : r;
}

struct Crt {
  uint32_t p1, p2, inv_p1, inv_p1_sh, m_mod, t_half, r1_half;

  // (r1 mod p1, r2 mod p2) -> signed value mod 2^32 (ntt.crt_to_i32).
  __device__ __forceinline__ uint32_t lift(uint32_t r1, uint32_t r2) const {
    const uint32_t r1p2 = r1 >= p2 ? r1 - p2 : r1;
    const uint32_t t = mul_shoup(sub_mod(r2, r1p2, p2), inv_p1, inv_p1_sh, p2);
    const uint32_t rep = r1 + p1 * t;
    const bool upper = t > t_half || (t == t_half && r1 >= r1_half);
    return upper ? rep - m_mod : rep;
  }
};

// Table layout (blind_rotate_cuda.kernel_tables): per prime, 4N + 4 words
//   psi_br[N] psi_br_shoup[N] ipsi_br[N] ipsi_br_shoup[N]
//   n_inv n_inv_shoup ipsi1_ninv ipsi1_ninv_shoup
// then p1 p2 inv_p1_mod_p2 inv_p1_shoup m_mod_2_32 t_half r1_half 0.
//
// Shapes are template parameters, so every per-thread loop has a constant
// trip count; the butterfly stages load all of a thread's operands before
// computing any of them, which lets each thread keep several shared-memory
// and twiddle loads in flight.
template <int K1, int L, int LOG_N>
__global__ void __launch_bounds__(kThreads)
blind_rotate_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ bara,
                    const uint32_t* __restrict__ bk, const uint32_t* __restrict__ bksh,
                    const uint32_t* __restrict__ tab, int32_t* __restrict__ acc_out,
                    int n, int bgbit, uint32_t offset, int32_t half_bg) {
  constexpr int KPL = K1 * L;
  constexpr int N = 1 << LOG_N;
  constexpr int HALF = N / 2;
  constexpr int STRIDE = 4 * N + 4;
  constexpr int FWD = kPrimes * KPL * HALF;  // butterflies per forward stage
  constexpr int INV = kPrimes * K1 * HALF;   // butterflies per inverse stage
  constexpr int FR = (FWD + kThreads - 1) / kThreads;
  constexpr int IR = (INV + kThreads - 1) / kThreads;

  extern __shared__ uint32_t smem[];
  int32_t* acc = reinterpret_cast<int32_t*>(smem);  // [K1][N]
  uint32_t* work = smem + K1 * N;                    // [kPrimes][KPL][N]

  const uint32_t* c = tab + kPrimes * STRIDE;
  const uint32_t P[kPrimes] = {c[0], c[1]};
  const Crt crt{c[0], c[1], c[2], c[3], c[4], c[5], c[6]};
  const uint32_t mask = (1u << bgbit) - 1u;

  const int tid = threadIdx.x;
  const size_t ct = blockIdx.x;
  for (int idx = tid; idx < K1 * N; idx += kThreads) acc[idx] = acc_in[ct * K1 * N + idx];
  __syncthreads();

  const size_t bk_slice = static_cast<size_t>(kPrimes) * KPL * K1 * N;
  for (int j = 0; j < n; ++j) {
    const int a = bara[ct * n + j];

    // 1. X^a * acc - acc, gadget-decomposed into rows c*L + p, as residues.
#pragma unroll
    for (int idx = tid; idx < K1 * N; idx += kThreads) {
      const int i = idx & (N - 1);
      const int row0 = idx - i;  // c * N
      int d = i - a;
      if (d < 0) d += 2 * N;
      const bool neg = d >= N;
      const uint32_t v = static_cast<uint32_t>(acc[row0 + (neg ? d - N : d)]);
      const uint32_t rot = neg ? 0u - v : v;
      const uint32_t u = rot - static_cast<uint32_t>(acc[idx]) + offset;
      const int cc = idx >> LOG_N;
#pragma unroll
      for (int p = 0; p < L; ++p) {
        const int32_t dig =
            static_cast<int32_t>((u >> (32 - (p + 1) * bgbit)) & mask) - half_bg;
        const int r = cc * L + p;
#pragma unroll
        for (int q = 0; q < kPrimes; ++q)
          work[(q * KPL + r) * N + i] =
              static_cast<uint32_t>(dig < 0 ? dig + static_cast<int32_t>(P[q]) : dig);
      }
    }
    __syncthreads();

    // 2. Forward NTT of every row, both primes (ntt.ntt_forward).
#pragma unroll
    for (int log_t = LOG_N - 1; log_t >= 0; --log_t) {
      const int m = HALF >> log_t;
      const int t = 1 << log_t;
      int off[FR];
      uint32_t uu[FR], vv[FR], w[FR], wsh[FR];
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        const int idx = tid + r * kThreads;
        if (FWD % kThreads != 0 && idx >= FWD) continue;
        const int poly = idx >> (LOG_N - 1);
        const int bf = idx & (HALF - 1);
        const int g = bf >> log_t;
        const uint32_t* tq = tab + (poly >= KPL) * STRIDE + m + g;
        off[r] = poly * N + (g << (log_t + 1)) + (bf & (t - 1));
        uu[r] = work[off[r]];
        vv[r] = work[off[r] + t];
        w[r] = __ldg(tq);
        wsh[r] = __ldg(tq + N);
      }
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        const int idx = tid + r * kThreads;
        if (FWD % kThreads != 0 && idx >= FWD) continue;
        const uint32_t p = (idx >> (LOG_N - 1)) >= KPL ? P[1] : P[0];
        const uint32_t wv = mul_shoup(vv[r], w[r], wsh[r], p);
        work[off[r]] = add_mod(uu[r], wv, p);
        work[off[r] + t] = sub_mod(uu[r], wv, p);
      }
      __syncthreads();
    }

    // 3. Pointwise multiply-accumulate against the key slice; output
    //    polynomial c overwrites row c (every row is read first).
    const uint32_t* bkj = bk + static_cast<size_t>(j) * bk_slice;
    const uint32_t* bkshj = bksh + static_cast<size_t>(j) * bk_slice;
#pragma unroll
    for (int idx = tid; idx < kPrimes * N; idx += kThreads) {
      const int q = idx >> LOG_N;
      const int i = idx & (N - 1);
      const uint32_t p = q ? P[1] : P[0];
      uint32_t d[KPL];
#pragma unroll
      for (int r = 0; r < KPL; ++r) d[r] = work[(q * KPL + r) * N + i];
      uint32_t s[K1];
#pragma unroll
      for (int cc = 0; cc < K1; ++cc) {
        s[cc] = 0;
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
          const size_t o = (static_cast<size_t>(q * KPL + r) * K1 + cc) * N + i;
          s[cc] = add_mod(s[cc], mul_shoup(d[r], __ldg(bkj + o), __ldg(bkshj + o), p), p);
        }
      }
#pragma unroll
      for (int cc = 0; cc < K1; ++cc) work[(q * KPL + cc) * N + i] = s[cc];
    }
    __syncthreads();

    // 4. Inverse NTT of rows 0..K1-1 up to its last stage (ntt.ntt_inverse).
#pragma unroll
    for (int log_t = 0; log_t < LOG_N - 1; ++log_t) {
      const int h = HALF >> log_t;
      const int t = 1 << log_t;
      int off[IR];
      uint32_t uu[IR], vv[IR], w[IR], wsh[IR];
#pragma unroll
      for (int r = 0; r < IR; ++r) {
        const int idx = tid + r * kThreads;
        if (INV % kThreads != 0 && idx >= INV) continue;
        const int pk = idx >> (LOG_N - 1);
        const int q = pk >= K1;
        const int bf = idx & (HALF - 1);
        const int g = bf >> log_t;
        const uint32_t* tq = tab + q * STRIDE + 2 * N + h + g;
        off[r] = (q * KPL + pk - q * K1) * N + (g << (log_t + 1)) + (bf & (t - 1));
        uu[r] = work[off[r]];
        vv[r] = work[off[r] + t];
        w[r] = __ldg(tq);
        wsh[r] = __ldg(tq + N);
      }
#pragma unroll
      for (int r = 0; r < IR; ++r) {
        const int idx = tid + r * kThreads;
        if (INV % kThreads != 0 && idx >= INV) continue;
        const uint32_t p = (idx >> (LOG_N - 1)) >= K1 ? P[1] : P[0];
        work[off[r]] = add_mod(uu[r], vv[r], p);
        work[off[r] + t] = mul_shoup(sub_mod(uu[r], vv[r], p), w[r], wsh[r], p);
      }
      __syncthreads();
    }

    // 5. Last inverse stage (N^-1 folded in), CRT lift, accumulate.
#pragma unroll
    for (int idx = tid; idx < K1 * HALF; idx += kThreads) {
      const int cc = idx >> (LOG_N - 1);
      const int i = idx & (HALF - 1);
      uint32_t lo[kPrimes], hi[kPrimes];
#pragma unroll
      for (int q = 0; q < kPrimes; ++q) {
        const uint32_t* tl = tab + q * STRIDE + 4 * N;
        const uint32_t* x = work + (q * KPL + cc) * N;
        const uint32_t uu = x[i], vv = x[i + HALF];
        lo[q] = mul_shoup(add_mod(uu, vv, P[q]), __ldg(tl + 0), __ldg(tl + 1), P[q]);
        hi[q] = mul_shoup(sub_mod(uu, vv, P[q]), __ldg(tl + 2), __ldg(tl + 3), P[q]);
      }
      int32_t* row = acc + cc * N;
      row[i] = static_cast<int32_t>(static_cast<uint32_t>(row[i]) + crt.lift(lo[0], lo[1]));
      row[i + HALF] = static_cast<int32_t>(static_cast<uint32_t>(row[i + HALF]) +
                                           crt.lift(hi[0], hi[1]));
    }
    __syncthreads();
  }

  for (int idx = tid; idx < K1 * N; idx += kThreads) acc_out[ct * K1 * N + idx] = acc[idx];
}

template <int K1, int L, int LOG_N>
ffi::Error Launch(cudaStream_t stream, int64_t batch, int n, const int32_t* acc,
                  const int32_t* bara, const uint32_t* bk, const uint32_t* bksh,
                  const uint32_t* tab, int32_t* out, int bgbit, uint32_t offset,
                  int32_t half_bg) {
  const size_t smem = sizeof(uint32_t) * static_cast<size_t>(K1 + kPrimes * K1 * L) << LOG_N;
  auto kernel = blind_rotate_kernel<K1, L, LOG_N>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  }
  kernel<<<static_cast<unsigned>(batch), kThreads, smem, stream>>>(
      acc, bara, bk, bksh, tab, out, n, bgbit, offset, half_bg);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

ffi::Error BlindRotateImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> acc,
                           ffi::Buffer<ffi::S32> bara, ffi::Buffer<ffi::U32> bk,
                           ffi::Buffer<ffi::U32> bksh, ffi::Buffer<ffi::U32> tables,
                           ffi::ResultBuffer<ffi::S32> out, int32_t l, int32_t bgbit,
                           uint32_t offset, int32_t half_bg) {
  const auto ad = acc.dimensions();
  const auto bd = bara.dimensions();
  const auto kd = bk.dimensions();
  if (ad.size() != 3 || bd.size() != 2 || kd.size() != 5)
    return ffi::Error::InvalidArgument("want acc [B,k+1,N], bara [B,n], bk [n,2,kpl,k+1,N]");
  const int64_t batch = ad[0], k1 = ad[1], N = ad[2], n = bd[1];
  if (bd[0] != batch || kd[0] != n || kd[1] != kPrimes || kd[2] != k1 * l || kd[3] != k1 ||
      kd[4] != N || bksh.element_count() != bk.element_count())
    return ffi::Error::InvalidArgument("blind rotate operand shapes disagree");
  if (tables.element_count() != kPrimes * (4 * N + 4) + 8)
    return ffi::Error::InvalidArgument("twiddle tables do not match N");
  if (batch == 0) return ffi::Error::Success();
  const int n32 = static_cast<int>(n);
#define TFHE_LAUNCH(K1_, L_, LOG_N_)                                                    \
  if (k1 == K1_ && l == L_ && N == (1 << LOG_N_))                                      \
    return Launch<K1_, L_, LOG_N_>(stream, batch, n32, acc.typed_data(),                \
                                   bara.typed_data(), bk.typed_data(), bksh.typed_data(), \
                                   tables.typed_data(), out->typed_data(), bgbit, offset, \
                                   half_bg);
  TFHE_LAUNCH(2, 2, 7)
  TFHE_LAUNCH(2, 2, 8)
  TFHE_LAUNCH(2, 2, 10)
  TFHE_LAUNCH(2, 3, 10)
#undef TFHE_LAUNCH
  return ffi::Error::InvalidArgument(
      "no kernel instance for k+1=" + std::to_string(k1) + ", l=" + std::to_string(l) +
      ", N=" + std::to_string(N));
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TfheBlindRotate, BlindRotateImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // acc
                                  .Arg<ffi::Buffer<ffi::S32>>()  // bara
                                  .Arg<ffi::Buffer<ffi::U32>>()  // bk_ntt
                                  .Arg<ffi::Buffer<ffi::U32>>()  // bk_ntt_shoup
                                  .Arg<ffi::Buffer<ffi::U32>>()  // tables
                                  .Ret<ffi::Buffer<ffi::S32>>()  // acc out
                                  .Attr<int32_t>("l")
                                  .Attr<int32_t>("bgbit")
                                  .Attr<uint32_t>("offset")
                                  .Attr<int32_t>("half_bg"));
