// Native exact TFHE engine (C++17 + OpenMP).
//
// The JAX framework's host-side twin of the reference's CPU path
// (cpuParallel/ + the CPU originals inside gpuParallel/*.cu): an exact
// integer implementation of the full gate-bootstrapping pipeline used as
//   (a) a fast differential oracle for the JAX pipeline (bit-exact:
//       both sides are exact integer arithmetic),
//   (b) the "CPU framework" capability of the reference (OpenMP-batched
//       gates, cpuParallel/Cipher.cpp:88-121), and
//   (c) a host evaluator that needs no accelerator.
//
// Written from scratch against the documented semantics (SURVEY.md sections
// 0-3); polynomial products are O(N^2) int64 negacyclic convolutions (exact),
// not FFTs, so results match the JAX NTT pipeline bit-for-bit.
//
// C ABI only; bound from Python via ctypes (tfhe_tpu/native_ref.py).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

struct TfheParamsC {
  int32_t n;        // LWE dimension
  int32_t N;        // ring degree
  int32_t k;        // TLWE mask count
  int32_t l;        // gadget length
  int32_t Bgbit;    // gadget base bits
  int32_t basebit;  // key-switch digit bits
  int32_t t;        // key-switch digit count
};

// ---------------------------------------------------------------- helpers

static inline uint32_t u32(int32_t x) { return static_cast<uint32_t>(x); }
static inline int32_t i32(uint32_t x) { return static_cast<int32_t>(x); }

// X^a * src in Z[X]/(X^N+1), a in [0, 2N)
// (semantics of torusPolynomialMulByXai, toruspolynomial-functions.cu:492)
static void mul_by_xai(int32_t* out, int a, const int32_t* src, int N) {
  if (a < N) {
    for (int i = 0; i < a; i++) out[i] = i32(0u - u32(src[i - a + N]));
    for (int i = a; i < N; i++) out[i] = src[i - a];
  } else {
    int aa = a - N;
    for (int i = 0; i < aa; i++) out[i] = src[i - aa + N];
    for (int i = aa; i < N; i++) out[i] = i32(0u - u32(src[i - aa]));
  }
}

// exact negacyclic product: small (int) x torus32, accumulated mod 2^32
static void polymul_acc(uint32_t* acc, const int32_t* small, const int32_t* torus, int N) {
  for (int i = 0; i < N; i++) {
    int64_t s = small[i];
    if (s == 0) continue;
    uint32_t su = u32(static_cast<int32_t>(s));
    for (int j = 0; j < N; j++) {
      uint32_t prod = su * u32(torus[j]);
      int idx = i + j;
      if (idx < N) acc[idx] += prod;
      else acc[idx - N] -= prod;
    }
  }
}

static inline int mod_switch_from_torus32(int32_t phase, int Msize) {
  uint64_t interv = ((UINT64_C(1) << 63) / Msize) * 2;
  uint64_t phase64 = (static_cast<uint64_t>(u32(phase)) << 32) + interv / 2;
  return static_cast<int>(phase64 / interv);
}

// ---------------------------------------------------------------- exports

void tfhe_polymul(const int32_t* a, const int32_t* b, int32_t* out, int N) {
  std::vector<uint32_t> acc(N, 0);
  polymul_acc(acc.data(), a, b, N);
  for (int i = 0; i < N; i++) out[i] = i32(acc[i]);
}

// One gate bootstrap (blind rotate + extract + key switch), exact.
// bk: int32[n, kpl, k+1, N]; ks_a: int32[kN, t, base, n]; ks_b: int32[kN, t, base]
void tfhe_bootstrap_one(const TfheParamsC* P, const int32_t* in_a, int32_t in_b,
                        int32_t mu, const int32_t* bk, const int32_t* ks_a,
                        const int32_t* ks_b, int32_t* out_a, int32_t* out_b) {
  const int n = P->n, N = P->N, k = P->k, l = P->l;
  const int kpl = (k + 1) * l;
  const int Nx2 = 2 * N;
  const uint32_t maskMod = (1u << P->Bgbit) - 1;
  const int32_t halfBg = 1 << (P->Bgbit - 1);
  uint32_t offset = 0;
  for (int i = 0; i < l; i++) offset += 1u << (32 - (i + 1) * P->Bgbit);
  offset *= static_cast<uint32_t>(halfBg);

  // mod-switch
  int barb = mod_switch_from_torus32(in_b, Nx2);
  std::vector<int> bara(n);
  for (int i = 0; i < n; i++) bara[i] = mod_switch_from_torus32(in_a[i], Nx2);

  // acc = (0, X^{2N-barb} * [mu,...,mu])
  std::vector<int32_t> acc((k + 1) * N, 0);
  {
    std::vector<int32_t> tv(N, mu);
    if (barb != 0) mul_by_xai(acc.data() + k * N, Nx2 - barb, tv.data(), N);
    else std::memcpy(acc.data() + k * N, tv.data(), N * sizeof(int32_t));
  }

  // blind rotate (tfhe_blindRotate semantics)
  std::vector<int32_t> rot((k + 1) * N);
  std::vector<int32_t> dec(kpl * N);
  std::vector<uint32_t> prod((k + 1) * N);
  for (int j = 0; j < n; j++) {
    if (bara[j] == 0) continue;
    // (X^a - 1) * acc
    for (int c = 0; c <= k; c++) {
      mul_by_xai(rot.data() + c * N, bara[j], acc.data() + c * N, N);
      for (int i = 0; i < N; i++)
        rot[c * N + i] = i32(u32(rot[c * N + i]) - u32(acc[c * N + i]));
    }
    // gadget decompose
    for (int c = 0; c <= k; c++) {
      for (int i = 0; i < N; i++) {
        uint32_t u = u32(rot[c * N + i]) + offset;
        for (int p = 0; p < l; p++) {
          uint32_t d = (u >> (32 - (p + 1) * P->Bgbit)) & maskMod;
          dec[(c * l + p) * N + i] = static_cast<int32_t>(d) - halfBg;
        }
      }
    }
    // external product: acc += sum_row dec_row (x) bk[j, row]
    std::fill(prod.begin(), prod.end(), 0u);
    const int32_t* bkj = bk + static_cast<int64_t>(j) * kpl * (k + 1) * N;
    for (int row = 0; row < kpl; row++)
      for (int c = 0; c <= k; c++)
        polymul_acc(prod.data() + c * N, dec.data() + row * N,
                    bkj + (row * (k + 1) + c) * N, N);
    for (int c = 0; c <= k; c++)
      for (int i = 0; i < N; i++)
        acc[c * N + i] = i32(u32(acc[c * N + i]) + prod[c * N + i]);
  }

  // sample extract (index 0)
  const int nExt = k * N;
  std::vector<int32_t> a_ext(nExt);
  for (int c = 0; c < k; c++) {
    a_ext[c * N] = acc[c * N];
    for (int jj = 1; jj < N; jj++)
      a_ext[c * N + jj] = i32(0u - u32(acc[c * N + N - jj]));
  }
  int32_t b_ext = acc[k * N];

  // key switch
  const int base = 1 << P->basebit;
  const int32_t prec_offset = 1 << (32 - (1 + P->basebit * P->t));
  std::vector<uint32_t> res_a(n, 0);
  uint32_t res_b = u32(b_ext);
  for (int i = 0; i < nExt; i++) {
    uint32_t aibar = u32(a_ext[i]) + u32(prec_offset);
    for (int jj = 0; jj < P->t; jj++) {
      uint32_t aij = (aibar >> (32 - (jj + 1) * P->basebit)) & (base - 1);
      if (aij != 0) {
        const int32_t* row = ks_a + ((static_cast<int64_t>(i) * P->t + jj) * base + aij) * n;
        for (int q = 0; q < n; q++) res_a[q] -= u32(row[q]);
        res_b -= u32(ks_b[(static_cast<int64_t>(i) * P->t + jj) * base + aij]);
      }
    }
  }
  for (int q = 0; q < n; q++) out_a[q] = i32(res_a[q]);
  *out_b = i32(res_b);
}

// Batched bootstraps, OpenMP-parallel across the batch (the cpuParallel
// analog: one thread per independent bit, Cipher.cpp:114-121).
void tfhe_bootstrap_batch(const TfheParamsC* P, const int32_t* in_a,
                          const int32_t* in_b, int32_t mu, const int32_t* bk,
                          const int32_t* ks_a, const int32_t* ks_b, int batch,
                          int32_t* out_a, int32_t* out_b) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < batch; i++) {
    tfhe_bootstrap_one(P, in_a + static_cast<int64_t>(i) * P->n, in_b[i], mu,
                       bk, ks_a, ks_b, out_a + static_cast<int64_t>(i) * P->n,
                       out_b + i);
  }
}

// Bootstrapped 2-input gate batch: temp = (0,const) + ca*x + cb*y -> bootstrap.
// (gate tables at boot-gates.cu:98-448)
void tfhe_gate2_batch(const TfheParamsC* P, int32_t gate_const, int32_t coef_a,
                      int32_t coef_b, const int32_t* xa, const int32_t* xb,
                      const int32_t* ya, const int32_t* yb, int32_t mu,
                      const int32_t* bk, const int32_t* ks_a, const int32_t* ks_b,
                      int batch, int32_t* out_a, int32_t* out_b) {
  const int n = P->n;
  std::vector<int32_t> ta(static_cast<int64_t>(batch) * n);
  std::vector<int32_t> tb(batch);
  for (int i = 0; i < batch; i++) {
    for (int q = 0; q < n; q++)
      ta[static_cast<int64_t>(i) * n + q] =
          i32(u32(coef_a) * u32(xa[static_cast<int64_t>(i) * n + q]) +
              u32(coef_b) * u32(ya[static_cast<int64_t>(i) * n + q]));
    tb[i] = i32(u32(gate_const) + u32(coef_a) * u32(xb[i]) + u32(coef_b) * u32(yb[i]));
  }
  tfhe_bootstrap_batch(P, ta.data(), tb.data(), mu, bk, ks_a, ks_b, batch,
                       out_a, out_b);
}

// Gate constants (boot-gates.cu:106,132; 1/8 and 1/4 on the torus)
static const int32_t kMu = 1 << 29;        // 1/8
static const int32_t kXorConst = 1 << 30;  // 1/4

// n-bit ripple-carry adder over LWE bit-planes — the native twin of the
// reference CPU framework's Cipher::addBits full adder (cpuParallel/
// Cipher.cpp:381-392) and of tfhe_tpu.arith.add (bitwise GPU_1 form):
//   bit 0:  s0 = XOR(a0,b0), c = AND(a0,b0)
//   bit i:  t0 = XOR(ai,c); t1 = XOR(bi,c); t = AND(t0,t1);
//           si = XOR(ai,t1); c' = XOR(t,c)
// Layout: xa [batch, nbits, n] C-order, xb [batch, nbits]; out same.
// Every gate stage bootstraps the whole batch in one OMP-parallel sweep.
void tfhe_ripple_add(const TfheParamsC* P, const int32_t* xa, const int32_t* xb,
                     const int32_t* ya, const int32_t* yb, int nbits, int batch,
                     const int32_t* bk, const int32_t* ks_a, const int32_t* ks_b,
                     int32_t* out_a, int32_t* out_b) {
  const int n = P->n;
  const int64_t stride = static_cast<int64_t>(nbits) * n;
  auto bit_a = [&](const int32_t* base, int i, int bit) {
    return base + static_cast<int64_t>(i) * stride + static_cast<int64_t>(bit) * n;
  };
  std::vector<int32_t> sel_xa(static_cast<int64_t>(batch) * n), sel_xb(batch);
  std::vector<int32_t> sel_ya(static_cast<int64_t>(batch) * n), sel_yb(batch);
  std::vector<int32_t> carry_a(static_cast<int64_t>(batch) * n), carry_b(batch);
  std::vector<int32_t> t0_a(static_cast<int64_t>(batch) * n), t0_b(batch);
  std::vector<int32_t> t1_a(static_cast<int64_t>(batch) * n), t1_b(batch);
  std::vector<int32_t> t_a(static_cast<int64_t>(batch) * n), t_b(batch);

  auto gather = [&](const int32_t* aa, const int32_t* ab, int bit,
                    std::vector<int32_t>& da, std::vector<int32_t>& db) {
    for (int i = 0; i < batch; i++) {
      std::memcpy(da.data() + static_cast<int64_t>(i) * n, bit_a(aa, i, bit),
                  n * sizeof(int32_t));
      db[i] = ab[static_cast<int64_t>(i) * nbits + bit];
    }
  };
  auto gate = [&](int32_t gconst, int32_t ca, int32_t cb,
                  const std::vector<int32_t>& pa, const std::vector<int32_t>& pb,
                  const std::vector<int32_t>& qa, const std::vector<int32_t>& qb,
                  std::vector<int32_t>& ra, std::vector<int32_t>& rb) {
    tfhe_gate2_batch(P, gconst, ca, cb, pa.data(), pb.data(), qa.data(),
                     qb.data(), kMu, bk, ks_a, ks_b, batch, ra.data(), rb.data());
  };
  auto scatter = [&](int bit, const std::vector<int32_t>& ra,
                     const std::vector<int32_t>& rb) {
    for (int i = 0; i < batch; i++) {
      std::memcpy(out_a + static_cast<int64_t>(i) * stride + static_cast<int64_t>(bit) * n,
                  ra.data() + static_cast<int64_t>(i) * n, n * sizeof(int32_t));
      out_b[static_cast<int64_t>(i) * nbits + bit] = rb[i];
    }
  };

  gather(xa, xb, 0, sel_xa, sel_xb);
  gather(ya, yb, 0, sel_ya, sel_yb);
  gate(kXorConst, 2, 2, sel_xa, sel_xb, sel_ya, sel_yb, t0_a, t0_b);  // s0
  scatter(0, t0_a, t0_b);
  gate(-kMu, 1, 1, sel_xa, sel_xb, sel_ya, sel_yb, carry_a, carry_b); // c = AND
  for (int bit = 1; bit < nbits; bit++) {
    gather(xa, xb, bit, sel_xa, sel_xb);
    gather(ya, yb, bit, sel_ya, sel_yb);
    gate(kXorConst, 2, 2, sel_xa, sel_xb, carry_a, carry_b, t0_a, t0_b);  // t0
    gate(kXorConst, 2, 2, sel_ya, sel_yb, carry_a, carry_b, t1_a, t1_b);  // t1
    gate(-kMu, 1, 1, t0_a, t0_b, t1_a, t1_b, t_a, t_b);                   // t
    gate(kXorConst, 2, 2, sel_xa, sel_xb, t1_a, t1_b, t0_a, t0_b);        // si
    scatter(bit, t0_a, t0_b);
    gate(kXorConst, 2, 2, t_a, t_b, carry_a, carry_b, t1_a, t1_b);        // c'
    carry_a.swap(t1_a);
    carry_b.swap(t1_b);
  }
}

int tfhe_native_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
