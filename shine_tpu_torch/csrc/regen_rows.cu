// Row-keyed rows regenerated by id, and their exact f32 distances to
// queries, on one CUDA card: the kernels behind shine_tpu_torch/ops/regen.py.
//
// Not a port of a Pallas kernel. In the JAX package this work is an XLA
// fusion: shine_tpu/io/device_synth.py:regen_rows (a vmapped
// jax.random.fold_in / split / randint / normal) and the einsum of
// shine_tpu/ops/distance.py:regen_rerank_topk. It is a kernel here because
// of its cost: plain torch regenerates a row through ~150 elementwise
// int64 passes, each reading and writing the whole (rows, d) tensor.
//
// Bound: integer operations. A row costs 7 threefry2x32 hashes (fold_in,
// split, randint's split and two draws) and each of its d elements one
// more, ~80 32-bit integer operations a hash, plus XLA's f32 erf_inv; the
// bytes (ids, queries, the output) are ~1% of that at d=128. Design: one
// thread a row (regen_rows) or a (query, candidate) pair (regen_score),
// the row's draw made once in registers, its d elements generated in index
// order and folded into the sums as they come: nothing but the result
// touches memory, and every sum runs over d in index order, so a query's
// score does not depend on its batch.
//
// ops/_build.py compiles this file with -fmad=false: every f32 multiply and
// add rounds on its own, as torch's elementwise ops do. The two
// multiply-adds that XLA fuses (the uniform's and the erf_inv
// polynomial's) are a f64 multiply and add rounded to f32, as in the plain
// version, and log1pf, sqrtf and the divisions are the ones torch's CUDA
// ops call. So the kernels equal ops/regen.py's plain versions bit for bit
// on the card.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax/_src/prng.py:_threefry2x32_lowering, 20 rounds
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, kRot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// random_bits(key, 32) at flat index i: the xor of the hash of (0, i)
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint32_t i) {
  uint32_t x0 = 0, x1 = i;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

struct RowDraw {
  uint32_t kn0, kn1;  // the key of the row's normals
  int a;              // its cluster
};

// kk = fold_in(key, id); ka, kn = split(kk); a = randint(ka, (), 0, nc)
__device__ __forceinline__ RowDraw row_draw(uint32_t k0, uint32_t k1,
                                            uint32_t id, uint32_t nc) {
  uint32_t kk0 = 0, kk1 = id;
  threefry2x32(k0, k1, kk0, kk1);
  uint32_t ka0 = 0, ka1 = 0, kn0 = 0, kn1 = 1;
  threefry2x32(kk0, kk1, ka0, ka1);
  threefry2x32(kk0, kk1, kn0, kn1);
  uint32_t h0 = 0, h1 = 0, l0 = 0, l1 = 1;  // randint's own split of ka
  threefry2x32(ka0, ka1, h0, h1);
  threefry2x32(ka0, ka1, l0, l1);
  const uint32_t hi = bits_at(h0, h1, 0), lo = bits_at(l0, l1, 0);
  uint32_t mult = 65536u % nc;
  mult = (mult * mult) % nc;  // wrapping uint32, as JAX's
  const uint32_t off = ((hi % nc) * mult + lo % nc) % nc;
  return {kn0, kn1, static_cast<int>(off)};
}

// a * b + c as XLA's fused multiply-add: f64 multiply (exact) and add,
// rounded to f32
__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a),
                                               static_cast<double>(b)),
                                     static_cast<double>(c)));
}

// XLA's ErfInv32
__device__ __forceinline__ float erf_inv_xla(float x) {
  constexpr float kLt5[9] = {2.81022636e-08f,  3.43273939e-07f,
                             -3.5233877e-06f,  -4.39150654e-06f,
                             0.00021858087f,   -0.00125372503f,
                             -0.00417768164f,  0.246640727f,
                             1.50140941f};
  constexpr float kGe5[9] = {-0.000200214257f, 0.000100950558f,
                             0.00134934322f,   -0.00367342844f,
                             0.00573950773f,   -0.0076224613f,
                             0.00943887047f,   1.00167406f,
                             2.83297682f};
  const float w0 = -log1pf(-(x * x));
  const bool lt = w0 < 5.0f;
  const float w = lt ? w0 - 2.5f : sqrtf(w0) - 3.0f;
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = mul_add(p, w, lt ? kLt5[i] : kGe5[i]);
  return fabsf(x) == 1.0f ? x * FLT_MAX : p * x;
}

// jax.random.normal's element j under the key kn: sqrt(2) * erf_inv(u), u
// uniform in (nextafter(-1, 0), 1)
__device__ __forceinline__ float normal_at(uint32_t kn0, uint32_t kn1,
                                           uint32_t j) {
  const uint32_t b = bits_at(kn0, kn1, j);
  const float f = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
  const float lo = __uint_as_float(0xBF7FFFFFu);
  const float u = fmaxf(lo, mul_add(f, 1.0f - lo, lo));
  return __uint_as_float(0x3FB504F3u) * erf_inv_xla(u);
}

__global__ void regen_rows_kernel(uint32_t k0, uint32_t k1,
                                  const float* __restrict__ centers,
                                  uint32_t nc, int d,
                                  const int* __restrict__ ids, int64_t m,
                                  int normalize, float* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m) return;
  const RowDraw rd = row_draw(k0, k1, static_cast<uint32_t>(ids[r]), nc);
  const float* c = centers + static_cast<int64_t>(rd.a) * d;
  float* o = out + r * d;
  float s = 0.0f;
  for (int j = 0; j < d; ++j) {
    const float x = c[j] + normal_at(rd.kn0, rd.kn1, j);
    o[j] = x;
    const float sq = x * x;
    s = j == 0 ? sq : s + sq;
  }
  if (!normalize) return;
  const float den = sqrtf(s) + 1e-30f;
  for (int j = 0; j < d; ++j) o[j] = o[j] / den;
}

__global__ void regen_score_kernel(uint32_t k0, uint32_t k1,
                                   const float* __restrict__ centers,
                                   uint32_t nc, int d,
                                   const float* __restrict__ q,
                                   const int* __restrict__ cand, int B, int K,
                                   int ip, float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(B) * K) return;
  const int id = cand[t];
  if (id < 0) {
    out[t] = __uint_as_float(0x7F800000u);  // +inf
    return;
  }
  const RowDraw rd = row_draw(k0, k1, static_cast<uint32_t>(id), nc);
  const float* c = centers + static_cast<int64_t>(rd.a) * d;
  const float* qb = q + (t / K) * d;
  if (!ip) {
    float qn = 0.0f, dot = 0.0f, rn = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float v = c[j] + normal_at(rd.kn0, rd.kn1, j);
      const float qq = qb[j] * qb[j], qv = qb[j] * v, vv = v * v;
      qn = j == 0 ? qq : qn + qq;
      dot = j == 0 ? qv : dot + qv;
      rn = j == 0 ? vv : rn + vv;
    }
    out[t] = (qn - 2.0f * dot) + rn;
    return;
  }
  float s = 0.0f;  // the row's norm first, then its unit row against q
  for (int j = 0; j < d; ++j) {
    const float x = c[j] + normal_at(rd.kn0, rd.kn1, j);
    const float sq = x * x;
    s = j == 0 ? sq : s + sq;
  }
  const float den = sqrtf(s) + 1e-30f;
  float dot = 0.0f;
  for (int j = 0; j < d; ++j) {
    const float v = (c[j] + normal_at(rd.kn0, rd.kn1, j)) / den;
    const float qv = qb[j] * v;
    dot = j == 0 ? qv : dot + qv;
  }
  out[t] = 1.0f - dot;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int shine_regen_rows(uint32_t k0, uint32_t k1, const float* centers,
                                int nc, int d, const int* ids, int64_t m,
                                int normalize, float* out,
                                cudaStream_t stream) {
  if (m <= 0) return 0;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  regen_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      k0, k1, centers, static_cast<uint32_t>(nc), d, ids, m, normalize, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shine_regen_score(uint32_t k0, uint32_t k1,
                                 const float* centers, int nc, int d,
                                 const float* q, const int* cand, int B, int K,
                                 int ip, float* out, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(B) * K;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  regen_score_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      k0, k1, centers, static_cast<uint32_t>(nc), d, q, cand, B, K, ip, out);
  return static_cast<int>(cudaGetLastError());
}
