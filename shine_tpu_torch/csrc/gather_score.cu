// gather_score: gather K candidate rows per query and score them, in one pass.
//
// Replaces shine_tpu/ops/pallas_gather.py:gather_rows_pallas_flat (and its
// 2-D twin gather_rows_pallas) together with the scoring that followed it in
// shine_tpu/models/hnsw.py:_dist_ext. For query b and candidate lane k:
//
//   out[b, k] = +inf                                  if ids[b, k] < 0
//             = bias[b] + s(row) (+ n(row) if l2)      otherwise, row = ids[b, k]
//
//   f32 / bf16 rows: s = sum_j q_ext[b, j] * v[row, j],  n = sum_j v[row, j]^2
//   int8 rows:       s = row_scl[row] * sum_j q_ext[b, j] * v[row, j],
//                    n = row_nrm[row]
//
// All sums are f32. An id >= N yields NaN; no row is read out of bounds.
//
// What bounds it on the H100: device-memory bytes. One HNSW beam step at
// B=4096 queries, K=256 lanes, d=128 reads up to B*K*d*4 B ~ 537 MB of f32
// rows (bf16 268 MB, int8 134 MB) and does at most 1 flop per byte, far
// below the ~20 flop/byte (67 TFLOP/s fp32 over 3.35 TB/s, data sheet)
// where f32 compute would bind; at the data sheet's 3.35 TB/s the full f32
// step cannot take less than ~160 us. Measured with 10% of lanes masked:
// 0.207 ms for f32 rows, 2.3 TB/s (NVIDIA H100 80GB HBM3, 700.00 W).
//
// What the design does about it: every row is read from device memory once
// and scored from registers. The plain version materialises the (B, K, d)
// gathered tile in device memory and reads it back for the dot and again for
// the norm; here the dot and the square-sum come out of the same 16-byte
// loads and meet in one warp-shuffle reduction, so the bytes moved are the
// rows themselves plus 4 B per output. One block per query keeps q_ext[b] in
// shared memory; each of its 8 warps takes one candidate row at a time, its
// 32 lanes reading the row as neighbouring 16-byte packs (a 512 B f32 row is
// four whole 128 B lines, one pack per lane). Enough warps are resident per
// SM (64) to keep ~32 KB of row loads in flight there. Rows whose byte width
// or base address is not a multiple of 16 take an element-wise loop.
//
// Left for later: cp.async/TMA pipelining of the next rows, packing several
// narrow (bf16/int8) rows into one warp, and the fused beam step that keeps
// each query's beam in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// 16-byte packs of row elements -> floats. bf16 is carried as its raw 16 bits:
// the float with the same top 16 bits is its exact value.
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int n = 4;
  __device__ static void unpack(uint4 v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  __device__ static float one(float x) { return x; }
};

template <> struct Pack<uint16_t> {
  static constexpr int n = 8;
  __device__ static void unpack(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float one(uint16_t x) { return __uint_as_float(uint32_t(x) << 16); }
};

template <> struct Pack<int8_t> {
  static constexpr int n = 16;
  __device__ static void unpack(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = float(int8_t((w[i] >> (8 * j)) & 0xffu));
  }
  __device__ static float one(int8_t x) { return float(x); }
};

template <typename T, bool VEC, bool QUANT>
__global__ void __launch_bounds__(kThreads)
gather_score_kernel(const T* __restrict__ vectors, const float* __restrict__ q_ext,
                    const float* __restrict__ bias, const int32_t* __restrict__ ids,
                    const float* __restrict__ row_scl, const float* __restrict__ row_nrm,
                    float* __restrict__ out, int64_t n_rows, int K, int d, bool l2) {
  extern __shared__ float4 q_smem[];
  float* q_s = reinterpret_cast<float*>(q_smem);
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += kThreads) q_s[j] = q_ext[int64_t(b) * d + j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float bb = bias[b];
  for (int k = warp; k < K; k += kWarps) {
    const int32_t id = ids[int64_t(b) * K + k];  // uniform across the warp
    float res;
    if (id < 0) {
      res = __int_as_float(0x7f800000);  // +inf
    } else if (id >= n_rows) {
      res = __int_as_float(0x7fffffff);  // NaN: id out of range
    } else {
      const T* row = vectors + int64_t(id) * d;
      float dot = 0.f, sq = 0.f;
      if (VEC) {
        constexpr int P = Pack<T>::n;
        const uint4* rv = reinterpret_cast<const uint4*>(row);
        for (int p = lane; p < d / P; p += 32) {
          float f[P];
          Pack<T>::unpack(__ldg(rv + p), f);
#pragma unroll
          for (int c = 0; c < P / 4; ++c) {
            const float4 q = q_smem[p * (P / 4) + c];
            dot = fmaf(q.x, f[4 * c], dot);
            dot = fmaf(q.y, f[4 * c + 1], dot);
            dot = fmaf(q.z, f[4 * c + 2], dot);
            dot = fmaf(q.w, f[4 * c + 3], dot);
          }
          if (!QUANT) {
#pragma unroll
            for (int j = 0; j < P; ++j) sq = fmaf(f[j], f[j], sq);
          }
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float f = Pack<T>::one(row[j]);
          dot = fmaf(q_s[j], f, dot);
          if (!QUANT) sq = fmaf(f, f, sq);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (!QUANT) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      if (QUANT) {
        dot *= row_scl[id];
        if (l2) dot += row_nrm[id];
      } else if (l2) {
        dot += sq;
      }
      res = bb + dot;
    }
    if (lane == 0) out[int64_t(b) * K + k] = res;
  }
}

template <typename T, bool QUANT>
void launch(const void* vectors, const float* q_ext, const float* bias, const int32_t* ids,
            const float* row_scl, const float* row_nrm, float* out, int64_t n_rows, int B,
            int K, int d, bool l2, cudaStream_t stream) {
  const size_t smem = size_t(d) * sizeof(float);
  const bool vec = (size_t(d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  const T* v = static_cast<const T*>(vectors);
  if (vec)
    gather_score_kernel<T, true, QUANT><<<B, kThreads, smem, stream>>>(
        v, q_ext, bias, ids, row_scl, row_nrm, out, n_rows, K, d, l2);
  else
    gather_score_kernel<T, false, QUANT><<<B, kThreads, smem, stream>>>(
        v, q_ext, bias, ids, row_scl, row_nrm, out, n_rows, K, d, l2);
}

}  // namespace

// row_type: 0 f32, 1 bf16, 2 int8 (row_scl required; row_nrm when l2).
// Returns the cudaError_t of the launch; the caller raises if it is not 0.
extern "C" int shine_gather_score(const void* vectors, int row_type, const void* q_ext,
                                  const void* bias, const void* ids, const void* row_scl,
                                  const void* row_nrm, void* out, int64_t n_rows, int B,
                                  int K, int d, int l2, void* stream) {
  const auto* q = static_cast<const float*>(q_ext);
  const auto* bi = static_cast<const float*>(bias);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* scl = static_cast<const float*>(row_scl);
  const auto* nrm = static_cast<const float*>(row_nrm);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (row_type) {
    case 0: launch<float, false>(vectors, q, bi, id, scl, nrm, o, n_rows, B, K, d, l2, s); break;
    case 1: launch<uint16_t, false>(vectors, q, bi, id, scl, nrm, o, n_rows, B, K, d, l2, s); break;
    case 2: launch<int8_t, true>(vectors, q, bi, id, scl, nrm, o, n_rows, B, K, d, l2, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
