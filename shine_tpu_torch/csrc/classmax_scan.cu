// classmax_scan: the exact top-kb select over the class lanes that ends the
// fused forms of the brute-force class-max scans of FastFlatIndex (K2) and
// SplitFlatIndex (K3), whose scan is the kernel of classmax2_scan.cu (which
// also holds the routed scan K4 and the chunked scan K6).
//
// Per query, the select takes the kb lanes of largest best in (value
// descending, lane ascending) order and gathers rows (and best2, rows2) at
// them: the select of shine_tpu/ops/pallas_scan3.py's classmax_topk_scan
// and classmax2_topk_scan and of pallas_scan_split.py's _topk_epilogue, the
// scan followed by an exact top-kb and a gather.
//
// What bounds it: reading the (B, cls) planes once, 4096 x 2048 x 8 bytes
// (16 for keep2) at the K2/K3 shapes, 0.02-0.04 ms at 3.35 TB/s. One warp a
// query keeps the query's cls lanes in shared memory and runs kb rounds of a
// warp argmax over them.
//
// Left for later: fusing the select into the scan's epilogue.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSelWarps = 4;

// One warp per query: kb rounds of a warp argmax over the query's cls lanes
// (held in shared memory), each round taking the first lane in (value
// descending, lane ascending) order that comes after the previous pick.
__global__ void __launch_bounds__(kSelWarps * 32)
select_kernel(const float* __restrict__ best, const int32_t* __restrict__ rows,
              const float* __restrict__ best2, const int32_t* __restrict__ rows2, int B,
              int cls, int kb, float* __restrict__ out_best, int32_t* __restrict__ out_rows,
              float* __restrict__ out_best2, int32_t* __restrict__ out_rows2) {
  extern __shared__ float sel_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSelWarps + warp;
  if (b >= B) return;
  float* v = sel_s + warp * cls;
  const int64_t base = int64_t(b) * cls;
  for (int j = lane; j < cls; j += 32) v[j] = best[base + j];
  __syncwarp();
  float pv = 0.f;
  int pj = -1;  // no pick yet
  for (int r = 0; r < kb; ++r) {
    float bv = -__int_as_float(0x7f800000);
    int bj = 0x7fffffff;
    for (int j = lane; j < cls; j += 32) {
      const float x = v[j];
      const bool after = pj < 0 || x < pv || (x == pv && j > pj);
      if (after && (x > bv || (x == bv && j < bj))) {
        bv = x;
        bj = j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
      if (ov > bv || (ov == bv && oj < bj)) {
        bv = ov;
        bj = oj;
      }
    }
    if (lane == 0) {
      const int64_t o = int64_t(b) * kb + r;
      out_best[o] = bv;
      out_rows[o] = rows[base + bj];
      if (best2 != nullptr) {
        out_best2[o] = best2[base + bj];
        out_rows2[o] = rows2[base + bj];
      }
    }
    pv = bv;
    pj = bj;
  }
}

}  // namespace

// Top-kb lanes of best (B, cls) per query, in (value desc, lane asc) order,
// with rows (and best2/rows2 when not null) gathered at them into (B, kb).
extern "C" int shine_classmax_select(const void* best, const void* rows, const void* best2,
                                     const void* rows2, int B, int cls, int kb,
                                     void* out_best, void* out_rows, void* out_best2,
                                     void* out_rows2, void* stream) {
  if (kb <= 0 || kb > cls || B <= 0) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(kSelWarps) * cls * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(select_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  select_kernel<<<(B + kSelWarps - 1) / kSelWarps, kSelWarps * 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(best), static_cast<const int32_t*>(rows),
      static_cast<const float*>(best2), static_cast<const int32_t*>(rows2), B, cls, kb,
      static_cast<float*>(out_best), static_cast<int32_t*>(out_rows),
      static_cast<float*>(out_best2), static_cast<int32_t*>(out_rows2));
  return int(cudaGetLastError());
}
