// blockmax_scan: the block-max scan (K5), which replaces
// shine_tpu/ops/pallas_scan.py: blockmax_scan (_scan_kernel). For bf16 queries
// q (B, dp) against the packed bf16 table ext (N_pad, dp), N_pad % 128 == 0,
// and each 128-row block j (rows 128j .. 128j + 127):
//
//   score(b, r) = sum_k q[b, k] * ext[r, k]   (bf16 products, f32 sums)
//   max1[b, j]  = the best score of the block; arg1[b, j] its row, the lowest
//                 row winning a tie (jnp.argmax)
//   max2[b, j]  = the best of the block with the winner's score replaced by
//                 -3e38 (the Pallas kernel's mask), arg2 its lowest row: a
//                 tied twin of the winner is the runner-up, and a block whose
//                 other rows all score below -3e38 (pad rows score
//                 bf16(-3e38) ~ -3.004e38) gives (-3e38, arg1)
//
// The outputs are (B, N_pad/128) in natural layout (the Pallas kernel stores
// them transposed only for the TPU's tiling).
//
// What bounds it on the H100: tensor-core operations. At the FastFlat shape
// (B = 4096, 1,000,000 real rows at width 130) the products are 1.065e12 FLOP,
// 1.0768 ms at the data sheet's 989 TFLOP/s of dense bf16; the table (289 MB)
// and the four outputs (514 MB) take 0.24 ms at 3.35 TB/s.
//
// What the design does about it. The Pallas kernel reduced a whole
// (tq, tn) VMEM tile at once; here a CTA holds a tile of 128 queries (64 or
// 32 when the queries are too wide for shared memory beside the ring) and
// walks a run of 16 blocks. Each block's 128 rows stream through a 3-stage
// cp.async ring (in column chunks of at most 160), the queries stay
// resident, and 16 warps (8, 4) score a 32-query x 32-row tile each with
// m16n8k16 mma.sync from ldmatrix fragments, as the class-max kernel does.
// After a block's last chunk each thread takes the top two of its 8 cells
// per query row in (score descending, row ascending) order, the four
// threads of a row merge theirs by shuffles, the four warps across the
// block merge through shared memory, and the mask rule above turns the
// block's true runner-up into the Pallas one. The run's results are staged
// in shared memory and written at the end as 64-byte runs of each output.
//
// Left for later: wgmma with TMA-fed tiles, and the cross-warp merge
// without a barrier a block.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kBlk = 128;    // rows a block
constexpr int kRun = 16;     // blocks a CTA walks
constexpr int kWarpQ = 32;   // queries a warp tile
constexpr int kColWarps = 4; // warps across a block's 128 rows
constexpr int kKC = 160;     // widest column chunk of a stage
constexpr int kPad = 8;      // bf16 of padding a shared-memory row
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kEStride = kKC + kPad;
constexpr int kEBuf = kBlk * kEStride;  // bf16 a ring slot
constexpr float kNeg = -3e38f;
constexpr int kSmemMax = 232448;

// Column chunking of a table row: nk chunks of w columns, multiples of 16.
struct Chunks {
  int nk, w;
  __host__ __device__ explicit Chunks(int dp) {
    nk = (dp + kKC - 1) / kKC;
    const int per = (dp + nk - 1) / nk;
    w = (per + 15) / 16 * 16;
  }
};

// The best two (score, row) of a set of rows, in (score descending, row
// ascending) order; an empty slot is (-inf, INT_MAX).
struct Top2 {
  float v1;
  int r1;
  float v2;
  int r2;
};

__device__ __forceinline__ bool ahead(float va, int ra, float vb, int rb) {
  return va > vb || (va == vb && ra < rb);
}

__device__ __forceinline__ void insert(Top2& t, float v, int r) {
  if (ahead(v, r, t.v1, t.r1)) {
    t.v2 = t.v1;
    t.r2 = t.r1;
    t.v1 = v;
    t.r1 = r;
  } else if (ahead(v, r, t.v2, t.r2)) {
    t.v2 = v;
    t.r2 = r;
  }
}

// the top two of the union of two disjoint row sets
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_first = ahead(a.v1, a.r1, b.v1, b.r1);
  const Top2& w = a_first ? a : b;
  const Top2& l = a_first ? b : a;
  Top2 o{w.v1, w.r1, w.v2, w.r2};
  if (ahead(l.v1, l.r1, w.v2, w.r2)) {
    o.v2 = l.v1;
    o.r2 = l.r1;
  }
  return o;
}

__device__ __forceinline__ Top2 shfl_xor(const Top2& t, int mask) {
  return Top2{__shfl_xor_sync(0xffffffffu, t.v1, mask), __shfl_xor_sync(0xffffffffu, t.r1, mask),
              __shfl_xor_sync(0xffffffffu, t.v2, mask), __shfl_xor_sync(0xffffffffu, t.r2, mask)};
}

size_t smem_bytes(int wq, int dp) {
  const size_t tq = size_t(wq) * kWarpQ;
  return (tq * (dp + kPad) + size_t(kStages) * kEBuf) * sizeof(uint16_t)  // queries, ring
         + size_t(kColWarps) * tq * sizeof(Top2)                          // warp merge
         + 4 * tq * kRun * sizeof(float);                                 // staged outputs
}

template <int WQ>
__global__ void __launch_bounds__(WQ * kColWarps * 32, 1)
blockmax_kernel(const uint16_t* __restrict__ ext, const uint16_t* __restrict__ q,
                float* __restrict__ max1, int32_t* __restrict__ arg1,
                float* __restrict__ max2, int32_t* __restrict__ arg2, int B, int dp, int nb) {
  constexpr int kThreads = WQ * kColWarps * 32;
  constexpr int TQ = WQ * kWarpQ;
  extern __shared__ __align__(16) uint16_t smem[];
  const int qstride = dp + kPad;
  uint16_t* q_s = smem;                 // [TQ][qstride]
  uint16_t* e_s = smem + TQ * qstride;  // [kStages][kBlk][kEStride]
  Top2* red = reinterpret_cast<Top2*>(e_s + kStages * kEBuf);    // [kColWarps][TQ]
  uint32_t* out_s = reinterpret_cast<uint32_t*>(red + kColWarps * TQ);  // [4][TQ][kRun]

  const int q0 = blockIdx.x * TQ;
  const int blk0 = blockIdx.y * kRun;
  const int nblk = min(kRun, nb - blk0);
  const int tid = threadIdx.x;
  const Chunks ch(dp);
  const int64_t stages = int64_t(nblk) * ch.nk;

  // the query tile, once; rows past B are zero (their results are dropped)
  const int qpieces = dp / 8;
  for (int i = tid; i < TQ * qpieces; i += kThreads) {
    const int r = i / qpieces, p = i - r * qpieces;
    uint16_t* dst = q_s + r * qstride + p * 8;
    if (q0 + r < B)
      cp_async16(dst, q + int64_t(q0 + r) * dp + p * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }

  // stage (block jb of the run, column chunk kc) into ring slot `slot`
  auto load_stage = [&](int jb, int kc, int slot) {
    const int c0 = kc * ch.w;
    const int pieces = min(ch.w, dp - c0) / 8;
    const uint16_t* src = ext + int64_t(blk0 + jb) * kBlk * dp + c0;
    uint16_t* dst = e_s + slot * kEBuf;
    for (int i = tid; i < kBlk * pieces; i += kThreads) {
      const int r = i / pieces, p = i - r * pieces;
      cp_async16(dst + r * kEStride + p * 8, src + int64_t(r) * dp + p * 8);
    }
  };
  auto advance = [&](int& jb, int& kk, int& slot) {
    if (++kk == ch.nk) {
      kk = 0;
      ++jb;
    }
    if (++slot == kStages) slot = 0;
  };

  int lj = 0, lkc = 0, lslot = 0;  // the load cursor, kStages - 1 stages ahead
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lj < nblk) load_stage(lj, lkc, lslot);
    cp_async_commit();
    advance(lj, lkc, lslot);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wq = warp / kColWarps, wc = warp % kColWarps;
  const uint16_t* a_row = q_s + (wq * kWarpQ + (lane & 15)) * qstride + (lane >> 4) * 8;
  const int b_off = (wc * 32 + (lane & 7) + ((lane >> 4) << 3)) * kEStride +
                    ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, t = lane & 3;

  float acc[2][4][4];
  int jb = 0, kc = 0, slot = 0;
  for (int64_t s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; the slot read in stage s-1 is free
    if (lj < nblk) load_stage(lj, lkc, lslot);
    cp_async_commit();
    advance(lj, lkc, lslot);

    const int c0 = kc * ch.w;
    const int nks = min(ch.w, dp - c0) / 16;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
    const uint16_t* qa = a_row + c0;
    const uint16_t* eb = e_s + slot * kEBuf + b_off;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t a[2][4], b[2][4];
      ldsm_x4(a[0], qa + ks * 16);
      ldsm_x4(a[1], qa + ks * 16 + 16 * qstride);
      ldsm_x4(b[0], eb + ks * 16);
      ldsm_x4(b[1], eb + ks * 16 + 16 * kEStride);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], &b[nt >> 1][(nt & 1) * 2]);
    }

    if (kc == ch.nk - 1) {
      // block jb is scored. Cell (mt, nt, i): query wq*32 + mt*16 + g + 8*(i >= 2),
      // block row wc*32 + nt*8 + 2t + (i & 1).
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Top2 top{-__int_as_float(0x7f800000), INT_MAX, -__int_as_float(0x7f800000), INT_MAX};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              insert(top, acc[mt][nt][2 * h + e], wc * 32 + nt * 8 + 2 * t + e);
          top = merge(top, shfl_xor(top, 1));
          top = merge(top, shfl_xor(top, 2));
          if (t == 0) red[wc * TQ + wq * kWarpQ + mt * 16 + g + 8 * h] = top;
        }
      __syncthreads();
      if (tid < TQ) {
        Top2 top = red[tid];
#pragma unroll
        for (int w = 1; w < kColWarps; ++w) top = merge(top, red[w * TQ + tid]);
        // the Pallas runner-up: the winner's lane masked to exactly -3e38
        float v2 = kNeg;
        int r2 = top.r1;
        if (top.v2 > kNeg) {
          v2 = top.v2;
          r2 = top.r2;
        } else if (top.v2 == kNeg) {
          r2 = min(top.r1, top.r2);
        }
        const int row0 = (blk0 + jb) * kBlk;
        uint32_t* o = out_s + tid * kRun + jb;
        o[0] = __float_as_uint(top.v1);
        o[TQ * kRun] = uint32_t(row0 + top.r1);
        o[2 * TQ * kRun] = __float_as_uint(v2);
        o[3 * TQ * kRun] = uint32_t(row0 + r2);
      }
    }
    advance(jb, kc, slot);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the run's outputs: each query's nblk consecutive columns of each plane
  void* planes[4] = {max1, arg1, max2, arg2};
  for (int i = tid; i < 4 * TQ * kRun; i += kThreads) {
    const int plane = i / (TQ * kRun), rest = i - plane * TQ * kRun;
    const int r = rest / kRun, j = rest - r * kRun;
    if (q0 + r < B && j < nblk)
      static_cast<uint32_t*>(planes[plane])[int64_t(q0 + r) * nb + blk0 + j] = out_s[i];
  }
}

template <int WQ>
int launch(const void* ext, const void* q, int B, int dp, int nb, void* max1, void* arg1,
           void* max2, void* arg2, cudaStream_t stream) {
  const size_t smem = smem_bytes(WQ, dp);
  auto kernel = blockmax_kernel<WQ>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  constexpr int TQ = WQ * kWarpQ;
  const dim3 grid((B + TQ - 1) / TQ, (nb + kRun - 1) / kRun);
  kernel<<<grid, WQ * kColWarps * 32, smem, stream>>>(
      static_cast<const uint16_t*>(ext), static_cast<const uint16_t*>(q),
      static_cast<float*>(max1), static_cast<int32_t*>(arg1), static_cast<float*>(max2),
      static_cast<int32_t*>(arg2), B, dp, nb);
  return int(cudaGetLastError());
}

}  // namespace

// K5. ext (n_pad, dp) bf16, q (B, dp) bf16; max1/arg1/max2/arg2 (B, n_pad/128)
// f32/i32/f32/i32. Needs dp % 16 == 0, n_pad % 128 == 0 and 16-byte aligned
// ext and q. The query tile is 128, else 64 or 32 when that many queries do not
// fit beside the ring. Returns the cudaError_t of the launch; the caller raises
// if not 0.
extern "C" int shine_blockmax_scan(const void* ext, const void* q, int64_t n_pad, int B, int dp,
                                   void* max1, void* arg1, void* max2, void* arg2,
                                   void* stream) {
  if (dp % 16 || n_pad % kBlk || B <= 0 || n_pad / kBlk > int64_t(65535) * kRun)
    return int(cudaErrorInvalidValue);
  const int nb = int(n_pad / kBlk);
  auto s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(4, dp) <= kSmemMax)
    return launch<4>(ext, q, B, dp, nb, max1, arg1, max2, arg2, s);
  if (smem_bytes(2, dp) <= kSmemMax)
    return launch<2>(ext, q, B, dp, nb, max1, arg1, max2, arg2, s);
  if (smem_bytes(1, dp) <= kSmemMax)
    return launch<1>(ext, q, B, dp, nb, max1, arg1, max2, arg2, s);
  return int(cudaErrorInvalidValue);
}
