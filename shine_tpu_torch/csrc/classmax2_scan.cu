// classmax2_scan: the keep2 class-max scan, the class winners and their
// runner-ups, on FastFlat's packed bf16 table (K2b, and K2d's scan before the
// select kernel of classmax_scan.cu) and on SplitFlat's split table in bf16
// or int8 (K3a/K3b with keep2).
//
// It replaces shine_tpu/ops/pallas_scan3.py: classmax2_scan (_kernel2) and
// classmax2_topk_scan (_kernel2_topk), and shine_tpu/ops/pallas_scan_split.py:
// classmax_scan_split and classmax_topk_scan_split with keep2 (_kernel_split).
// For query b and class c (row r belongs to class r % cls):
//
//   K2 score(b, r) = sum_j q[b, j] * ext[r, j]          (bf16 products, f32 sums)
//   K3 score(b, r) = scl[r] * sum_j q[b, j] * comp[r, j] + nrm[r]
//                    (product and sum rounded once each, no FMA; int8 comp is
//                    widened to bf16 exactly; pad rows score exactly -3e38)
//   best/rows      = the best score of class c and its row, strict > in
//                    increasing row order (the earliest row wins a tie), from
//                    the start state (-3e38, code 0); rows = code*cls + c
//   best2/rows2    = the runner-up by _kernel2's demotion rule: the old winner
//                    drops to the runner-up slot when beaten; a challenger takes
//                    the slot only if it beats the runner-up and not the winner.
//                    The update keeps the select form: fmaxf/fminf may turn a
//                    -0.0 tie into +0.0, which the strict > never does.
//
// What bounds it on the H100: tensor-core operations. B=4096 queries against
// the 1,000,000 real rows of a 1M x 128 set are 2*B*1e6*130 FLOP for K2 (width
// d+2), 1.0768 ms at the data sheet's 989 TFLOP/s of dense bf16, and
// 2*B*1e6*128 for K3, 1.0602 ms; the tables (289 MB, 268 MB, 138 MB) take under
// 0.09 ms at 3.35 TB/s. Its times are in PERF.md.
//
// What the design does about it. The keep2 state is 128 registers a thread
// (winner, runner-up and their member codes for 32 cells), and its update costs
// ~8 instructions a cell a member: run after the products, as the mma.sync
// kernel of classmax_scan.cu did, it took more time than the products. Here the
// update of one member overlaps the products of the next:
//   - A CTA owns 128 queries x 64 classes (64 x 64 at a wide dp): one or two
//     consumer warpgroups of 64 queries each, and one producer warpgroup.
//   - The producer streams member m's 64 table rows (rows m*cls + lane0 ..
//     +63, in column chunks when dp is wide) into a ring of up to 6 slots: one
//     thread issues a TMA load a stage, through a 4-D view of the table whose
//     box lands in the wgmma core-matrix layout (no swizzle, K-major), and
//     bulk copies of K3's 64 nrm and 64 scl beside it. Each slot has a full
//     and an empty mbarrier; no __syncthreads runs in the main loop, so the
//     two consumer warpgroups drift apart. An int8 table lands raw by TMA in
//     a 3-deep ring of its own, and the producer warpgroup widens it into the
//     bf16 slot before it arrives: the consumers see bf16 only.
//   - The query tile is written once, in the core-matrix layout, and both
//     operands of wgmma.mma_async m64n64k16 come from shared memory: no
//     fragments are loaded per member.
//   - Each consumer keeps two accumulator sets. It issues member m+1's wgmma
//     group into one, waits (wgmma.wait_group 1) for member m's group in the
//     other, scales and shifts it (K3), runs the update on it while the tensor
//     cores work on m+1, then releases m's slot.
//   - setmaxnreg moves registers from the producer (40) to the consumers
//     (232) at 128 queries a CTA.
// The loads are TMA, issued by one thread, because 16-byte cp.async pieces
// issued by the whole producer warpgroup cost it about as many clocks of
// address arithmetic a member as the consumers' whole step, on the
// consumers' schedulers (PERF.md). Shared memory written by the generic proxy
// (the widening, the query tile) is fenced (fence.proxy.async) before wgmma
// reads it.

#include <algorithm>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kTC = 64;          // classes per CTA (table rows a member)
constexpr int kMaxSlots = 6;     // ring slots
constexpr int kRaw = 3;          // int8: the producer's raw ring depth
constexpr int kBarBytes = 256;   // full, empty[kMaxSlots]; raw_full, raw_empty[kRaw]
constexpr int kSmemMax = 232448;
constexpr float kNeg = -3e38f;

enum Kind { kExt = 0, kSplitBf16 = 1, kSplitI8 = 2 };

// --- mbarriers, proxy fences and wgmma -----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more from the async copies that complete on bar
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box at coordinates (0, 0, c2, c3) of the 4-D tensor map at
// generic address tmap into dst; completes on bar
__device__ __forceinline__ void tma_load_4d(void* dst, uint64_t tmap, uint64_t* bar, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(tmap), "r"(smem_addr(bar)), "r"(0), "r"(0), "r"(c2), "r"(c3)
      : "memory");
}

// bytes (a multiple of 16) from src (16-byte aligned) into dst; completes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle: 8-row x 16-byte core matrices,
// lbo bytes between core matrices along K, sbo bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x 64 f32, the warpgroup's accumulator) = a (64 x 16) * b (64 x 16)^T
// (+ d when accumulate), both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// n k-steps (n <= 16) of wgmma into x, the A and B descriptors stepping by
// astep and bstep (16-byte units); the first k-step overwrites x unless
// accumulate. Each n is one unrolled run, so that each group ends in one
// scoreboard mark and wgmma.wait_group 1 leaves the whole newest group in
// flight (a runtime loop of wgmma got a mark every few k-steps, and the wait
// then waited for most of the newest group too).
template <int N>
__device__ __forceinline__ void wgmma_run(float (&x)[32], int n, uint64_t da, uint64_t db,
                                          int astep, int bstep, int accumulate) {
  if (n == N) {
#pragma unroll
    for (int ks = 0; ks < N; ++ks)
      wgmma_m64n64k16(x, da + ks * astep, db + ks * bstep, ks > 0 ? 1 : accumulate);
  } else if constexpr (N > 1) {
    wgmma_run<N - 1>(x, n, da, db, astep, bstep, accumulate);
  }
}

// The four signed bytes of x as four bf16, exactly, on the FMA pipe instead of
// the conversion unit: byte b + 128 spliced under the exponent of 2^23 is the
// float 2^23 + 128 + b; subtracting 2^23 + 128 leaves b, whose upper half is
// its bf16 (|b| <= 128 has at most 8 significant bits). lo holds bytes 0, 1.
__device__ __forceinline__ void bf16x4_of_s8(uint32_t x, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = x ^ 0x80808080u;
  const float k = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - k;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - k;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - k;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - k;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// One cell's keep2 update by score v of member `code`, in selects: a winner
// demotes the old one to the runner-up; else a score above the runner-up
// replaces it (a winner is always above the runner-up, so the second test
// needs no !win). In PTX, so that the compiler keeps it branch-free: written
// in C++ it became a branch around each cell.
__device__ __forceinline__ void keep2_cell(float v, int code, float& s1, float& s2, int& c1,
                                           int& c2) {
  asm("{\n.reg .pred win, above2;\n"
      "setp.gt.f32 win, %4, %0;\n"
      "setp.gt.f32 above2, %4, %1;\n"
      "selp.f32 %1, %4, %1, above2;\n"
      "selp.b32 %3, %5, %3, above2;\n"
      "selp.f32 %1, %0, %1, win;\n"
      "selp.b32 %3, %2, %3, win;\n"
      "selp.f32 %0, %4, %0, win;\n"
      "selp.b32 %2, %5, %2, win;\n}\n"
      : "+f"(s1), "+f"(s2), "+r"(c1), "+r"(c2)
      : "f"(v), "r"(code));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The ring: nk column chunks of w columns a member (the last one narrower,
// all multiples of 16), S slots.
struct Plan {
  int nk, w, S;
};

// Shared memory of a CTA: barriers, the query tile (64*nwg rows), S bf16 slots
// of 64 rows x w, the split's S aux runs, the int8 raw ring.
size_t smem_bytes(int nwg, int dp, int kind, int w, int S) {
  size_t b = kBarBytes + size_t(nwg) * 64 * dp * 2 + size_t(S) * kTC * w * 2;
  if (kind != kExt) b += size_t(S) * 2 * kTC * sizeof(float);
  if (kind == kSplitI8) b += size_t(kRaw) * (kTC * w + 2 * kTC * sizeof(float));
  return b;
}

template <int NWG, int KIND>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
classmax2_kernel(const void* __restrict__ table, const float* __restrict__ aux,
                 const uint16_t* __restrict__ q, float* __restrict__ best,
                 int32_t* __restrict__ rows, float* __restrict__ best2,
                 int32_t* __restrict__ rows2, int B, int dp, int cls, int members,
                 const Plan pl, const __grid_constant__ CUtensorMap tmap) {
  constexpr bool kSplit = KIND != kExt;
  constexpr bool kI8 = KIND == kSplitI8;
  constexpr int TQ = NWG * 64;
  const int nk = pl.nk, w = pl.w, S = pl.S;
  const int slot_bytes = kTC * w * 2;
  const int raw_bytes = kTC * w + 2 * kTC * 4;  // int8: a raw stage and its aux
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxSlots;
  uint8_t* q_s = smem + kBarBytes;                    // [TQ/8][dp/8][8 rows][8] bf16
  uint8_t* e_s = q_s + TQ * dp * 2;                   // S x [8][w/8][8 rows][8] bf16
  float* a_s = reinterpret_cast<float*>(e_s + S * slot_bytes);       // S x [nrm 64, scl 64]
  uint8_t* r_s = reinterpret_cast<uint8_t*>(a_s + (kSplit ? S * 2 * kTC : 0));  // kRaw raw
  const int64_t n_pad = int64_t(members) * cls;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ, lane0 = blockIdx.y * kTC;

  uint64_t* raw_full = empty + kMaxSlots;  // int8: kRaw raw stages landed
  uint64_t* raw_empty = raw_full + kRaw;   // int8: kRaw raw stages widened
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, kI8 ? 128 : 1);  // the TMA thread, or every widening thread
      mbar_init(empty + s, NWG * 4);       // every consumer warp
    }
    for (int s = 0; s < kRaw; ++s) {
      mbar_init(raw_full + s, 1);
      mbar_init(raw_empty + s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query tile, once, in the layout of the table's slots (tma_map below):
  // row r, 16-byte chunk c at (r/8)*dp*16 + c*128 + (r%8)*16; rows past B are
  // zero (their results are dropped)
  for (int i = tid; i < TQ * (dp / 8); i += blockDim.x) {
    const int r = i % TQ, c = i / TQ;
    uint8_t* dst = q_s + (r >> 3) * dp * 16 + c * 128 + (r & 7) * 16;
    if (q0 + r < B)
      cp_async16(dst, q + int64_t(q0 + r) * dp + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == NWG) {
    // ---- producer: stages (member m, chunk kc) in order into slot s -------------
    if constexpr (NWG == 2) setmaxnreg_dec<40>();
    const int p = tid & 127;
    const uint64_t tm = reinterpret_cast<uint64_t>(&tmap);
    int slot = 0;
    uint32_t ph = 0;
    if constexpr (!kI8) {
      // one thread: a TMA load of the stage's 64 rows (K3: and two bulk
      // copies of its nrm and scl) onto the slot's full barrier
      if (p == 0) {
        for (int m = 0; m < members; ++m) {
          const int64_t row0 = int64_t(m) * cls + lane0;
          for (int kc = 0; kc < nk; ++kc) {
            const bool with_aux = kSplit && kc == nk - 1;
            mbar_wait(empty + slot, ph ^ 1);
            mbar_expect_tx(full + slot, slot_bytes + (with_aux ? 2 * kTC * 4 : 0));
            tma_load_4d(e_s + slot * slot_bytes, tm, full + slot, kc * w / 8, int(row0 / 8));
            if (with_aux) {
              float* a = a_s + slot * 2 * kTC;
              bulk_load(a, aux + row0, kTC * 4, full + slot);
              bulk_load(a + kTC, aux + n_pad + row0, kTC * 4, full + slot);
            }
            if (++slot == S) { slot = 0; ph ^= 1; }
          }
        }
      }
    } else {
      // int8: thread 0 loads raw stages by TMA kRaw - 1 ahead into the raw
      // ring; every thread widens its pieces into the bf16 slot. Raw piece
      // i = (g*(w/16) + c)*8 + r is row 8g + r, columns 16c ..; its two bf16
      // halves go to chunks 2c and 2c+1, at (i/8)*256 + (i%8)*16 and +128.
      const int total = members * nk;
      auto raw_load = [&](int j) {
        const int rs = j % kRaw, m = j / nk, kc = j - m * nk;
        const int64_t row0 = int64_t(m) * cls + lane0;
        const bool with_aux = kc == nk - 1;
        mbar_wait(raw_empty + rs, ((j / kRaw) & 1) ^ 1);
        mbar_expect_tx(raw_full + rs, kTC * w + (with_aux ? 2 * kTC * 4 : 0));
        uint8_t* dst = r_s + rs * raw_bytes;
        tma_load_4d(dst, tm, raw_full + rs, kc * w / 16, int(row0 / 8));
        if (with_aux) {
          float* a = reinterpret_cast<float*>(dst + kTC * w);
          bulk_load(a, aux + row0, kTC * 4, raw_full + rs);
          bulk_load(a + kTC, aux + n_pad + row0, kTC * 4, raw_full + rs);
        }
      };
      if (p == 0)
        for (int j = 0; j < kRaw - 1 && j < total; ++j) raw_load(j);
      int kc = 0;
      for (int j = 0; j < total; ++j) {
        if (p == 0 && j + kRaw - 1 < total) raw_load(j + kRaw - 1);
        const int rs = j % kRaw;
        mbar_wait(raw_full + rs, (j / kRaw) & 1);
        mbar_wait(empty + slot, ph ^ 1);
        const uint8_t* src = r_s + rs * raw_bytes;
        uint8_t* dst = e_s + slot * slot_bytes;
        for (int i = p; i < kTC * (w / 16); i += 128) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src + i * 16);
          uint8_t* d = dst + (i >> 3) * 256 + (i & 7) * 16;
          uint4 a, b;
          bf16x4_of_s8(raw.x, a.x, a.y);
          bf16x4_of_s8(raw.y, a.z, a.w);
          bf16x4_of_s8(raw.z, b.x, b.y);
          bf16x4_of_s8(raw.w, b.z, b.w);
          *reinterpret_cast<uint4*>(d) = a;
          *reinterpret_cast<uint4*>(d + 128) = b;
        }
        if (kc == nk - 1 && p < 32)
          reinterpret_cast<uint4*>(a_s + slot * 2 * kTC)[p] =
              *reinterpret_cast<const uint4*>(src + kTC * w + p * 16);
        fence_proxy_async();  // the widened tile is read by wgmma
        mbar_arrive(raw_empty + rs);
        mbar_arrive(full + slot);
        if (++slot == S) { slot = 0; ph ^= 1; }
        if (++kc == nk) kc = 0;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries wg*64 .. +63 of the tile ----------
  if constexpr (NWG == 2) setmaxnreg_inc<232>();
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // 16-byte chunks of a row 128 bytes apart, 8-row groups dp*16 (queries) or
  // w*16 (a slot) bytes apart
  const uint64_t qdesc = smem_desc(smem_addr(q_s) + wg * 64 * dp * 2, 128, dp * 16);
  const uint64_t edesc = smem_desc(smem_addr(e_s), 128, w * 16);

  // accumulator cell i = nb*4 + j: query warp*16 + g + 8*(j >> 1), class
  // nb*8 + 2t + (j & 1), as in mma.sync's layout for each n-block nb
  float acc_a[32], acc_b[32];
  float s1[32], s2[32];
  int32_t c1[32], c2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s1[i] = kNeg;
    s2[i] = kNeg;
    c1[i] = 0;
    c2[i] = 0;
  }

  int slot = 0, prev = 0;
  uint32_t ph = 0;
  // issue chunk kc of the member in slot `slot` into x
  auto issue = [&](float (&x)[32], int kc) {
    mbar_wait(full + slot, ph);
    const int c0 = kc * w, nks = min(w, dp - c0) / 16;
    const uint64_t da = qdesc + c0;  // c0/8 chunks of 128 bytes, in 16-byte units
    const uint64_t db = edesc + (slot * slot_bytes >> 4);
    wgmma_fence();
    // w <= 256: at most 16 k-steps; a member's first k-step overwrites x
    wgmma_run<16>(x, nks, da, db, 16, 16, kc > 0);
    wgmma_commit();
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  };
  // member code's dot products are in y and its aux in slot s: the running
  // update (y itself is only read: no instruction but wgmma writes an
  // accumulator, or ptxas serializes the wgmma)
  auto update = [&](const float (&y)[32], int code, int s) {
    const float* nrm = a_s + s * 2 * kTC + 2 * t;
    const float* scl = nrm + kTC;
    float2 sc = make_float2(1.f, 1.f), nr = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float v = y[i];
      if constexpr (kSplit) {
        if ((i & 3) == 0) {  // class nb*8 + 2t and the next, nb = i / 4
          sc = *reinterpret_cast<const float2*>(scl + (i >> 2) * 8);
          nr = *reinterpret_cast<const float2*>(nrm + (i >> 2) * 8);
        }
        // score = scl * dot + nrm, rounded twice (no FMA contraction)
        v = __fadd_rn(__fmul_rn(v, (i & 1) ? sc.y : sc.x), (i & 1) ? nr.y : nr.x);
      }
      keep2_cell(v, code, s1[i], s2[i], c1[i], c2[i]);
    }
  };
  auto advance = [&]() {
    prev = slot;
    if (++slot == S) { slot = 0; ph ^= 1; }
  };
  if constexpr (NWG == 2) {
    // one chunk a member: even members in acc_a, odd ones in acc_b, in
    // straight-line pairs, so that ptxas sees which group each wait retires
    // (a wait it cannot place, it injects as a full one)
    if (members > 0) {
      issue(acc_a, 0);
      advance();
      int m = 1;
      for (; m + 1 < members; m += 2) {
        issue(acc_b, 0);
        wgmma_wait<1>();  // member m-1, in acc_a, is done
        update(acc_a, m - 1, prev);
        release(prev);
        advance();
        issue(acc_a, 0);
        wgmma_wait<1>();  // member m, in acc_b, is done
        update(acc_b, m, prev);
        release(prev);
        advance();
      }
      if (m < members) {
        issue(acc_b, 0);
        wgmma_wait<1>();
        update(acc_a, m - 1, prev);
        release(prev);
        advance();
        wgmma_wait<0>();
        update(acc_b, m, prev);
      } else {
        wgmma_wait<0>();
        update(acc_a, m - 1, prev);
      }
    }
  } else {
    // column chunks: member m into x, chunk by chunk, each chunk's slot freed
    // once the next chunk is issued; once m's first chunk is issued, member
    // m-1 (in y) finishes, is updated and frees its last slot
    auto member = [&](float (&x)[32], float (&y)[32], int m) {
      for (int kc = 0; kc < nk; ++kc) {
        issue(x, kc);
        if (kc > 0 || m > 0) {
          wgmma_wait<1>();  // every group but the one just issued is done
          if (kc == 0) update(y, m - 1, prev);
          release(prev);
        }
        advance();
      }
    };
    int m = 0;
    for (; m + 1 < members; m += 2) {
      member(acc_a, acc_b, m);
      member(acc_b, acc_a, m + 1);
    }
    if (m < members) member(acc_a, acc_b, m);
    if (members > 0) {
      wgmma_wait<0>();
      if (members & 1)
        update(acc_a, members - 1, prev);
      else
        update(acc_b, members - 1, prev);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + wg * 64 + warp * 16 + g + 8 * h;
    if (qi >= B) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int i = nb * 4 + 2 * h;
      const int col = lane0 + nb * 8 + 2 * t;
      const int64_t o = int64_t(qi) * cls + col;
      *reinterpret_cast<float2*>(best + o) = make_float2(s1[i], s1[i + 1]);
      *reinterpret_cast<int2*>(rows + o) = make_int2(c1[i] * cls + col, c1[i + 1] * cls + col + 1);
      *reinterpret_cast<float2*>(best2 + o) = make_float2(s2[i], s2[i + 1]);
      *reinterpret_cast<int2*>(rows2 + o) =
          make_int2(c2[i] * cls + col, c2[i + 1] * cls + col + 1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The table (n_pad, dp) row-major, bf16 or int8, seen in 4-D as (16-byte
// chunk's elements, row in an 8-row group, chunk, 8-row group); a box of
// (all, 8, w/e chunks, 8 groups) lands in shared memory as [group][chunk]
// [row][16 bytes]: 8-row x 16-byte core matrices, chunks 128 bytes apart,
// groups w*16 (bf16) bytes apart, the layout wgmma reads without swizzle.
// Columns past dp are zero-filled.
bool tma_map(CUtensorMap* map, const void* table, int64_t n_pad, int dp, int w, bool i8) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elt = i8 ? 1 : 2, e = 16 / elt;
  const cuuint64_t dims[4] = {e, 8, cuuint64_t(dp) / e, cuuint64_t(n_pad) / 8};
  const cuuint64_t strides[3] = {cuuint64_t(dp) * elt, 16, cuuint64_t(dp) * elt * 8};
  const cuuint32_t box[4] = {cuuint32_t(e), 8, cuuint32_t(w / e), 8};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(table), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int KIND>
int launch(const void* table, const float* aux, const uint16_t* q, float* best, int32_t* rows,
           float* best2, int32_t* rows2, int B, int dp, int cls, int members, const Plan& pl,
           size_t smem, cudaStream_t stream) {
  CUtensorMap map;
  if (!tma_map(&map, table, int64_t(members) * cls, dp, pl.w, KIND == kSplitI8))
    return int(cudaErrorInvalidValue);
  auto kernel = classmax2_kernel<NWG, KIND>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((B + NWG * 64 - 1) / (NWG * 64), cls / kTC);
  kernel<<<grid, (NWG + 1) * 128, smem, stream>>>(table, aux, q, best, rows, best2, rows2, B,
                                                   dp, cls, members, pl, map);
  return int(cudaGetLastError());
}

template <int KIND>
int dispatch(const void* table, const void* aux, const void* q, int64_t n_pad, int B, int dp,
             int cls, void* best, void* rows, void* best2, void* rows2, void* stream) {
  if (dp % 16 || cls % kTC || n_pad % cls || B <= 0) return int(cudaErrorInvalidValue);
  // the 128-query tile while a member's rows fit in one slot (dp <= 256) and
  // a ring of 3 fits beside the queries, else 64 queries beside a ring of 2
  // whose slots hold column chunks
  for (int nwg = 2; nwg >= 1; --nwg) {
    for (int cap = 256; cap >= 16; cap /= 2) {
      const int units = dp / 16, per = (units + cap / 16 - 1) / (cap / 16);
      const int w = (units + per - 1) / per * 16;  // per chunks of at most cap
      const size_t base = smem_bytes(nwg, dp, KIND, w, 0);
      if (base >= size_t(kSmemMax)) continue;
      const size_t slot = smem_bytes(nwg, dp, KIND, w, 1) - base;
      const int S = int(std::min<size_t>(kMaxSlots, (kSmemMax - base) / slot));
      if (S < (nwg == 2 ? 3 : 2) || (nwg == 2 && w < dp)) continue;
      const Plan pl{(dp + w - 1) / w, w, S};
      const size_t smem = smem_bytes(nwg, dp, KIND, w, S);
      const int members = int(n_pad / cls);
      const auto* a = static_cast<const float*>(aux);
      const auto* qq = static_cast<const uint16_t*>(q);
      auto* b1 = static_cast<float*>(best);
      auto* r1 = static_cast<int32_t*>(rows);
      auto* b2 = static_cast<float*>(best2);
      auto* r2 = static_cast<int32_t*>(rows2);
      auto s = static_cast<cudaStream_t>(stream);
      return nwg == 2 ? launch<2, KIND>(table, a, qq, b1, r1, b2, r2, B, dp, cls, members, pl,
                                        smem, s)
                      : launch<1, KIND>(table, a, qq, b1, r1, b2, r2, B, dp, cls, members, pl,
                                        smem, s);
    }
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// The keep2 scan of classmax_scan.cu's entry points (shine_classmax_scan and
// shine_classmax_scan_split with keep2): kind 0 K2's packed bf16 ext, 1 K3's
// bf16 comp, 2 K3's int8 comp (aux (2, n_pad) f32 [nrm; scl] for 1 and 2).
// best/rows/best2/rows2 (B, cls). Returns the cudaError_t of the launch.
int classmax2_dispatch(int kind, const void* table, const void* aux, const void* q,
                       int64_t n_pad, int B, int dp, int cls, void* best, void* rows,
                       void* best2, void* rows2, void* stream) {
  if (kind == kSplitI8)
    return dispatch<kSplitI8>(table, aux, q, n_pad, B, dp, cls, best, rows, best2, rows2,
                              stream);
  if (kind == kSplitBf16)
    return dispatch<kSplitBf16>(table, aux, q, n_pad, B, dp, cls, best, rows, best2, rows2,
                                stream);
  return dispatch<kExt>(table, aux, q, n_pad, B, dp, cls, best, rows, best2, rows2, stream);
}
