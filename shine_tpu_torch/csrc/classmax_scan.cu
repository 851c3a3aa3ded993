// classmax_scan: the exact top-kb select over the class lanes that ends the
// fused forms of the brute-force class-max scans of FastFlatIndex (K2) and
// SplitFlatIndex (K3), whose scan is the kernel of classmax2_scan.cu; and the
// mma.sync class-max kernel, which serves two walks: the routed scan of
// RoutedSplitIndex (K4) and the chunked class-max of blockmax_scan2 (K6).
//
// The class-max semantics (the K2 and K3 scores, ties to the earliest row,
// the start state (-3e38, code 0), keep2's demotion rule) are written out in
// classmax2_scan.cu; K4 and K6 below keep them. The select kernel takes, per
// query, the kb lanes of largest best in (value descending, lane ascending)
// order and gathers rows (and best2, rows2) at them (the select of
// classmax_topk_scan, classmax2_topk_scan and the split forms'
// _topk_epilogue): the scan followed by an exact top-kb and a gather.
//
// The mma.sync kernel below walks members as the class-max scans do: class c = row % cls
// means that member m of a run of classes lane0 .. lane0+63 is the contiguous
// block of rows m*cls + lane0 .. m*cls + lane0 + 63. Each CTA owns a (TQ
// queries) x (64 classes) tile and keeps its running best and member code in
// registers, laid out as the mma accumulators are: every thread holds 32
// (query, class) cells. It walks its members in order, so the earliest row
// still wins. For each member the 64 table rows stream through a 3-stage
// cp.async ring in shared memory (in column chunks of at most 160 when dp is
// wide), the queries stay resident in shared memory, the TQ x 64 scores come
// out of m16n8k16 mma.sync, and the max update runs on the accumulators. Rows
// (= code*cls + lane) are written once, at the end. Two CTAs run on each SM.
// Fragments come from shared memory by ldmatrix, those of the next 16 columns
// while the mma of the current ones run; shared-memory rows are padded by 8
// bf16 so that the eight row addresses of each 8x8 matrix hit distinct banks.
// The member's 64 nrm and 64 scl (two 256-byte runs of aux) ride in each ring
// stage beside the table rows and scale and shift the accumulators before the
// max update. An int8 table streams raw bytes through the ring; once a stage
// has landed, the CTA widens its 64 rows to bf16 (int8 -> f32 -> bf16 is
// exact for |x| <= 128) into one bf16 tile, behind one more barrier, and the
// mma read that tile.
//
// K4 replaces shine_tpu/ops/pallas_scan_routed.py: routed_classmax_scan
// (_kernel_routed), RoutedSplitIndex's scan over a cluster-major split table
// ((C+1)*cap rows, the last cluster a pad cluster whose nrm is -3e38) with
// its aux in the routed layout aux_r (C+1, 2*cap/cls, cls). The B = G*T
// queries come in groups of T (16, 32 or 64); group g scores only the P
// clusters of cols[g] (G, P), and its class-max walks code = p*(cap/cls) + m
// in increasing order, so the earliest code wins a tie; rows = code*cls +
// lane. A CTA holds one group (a query tile of 32 or 64, zero rows past T)
// and 64 classes, and the rows of member m of cluster cols[g, p], with their
// nrm and scl runs of aux_r, stream through the ring. Columns that name the
// pad cluster C are skipped: its rows score -3e38 and never enter, so the
// result is the same, and a tile whose queries share clusters leaves many
// such columns (at the auto knobs of a 4.19M x 128 set, ~56% of them). What
// bounds it: the bf16 operations 2*T*cap*128 a granted real column, against
// the unique bytes of the clusters a batch is granted at 3.35 TB/s; the
// G*P*cap*136 bytes of its per-group reads (6.8 GB at B=4096, P=192,
// cap=4096, int8) fall to the L2 cache only where groups share clusters. Its
// times are in PERF.md.
//
// K6 replaces shine_tpu/ops/pallas_scan2.py: blockmax_scan2 (_kernel), K2's
// class-max at cls = 128 restarted at every 4096-row chunk: column c*128 + p of
// its (B, N_pad/32) outputs holds the best of rows c*4096 + m*128 + p, m =
// 0..31, the first member winning a tie and member 0 entering whatever it
// scores (the Pallas running max starts from it). It is the chunked walk
// (CHUNKED): CTA z of the grid's third axis walks chunk z's 32 members, starts
// its running max at -inf, and writes its 128 classes at columns z*128 ...
// What bounds it: K2's operations (1.0768 ms at B = 4096 on 1M rows); its
// outputs are 1.03 GB, 0.31 ms at 3.35 TB/s. No path of the JAX package calls
// it.
//
// Left for later: the wgmma ring of classmax2_scan.cu for these two walks
// too, a fused select, and for K4 more queries a CTA and an order of groups
// that shares clusters in the L2 cache.

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kTC = 64;      // classes per CTA
constexpr int kWarpQ = 32;   // queries per warp
constexpr int kKC = 160;     // widest column chunk of a stage
constexpr int kPad = 8;      // bf16 of padding per shared-memory row
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kEStride = kKC + kPad;
constexpr int kEBuf = kTC * kEStride;  // bf16 per ring slot
constexpr int kRStride = kKC + 16;     // bytes per raw int8 row of a slot
constexpr float kNeg = -3e38f;

// the table a scan reads: K2's packed bf16 ext, or K3's split comp + aux
enum Kind { kExt = 0, kSplitBf16 = 1, kSplitI8 = 2 };

// One k-step's fragments of a warp's 32 x 32 tile: a[mt] the A fragment of
// query rows mt*16 .. +15; b[np] the B fragments of table rows np*16 .. +15,
// {b0, b1} of the first n-tile of 8, then of the second.
__device__ __forceinline__ void load_frags(uint32_t (&a)[2][4], uint32_t (&b)[2][4],
                                           const uint16_t* qa, const uint16_t* eb,
                                           int qstride) {
  ldsm_x4(a[0], qa);
  ldsm_x4(a[1], qa + 16 * qstride);
  ldsm_x4(b[0], eb);
  ldsm_x4(b[1], eb + 16 * kEStride);
}

__device__ __forceinline__ void mma_tile(float (&acc)[2][4][4], const uint32_t (&a)[2][4],
                                         const uint32_t (&b)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], &b[nt >> 1][(nt & 1) * 2]);
}

// Two bf16 (low half first) of the signed bytes 2h and 2h+1 of x, exactly.
__device__ __forceinline__ uint32_t bf16x2_of_s8(uint32_t x, int h) {
  const int v0 = static_cast<int>(x << (24 - 16 * h)) >> 24;
  const int v1 = static_cast<int>(x << (16 - 16 * h)) >> 24;
  return __byte_perm(__float_as_uint(__int2float_rn(v0)),
                     __float_as_uint(__int2float_rn(v1)), 0x7632);
}

// Column chunking of a table row: nk chunks of w columns (the last one
// narrower), all multiples of 16.
struct Chunks {
  int nk, w;
  __host__ __device__ explicit Chunks(int dp) {
    nk = (dp + kKC - 1) / kKC;
    const int per = (dp + nk - 1) / nk;
    w = (per + 15) / 16 * 16;
  }
};

// Shared memory of a CTA: the query tile, the bf16 ring (an int8 table
// keeps one bf16 tile and a raw byte ring instead), and the aux ring.
size_t scan_smem_bytes(int wq, int dp, int kind) {
  const int tiles = kind == kSplitI8 ? 1 : kStages;
  size_t bytes = (size_t(wq) * kWarpQ * (dp + kPad) + size_t(tiles) * kEBuf) * sizeof(uint16_t);
  if (kind == kSplitI8) bytes += size_t(kStages) * kTC * kRStride;
  if (kind != kExt) bytes += size_t(kStages) * 2 * kTC * sizeof(float);
  return bytes;
}

// K4's walk: group blockIdx.x's T queries over the P clusters of its row of
// cols, cap / cls members each
struct Route {
  const int32_t* cols;  // (G, P)
  int T, P, cap, mc;    // mc = cap / cls
  int pad;              // the pad cluster C, skipped: its rows score -3e38
};

// Capped at 128 registers a thread so that two CTAs share an SM and their
// per-member barriers interleave.
// ROUTED is K4's walk. CHUNKED is K6's walk: CTA z walks only the `members`
// members of row chunk z (rows z*members*cls ..), the first member entering
// unconditionally, and writes its classes at columns z*cls .. of a (B,
// gridDim.z*cls) output.
template <int WQ, int KIND, bool ROUTED, bool CHUNKED = false>
__global__ void __launch_bounds__(WQ * 2 * 32, 2)
classmax_kernel(const void* __restrict__ table, const float* __restrict__ aux,
                const uint16_t* __restrict__ q, float* __restrict__ best,
                int32_t* __restrict__ rows, int B, int dp, int cls, int members,
                const Route rt) {
  static_assert(ROUTED != CHUNKED, "K4's walk or K6's");
  constexpr bool kSplit = KIND != kExt;
  constexpr bool kI8 = KIND == kSplitI8;
  constexpr int kThreads = WQ * 2 * 32;
  constexpr int TQ = WQ * kWarpQ;
  extern __shared__ __align__(16) uint16_t smem[];
  const int qstride = dp + kPad;
  uint16_t* q_s = smem;                 // [TQ][qstride]
  uint16_t* e_s = smem + TQ * qstride;  // [kStages or 1][kTC][kEStride]
  // int8 only: [kStages][kTC][kRStride] raw bytes
  int8_t* r_s = reinterpret_cast<int8_t*>(e_s + (kI8 ? 1 : kStages) * kEBuf);
  // split only: [kStages][2][kTC] f32, nrm then scl
  float* a_s = reinterpret_cast<float*>(r_s + (kI8 ? kStages * kTC * kRStride : 0));
  const int64_t n_pad = int64_t(members) * cls;

  const int q0 = blockIdx.x * (ROUTED ? rt.T : TQ);
  const int lane0 = blockIdx.y * kTC;
  const int tid = threadIdx.x;
  const Chunks ch(dp);
  // K4 walks only the members of the group's real clusters: a column that
  // names the pad cluster scores -3e38 on every row, which never enters
  const int32_t* cols_g = ROUTED ? rt.cols + int64_t(blockIdx.x) * rt.P : nullptr;
  auto skip_pad = [&](int mm) {
    if constexpr (ROUTED)
      while (mm < members && __ldg(cols_g + mm / rt.mc) == rt.pad) mm += rt.mc;
    return mm;
  };
  auto walked = [&]() {
    if constexpr (ROUTED) {
      int real = 0;
      for (int p = 0; p < rt.P; ++p) real += __ldg(cols_g + p) != rt.pad;
      return real * rt.mc;
    }
    return members;
  };
  const int64_t stages = int64_t(walked()) * ch.nk;

  // the query tile, once; rows past B (K4: past the group's T) are zero
  // (their results are dropped)
  const int qpieces = dp / 8;
  for (int i = tid; i < TQ * qpieces; i += kThreads) {
    const int r = i / qpieces, p = i - r * qpieces;
    uint16_t* dst = q_s + r * qstride + p * 8;
    if (ROUTED ? r < rt.T : q0 + r < B)
      cp_async16(dst, q + int64_t(q0 + r) * dp + p * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }

  // stage (member m, column chunk kc): rows m*cls + lane0 .. +63 (and their
  // nrm, scl), into ring slot `slot`. K4's member m = p*mc + mm is member mm
  // of cluster c = cols[g, p]: rows c*cap + mm*cls + lane0 .., its nrm and
  // scl at aux_r[c, mm, lane0 ..] and aux_r[c, mc + mm, lane0 ..]
  auto load_stage = [&](int m, int kc, int slot) {
    const int c0 = kc * ch.w;
    int64_t row0;
    const float* aux_c = nullptr;
    if constexpr (ROUTED) {
      const int p = m / rt.mc, mm = m - p * rt.mc;
      const int64_t c = __ldg(rt.cols + int64_t(blockIdx.x) * rt.P + p);
      row0 = c * rt.cap + int64_t(mm) * cls + lane0;
      aux_c = aux + (c * 2 * rt.mc + mm) * cls + lane0;
    } else {
      row0 = (int64_t(blockIdx.z) * members + m) * cls + lane0;
    }
    if constexpr (kI8) {
      const int pieces = min(ch.w, dp - c0) / 16;
      const int8_t* src = static_cast<const int8_t*>(table) + row0 * dp + c0;
      int8_t* dst = r_s + slot * kTC * kRStride;
      for (int i = tid; i < kTC * pieces; i += kThreads) {
        const int r = i / pieces, p = i - r * pieces;
        cp_async16(dst + r * kRStride + p * 16, src + int64_t(r) * dp + p * 16);
      }
    } else {
      const int pieces = min(ch.w, dp - c0) / 8;
      const uint16_t* src = static_cast<const uint16_t*>(table) + row0 * dp + c0;
      uint16_t* dst = e_s + slot * kEBuf;
      for (int i = tid; i < kTC * pieces; i += kThreads) {
        const int r = i / pieces, p = i - r * pieces;
        cp_async16(dst + r * kEStride + p * 8, src + int64_t(r) * dp + p * 8);
      }
    }
    if constexpr (kSplit) {
      // 16 pieces of 4 f32 for nrm (aux[0]), 16 for scl (aux[1])
      for (int i = tid; i < 2 * kTC / 4; i += kThreads) {
        const int plane = i / (kTC / 4), p = i - plane * (kTC / 4);
        const float* src;
        if constexpr (ROUTED)
          src = aux_c + plane * int64_t(rt.mc) * cls + p * 4;
        else
          src = aux + plane * n_pad + row0 + p * 4;
        cp_async16(a_s + (slot * 2 + plane) * kTC + p * 4, src);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wq = warp >> 1, wc = warp & 1;

  float acc[2][4][4];
  float s1[2][4][4];
  int32_t c1[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // K6's running max starts below every finite score, so that member
        // 0 enters whatever it scores
        s1[mt][nt][i] = CHUNKED ? -__int_as_float(0x7f800000) : kNeg;
        c1[mt][nt][i] = 0;
      }

  // the load cursor runs kStages - 1 stages ahead of the compute cursor;
  // the query copies ride in the first group
  int lm = skip_pad(0), lkc = 0, lslot = 0;
  auto advance = [&](int& mm, int& kk, int& slot) {
    if (++kk == ch.nk) { kk = 0; mm = skip_pad(mm + 1); }
    if (++slot == kStages) slot = 0;
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lm < members) load_stage(lm, lkc, lslot);
    cp_async_commit();
    advance(lm, lkc, lslot);
  }

  // ldmatrix row addresses of this lane: A (queries) 16 rows x 8 columns per
  // matrix pair, B (table rows) two n-tiles of 8 rows
  const uint16_t* a_row = q_s + (wq * kWarpQ + (lane & 15)) * qstride + (lane >> 4) * 8;
  const int b_off = (wc * 32 + (lane & 7) + ((lane >> 4) << 3)) * kEStride +
                    ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, t = lane & 3;

  int m = skip_pad(0), kc = 0, slot = 0;
  for (int64_t s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; the slot read in stage s-1 is free
    if (lm < members) load_stage(lm, lkc, lslot);
    cp_async_commit();
    advance(lm, lkc, lslot);

    const int c0 = kc * ch.w;
    const int nks = min(ch.w, dp - c0) / 16;
    if constexpr (kI8) {
      // widen the stage's int8 rows into the bf16 tile; its last reader,
      // stage s-1, passed the barrier above
      const int pieces = nks;
      const int8_t* src = r_s + slot * kTC * kRStride;
      for (int i = tid; i < kTC * pieces; i += kThreads) {
        const int r = i / pieces, p = i - r * pieces;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * kRStride + p * 16);
        uint4* dst = reinterpret_cast<uint4*>(e_s + r * kEStride + p * 16);
        dst[0] = make_uint4(bf16x2_of_s8(raw.x, 0), bf16x2_of_s8(raw.x, 1),
                            bf16x2_of_s8(raw.y, 0), bf16x2_of_s8(raw.y, 1));
        dst[1] = make_uint4(bf16x2_of_s8(raw.z, 0), bf16x2_of_s8(raw.z, 1),
                            bf16x2_of_s8(raw.w, 0), bf16x2_of_s8(raw.w, 1));
      }
      __syncthreads();
    }
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
    // fragments of k-step ks+1 load while the mma of k-step ks run
    const uint16_t* qa = a_row + c0;
    const uint16_t* eb = e_s + (kI8 ? 0 : slot * kEBuf) + b_off;
    uint32_t a0[2][4], b0[2][4], a1[2][4], b1[2][4];
    load_frags(a0, b0, qa, eb, qstride);
    for (int ks = 0; ks < nks; ks += 2) {
      if (ks + 1 < nks) load_frags(a1, b1, qa + (ks + 1) * 16, eb + (ks + 1) * 16, qstride);
      mma_tile(acc, a0, b0);
      if (ks + 1 < nks) {
        if (ks + 2 < nks) load_frags(a0, b0, qa + (ks + 2) * 16, eb + (ks + 2) * 16, qstride);
        mma_tile(acc, a1, b1);
      }
    }

    if (kc == ch.nk - 1) {  // member m is scored: the running max update
      if constexpr (kSplit) {
        // score = scl * dot + nrm, rounded twice (no FMA contraction)
        const float* nrm = a_s + slot * 2 * kTC + wc * 32 + 2 * t;
        const float* scl = nrm + kTC;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 sc = *reinterpret_cast<const float2*>(scl + nt * 8);
          const float2 nr = *reinterpret_cast<const float2*>(nrm + nt * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mt][nt][i] = __fadd_rn(__fmul_rn(acc[mt][nt][i], (i & 1) ? sc.y : sc.x),
                                         (i & 1) ? nr.y : nr.x);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = acc[mt][nt][i];
            if (v > s1[mt][nt][i]) {
              s1[mt][nt][i] = v;
              c1[mt][nt][i] = m;
            }
          }
    }
    advance(m, kc, slot);
  }
  cp_async_wait<0>();

  // accumulator cell (mt, nt, i): query wq*32 + mt*16 + g + 8*(i >= 2),
  // class lane0 + wc*32 + nt*8 + 2t + (i & 1); K6 puts chunk z's classes
  // at columns z*cls .. of rows gridDim.z*cls wide, its codes past z*members
  const int64_t out_ld = CHUNKED ? int64_t(gridDim.z) * cls : cls;
  const int out_col0 = CHUNKED ? blockIdx.z * cls : 0;
  const int code0 = CHUNKED ? blockIdx.z * members : 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wq * kWarpQ + mt * 16 + g + 8 * h;
      const int qi = q0 + lr;
      if (ROUTED ? lr >= rt.T : qi >= B) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = lane0 + wc * 32 + nt * 8 + 2 * t;
        const int64_t o = int64_t(qi) * out_ld + out_col0 + col;
        *reinterpret_cast<float2*>(best + o) =
            make_float2(s1[mt][nt][2 * h], s1[mt][nt][2 * h + 1]);
        *reinterpret_cast<int2*>(rows + o) =
            make_int2((code0 + c1[mt][nt][2 * h]) * cls + col,
                      (code0 + c1[mt][nt][2 * h + 1]) * cls + col + 1);
      }
    }
}

template <int WQ, int KIND, bool ROUTED = false, bool CHUNKED = false>
int launch_scan(const void* table, const float* aux, const uint16_t* q, float* best,
                int32_t* rows, int B, int dp, int cls, int members, cudaStream_t stream,
                const Route rt = Route{}, int chunks = 1) {
  const size_t smem = scan_smem_bytes(WQ, dp, KIND);
  auto kernel = classmax_kernel<WQ, KIND, ROUTED, CHUNKED>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  constexpr int TQ = WQ * kWarpQ;
  // K4: one CTA row a group of T queries
  const dim3 grid(ROUTED ? B / rt.T : (B + TQ - 1) / TQ, cls / kTC, chunks);
  kernel<<<grid, WQ * 2 * 32, smem, stream>>>(table, aux, q, best, rows, B, dp, cls, members,
                                              rt);
  return int(cudaGetLastError());
}

// K4: the query tile is 32 (T <= 32) or 64 (T <= 64); a T=16 group fills half
// of a 32-query tile with zero rows, never written.
template <int KIND>
int dispatch_routed(const void* comp, const void* aux_r, const void* q, const void* cols,
                    int C, int G, int T, int P, int dpc, int cap, int cls, void* best,
                    void* rows, void* stream) {
  if (dpc % 16 || cls % kTC || cap % cls || G <= 0 || P <= 0 || T <= 0 || T > 2 * kWarpQ)
    return int(cudaErrorInvalidValue);
  const int wq = T > kWarpQ ? 2 : 1;
  if (scan_smem_bytes(wq, dpc, KIND) > 232448) return int(cudaErrorInvalidValue);
  const Route rt{static_cast<const int32_t*>(cols), T, P, cap, cap / cls, C};
  const auto* a = static_cast<const float*>(aux_r);
  const auto* qq = static_cast<const uint16_t*>(q);
  auto* b1 = static_cast<float*>(best);
  auto* r1 = static_cast<int32_t*>(rows);
  auto s = static_cast<cudaStream_t>(stream);
  const int members = P * (cap / cls);
  if (wq == 1)
    return launch_scan<1, KIND, true>(comp, a, qq, b1, r1, G * T, dpc, cls, members, s, rt);
  return launch_scan<2, KIND, true>(comp, a, qq, b1, r1, G * T, dpc, cls, members, s, rt);
}

// K6: the class-max at cls = 128 of each 4096-row chunk (32 members), the
// query tile 128, else 64 when the queries of 128 do not fit.
int dispatch_chunked(const void* ext, const void* q, int64_t n_pad, int B, int dp, void* best,
                     void* rows, void* stream) {
  constexpr int kCls = 128, kMembers = 32;
  const int64_t chunk = int64_t(kCls) * kMembers;
  if (dp % 16 || n_pad % chunk || n_pad / chunk > 65535 || B <= 0)
    return int(cudaErrorInvalidValue);
  const int chunks = int(n_pad / chunk);
  const auto* qq = static_cast<const uint16_t*>(q);
  auto* b1 = static_cast<float*>(best);
  auto* r1 = static_cast<int32_t*>(rows);
  auto s = static_cast<cudaStream_t>(stream);
  const bool wide = scan_smem_bytes(4, dp, kExt) > 232448;
  if (wide && scan_smem_bytes(2, dp, kExt) > 232448) return int(cudaErrorInvalidValue);
  return wide ? launch_scan<2, kExt, false, true>(ext, nullptr, qq, b1, r1, B, dp, kCls,
                                                  kMembers, s, Route{}, chunks)
              : launch_scan<4, kExt, false, true>(ext, nullptr, qq, b1, r1, B, dp, kCls,
                                                  kMembers, s, Route{}, chunks);
}

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

// K4. comp ((C+1)*cap or more rows, dpc) bf16 (comp_int8 = 0) or int8 (1),
// cluster-major; aux_r (C+1, 2*cap/cls, cls) f32, nrm rows then scl rows,
// cluster C a pad cluster (comp 0, nrm -3e38), which the walk skips; q
// (G*T, dpc) bf16; cols (G, P) i32, each in 0..C; best/rows (G*T, cls)
// f32/i32, rows = code*cls + lane with code = p*(cap/cls) + member. Needs
// dpc % 16 == 0, cls % 64 == 0, cap % cls == 0, 1 <= T <= 64 and 16-byte
// aligned comp, aux_r and q.
extern "C" int shine_classmax_scan_routed(const void* comp, int comp_int8, const void* aux_r,
                                          const void* q, const void* cols, int C, int G, int T,
                                          int P, int dpc, int cap, int cls, void* best,
                                          void* rows, void* stream) {
  if (comp_int8)
    return dispatch_routed<kSplitI8>(comp, aux_r, q, cols, C, G, T, P, dpc, cap, cls, best,
                                     rows, stream);
  return dispatch_routed<kSplitBf16>(comp, aux_r, q, cols, C, G, T, P, dpc, cap, cls, best,
                                     rows, stream);
}

// K6. ext (n_pad, dp) bf16, q (B, dp) bf16, best/rows (B, n_pad/32) f32/i32:
// column c*128 + p holds the best of rows c*4096 + m*128 + p, m = 0..31, and
// that row, the first member winning a tie. Needs dp % 16 == 0, n_pad % 4096
// == 0 and 16-byte aligned ext and q.
extern "C" int shine_blockmax_scan2(const void* ext, const void* q, int64_t n_pad, int B,
                                    int dp, void* best, void* rows, void* stream) {
  return dispatch_chunked(ext, q, n_pad, B, dp, best, rows, stream);
}

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
