// classmax2_scan: the Hopper kernel of every scan over a packed or split
// table: the class-max scans, keep1 and keep2, on FastFlat's packed bf16
// table (K2a, K2b, and the scans of K2c and K2d before the select kernel of
// classmax_scan.cu) and on SplitFlat's split table in bf16 or int8 (K3a/K3b,
// keep1 and keep2), the block-max scan (K5), the chunked class-max scan (K6)
// and RoutedSplitIndex's routed scan over a cluster-major split table (K4).
//
// It replaces shine_tpu/ops/pallas_scan3.py: classmax_scan (_kernel),
// classmax2_scan (_kernel2), classmax_topk_scan (_kernel_topk) and
// classmax2_topk_scan (_kernel2_topk); shine_tpu/ops/pallas_scan_split.py:
// classmax_scan_split and classmax_topk_scan_split (_kernel_split);
// shine_tpu/ops/pallas_scan.py: blockmax_scan (_scan_kernel);
// shine_tpu/ops/pallas_scan2.py: blockmax_scan2 (_kernel); and
// shine_tpu/ops/pallas_scan_routed.py: routed_classmax_scan
// (_kernel_routed). For query b:
//
//   K2 score(b, r) = sum_j q[b, j] * ext[r, j]          (bf16 products, f32 sums)
//   K3 score(b, r) = scl[r] * sum_j q[b, j] * comp[r, j] + nrm[r]
//                    (product and sum rounded once each, no FMA; int8 comp is
//                    widened to bf16 exactly; pad rows score exactly -3e38)
//
// The class-max scans, class c = r % cls:
//   best/rows      = the best score of class c and its row, strict > in
//                    increasing row order (the earliest row wins a tie), from
//                    the start state (-3e38, code 0); rows = code*cls + c
//   best2/rows2    = keep2 only: the runner-up by _kernel2's demotion rule:
//                    the old winner drops to the runner-up slot when beaten; a
//                    challenger takes the slot only if it beats the runner-up
//                    and not the winner. The update keeps the select form:
//                    fmaxf/fminf may turn a -0.0 tie into +0.0, which the
//                    strict > never does.
// K5, each 128-row block j (rows 128j .. 128j + 127) of the packed table:
//   max1/arg1      = the block's best score and its row, the lowest row
//                    winning a tie (jnp.argmax)
//   max2/arg2      = the best with the winner's score replaced by -3e38 (the
//                    Pallas kernel's mask), its lowest row: a tied twin of the
//                    winner is the runner-up, and a block whose other rows all
//                    score below -3e38 (pad rows score bf16(-3e38) ~ -3.004e38)
//                    gives (-3e38, arg1). Four (B, N_pad/128) planes.
// K6, each 4096-row chunk z of the packed table, at cls = 128:
//   max1/arg1      = K2 keep1 over the chunk's 32 members alone: column
//                    z*128 + p holds the best of rows z*4096 + m*128 + p, m =
//                    0..31, and its row, the first member winning a tie;
//                    member 0 enters whatever it scores (the Pallas running
//                    max starts from it). Two (B, N_pad/32) planes.
// K4, over a cluster-major split table ((C+1)*cap rows, cluster C a pad
// cluster whose nrm is -3e38) with its aux in the routed layout aux_r (C+1,
// 2*cap/cls, cls): the B = G*T queries come in groups of T (at most 64);
// group g scores only the P clusters cols[g], and the keep1 walk runs over
// code = p*(cap/cls) + m in increasing order (member m of cluster cols[g,
// p]), ties to the earliest code, from (-3e38, 0); rows = code*cls + c.
// Columns that name the pad cluster are skipped: its rows score -3e38 and
// never enter.
//
// What bounds it on the H100: tensor-core operations. B=4096 queries against
// the 1,000,000 real rows of a 1M x 128 set are 2*B*1e6*130 FLOP for K2, K5
// and K6 (width d+2), 1.0768 ms at the data sheet's 989 TFLOP/s of dense
// bf16, and 2*B*1e6*128 for K3, 1.0602 ms; the tables (289 MB, 268 MB, 138
// MB) take under 0.09 ms at 3.35 TB/s, K5's four outputs (514 MB) 0.15 ms,
// K6's two (1.03 GB) 0.31 ms. K4's are 2*T*cap*128 FLOP a granted real
// column, against the unique bytes of the clusters a batch is granted; its
// per-group reads (G*P*cap*136 bytes, 6.8 GB at B=4096, P=192, cap=4096,
// int8) fall to the L2 cache only where groups share clusters. Its times are
// in PERF.md.
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
// keep1 (FORM kKeep1) is the winner half of the keep2 update, and drops the
// runner-up's 64 registers. K6 (kChunks) is keep1 at cls = 128 over a run of
// chunks a CTA (about kWaveCtas CTAs a launch), member 0 of each chunk
// entering as it scores and the chunk's last member writing its 64 classes
// out, as a cluster pair like K2a. K5 (kBlocks) is another walk of the same
// ring: a 128-row block is two consecutive 64-row members (member m is rows
// 64m .., cls = 64, lane0 = 0), and CTA (x, y) walks the members of blocks
// y*run .. y*run + run - 1. In wgmma's accumulator layout the four threads of a quad
// hold all 64 rows of a member for their two query rows, so each thread keeps
// a top two (score, row) a query row over both members in increasing row
// order (keep2_cell's strict > keeps the lower row ahead on a tie), the quad
// merges by two xor shuffles, and the mask rule above gives the Pallas
// runner-up. Each warp owns 16 queries and all 128 rows of a block, so the
// results go to a staging area of its own behind __syncwarp, and every 16
// blocks the warp writes them as 64-byte runs of each of the four planes: no
// CTA-wide barrier runs in the main loop.
//
// The loads are TMA, issued by one thread, because 16-byte cp.async pieces
// issued by the whole producer warpgroup cost it about as many clocks of
// address arithmetic a member as the consumers' whole step, on the
// consumers' schedulers (PERF.md). Shared memory written by the generic proxy
// (the widening, the query tile) is fenced (fence.proxy.async) before wgmma
// reads it.
//
// Clusters (CL = 2): the two CTAs of a cluster hold neighbouring query tiles
// and walk the same members. Each producer loads half of every stage's rows
// (4 of its 8 row groups) with a TMA multicast into both CTAs, so each SM's
// TMA unit moves half the 16-byte pieces of a stage, which set the pace of
// the ring (PERF.md); a slot is refilled only once both CTAs' consumers have
// released it (each consumer warp arrives on its own empty barrier and on its
// peer's). A cluster barrier after the barriers' init and another before
// exit keep each CTA's shared memory alive while its peer can still write
// into it or arrive on its barriers. The keep1 forms of the bf16 tables and
// K6 run as pairs; K5, int8 keep1 and keep2 measured slower or are kept as
// they were (paired() below, PERF.md).
//
// K4 (kRouted) keeps the ring and the producer but swaps the operands: the
// table rows are wgmma's A operand, from registers, widened there from int8,
// and the group's queries its B operand with N = 16, 32 or 64 (routed_cta
// below says why).
//
// Left for later: K4's group order (groups that share clusters walked
// together, so that their rows come from the L2 cache: K4's loads alone
// take ~60% of its time, PERF.md), and a fused select.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>

// The file builds as three objects, one nvcc each, at once (ops/_build.py):
// SHINE_CM_PART 1 holds the scans of the packed table (K2, K5, K6), 2 the
// split scans (K3), 3 the routed scan (K4). Without it one object holds all.
#ifndef SHINE_CM_PART
#define SHINE_CM_PART 0
#endif
#define SHINE_CM_HAS(part) (SHINE_CM_PART == 0 || SHINE_CM_PART == (part))

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

constexpr int kTC = 64;          // classes per CTA (table rows a member)
constexpr int kMaxSlots = 6;     // ring slots
constexpr int kRaw = 3;          // int8: the producer's raw ring depth
constexpr int kBarBytes = 256;   // full, empty[kMaxSlots]; raw_full, raw_empty[kRaw]
constexpr int kSmemMax = 232448;
constexpr float kNeg = -3e38f;
constexpr int kBlk = 128;        // K5: rows a block, two members
constexpr int kRun = 16;         // K5: blocks a warp stages between writes
constexpr int kStageWords = 4 * 16 * kRun;  // K5: a warp's staging area, [plane][query][block]
constexpr int kWaveCtas = 1024;  // K5, K6: about the CTAs a launch aims for
constexpr int kChunk = 32;       // K6: members a chunk (4096 rows at cls = 128)

enum Kind { kExt = 0, kSplitBf16 = 1, kSplitI8 = 2 };
// what a CTA keeps: each class's winner (K2a, K2c, K3 keep1), with its
// runner-up (K2b, K2d, K3 keep2), each 128-row block's top two (K5), each
// class's winner in each chunk of 32 members (K6), or each class's winner
// over a query group's granted clusters (K4)
enum Form { kKeep1 = 1, kKeep2 = 2, kBlocks = 3, kChunks = 4, kRouted = 5 };

// --- mbarriers, proxy fences, clusters and wgmma -------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive on the barrier at bar's offset in the shared memory of cluster CTA
// peer. Without .release.cluster, as CUTLASS's pipelines arrive: the reads it
// releases, wgmma's, are retired by wgmma.wait_group before it, and a release
// at cluster scope took longer than the loads it let through (PERF.md).
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, uint32_t peer) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_addr(bar)),
      "r"(peer)
      : "memory");
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

// the same box into dst of both CTAs of the cluster, completing on the
// barrier at bar's offset in each
__device__ __forceinline__ void tma_load_4d_pair(void* dst, uint64_t tmap, uint64_t* bar,
                                                 int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(smem_addr(dst)),
      "l"(tmap), "r"(smem_addr(bar)), "r"(0), "r"(0), "r"(c2), "r"(c3), "h"(uint16_t(3))
      : "memory");
}

// TMA: the box at coordinates (c0, c1) of the 2-D tensor map at generic
// address tmap into dst; completes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, uint64_t tmap, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(tmap), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster, with release/acquire of shared memory
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// K4: d (64 x N f32, N = 16, 32 or 64) = a (64 x 16, this thread's fragment
// in registers, in mma.sync's A layout) * b (N x 16, bf16 K-major in shared
// memory)^T (+ d when accumulate)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
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

// keep1: the winner half of keep2_cell
__device__ __forceinline__ void keep1_cell(float v, int code, float& s1, int& c1) {
  asm("{\n.reg .pred win;\n"
      "setp.gt.f32 win, %2, %0;\n"
      "selp.f32 %0, %2, %0, win;\n"
      "selp.b32 %1, %3, %1, win;\n}\n"
      : "+f"(s1), "+r"(c1)
      : "f"(v), "r"(code));
}

// K5: the best two (score, row) of a set of rows, in (score descending, row
// ascending) order; an empty slot is (-inf, INT_MAX)
struct Top2 {
  float v1;
  int r1;
  float v2;
  int r2;
};

__device__ __forceinline__ bool ahead(float va, int ra, float vb, int rb) {
  return va > vb || (va == vb && ra < rb);
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

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The ring: nk column chunks of w columns a member (the last one narrower,
// all multiples of 16), S slots; K5: the blocks a CTA walks (run).
struct Plan {
  int nk, w, S, run;
};

// K4's plan: the ring's (nk chunks of w columns a member, S slots), and the
// walk: group g's P columns cols[g*P ..] (pad the pad cluster, skipped), T
// queries a group, cap rows a cluster
struct RoutedPlan {
  int nk, w, S, run;
  const int32_t* cols;
  int P, T, cap, pad;
};

template <int FORM>
struct PlanOf {
  using type = Plan;
};
template <>
struct PlanOf<kRouted> {
  using type = RoutedPlan;
};

// Shared memory of a CTA: barriers, the query tile (64*nwg rows), S bf16 slots
// of 64 rows x w, the split's S aux runs, the int8 raw ring, K5's staging.
size_t smem_bytes(int nwg, int dp, int kind, int form, int w, int S) {
  size_t b = kBarBytes + size_t(nwg) * 64 * dp * 2 + size_t(S) * kTC * w * 2;
  if (kind != kExt) b += size_t(S) * 2 * kTC * sizeof(float);
  if (kind == kSplitI8) b += size_t(kRaw) * (kTC * w + 2 * kTC * sizeof(float));
  if (form == kBlocks) b += size_t(nwg) * 4 * kStageWords * sizeof(uint32_t);
  return b;
}

// --- K4: the routed walk (FORM kRouted) ------------------------------------------
//
// A CTA holds one group of T queries (of the B = G*T, group blockIdx.x) and
// 128 classes lane0 = blockIdx.y*128 ..; its two consumer warpgroups hold 64
// classes each. The table rows are wgmma's A operand, from registers (M =
// the 64 rows of a member), and the group's queries its B operand, from
// shared memory (N = NQ = 16, 32 or 64, the least that holds T): no query
// row is wasted at T = 16 or 32. The producer thread walks cols[g, p] in p
// order, skips the columns that name the pad cluster, and for member m of
// cluster c = cols[g, p] loads rows c*cap + m*cls + lane0 .. +127 by TMA, one
// 128-byte piece a row (a chunk of a row: 128 int8 or 64 bf16 columns) with
// the 128-byte swizzle, plus the 128 nrm and the 128 scl of aux_r[c, m] and
// aux_r[c, mc + m]. Each consumer thread reads the 32 bytes of its two rows
// it holds in the A fragment (4 ld.shared.v4, spread over the banks by the
// swizzle), frees the slot, and widens int8 to bf16 in registers: no
// widening pass and no barrier besides the ring's. A thread's 32 bytes are
// contiguous columns, which wgmma's fragment layout would scatter over the
// k-steps: the K order of the query tile is permuted to match instead (the
// dot product does not depend on it). nrm and scl are per accumulator row,
// so the update is the keep1 cell of every (row, query) cell. code =
// p*mc + m, ties to the earliest code, from (-3e38, 0). A warpgroup waits
// for each member's products before it makes the next member's fragments:
// a second fragment set, so that the widening overlaps the products, took
// longer on the card (the two warpgroups already overlap each other).

constexpr int kRRows = 128;             // K4: table rows a stage, 64 a consumer warpgroup
constexpr int kRSlot = kRRows * 128;    // K4: a stage, 128 swizzled bytes a row
constexpr int kRAux = 2 * kRRows * 4;   // K4: a stage's nrm and scl
constexpr int kRFixed = kBarBytes + 1024;  // K4: barriers, and the slots' alignment

__device__ __forceinline__ uint32_t word_of(const uint4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Shared memory of a K4 CTA: barriers, S slots (1024-byte aligned, as the
// 128-byte swizzle needs), their aux, the query tile (nq rows of kl columns).
size_t routed_smem_bytes(int nq, int kl, int S) {
  return kRFixed + size_t(S) * (kRSlot + kRAux) + size_t(nq) * kl * 2;
}

template <int KIND, int NQ>
__device__ __forceinline__ void routed_cta(uint8_t* smem, const float* __restrict__ aux,
                                           const uint16_t* __restrict__ q,
                                           float* __restrict__ best, int32_t* __restrict__ rows,
                                           int dp, int cls, int mc, const RoutedPlan pl,
                                           uint64_t tm) {
  constexpr bool kI8 = KIND == kSplitI8;
  constexpr int E = kI8 ? 128 : 64;  // table columns in a row's 128-byte chunk
  constexpr int KS = E / 16;         // k-steps a chunk
  constexpr int NC = NQ / 2;         // accumulator cells a thread
  const int nk = pl.nk, S = pl.S, KL = nk * E, T = pl.T;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxSlots;
  const uint32_t base = smem_addr(smem);
  uint8_t* e_s = smem + (((base + kBarBytes + 1023) & ~1023u) - base);  // S x [128 rows][128 B]
  float* a_s = reinterpret_cast<float*>(e_s + S * kRSlot);              // S x [nrm 128, scl 128]
  uint8_t* q_s = reinterpret_cast<uint8_t*>(a_s + S * 2 * kRRows);      // [NQ/8][KL/8][8][8] bf16
  const int tid = threadIdx.x, grp = blockIdx.x;
  const int lane0 = blockIdx.y * kRRows;
  const int32_t* cols_g = pl.cols + int64_t(grp) * pl.P;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query tile, once: logical column k = 16*kk + L of k-step kk = kc*KS + ks
  // holds query column kc*E + 4*KS*t + 4*ks + j, the column that thread t
  // holds at position L of its fragment (t = (L%8)/2, j = 2*(L/8) + L%2);
  // rows past T and columns past dp are zero
  for (int i = tid; i < NQ * KL; i += blockDim.x) {
    const int n = i / KL, k = i - n * KL;
    const int kk = k >> 4, L = k & 15, kc = kk / KS, ks = kk - kc * KS;
    const int col = kc * E + ((L & 7) >> 1) * 4 * KS + 4 * ks + ((L >> 3) << 1) + (L & 1);
    uint16_t v = 0;
    if (n < T && col < dp) v = q[int64_t(grp * T + n) * dp + col];
    *reinterpret_cast<uint16_t*>(q_s + (n >> 3) * KL * 16 + (k >> 3) * 128 + (n & 7) * 16 +
                                 (k & 7) * 2) = v;
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    // ---- producer: one thread walks the granted clusters' members ----------------
    setmaxnreg_dec<40>();
    if ((tid & 127) == 0) {
      int slot = 0;
      uint32_t ph = 0;
      for (int p = 0; p < pl.P; ++p) {
        const int c = __ldg(cols_g + p);
        if (c == pl.pad) continue;
        for (int m = 0; m < mc; ++m) {
          const int row0 = c * pl.cap + m * cls + lane0;
          const float* an = aux + (int64_t(c) * 2 * mc + m) * cls + lane0;
          for (int kc = 0; kc < nk; ++kc) {
            const bool with_aux = kc == nk - 1;
            mbar_wait(empty + slot, ph ^ 1);
            mbar_expect_tx(full + slot, kRSlot + (with_aux ? kRAux : 0));
            tma_load_2d(e_s + slot * kRSlot, tm, full + slot, kc * E, row0);
            if (with_aux) {
              float* a = a_s + slot * 2 * kRRows;
              bulk_load(a, an, kRRows * 4, full + slot);
              bulk_load(a + kRRows, an + int64_t(mc) * cls, kRRows * 4, full + slot);
            }
            if (++slot == S) { slot = 0; ph ^= 1; }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: rows r0 and r0 + 8 of each stage, classes lane0 + r0 .. ----------
  setmaxnreg_inc<232>();
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;
  // 16-byte chunks of a query row 128 bytes apart, 8-row groups KL*16 apart
  const uint64_t bdesc = smem_desc(smem_addr(q_s), 128, KL * 16);

  // cell j: class row r0 + 8*((j >> 1) & 1), query (j >> 2)*8 + 2t + (j & 1)
  float acc_a[NC], acc_b[NC], s1[NC];
  int32_t c1[NC];
  float ax_a[4], ax_b[4];  // nrm of rows r0, r0 + 8, then their scl
  uint32_t a[KS][4];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    s1[j] = kNeg;
    c1[j] = 0;
  }
  int slot = 0;
  uint32_t ph = 0;
  // the landed stage in `slot`: this thread's 32 bytes of rows r0 and r0 + 8
  // (chunks 2t, 2t + 1, swizzled by the row), and the member's aux with its
  // last chunk; then the slot is freed and the fragments made
  auto load_stage = [&](float (&ax)[4], bool with_aux) {
    mbar_wait(full + slot, ph);
    const uint8_t* src = e_s + slot * kRSlot;
    uint4 x[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        x[h][c] = *reinterpret_cast<const uint4*>(src + (r0 + 8 * h) * 128 +
                                                  (((2 * t + c) ^ g) << 4));
    if (with_aux) {
      const float* an = a_s + slot * 2 * kRRows;
      ax[0] = an[r0];
      ax[1] = an[r0 + 8];
      ax[2] = an[kRRows + r0];
      ax[3] = an[kRRows + r0 + 8];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
    if (++slot == S) { slot = 0; ph ^= 1; }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (kI8) {  // word ks of a row: its columns 2t, 2t+1 | 2t+8, 2t+9
        uint32_t lo0, hi0, lo1, hi1;
        bf16x4_of_s8(word_of(x[0][ks >> 2], ks & 3), lo0, hi0);
        bf16x4_of_s8(word_of(x[1][ks >> 2], ks & 3), lo1, hi1);
        a[ks][0] = lo0;
        a[ks][1] = lo1;
        a[ks][2] = hi0;
        a[ks][3] = hi1;
      } else {  // words 2ks and 2ks + 1 of a row
        a[ks][0] = word_of(x[0][ks >> 1], (2 * ks) & 3);
        a[ks][1] = word_of(x[1][ks >> 1], (2 * ks) & 3);
        a[ks][2] = word_of(x[0][ks >> 1], (2 * ks + 1) & 3);
        a[ks][3] = word_of(x[1][ks >> 1], (2 * ks + 1) & 3);
      }
    }
  };
  auto issue = [&](float (&x)[NC], int kc) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_rs(x, a[ks], bdesc + uint64_t((kc * KS + ks) * 16), kc > 0 || ks > 0);
    wgmma_commit();
  };
  // score = scl * dot + nrm, rounded twice (no FMA contraction), then keep1
  auto update = [&](const float (&y)[NC], const float (&ax)[4], int code) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int h = (j >> 1) & 1;
      keep1_cell(__fadd_rn(__fmul_rn(y[j], ax[2 + h]), ax[h]), code, s1[j], c1[j]);
    }
  };
  // member `code` into x, chunk by chunk; while its first chunk's wgmma run,
  // the previous member (in y, done) is updated
  auto member = [&](float (&x)[NC], float (&ax)[4], const float (&y)[NC],
                    const float (&ay)[4], int code, int prev) {
    for (int kc = 0; kc < nk; ++kc) {
      load_stage(ax, kc == nk - 1);
      issue(x, kc);
      if (kc == 0 && prev >= 0) update(y, ay, prev);
      wgmma_wait<0>();  // the fragments are free again
    }
  };
  // the walk's codes p*mc + m, the pad columns skipped
  int real = 0;
  for (int p = 0; p < pl.P; ++p) real += __ldg(cols_g + p) != pl.pad;
  const int total = real * mc;
  int cp = -1, cm = mc - 1;
  auto next_code = [&]() {
    if (++cm == mc) {
      cm = 0;
      do ++cp;
      while (__ldg(cols_g + cp) == pl.pad);
    }
    return cp * mc + cm;
  };
  // straight-line pairs, so that each accumulator set is a fixed register set
  int i = 0, prev = -1;
  for (; i + 1 < total; i += 2) {
    const int ca = next_code();
    member(acc_a, ax_a, acc_b, ax_b, ca, prev);
    const int cb = next_code();
    member(acc_b, ax_b, acc_a, ax_a, cb, ca);
    prev = cb;
  }
  if (i < total) {
    const int ca = next_code();
    member(acc_a, ax_a, acc_b, ax_b, ca, prev);
    update(acc_a, ax_a, ca);
  } else if (total > 0) {
    update(acc_b, ax_b, prev);
  }

  // cell j at (query grp*T + qn, class lane0 + r); rows = code*cls + class
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int qn = (j >> 2) * 8 + 2 * t + (j & 1);
    const int cl = lane0 + r0 + 8 * ((j >> 1) & 1);
    if (qn < T && cl < cls) {
      const int64_t o = int64_t(grp * T + qn) * cls + cl;
      best[o] = s1[j];
      rows[o] = c1[j] * cls + cl;
    }
  }
}

// best/rows/best2/rows2: the (B, cls) outputs of the class-max forms (keep1
// and K4 write the first two), K5's max1/arg1/max2/arg2 (B, members/2), or
// K6's max1/arg1 (B, members*cls/32). The class-max walk reads members
// n_pad/cls, K5's members of 64 rows (cls = 64), K4 the members of each
// granted cluster (members = cap/cls), its queries NQ a CTA.
template <int NWG, int KIND, int FORM, int CL, int NQ = 0>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
classmax2_kernel(const void* __restrict__ table, const float* __restrict__ aux,
                 const uint16_t* __restrict__ q, float* __restrict__ best,
                 int32_t* __restrict__ rows, float* __restrict__ best2,
                 int32_t* __restrict__ rows2, int B, int dp, int cls, int members,
                 const typename PlanOf<FORM>::type pl,
                 const __grid_constant__ CUtensorMap tmap) {
  constexpr bool kSplit = KIND != kExt;
  constexpr bool kI8 = KIND == kSplitI8;
  constexpr bool kBlockWalk = FORM == kBlocks;
  constexpr bool kChunkWalk = FORM == kChunks;
  constexpr bool kPair = CL == 2;
  static_assert(!(kPair && kI8), "an int8 table's raw ring is not shared");
  constexpr int TQ = NWG * 64;
  const int nk = pl.nk, w = pl.w, S = pl.S;
  const int slot_bytes = kTC * w * 2;
  const int raw_bytes = kTC * w + 2 * kTC * 4;  // int8: a raw stage and its aux
  extern __shared__ __align__(128) uint8_t smem[];
  if constexpr (FORM == kRouted) {
    static_assert(NWG == 2 && CL == 1, "K4: two consumer warpgroups, no pair");
    routed_cta<KIND, NQ>(smem, aux, q, best, rows, dp, cls, members, pl,
                         reinterpret_cast<uint64_t>(&tmap));
    return;
  }
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxSlots;
  uint8_t* q_s = smem + kBarBytes;                    // [TQ/8][dp/8][8 rows][8] bf16
  uint8_t* e_s = q_s + TQ * dp * 2;                   // S x [8][w/8][8 rows][8] bf16
  float* a_s = reinterpret_cast<float*>(e_s + S * slot_bytes);       // S x [nrm 64, scl 64]
  uint8_t* r_s = reinterpret_cast<uint8_t*>(a_s + (kSplit ? S * 2 * kTC : 0));  // kRaw raw
  uint32_t* st_s = reinterpret_cast<uint32_t*>(r_s + (kI8 ? kRaw * raw_bytes : 0));  // K5
  const int64_t n_pad = int64_t(members) * cls;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  // the class-max walk: every member, classes lane0 ..; K5: the members of
  // blocks blockIdx.y*run .. (rows 64m .. of member m); K6: the members of
  // chunks z*run .., z = blockIdx.y / (cls/64), classes lane0 .. of each
  const int ctiles = kChunkWalk ? cls / kTC : 1;
  const int lane0 = kBlockWalk ? 0 : (kChunkWalk ? blockIdx.y % ctiles : blockIdx.y) * kTC;
  const int m0 = kBlockWalk ? blockIdx.y * pl.run * 2
                            : kChunkWalk ? blockIdx.y / ctiles * pl.run * kChunk : 0;
  const int count = kBlockWalk   ? min(2 * pl.run, members - m0)
                    : kChunkWalk ? min(pl.run * kChunk, members - m0)
                                 : members;
  // a cluster pair: this CTA's rank, the peer's, and the half of each stage's
  // row groups this CTA's producer loads for both
  const uint32_t rank = kPair ? cluster_rank() : 0, peer = rank ^ 1;

  uint64_t* raw_full = empty + kMaxSlots;  // int8: kRaw raw stages landed
  uint64_t* raw_empty = raw_full + kRaw;   // int8: kRaw raw stages widened
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, kI8 ? 128 : 1);  // the TMA thread, or every widening thread
      mbar_init(empty + s, NWG * 4 * CL);  // every consumer warp (of both CTAs)
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
  if constexpr (kPair) cluster_sync();  // the peer's barriers are initialised

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
      // copies of its nrm and scl) onto the slot's full barrier; in a pair,
      // of its half of the rows into both CTAs
      if (p == 0) {
        for (int m = m0; m < m0 + count; ++m) {
          const int64_t row0 = int64_t(m) * cls + lane0;
          for (int kc = 0; kc < nk; ++kc) {
            const bool with_aux = kSplit && kc == nk - 1;
            mbar_wait(empty + slot, ph ^ 1);
            mbar_expect_tx(full + slot, slot_bytes + (with_aux ? 2 * kTC * 4 : 0));
            if constexpr (kPair)
              tma_load_4d_pair(e_s + slot * slot_bytes + rank * (slot_bytes / 2), tm,
                               full + slot, kc * w / 8, int(row0 / 8) + 4 * rank);
            else
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
      const int total = count * nk;
      auto raw_load = [&](int j) {
        const int rs = j % kRaw, m = m0 + j / nk, kc = j - (j / nk) * nk;
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
    if constexpr (kPair) {
      __syncwarp();
      cluster_sync();
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
  // K5: the running top two of query rows g and g+8 over the block's rows
  float bv1[2], bv2[2];
  int br1[2], br2[2];
  uint32_t* st = st_s + (wg * 4 + warp) * kStageWords;  // K5: this warp's staging

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
    if (lane == 0) {
      mbar_arrive(empty + s);
      if constexpr (kPair) mbar_arrive_peer(empty + s, peer);
    }
  };
  // K5: block jb of the CTA's run is scored; blocks jb - jb % 16 .. jb are
  // staged. The quad's merge, the mask rule, the staging; after the 16th
  // block of a run or the CTA's last block the warp writes the run out.
  auto finish_block = [&](int jb) {
    const int jr = jb % kRun;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Top2 top{bv1[h], br1[h], bv2[h], br2[h]};
      top = merge(top, shfl_xor(top, 1));
      top = merge(top, shfl_xor(top, 2));
      // the Pallas runner-up: the winner's lane masked to exactly -3e38
      float v2 = kNeg;
      int r2 = top.r1;
      if (top.v2 > kNeg) {
        v2 = top.v2;
        r2 = top.r2;
      } else if (top.v2 == kNeg) {
        r2 = min(top.r1, top.r2);
      }
      if (t == h) {
        const int row0 = (m0 / 2 + jb) * kBlk;
        uint32_t* o = st + (g + 8 * h) * kRun + jr;
        o[0] = __float_as_uint(top.v1);
        o[16 * kRun] = uint32_t(row0 + top.r1);
        o[32 * kRun] = __float_as_uint(v2);
        o[48 * kRun] = uint32_t(row0 + r2);
      }
    }
    if (jr == kRun - 1 || 2 * jb + 2 == count) {
      __syncwarp();
      const int nb = members / 2, col0 = m0 / 2 + jb - jr;
      const int qw = q0 + wg * 64 + warp * 16;
#pragma unroll
      for (int pi = 0; pi < 4; ++pi) {
        uint32_t* out = reinterpret_cast<uint32_t*>(
            pi == 0 ? static_cast<void*>(best)
                    : pi == 1 ? static_cast<void*>(rows)
                              : pi == 2 ? static_cast<void*>(best2) : static_cast<void*>(rows2));
#pragma unroll
        for (int k = lane; k < 16 * kRun; k += 32) {  // query k / kRun, block k % kRun
          const int j = k % kRun, qr = k / kRun;
          if (j <= jr && qw + qr < B) out[int64_t(qw + qr) * nb + col0 + j] = st[pi * 16 * kRun + k];
        }
      }
      __syncwarp();
    }
  };
  // member code's dot products are in y and its aux in slot s: the running
  // update (y itself is only read: no instruction but wgmma writes an
  // accumulator, or ptxas serializes the wgmma)
  auto update = [&](const float (&y)[32], int code, int s) {
    if constexpr (kBlockWalk) {
      // code = member code of the CTA's walk: half code & 1 of block code / 2
      const int h = code & 1;
      if (h == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bv1[r] = bv2[r] = -__int_as_float(0x7f800000);
          br1[r] = br2[r] = INT_MAX;
        }
      }
      const int base = h * kTC + 2 * t;  // the block row of cell 0
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        keep2_cell(y[i], base + (i >> 2) * 8 + (i & 1), bv1[r], bv2[r], br1[r], br2[r]);
      }
      if (h == 1) finish_block(code >> 1);
    } else if constexpr (kChunkWalk) {
      // code = member of the CTA's walk; its chunk's member 0 enters
      // whatever it scores, and the chunk's last member writes it out
      const int gm = m0 + code;
      if ((code & (kChunk - 1)) == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s1[i] = y[i];
          c1[i] = gm;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) keep1_cell(y[i], gm, s1[i], c1[i]);
      }
      if ((code & (kChunk - 1)) == kChunk - 1) {
        // chunk z's classes at columns z*cls + lane0 .. of rows members*cls/32 wide
        const int64_t ld = int64_t(members) * cls / kChunk;
        const int col0 = (gm / kChunk) * cls + lane0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qi = q0 + wg * 64 + warp * 16 + g + 8 * h;
          if (qi >= B) continue;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int i = nb * 4 + 2 * h;
            const int64_t o = int64_t(qi) * ld + col0 + nb * 8 + 2 * t;
            const int row = lane0 + nb * 8 + 2 * t;
            *reinterpret_cast<float2*>(best + o) = make_float2(s1[i], s1[i + 1]);
            *reinterpret_cast<int2*>(rows + o) =
                make_int2(c1[i] * cls + row, c1[i + 1] * cls + row + 1);
          }
        }
      }
    } else {
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
        if constexpr (FORM == kKeep2)
          keep2_cell(v, code, s1[i], s2[i], c1[i], c2[i]);
        else
          keep1_cell(v, code, s1[i], c1[i]);
      }
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
    if (count > 0) {
      issue(acc_a, 0);
      advance();
      int m = 1;
      for (; m + 1 < count; m += 2) {
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
      if (m < count) {
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
    for (; m + 1 < count; m += 2) {
      member(acc_a, acc_b, m);
      member(acc_b, acc_a, m + 1);
    }
    if (m < count) member(acc_a, acc_b, m);
    if (count > 0) {
      wgmma_wait<0>();
      if (count & 1)
        update(acc_a, count - 1, prev);
      else
        update(acc_b, count - 1, prev);
    }
  }

  if constexpr (!kBlockWalk && !kChunkWalk) {
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
        *reinterpret_cast<int2*>(rows + o) =
            make_int2(c1[i] * cls + col, c1[i + 1] * cls + col + 1);
        if constexpr (FORM == kKeep2) {
          *reinterpret_cast<float2*>(best2 + o) = make_float2(s2[i], s2[i + 1]);
          *reinterpret_cast<int2*>(rows2 + o) =
              make_int2(c2[i] * cls + col, c2[i + 1] * cls + col + 1);
        }
      }
    }
  }
  if constexpr (kPair) cluster_sync();  // no CTA exits while its peer may reach it
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
// (all, 8, w/e chunks, `groups` groups) lands in shared memory as [group]
// [chunk][row][16 bytes]: 8-row x 16-byte core matrices, chunks 128 bytes
// apart, groups w*16 (bf16) bytes apart, the layout wgmma reads without
// swizzle. A stage is 8 groups (64 rows): one box, or in a cluster pair two
// boxes of 4, one from each CTA. Columns past dp are zero-filled.
bool tma_map(CUtensorMap* map, const void* table, int64_t n_pad, int dp, int w, bool i8,
             int groups) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elt = i8 ? 1 : 2, e = 16 / elt;
  const cuuint64_t dims[4] = {e, 8, cuuint64_t(dp) / e, cuuint64_t(n_pad) / 8};
  const cuuint64_t strides[3] = {cuuint64_t(dp) * elt, 16, cuuint64_t(dp) * elt * 8};
  const cuuint32_t box[4] = {cuuint32_t(e), 8, cuuint32_t(w / e), cuuint32_t(groups)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(table), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K4: the table (rows, dp) row-major, bf16 or int8, in 2-D; a box of 128
// rows x 128 bytes (one chunk of each row) lands with the 128-byte swizzle:
// 16-byte chunk c of row r at chunk c ^ (r % 8) of the row's 128 bytes.
// Columns past dp are zero-filled.
bool tma_map_rows(CUtensorMap* map, const void* table, int64_t rows, int dp, bool i8) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elt = i8 ? 1 : 2;
  const cuuint64_t dims[2] = {cuuint64_t(dp), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(dp) * elt};
  const cuuint32_t box[2] = {cuuint32_t(128 / elt), cuuint32_t(kRRows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(table), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The outputs and shape of one launch.
struct Args {
  const void* table;
  const float* aux;
  const uint16_t* q;
  float* o0;
  int32_t* o1;
  float* o2;
  int32_t* o3;
  int B, dp, cls, members;
};

template <int NWG, int KIND, int FORM, int CL>
int launch(const Args& a, const Plan& pl, size_t smem, cudaStream_t stream) {
  CUtensorMap map;
  if (!tma_map(&map, a.table, int64_t(a.members) * a.cls, a.dp, pl.w, KIND == kSplitI8,
               8 / CL))
    return int(cudaErrorInvalidValue);
  auto kernel = classmax2_kernel<NWG, KIND, FORM, CL>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  // query tiles (an even count in a pair: the last CTA may hold none) x
  // class tiles, or K5's block runs, or K6's class tiles x chunk runs
  const int tiles = (a.B + NWG * 64 - 1) / (NWG * 64);
  const int runs = FORM == kBlocks   ? (a.members / 2 + pl.run - 1) / pl.run
                   : FORM == kChunks ? (a.members / kChunk + pl.run - 1) / pl.run
                                     : 1;
  const dim3 grid((tiles + CL - 1) / CL * CL, FORM == kBlocks ? runs : a.cls / kTC * runs);
  if constexpr (CL == 1) {
    kernel<<<grid, (NWG + 1) * 128, smem, stream>>>(a.table, a.aux, a.q, a.o0, a.o1, a.o2, a.o3,
                                                     a.B, a.dp, a.cls, a.members, pl, map);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3((NWG + 1) * 128);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, a.table, a.aux, a.q, a.o0, a.o1, a.o2, a.o3, a.B, a.dp,
                           a.cls, a.members, pl, map);
    if (e != cudaSuccess) return int(e);
  }
  return int(cudaGetLastError());
}

// The forms that run as cluster pairs at 128 queries a CTA: those the pair
// made faster on the card (PERF.md), and K6, K2a's walk with a restart.
template <int KIND, int FORM>
constexpr bool paired() {
  return (FORM == kKeep1 || FORM == kChunks) && KIND != kSplitI8;
}

template <int KIND, int FORM>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.dp % 16 || a.cls % kTC || a.B <= 0) return int(cudaErrorInvalidValue);
  // the 128-query tile while a member's rows fit in one slot (dp <= 256) and
  // a ring of 3 fits beside the queries, else 64 queries beside a ring of 2
  // whose slots hold column chunks
  for (int nwg = 2; nwg >= 1; --nwg) {
    for (int cap = 256; cap >= 16; cap /= 2) {
      const int units = a.dp / 16, per = (units + cap / 16 - 1) / (cap / 16);
      const int w = (units + per - 1) / per * 16;  // per chunks of at most cap
      const size_t base = smem_bytes(nwg, a.dp, KIND, FORM, w, 0);
      if (base >= size_t(kSmemMax)) continue;
      const size_t slot = smem_bytes(nwg, a.dp, KIND, FORM, w, 1) - base;
      const int S = int(std::min<size_t>(kMaxSlots, (kSmemMax - base) / slot));
      if (S < (nwg == 2 ? 3 : 2) || (nwg == 2 && w < a.dp)) continue;
      // K5: about kWaveCtas CTAs, each walking one run of blocks; K6: of
      // chunks, in each class tile
      int run = 0;
      const int tiles = (a.B + nwg * 64 - 1) / (nwg * 64);
      if (FORM == kBlocks) {
        const int nb = a.members / 2;
        const int runs = std::max(1, std::min((nb + kRun - 1) / kRun, kWaveCtas / tiles));
        run = (nb + runs - 1) / runs;
      } else if (FORM == kChunks) {
        const int nc = a.members / kChunk;
        const int runs = std::max(1, std::min(nc, kWaveCtas / (tiles * (a.cls / kTC))));
        run = (nc + runs - 1) / runs;
      }
      const Plan pl{(a.dp + w - 1) / w, w, S, run};
      const size_t smem = smem_bytes(nwg, a.dp, KIND, FORM, w, S);
      if (nwg == 1) return launch<1, KIND, FORM, 1>(a, pl, smem, stream);
      return launch<2, KIND, FORM, paired<KIND, FORM>() ? 2 : 1>(a, pl, smem, stream);
    }
  }
  return int(cudaErrorInvalidValue);
}

template <int KIND>
int dispatch_keep(int keep, const Args& a, cudaStream_t stream) {
  return keep == 2 ? dispatch<KIND, kKeep2>(a, stream) : dispatch<KIND, kKeep1>(a, stream);
}

#if SHINE_CM_HAS(1) || SHINE_CM_HAS(2)
// The class-max scans: kind 0 K2's packed bf16 ext, 1 K3's bf16 comp, 2 K3's
// int8 comp (aux (2, n_pad) f32 [nrm; scl] for 1 and 2); keep 1 or 2.
// best/rows (B, cls), and best2/rows2 with keep 2. Returns the cudaError_t of
// the launch.
int classmax_dispatch(int kind, int keep, const void* table, const void* aux, const void* q,
                      int64_t n_pad, int B, int dp, int cls, void* best, void* rows,
                      void* best2, void* rows2, void* stream) {
  if (cls <= 0 || n_pad % cls) return int(cudaErrorInvalidValue);
  const Args a{table,
               static_cast<const float*>(aux),
               static_cast<const uint16_t*>(q),
               static_cast<float*>(best),
               static_cast<int32_t*>(rows),
               static_cast<float*>(best2),
               static_cast<int32_t*>(rows2),
               B,
               dp,
               cls,
               int(n_pad / cls)};
  auto s = static_cast<cudaStream_t>(stream);
#if SHINE_CM_HAS(2)
  if (kind == kSplitI8) return dispatch_keep<kSplitI8>(keep, a, s);
  if (kind == kSplitBf16) return dispatch_keep<kSplitBf16>(keep, a, s);
#endif
#if SHINE_CM_HAS(1)
  if (kind == kExt) return dispatch_keep<kExt>(keep, a, s);
#endif
  return int(cudaErrorInvalidValue);
}
#endif

// K4: one CTA a (group, 128 classes); NQ queries a CTA, the least of 16, 32
// and 64 that holds T.
template <int KIND, int NQ>
int launch_routed(const Args& a, const RoutedPlan& pl, int64_t rows, size_t smem,
                  cudaStream_t stream) {
  CUtensorMap map;
  if (!tma_map_rows(&map, a.table, rows, a.dp, KIND == kSplitI8))
    return int(cudaErrorInvalidValue);
  auto kernel = classmax2_kernel<2, KIND, kRouted, 1, NQ>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(a.B / pl.T, (a.cls + kRRows - 1) / kRRows);
  kernel<<<grid, 3 * 128, smem, stream>>>(a.table, a.aux, a.q, a.o0, a.o1, nullptr, nullptr, a.B,
                                          a.dp, a.cls, a.members, pl, map);
  return int(cudaGetLastError());
}

template <int KIND>
int dispatch_routed(const Args& a, const int32_t* cols, int C, int G, int T, int P, int cap,
                    cudaStream_t stream) {
  if (a.dp % 16 || a.cls % kTC || cap % a.cls || G <= 0 || P <= 0 || T <= 0 || T > 64 ||
      int64_t(C + 1) * cap >= INT_MAX)
    return int(cudaErrorInvalidValue);
  constexpr int E = KIND == kSplitI8 ? 128 : 64;
  const int nk = (a.dp + E - 1) / E, nq = T <= 16 ? 16 : T <= 32 ? 32 : 64;
  const size_t base = routed_smem_bytes(nq, nk * E, 0);
  if (base >= size_t(kSmemMax)) return int(cudaErrorInvalidValue);
  const int S = int(std::min<size_t>(kMaxSlots, (kSmemMax - base) / (kRSlot + kRAux)));
  if (S < 2) return int(cudaErrorInvalidValue);
  const RoutedPlan pl{nk, E, S, 0, cols, P, T, cap, C};
  const size_t smem = routed_smem_bytes(nq, nk * E, S);
  const int64_t rows = int64_t(C + 1) * cap;
  if (nq == 16) return launch_routed<KIND, 16>(a, pl, rows, smem, stream);
  if (nq == 32) return launch_routed<KIND, 32>(a, pl, rows, smem, stream);
  return launch_routed<KIND, 64>(a, pl, rows, smem, stream);
}

}  // namespace

#if SHINE_CM_HAS(1)
// K2. best/rows (B, cls) f32/i32 outputs, best2/rows2 too when keep2 (else
// null). Needs dp % 16 == 0, cls % 64 == 0, n_pad % cls == 0, 16-byte
// aligned ext and q. Returns the cudaError_t of the launch; the caller
// raises if not 0.
extern "C" int shine_classmax_scan(const void* ext, const void* q, int64_t n_pad, int B,
                                   int dp, int cls, int keep2, void* best, void* rows,
                                   void* best2, void* rows2, void* stream) {
  return classmax_dispatch(kExt, keep2 ? 2 : 1, ext, nullptr, q, n_pad, B, dp, cls, best, rows,
                           best2, rows2, stream);
}
#endif

#if SHINE_CM_HAS(2)
// K3. comp (n_pad, dpc) bf16 (comp_int8 = 0) or int8 (1), aux (2, n_pad) f32
// [nrm; scl], q (B, dpc) bf16; outputs and requirements as K2's, aux 16-byte
// aligned too.
extern "C" int shine_classmax_scan_split(const void* comp, int comp_int8, const void* aux,
                                         const void* q, int64_t n_pad, int B, int dpc, int cls,
                                         int keep2, void* best, void* rows, void* best2,
                                         void* rows2, void* stream) {
  return classmax_dispatch(comp_int8 ? kSplitI8 : kSplitBf16, keep2 ? 2 : 1, comp, aux, q, n_pad,
                           B, dpc, cls, best, rows, best2, rows2, stream);
}
#endif

#if SHINE_CM_HAS(1)
// K5. ext (n_pad, dp) bf16, q (B, dp) bf16; max1/arg1/max2/arg2 (B, n_pad/128)
// f32/i32/f32/i32. Needs dp % 16 == 0, n_pad % 128 == 0 and 16-byte aligned
// ext and q. The query tile is 128 while dp <= 256, else 64. Returns the
// cudaError_t of the launch; the caller raises if not 0.
extern "C" int shine_blockmax_scan(const void* ext, const void* q, int64_t n_pad, int B, int dp,
                                   void* max1, void* arg1, void* max2, void* arg2,
                                   void* stream) {
  if (n_pad <= 0 || n_pad % kBlk || n_pad / kTC >= int64_t(INT_MAX))
    return int(cudaErrorInvalidValue);
  const Args a{ext,
               nullptr,
               static_cast<const uint16_t*>(q),
               static_cast<float*>(max1),
               static_cast<int32_t*>(arg1),
               static_cast<float*>(max2),
               static_cast<int32_t*>(arg2),
               B,
               dp,
               kTC,
               int(n_pad / kTC)};
  return dispatch<kExt, kBlocks>(a, static_cast<cudaStream_t>(stream));
}

// K6. ext (n_pad, dp) bf16, q (B, dp) bf16, best/rows (B, n_pad/32) f32/i32:
// column c*128 + p holds the best of rows c*4096 + m*128 + p, m = 0..31, and
// that row, the first member winning a tie. Needs dp % 16 == 0, n_pad % 4096
// == 0 and 16-byte aligned ext and q.
extern "C" int shine_blockmax_scan2(const void* ext, const void* q, int64_t n_pad, int B, int dp,
                                    void* best, void* rows, void* stream) {
  constexpr int kCls = 128;
  if (n_pad <= 0 || n_pad % (kCls * kChunk) || n_pad >= int64_t(INT_MAX))
    return int(cudaErrorInvalidValue);
  const Args a{ext,
               nullptr,
               static_cast<const uint16_t*>(q),
               static_cast<float*>(best),
               static_cast<int32_t*>(rows),
               nullptr,
               nullptr,
               B,
               dp,
               kCls,
               int(n_pad / kCls)};
  return dispatch<kExt, kChunks>(a, static_cast<cudaStream_t>(stream));
}
#endif

#if SHINE_CM_HAS(3)
// K4. comp ((C+1)*cap or more rows, dpc) bf16 (comp_int8 = 0) or int8 (1),
// cluster-major; aux_r (C+1, 2*cap/cls, cls) f32, nrm rows then scl rows,
// cluster C a pad cluster (comp 0, nrm -3e38), which the walk skips; q
// (G*T, dpc) bf16; cols (G, P) i32, each in 0..C; best/rows (G*T, cls)
// f32/i32, rows = code*cls + lane with code = p*(cap/cls) + member. Needs
// dpc % 16 == 0, cls % 64 == 0, cap % cls == 0, 1 <= T <= 64, (C+1)*cap <
// 2^31 and 16-byte aligned comp, aux_r and q.
extern "C" int shine_classmax_scan_routed(const void* comp, int comp_int8, const void* aux_r,
                                          const void* q, const void* cols, int C, int G, int T,
                                          int P, int dpc, int cap, int cls, void* best,
                                          void* rows, void* stream) {
  if (cls <= 0) return int(cudaErrorInvalidValue);
  const Args a{comp,
               static_cast<const float*>(aux_r),
               static_cast<const uint16_t*>(q),
               static_cast<float*>(best),
               static_cast<int32_t*>(rows),
               nullptr,
               nullptr,
               G * T,
               dpc,
               cls,
               cap / cls};
  const auto* c = static_cast<const int32_t*>(cols);
  auto s = static_cast<cudaStream_t>(stream);
  if (comp_int8) return dispatch_routed<kSplitI8>(a, c, C, G, T, P, cap, s);
  return dispatch_routed<kSplitBf16>(a, c, C, G, T, P, cap, s);
}
#endif
