// K1 on Hopper: score candidate rows (gather_score) and the fused layer-0
// HNSW beam step (beam_step). Both score rows through one device routine,
// RowScorer, so one row of one query gets the same bits from either entry.
//
// Replaces shine_tpu/ops/pallas_gather.py:gather_rows_pallas_flat (and its
// 2-D twin gather_rows_pallas) with the scoring that followed it in
// shine_tpu/models/hnsw.py:_dist_ext, and, in beam_step, the whole body of
// the JAX package's layer-0 lax.while_loop (shine_tpu/models/hnsw.py:
// _beam_search_l0_seeded: frontier pick, list gather, row gather, scoring,
// ops/beam.py:beam_merge and the counters).
//
// gather_score, for query b and candidate lane k:
//
//   out[b, k] = +inf                                  if ids[b, k] < 0
//             = NaN                                   if ids[b, k] >= N
//             = bias[b] + s(row) (+ n(row) if l2)      otherwise, row = ids[b, k]
//
//   f32 / bf16 rows: s = sum_j q_ext[b, j] * v[row, j],  n = sum_j v[row, j]^2
//   int8 rows:       s = row_scl[row] * sum_j q_ext[b, j] * v[row, j],
//                    n = row_nrm[row]
//
// All sums are f32; the scale, norm and bias are added by __fmul_rn and
// __fadd_rn, which the compiler never fuses, so both entries round alike.
//
// beam_step, one CTA per query, its beam in shared memory for the step:
//   1. gate: if unsettled[t] is 0 the previous launch left every query
//      settled, and the launch returns at once, writing nothing;
//   2. frontier: the first E unexpanded slots in beam order (a ballot over
//      ef), marked expanded;
//   3. the E lists neighbors0[fid] (W = 2M ids each; an inactive slot gives
//      -1 lanes), and the counters: hops += active slots, dists += lanes
//      with an id >= 0;
//   4. duplicates dropped before any row is read: a lane goes if its id is
//      a pad, is in the beam, or repeats an earlier lane (a hash table in
//      shared memory). beam_merge keeps the beam's copy of an id, or the
//      first candidate copy, and every copy of one id scores the same bits,
//      so the dropped copies' distances never reach its output;
//   5. the kept rows scored by RowScorer;
//   6. merge: with duplicates gone the (dist, id) key of ops/beam.py:
//      dist_id_key (the float's ordered bits, -0.0 read as +0.0, then the
//      id) is a total order on the real entries. A candidate whose key is
//      past a full beam's last entry has ef entries below it and cannot
//      place, so it is dropped as it is scored; each remaining entry's
//      place is the count of entries below it (a binary search in the
//      sorted beam, a count over the surviving candidates). The first ef
//      are written back in place, the rest of the row as pads (+inf, -1,
//      expanded);
//   7. the query's settled flag after the merge (term "ef": its ef entries
//      expanded; "k": its first k), added into unsettled[t + 1].
// Its output is beam_merge's bit for bit. Limits: ef <= 512, E * W <= 1024
// lanes, and the shared memory of shine_beam_step_smem under 48 KB.
//
// What bounds a step on the H100: device-memory bytes, then the latency of
// each CTA's chain of dependent loads (its beam, its lists, their rows).
// At step 8 of a 4096-query batch on the 1M x 128 graph (ef=96, E=8, W=32;
// chip_smoke.py phase 19) 87% of the 256 lanes hold an id and 92% of those
// are new, so the step reads ~0.84M rows: 0.43 GB of f32 rows, a bound of
// 0.13 ms at the data sheet's 3.35 TB/s (bf16 0.07 ms, int8 0.04 ms).
// Measured on random lists at the same step (NVIDIA H100 80GB HBM3, 700 W;
// scripts/torch_k1_ab.py): f32 0.224 ms, bf16 0.147, int8 0.146, of which
// the ablation (scripts/torch_beam_step_ablate.py) puts 0.14 (f32) in the
// row scoring, ~0.08 in the rest and ~0.01 in the merge. An int8 row's scale
// and norm cost two more 32-byte sectors, as many bytes as a bf16 row.
//
// What the design does about it: no candidate tile, beam copy or sort key
// ever goes to device memory; one launch replaces the plain step's ~80
// (two int64 sorts among them) and no step reads a flag back to the host.
// The duplicate drop reads each new row once, and the merge counts only
// the candidates that can place. RowScorer reads each row once, as 16-byte
// packs: a row takes as many lanes as it has packs, rounded up to a power
// of two (at d=128: 32 lanes for f32, 16 for bf16, 8 for int8), so a warp
// scores 1, 2 or 4 rows a pass, and it issues the loads of kUnroll passes
// (and an int8 row's scale and norm) before it reduces them by segmented
// shuffles. Rows whose byte width or base address is not a multiple of 16
// take an element-wise loop, one row a warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // row groups a warp keeps in flight
constexpr int kMaxEf = 512;
constexpr int kMaxLanes = 1024;  // E * W
constexpr size_t kMaxSmem = 48 * 1024;
constexpr uint32_t kFull = 0xffffffffu;

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

// int8: the byte plus 128 in the low mantissa bits of 2^23 is exactly
// 2^23 + 128 + x, so one subtraction gives x (no int-to-float conversion).
template <> struct Pack<int8_t> {
  static constexpr int n = 16;
  __device__ static void unpack(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] =
            __uint_as_float(0x4b000000u | (((w[i] >> (8 * j)) & 0xffu) ^ 0x80u)) - 8388736.f;
  }
  __device__ static float one(int8_t x) { return float(x); }
};

// Lanes that score one row: its 16-byte packs rounded up to a power of two,
// at most 32; the element-wise path takes the whole warp.
template <typename T>
int row_lanes(int d, bool vec) {
  if (!vec) return 32;
  const int packs = d / Pack<T>::n;
  int g = 1;
  while (g < packs && g < 32) g <<= 1;
  return g;
}

// What a warp needs to score rows for one query. Lane l serves slot
// l / lanes of each of the kUnroll groups; all lanes of a slot end with the
// slot's distance. A lane's partial sum runs over the packs sub, sub +
// lanes, ... of the row (sub = l % lanes), and the slot's partials meet in
// a fixed xor-shuffle tree, so the order of the sum depends on d and lanes
// only, never on the slot or group that holds the row.
template <typename T, bool VEC, bool QUANT>
struct RowScorer {
  const T* vectors;
  const float* q_s;  // the query row, shared memory, 16-byte aligned
  const float* row_scl;
  const float* row_nrm;
  int d;
  int lanes;
  bool l2;
  float bias;

  // dist[u] = the distance of row rid[u]; rid[u] < 0 leaves dist[u] as it is.
  __device__ __forceinline__ void score(const int32_t (&rid)[kUnroll],
                                        float (&dist)[kUnroll]) const {
    const int lane = threadIdx.x & 31;
    float dot[kUnroll], sq[kUnroll], scl[kUnroll], nrm[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dot[u] = sq[u] = scl[u] = nrm[u] = 0.f;
      if (QUANT && rid[u] >= 0) {  // in flight beside the row's loads
        scl[u] = __ldg(row_scl + rid[u]);
        if (l2) nrm[u] = __ldg(row_nrm + rid[u]);
      }
    }
    if (VEC) {
      constexpr int P = Pack<T>::n;
      const int packs = d / P;
      const int sub = lane & (lanes - 1);
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
      for (int p0 = 0; p0 < packs; p0 += lanes) {
        const int p = p0 + sub;
        const bool in = p < packs;
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = (in && rid[u] >= 0)
                     ? __ldg(reinterpret_cast<const uint4*>(vectors + int64_t(rid[u]) * d) + p)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!in || rid[u] < 0) continue;
          float f[P];
          Pack<T>::unpack(v[u], f);
#pragma unroll
          for (int c = 0; c < P / 4; ++c) {
            const float4 q = q4[p * (P / 4) + c];
            dot[u] = fmaf(q.x, f[4 * c], dot[u]);
            dot[u] = fmaf(q.y, f[4 * c + 1], dot[u]);
            dot[u] = fmaf(q.z, f[4 * c + 2], dot[u]);
            dot[u] = fmaf(q.w, f[4 * c + 3], dot[u]);
          }
          if (!QUANT) {
#pragma unroll
            for (int j = 0; j < P; ++j) sq[u] = fmaf(f[j], f[j], sq[u]);
          }
        }
      }
    } else {
      for (int j = lane; j < d; j += 32) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rid[u] < 0) continue;
          const float f = Pack<T>::one(vectors[int64_t(rid[u]) * d + j]);
          dot[u] = fmaf(q_s[j], f, dot[u]);
          if (!QUANT) sq[u] = fmaf(f, f, sq[u]);
        }
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dot[u] += __shfl_xor_sync(kFull, dot[u], o);
        if (!QUANT) sq[u] += __shfl_xor_sync(kFull, sq[u], o);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (rid[u] < 0) continue;
      float s = dot[u];
      if (QUANT) {
        s = __fmul_rn(s, scl[u]);
        if (l2) s = __fadd_rn(s, nrm[u]);
      } else if (l2) {
        s = __fadd_rn(s, sq[u]);
      }
      dist[u] = __fadd_rn(bias, s);
    }
  }
};

template <typename T, bool VEC, bool QUANT>
__global__ void __launch_bounds__(kThreads)
gather_score_kernel(const T* __restrict__ vectors, const float* __restrict__ q_ext,
                    const float* __restrict__ bias, const int32_t* __restrict__ ids,
                    const float* __restrict__ row_scl, const float* __restrict__ row_nrm,
                    float* __restrict__ out, int64_t n_rows, int K, int d, int lanes,
                    bool l2) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += kThreads) q_s[j] = q_ext[int64_t(b) * d + j];
  __syncthreads();

  const RowScorer<T, VEC, QUANT> sc{vectors, q_s, row_scl, row_nrm, d, lanes, l2, bias[b]};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slots = 32 / lanes;
  const int slot = lane / lanes;
  const int per_pass = slots * kUnroll;
  const int32_t* ids_b = ids + int64_t(b) * K;
  float* out_b = out + int64_t(b) * K;
  for (int base = warp * per_pass; base < K; base += kWarps * per_pass) {
    int32_t raw[kUnroll], rid[kUnroll];
    float dist[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * slots + slot;
      raw[u] = k < K ? ids_b[k] : -1;
      rid[u] = (raw[u] >= 0 && raw[u] < n_rows) ? raw[u] : -1;
      dist[u] = 0.f;
    }
    sc.score(rid, dist);
    if ((lane & (lanes - 1)) == 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = base + u * slots + slot;
        if (k >= K) continue;
        out_b[k] = raw[u] < 0 ? __int_as_float(0x7f800000)                // +inf
                   : raw[u] >= n_rows ? __int_as_float(0x7fffffff)         // NaN
                                      : dist[u];
      }
    }
  }
}

// ---- beam_step ---------------------------------------------------------------

// The high word of ops/beam.py:dist_id_key: the float's bits, ordered as
// integers, with -0.0 read as +0.0.
__device__ __forceinline__ int dist_key(float d) {
  const int bits = __float_as_int(__fadd_rn(d, 0.f));
  return bits < 0 ? bits ^ 0x7fffffff : bits;
}

// ops/beam.py:dist_id_key of a real entry (id >= 0): the ordered bits in the
// high word, the id in the low word, so int64 order is (dist, id) order.
__device__ __forceinline__ int64_t entry_key(float d, int32_t id) {
  return int64_t(uint64_t(uint32_t(dist_key(d))) << 32 | uint32_t(id));
}

// Insert id into the open-addressed table (empty = -1); true if it was new.
__device__ __forceinline__ bool table_insert(int32_t* table, int bits, int32_t id) {
  const uint32_t mask = (1u << bits) - 1u;
  uint32_t h = (uint32_t(id) * 2654435761u) >> (32 - bits);
  while (true) {
    const int32_t prev = atomicCAS(table + h, -1, id);
    if (prev == -1) return true;
    if (prev == id) return false;
    h = (h + 1u) & mask;
  }
}

int table_bits(int ef, int lanes) {
  int bits = 5;
  while ((1 << bits) < 2 * (ef + lanes)) ++bits;
  return bits;
}

// Shared-memory layout of beam_step (4-byte words, then the flags' bytes):
// q_s[d rounded up to 4], sk[L] (8-byte keys), bd[ef], bi[ef], fid[E],
// cid[L], cd[L], table[2^bits], be[ef].
size_t beam_step_smem(int ef, int E, int W, int d) {
  const int L = E * W;
  const size_t words = size_t((d + 3) / 4 * 4) + 2 * size_t(ef) + E + 4 * size_t(L) +
                       (size_t(1) << table_bits(ef, L));
  return words * 4 + ef;
}

template <typename T, bool VEC, bool QUANT>
__global__ void __launch_bounds__(kThreads)
beam_step_kernel(const T* __restrict__ vectors, const float* __restrict__ q_ext,
                 const float* __restrict__ bias, const float* __restrict__ row_scl,
                 const float* __restrict__ row_nrm, const int32_t* __restrict__ neighbors0,
                 float* __restrict__ beam_d, int32_t* __restrict__ beam_i,
                 uint8_t* __restrict__ beam_e, int32_t* __restrict__ hops,
                 int32_t* __restrict__ counts, int32_t* __restrict__ unsettled, int t,
                 int64_t n_rows, int ef, int E, int W, int d, int lanes, int settle,
                 int bits, bool l2) {
  if (unsettled[t] == 0) return;  // every query settled: this launch is a no-op

  extern __shared__ float4 smem4[];
  const int L = E * W;
  float* q_s = reinterpret_cast<float*>(smem4);
  int64_t* sk = reinterpret_cast<int64_t*>(q_s + (d + 3) / 4 * 4);
  float* bd = reinterpret_cast<float*>(sk + L);
  int32_t* bi = reinterpret_cast<int32_t*>(bd + ef);
  int32_t* fid = bi + ef;
  int32_t* cid = fid + E;
  float* cd = reinterpret_cast<float*>(cid + L);
  int32_t* table = reinterpret_cast<int32_t*>(cd + L);
  uint8_t* be = reinterpret_cast<uint8_t*>(table + (1 << bits));
  __shared__ int s_active, s_valid, s_kept, s_beam, s_surv, s_unsettled;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t below_lane = (1u << lane) - 1u;
  float* row_d = beam_d + int64_t(b) * ef;
  int32_t* row_i = beam_i + int64_t(b) * ef;
  uint8_t* row_e = beam_e + int64_t(b) * ef;

  for (int j = tid; j < d; j += kThreads) q_s[j] = q_ext[int64_t(b) * d + j];
  for (int j = tid; j < ef; j += kThreads) {
    bd[j] = row_d[j];
    bi[j] = row_i[j];
    be[j] = row_e[j];
  }
  for (int j = tid; j < (1 << bits); j += kThreads) table[j] = -1;
  if (tid == 0) s_valid = s_kept = s_beam = s_surv = s_unsettled = 0;
  __syncthreads();

  // frontier: the first E unexpanded slots, in beam order (warp 0)
  if (warp == 0) {
    int cnt = 0;
    for (int j0 = 0; j0 < ef && cnt < E; j0 += 32) {
      const int j = j0 + lane;
      const bool un = j < ef && be[j] == 0;
      const uint32_t m = __ballot_sync(kFull, un);
      const int rank = cnt + __popc(m & below_lane);
      if (un && rank < E) {
        fid[rank] = bi[j];
        be[j] = 1;
      }
      cnt += __popc(m);
    }
    if (lane == 0) s_active = min(cnt, E);
  }
  // the beam's real ids (they lead the row; pads trail) into the table
  for (int j = tid; j < ef; j += kThreads) {
    if (bi[j] >= 0) {
      table_insert(table, bits, bi[j]);
      atomicAdd(&s_beam, 1);
    }
  }
  __syncthreads();

  // the frontier's lists; keep each new id once
  const int n_act = s_active;
  int valid = 0;
  for (int k = tid; k < L; k += kThreads) {
    const int f = k / W;
    const int32_t id = f < n_act ? __ldg(neighbors0 + int64_t(fid[f]) * W + (k - f * W)) : -1;
    if (id >= 0) {
      ++valid;
      if (table_insert(table, bits, id)) cid[atomicAdd(&s_kept, 1)] = id;
    }
  }
  valid = __reduce_add_sync(kFull, valid);
  if (lane == 0 && valid) atomicAdd(&s_valid, valid);
  __syncthreads();

  // score the kept rows; a row whose key is past the beam's last entry
  // cannot place (ef beam entries lie below it) and is dropped here
  const int n_kept = s_kept;
  const int n_beam = s_beam;
  const int64_t worst =
      n_beam == ef ? entry_key(bd[ef - 1], bi[ef - 1]) : INT64_MAX;
  {
    const RowScorer<T, VEC, QUANT> sc{vectors, q_s, row_scl, row_nrm, d, lanes, l2, bias[b]};
    const int slots = 32 / lanes;
    const int slot = lane / lanes;
    const int per_pass = slots * kUnroll;
    for (int base = warp * per_pass; base < n_kept; base += kWarps * per_pass) {
      int32_t rid[kUnroll];
      float dist[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * slots + slot;
        const int32_t id = c < n_kept ? cid[c] : -1;
        rid[u] = id < n_rows ? id : -1;
        dist[u] = __int_as_float(0x7fffffff);  // NaN: an id past the table
      }
      sc.score(rid, dist);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * slots + slot;
        const bool writer = (lane & (lanes - 1)) == 0 && c < n_kept;
        const int64_t key = writer ? entry_key(dist[u], cid[c]) : 0;
        const bool keep = writer && key < worst;
        const uint32_t m = __ballot_sync(kFull, keep);
        int at = 0;
        if (lane == 0 && m) at = atomicAdd(&s_surv, __popc(m));
        at = __shfl_sync(kFull, at, 0) + __popc(m & below_lane);
        if (keep) {
          sk[at] = key;
          cd[at] = dist[u];
        }
      }
    }
  }
  __syncthreads();

  // merge: an entry's place is the count of real entries with a smaller key
  const int n_surv = s_surv;
  const int n_all = n_beam + n_surv;
  for (int x = tid; x < n_all; x += kThreads) {
    const bool from_beam = x < n_beam;
    const float dx = from_beam ? bd[x] : cd[x - n_beam];
    const int64_t kx = from_beam ? entry_key(dx, bi[x]) : sk[x - n_beam];
    const bool ex = from_beam && be[x] != 0;
    int rank = 0;
#pragma unroll 4
    for (int c = 0; c < n_surv; ++c) rank += sk[c] < kx;
    if (from_beam) {
      rank += x;
    } else {  // the beam is sorted: binary search
      int lo = 0, hi = n_beam;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (entry_key(bd[mid], bi[mid]) < kx) lo = mid + 1;
        else hi = mid;
      }
      rank += lo;
    }
    if (rank < ef) {
      row_d[rank] = dx;
      row_i[rank] = int32_t(uint32_t(kx));
      row_e[rank] = ex;
    }
    if (!ex && rank < settle) s_unsettled = 1;
  }
  for (int r = n_all + tid; r < ef; r += kThreads) {
    row_d[r] = __int_as_float(0x7f800000);
    row_i[r] = -1;
    row_e[r] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    hops[b] += n_act;
    counts[b] += s_valid;
    if (s_unsettled) atomicAdd(unsettled + t + 1, 1);
  }
}

template <typename T>
bool vec_rows(const void* vectors, int d) {
  return (size_t(d) * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
}

template <typename T, bool QUANT>
void launch_gather(const void* vectors, const float* q_ext, const float* bias,
                   const int32_t* ids, const float* row_scl, const float* row_nrm, float* out,
                   int64_t n_rows, int B, int K, int d, bool l2, cudaStream_t stream) {
  const size_t smem = size_t(d) * sizeof(float);
  const bool vec = vec_rows<T>(vectors, d);
  const int lanes = row_lanes<T>(d, vec);
  const T* v = static_cast<const T*>(vectors);
  if (vec)
    gather_score_kernel<T, true, QUANT><<<B, kThreads, smem, stream>>>(
        v, q_ext, bias, ids, row_scl, row_nrm, out, n_rows, K, d, lanes, l2);
  else
    gather_score_kernel<T, false, QUANT><<<B, kThreads, smem, stream>>>(
        v, q_ext, bias, ids, row_scl, row_nrm, out, n_rows, K, d, lanes, l2);
}

struct StepArgs {
  const float* q_ext;
  const float* bias;
  const float* row_scl;
  const float* row_nrm;
  const int32_t* neighbors0;
  float* beam_d;
  int32_t* beam_i;
  uint8_t* beam_e;
  int32_t* hops;
  int32_t* counts;
  int32_t* unsettled;
  int t;
  int64_t n_rows;
  int B, ef, E, W, d, settle;
  bool l2;
};

template <typename T, bool QUANT>
void launch_step(const void* vectors, const StepArgs& a, cudaStream_t stream) {
  const size_t smem = beam_step_smem(a.ef, a.E, a.W, a.d);
  const int bits = table_bits(a.ef, a.E * a.W);
  const bool vec = vec_rows<T>(vectors, a.d);
  const int lanes = row_lanes<T>(a.d, vec);
  const T* v = static_cast<const T*>(vectors);
  auto kernel = vec ? beam_step_kernel<T, true, QUANT> : beam_step_kernel<T, false, QUANT>;
  kernel<<<a.B, kThreads, smem, stream>>>(
      v, a.q_ext, a.bias, a.row_scl, a.row_nrm, a.neighbors0, a.beam_d, a.beam_i, a.beam_e,
      a.hops, a.counts, a.unsettled, a.t, a.n_rows, a.ef, a.E, a.W, a.d, lanes, a.settle, bits,
      a.l2);
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
    case 0: launch_gather<float, false>(vectors, q, bi, id, scl, nrm, o, n_rows, B, K, d, l2, s); break;
    case 1: launch_gather<uint16_t, false>(vectors, q, bi, id, scl, nrm, o, n_rows, B, K, d, l2, s); break;
    case 2: launch_gather<int8_t, true>(vectors, q, bi, id, scl, nrm, o, n_rows, B, K, d, l2, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// Bytes of shared memory one beam_step CTA takes.
extern "C" int64_t shine_beam_step_smem(int ef, int E, int W, int d) {
  return int64_t(beam_step_smem(ef, E, W, d));
}

// One layer-0 beam step for B queries, in place on the beam (dists f32,
// ids i32, expanded as bytes, each (B, ef)), hops and counts (B,) i32 and
// unsettled (t + 2 or more,) i32; settle is k (term "k") or ef (term "ef").
// Returns the cudaError_t of the launch, cudaErrorInvalidValue past the
// limits.
extern "C" int shine_beam_step(const void* vectors, int row_type, const void* q_ext,
                               const void* bias, const void* row_scl, const void* row_nrm,
                               const void* neighbors0, void* beam_d, void* beam_i,
                               void* beam_e, void* hops, void* counts, void* unsettled, int t,
                               int64_t n_rows, int B, int ef, int E, int W, int d, int settle,
                               int l2, void* stream) {
  if (ef < 1 || ef > kMaxEf || E < 1 || W < 1 || E * W > kMaxLanes || settle < 1 ||
      settle > ef || beam_step_smem(ef, E, W, d) > kMaxSmem)
    return int(cudaErrorInvalidValue);
  const StepArgs a{static_cast<const float*>(q_ext), static_cast<const float*>(bias),
                   static_cast<const float*>(row_scl), static_cast<const float*>(row_nrm),
                   static_cast<const int32_t*>(neighbors0), static_cast<float*>(beam_d),
                   static_cast<int32_t*>(beam_i), static_cast<uint8_t*>(beam_e),
                   static_cast<int32_t*>(hops), static_cast<int32_t*>(counts),
                   static_cast<int32_t*>(unsettled), t, n_rows, B, ef, E, W, d, settle,
                   l2 != 0};
  auto s = static_cast<cudaStream_t>(stream);
  switch (row_type) {
    case 0: launch_step<float, false>(vectors, a, s); break;
    case 1: launch_step<uint16_t, false>(vectors, a, s); break;
    case 2: launch_step<int8_t, true>(vectors, a, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
