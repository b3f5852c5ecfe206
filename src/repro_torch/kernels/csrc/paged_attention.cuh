// Shared body of the port's FMA attention paths (the chunk kernel's and
// flash attention's f32 bodies; the dense decode's split pass stages with
// it): a tile of query rows of one (sequence, kv head) against the
// sequence's keys, with an online softmax. The paged decode kernel has a
// body of its own (paged_decode_attention.cu) and takes only the numerics,
// types and dtype codes below. Where a key position's K/V row lives is a
// policy (PagedRows: through the sequence's page table; DenseRows: a dense
// per-sequence cache).
//
// Numerics follow the reference kernels' shared step
// (repro/kernels/decode_attention.py, _online_softmax_step/_finalize):
//   s = (q . k) * scale in f32, s = NEG_INF where kpos >= valid(row);
//   m_new = max(m_prev, max_j s); p = 0 where s <= NEG_INF/2,
//   else exp(s - m_new); corr = exp(min(m_prev - m_new, 0));
//   l = l * corr + sum_j p; acc = acc * corr + p @ v;
//   out = acc / max(l, 1e-30), written in the query's dtype.
// int8 K/V are multiplied by their per-kv-head f32 scale as they are staged.
//
// Design (every KV byte is read once per row tile and reused across the
// tile's rows from shared memory; measured latency bound on the H100, by
// the serial tile walk, not by bandwidth):
//   * one thread block of NT threads per (sequence, kv head, row tile) of
//     FmaRows<DH> rows (16; 8 at head widths 256 and 384, 4 at 512);
//   * the keys are walked in tiles of TK = 4096 / DH positions (10 at
//     head width 384: no loop here takes TK to be a power of two), which
//     may span several pages: with PagedRows each staged vector reads its own
//     page id from the page table (there is no scalar prefetch) and the id
//     is clamped to the null page 0 when it is out of [0, n_pages);
//   * K and V tiles are staged in shared memory as f32 with 16-byte loads;
//     key positions past the tile's last attendable position (or past the
//     page table or the dense cache) are zero-filled and never read from
//     device memory;
//   * scores and probabilities live in shared memory, the running max and
//     sum in shared memory, the output accumulator in registers.
// Plain FMA arithmetic; no tensor cores, TMA or split-K yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_paged {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;        // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MAX_ROWS = 16;   // query rows per block (row tile)

// dtype codes shared with the Python wrapper
enum DType { F32 = 0, BF16 = 1, F16 = 2, I8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// Key position kpos of the block's sequence in the paged pool: row
// pid * ps + kpos % ps of the (n_pages * ps, Hkv, DH) view, pid read from
// the sequence's page-table row and clamped to the null page 0 when it is
// out of [0, n_pages); -1 past the page table.
struct PagedRows {
  const int* pt_row;
  int n_pp, n_pages, ps;
  __device__ __forceinline__ long long operator()(int kpos) const {
    const int pi = kpos / ps;
    if (pi >= n_pp) return -1;
    int pid = pt_row[pi];
    if (pid < 0 || pid >= n_pages) pid = 0;    // never leave the pool
    return static_cast<long long>(pid) * ps + kpos % ps;
  }
};

// Key position kpos of sequence b in a dense (B, L, Hkv, DH) cache: row
// b * L + kpos of the (B * L, Hkv, DH) view (base = b * L); -1 at or past L.
struct DenseRows {
  long long base;
  int L;
  __device__ __forceinline__ long long operator()(int kpos) const {
    return kpos < L ? base + kpos : -1;
  }
};

template <int DH>
struct Tile {
  static constexpr int TK = 4096 / DH;   // key positions per staged tile
  static constexpr int KSTRIDE = DH + 1; // padded K row: conflict-free dots
};

// Query rows an FMA block takes at a time: MAX_ROWS, 8 at head widths 256
// and 384 and 4 at 512, where more f32 rows beside a K and a V tile (Smem)
// would pass the 48 KB of static shared memory: 16 rows at 256 take 50.4
// KB, 8 take 41.6; at 384 8 rows take 42.4 KB; at 512 8 take 48.4, 4
// take 40.2. The accumulator stays at 16 to 24 f32 a thread. The grids
// that launch attend_rows divide their rows by it. Past 512 the tiles
// would keep shrinking (at 1024 4 rows take 49.3 KB), so every wider
// multiple of 128 runs the width-generic bodies of wide_tile.cuh, whose
// shared memory does not grow with the width.
template <int DH>
struct FmaRows {
  static constexpr int value = DH >= 512 ? 4 : DH >= 256 ? 8 : MAX_ROWS;
};

// ROWS query rows against a K and a V tile.
template <int DH, int ROWS>
struct Smem {
  float k[Tile<DH>::TK * Tile<DH>::KSTRIDE];
  float v[Tile<DH>::TK * DH];
  float q[ROWS * DH];
  float p[ROWS * Tile<DH>::TK];
  float m[ROWS];
  float l[ROWS];
  float corr[ROWS];
};
static_assert(sizeof(Smem<64, FmaRows<64>::value>) <= 48 * 1024 &&
                  sizeof(Smem<128, FmaRows<128>::value>) <= 48 * 1024 &&
                  sizeof(Smem<256, FmaRows<256>::value>) <= 48 * 1024 &&
                  sizeof(Smem<384, FmaRows<384>::value>) <= 48 * 1024 &&
                  sizeof(Smem<512, FmaRows<512>::value>) <= 48 * 1024,
              "an FMA block's tiles fit the 48 KB of static shared memory");
static_assert(FmaRows<384>::value * 384 % NT == 0 && FmaRows<512>::value * 512 % NT == 0,
              "an FMA block's accumulator is whole elements a thread");

// Stage key positions [base, base + TK) of kv head h into shared memory as
// f32 (scaled when int8). Positions >= limit, or that rows_at places
// outside the storage, are zero-filled. 16-byte vector loads: VEC elements
// of KV each.
template <typename KV, int DH, typename Rows, int ROWS>
__device__ __forceinline__ void stage_kv(Smem<DH, ROWS>& sm, const KV* __restrict__ kp,
                                         const KV* __restrict__ vp, const Rows& rows_at,
                                         int Hkv, int h, int base, int limit, float ksc,
                                         float vsc) {
  constexpr int TK = Tile<DH>::TK;
  constexpr int KS = Tile<DH>::KSTRIDE;
  constexpr int VEC = 16 / sizeof(KV);
  constexpr int VPR = DH / VEC;          // vectors per key row
  for (int i = threadIdx.x; i < TK * VPR; i += NT) {
    const int j = i / VPR;
    const int c = (i % VPR) * VEC;
    const int kpos = base + j;
    const long long row = kpos < limit ? rows_at(kpos) : -1;
    float kf[VEC], vf[VEC];
    if (row >= 0) {
      const size_t off = (static_cast<size_t>(row) * Hkv + h) * DH + c;
      const uint4 kr = *reinterpret_cast<const uint4*>(kp + off);
      const uint4 vr = *reinterpret_cast<const uint4*>(vp + off);
      const KV* ke = reinterpret_cast<const KV*>(&kr);
      const KV* ve = reinterpret_cast<const KV*>(&vr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kf[e] = to_f32(ke[e]) * ksc;
        vf[e] = to_f32(ve[e]) * vsc;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sm.k[j * KS + c + e] = kf[e];
      sm.v[j * DH + c + e] = vf[e];
    }
  }
}

// Attend rows [r0, r0 + nrows) (nrows <= FmaRows<DH>) of sequence b's
// query block for kv head h.
// Row r (in (position, head-in-group) order) is position c = r / group of
// the chunk and query head h * group + r % group; it may attend key
// positions < min(start + c + 1, n_valid). q/out: (B, C, H, DH); rows_at
// maps sequence b's key positions to K/V rows (PagedRows, DenseRows).
template <typename T, typename KV, int DH, typename Rows>
__device__ void attend_rows(const T* __restrict__ q, const KV* __restrict__ kp,
                            const KV* __restrict__ vp, const Rows& rows_at,
                            const float* __restrict__ ksc_p, const float* __restrict__ vsc_p,
                            T* __restrict__ out, int b, int h, int r0, int nrows, int C,
                            int H, int Hkv, int start, int n_valid, float scale) {
  constexpr int TK = Tile<DH>::TK;
  constexpr int KS = Tile<DH>::KSTRIDE;
  constexpr int ROWS = FmaRows<DH>::value;
  constexpr int APT = ROWS * DH / NT;       // accumulator elements per thread
  __shared__ Smem<DH, ROWS> sm;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float ksc = ksc_p ? ksc_p[h] : 1.f;
  const float vsc = vsc_p ? vsc_p[h] : 1.f;

  // query rows to shared memory (f32); row state init
  for (int i = tid; i < nrows * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int gr = r0 + r;
    const int c = gr / group, hq = h * group + gr % group;
    sm.q[i] = to_f32(q[((static_cast<size_t>(b) * C + c) * H + hq) * DH + d]);
  }
  if (tid < ROWS) {
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  float acc[APT];
#pragma unroll
  for (int a = 0; a < APT; ++a) acc[a] = 0.f;

  // the last row of the tile sees the most keys; no row sees past n_valid
  const int limit = min(start + (r0 + nrows - 1) / group + 1, n_valid);
  __syncthreads();

  for (int base = 0; base < limit; base += TK) {
    stage_kv<KV, DH>(sm, kp, vp, rows_at, Hkv, h, base, limit, ksc, vsc);
    __syncthreads();

    // scores: one (row, key) dot per step; keys vary fastest across lanes
    for (int i = tid; i < nrows * TK; i += NT) {
      const int r = i / TK, j = i % TK;
      const int valid = min(start + (r0 + r) / group + 1, n_valid);
      float s = NEG_INF;
      if (base + j < valid) {
        const float* qr = sm.q + r * DH;
        const float* kr = sm.k + j * KS;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      sm.p[r * TK + j] = s;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < nrows; r += NWARPS) {
      float* pr = sm.p + r * TK;
      float mx = NEG_INF;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float s = pr[j];
        const float e = (s <= NEG_INF / 2) ? 0.f : expf(s - m_new);
        pr[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(fminf(m_prev - m_new, 0.f));
        sm.corr[r] = corr;
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * corr + sum;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v over this tile
#pragma unroll
    for (int a = 0; a < APT; ++a) {
      const int i = tid + a * NT;
      const int r = i / DH, d = i % DH;
      if (r < nrows) {
        const float* pr = sm.p + r * TK;
        float u = 0.f;
#pragma unroll 8
        for (int j = 0; j < TK; ++j) u = fmaf(pr[j], sm.v[j * DH + d], u);
        acc[a] = acc[a] * sm.corr[r] + u;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < APT; ++a) {
    const int i = tid + a * NT;
    const int r = i / DH, d = i % DH;
    if (r < nrows) {
      const int gr = r0 + r;
      const int c = gr / group, hq = h * group + gr % group;
      const float l = fmaxf(sm.l[r], 1e-30f);
      out[((static_cast<size_t>(b) * C + c) * H + hq) * DH + d] = from_f32<T>(acc[a] / l);
    }
  }
}

}  // namespace repro_paged
