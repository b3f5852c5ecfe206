// Width-generic attention for head widths above 512: every multiple of 128
// (640, 768, 1024, 2048, ...), with the width a run-time argument. The
// per-width templates of the other instances run out of room just above
// 512: a combine of one thread a column passes 1,024 threads at 2048, the
// FMA tiles (Smem) pass 48 KB of static shared memory at 1024, and the
// tensor-core tiles hold dh / 2 f32 of O a thread. So the wide instances
// take a head in pieces of DS = 128 columns:
//   * column blocks: the grid gains a dimension over O's columns, DS a
//     block, and a block holds only its slice of O;
//   * every block computes the whole S: S = Q K^T of its row tile is
//     accumulated over dh / DS pieces of Q and K staged through shared
//     memory, then the online softmax runs on it, so every column block of
//     a row holds bitwise the same P, m and l without exchanging anything
//     (the two warps of a 16-row tile at 384 and 512, taken from warps to
//     blocks); the P V product reads only the block's slice of V;
//   * key splits (flash-decoding) combine per column slice
//     (combine_wide_kernel: DS threads a block, whatever dh is);
//   * shared memory and registers do not grow with dh: a decode block
//     holds a 128-key tile's scores (3 KB), an FMA block 16 query rows'
//     pieces, a 32-key K piece and V slice (43 KB), a tensor-core block a
//     ring of three stages of a 64 x DS Q piece and a 32 x DS K piece or
//     V slice (78 KB, 87 KB over int8).
// The cost: Q K^T and the reads of K repeat dh / DS times (8 at 1024),
// across blocks that run side by side; at the served shapes one KV head's
// keys (8 slots x 576 positions x 1024 x 2 B, about 9.4 MB) stay in the
// 50 MB L2 between them. Numerics are the reference's shared step
// (paged_attention.cuh): f32 m, l and acc; NEG_INF masking with p forced to
// 0 at s <= NEG_INF / 2; corr = exp(min(m_prev - m_new, 0)); out = acc /
// max(l, 1e-30); int8 with a per-KV-head f32 scale.
//
// This header holds the FMA bodies (wide_decode_rows: the paged and
// dense decodes, one key a thread; wide_fma_rows: the f32 chunk and
// flash, staged 128-column pieces) and the split combine; the tensor-core
// body of bf16/f16 queries is wide_mma.cuh. Plain FMA and mma.sync; no
// TMA, wgmma or double-buffered FMA staging yet.
#pragma once

#include <type_traits>

#include "paged_attention.cuh"

namespace repro_paged {

constexpr int DS = 128;      // O's columns a block holds; a staged Q / K piece
constexpr int WT = 128;      // threads a wide block (4 warps)
constexpr int WROWS = 16;    // query rows an FMA wide block takes
constexpr int WDR = 4;       // query rows a decode block takes
constexpr int WTK = 32;      // keys an FMA wide tile

// 4 consecutive elements of X (16, 8 or 4 bytes, aligned) as f32: one load
// of a vector register type
template <typename X>
__device__ __forceinline__ void load4(const X* __restrict__ p, float (&f)[4]) {
  if constexpr (sizeof(X) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    using R = typename std::conditional<sizeof(X) == 2, uint2, unsigned>::type;
    const R raw = *reinterpret_cast<const R*>(p);
    const X* e = reinterpret_cast<const X*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = to_f32(e[i]);
  }
}

// An FMA wide block's shared memory (43.6 KB at any head width)
struct WideFma {
  float q[WROWS * DS];           // a Q piece of the row tile
  float k[WTK * (DS + 1)];       // a K piece, rows padded: conflict-free dots
  float v[WTK * DS];             // the block's V slice
  float p[WROWS * WTK];          // scores, then probabilities
  float m[WROWS], l[WROWS], corr[WROWS];
  long long row[WTK];            // the tile's keys as K/V rows (-1: none)
};
static_assert(sizeof(WideFma) <= 48 * 1024, "within static shared memory");

// Rows [r0, r0 + nrows) (nrows <= WROWS) of sequence b's query block for kv
// head h, O's columns [cb * DS, cb * DS + DS). Row gr (in (position,
// head-in-group) order) is position gr / group of the chunk and query head
// h * group + gr % group of q, out (B, C, H, dh); it attends keys [lo,
// min(start + gr / group + 1, n_valid, hi)), whose K/V rows rows_at gives
// (PagedRows, DenseRows: paged_attention.cuh). K and V are staged as f32
// times their int8 scales. part_acc == nullptr: write the rows' output;
// else split si's partials of n_split (m natural-log, acc (rows, n_split,
// dh), m and l written by column block 0).
template <typename T, typename KV, typename Rows>
__device__ void wide_fma_rows(const T* __restrict__ q, const KV* __restrict__ kp,
                              const KV* __restrict__ vp, const Rows& rows_at,
                              const float* __restrict__ ksc_p, const float* __restrict__ vsc_p,
                              T* __restrict__ out, float* __restrict__ part_acc,
                              float* __restrict__ part_m, float* __restrict__ part_l, int si,
                              int n_split, int b, int h, int cb, int r0, int nrows, int C, int H,
                              int Hkv, int dh, int start, int n_valid, int lo, int hi,
                              float scale) {
  constexpr int SPT = WROWS * WTK / WT;   // scores a thread
  __shared__ WideFma sm;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = cb * DS;
  const bool direct = part_acc == nullptr;
  auto orow = [&](int r) {
    const int gr = r0 + r;
    return (static_cast<size_t>(b) * C + gr / group) * H + h * group + gr % group;
  };
  auto lim = [&](int r) { return min(min(start + (r0 + r) / group + 1, n_valid), hi); };

  if (lo >= hi) {   // no row sees a key of [lo, hi): read nothing
    for (int i = tid; i < nrows * DS; i += WT) {
      const size_t o = orow(i / DS);
      const int d = c0 + i % DS;
      if (direct) {
        out[o * dh + d] = from_f32<T>(0.f);
      } else {
        part_acc[(o * n_split + si) * dh + d] = 0.f;
        if (cb == 0 && i % DS == 0) {
          part_m[o * n_split + si] = NEG_INF;
          part_l[o * n_split + si] = 0.f;
        }
      }
    }
    return;
  }
  const float ksc = ksc_p ? ksc_p[h] : 1.f;
  const float vsc = vsc_p ? vsc_p[h] : 1.f;
  if (tid < WROWS) {
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  float acc[WROWS];   // column c0 + tid of each row
#pragma unroll
  for (int r = 0; r < WROWS; ++r) acc[r] = 0.f;
  const size_t kv_stride = static_cast<size_t>(Hkv) * dh;   // between K/V rows
  const int n_pc = dh / DS;

  for (int base = lo; base < hi; base += WTK) {
    if (tid < WTK) sm.row[tid] = base + tid < hi ? rows_at(base + tid) : -1;
    float sacc[SPT];
#pragma unroll
    for (int a = 0; a < SPT; ++a) sacc[a] = 0.f;
    // S = Q K^T over the pieces, summed in column order
    for (int pc = 0; pc < n_pc; ++pc) {
      __syncthreads();   // the tile's rows visible; the last piece's dots done
      for (int i = tid; i < WROWS * DS; i += WT) {
        const int r = i / DS, d = i % DS;
        sm.q[i] = r < nrows ? to_f32(q[orow(r) * dh + pc * DS + d]) : 0.f;
      }
      for (int i = tid; i < WTK * DS / 4; i += WT) {
        const int j = i / (DS / 4), c = (i % (DS / 4)) * 4;
        const long long row = sm.row[j];
        float kf[4] = {0.f, 0.f, 0.f, 0.f};
        if (row >= 0) load4(kp + (row * Hkv + h) * dh + pc * DS + c, kf);
#pragma unroll
        for (int e = 0; e < 4; ++e) sm.k[j * (DS + 1) + c + e] = kf[e] * ksc;
      }
      __syncthreads();
      // one (row, key) dot a step; keys vary fastest across lanes
#pragma unroll
      for (int a = 0; a < SPT; ++a) {
        const int i = tid + a * WT;
        const int r = i / WTK, j = i % WTK;
        if (r < nrows) {
          const float* qr = sm.q + r * DS;
          const float* kr = sm.k + j * (DS + 1);
          float dot = sacc[a];
#pragma unroll 16
          for (int d = 0; d < DS; ++d) dot = fmaf(qr[d], kr[d], dot);
          sacc[a] = dot;
        }
      }
    }
    // the scores, masked at each row's limit; the block's V slice
#pragma unroll
    for (int a = 0; a < SPT; ++a) {
      const int i = tid + a * WT;
      const int r = i / WTK, j = i % WTK;
      sm.p[i] = r < nrows && base + j < lim(r) ? sacc[a] * scale : NEG_INF;
    }
    for (int i = tid; i < WTK * DS / 4; i += WT) {
      const int j = i / (DS / 4), c = (i % (DS / 4)) * 4;
      const long long row = sm.row[j];
      float vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (row >= 0) load4(vp + (row * Hkv + h) * dh + c0 + c, vf);
#pragma unroll
      for (int e = 0; e < 4; ++e) sm.v[j * DS + c + e] = vf[e] * vsc;
    }
    __syncthreads();

    // online softmax: one warp a row, one key a lane
    for (int r = warp; r < nrows; r += WT / 32) {
      float* pr = sm.p + r * WTK;
      const float s = pr[lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float e = s <= NEG_INF / 2 ? 0.f : expf(s - m_new);
      pr[lane] = e;
      float sum = e;
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

    // acc = acc * corr + p @ v, column c0 + tid; the next tile's first
    // barrier comes before anything read here is written again
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      if (r < nrows) {
        const float* pr = sm.p + r * WTK;
        float u = 0.f;
#pragma unroll 8
        for (int j = 0; j < WTK; ++j) u = fmaf(pr[j], sm.v[j * DS + tid], u);
        acc[r] = acc[r] * sm.corr[r] + u;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    if (r < nrows) {
      const size_t o = orow(r);
      if (direct) {
        out[o * dh + c0 + tid] = from_f32<T>(acc[r] / fmaxf(sm.l[r], 1e-30f));
      } else {
        part_acc[(o * n_split + si) * dh + c0 + tid] = acc[r];
        if (cb == 0 && tid == 0) {
          part_m[o * n_split + si] = sm.m[r];
          part_l[o * n_split + si] = sm.l[r];
        }
      }
    }
  }
}

// The decodes' body (one query position, the GQA group's rows): a block
// takes up to WDR = 4 of the group's query rows and WT = 128 keys a tile,
// 32 a warp. A warp reads a key's whole row straight from the pool or
// cache (4 elements a lane a 128-column piece: coalesced; int8 times its
// scale), eight keys at a time, dots it with every query row of the tile
// (q read through L1) and sums across its lanes, so S costs no barrier
// and no staging per piece; the online softmax runs one warp a row over
// the tile's scores in shared memory; then each thread adds P times its
// column of the block's V slice (a coalesced row of 128 a key), eight
// keys' loads in flight. 3 KB of shared memory at any width.
struct WideDec {
  float p[WDR * WT];             // scores, then probabilities
  float m[WDR], l[WDR], corr[WDR];
  long long row[WT];             // the tile's keys as K/V rows (-1: none)
};

// Rows [r0, r0 + nrows) (nrows <= WDR) of the group of query position b
// (q, out: (B, H, dh); row r is query head h * group + r0 + r) against
// keys [lo, hi), O's columns [cb * DS, cb * DS + DS); outputs and
// partials as wide_fma_rows writes them. q 16-byte aligned.
template <typename T, typename KV, typename Rows>
__device__ void wide_decode_rows(const T* __restrict__ q, const KV* __restrict__ kp,
                                 const KV* __restrict__ vp, const Rows& rows_at,
                                 const float* __restrict__ ksc_p,
                                 const float* __restrict__ vsc_p, T* __restrict__ out,
                                 float* __restrict__ part_acc, float* __restrict__ part_m,
                                 float* __restrict__ part_l, int si, int n_split, int b, int h,
                                 int cb, int r0, int nrows, int H, int Hkv, int dh, int lo,
                                 int hi, float scale) {
  constexpr int WU = 8;   // keys a warp reads at a time
  __shared__ WideDec sm;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = cb * DS;
  const bool direct = part_acc == nullptr;
  const size_t row0 = static_cast<size_t>(b) * H + h * group + r0;   // of out / partials

  if (lo >= hi) {   // wholly past the valid keys: read nothing
    for (int i = tid; i < nrows * DS; i += WT) {
      const size_t o = row0 + i / DS;
      const int d = c0 + i % DS;
      if (direct) {
        out[o * dh + d] = from_f32<T>(0.f);
      } else {
        part_acc[(o * n_split + si) * dh + d] = 0.f;
        if (cb == 0 && i % DS == 0) {
          part_m[o * n_split + si] = NEG_INF;
          part_l[o * n_split + si] = 0.f;
        }
      }
    }
    return;
  }
  const float ksc = ksc_p ? ksc_p[h] : 1.f;
  const float vsc = vsc_p ? vsc_p[h] : 1.f;
  if (tid < WDR) {
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  float acc[WDR];   // column c0 + tid of each row
#pragma unroll
  for (int r = 0; r < WDR; ++r) acc[r] = 0.f;
  const T* qb = q + row0 * dh;

  for (int base = lo; base < hi; base += WT) {
    // the tile's keys as K/V rows
    sm.row[tid] = base + tid < hi ? rows_at(base + tid) : -1;
    __syncthreads();
    // S: a warp takes 32 of the tile's keys, WU at a time; a key's row is
    // read by the whole warp, 4 elements a lane a 128-column piece
    // (coalesced), dotted with the lane's elements of every query row (q
    // through L1) and summed across the lanes in a fixed order
    for (int j0 = warp * 32; j0 < warp * 32 + 32; j0 += WU) {
      long long rw[WU];
#pragma unroll
      for (int u = 0; u < WU; ++u) rw[u] = sm.row[j0 + u];
      float dot[WU][WDR];
#pragma unroll
      for (int u = 0; u < WU; ++u)
#pragma unroll
        for (int r = 0; r < WDR; ++r) dot[u][r] = 0.f;
      if (base + j0 < hi) {   // warp-uniform: some key of the batch is live
#pragma unroll 2
        for (int d = lane * 4; d < dh; d += DS) {
          float kf[WU][4];
#pragma unroll
          for (int u = 0; u < WU; ++u) {
#pragma unroll
            for (int i = 0; i < 4; ++i) kf[u][i] = 0.f;
            if (rw[u] >= 0) load4(kp + (rw[u] * Hkv + h) * dh + d, kf[u]);
#pragma unroll
            for (int i = 0; i < 4; ++i) kf[u][i] *= ksc;
          }
#pragma unroll
          for (int r = 0; r < WDR; ++r) {
            if (r < nrows) {
              float qf[4];
              load4(qb + r * dh + d, qf);
#pragma unroll
              for (int u = 0; u < WU; ++u)
#pragma unroll
                for (int i = 0; i < 4; ++i) dot[u][r] = fmaf(qf[i], kf[u][i], dot[u][r]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < WU; ++u)
#pragma unroll
        for (int r = 0; r < WDR; ++r) {
          if (r < nrows) {
            float x = dot[u][r];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
            dot[u][r] = x;
          }
        }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < WU; ++u)
#pragma unroll
          for (int r = 0; r < WDR; ++r)
            if (r < nrows) sm.p[r * WT + j0 + u] = rw[u] >= 0 ? dot[u][r] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: one warp a row, four keys a lane
    for (int r = warp; r < nrows; r += WT / 32) {
      float* pr = sm.p + r * WT;
      float x[WT / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < WT / 32; ++i) {
        x[i] = pr[lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < WT / 32; ++i) {
        const float e = x[i] <= NEG_INF / 2 ? 0.f : expf(x[i] - m_new);
        pr[lane + 32 * i] = e;
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

    // acc = acc * corr + p @ v, column c0 + tid
    const int nk = min(WT, hi - base);
    float u[WDR];
#pragma unroll
    for (int r = 0; r < WDR; ++r) u[r] = 0.f;
#pragma unroll 8
    for (int j = 0; j < nk; ++j) {
      const float v = to_f32(vp[(sm.row[j] * Hkv + h) * dh + c0 + tid]) * vsc;
#pragma unroll
      for (int r = 0; r < WDR; ++r)
        if (r < nrows) u[r] = fmaf(sm.p[r * WT + j], v, u[r]);
    }
#pragma unroll
    for (int r = 0; r < WDR; ++r)
      if (r < nrows) acc[r] = acc[r] * sm.corr[r] + u[r];
    __syncthreads();   // every thread done with the tile's rows and p
  }

#pragma unroll
  for (int r = 0; r < WDR; ++r) {
    if (r < nrows) {
      const size_t o = row0 + r;
      if (direct) {
        out[o * dh + c0 + tid] = from_f32<T>(acc[r] / fmaxf(sm.l[r], 1e-30f));
      } else {
        part_acc[(o * n_split + si) * dh + c0 + tid] = acc[r];
        if (cb == 0 && tid == 0) {
          part_m[o * n_split + si] = sm.m[r];
          part_l[o * n_split + si] = sm.l[r];
        }
      }
    }
  }
}

// Pass 2 of the wide splits: a block of DS threads per (query row, column
// block); splits combined in index order, as split_combine_kernel does.
template <typename T>
__global__ void __launch_bounds__(DS)
combine_wide_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                    const float* __restrict__ part_l, T* __restrict__ out, int n_split, int dh) {
  const size_t row = blockIdx.x;
  const int d = blockIdx.y * DS + threadIdx.x;
  const float* m = part_m + row * n_split;
  const float* l = part_l + row * n_split;
  const float* acc = part_acc + row * n_split * dh + d;
  float M = NEG_INF;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, m[i]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float mi = m[i];
    const float w = mi <= NEG_INF / 2 ? 0.f : expf(fminf(mi - M, 0.f));
    num += w * acc[static_cast<size_t>(i) * dh];
    den += w * l[i];
  }
  out[row * dh + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

// The partials of n_rows query rows at n_split splits in part (acc, then m,
// then l: B * H * n_split * (dh + 2) f32), and their combine into out.
struct WideParts {
  float* acc;
  float* m;
  float* l;
  WideParts(void* part, size_t n_rows, int n_split, int dh)
      : acc(static_cast<float*>(part)),
        m(acc ? acc + n_rows * n_split * dh : nullptr),
        l(acc ? m + n_rows * n_split : nullptr) {}
  template <typename T>
  void combine(void* out, size_t n_rows, int n_split, int dh, cudaStream_t stream) const {
    // a refused first pass stays the last error; the entry reports it
    if (!acc || cudaPeekAtLastError() != cudaSuccess) return;
    combine_wide_kernel<T><<<dim3(static_cast<unsigned>(n_rows), dh / DS), DS, 0, stream>>>(
        acc, m, l, static_cast<T*>(out), n_split, dh);
  }
};

}  // namespace repro_paged
