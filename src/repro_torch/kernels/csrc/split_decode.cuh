// Split-K (flash-decoding) attention of one query position per sequence
// against its keys, in two passes, over a key-row policy (DenseRows for a
// dense cache). The chunk kernel and the paged decode kernel write the
// same partials from their own pass-1 bodies and share pass 2.
//
// Pass 1 (split_partial): one block per (split, kv head, sequence) takes
// the GQA group's rows against keys [lo, hi) of its split, where the
// splits cut the cache into pieces of `split` keys and hi is clipped to the
// sequence's valid length. It stages each K/V element of the range once
// with the shared row-tile body's stage_kv (16-byte loads, int8
// dequantized by its kv head's scale), runs the reference's online softmax
// over the range (paged_attention.cuh) in f32 and writes each row's
// partial max m, sum l and unnormalised accumulator acc. A split that lies
// wholly past the valid length reads no key and writes m = NEG_INF, l = 0,
// acc = 0.
//
// Pass 2 (split_combine_kernel): per query row, in split order,
//   M = max_i m_i; w_i = 0 where m_i <= NEG_INF/2, else
//   exp(min(m_i - M, 0)); out = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30)
// in the query's dtype. No atomics: the result is bitwise repeatable.
//
// Partials: m and l (B, H, n_split) f32, acc (B, H, n_split, DH) f32, in
// scratch the caller allocates.
#pragma once

#include "paged_attention.cuh"

namespace repro_paged {

// Pass 1 for sequence b, kv head h, split `split` of n_split: the group's
// query rows (query heads h * group + r of q (B, H, DH)) against keys
// [lo, hi). Rows are taken FmaRows<DH> at a time (paged_attention.cuh).
template <typename T, typename KV, int DH, typename Rows>
__device__ void split_partial(const T* __restrict__ q, const KV* __restrict__ kp,
                              const KV* __restrict__ vp, const Rows& rows_at,
                              const float* __restrict__ ksc_p, const float* __restrict__ vsc_p,
                              float* __restrict__ part_acc, float* __restrict__ part_m,
                              float* __restrict__ part_l, int b, int h, int split, int n_split,
                              int H, int Hkv, int lo, int hi, float scale) {
  constexpr int TK = Tile<DH>::TK;
  constexpr int KS = Tile<DH>::KSTRIDE;
  constexpr int ROWS = FmaRows<DH>::value;
  constexpr int APT = ROWS * DH / NT;       // accumulator elements per thread
  __shared__ Smem<DH, ROWS> sm;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // partial row of query head hq
  auto prow = [&](int hq) {
    return (static_cast<size_t>(b) * H + hq) * n_split + split;
  };

  if (lo >= hi) {   // wholly past the valid length: read nothing
    for (int i = tid; i < group * DH; i += NT) {
      const int hq = h * group + i / DH;
      part_acc[prow(hq) * DH + i % DH] = 0.f;
      if (i % DH == 0) {
        part_m[prow(hq)] = NEG_INF;
        part_l[prow(hq)] = 0.f;
      }
    }
    return;
  }
  const float ksc = ksc_p ? ksc_p[h] : 1.f;
  const float vsc = vsc_p ? vsc_p[h] : 1.f;

  for (int r0 = 0; r0 < group; r0 += ROWS) {
    const int nrows = min(ROWS, group - r0);
    for (int i = tid; i < nrows * DH; i += NT)
      sm.q[i] = to_f32(q[(static_cast<size_t>(b) * H + h * group + r0 + i / DH) * DH + i % DH]);
    if (tid < ROWS) {
      sm.m[tid] = NEG_INF;
      sm.l[tid] = 0.f;
    }
    float acc[APT];
#pragma unroll
    for (int a = 0; a < APT; ++a) acc[a] = 0.f;

    for (int base = lo; base < hi; base += TK) {
      stage_kv<KV, DH>(sm, kp, vp, rows_at, Hkv, h, base, hi, ksc, vsc);
      __syncthreads();

      // scores: one (row, key) dot per step; keys vary fastest across lanes
      for (int i = tid; i < nrows * TK; i += NT) {
        const int r = i / TK, j = i % TK;
        float s = NEG_INF;
        if (base + j < hi) {
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

      // online softmax over the split's tiles: one warp per row
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
      if (r < nrows) part_acc[prow(h * group + r0 + r) * DH + d] = acc[a];
    }
    if (tid < nrows) {
      part_m[prow(h * group + r0 + tid)] = sm.m[tid];
      part_l[prow(h * group + r0 + tid)] = sm.l[tid];
    }
  }
}

// Pass 2: one block of DH threads per query row (b * H + hq); splits
// combined in index order.
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
split_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                     const float* __restrict__ part_l, T* __restrict__ out, int n_split) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = part_m + row * n_split;
  const float* l = part_l + row * n_split;
  const float* acc = part_acc + row * n_split * DH + d;
  float M = NEG_INF;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, m[i]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float mi = m[i];
    const float w = mi <= NEG_INF / 2 ? 0.f : expf(fminf(mi - M, 0.f));
    num += w * acc[static_cast<size_t>(i) * DH];
    den += w * l[i];
  }
  out[row * DH + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

}  // namespace repro_paged
