// The tensor-core body of the width-generic instances (wide_tile.cuh's
// design): bf16/f16 queries over keys of their own type or int8, for the
// chunk kernel (chunk prefill and spec verify) and flash attention at head
// widths above 512.
//
// A block of 4 warps takes a tile of BM = 64 query rows (16 a warp) of one
// (sequence, kv head) and one column block of O (DS = 128 columns). Keys
// come BN = 32 a tile; a tile is dh / DS + 1 steps: dh / DS steps each
// stage a Q piece (64 x DS) and a K piece (32 x DS) and add their product
// to the warp's S (mma.sync.m16n8k16, f32 accumulate), then one step
// stages the block's V slice (32 x DS), runs the online softmax on S in
// the log2 domain and adds P V to O (P rounded to the query dtype, V
// through ldmatrix.trans), as flash_attention.cu's tiles do. The steps go
// through a ring of three cp.async stages (26 KB each: rows padded by 16
// bytes, so every ldmatrix is free of bank conflicts), the next two
// steps' copies in flight while this one computes: one barrier a step.
// int8 K/V pieces are converted to the query type in shared memory
// (exact), the k scale joining the score multiplier and the v scale the
// output, as in the chunk kernel's tiles. O is DS / 2 = 64 f32 a thread
// at any width.
#pragma once

#include "mma_tile.cuh"
#include "wide_tile.cuh"

namespace repro_paged {
namespace wide_tc {

constexpr int BM = 64;                     // query rows a block: 16 a warp
constexpr int BN = 32;                     // keys a tile
constexpr int LD = DS + 8;                 // padded row of a staged piece, elements
constexpr int STAGES = 3;                  // the ring of steps in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory of a block, past whatever the caller keeps before
// it: STAGES stages of (Q piece, K piece or V slice), and (int8) the step's
// K piece or V slice converted to T.
template <typename KV>
struct Layout {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int Q_BYTES = BM * LD * 2;
  static constexpr int KV_BYTES = BN * LD * 2;   // a T piece; an int8 one fits
  static constexpr int STAGE = Q_BYTES + KV_BYTES;
  static constexpr int CVT = QUANT ? BN * LD * 2 : 0;
  static constexpr int BYTES = STAGES * STAGE + CVT;
  static_assert(Q_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte aligned regions");
};

// Rows [r0, r0 + nrows) (nrows <= BM) of sequence b's query block for kv
// head h, O's columns [cb * DS, cb * DS + DS), as wide_fma_rows takes them
// (row gr attends keys [lo, min(start + gr / group + 1, n_valid, hi))), K/V
// row of key kpos: row_of(kpos), called for keys in [lo, hi) only.
// Partials as wide_fma_rows writes them, m in the natural-log domain.
template <typename T, typename KV, typename RowOf>
__device__ void wide_mma_rows(const T* __restrict__ q, const KV* __restrict__ kp,
                              const KV* __restrict__ vp, const RowOf& row_of,
                              const float* __restrict__ ksc_p, const float* __restrict__ vsc_p,
                              T* __restrict__ out, float* __restrict__ part_acc,
                              float* __restrict__ part_m, float* __restrict__ part_l, int si,
                              int n_split, int b, int h, int cb, int r0, int nrows, int C, int H,
                              int Hkv, int dh, int start, int n_valid, int lo, int hi,
                              float scale_log2, unsigned char* smem) {
  static_assert(sizeof(T) == 2, "tensor-core tiles take bf16 or f16");
  using S = Layout<KV>;
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));   // elements a 16-byte copy
  constexpr int RAW_LD = S::QUANT ? DS : LD;               // elements a staged K/V row
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr0 = warp * 16;
  const int c0 = cb * DS;
  const bool direct = part_acc == nullptr;
  auto orow = [&](int r) {
    const int gr = r0 + r;
    return (static_cast<size_t>(b) * C + gr / group) * H + h * group + gr % group;
  };
  auto frontier = [&](int gr) { return min(min(start + gr / group + 1, n_valid), hi); };

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
  const float sl = scale_log2 * (ksc_p ? ksc_p[h] : 1.f);
  const float vsc = vsc_p ? vsc_p[h] : 1.f;
  T* cvt = reinterpret_cast<T*>(smem + STAGES * S::STAGE);
  const size_t kv_stride = static_cast<size_t>(Hkv) * dh;   // between K/V rows
  const KV* kb0 = kp + static_cast<size_t>(h) * dh;
  const KV* vb0 = vp + static_cast<size_t>(h) * dh + c0;
  const int n_pc = dh / DS;
  const int per_tile = n_pc + 1;
  const int n_steps = (hi - lo + BN - 1) / BN * per_tile;

  // step g of tile g / per_tile: a Q and a K piece, or (the last) V's slice
  auto load_step = [&](int g) {
    const int pc = g % per_tile;
    const int base = lo + g / per_tile * BN;
    unsigned char* st = smem + g % STAGES * S::STAGE;
    if (pc < n_pc) {
      T* sq = reinterpret_cast<T*>(st);
      for (int i = tid; i < BM * DS / 8; i += WT) {
        const int r = i / (DS / 8), c = (i % (DS / 8)) * 8;
        const bool ok = r < nrows;
        cp_async16(sq + r * LD + c, ok ? q + orow(r) * dh + pc * DS + c : q, ok);
      }
    }
    KV* skv = reinterpret_cast<KV*>(st + S::Q_BYTES);
    const KV* src = pc < n_pc ? kb0 + pc * DS : vb0;
    for (int i = tid; i < BN * DS / EPC; i += WT) {
      const int j = i / (DS / EPC), c = (i % (DS / EPC)) * EPC;
      const bool ok = base + j < hi;
      const size_t off = ok ? static_cast<size_t>(row_of(base + j)) * kv_stride + c : 0;
      cp_async16(skv + j * RAW_LD + c, src + off, ok);
    }
  };
  // int8 stage -> the converted piece (exact in T)
  auto convert = [&](const unsigned char* raw) {
    for (int i = tid; i < BN * DS / 16; i += WT) {
      const int j = i / (DS / 16), c = (i % (DS / 16)) * 16;
      const uint4 x = *reinterpret_cast<const uint4*>(raw + j * DS + c);
      const int8_t* e = reinterpret_cast<const int8_t*>(&x);
      uint4 lo8, hi8;
      unsigned* l = reinterpret_cast<unsigned*>(&lo8);
      unsigned* u = reinterpret_cast<unsigned*>(&hi8);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        l[p] = pack2<T>(static_cast<float>(e[2 * p]), static_cast<float>(e[2 * p + 1]));
        u[p] = pack2<T>(static_cast<float>(e[8 + 2 * p]), static_cast<float>(e[9 + 2 * p]));
      }
      *reinterpret_cast<uint4*>(cvt + j * LD + c) = lo8;
      *reinterpret_cast<uint4*>(cvt + j * LD + c + 8) = hi8;
    }
  };

  float o[DS / 8][4];
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float s[BN / 8][4];
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};   // this lane's share of the row sums
  // keys < lim_r[i] for the lane's two rows; the warp's least and greatest
  // limit (rows past nrows are padding)
  const int row_a = r0 + wr0 + (lane >> 2);
  const int lim_r[2] = {frontier(row_a), frontier(row_a + 8)};
  const bool w_live = wr0 < nrows;
  const int w_min = frontier(r0 + wr0);
  const int w_max = frontier(r0 + min(wr0 + 15, nrows - 1));

  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < n_steps) load_step(g);
    cp_async_commit();
  }
  for (int g = 0; g < n_steps; ++g) {
    // after this barrier step g's copies are visible to every warp, and
    // every warp is done with step g - 1, whose stage the next copies take
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (g + STAGES - 1 < n_steps) load_step(g + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + g % STAGES * S::STAGE;
    const T* skv;
    if constexpr (S::QUANT) {
      convert(st + S::Q_BYTES);
      __syncthreads();
      skv = cvt;
    } else {
      skv = reinterpret_cast<const T*>(st + S::Q_BYTES);
    }
    const int pc = g % per_tile;
    const int kbase = lo + g / per_tile * BN;
    if (!w_live || kbase >= w_max) continue;   // no row of the warp sees these keys

    if (pc < n_pc) {
      // S += Q K^T over this piece: 16 rows x BN keys a warp
      if (pc == 0) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
      const T* sq_frag =
          reinterpret_cast<const T*>(st) + (wr0 + (lane & 15)) * LD + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk) {
        unsigned qf[4];
        ldsm_x4(qf, sq_frag + kk * 16);
#pragma unroll
        for (int nn = 0; nn < BN / 16; ++nn) {
          unsigned bk[4];   // two 8-key tiles: keys nn*16 + (0..7 | 8..15)
          ldsm_x4(bk, skv + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          (((lane >> 3) & 1) << 3));
          mma16816<T>(s[2 * nn], qf, bk[0], bk[1]);
          mma16816<T>(s[2 * nn + 1], qf, bk[2], bk[3]);
        }
      }
      continue;
    }

    // online softmax (log2 domain); mask only where the tile crosses a
    // row's limit
    const bool edge = kbase + BN > w_min;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl;
        if (edge && kbase + n * 8 + ((lane & 3) << 1) + (e & 1) >= lim_r[e >> 1]) x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(fminf(m_r[i] - mx[i], 0.f));
      m_r[i] = mx[i];
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x <= NEG_INF / 2 ? 0.f : exp2f(x - m_r[e >> 1]);
        s[n][e] = p;
        l_r[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < DS / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P from the score registers, rounded to T
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const unsigned pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < DS / 16; ++nn) {
        unsigned bv[4];   // keys kk*16 + (0..7 | 8..15), columns nn*16 + (0..7 | 8..15)
        ldsm_x4_t(bv, skv + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                          nn * 16 + ((lane >> 4) << 3));
        mma16816<T>(o[2 * nn], pa, bv[0], bv[1]);
        mma16816<T>(o[2 * nn + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lr = wr0 + (lane >> 2) + 8 * i;
    if (lr >= nrows) continue;
    const size_t orw = orow(lr);
    const int d0 = c0 + ((lane & 3) << 1);
    if (direct) {
      const float inv = vsc / fmaxf(l_r[i], 1e-30f);
      T* dst = out + orw * dh + d0;
#pragma unroll
      for (int n = 0; n < DS / 8; ++n)
        *reinterpret_cast<unsigned*>(dst + n * 8) =
            pack2<T>(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    } else {
      float* dst = part_acc + (orw * n_split + si) * dh + d0;
#pragma unroll
      for (int n = 0; n < DS / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[n][2 * i] * vsc, o[n][2 * i + 1] * vsc);
      if ((lane & 3) == 0 && cb == 0) {
        part_m[orw * n_split + si] = m_r[i] <= NEG_INF / 2 ? NEG_INF : m_r[i] * LN2;
        part_l[orw * n_split + si] = l_r[i];
      }
    }
  }
}

}  // namespace wide_tc
}  // namespace repro_paged
