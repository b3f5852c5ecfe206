// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel): blocked online-softmax GQA attention of q (B, S, H, dh) over
// k/v (B, S, Hkv, dh), query head hq reading kv head hq / group, causal
// (query position c sees keys <= c) or full. It is the static engine's
// prefill attention (every layer of every prompt wave).
//
// What bounds it on this card: at a 512-token prompt the bf16 work is
// about 4.3 GFLOP against 18.9 MB of inputs and outputs, so at the tensor
// cores' rate it is byte bound (5.6 us of bytes, 4.4 us of operations):
// the products must run on the tensor cores, and nothing but Q, K, V and
// the output may touch device memory. Measured (PERF.md), this design is
// still several times its bound, set by the latency of each key tile's
// step (wait, products, softmax, barrier) rather than by bytes or by the
// tensor cores' rate.
//
// Design, bf16 and f16 (FlashAttention-2 on mma.sync):
//   * rows are (position, head-in-group) pairs of one (sequence, kv head),
//     BM = 64 of them a block of 4 warps, 16 rows a warp, so every staged
//     K/V tile serves the whole GQA group (at group 8 a tile is 8
//     positions x 8 heads); the grid is (Hkv, B, row tiles), the tile
//     index reversed so that the heaviest causal tiles start first;
//   * S = Q K^T and O += P V with mma.sync.m16n8k16 (bf16/f16 in, f32
//     accumulate); Q stays in registers for the whole walk up to dh 128
//     (at 256 it is read from shared memory each key step: Cfg); P goes from
//     the score accumulators to the PV product in registers, rounded to
//     the input dtype (the Pallas kernel and the plain version keep it in
//     f32); V is read through ldmatrix.trans;
//   * K and V tiles of BN = 32 keys go into a ring of three shared-memory
//     stages with cp.async (16 bytes a thread), so the next two tiles'
//     loads overlap this tile's products (52 KB at dh=128); Q passes
//     through the last stage before the walk starts (at dh 256: two stages
//     and a Q region of its own, 99 KB); rows are padded by
//     16 bytes, which makes every ldmatrix free of bank conflicts; keys at
//     or past S are zero-filled, never loaded. 32-key tiles waste less of
//     the diagonal tile than 64-key ones, where a 64-row tile at group 8
//     spans only 8 positions;
//   * online softmax in f32 registers with the reference's rules
//     (paged_attention.cuh), in the log2 domain (exp2f, scale * log2(e)
//     folded into one multiply); row max and sum by quad shuffles;
//   * causal: a row tile walks keys only up to its last row's position,
//     and only tiles that cross the diagonal (or the end of the keys) mask
//     per element. Any S == L is taken: the last row tile is short.
//   * above dh 256 two warps share each 16-row tile (8 warps a block), each
//     holding half of O's columns: O alone would need dh / 2 f32 registers
//     a thread (256 at 512, past the 255 a thread has). Both warps compute
//     the tile's whole S = Q K^T and run the same softmax on it, so the
//     two halves see bitwise the same P, with no exchange through shared
//     memory and no barrier between them; the cost is Q K^T's products
//     twice, on a kernel bound by the latency of its key steps, not by
//     its tensor cores (the other way, partial dots summed through shared
//     memory, adds a store, a barrier and a load to every key step).
// f32 has no tensor-core product without TF32, so it keeps the shared
// FMA row-tile body (attend_rows; 8 rows a block at dh 256 and 384, 4 at
// 512). Head widths 64, 128, 256, 384 and 512 (dispatch.cuh). Next
// (ROADMAP A14): 32 rows a warp, then wgmma with TMA.
#include <type_traits>

#include "dispatch.cuh"
#include "mma_tile.cuh"

namespace repro_paged {

// ---- f32: the shared FMA row-tile body ----

template <typename T, typename KV, int DH>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
             T* __restrict__ out, int S, int H, int Hkv, int causal, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  constexpr int ROWS = FmaRows<DH>::value;
  const int rows = S * (H / Hkv);
  const int r0 = blockIdx.z * ROWS;
  const int nrows = min(ROWS, rows - r0);
  // causal: the prompt is a chunk at start 0 (row c sees keys < c + 1);
  // full: start S puts every row's causal frontier past the keys, so
  // n_valid = S binds for all
  attend_rows<T, KV, DH>(q, k, v, DenseRows{static_cast<long long>(b) * S, S}, nullptr,
                         nullptr, out, b, h, r0, nrows, /*C=*/S, H, Hkv,
                         /*start=*/causal ? 0 : S, /*n_valid=*/S, scale);
}

// ---- bf16 / f16: tensor-core tiles ----

namespace flash_tc {

constexpr int BM = 64;         // query rows a block
constexpr int BN = 32;         // keys a staged tile
constexpr int WR = BM / 16;    // warps along the rows: 16 rows a warp
constexpr float LOG2E = 1.4426950408889634f;

// Up to dh 128 Q stays in registers and passes through the last stage of
// a ring of three; at 256 its 64 registers beside O's 128 f32 would crowd
// 255, so Q keeps a region of its own and each key step reads its
// fragments with ldmatrix, beside a ring of two (99 KB: two blocks an SM).
// Above 256 WD = 2 warps share each 16-row tile, each holding DW = dh / 2
// of O's columns (the note at the top): 147 and 195 KB at 384 and 512, 8
// warps, one block an SM.
template <int DH>
struct Cfg {
  static constexpr bool Q_SMEM = DH >= 256;   // Q's fragments from shared memory
  static constexpr int STAGES = Q_SMEM ? 2 : 3;  // ring of K/V tiles in flight
  static constexpr int WD = DH > 256 ? 2 : 1;    // warps along dh, DW columns of O each
  static constexpr int DW = DH / WD;
  static constexpr int NTHR = WR * WD * 32;
  static constexpr int LD = DH + 8;        // padded row, elements (+16 bytes)
  static constexpr int CPR = DH / 8;       // 16-byte chunks a row
  static constexpr int TILE = BN * LD;     // one K or V tile, elements
  static constexpr int SMEM_BYTES = (STAGES * 2 * TILE + (Q_SMEM ? BM * LD : 0)) * 2;
  static_assert(Q_SMEM || BM <= 2 * BN, "Q is staged in one stage's place");
  static_assert(SMEM_BYTES <= 232448, "within a block's opt-in shared memory");
};

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<DH>::NTHR)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int S, int H, int Hkv, int causal, float scale_log2) {
  static_assert(sizeof(T) == 2, "tensor-core tiles take bf16 or f16");
  using C = Cfg<DH>;
  constexpr int LD = C::LD, STAGES = C::STAGES, NTHR = C::NTHR, DW = C::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* skv = reinterpret_cast<T*>(smem_raw);  // stage s: K at 2s * TILE, V after it
  // Q: past the ring (Q_SMEM), else in the last stage until its first tile
  // is loaded
  T* sq = skv + 2 * (C::Q_SMEM ? STAGES : STAGES - 1) * C::TILE;

  const int h = blockIdx.x, b = blockIdx.y;
  const int group = H / Hkv;
  const int rows = S * group;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heaviest causal tiles first
  const int nrows = min(BM, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first_pos = r0 / group;
  const int limit = causal ? min((r0 + nrows - 1) / group + 1, S) : S;
  const int n_tiles = (limit + BN - 1) / BN;

  const size_t kv_stride = static_cast<size_t>(Hkv) * DH;  // between key positions
  const T* kb = k + (static_cast<size_t>(b) * S * Hkv + h) * DH;
  const T* vb = v + (static_cast<size_t>(b) * S * Hkv + h) * DH;

  // Q rows of the tile (zero past the last row) join the first tile's group
  for (int i = tid; i < BM * C::CPR; i += NTHR) {
    const int r = i / C::CPR, c = (i % C::CPR) * 8;
    const int gr = r0 + r;
    const bool ok = r < nrows;
    const T* src =
        ok ? q + ((static_cast<size_t>(b) * S + gr / group) * H + h * group + gr % group) * DH + c
           : q;
    cp_async16(sq + r * LD + c, src, ok);
  }
  auto load_tile = [&](int t) {
    T* sk = skv + 2 * (t % STAGES) * C::TILE;
    T* sv = sk + C::TILE;
    const int base = t * BN;
    for (int i = tid; i < BN * C::CPR; i += NTHR) {
      const int j = i / C::CPR, c = (i % C::CPR) * 8;
      const bool ok = base + j < S;
      const size_t off = ok ? static_cast<size_t>(base + j) * kv_stride + c : 0;
      cp_async16(sk + j * LD + c, kb + off, ok);
      cp_async16(sv + j * LD + c, vb + off, ok);
    }
  };
  for (int t = 0; t < STAGES - 1; ++t) {  // Q joins the first tile's group
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  const int wr0 = (warp % WR) * 16;
  const int dc = (warp / WR) * DW;   // the warp's first column of O
  const T* sq_frag = sq + (wr0 + (lane & 15)) * LD + ((lane >> 4) << 3);
  // Q's fragments: in registers for the whole walk, or (Q_SMEM) loaded
  // from shared memory at each key step, after that step's barrier
  unsigned qf[DH / 16][4];
  if constexpr (!C::Q_SMEM) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) ldsm_x4(qf[kk], sq_frag + kk * 16);
  }

  float o[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this lane's share of the row sums
  const int row_a = r0 + wr0 + (lane >> 2);
  const int pos_r[2] = {row_a / group, (row_a + 8) / group};

  for (int t = 0; t < n_tiles; ++t) {
    // one barrier a tile: after it tile t is visible to every warp, and
    // every warp is done with tile t - 1 (at t = 0: with Q), whose stage
    // the next load takes
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    const T* sk = skv + 2 * (t % STAGES) * C::TILE;
    const T* sv = sk + C::TILE;

    // S = Q K^T: 16 rows x BN keys a warp
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      if constexpr (C::Q_SMEM) ldsm_x4(qf[kk], sq_frag + kk * 16);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        unsigned bk[4];  // two 8-key tiles: keys nn*16 + (0..7 | 8..15)
        ldsm_x4(bk, sk + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        (((lane >> 3) & 1) << 3));
        mma16816<T>(s[2 * nn], qf[kk], bk[0], bk[1]);
        mma16816<T>(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // online softmax (log2 domain); mask only where the tile crosses the
    // diagonal or the end of the keys
    const int kbase = t * BN;
    const bool edge = kbase + BN > S || (causal && kbase + BN - 1 > first_pos);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = kbase + n * 8 + ((lane & 3) << 1) + (e & 1);
          if (key >= S || (causal && key > pos_r[e >> 1])) x = NEG_INF;
        }
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
    for (int n = 0; n < DW / 8; ++n) {
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
      for (int nn = 0; nn < DW / 16; ++nn) {
        unsigned bv[4];  // keys kk*16 + (0..7 | 8..15), dims dc + nn*16 + (0..7 | 8..15)
        ldsm_x4_t(bv, sv + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + dc +
                          nn * 16 + ((lane >> 4) << 3));
        mma16816<T>(o[2 * nn], pa, bv[0], bv[1]);
        mma16816<T>(o[2 * nn + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30), in T
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = fmaxf(l_r[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lr = wr0 + (lane >> 2) + 8 * i;
    if (lr < nrows) {
      const int gr = r0 + lr;
      T* dst = out + ((static_cast<size_t>(b) * S + gr / group) * H + h * group + gr % group) * DH +
               dc + ((lane & 3) << 1);
#pragma unroll
      for (int n = 0; n < DW / 8; ++n)
        *reinterpret_cast<unsigned*>(dst + n * 8) =
            pack2<T>(o[n][2 * i] / l_r[i], o[n][2 * i + 1] / l_r[i]);
    }
  }
}

}  // namespace flash_tc

template <typename T, typename KV, int DH>
struct FlashLaunch {
  static void run(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                  int Hkv, int causal, float scale, cudaStream_t stream) {
    const int rows = S * (H / Hkv);
    if constexpr (std::is_same<T, float>::value) {
      constexpr int ROWS = FmaRows<DH>::value;
      dim3 grid(Hkv, B, (rows + ROWS - 1) / ROWS);
      flash_kernel<T, KV, DH><<<grid, NT, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
          static_cast<T*>(out), S, H, Hkv, causal, scale);
    } else {
      using namespace flash_tc;
      constexpr int smem = Cfg<DH>::SMEM_BYTES;
      static bool smem_set = false;  // once a kernel; a failure stays the last error
      if (!smem_set) {
        if (cudaFuncSetAttribute(flash_mma_kernel<T, DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem) != cudaSuccess)
          return;
        smem_set = true;
      }
      dim3 grid(Hkv, B, (rows + BM - 1) / BM);
      flash_mma_kernel<T, DH><<<grid, Cfg<DH>::NTHR, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out), S, H, Hkv, causal, scale * LOG2E);
    }
  }
};

}  // namespace repro_paged

// q, out: (B, S, H, dh); k, v: (B, S, Hkv, dh), all of one dtype, 16-byte
// aligned; causal: 0 or 1. Returns cudaGetLastError() after the launch, or
// -1 for an unsupported dtype/width.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int S, int H, int Hkv, int dh, int dtype, int causal,
                               float scale, void* stream) {
  return repro_paged::dispatch_same<repro_paged::FlashLaunch>(
      dh, dtype, q, k, v, out, B, S, H, Hkv, causal, scale, static_cast<cudaStream_t>(stream));
}
