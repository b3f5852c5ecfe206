// Chunked-prefill and speculative-verify attention over the paged KV pool
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// chunk_prefill_attention (_chunk_kernel): a (B, C) query chunk at absolute
// positions [start_b, start_b + C) against the pool, which already holds
// the chunk's own KV. Rows are ordered (position, head-in-group); row r
// attends key positions < min(start_b + r / group + 1, n_valid_b), read
// through page_table[b, kpos / ps] (ids outside [0, n_pages) read the null
// page 0); no key past a block's frontier is loaded. The speculative-verify
// window is this kernel too (spec_verify_attention in decode_attention.py,
// replacing repro/kernels/decode_attention.py::spec_verify_attention):
// start = seq_lens, n_valid = seq_lens + n_fed, C = spec_k + 1 or less;
// rows past a sequence's fed window see the last fed row's frontier
// through the min() with n_valid.
//
// What bounds it on this card: at the continuous path's 64-position chunk
// the work is about 64 * group multiply-adds per KV element, so a bf16
// pool is byte bound only on the tensor cores (the chunk's bound is about
// 1.3 us of bytes at B=1, 32 kv heads, 448 keys; a verify pass of B=8
// windows over ~300 keys is about 6 us of bytes). The earlier FMA body
// (attend_rows) was set instead by f32 dots out of shared memory and by a
// grid of 32 to 256 blocks each walking its whole prefix in series.
// Measured with this design (PERF.md), both entries are latency bound: a
// block's serial prologue (page-table reads, then Q and the first
// stages), a few steps of 32 or 64 keys, and the combine's second launch.
//
// Design, bf16/f16 queries over a pool of their own type or int8:
//   * tensor-core tiles as in flash_attention.cu (mma_tile.cuh): S = Q K^T
//     and O += P V with mma.sync.m16n8k16 in f32, Q in registers, P
//     rounded to the query dtype for the PV product, V through
//     ldmatrix.trans; K/V tiles in a ring of three cp.async stages with
//     rows padded by 16 bytes, Q passing through a stage before the walk;
//     at dh 256 Q keeps a shared-memory region of its own, read with
//     ldmatrix each step, beside a ring of two stages (Cfg: 64 Q registers
//     beside O's 128 f32 would crowd the 255 a thread);
//   * key rows through the page table: a block first turns its key range
//     into pool rows (pid * ps + kpos % ps, one page-table read a key) in
//     shared memory; every 16-byte copy then addresses its row of the
//     (n_pages * ps, Hkv, dh) view; keys past the block's frontier or its
//     split are zero-filled, not read;
//   * int8 pools: the ring stages the int8 tile, which is converted in
//     shared memory to the query dtype (exact: |x| <= 127); the kv head's
//     k scale joins the score multiplier and its v scale the output, so
//     the products see the integers (the plain version scales in f32
//     before its dots: one more rounding difference);
//   * split over keys: the table's key range n_pp * ps is cut into splits
//     of `split` keys (kernels/decode_attention.py, chunk_split: a
//     function of the shapes and the SM count, never of start or n_valid,
//     which stay on the device). A block takes one (split, kv head, row
//     tile, sequence); a split wholly past its row tile's frontier writes
//     m = NEG_INF, l = 0, acc = 0 without reading a key. With one split the
//     block writes the output; with more, pass 2 (split_decode.cuh's
//     split_combine_kernel) combines the partials in split order, with no
//     float atomics (bitwise repeatable);
//   * row tiles of 64 rows (4 warps of 16) when C * group > 16, else of 16
//     rows (the verify windows at group 1), whose 4 warps take different
//     16-key slices of each 64-key stage and merge their (m, l, acc)
//     through shared memory at the end;
//   * above dh 256 (384, 512) two warps share each (row tile, key slice),
//     each holding half of O's columns (O alone would take dh / 2 f32
//     registers a thread: 256 at 512, past the 255 a thread has): 8 warps
//     on a 64-row tile, 4 on a 16-row tile (2 along the keys), 32 keys a
//     stage either way (chunk_split takes dh for it). Both warps of a pair
//     compute the slice's whole S = Q K^T and run the same softmax on it,
//     so they hold bitwise the same P, m and l, with no exchange through
//     shared memory and no barrier between them; the cost is Q K^T's
//     products twice, on a kernel bound by the latency of its key steps
//     (the other way, partial dots summed through shared memory, puts a
//     store, a barrier and a load in every key step);
//   * online softmax in f32 registers in the log2 domain with the
//     reference's rules (paged_attention.cuh); a warp masks per element
//     only on steps that cross one of its rows' frontiers, and skips steps
//     past all of them.
// f32 queries, and pools of another float type, keep the shared FMA
// row-tile body (attend_rows, one pass; 8 rows a block at dh 256 and 384,
// 4 at 512). Head widths 64, 128, 256, 384 and 512 (dispatch.cuh), and
// every multiple of 128 above 512 in the width-generic instance
// (wide_tile.cuh): a grid of (split, kv head x column block of 128,
// sequence x tile of 64 rows) on the tensor-core body of wide_mma.cuh,
// the same split rule over 32-key tiles (chunk_split counts the column
// blocks), the combine a block of 128 threads a (row, column block); the
// other pairings on the FMA body, 16 rows a block, one pass. Next: wgmma
// with TMA, which needs 64-row warpgroup tiles and a gather of paged rows
// per TMA box.
#include <type_traits>

#include "dispatch.cuh"
#include "mma_tile.cuh"
#include "split_decode.cuh"
#include "wide_mma.cuh"

namespace repro_paged {

// Where sequence b's chunk starts and how many of its keys are valid: a
// (B,) start, or one start for all (start == nullptr); a (B,) n_valid, or
// start + n_fed (the verify window's, n_valid == nullptr). The wrapper
// passes what it was given, so it launches nothing to build them.
struct Window {
  const int* start;
  int start0;
  const int* n_valid;
  const int* n_fed;
  __device__ __forceinline__ int start_of(int b) const { return start ? start[b] : start0; }
  __device__ __forceinline__ int valid_of(int b) const {
    return n_valid ? n_valid[b] : start_of(b) + n_fed[b];
  }
};

// ---- f32 queries: the shared FMA row-tile body ----

template <typename T, typename KV, int DH>
__global__ void __launch_bounds__(NT)
chunk_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                     const KV* __restrict__ vp, const int* __restrict__ pt, Window win,
                     const float* __restrict__ ksc, const float* __restrict__ vsc,
                     T* __restrict__ out, int C, int H, int Hkv, int ps, int n_pp,
                     int n_pages, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  constexpr int ROWS = FmaRows<DH>::value;
  const int rows = C * (H / Hkv);
  const int r0 = blockIdx.z * ROWS;
  const int nrows = min(ROWS, rows - r0);
  attend_rows<T, KV, DH>(q, kp, vp, PagedRows{pt + static_cast<size_t>(b) * n_pp, n_pp,
                                              n_pages, ps},
                         ksc, vsc, out, b, h, r0, nrows, C, H, Hkv, win.start_of(b),
                         win.valid_of(b), scale);
}

// ---- bf16 / f16 queries: tensor-core tiles, split over keys ----

namespace chunk_tc {

constexpr int NWARP = 4;         // warps along the rows and the keys (Cfg)
constexpr int MAX_SPLIT = 4096;  // keys a split at most (their pool rows sit in shared memory)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory of a split's pool rows (4 bytes a key), 16-byte aligned
__host__ __device__ constexpr int row_bytes(int split) { return (split * 4 + 15) / 16 * 16; }

// WR warps along the rows (16 rows each), NWARP / WR along the keys. Up to
// dh 128 Q stays in registers and passes through a stage (or the converted
// tile) of a ring of three; at 256 its 64 registers beside O's 128 f32
// would crowd 255, so Q keeps a region of its own, each key step reads its
// fragments with ldmatrix, and the ring holds two stages. Above 256 WD = 2
// warps share each (row tile, key slice), each holding DW = dh / 2 of O's
// columns (the note at the top): 2 warps along the keys with 16-row
// tiles, 1 with 64-row tiles, so a stage holds 32 keys (two stages of 64
// would pass a block's shared memory at 512).
template <typename T, typename KV, int DH, int WR>
struct Cfg {
  static constexpr bool Q_SMEM = DH >= 256;         // Q's fragments from shared memory
  static constexpr int STAGES = Q_SMEM ? 2 : 3;     // ring of K/V stages in flight
  static constexpr int WD = DH > 256 ? 2 : 1;       // warps along dh
  static constexpr int DW = DH / WD;                // O's columns a warp holds
  static constexpr int WK = WR == 1 ? NWARP / WD : 1;   // warps along the keys
  static constexpr int NTHR = WR * WK * WD * 32;    // threads a block
  static constexpr int BM = 16 * WR;                // rows a block
  static constexpr int KW = WK == 1 ? 32 : 16;      // keys a warp takes a step
  static constexpr int SK = KW * WK;                // keys a stage
  static constexpr int LD = DH + 8;                 // padded T row, elements (+16 bytes)
  static constexpr int CPR = DH / 8;                // 16-byte chunks of a T row
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int RAW_LD = QUANT ? DH : LD;    // KV elements a staged row
  static constexpr int RAW_CPR = DH * static_cast<int>(sizeof(KV)) / 16;
  static constexpr int RAW_TILE = SK * RAW_LD * static_cast<int>(sizeof(KV));  // bytes
  static constexpr int RING = STAGES * 2 * RAW_TILE;
  static constexpr int CVT = QUANT ? 2 * SK * LD * 2 : 0;   // int8 K and V as T
  static constexpr int QS = Q_SMEM ? BM * LD * 2 : 0;       // Q's own region
  static constexpr int MERGE = WK > 1 ? WK * 16 * (DH + 2) * 4 : 0;
  static constexpr int BODY = RING + CVT + QS > MERGE ? RING + CVT + QS : MERGE;
  static constexpr int SMEM_MAX = MAX_SPLIT * 4 + BODY;
  static_assert(Q_SMEM || BM <= 2 * SK,
                "Q is staged in one stage's (or the converted tile's) place");
  static_assert(SMEM_MAX <= 232448, "within a block's opt-in shared memory");
};

// Block (split, kv head h, row tile, sequence b): rows [r0, r0 + nrows)
// against keys [lo, hi) of the split, hi clipped to the row tile's
// frontier. part_acc == nullptr: one split, write out; else write the
// partials of query row (b, c, hq) at (((b * C + c) * H + hq) * n_split +
// split), m in the natural-log domain, acc scaled by the v scale.
template <typename T, typename KV, int DH, int WR>
__global__ void __launch_bounds__(Cfg<T, KV, DH, WR>::NTHR)
chunk_mma_kernel(const T* __restrict__ q, const KV* __restrict__ kp, const KV* __restrict__ vp,
                 const int* __restrict__ pt, Window win, const float* __restrict__ ksc_p,
                 const float* __restrict__ vsc_p, T* __restrict__ out,
                 float* __restrict__ part_acc, float* __restrict__ part_m,
                 float* __restrict__ part_l, int C, int H, int Hkv, int ps, int n_pp,
                 int n_pages, int split, float scale_log2) {
  static_assert(sizeof(T) == 2, "tensor-core tiles take bf16 or f16");
  using G = Cfg<T, KV, DH, WR>;
  constexpr int BM = G::BM, KW = G::KW, SK = G::SK, LD = G::LD, STAGES = G::STAGES;
  constexpr int NTHR = G::NTHR, DW = G::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_row = reinterpret_cast<int*>(smem_raw);   // pool row of each key of the split
  unsigned char* ring = smem_raw + row_bytes(split);
  T* cvt = reinterpret_cast<T*>(ring + G::RING);   // int8: the step's K and V as T

  const int si = blockIdx.x, n_split = gridDim.x;
  const int h = blockIdx.y;
  const int group = H / Hkv;
  const int rows = C * group;
  const int n_rt = (rows + BM - 1) / BM;
  const int b = blockIdx.z / n_rt;
  const int r0 = (blockIdx.z % n_rt) * BM;
  const int nrows = min(BM, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr0 = (warp % WR) * 16, wk = warp / WR % G::WK;
  const int dc = warp / (WR * G::WK) * DW;   // the warp's first column of O
  const int st = win.start_of(b), nv = min(win.valid_of(b), n_pp * ps);
  auto frontier = [&](int gr) { return min(st + gr / group + 1, nv); };
  const int lo = si * split;
  const int hi = min(lo + split, frontier(r0 + nrows - 1));
  const bool direct = part_acc == nullptr;
  // output / partial row of tile row r
  auto out_row = [&](int r) {
    const int gr = r0 + r;
    return (static_cast<size_t>(b) * C + gr / group) * H + h * group + gr % group;
  };

  if (lo >= hi) {   // wholly past the row tile's frontier: read nothing
    for (int i = tid; i < nrows * DH; i += NTHR) {
      const size_t orow = out_row(i / DH);
      const int d = i % DH;
      if (direct) {
        out[orow * DH + d] = from_f32<T>(0.f);
      } else {
        part_acc[(orow * n_split + si) * DH + d] = 0.f;
        if (d == 0) {
          part_m[orow * n_split + si] = NEG_INF;
          part_l[orow * n_split + si] = 0.f;
        }
      }
    }
    return;
  }
  const float sl = scale_log2 * (ksc_p ? ksc_p[h] : 1.f);
  const float vsc = vsc_p ? vsc_p[h] : 1.f;

  // the split's keys as pool rows, one page-table read a key
  const int* pt_row = pt + static_cast<size_t>(b) * n_pp;
  for (int j = tid; j < hi - lo; j += NTHR) {
    const int kpos = lo + j;
    int pid = pt_row[kpos / ps];
    if (pid < 0 || pid >= n_pages) pid = 0;   // never leave the pool
    s_row[j] = pid * ps + kpos % ps;
  }
  // Q rows of the tile (zero past the last row) join the first stage's
  // group: past the ring and the converted tile (Q_SMEM), else in the
  // converted tile (int8) or the last stage until the walk takes it
  T* sq = G::Q_SMEM ? reinterpret_cast<T*>(ring + G::RING + G::CVT)
          : G::QUANT ? cvt
                     : reinterpret_cast<T*>(ring + (STAGES - 1) * 2 * G::RAW_TILE);
  for (int i = tid; i < BM * G::CPR; i += NTHR) {
    const int r = i / G::CPR, c = (i % G::CPR) * 8;
    const bool ok = r < nrows;
    cp_async16(sq + r * LD + c, ok ? q + out_row(r) * DH + c : q, ok);
  }
  __syncthreads();   // s_row visible before the first stage's copies

  const size_t kv_stride = static_cast<size_t>(Hkv) * DH;   // between pool rows
  const KV* kb0 = kp + static_cast<size_t>(h) * DH;
  const KV* vb0 = vp + static_cast<size_t>(h) * DH;
  auto stage_k = [&](int t) {
    return reinterpret_cast<KV*>(ring + (t % STAGES) * 2 * G::RAW_TILE);
  };
  auto load_stage = [&](int t) {
    KV* sk = stage_k(t);
    KV* sv = sk + SK * G::RAW_LD;
    constexpr int EPC = 16 / static_cast<int>(sizeof(KV));   // elements a copy
    const int base = t * SK;                                 // from lo
    for (int i = tid; i < SK * G::RAW_CPR; i += NTHR) {
      const int j = i / G::RAW_CPR, c = (i % G::RAW_CPR) * EPC;
      const bool ok = lo + base + j < hi;
      const size_t off = ok ? static_cast<size_t>(s_row[base + j]) * kv_stride + c : 0;
      cp_async16(sk + j * G::RAW_LD + c, kb0 + off, ok);
      cp_async16(sv + j * G::RAW_LD + c, vb0 + off, ok);
    }
  };
  // int8 stage t -> the converted K and V tiles (exact in T)
  auto convert = [&](int t) {
    const KV* sk = stage_k(t);
    const KV* sv = sk + SK * G::RAW_LD;
    T* ck = cvt;
    T* cv = cvt + SK * LD;
    for (int i = tid; i < 2 * SK * (DH / 16); i += NTHR) {
      const int kv = i / (SK * (DH / 16)), ii = i % (SK * (DH / 16));
      const int j = ii / (DH / 16), c = (ii % (DH / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>((kv ? sv : sk) + j * DH + c);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      uint4 lo8, hi8;
      unsigned* l = reinterpret_cast<unsigned*>(&lo8);
      unsigned* u = reinterpret_cast<unsigned*>(&hi8);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        l[p] = pack2<T>(static_cast<float>(e[2 * p]), static_cast<float>(e[2 * p + 1]));
        u[p] = pack2<T>(static_cast<float>(e[8 + 2 * p]), static_cast<float>(e[9 + 2 * p]));
      }
      T* dst = (kv ? cv : ck) + j * LD + c;
      *reinterpret_cast<uint4*>(dst) = lo8;
      *reinterpret_cast<uint4*>(dst + 8) = hi8;
    }
  };

  const int n_steps = (hi - lo + SK - 1) / SK;
  for (int t = 0; t < STAGES - 1; ++t) {   // Q joins the first stage's group
    if (t < n_steps) load_stage(t);
    cp_async_commit();
  }
  const T* sq_frag = sq + (wr0 + (lane & 15)) * LD + ((lane >> 4) << 3);
  // Q's fragments: in registers for the whole walk, or (Q_SMEM) loaded
  // from shared memory at each key step, after that step's barrier
  unsigned qf[DH / 16][4];
  if constexpr (!G::Q_SMEM) {
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
  float l_r[2] = {0.f, 0.f};   // this lane's share of the row sums
  // keys < lim_r[i] for the lane's two rows; the warp's least and greatest
  // frontier within the split (rows past nrows are padding)
  const int row_a = r0 + wr0 + (lane >> 2);
  const int lim_r[2] = {min(frontier(row_a), hi), min(frontier(row_a + 8), hi)};
  const bool w_live = wr0 < nrows;
  const int w_min = min(frontier(r0 + wr0), hi);
  const int w_max = min(frontier(r0 + min(wr0 + 15, nrows - 1)), hi);

  for (int t = 0; t < n_steps; ++t) {
    // after this barrier stage t is visible to every warp, and every warp
    // is done with stage t - 1 (and with Q at t = 0), which the next load
    // takes
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < n_steps) load_stage(t + STAGES - 1);
    cp_async_commit();
    const T* sk;
    if constexpr (G::QUANT) {
      convert(t);
      __syncthreads();
      sk = cvt;
    } else {
      sk = reinterpret_cast<const T*>(stage_k(t));
    }
    const T* sv = sk + SK * LD;
    const int kbase = lo + t * SK + wk * KW;   // the warp's first key this step
    if (!w_live || kbase >= w_max) continue;  // no row of the warp sees these keys
    const T* skw = sk + wk * KW * LD;
    const T* svw = sv + wk * KW * LD;

    // S = Q K^T: 16 rows x KW keys a warp
    float s[KW / 8][4];
#pragma unroll
    for (int n = 0; n < KW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      if constexpr (G::Q_SMEM) ldsm_x4(qf[kk], sq_frag + kk * 16);
#pragma unroll
      for (int nn = 0; nn < KW / 16; ++nn) {
        unsigned bk[4];  // two 8-key tiles: keys nn*16 + (0..7 | 8..15)
        ldsm_x4(bk, skw + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        (((lane >> 3) & 1) << 3));
        mma16816<T>(s[2 * nn], qf[kk], bk[0], bk[1]);
        mma16816<T>(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // online softmax (log2 domain); mask only where the step crosses a
    // row's frontier or the split's end
    const bool edge = kbase + KW > w_min;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < KW / 8; ++n)
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
    for (int n = 0; n < KW / 8; ++n)
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
    for (int kk = 0; kk < KW / 16; ++kk) {
      const unsigned pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < DW / 16; ++nn) {
        unsigned bv[4];  // keys kk*16 + (0..7 | 8..15), dims dc + nn*16 + (0..7 | 8..15)
        ldsm_x4_t(bv, svw + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + dc +
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
  // (m, l, acc) of a row -> the output, or its partial in the natural-log
  // domain
  auto emit = [&](size_t orow, int d, float m, float l, float acc) {
    if (direct) {
      out[orow * DH + d] = from_f32<T>(acc * vsc / fmaxf(l, 1e-30f));
    } else {
      part_acc[(orow * n_split + si) * DH + d] = acc * vsc;
      if (d == 0) {
        part_m[orow * n_split + si] = m <= NEG_INF / 2 ? NEG_INF : m * LN2;
        part_l[orow * n_split + si] = l;
      }
    }
  };

  if constexpr (G::WK == 1) {
    // each warp writes its own rows (and columns) from the accumulators
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = wr0 + (lane >> 2) + 8 * i;
      if (lr >= nrows) continue;
      const size_t orow = out_row(lr);
      const int d0 = dc + ((lane & 3) << 1);
      if (direct) {
        const float inv = vsc / fmaxf(l_r[i], 1e-30f);
        T* dst = out + orow * DH + d0;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n)
          *reinterpret_cast<unsigned*>(dst + n * 8) =
              pack2<T>(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      } else {
        float* dst = part_acc + (orow * n_split + si) * DH + d0;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(o[n][2 * i] * vsc, o[n][2 * i + 1] * vsc);
        if ((lane & 3) == 0 && dc == 0) {
          part_m[orow * n_split + si] = m_r[i] <= NEG_INF / 2 ? NEG_INF : m_r[i] * LN2;
          part_l[orow * n_split + si] = l_r[i];
        }
      }
    }
  } else {
    // warps along the keys: merge their (m, l, acc) through shared memory
    // (the ring is free: every copy has landed and every warp is past its
    // last product after the barrier)
    __syncthreads();
    float* sm_o = reinterpret_cast<float*>(ring);   // [WK][16][DH]
    float* sm_m = sm_o + G::WK * 16 * DH;           // [WK][16]
    float* sm_l = sm_m + G::WK * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = (lane >> 2) + 8 * i;
      float* dst = sm_o + (wk * 16 + lr) * DH + dc + ((lane & 3) << 1);
#pragma unroll
      for (int n = 0; n < DW / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if ((lane & 3) == 0 && dc == 0) {
        sm_m[wk * 16 + lr] = m_r[i];
        sm_l[wk * 16 + lr] = l_r[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < nrows * DH; i += NTHR) {
      const int r = i / DH, d = i % DH;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < G::WK; ++w) M = fmaxf(M, sm_m[w * 16 + r]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < G::WK; ++w) {
        const float mw = sm_m[w * 16 + r];
        const float c = mw <= NEG_INF / 2 ? 0.f : exp2f(mw - M);
        L += c * sm_l[w * 16 + r];
        A += c * sm_o[(w * 16 + r) * DH + d];
      }
      emit(out_row(r), d, M, L, A);
    }
  }
}

template <typename T, typename KV, int DH, int WR>
void launch(const void* q, const void* kp, const void* vp, const void* pt, Window win,
            const void* ksc, const void* vsc, void* part, void* out,
            int B, int C, int H, int Hkv, int ps, int n_pp, int n_pages, int split,
            int n_split, float scale, cudaStream_t stream) {
  using G = Cfg<T, KV, DH, WR>;
  static bool smem_set = false;   // once a kernel; a failure stays the last error
  if (!smem_set) {
    if (cudaFuncSetAttribute(chunk_mma_kernel<T, KV, DH, WR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM_MAX) != cudaSuccess)
      return;
    smem_set = true;
  }
  const size_t n_rows = static_cast<size_t>(B) * C * H;
  float* acc = n_split > 1 ? static_cast<float*>(part) : nullptr;
  float* m = acc ? acc + n_rows * n_split * DH : nullptr;
  float* l = acc ? m + n_rows * n_split : nullptr;
  const int n_rt = (C * (H / Hkv) + G::BM - 1) / G::BM;
  const int smem = row_bytes(split) + G::BODY;
  chunk_mma_kernel<T, KV, DH, WR><<<dim3(n_split, Hkv, B * n_rt), G::NTHR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
      static_cast<const int*>(pt), win, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<T*>(out), acc, m, l, C, H, Hkv, ps, n_pp,
      n_pages, split, scale * LOG2E);
  // a refused first pass stays the last error; the entry reports it
  if (!acc || cudaPeekAtLastError() != cudaSuccess) return;
  split_combine_kernel<T, DH><<<static_cast<unsigned>(n_rows), DH, 0, stream>>>(
      acc, m, l, static_cast<T*>(out), n_split);
}

}  // namespace chunk_tc

// The tensor-core tiles take bf16/f16 queries over a pool of the query's
// type or int8; every other pairing runs the FMA body (one pass).
template <typename T, typename KV>
constexpr bool chunk_on_tensor_cores() {
  return !std::is_same<T, float>::value &&
         (std::is_same<KV, T>::value || std::is_same<KV, int8_t>::value);
}

template <typename T, typename KV, int DH>
struct ChunkLaunch {
  static void run(const void* q, const void* kp, const void* vp, const void* pt,
                  Window win, const void* ksc, const void* vsc,
                  void* part, void* out, int B, int C, int H, int Hkv, int ps, int n_pp,
                  int n_pages, int split, int n_split, float scale, cudaStream_t stream) {
    const int rows = C * (H / Hkv);
    if constexpr (chunk_on_tensor_cores<T, KV>()) {
      if (rows <= 16)
        chunk_tc::launch<T, KV, DH, 1>(q, kp, vp, pt, win, ksc, vsc, part, out, B, C, H, Hkv,
                                       ps, n_pp, n_pages, split, n_split, scale, stream);
      else
        chunk_tc::launch<T, KV, DH, chunk_tc::NWARP>(q, kp, vp, pt, win, ksc, vsc, part, out,
                                                     B, C, H, Hkv, ps, n_pp, n_pages, split,
                                                     n_split, scale, stream);
    } else {
      constexpr int ROWS = FmaRows<DH>::value;
      dim3 grid(Hkv, B, (rows + ROWS - 1) / ROWS);
      chunk_prefill_kernel<T, KV, DH><<<grid, NT, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
          static_cast<const int*>(pt), win, static_cast<const float*>(ksc),
          static_cast<const float*>(vsc), static_cast<T*>(out), C, H, Hkv, ps, n_pp, n_pages,
          scale);
    }
  }
};

// ---- above 512 (dispatch.cuh's WIDE): the width-generic bodies ----

// Tensor-core tiles: block (split, kv head x column block, sequence x row
// tile of wide_tc::BM), the split's keys turned into pool rows in shared
// memory before the walk, as chunk_mma_kernel does.
template <typename T, typename KV>
__global__ void __launch_bounds__(WT)
chunk_wide_mma_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                      const KV* __restrict__ vp, const int* __restrict__ pt, Window win,
                      const float* __restrict__ ksc, const float* __restrict__ vsc,
                      T* __restrict__ out, float* __restrict__ part_acc,
                      float* __restrict__ part_m, float* __restrict__ part_l, int C, int H,
                      int Hkv, int dh, int ps, int n_pp, int n_pages, int split,
                      float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_row = reinterpret_cast<int*>(smem_raw);   // pool row of each key of the split
  const int n_cb = dh / DS;
  const int si = blockIdx.x, h = blockIdx.y / n_cb, cb = blockIdx.y % n_cb;
  const int group = H / Hkv;
  const int rows = C * group;
  const int n_rt = (rows + wide_tc::BM - 1) / wide_tc::BM;
  const int b = blockIdx.z / n_rt;
  const int r0 = (blockIdx.z % n_rt) * wide_tc::BM;
  const int nrows = min(wide_tc::BM, rows - r0);
  const int st = win.start_of(b), nv = min(win.valid_of(b), n_pp * ps);
  const int lo = si * split;
  const int hi = min(lo + split, min(st + (r0 + nrows - 1) / group + 1, nv));
  const int* pt_row = pt + static_cast<size_t>(b) * n_pp;
  for (int j = threadIdx.x; j < hi - lo; j += WT) {
    const int kpos = lo + j;
    int pid = pt_row[kpos / ps];
    if (pid < 0 || pid >= n_pages) pid = 0;   // never leave the pool
    s_row[j] = pid * ps + kpos % ps;
  }
  __syncthreads();   // s_row visible before the first copies
  wide_tc::wide_mma_rows<T, KV>(
      q, kp, vp, [&](int kpos) { return s_row[kpos - lo]; }, ksc, vsc, out, part_acc, part_m,
      part_l, si, gridDim.x, b, h, cb, r0, nrows, C, H, Hkv, dh, st, nv, lo, hi, scale_log2,
      smem_raw + chunk_tc::row_bytes(split));
}

// The FMA body: block (kv head x column block, sequence, tile of WROWS
// rows), one pass over its frontier.
template <typename T, typename KV>
__global__ void __launch_bounds__(WT)
chunk_wide_fma_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                      const KV* __restrict__ vp, const int* __restrict__ pt, Window win,
                      const float* __restrict__ ksc, const float* __restrict__ vsc,
                      T* __restrict__ out, int C, int H, int Hkv, int dh, int ps, int n_pp,
                      int n_pages, float scale) {
  const int n_cb = dh / DS;
  const int h = blockIdx.x / n_cb, cb = blockIdx.x % n_cb, b = blockIdx.y;
  const int group = H / Hkv;
  const int r0 = blockIdx.z * WROWS;
  const int nrows = min(WROWS, C * group - r0);
  const int st = win.start_of(b), nv = min(win.valid_of(b), n_pp * ps);
  wide_fma_rows<T, KV>(q, kp, vp, PagedRows{pt + static_cast<size_t>(b) * n_pp, n_pp,
                                            n_pages, ps},
                       ksc, vsc, out, nullptr, nullptr, nullptr, 0, 1, b, h, cb, r0, nrows,
                       C, H, Hkv, dh, st, nv, 0,
                       min(st + (r0 + nrows - 1) / group + 1, nv), scale);
}

template <typename T, typename KV>
struct ChunkLaunch<T, KV, WIDE> {
  static void run(int dh, const void* q, const void* kp, const void* vp, const void* pt,
                  Window win, const void* ksc, const void* vsc, void* part, void* out, int B,
                  int C, int H, int Hkv, int ps, int n_pp, int n_pages, int split, int n_split,
                  float scale, cudaStream_t stream) {
    const int rows = C * (H / Hkv);
    const unsigned hc = static_cast<unsigned>(Hkv * (dh / DS));
    if constexpr (chunk_on_tensor_cores<T, KV>()) {
      using Lay = wide_tc::Layout<KV>;
      static bool smem_set = false;   // once a kernel; a failure stays the last error
      if (!smem_set) {
        if (cudaFuncSetAttribute(chunk_wide_mma_kernel<T, KV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 chunk_tc::row_bytes(chunk_tc::MAX_SPLIT) + Lay::BYTES) !=
            cudaSuccess)
          return;
        smem_set = true;
      }
      const size_t n_rows = static_cast<size_t>(B) * C * H;
      const WideParts parts(n_split > 1 ? part : nullptr, n_rows, n_split, dh);
      const int n_rt = (rows + wide_tc::BM - 1) / wide_tc::BM;
      chunk_wide_mma_kernel<T, KV>
          <<<dim3(n_split, hc, B * n_rt), WT, chunk_tc::row_bytes(split) + Lay::BYTES,
             stream>>>(static_cast<const T*>(q), static_cast<const KV*>(kp),
                       static_cast<const KV*>(vp), static_cast<const int*>(pt), win,
                       static_cast<const float*>(ksc), static_cast<const float*>(vsc),
                       static_cast<T*>(out), parts.acc, parts.m, parts.l, C, H, Hkv, dh, ps,
                       n_pp, n_pages, split, scale * wide_tc::LOG2E);
      parts.combine<T>(out, n_rows, n_split, dh, stream);
    } else {
      chunk_wide_fma_kernel<T, KV><<<dim3(hc, B, (rows + WROWS - 1) / WROWS), WT, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
          static_cast<const int*>(pt), win, static_cast<const float*>(ksc),
          static_cast<const float*>(vsc), static_cast<T*>(out), C, H, Hkv, dh, ps, n_pp,
          n_pages, scale);
    }
  }
};

}  // namespace repro_paged

// q, out: (B, C, H, dh); k/v pages: (n_pages, ps, Hkv, dh); page_table:
// (B, n_pp) int32; start: (B,) int32, or null for start0 in every
// sequence; n_valid: (B,) int32, or null for start + n_fed with n_fed (B,)
// int32; k/v scales: (Hkv,) f32 or null. On the tensor-core tiles (bf16/f16 queries over their own type or
// int8): split keys a split (1 to 4096), n_split splits covering n_pp * ps
// keys; part: f32 scratch of B * C * H * n_split *
// (dh + 2) elements when n_split > 1, else unused. The FMA body ignores
// split, n_split and part. Returns cudaGetLastError() after the launches
// (the combine is not launched if the first pass is refused), or -1 for
// an unsupported dtype, width or split.
extern "C" int chunk_prefill_attention(const void* q, const void* kp, const void* vp,
                                       const void* page_table, const void* start, int start0,
                                       const void* n_valid, const void* n_fed,
                                       const void* k_scale, const void* v_scale, void* part,
                                       void* out, int B, int C, int H, int Hkv, int dh, int ps,
                                       int n_pp, int n_pages, int split, int n_split,
                                       int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace repro_paged;
  const bool tc = (q_dtype == BF16 || q_dtype == F16) && (kv_dtype == q_dtype || kv_dtype == I8);
  if (n_valid == nullptr && n_fed == nullptr) return UNSUPPORTED;
  if (tc && (split < 1 || split > chunk_tc::MAX_SPLIT || n_split < 1 ||
             static_cast<long long>(split) * n_split < static_cast<long long>(n_pp) * ps ||
             (n_split > 1 && part == nullptr)))
    return UNSUPPORTED;
  return dispatch<ChunkLaunch>(
      dh, q_dtype, kv_dtype, q, kp, vp, page_table,
      Window{static_cast<const int*>(start), start0, static_cast<const int*>(n_valid),
             static_cast<const int*>(n_fed)},
      k_scale, v_scale, part, out, B, C, H, Hkv, ps, n_pp, n_pages, split, n_split, scale,
      static_cast<cudaStream_t>(stream));
}
