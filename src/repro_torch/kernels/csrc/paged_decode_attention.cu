// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention (_paged_kernel): one query token per sequence
// against a page-table-indirected KV pool, the GQA group of H/Hkv query
// rows per kv head, positions >= seq_lens[b] masked and never read, page
// ids outside [0, n_pages) read as the null page 0.
//
// What bounds it on this card: the KV bytes. A decode step reads each
// sequence's valid keys once for group query rows: 1-8 FLOP a byte at the
// repo's paged widths, far below the ~295 a byte at which the H100's
// tensor cores become the limit, so there are no tensor cores here (a
// 16-row mma tile would waste 15 of its 16 rows at group 1). At the
// continuous path's shape (B=8, 32 kv heads, dh=64, bf16 pool, ragged
// lengths up to 576) the bytes take 0.00676 ms at 3.35 TB/s. The earlier
// design (the shared row-tile body, attend_rows) ran 8.3x that: a grid of
// B * Hkv blocks each walking its sequence serially, f32 staging with four
// barriers a tile and no load in flight across tiles, and half of every
// block idle at group 1. What the design spends on is loads in flight and
// blocks:
//   * split over the page table (flash-decoding): the table's n_pp * ps
//     keys are cut into splits of `split` keys, a whole number of pages
//     (kernels/decode_attention.py, paged_split: a function of the shapes
//     and the SM count, never of seq_lens, which stays on the device). A
//     block takes one (split, kv head, sequence, tile of R query rows). A
//     split wholly past seq_lens[b] reads no key and writes m = NEG_INF,
//     l = 0, acc = 0. With one split the block writes the output; with
//     more, pass 2 (split_decode.cuh's split_combine_kernel) combines the
//     partials in split order, with no float atomics (bitwise repeatable);
//   * a body made for one to a few query rows: the block first turns its
//     split's keys into pool rows (one page-table read a key, issued
//     before seq_lens is known) in shared memory, behind the one barrier
//     before the key loop. Its four warps then take 16-byte loads of K and
//     V in their storage dtype straight into registers: a key row's dh
//     elements span LPK lanes, so one warp-wide load covers 32 / LPK keys,
//     neighbouring lanes on neighbouring bytes. Each lane keeps its dh
//     slice of the tile's query rows in registers, pre-scaled; a key's dot
//     is summed across its lanes with __shfl_xor_sync;
//   * the next step's loads are issued into a second register buffer
//     before the current step is computed, so two steps of loads are in
//     flight; no barrier sits in the key loop;
//   * each warp runs the online softmax in f32 registers in the log2
//     domain with the reference's rules (paged_attention.cuh), and at the
//     end of the split the warps merge their (m, l, acc) through shared
//     memory in warp order;
//   * int8 pools: the k scale joins the query's pre-scale and the v scale
//     multiplies the accumulator, outside the products (the plain version
//     scales in f32 before its dots: the last f32 places may differ).
// Query rows past what the registers hold (R: 4 rows, 2 over int8) are
// further row tiles of the grid. Head widths 64, 128, 256, 384 and 512
// (dispatch.cuh): at 256 a bf16/f16 key row spans all 32 lanes (a dot is a
// five-level shuffle), an int8 row 16, and an f32 row (1 KB) 32 lanes of
// two loads each, with half the keys a step (Geo); at 384 a row is three
// loads a lane over 16 (bf16/f16), 32 (f32) or 8 (int8) lanes, at 512 two
// (bf16/f16), four (f32) or one (int8) over all 32; where a lane holds
// more than 16 elements of a row (bf16/f16 and int8 at 384, f32 at 512) a
// block takes one query row, else two at these widths; the combine runs
// DH threads. Every multiple of 128 above 512 runs the width-generic
// instance (wide_tile.cuh): the same splits (paged_split counts its
// column blocks), a grid of (split, kv head x column block of 128, sequence
// x tile of 4 query rows), each block the decode body over its split's
// keys (one a thread, its whole row dotted in registers) for the whole of
// S and its slice of O, the combine a block of 128 threads a (row, column
// block).
#include "dispatch.cuh"
#include "split_decode.cuh"
#include "wide_tile.cuh"

namespace repro_paged {
namespace paged_dec {

constexpr int NWARP = 4;
constexpr int NTHR = NWARP * 32;
constexpr int MAX_SPLIT = 4096;   // keys a split at most (their pool rows sit in shared memory)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The largest power of two, at most `lanes` (32), that divides n (n > 0).
__host__ __device__ constexpr int pow2_lanes(int n, int lanes = 32) {
  return n % lanes == 0 ? lanes : pow2_lanes(n, lanes / 2);
}

// How a key row of dh elements of KV lies across a warp's lanes: its DH /
// VEC 16-byte loads go to LPK lanes, the largest power of two up to 32
// that divides them, NV loads a lane. A row of up to 512 bytes whose loads
// are a power of two spans DH / VEC lanes, one load each; a wider one (f32
// at dh 256, 1 KB; every type at 512) spans all 32, NV loads each. At dh
// 384 a row is 3 x 2^k loads: 16 lanes of 3 loads (bf16/f16), 32 of 3
// (f32), 8 of 3 (int8). A lane then takes fewer keys a step, so that its
// loads in flight stay at most 4 a buffer; and the wider its slice (EPL),
// the fewer query rows its registers hold (RMAX).
template <typename KV, int DH>
struct Geo {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(KV));  // elements a load
  static constexpr int LPK = pow2_lanes(DH / VEC);  // lanes a key row
  static constexpr int NV = DH / VEC / LPK;   // loads a lane's slice
  static constexpr int EPL = NV * VEC;        // elements of a key row a lane holds
  static constexpr int KPL = 32 / LPK;        // keys a warp-wide load
  static constexpr int U = KPL >= 8 ? 2 : 4 / NV;  // keys of K (and of V) a lane takes a step
  static constexpr int KW = U * KPL;          // keys a warp takes a step
  static constexpr int KB = KW * NWARP;       // keys a block takes a step
  static constexpr int RMAX = EPL > 16 ? 1 : EPL > 8 ? 2 : 4;  // query rows a block at most
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "a key row spans 1 to 32 lanes");
  static_assert(LPK * EPL == DH && U >= 1 && U * NV <= 4, "a lane's slice tiles the row");
};

// NV x 16 bytes of KV -> f32
template <typename KV, int NV, int N>
__device__ __forceinline__ void unpack(const uint4 (&raw)[NV], float (&f)[N]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const KV* e = reinterpret_cast<const KV*>(&raw[v]);
#pragma unroll
    for (int i = 0; i < N / NV; ++i) f[v * (N / NV) + i] = to_f32(e[i]);
  }
}

// Block (split, kv head h, sequence b and row tile): query rows [r0, r0 +
// nrows) of the group against the split's keys [lo, hi), hi clipped to
// seq_lens[b]. part_acc == nullptr: one split, write out; else write the
// partials of query row b * H + hq at (row * n_split + split), m in the
// natural-log domain, acc scaled by the v scale.
template <typename T, typename KV, int DH, int R>
__global__ void __launch_bounds__(NTHR)
paged_split_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                   const KV* __restrict__ vp, const int* __restrict__ pt,
                   const int* __restrict__ seq_lens, const float* __restrict__ ksc_p,
                   const float* __restrict__ vsc_p, T* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l, int H, int Hkv, int ps, int n_pp, int n_pages,
                   int split, float scale_log2) {
  using G = Geo<KV, DH>;
  constexpr int VEC = G::VEC, NV = G::NV, EPL = G::EPL, LPK = G::LPK, KPL = G::KPL,
                U = G::U;
  extern __shared__ int s_row[];            // pool row of each key of the split
  __shared__ float s_acc[NWARP][R][DH];     // the warps' partials, merged at the end
  __shared__ float s_m[NWARP][R];
  __shared__ float s_l[NWARP][R];

  const int si = blockIdx.x, n_split = gridDim.x, h = blockIdx.y;
  const int group = H / Hkv;
  const int n_rt = (group + R - 1) / R;
  const int b = blockIdx.z / n_rt;
  const int r0 = (blockIdx.z % n_rt) * R;
  const int nrows = min(R, group - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = si * split;
  const int top = min(lo + split, n_pp * ps);   // past the split or the table

  // the split's keys as pool rows, one page-table read a key, in flight
  // with the read of the sequence's length
  const int len = seq_lens[b];
  const int* pt_row = pt + static_cast<size_t>(b) * n_pp;
  for (int j = tid; j < top - lo; j += NTHR) {
    const int kpos = lo + j;
    int pid = pt_row[kpos / ps];
    if (pid < 0 || pid >= n_pages) pid = 0;   // never leave the pool
    s_row[j] = pid * ps + kpos % ps;
  }
  const int hi = min(top, len);
  const bool direct = part_acc == nullptr;
  auto out_row = [&](int r) { return static_cast<size_t>(b) * H + h * group + r0 + r; };

  if (lo >= hi) {   // wholly past the sequence: read nothing
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

  // this lane's dims [c, c + EPL) of key group g's rows; its query slice,
  // pre-scaled by scale * k scale * log2(e) (zero past the tile's rows)
  const int c = (lane % LPK) * EPL;
  const int g = lane / LPK;
  const float sl = scale_log2 * (ksc_p ? ksc_p[h] : 1.f);
  const float vsc = vsc_p ? vsc_p[h] : 1.f;
  float qs[R][EPL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qs[r][e] = r < nrows ? to_f32(q[out_row(r) * DH + c + e]) * sl : 0.f;
  __syncthreads();   // s_row visible

  const size_t kv_stride = static_cast<size_t>(Hkv) * DH;   // between pool rows
  const KV* kbase = kp + static_cast<size_t>(h) * DH + c;
  const KV* vbase = vp + static_cast<size_t>(h) * DH + c;
  // key of load j at step t: lo + t * KB + warp * KW + j * KPL + g
  const int wfirst = lo + warp * G::KW;
  auto load = [&](uint4 (&kr)[U][NV], uint4 (&vr)[U][NV], int t) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int kpos = wfirst + t * G::KB + j * KPL + g;
      const size_t off =
          kpos < hi ? static_cast<size_t>(s_row[kpos - lo]) * kv_stride : 0;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (kpos < hi) {
          kr[j][v] = __ldg(reinterpret_cast<const uint4*>(kbase + off + v * VEC));
          vr[j][v] = __ldg(reinterpret_cast<const uint4*>(vbase + off + v * VEC));
        } else {
          kr[j][v] = make_uint4(0u, 0u, 0u, 0u);
          vr[j][v] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };

  float m[R], l[R], acc[R][EPL];   // l: this lane's keys only until the end
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }
  auto compute = [&](const uint4 (&kr)[U][NV], const uint4 (&vr)[U][NV], int t) {
    const int k0 = wfirst + t * G::KB;
    if (k0 >= hi) return;   // no key of this warp's step is live (warp-uniform)
    float s[U][R];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      float kf[EPL];
      unpack<KV>(kr[j], kf);
      const bool live = k0 + j * KPL + g < hi;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qs[r][e], kf[e], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[j][r] = live ? d : NEG_INF;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < U; ++j) mx = fmaxf(mx, s[j][r]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float corr = exp2f(fminf(m[r] - mx, 0.f));
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      float vf[EPL];
      unpack<KV>(vr[j], vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = s[j][r];
        const float p = x <= NEG_INF / 2 ? 0.f : exp2f(x - m[r]);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  };

  // two register buffers: step t + 1's loads are in flight while step t
  // is computed
  const int n_steps = (hi - lo + G::KB - 1) / G::KB;
  uint4 ka[U][NV], va[U][NV], kb[U][NV], vb[U][NV];
  load(ka, va, 0);
  for (int t = 0; t < n_steps; t += 2) {
    if (t + 1 < n_steps) load(kb, vb, t + 1);
    compute(ka, va, t);
    if (t + 1 >= n_steps) break;
    if (t + 2 < n_steps) load(ka, va, t + 2);
    compute(kb, vb, t + 1);
  }

  // sum the warp's key groups (lanes g * LPK + i hold the same dims)
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < EPL; ++e) s_acc[warp][r][c + e] = acc[r][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
  }
  __syncthreads();

  // merge the warps in warp order; emit the output or the split's partial
  for (int i = tid; i < nrows * DH; i += NTHR) {
    const int r = i / DH, d = i % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) M = fmaxf(M, s_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float mw = s_m[w][r];
      const float cw = mw <= NEG_INF / 2 ? 0.f : exp2f(mw - M);
      L += cw * s_l[w][r];
      A += cw * s_acc[w][r][d];
    }
    const size_t orow = out_row(r);
    if (direct) {
      out[orow * DH + d] = from_f32<T>(A * vsc / fmaxf(L, 1e-30f));
    } else {
      part_acc[(orow * n_split + si) * DH + d] = A * vsc;
      if (d == 0) {
        part_m[orow * n_split + si] = M <= NEG_INF / 2 ? NEG_INF : M * LN2;
        part_l[orow * n_split + si] = L;
      }
    }
  }
}

template <typename T, typename KV, int DH, int R>
void launch(const void* q, const void* kp, const void* vp, const void* pt, const void* lens,
            const void* ksc, const void* vsc, void* part, void* out, int B, int H, int Hkv,
            int ps, int n_pp, int n_pages, int split, int n_split, float scale,
            cudaStream_t stream) {
  const size_t n_rows = static_cast<size_t>(B) * H;
  float* acc = n_split > 1 ? static_cast<float*>(part) : nullptr;
  float* m = acc ? acc + n_rows * n_split * DH : nullptr;
  float* l = acc ? m + n_rows * n_split : nullptr;
  const int n_rt = (H / Hkv + R - 1) / R;
  paged_split_kernel<T, KV, DH, R>
      <<<dim3(n_split, Hkv, B * n_rt), NTHR, split * sizeof(int), stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
          static_cast<const int*>(pt), static_cast<const int*>(lens),
          static_cast<const float*>(ksc), static_cast<const float*>(vsc),
          static_cast<T*>(out), acc, m, l, H, Hkv, ps, n_pp, n_pages, split, scale * LOG2E);
  // a refused first pass stays the last error; the entry reports it
  if (!acc || cudaPeekAtLastError() != cudaSuccess) return;
  split_combine_kernel<T, DH><<<static_cast<unsigned>(n_rows), DH, 0, stream>>>(
      acc, m, l, static_cast<T*>(out), n_split);
}

}  // namespace paged_dec

// Rows a block: the group itself up to two (and up to RMAX), else as many
// as the registers hold (Geo::RMAX), the rest in further row tiles.
template <typename T, typename KV, int DH>
struct DecodeLaunch {
  static void run(const void* q, const void* kp, const void* vp, const void* pt,
                  const void* lens, const void* ksc, const void* vsc, void* part, void* out,
                  int B, int H, int Hkv, int ps, int n_pp, int n_pages, int split, int n_split,
                  float scale, cudaStream_t stream) {
    constexpr int RMAX = paged_dec::Geo<KV, DH>::RMAX;
    constexpr int R2 = RMAX < 2 ? RMAX : 2;
    const int group = H / Hkv;
    if (group == 1)
      paged_dec::launch<T, KV, DH, 1>(q, kp, vp, pt, lens, ksc, vsc, part, out, B, H, Hkv, ps,
                                      n_pp, n_pages, split, n_split, scale, stream);
    else if (group == 2)
      paged_dec::launch<T, KV, DH, R2>(q, kp, vp, pt, lens, ksc, vsc, part, out, B, H, Hkv,
                                       ps, n_pp, n_pages, split, n_split, scale, stream);
    else
      paged_dec::launch<T, KV, DH, RMAX>(q, kp, vp, pt, lens, ksc, vsc, part, out, B, H, Hkv,
                                         ps, n_pp, n_pages, split, n_split, scale, stream);
  }
};

// Above 512 (dispatch.cuh's WIDE): block (split, kv head x column block,
// sequence x row tile) of wide_decode_rows over keys [lo, min(lo + split,
// seq_lens[b])).
template <typename T, typename KV>
__global__ void __launch_bounds__(WT)
paged_wide_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                  const KV* __restrict__ vp, const int* __restrict__ pt,
                  const int* __restrict__ seq_lens, const float* __restrict__ ksc,
                  const float* __restrict__ vsc, T* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_m,
                  float* __restrict__ part_l, int H, int Hkv, int dh, int ps, int n_pp,
                  int n_pages, int split, float scale) {
  const int n_cb = dh / DS;
  const int si = blockIdx.x, h = blockIdx.y / n_cb, cb = blockIdx.y % n_cb;
  const int group = H / Hkv;
  const int n_rt = (group + WDR - 1) / WDR;
  const int b = blockIdx.z / n_rt;
  const int r0 = (blockIdx.z % n_rt) * WDR;
  const int len = seq_lens[b];
  const int lo = si * split;
  const int hi = min(min(lo + split, n_pp * ps), len);
  wide_decode_rows<T, KV>(q, kp, vp,
                          PagedRows{pt + static_cast<size_t>(b) * n_pp, n_pp, n_pages, ps},
                          ksc, vsc, out, part_acc, part_m, part_l, si, gridDim.x, b, h, cb, r0,
                          min(WDR, group - r0), H, Hkv, dh, lo, hi, scale);
}

template <typename T, typename KV>
struct DecodeLaunch<T, KV, WIDE> {
  static void run(int dh, const void* q, const void* kp, const void* vp, const void* pt,
                  const void* lens, const void* ksc, const void* vsc, void* part, void* out,
                  int B, int H, int Hkv, int ps, int n_pp, int n_pages, int split, int n_split,
                  float scale, cudaStream_t stream) {
    const size_t n_rows = static_cast<size_t>(B) * H;
    const WideParts parts(n_split > 1 ? part : nullptr, n_rows, n_split, dh);
    const int n_rt = (H / Hkv + WDR - 1) / WDR;
    paged_wide_kernel<T, KV><<<dim3(n_split, Hkv * (dh / DS), B * n_rt), WT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
        static_cast<const int*>(pt), static_cast<const int*>(lens),
        static_cast<const float*>(ksc), static_cast<const float*>(vsc), static_cast<T*>(out),
        parts.acc, parts.m, parts.l, H, Hkv, dh, ps, n_pp, n_pages, split, scale);
    parts.combine<T>(out, n_rows, n_split, dh, stream);
  }
};

}  // namespace repro_paged

// q, out: (B, H, dh); k/v pages: (n_pages, ps, Hkv, dh); page_table:
// (B, n_pp) int32; seq_lens: (B,) int32; k/v scales: (Hkv,) f32 or null.
// split: keys a split (1 to 4096), n_split splits covering n_pp * ps keys;
// part: f32 scratch of B * H * n_split * (dh + 2) elements when n_split >
// 1, else unused. Returns cudaGetLastError() after the launches (the
// combine is not launched if the first pass is refused), or -1 for an
// unsupported dtype, width or split.
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* page_table, const void* seq_lens,
                                      const void* k_scale, const void* v_scale, void* part,
                                      void* out, int B, int H, int Hkv, int dh, int ps, int n_pp,
                                      int n_pages, int split, int n_split, int q_dtype,
                                      int kv_dtype, float scale, void* stream) {
  using namespace repro_paged;
  if (split < 1 || split > paged_dec::MAX_SPLIT || n_split < 1 ||
      static_cast<long long>(split) * n_split < static_cast<long long>(n_pp) * ps ||
      (n_split > 1 && part == nullptr))
    return UNSUPPORTED;
  return dispatch<DecodeLaunch>(dh, q_dtype, kv_dtype, q, kp, vp, page_table, seq_lens,
                                k_scale, v_scale, part, out, B, H, Hkv, ps, n_pp, n_pages,
                                split, n_split, scale, static_cast<cudaStream_t>(stream));
}
