// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention (_paged_kernel): one query token per sequence
// against a page-table-indirected KV pool, the GQA group of H/Hkv query
// rows per kv head, pages with pi * ps >= seq_lens[b] skipped and positions
// >= seq_lens[b] masked.
//
// What bounds it on this card: the KV bytes. A decode step reads each
// sequence's whole cache for one query row per head (about one FMA per
// byte), far below the ~295 operations per byte the H100 needs before
// arithmetic is the limit. The design reads every KV element once per
// (sequence, kv head) block, stages it in shared memory with 16-byte
// vector loads and reuses it for the whole GQA group; the Pallas grid's
// sequential page axis becomes a loop inside the block.
//
// Known limit, recorded rather than fixed here: the grid is B * Hkv blocks
// (64 at the GQA path's width), fewer than the card's 132 SMs, and each
// block walks its pages one tile at a time. Split-K over pages
// (flash-decoding) with wgmma is the planned redesign.
#include "dispatch.cuh"

namespace repro_paged {

template <typename T, typename KV, int DH>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ seq_lens, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, T* __restrict__ out, int H, int Hkv,
                    int ps, int n_pp, int n_pages, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int group = H / Hkv;
  const int r0 = blockIdx.z * MAX_ROWS;
  const int nrows = min(MAX_ROWS, group - r0);
  const int len = seq_lens[b];
  // a decode query is a one-position chunk at position len - 1 whose rows
  // all see keys < len
  attend_rows<T, KV, DH>(q, kp, vp, pt, ksc, vsc, out, b, h, r0, nrows, /*C=*/1, H, Hkv,
                         ps, n_pp, n_pages, /*start=*/len - 1, /*n_valid=*/len, scale);
}

template <typename T, typename KV, int DH>
struct DecodeLaunch {
  static void run(const void* q, const void* kp, const void* vp, const void* pt,
                  const void* lens, const void* ksc, const void* vsc, void* out, int B,
                  int H, int Hkv, int ps, int n_pp, int n_pages, float scale,
                  cudaStream_t stream) {
    const int group = H / Hkv;
    dim3 grid(Hkv, B, (group + MAX_ROWS - 1) / MAX_ROWS);
    paged_decode_kernel<T, KV, DH><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
        static_cast<const int*>(pt), static_cast<const int*>(lens),
        static_cast<const float*>(ksc), static_cast<const float*>(vsc),
        static_cast<T*>(out), H, Hkv, ps, n_pp, n_pages, scale);
  }
};

}  // namespace repro_paged

// q, out: (B, H, dh); k/v pages: (n_pages, ps, Hkv, dh); page_table:
// (B, n_pp) int32; seq_lens: (B,) int32; k/v scales: (Hkv,) f32 or null.
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// dtype/width.
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* page_table, const void* seq_lens,
                                      const void* k_scale, const void* v_scale, void* out,
                                      int B, int H, int Hkv, int dh, int ps, int n_pp,
                                      int n_pages, int q_dtype, int kv_dtype, float scale,
                                      void* stream) {
  return repro_paged::dispatch<repro_paged::DecodeLaunch>(
      dh, q_dtype, kv_dtype, q, kp, vp, page_table, seq_lens, k_scale, v_scale, out, B, H,
      Hkv, ps, n_pp, n_pages, scale, static_cast<cudaStream_t>(stream));
}
