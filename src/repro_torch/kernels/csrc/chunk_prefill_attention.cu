// Chunked-prefill attention over the paged KV pool for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// chunk_prefill_attention (_chunk_kernel): a (B, C) query chunk at absolute
// positions [start_b, start_b + C) against the pool, which already holds
// the chunk's own KV. Rows are ordered (position, head-in-group); row r
// attends key positions < min(start_b + r / group + 1, n_valid_b), and
// pages past the chunk's last attendable position are skipped.
//
// What bounds it on this card: at the path's chunk of 64 positions the
// kernel does about 64 * group FMAs per KV element in f32 on CUDA cores, so
// a bf16 pool is still memory bound against the tensor-core peak, while the
// f32-accumulating FMA loop itself is the practical limit. The design gives
// each block a tile of 16 rows of one (sequence, kv head), stages each
// key tile once in shared memory for all of the tile's rows, and lets each
// row tile stop at its own causal frontier (earlier row tiles read fewer
// pages). mma/wgmma on the tiles is the planned redesign.
//
// start is a (B,) tensor (the prefill wrapper broadcasts a scalar). The
// speculative-verify window is this kernel too (spec_verify_attention in
// decode_attention.py, replacing repro/kernels/decode_attention.py::
// spec_verify_attention): start = seq_lens, n_valid = seq_lens + n_fed,
// C = spec_k + 1 or less, so a block may hold as few as one row; rows past
// a sequence's fed window (n_fed <= r / group) see exactly the last fed
// row's frontier through the min() with n_valid.
#include "dispatch.cuh"

namespace repro_paged {

template <typename T, typename KV, int DH>
__global__ void __launch_bounds__(NT)
chunk_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                     const KV* __restrict__ vp, const int* __restrict__ pt,
                     const int* __restrict__ start, const int* __restrict__ n_valid,
                     const float* __restrict__ ksc, const float* __restrict__ vsc,
                     T* __restrict__ out, int C, int H, int Hkv, int ps, int n_pp,
                     int n_pages, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int rows = C * (H / Hkv);
  const int r0 = blockIdx.z * MAX_ROWS;
  const int nrows = min(MAX_ROWS, rows - r0);
  attend_rows<T, KV, DH>(q, kp, vp, PagedRows{pt + static_cast<size_t>(b) * n_pp, n_pp,
                                              n_pages, ps},
                         ksc, vsc, out, b, h, r0, nrows, C, H, Hkv, start[b], n_valid[b],
                         scale);
}

template <typename T, typename KV, int DH>
struct ChunkLaunch {
  static void run(const void* q, const void* kp, const void* vp, const void* pt,
                  const void* start, const void* n_valid, const void* ksc, const void* vsc,
                  void* out, int B, int C, int H, int Hkv, int ps, int n_pp, int n_pages,
                  float scale, cudaStream_t stream) {
    const int rows = C * (H / Hkv);
    dim3 grid(Hkv, B, (rows + MAX_ROWS - 1) / MAX_ROWS);
    chunk_prefill_kernel<T, KV, DH><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
        static_cast<const int*>(pt), static_cast<const int*>(start),
        static_cast<const int*>(n_valid), static_cast<const float*>(ksc),
        static_cast<const float*>(vsc), static_cast<T*>(out), C, H, Hkv, ps, n_pp, n_pages,
        scale);
  }
};

}  // namespace repro_paged

// q, out: (B, C, H, dh); k/v pages: (n_pages, ps, Hkv, dh); page_table:
// (B, n_pp) int32; start, n_valid: (B,) int32; k/v scales: (Hkv,) f32 or
// null. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported dtype/width.
extern "C" int chunk_prefill_attention(const void* q, const void* kp, const void* vp,
                                       const void* page_table, const void* start,
                                       const void* n_valid, const void* k_scale,
                                       const void* v_scale, void* out, int B, int C, int H,
                                       int Hkv, int dh, int ps, int n_pp, int n_pages,
                                       int q_dtype, int kv_dtype, float scale, void* stream) {
  return repro_paged::dispatch<repro_paged::ChunkLaunch>(
      dh, q_dtype, kv_dtype, q, kp, vp, page_table, start, n_valid, k_scale, v_scale, out, B,
      C, H, Hkv, ps, n_pp, n_pages, scale, static_cast<cudaStream_t>(stream));
}
