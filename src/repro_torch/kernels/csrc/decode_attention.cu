// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_kernel): one query token per sequence against a dense
// (B, L, Hkv, dh) KV cache, the GQA group of H/Hkv consecutive query heads
// per kv head, positions >= kv_valid[b] masked and never read. It is the
// static engine's decode attention (every layer of every micro-step, at
// kv_valid = pos + 1).
//
// What bounds it on this card: the KV bytes. A decode step reads each
// sequence's valid cache once for one query row per head (about one FMA
// per byte), far below the ~295 operations per byte the H100 needs before
// arithmetic is the limit. The design is the paged decode kernel's with a
// dense row policy: every valid KV element is read once per (sequence, kv
// head) block, staged in shared memory with 16-byte vector loads (int8
// dequantized by its kv head's scale as it is staged) and reused for the
// whole GQA group; the Pallas grid's sequential KV axis becomes a loop
// inside the block. Unlike the TPU kernel, which pads L to a multiple of
// its 512-key block, any L is taken: keys at or past min(kv_valid[b], L)
// are zero-filled in shared memory, not loaded.
//
// Known limit, recorded rather than fixed here: the grid is B * Hkv blocks
// (8 at qwen2.5-3b's width with a batch of 4) on 132 SMs, each walking its
// keys serially. Split-K over the cache (flash-decoding) with wgmma is the
// planned redesign.
#include "dispatch.cuh"

namespace repro_paged {

template <typename T, typename KV, int DH>
__global__ void __launch_bounds__(NT)
dense_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                    const KV* __restrict__ vc, const int* __restrict__ kv_valid,
                    const float* __restrict__ ksc, const float* __restrict__ vsc,
                    T* __restrict__ out, int H, int Hkv, int L, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int group = H / Hkv;
  const int r0 = blockIdx.z * MAX_ROWS;
  const int nrows = min(MAX_ROWS, group - r0);
  const int valid = min(kv_valid[b], L);
  // a one-position chunk at position valid - 1 whose rows all see keys
  // < valid (none when valid <= 0: the output is then 0)
  attend_rows<T, KV, DH>(q, kc, vc, DenseRows{static_cast<long long>(b) * L, L}, ksc, vsc,
                         out, b, h, r0, nrows, /*C=*/1, H, Hkv, /*start=*/valid - 1,
                         /*n_valid=*/valid, scale);
}

template <typename T, typename KV, int DH>
struct DenseDecodeLaunch {
  static void run(const void* q, const void* kc, const void* vc, const void* kv_valid,
                  const void* ksc, const void* vsc, void* out, int B, int H, int Hkv, int L,
                  float scale, cudaStream_t stream) {
    const int group = H / Hkv;
    dim3 grid(Hkv, B, (group + MAX_ROWS - 1) / MAX_ROWS);
    dense_decode_kernel<T, KV, DH><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(kc), static_cast<const KV*>(vc),
        static_cast<const int*>(kv_valid), static_cast<const float*>(ksc),
        static_cast<const float*>(vsc), static_cast<T*>(out), H, Hkv, L, scale);
  }
};

}  // namespace repro_paged

// q, out: (B, H, dh); k/v caches: (B, L, Hkv, dh); kv_valid: (B,) int32;
// k/v scales: (Hkv,) f32 or null. Returns cudaGetLastError() after the
// launch, or -1 for an unsupported dtype/width.
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* kv_valid, const void* k_scale,
                                const void* v_scale, void* out, int B, int H, int Hkv, int dh,
                                int L, int q_dtype, int kv_dtype, float scale, void* stream) {
  return repro_paged::dispatch<repro_paged::DenseDecodeLaunch>(
      dh, q_dtype, kv_dtype, q, k_cache, v_cache, kv_valid, k_scale, v_scale, out, B, H, Hkv,
      L, scale, static_cast<cudaStream_t>(stream));
}
