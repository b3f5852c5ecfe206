// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_kernel): one query token per sequence against a dense
// (B, L, Hkv, dh) KV cache, the GQA group of H/Hkv consecutive query heads
// per kv head, positions >= kv_valid[b] masked and never read. It is the
// static engine's decode attention (every layer of every micro-step, at
// kv_valid = pos + 1).
//
// What bounds it on this card: the KV bytes, about 1.1 MB (0.3 us) at the
// static path's B=4, L=545, Hkv=2, dh=128: a decode step reads each
// sequence's valid cache once for one query row per head (about one FMA
// per byte), far below the ~295 operations per byte the H100 needs before
// arithmetic is the limit. What held the earlier design back was the grid:
// B * Hkv = 8 blocks on 132 SMs, each walking its keys serially.
//
// Design: split-K (flash-decoding, split_decode.cuh) over the dense row
// policy. Pass 1 runs a grid of (n_split, Hkv, B) blocks; each reads its
// split of `split` keys, clipped to min(kv_valid[b], L), once, with 16-byte
// loads (int8 dequantized by its kv head's scale), for the whole GQA
// group, and writes f32 partials (m, l, acc). Pass 2 combines the splits
// in a fixed order. The split size is a function of the shapes and the SM
// count only (kernels/decode_attention.py, decode_split: about two blocks
// an SM, at most 128 keys a split), never of kv_valid, so the host never
// reads the device. The dots stay f32 FMA for every dtype: a group of 8
// rows against a split is a few FLOP a byte. Any L is taken, as in the
// earlier design.
//
// Head widths 64, 128, 256 (paligemma-3b's, gemma3-1b's), 384 and 512; a
// pass-1 block stages TK = 4096 / dh keys a tile (16 at 256, 10 at 384, 8
// at 512) and takes FmaRows query rows at a time (8 at 256 and 384, 4 at
// 512: paged_attention.cuh), and the combine runs dh threads a block.
#include "dispatch.cuh"
#include "split_decode.cuh"

namespace repro_paged {

template <typename T, typename KV, int DH>
__global__ void __launch_bounds__(NT)
dense_split_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                   const KV* __restrict__ vc, const int* __restrict__ kv_valid,
                   const float* __restrict__ ksc, const float* __restrict__ vsc,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l, int H, int Hkv, int L, int split,
                   float scale) {
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lo = s * split;
  const int hi = min(lo + split, min(kv_valid[b], L));
  split_partial<T, KV, DH>(q, kc, vc, DenseRows{static_cast<long long>(b) * L, L}, ksc, vsc,
                           part_acc, part_m, part_l, b, h, s, gridDim.x, H, Hkv, lo, hi,
                           scale);
}

template <typename T, typename KV, int DH>
struct DenseDecodeLaunch {
  static void run(const void* q, const void* kc, const void* vc, const void* kv_valid,
                  const void* ksc, const void* vsc, void* part, void* out, int B, int H,
                  int Hkv, int L, int split, int n_split, float scale, cudaStream_t stream) {
    float* acc = static_cast<float*>(part);
    float* m = acc + static_cast<size_t>(B) * H * n_split * DH;
    float* l = m + static_cast<size_t>(B) * H * n_split;
    dense_split_kernel<T, KV, DH><<<dim3(n_split, Hkv, B), NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(kc), static_cast<const KV*>(vc),
        static_cast<const int*>(kv_valid), static_cast<const float*>(ksc),
        static_cast<const float*>(vsc), acc, m, l, H, Hkv, L, split, scale);
    // a refused first pass stays the last error; the entry reports it
    if (cudaPeekAtLastError() != cudaSuccess) return;
    split_combine_kernel<T, DH><<<B * H, DH, 0, stream>>>(acc, m, l, static_cast<T*>(out),
                                                          n_split);
  }
};

}  // namespace repro_paged

// q, out: (B, H, dh); k/v caches: (B, L, Hkv, dh); kv_valid: (B,) int32;
// dh: 64, 128, 256, 384 or 512; k/v scales: (Hkv,) f32 or null; part: f32 scratch of
// B * H * n_split * (dh + 2) elements; split: keys a split (>= 1), n_split:
// ceil(L / split) (>= 1). Returns cudaGetLastError() after the two
// launches (the second is not made if the first is refused), or -1 for an
// unsupported dtype/width.
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* kv_valid, const void* k_scale,
                                const void* v_scale, void* part, void* out, int B, int H,
                                int Hkv, int dh, int L, int split, int n_split, int q_dtype,
                                int kv_dtype, float scale, void* stream) {
  return repro_paged::dispatch<repro_paged::DenseDecodeLaunch>(
      dh, q_dtype, kv_dtype, q, k_cache, v_cache, kv_valid, k_scale, v_scale, part, out, B, H,
      Hkv, L, split, n_split, scale, static_cast<cudaStream_t>(stream));
}
