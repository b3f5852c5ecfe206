// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel): blocked online-softmax GQA attention of q (B, S, H, dh) over
// k/v (B, S, Hkv, dh), query head hq reading kv head hq / group, causal
// (query position c sees keys <= c) or full. It is the static engine's
// prefill attention (every layer of every prompt wave).
//
// What bounds it on this card: at a 512-token prompt the work is about
// S/2 (causal) FMAs per KV element per query head, so against the
// tensor-core peak a bf16 call is byte bound (a few microseconds); this
// kernel's f32 FMA dots out of shared memory are its practical limit.
// Design: rows are (position, head-in-group) pairs of one (sequence, kv
// head), MAX_ROWS of them a block, so a group of 8 puts 2 positions of all
// 8 query heads in one tile and every staged K/V tile serves the whole
// group. The causal rule of the Pallas kernel (skip KV blocks strictly
// above the diagonal) holds at tile granularity: a row tile walks keys
// only up to its last row's position, and each row masks its own
// frontier. Unlike the Pallas wrapper, which needs S and L to be
// multiples of its blocks, any S == L is taken: the last row tile is
// short and keys at or past L are zero-filled, not loaded. mma/wgmma tiles
// are the planned redesign.
#include "dispatch.cuh"

namespace repro_paged {

template <typename T, typename KV, int DH>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
             T* __restrict__ out, int S, int H, int Hkv, int causal, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int rows = S * (H / Hkv);
  const int r0 = blockIdx.z * MAX_ROWS;
  const int nrows = min(MAX_ROWS, rows - r0);
  // causal: the prompt is a chunk at start 0 (row c sees keys < c + 1);
  // full: start S puts every row's causal frontier past the keys, so
  // n_valid = S binds for all
  attend_rows<T, KV, DH>(q, k, v, DenseRows{static_cast<long long>(b) * S, S}, nullptr,
                         nullptr, out, b, h, r0, nrows, /*C=*/S, H, Hkv,
                         /*start=*/causal ? 0 : S, /*n_valid=*/S, scale);
}

template <typename T, typename KV, int DH>
struct FlashLaunch {
  static void run(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                  int Hkv, int causal, float scale, cudaStream_t stream) {
    const int rows = S * (H / Hkv);
    dim3 grid(Hkv, B, (rows + MAX_ROWS - 1) / MAX_ROWS);
    flash_kernel<T, KV, DH><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
        static_cast<T*>(out), S, H, Hkv, causal, scale);
  }
};

}  // namespace repro_paged

// q, out: (B, S, H, dh); k, v: (B, S, Hkv, dh), all of one dtype; causal:
// 0 or 1. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported dtype/width.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int S, int H, int Hkv, int dh, int dtype, int causal,
                               float scale, void* stream) {
  return repro_paged::dispatch_same<repro_paged::FlashLaunch>(
      dh, dtype, q, k, v, out, B, S, H, Hkv, causal, scale, static_cast<cudaStream_t>(stream));
}
