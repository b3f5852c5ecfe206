// Type/width dispatch shared by the two paged-attention entry points: the
// wrapper passes dtype codes (repro_paged::DType) and the head width, and
// Launch<T, KV, DH>::run is instantiated for every supported combination.
#pragma once

#include "paged_attention.cuh"

namespace repro_paged {

// Returned by an entry point for a dtype/width it was not built for (the
// Python wrapper checks first, so this is a guard, not a code path).
constexpr int UNSUPPORTED = -1;

template <template <typename, typename, int> class Launch, typename T, int DH, typename... A>
int by_pool(int kv_dtype, A... args) {
  switch (kv_dtype) {
    case F32: Launch<T, float, DH>::run(args...); return 0;
    case BF16: Launch<T, __nv_bfloat16, DH>::run(args...); return 0;
    case F16: Launch<T, __half, DH>::run(args...); return 0;
    case I8: Launch<T, int8_t, DH>::run(args...); return 0;
    default: return UNSUPPORTED;
  }
}

template <template <typename, typename, int> class Launch, int DH, typename... A>
int by_query(int q_dtype, int kv_dtype, A... args) {
  switch (q_dtype) {
    case F32: return by_pool<Launch, float, DH>(kv_dtype, args...);
    case BF16: return by_pool<Launch, __nv_bfloat16, DH>(kv_dtype, args...);
    case F16: return by_pool<Launch, __half, DH>(kv_dtype, args...);
    default: return UNSUPPORTED;
  }
}

template <template <typename, typename, int> class Launch, typename... A>
int dispatch(int dh, int q_dtype, int kv_dtype, A... args) {
  int rc;
  switch (dh) {
    case 64: rc = by_query<Launch, 64>(q_dtype, kv_dtype, args...); break;
    case 128: rc = by_query<Launch, 128>(q_dtype, kv_dtype, args...); break;
    default: return UNSUPPORTED;
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_paged
