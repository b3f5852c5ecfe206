// Type/width dispatch shared by the attention entry points: the wrapper
// passes dtype codes (repro_paged::DType) and the head width (64, 128,
// 256, 384 or 512), and Launch<T, KV, DH>::run is instantiated for every supported
// combination (dispatch: any query type against any K/V type, twelve
// pairs a width; dispatch_same: K/V of the query's type).
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

template <template <typename, typename, int> class Launch, int DH, typename... A>
int by_same(int dtype, A... args) {
  switch (dtype) {
    case F32: Launch<float, float, DH>::run(args...); return 0;
    case BF16: Launch<__nv_bfloat16, __nv_bfloat16, DH>::run(args...); return 0;
    case F16: Launch<__half, __half, DH>::run(args...); return 0;
    default: return UNSUPPORTED;
  }
}

// rc of the dispatch, else cudaGetLastError() after the launch
inline int launch_status(int rc) {
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

template <template <typename, typename, int> class Launch, typename... A>
int dispatch(int dh, int q_dtype, int kv_dtype, A... args) {
  switch (dh) {
    case 64: return launch_status(by_query<Launch, 64>(q_dtype, kv_dtype, args...));
    case 128: return launch_status(by_query<Launch, 128>(q_dtype, kv_dtype, args...));
    case 256: return launch_status(by_query<Launch, 256>(q_dtype, kv_dtype, args...));
    case 384: return launch_status(by_query<Launch, 384>(q_dtype, kv_dtype, args...));
    case 512: return launch_status(by_query<Launch, 512>(q_dtype, kv_dtype, args...));
    default: return UNSUPPORTED;
  }
}

template <template <typename, typename, int> class Launch, typename... A>
int dispatch_same(int dh, int dtype, A... args) {
  switch (dh) {
    case 64: return launch_status(by_same<Launch, 64>(dtype, args...));
    case 128: return launch_status(by_same<Launch, 128>(dtype, args...));
    case 256: return launch_status(by_same<Launch, 256>(dtype, args...));
    case 384: return launch_status(by_same<Launch, 384>(dtype, args...));
    case 512: return launch_status(by_same<Launch, 512>(dtype, args...));
    default: return UNSUPPORTED;
  }
}

}  // namespace repro_paged
