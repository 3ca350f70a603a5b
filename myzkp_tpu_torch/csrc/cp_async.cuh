// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), as the bucket scan (bucket_scan.cu) stages its
// point rows, K14 (rows.cu) its gathered rows and K6's four-word instance
// (ntt.cu) its next tile.  A copy is issued by one
// thread, lands without passing through its registers, and is waited for by
// groups: commit closes a group, wait<k> returns once at most k of this
// thread's groups are in flight.  A host rehearsal (g++, MYZKP_HOST_REHEARSAL
// defined) copies at once with memcpy.
#pragma once

#include <cstdint>

#if !defined(__CUDA_ARCH__) && defined(MYZKP_HOST_REHEARSAL)
#include <cstring>
#endif

namespace myzkp {

#if defined(__CUDA_ARCH__) || !defined(MYZKP_HOST_REHEARSAL)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

// A 4-byte copy (cp.async.ca: the sizes below 16 go through L1), for rows
// whose 16-byte pieces do not line up.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
#else
inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async4(void* dst, const void* src) { std::memcpy(dst, src, 4); }
inline void cp_async_commit() {}
template <int kPending>
inline void cp_async_wait() {}
#endif

}  // namespace myzkp
