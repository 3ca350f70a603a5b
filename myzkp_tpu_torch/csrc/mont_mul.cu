// K1: elementwise Montgomery multiply a * b * R^-1 mod p over (16, n) limb
// planes.
//
// Replaces limb_pallas.mont_mul_pallas (myzkp_tpu/fields/limb_pallas.py:286,
// kernel body _make_kernel :42), which ran the same product on (32, 128)
// VMEM tiles.
//
// Bound on the H100: device memory.  An element moves 192 bytes (two inputs
// and one output of 16 int32 limbs each, twice the packed size because the
// interface keeps one 16-bit limb per int32) against ~130 32x32->64-bit
// multiply-adds.  Design: one thread per element; thread i reads column i
// of every limb plane, so each warp's loads and stores are 128-byte
// coalesced, and the whole CIOS product stays in registers (field.cuh).
#include <cuda_runtime.h>

#include "field.cuh"

using myzkp::Fe;
using myzkp::FieldConsts;

namespace {

__global__ void __launch_bounds__(256)
    mont_mul_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    int64_t n, FieldConsts c) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = myzkp::load_planes(a, n, i);
  Fe y = myzkp::load_planes(b, n, i);
  myzkp::store_planes(out, n, i, myzkp::fe_mul(x, y, c));
}

}  // namespace

extern "C" int myzkp_mont_mul(const int32_t* a, const int32_t* b,
                              int32_t* out, int64_t n,
                              const FieldConsts* consts, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  mont_mul_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, b, out, n,
                                                         *consts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* myzkp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
