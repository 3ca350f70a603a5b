// K17: polynomial long division a = q b + r over limb planes, one launch a
// batch of rows.
//
// Replaces the reference's long division (myzkp_tpu/ops/poly.py:229-261,
// _divmod_kernel: a lax.scan of na - bd steps, each one Montgomery product
// and one subtraction on a bd-wide window, jit-compiled onto the device),
// which the port had run as na - bd steps of several launches each from the
// host: the STARK's remainder tree (ops/ntt.py _fast_evaluate_pow2) divides
// two 2^16-coefficient residues by 2^15-degree nodes, 32,768 steps, and its
// boundary quotient 65,536 coefficients by a quadratic.  Same steps, same
// order, so the same q and r: step k takes pos = na - 1 - k, c = rem[pos] *
// inv(b[bd]) (the wrapper passes the inverse; inv(0) = 0 gives q = 0 and r
// = a's low bd coefficients, as the reference), q[pos - bd] = c and
// rem[pos - bd + j] -= c b[j] for j < bd.
//
// Bound on the H100: the steps are sequential, so a row is bound by the
// latency of a step (the product for c, the window's products, one barrier)
// times na - bd; the work, (na - bd)(bd + 1) products a row, bounds the
// card only where many rows run side by side.  Design: a row on a cluster
// of C thread blocks (C = 1 to 8, as many as its window needs at one or a
// few elements a thread), element j of the window on thread j mod (C T);
// rem is a word-packed copy of the row in the wrapper's scratch (16 bytes an
// element at four words), filled from a by the cluster before the first
// step, read and written through L2 (__ldcg / __stcg: another block of the
// cluster wrote it the step before) with one cluster barrier a step
// (barrier.cluster's release and acquire order those accesses); b is read
// through the read-only path and stays in L1.  Every thread computes the
// step's c from rem[pos] (one product, no extra barrier).  Blocks are 1024
// threads at four words (M128), 512 at eight (BN254, on no path).  Measured
// at the STARK's shapes in PERF.md (chip_smoke.py, profile_paths.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"

namespace cg = cooperative_groups;
using myzkp::FeN;
using myzkp::FieldConsts;
using myzkp::FieldConstsN;

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size

template <int N>
constexpr int div_threads() {
  return N == myzkp::kWords ? 512 : 1024;
}

// Element i of a word-packed row: N words at w[N i], through L2.
template <int N>
__device__ __forceinline__ FeN<N> load_words(const uint32_t* w, int64_t i) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(w + N * i + k));
    r.w[k] = v.x;
    r.w[k + 1] = v.y;
    r.w[k + 2] = v.z;
    r.w[k + 3] = v.w;
  }
  return r;
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* w, int64_t i, const FeN<N>& a) {
#pragma unroll
  for (int k = 0; k < N; k += 4)
    __stcg(reinterpret_cast<uint4*>(w + N * i + k),
           make_uint4(a.w[k], a.w[k + 1], a.w[k + 2], a.w[k + 3]));
}

template <int N>
__device__ __forceinline__ void long_division_body(
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    const int32_t* __restrict__ lead, int32_t* __restrict__ q, int32_t* __restrict__ r,
    uint32_t* work, int64_t rows, int64_t na, int64_t bd, const FieldConstsN<N>& c) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int64_t C = cluster.num_blocks();
  const int64_t row = blockIdx.x / C;
  const int64_t tid = cluster.block_rank() * blockDim.x + threadIdx.x;
  const int64_t nt = C * blockDim.x;
  const int64_t steps = na - bd;
  const int64_t pa = rows * na, pb = rows * (bd + 1), pq = rows * steps, pr = rows * bd;
  uint32_t* rem = work + row * na * N;
  for (int64_t k = tid; k < na; k += nt)
    store_words(rem, k, myzkp::load_planes<N>(a, pa, row * na + k));
  const FeN<N> inv = myzkp::load_planes<N>(lead, rows, row);
  cluster.sync();
#pragma unroll 1
  for (int64_t pos = na - 1; pos >= bd; --pos) {
    const FeN<N> cq = myzkp::fe_mul_cc(load_words<N>(rem, pos), inv, c);
    if (tid == 0) myzkp::store_planes(q, pq, row * steps + pos - bd, cq);
#pragma unroll 4
    for (int64_t j = tid; j < bd; j += nt) {
      const int64_t x = pos - bd + j;
      const FeN<N> t =
          myzkp::fe_mul_cc(cq, myzkp::load_planes<N>(b, pb, row * (bd + 1) + j), c);
      store_words(rem, x, myzkp::fe_sub_cc(load_words<N>(rem, x), t, c));
    }
    cluster.sync();
  }
  for (int64_t j = tid; j < bd; j += nt)
    myzkp::store_planes(r, pr, row * bd + j, load_words<N>(rem, j));
}

__global__ void __launch_bounds__(div_threads<8>())
    long_division_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                         const int32_t* __restrict__ lead, int32_t* __restrict__ q,
                         int32_t* __restrict__ r, uint32_t* work, int64_t rows, int64_t na,
                         int64_t bd, FieldConsts c) {
  long_division_body<8>(a, b, lead, q, r, work, rows, na, bd, c);
}

__global__ void __launch_bounds__(div_threads<4>())
    long_division_l8_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                            const int32_t* __restrict__ lead, int32_t* __restrict__ q,
                            int32_t* __restrict__ r, uint32_t* work, int64_t rows,
                            int64_t na, int64_t bd, FieldConstsN<4> c) {
  long_division_body<4>(a, b, lead, q, r, work, rows, na, bd, c);
}

// Threads a block (a power of two from 32 to div_threads, not past bd) and
// blocks a cluster (a power of two up to kMaxCluster, enough for one window
// element a thread where the cluster allows it) of a row with window bd.
template <int N>
void division_shape(int64_t bd, int* threads, int* cluster) {
  int t = 32;
  while (t < div_threads<N>() && t < bd) t *= 2;
  int k = 1;
  while (k < kMaxCluster && int64_t{k} * t < bd) k *= 2;
  *threads = t;
  *cluster = k;
}

template <int N, class Kernel>
int launch_long_division(Kernel kernel, const int32_t* a, const int32_t* b,
                         const int32_t* lead, int32_t* q, int32_t* r, uint32_t* work,
                         int64_t rows, int64_t na, int64_t bd, const FieldConstsN<N>& c,
                         void* stream) {
  int threads, cluster;
  division_shape<N>(bd, &threads, &cluster);
  if (rows < 1 || bd < 1 || na <= bd || rows * cluster > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster));
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, b, lead, q, r, work, rows,
                                             na, bd, c);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// a (2N, rows, na), b (2N, rows, bd + 1), lead (2N, rows) = inv(b[..., bd]);
// out q (2N, rows, na - bd) and r (2N, rows, bd); work: the scratch of
// rows * na * N words.  2N = 16 limbs (BN254) or 8 (M128, the _l8 entry
// point); 1 <= bd < na.
extern "C" int myzkp_long_division(const int32_t* a, const int32_t* b,
                                   const int32_t* lead, int32_t* q, int32_t* r,
                                   uint32_t* work, int64_t rows, int64_t na, int64_t bd,
                                   const FieldConsts* consts, void* stream) {
  return launch_long_division(long_division_kernel, a, b, lead, q, r, work, rows, na, bd,
                              *consts, stream);
}

extern "C" int myzkp_long_division_l8(const int32_t* a, const int32_t* b,
                                      const int32_t* lead, int32_t* q, int32_t* r,
                                      uint32_t* work, int64_t rows, int64_t na, int64_t bd,
                                      const FieldConstsN<4>* consts, void* stream) {
  return launch_long_division(long_division_l8_kernel, a, b, lead, q, r, work, rows, na,
                              bd, *consts, stream);
}
