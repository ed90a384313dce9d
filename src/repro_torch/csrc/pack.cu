// pack_threshold: fused threshold-binarize + LSB-first bit-pack.
//
// Replaces the TPU kernel src/repro/kernels/pack/kernel.py pack_threshold
// (_kernel): bits = x >= theta, 32 per word along the last axis, zero pad
// bits.  Here x may be up to 4-D with any strides (a permuted view is read
// in place) and theta is broadcast against x through its own strides (0 on
// broadcast axes), so one kernel serves a per-column, per-head or per-row
// threshold.
//
// Bound on the H100: bytes.  At the main-path prefill shape (x (1024, 576)
// bf16, one threshold) it reads 1.18 MB and writes 74 KB and does one
// compare per value, far below the compute line.  Design: one warp per
// output word; lane i reads value 32*w + i (neighbouring lanes read
// neighbouring addresses when the last axis is contiguous), compares, and
// __ballot_sync puts lane i into bit i, which is the LSB-first order, so
// the word is written once and no bit is ever shuffled through memory.
#include "common.cuh"

namespace {

__device__ __forceinline__ bool ge(__nv_bfloat16 x, float t) {
  return __bfloat162float(x) >= t;
}
__device__ __forceinline__ bool ge(float x, float t) { return x >= t; }
__device__ __forceinline__ bool ge(int32_t x, int32_t t) { return x >= t; }

struct Dims4 {
  long long n0, n1, n2, len;       // rows n0*n1*n2, each of len values
  long long xs0, xs1, xs2, xsc;    // element strides of x
  long long ts0, ts1, ts2, tsc;    // element strides of theta (0 = bcast)
};

constexpr int kWarps = 8;

template <typename T, typename TT>
__global__ void __launch_bounds__(kWarps * 32)
    pack_threshold_kernel(const T* __restrict__ x,
                          const TT* __restrict__ theta, Dims4 d,
                          long long words_per_row, long long total_words,
                          int32_t* __restrict__ out) {
  const long long gw =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (gw >= total_words) return;  // whole warp leaves together
  const long long r = gw / words_per_row;
  const long long w = gw % words_per_row;
  const long long i2 = r % d.n2;
  const long long i1 = (r / d.n2) % d.n1;
  const long long i0 = r / (d.n2 * d.n1);
  const long long c = w * 32 + lane;
  bool bit = false;
  if (c < d.len) {
    const T xv = x[i0 * d.xs0 + i1 * d.xs1 + i2 * d.xs2 + c * d.xsc];
    const TT tv = theta[i0 * d.ts0 + i1 * d.ts1 + i2 * d.ts2 + c * d.tsc];
    bit = ge(xv, tv);
  }
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[gw] = static_cast<int32_t>(word);
}

template <typename T, typename TT>
void launch(const void* x, const void* theta, const Dims4& d,
            int32_t* out, cudaStream_t stream) {
  const long long wpr = (d.len + 31) / 32;
  const long long total = d.n0 * d.n1 * d.n2 * wpr;
  if (total == 0) return;
  const long long blocks = (total + kWarps - 1) / kWarps;
  pack_threshold_kernel<T, TT>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const TT*>(theta), d, wpr,
          total, out);
}

}  // namespace

// dtype: 0 = bf16 x / f32 theta, 1 = f32 x / f32 theta, 2 = i32 x / i32 theta
COBRA_API int cobra_pack_threshold(
    const void* x, int dtype, const void* theta, long long n0, long long n1,
    long long n2, long long len, long long xs0, long long xs1, long long xs2,
    long long xsc, long long ts0, long long ts1, long long ts2,
    long long tsc, void* out, void* stream) {
  const Dims4 d{n0, n1, n2, len, xs0, xs1, xs2, xsc, ts0, ts1, ts2, tsc};
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<__nv_bfloat16, float>(x, theta, d, o, s); break;
    case 1: launch<float, float>(x, theta, d, o, s); break;
    case 2: launch<int32_t, int32_t>(x, theta, d, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cobra_launch_status();
}
