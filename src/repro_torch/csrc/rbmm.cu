// rbmm_int: Eq. 7 integer RBMM on packed words, both schemes.
//
// Replaces the TPU kernel src/repro/kernels/rbmm/kernel.py rbmm_int
// (_rbmm_int_kernel, _row_body):
//   xnor   : c = 2*popcount(~(a ^ b)) - (k + 2*pad)   (pad-0 correction)
//   and_dc : c = 2*popcount(a & b) - k + dc,  dc = k - popcount(a) if absent
// over a (batch, M, Kp) and b (batch, P, Kp) -> (batch, M, P) int32.
//
// Bound on the H100: bytes and launch overhead.  The main path calls it at
// decode, where M = batch <= 16: wq at M=8 moves 60 KB (0.02 us at
// 3.35 TB/s), so the launch itself (a few us) is the floor; the decode
// attention score and context calls are of the same size.  Design: one
// thread per output element looping over the Kp words with __popc;
// neighbouring threads take neighbouring output columns, so the A row is a
// broadcast read and the output store is coalesced.  A tiled version only
// pays once M grows, and at M > 16 the projections take rbmm_mxu instead.
#include "common.cuh"

namespace {

__global__ void rbmm_int_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                const int32_t* __restrict__ dc,
                                long long batch, int m, int p, int kp, int k,
                                int and_dc, int32_t* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= batch * m * p) return;
  const int col = static_cast<int>(idx % p);
  const long long rowz = idx / p;  // z * m + row
  const long long z = rowz / m;
  const uint32_t* ar = a + rowz * kp;
  const uint32_t* br = b + (z * p + col) * kp;
  int pc = 0;
  if (!and_dc) {
    for (int w = 0; w < kp; ++w) pc += __popc(~(ar[w] ^ br[w]));
    out[idx] = 2 * pc - (k + 2 * (kp * 32 - k));
    return;
  }
  int ones = 0;
  for (int w = 0; w < kp; ++w) {
    pc += __popc(ar[w] & br[w]);
    ones += __popc(ar[w]);
  }
  const int d = dc ? dc[rowz] : k - ones;
  out[idx] = 2 * pc - k + d;
}

}  // namespace

// scheme: 0 = xnor, 1 = and_dc.  dc may be null (derived from a).
COBRA_API int cobra_rbmm_int(const void* a, const void* b, const void* dc,
                             long long batch, long long m, long long p,
                             long long kp, long long k, int scheme,
                             void* out, void* stream) {
  const long long total = batch * m * p;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  rbmm_int_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const int32_t*>(dc), batch, static_cast<int>(m),
      static_cast<int>(p), static_cast<int>(kp), static_cast<int>(k),
      scheme, static_cast<int32_t*>(out));
  return cobra_launch_status();
}
