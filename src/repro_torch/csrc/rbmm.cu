// rbmm_int and rbmm_binary: Eq. 7 integer RBMM on packed words, both
// schemes, and its quantization-fused variant (Eq. 10).
//
// rbmm_int replaces the TPU kernel src/repro/kernels/rbmm/kernel.py rbmm_int
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
//
// rbmm_binary replaces the TPU kernel src/repro/kernels/rbmm/kernel.py
// rbmm_binary (_rbmm_binary_kernel): the same scores with the Eq. 10
// epilogue bit = c >= theta[row, col], an optional causal mask col <= row,
// and the DC RETURN, the zeros of each output row over the true P.  It
// stores either the {0,1} bits as int32 (the TPU kernel's output) or the
// bits packed 32 to a word, LSB-first, straight from the epilogue, which is
// what the next and_dc RBMM reads.  theta is read through three strides
// (sequence, row, column; 0 where broadcast), so a (P,) vector, a scalar or
// a full (batch, M, P) table take the same kernel.
//
// Bound on the H100: operations.  At the bert-base FFN F1 shape (M = 4096
// tokens, K = 768 as Kp = 24 words, P = 768) it does 4096*768*24 word
// steps of xor/and, popcount and add, 0.23 G 32-bit ops (3.4 us at the
// 67 T/s non-tensor rate), against 0.9 MB moved (0.27 us).  Design: a block
// of four warps owns 32 rows x 128 columns; per chunk of 32 words it stages
// the A rows and the B columns in shared memory (B padded to 33 words a
// column, so the 32 lanes of a warp hit 32 banks), and each thread, one
// output column, keeps 32 row accumulators in registers and reads the A
// words four at a time as broadcast 16-byte loads.  The xnor score is
// k - 2*popcount(a ^ b), the same integer as the pad-corrected form.  In
// the epilogue each warp compares its 32 columns and __ballot_sync puts
// lane i into bit i, so the packed word exists in a register and is stored
// once; the row's zero count is 32 minus its popcount (over the true
// columns only), added to a cleared dc vector with one int32 atomic per
// word, which is exact in any order.
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

namespace {

constexpr int kBinRows = 32;   // rows per block: one accumulator each
constexpr int kBinCols = 128;  // columns per block: four warps of 32 lanes
constexpr int kBinChunk = 32;  // packed words staged per step

template <bool kAndDc, bool kPacked>
__global__ void __launch_bounds__(kBinCols)
    rbmm_binary_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       const int32_t* __restrict__ dc,
                       const int32_t* __restrict__ theta, long long ts_z,
                       long long ts_m, long long ts_p, int m, int p, int kp,
                       int k, int causal, int32_t* __restrict__ out,
                       int32_t* __restrict__ dc_out) {
  __shared__ __align__(16) uint32_t a_s[kBinRows][kBinChunk];
  __shared__ uint32_t b_s[kBinCols][kBinChunk + 1];
  __shared__ int ones_s[kBinRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long z = blockIdx.z;
  const int row0 = blockIdx.y * kBinRows;
  const int col0 = blockIdx.x * kBinCols;
  const int col = col0 + tid;
  const uint32_t* az = a + z * m * static_cast<long long>(kp);
  const uint32_t* bz = b + z * p * static_cast<long long>(kp);
  const bool derive_dc = kAndDc && dc == nullptr;

  int acc[kBinRows];
#pragma unroll
  for (int r = 0; r < kBinRows; ++r) acc[r] = 0;
  if (tid < kBinRows) ones_s[tid] = 0;

  for (int w0 = 0; w0 < kp; w0 += kBinChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kBinRows * kBinChunk; i += kBinCols) {
      const int r = i / kBinChunk, w = i % kBinChunk;
      const int row = row0 + r, ww = w0 + w;
      a_s[r][w] = (row < m && ww < kp)
                      ? az[static_cast<long long>(row) * kp + ww] : 0u;
    }
    for (int i = tid; i < kBinCols * kBinChunk; i += kBinCols) {
      const int c = i / kBinChunk, w = i % kBinChunk;
      const int cc = col0 + c, ww = w0 + w;
      b_s[c][w] = (cc < p && ww < kp)
                      ? bz[static_cast<long long>(cc) * kp + ww] : 0u;
    }
    __syncthreads();
    if (derive_dc && tid < kBinRows) {
      int ones = 0;
      for (int w = 0; w < kBinChunk; ++w) ones += __popc(a_s[tid][w]);
      ones_s[tid] += ones;
    }
    // staged words past kp are 0 in both operands and add nothing
    const int nw = min(kBinChunk, kp - w0);
    for (int w = 0; w < nw; w += 4) {
      const uint32_t b0 = b_s[tid][w], b1 = b_s[tid][w + 1],
                     b2 = b_s[tid][w + 2], b3 = b_s[tid][w + 3];
#pragma unroll
      for (int r = 0; r < kBinRows; ++r) {
        const uint4 av = *reinterpret_cast<const uint4*>(&a_s[r][w]);
        if (kAndDc) {
          acc[r] += __popc(av.x & b0) + __popc(av.y & b1) +
                    __popc(av.z & b2) + __popc(av.w & b3);
        } else {
          acc[r] += __popc(av.x ^ b0) + __popc(av.y ^ b1) +
                    __popc(av.z ^ b2) + __popc(av.w ^ b3);
        }
      }
    }
  }
  __syncthreads();  // ones_s is complete

  const int warp_col0 = col0 + (tid & ~31);
  const int valid = min(32, p - warp_col0);   // true columns of this word
  const int pw = (p + 31) / 32;
#pragma unroll
  for (int r = 0; r < kBinRows; ++r) {
    const int row = row0 + r;
    if (row >= m) break;  // the same for the whole block
    const long long zrow = z * m + row;
    int c;
    if (kAndDc) {
      const int d = derive_dc ? k - ones_s[r] : dc[zrow];
      c = 2 * acc[r] - k + d;
    } else {
      c = k - 2 * acc[r];
    }
    const bool bit = col < p && (!causal || col <= row) &&
                     c >= theta[z * ts_z + row * ts_m + col * ts_p];
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (kPacked) {
      if (lane == 0 && valid > 0)
        out[zrow * pw + warp_col0 / 32] = static_cast<int32_t>(word);
    } else if (col < p) {
      out[zrow * p + col] = bit ? 1 : 0;
    }
    if (lane == 0 && valid > 0)
      atomicAdd(&dc_out[zrow], valid - __popc(word));
  }
}

}  // namespace

// scheme: 0 = xnor, 1 = and_dc; dc may be null (derived from a).  out is
// (batch, M, P) int32 bits, or (batch, M, ceil(P/32)) words when packed;
// dc_out (batch, M) int32 must be zero on entry.
COBRA_API int cobra_rbmm_binary(const void* a, const void* b, const void* dc,
                                const void* theta, long long ts_z,
                                long long ts_m, long long ts_p,
                                long long batch, long long m, long long p,
                                long long kp, long long k, int scheme,
                                int causal, int packed, void* out,
                                void* dc_out, void* stream) {
  if (batch == 0 || m == 0 || p == 0) return 0;
  const dim3 grid(static_cast<unsigned>((p + kBinCols - 1) / kBinCols),
                  static_cast<unsigned>((m + kBinRows - 1) / kBinRows),
                  static_cast<unsigned>(batch));
  auto s = static_cast<cudaStream_t>(stream);
  auto au = static_cast<const uint32_t*>(a);
  auto bu = static_cast<const uint32_t*>(b);
  auto dci = static_cast<const int32_t*>(dc);
  auto th = static_cast<const int32_t*>(theta);
  auto o = static_cast<int32_t*>(out);
  auto dco = static_cast<int32_t*>(dc_out);
  const int mi = static_cast<int>(m), pi = static_cast<int>(p),
            kpi = static_cast<int>(kp), ki = static_cast<int>(k);
#define COBRA_RBMM_BINARY(AND_DC, PACKED)                                  \
  rbmm_binary_kernel<AND_DC, PACKED><<<grid, kBinCols, 0, s>>>(             \
      au, bu, dci, th, ts_z, ts_m, ts_p, mi, pi, kpi, ki, causal, o, dco)
  if (scheme) {
    if (packed) COBRA_RBMM_BINARY(true, true);
    else COBRA_RBMM_BINARY(true, false);
  } else {
    if (packed) COBRA_RBMM_BINARY(false, true);
    else COBRA_RBMM_BINARY(false, false);
  }
#undef COBRA_RBMM_BINARY
  return cobra_launch_status();
}
