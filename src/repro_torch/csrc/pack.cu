// pack_threshold: fused threshold-binarize + LSB-first bit-pack.
//
// Replaces the TPU kernel src/repro/kernels/pack/kernel.py pack_threshold
// (_kernel): bits = x >= theta, 32 per word along the last axis, zero pad
// bits.  Here x may be up to 4-D with any strides (a permuted view is read
// in place) and theta is broadcast against x through its own strides (0 on
// broadcast axes), so one entry serves a per-column, per-head or per-row
// threshold.  A float x is compared in float32, an int32 x in int32.
//
// Bound on the H100: bytes.  It reads every value once and writes one bit
// per value, with one compare per value, far below the compute line: the
// encoder's x (8, 512, 768) bf16 moves 6.3 MB (1.9 us at 3.35 TB/s), the
// prefill x (1024, 576) bf16 1.2 MB (0.37 us); the decode shapes (8 or 16
// rows of 576) are a few KB, where the launch is the floor.  The design
// reads x in whole 32-byte sectors and wide loads whatever its layout:
//
//   * contiguous packed axis (the last stride 1; every main-path x but
//     V^T): each thread takes one 16-byte piece of a row, 8 bf16 or 4
//     f32 / int32 values, with one vector load when the rows are 16-byte
//     aligned, and compares it; the 4 (bf16) or 8 lanes whose pieces make
//     one 32-value word OR their bits together with __shfl_xor_sync, and
//     one of them stores the word.  A grid of at most 8 blocks per SM walks
//     the words with a grid-stride loop; the row, the word and x's row
//     offset come from 32-bit multiply-shift divisions by magic numbers the
//     host computes, a few instructions per word and no 64-bit divide.  A
//     per-column theta, the same (K,) vector for every row, is staged in
//     shared memory once per block; a theta that does not depend on the
//     column (per-head, per-row or one scalar) is read once per word.
//   * packed axis strided, rows contiguous (the V^T view v.permute(0, 2,
//     3, 1) that attention packs along the sequence, and the chunked
//     prefill's V^T words): reading along the packed axis would take one
//     32-byte sector per value.  Instead each lane owns one row, and a
//     warp reads, for each of the 32 positions of its word, the 32 rows'
//     values there in one contiguous load (64 bytes of bf16, 128 of f32 or
//     int32); a lane issues all 32 loads before its first compare (so they
//     are in flight together), then sets bit s of its row's word.  The
//     block's warps (8, or fewer when a row has fewer words) take
//     consecutive words of the same rows, and the words go through shared
//     memory so that the block stores them row by row, up to 32 contiguous
//     bytes per row, instead of one scattered word per lane.
//   * any other layout (no stride-1 axis where it helps): one warp per
//     output word, lane i reading value 32 w + i, __ballot_sync putting
//     lane i into bit i (the port's first design, kept for generality).
#include <algorithm>

#include "common.cuh"

namespace {

struct Dims4 {
  long long n0, n1, n2, len;       // rows n0*n1*n2, each of len values
  long long xs0, xs1, xs2, xsc;    // element strides of x
  long long ts0, ts1, ts2, tsc;    // element strides of theta (0 = bcast)
};

// n / d for n < 2^31 by a multiply and a shift: q = (umulhi(n, mul) + n)
// >> shift, with shift = ceil(log2 d) and mul = floor(2^32 (2^shift - d)
// / d) + 1 (Granlund and Montgomery).
struct FastDiv {
  uint32_t d, mul, shift;
};

FastDiv fast_div(long long d) {
  uint32_t s = 0;
  while ((1ull << s) < static_cast<unsigned long long>(d)) ++s;
  const unsigned long long mul =
      ((1ull << 32) * ((1ull << s) - static_cast<unsigned long long>(d))) /
          static_cast<unsigned long long>(d) + 1;
  return {static_cast<uint32_t>(d), static_cast<uint32_t>(mul), s};
}

__device__ __forceinline__ uint32_t quot(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.mul) + n) >> f.shift;
}

enum ThetaKind { kThetaAny = 0, kThetaByRow = 1, kThetaByCol = 2 };

constexpr int kThreads = 256;
constexpr int kThetaSmem = 4096;   // a per-column theta staged up to this K

// x's value in the comparison type: float32 for float x, int32 for int32.
__device__ __forceinline__ float as_cmp(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float as_cmp(float x) { return x; }
__device__ __forceinline__ int32_t as_cmp(int32_t x) { return x; }

// -- contiguous packed axis ---------------------------------------------------

// The V values of a 16-byte piece as float (or int32 for int32 x).
__device__ __forceinline__ void unpack16(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> float is a 16-bit shift
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack16(uint4 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(uint4 u, int32_t (&v)[4]) {
  v[0] = static_cast<int32_t>(u.x);
  v[1] = static_cast<int32_t>(u.y);
  v[2] = static_cast<int32_t>(u.z);
  v[3] = static_cast<int32_t>(u.w);
}

template <typename T, typename TT>
__global__ void __launch_bounds__(kThreads)
    pack_contig_kernel(const T* __restrict__ x, const TT* __restrict__ theta,
                       Dims4 d, FastDiv wpr, FastDiv n2, FastDiv n1,
                       uint32_t total, int vec, int theta_kind,
                       int32_t* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);   // values per 16-byte piece
  constexpr int G = 32 / V;           // pieces (lanes) per word
  __shared__ TT th_s[kThetaSmem];
  const int len = static_cast<int>(d.len);
  const bool th_smem = theta_kind == kThetaByCol && len <= kThetaSmem;
  if (th_smem) {
    for (int c = threadIdx.x; c < len; c += kThreads)
      th_s[c] = theta[c * d.tsc];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const uint32_t stride = gridDim.x * kThreads;
  // warp-uniform bounds: every lane takes part in the shuffles; a word's G
  // lanes are all in or all out, as total is a multiple of G
  for (uint32_t base = blockIdx.x * kThreads + (threadIdx.x & ~31u);
       base < total; base += stride) {
    const uint32_t t = base + lane;
    uint32_t bits = 0;
    uint32_t gw = 0;
    if (t < total) {
      gw = t / G;
      const uint32_t r = quot(gw, wpr);
      const int c0 = static_cast<int>(gw - r * wpr.d) * 32 + sub * V;
      const uint32_t r12 = quot(r, n2);
      const uint32_t i2 = r - r12 * n2.d;
      const uint32_t i0 = quot(r12, n1);
      const uint32_t i1 = r12 - i0 * n1.d;
      const T* xr = x + i0 * d.xs0 + i1 * d.xs1 + i2 * d.xs2;
      const TT* tr = theta + i0 * d.ts0 + i1 * d.ts1 + i2 * d.ts2;
      const TT t_row = theta_kind == kThetaByRow ? *tr : TT(0);
      TT v[V];   // TT is the comparison type: float, or int32
      const bool full = c0 + V <= len;
      if (vec && full) {
        unpack16(*reinterpret_cast<const uint4*>(xr + c0), v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[j] = c0 + j < len ? as_cmp(xr[c0 + j]) : TT(0);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = c0 + j;
        TT th;
        if (theta_kind == kThetaByRow) th = t_row;
        else if (th_smem) th = th_s[c < len ? c : 0];
        else th = c < len ? tr[c * d.tsc] : TT(0);
        bits |= static_cast<uint32_t>(c < len && v[j] >= th) << j;
      }
      bits <<= sub * V;
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1)
      bits |= __shfl_xor_sync(0xffffffffu, bits, o);
    if (t < total && sub == 0) out[gw] = static_cast<int32_t>(bits);
  }
}

// -- strided packed axis, contiguous rows -----------------------------------

constexpr int kStrWords = kThreads / 32;   // words per block, at most

// A block of wb <= kStrWords warps takes wb consecutive words of 32
// consecutive rows (one a lane) of one (i0, i1).
template <typename T, typename TT>
__global__ void __launch_bounds__(kThreads)
    pack_strided_kernel(const T* __restrict__ x,
                        const TT* __restrict__ theta, Dims4 d,
                        long long wpr, int theta_kind,
                        int32_t* __restrict__ out) {
  __shared__ uint32_t words_s[32][kStrWords + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int wb = blockDim.x / 32;
  const long long w = static_cast<long long>(blockIdx.x) * wb + warp;
  const long long rb = static_cast<long long>(blockIdx.y) * 32;
  const long long r = rb + lane;                   // this lane's row
  const long long nz = d.n0 * d.n1;
  // the values of the word's 32 positions: all loads are issued before the
  // first compare, with no branch between them (positions past len and rows
  // past n2 read a clamped, valid address and are masked later), so a
  // lane has its 32 loads in flight at once
  const int nval = static_cast<int>(min(32ll, max(0ll, d.len - w * 32)));
  const bool row_ok = r < d.n2;
  for (long long zz = blockIdx.z; zz < nz; zz += gridDim.z) {
    const long long i0 = zz / d.n1, i1 = zz % d.n1;
    uint32_t word = 0u;
    if (nval > 0) {
      const T* xr = x + i0 * d.xs0 + i1 * d.xs1 + min(r, d.n2 - 1);
      const TT* tr = theta + i0 * d.ts0 + i1 * d.ts1 + r * d.ts2;
      const long long c0 = w * 32;
      // 32-bit offsets from the word's first value: the host routes here
      // only views whose packed axis spans less than 2^31 elements
      const T* xw = xr + c0 * d.xsc;
      const int xsc = static_cast<int>(d.xsc), slast = nval - 1;
      TT v[32];
#pragma unroll
      for (int s = 0; s < 32; ++s) v[s] = as_cmp(xw[min(s, slast) * xsc]);
      const TT t_row = theta_kind == kThetaByRow && row_ok ? *tr : TT(0);
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const bool in = s < nval && row_ok;
        const TT th = theta_kind == kThetaByRow || !in
                          ? t_row : tr[(c0 + s) * d.tsc];
        word |= static_cast<uint32_t>(in && v[s] >= th) << s;
      }
    }
    words_s[lane][warp] = word;
    __syncthreads();
    // the block's 32 rows x wb words, stored row by row
    int32_t* oz = out + zz * d.n2 * wpr;
    for (int i = threadIdx.x; i < 32 * wb; i += blockDim.x) {
      const int rl = i / wb, wl = i % wb;
      const long long row = rb + rl;
      const long long ww = static_cast<long long>(blockIdx.x) * wb + wl;
      if (row < d.n2 && ww < wpr)
        oz[row * wpr + ww] = static_cast<int32_t>(words_s[rl][wl]);
    }
    __syncthreads();
  }
}

// -- any layout -------------------------------------------------------------

constexpr int kWarps = kThreads / 32;

template <typename T, typename TT>
__global__ void __launch_bounds__(kThreads)
    pack_any_kernel(const T* __restrict__ x, const TT* __restrict__ theta,
                    Dims4 d, long long words_per_row, long long total_words,
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
    bit = as_cmp(x[i0 * d.xs0 + i1 * d.xs1 + i2 * d.xs2 + c * d.xsc]) >=
          theta[i0 * d.ts0 + i1 * d.ts1 + i2 * d.ts2 + c * d.tsc];
  }
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[gw] = static_cast<int32_t>(word);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T, typename TT>
void launch(const void* xv, const void* thv, Dims4 d, int32_t* out,
            cudaStream_t stream) {
  auto x = static_cast<const T*>(xv);
  auto theta = static_cast<const TT*>(thv);
  const long long wpr = (d.len + 31) / 32;
  const long long rows = d.n0 * d.n1 * d.n2;
  if (rows * wpr == 0) return;
  // strides of size-1 axes are never multiplied by a non-zero index
  const long long* n[3] = {&d.n0, &d.n1, &d.n2};
  long long* xs[3] = {&d.xs0, &d.xs1, &d.xs2};
  long long* ts[3] = {&d.ts0, &d.ts1, &d.ts2};
  for (int i = 0; i < 3; ++i)
    if (*n[i] == 1) *xs[i] = *ts[i] = 0;
  if (d.len == 1) d.xsc = 1, d.tsc = 0;
  const int theta_kind = d.tsc == 0 ? kThetaByRow
                         : d.ts0 == 0 && d.ts1 == 0 && d.ts2 == 0
                             ? kThetaByCol
                             : kThetaAny;
  constexpr int V = 16 / sizeof(T);
  const long long threads = rows * wpr * (32 / V);
  if (d.xsc == 1 && threads < (1ll << 31)) {
    const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    d.xs0 % V == 0 && d.xs1 % V == 0 && d.xs2 % V == 0;
    const long long blocks = std::min<long long>(
        (threads + kThreads - 1) / kThreads, 8ll * sm_count());
    pack_contig_kernel<T, TT><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(
        x, theta, d, fast_div(wpr), fast_div(d.n2), fast_div(d.n1),
        static_cast<uint32_t>(threads), vec, theta_kind, out);
    return;
  }
  if (d.xs2 == 1 && d.n2 > 1 && d.len * d.xsc < (1ll << 31)) {
    const long long wb = std::min<long long>(kStrWords, wpr);
    const dim3 grid(static_cast<unsigned>((wpr + wb - 1) / wb),
                    static_cast<unsigned>((d.n2 + 31) / 32),
                    static_cast<unsigned>(std::min<long long>(d.n0 * d.n1,
                                                              65535)));
    pack_strided_kernel<T, TT><<<grid, static_cast<unsigned>(32 * wb), 0,
                                 stream>>>(
        x, theta, d, wpr,
        theta_kind == kThetaByRow ? kThetaByRow : kThetaAny, out);
    return;
  }
  const long long total = rows * wpr;
  pack_any_kernel<T, TT>
      <<<static_cast<unsigned>((total + kWarps - 1) / kWarps), kThreads, 0,
         stream>>>(x, theta, d, wpr, total, out);
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
