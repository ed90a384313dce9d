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
// Bound on the H100: operations, on the int8 tensor cores.  At the
// bert-base FFN F1 shape (M = 4096 tokens, K = 768 as Kp = 24 words, P =
// 768) the product is 4.83 G multiply-adds of ±1 or {0,1} values: 2.44 us
// at 1,979 TOP/s, against 0.23 G 32-bit word operations (3.38 us at the
// 67 T/s non-tensor rate, and 18 us at the card's popcount issue rate of
// 16 per clock per SM, which bounded the popcount design this replaces)
// and 0.88 MB moved (0.26 us).  The values are exact in int8 and their
// sums, at most 32 * Kp in magnitude, in int32.
//
// Design: a block of two consumer warpgroups and one producer warp owns
// 128 rows x 192 columns (128 blocks at F1: one wave on 132 SMs) and walks
// K in steps of 128 values (4 words per row).  The producer warp copies a
// step's A and B words into a 4-stage mbarrier ring with cp.async
// (16-byte copies when Kp % 4 == 0 and the bases are aligned, 4-byte ones
// otherwise; zero past M, P or Kp).  The consumers unpack a stage into
// int8 tiles in the 128-byte-swizzled K-major wgmma layout, 16 bits to a
// 16-byte chunk (x * 0x204081 spreads a nibble into four bytes): ±1 for
// xnor, {0,1} for and_dc; the words go back to the producer at once.
// Every bit of the Kp words unpacks, pad bits of the last word included,
// and the integer correction makes the score equal the plain version for
// any words: c = dot - (32 * Kp - K) for xnor, 2 * dot - K + d for and_dc
// (d from all words when derived).  Words past Kp in a stage unpack to 0:
// in ±1 form a zero word would be all -1.  Then the proxy fence, a
// barrier among the consumers and four wgmma m64n192k32 s8.s8 -> s32 per
// warpgroup, left running while the next step unpacks (three tile
// buffers).  The thresholds of the block's columns are staged in shared
// memory when theta does not depend on the row.  In the epilogue each
// thread holds column pairs 8j + 2 * (lane % 4) + {0, 1} of two rows; it
// thresholds them, masks causally and past P, and an OR over the four
// lanes of a quad (__shfl_xor_sync) assembles each 32-column word, stored
// once.  A row's zeros in the block (true columns only) go to a cleared
// dc vector with one int32 atomic per row and block, exact in any order.
#include "common.cuh"
#include "tc_common.cuh"

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

constexpr int kBinM = 128;       // rows per block: two consumer warpgroups
constexpr int kBinN = 192;       // columns per block: wgmma n192
constexpr int kBinWords = 4;     // words per row and K-step (128 values)
constexpr int kBinStages = 4;    // word ring depth
constexpr int kBinBufs = 3;      // unpacked tiles in flight (see the loop)
constexpr int kBinConsumers = 256;
constexpr int kBinThreads = kBinConsumers + 32;   // + producer warp
constexpr int kBinRows = kBinM + kBinN;           // staged rows: A then B
constexpr int kBinStageWords = kBinRows * kBinWords;
constexpr int kBinChunks = kBinRows * 8 / kBinConsumers;  // per thread
constexpr int kBinTileBytes = kBinRows * tc::kRowBytes;   // A and B, int8
constexpr int kBinTileOff = 0;
constexpr int kBinWordOff = kBinBufs * kBinTileBytes;
constexpr int kBinThetaOff = kBinWordOff + kBinStages * kBinStageWords * 4;
constexpr int kBinOnesOff = kBinThetaOff + kBinN * 4;
constexpr int kBinBarOff = kBinOnesOff + kBinM * 4;
constexpr int kBinSmem = kBinBarOff + 2 * kBinStages * 8 + 1024;  // + align
static_assert(kBinRows * 8 % kBinConsumers == 0, "whole chunks per thread");

template <bool kAndDc, bool kPacked>
__global__ void __launch_bounds__(kBinThreads)
    rbmm_binary_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       const int32_t* __restrict__ dc,
                       const int32_t* __restrict__ theta, long long ts_z,
                       long long ts_m, long long ts_p, int m, int p, int kp,
                       int k, int causal, int vec16,
                       int32_t* __restrict__ out,
                       int32_t* __restrict__ dc_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* tiles = smem + kBinTileOff;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + kBinWordOff);
  int32_t* theta_s = reinterpret_cast<int32_t*>(smem + kBinThetaOff);
  int* ones_s = reinterpret_cast<int*>(smem + kBinOnesOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBinBarOff);
  uint64_t* empty = full + kBinStages;

  const int tid = threadIdx.x;
  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * kBinM;
  const int n0 = blockIdx.x * kBinN;
  const uint32_t* az = a + z * m * static_cast<long long>(kp);
  const uint32_t* bz = b + z * p * static_cast<long long>(kp);
  const int ktiles = (kp + kBinWords - 1) / kBinWords;

  if (tid == 0) {
    for (int s = 0; s < kBinStages; ++s) {
      tc::mbar_init(&full[s], 32);                   // cp.async arrivals
      tc::mbar_init(&empty[s], kBinConsumers / 32);  // one per warp
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kBinConsumers) {   // the producer warp
    const int lane = tid - kBinConsumers;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kBinStages;
      if (kt >= kBinStages)
        tc::mbar_wait(&empty[s], (kt / kBinStages - 1) & 1);
      uint32_t* ws = words + s * kBinStageWords;
      const int w0 = kt * kBinWords;
      if (vec16) {
        for (int r = lane; r < kBinRows; r += 32) {
          const int gr = r < kBinM ? m0 + r : n0 + r - kBinM;
          const bool ok = r < kBinM ? gr < m : gr < p;
          const uint32_t* src =
              (r < kBinM ? az : bz) + static_cast<long long>(gr) * kp + w0;
          tc::cp_async<16>(ws + r * kBinWords, ok ? src : a, ok ? 16 : 0);
        }
      } else {
        for (int i = lane; i < kBinStageWords; i += 32) {
          const int r = i / kBinWords, ww = w0 + i % kBinWords;
          const int gr = r < kBinM ? m0 + r : n0 + r - kBinM;
          const bool ok = (r < kBinM ? gr < m : gr < p) && ww < kp;
          const uint32_t* src =
              (r < kBinM ? az : bz) + static_cast<long long>(gr) * kp + ww;
          tc::cp_async<4>(ws + i, ok ? src : a, ok ? 4 : 0);
        }
      }
      tc::cp_async_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer warpgroups; while the first words are in flight, stage the
  // block's thresholds when they do not depend on the row, and count the
  // A rows' ones when dc is derived (over all words, pad bits included, as
  // the plain version counts them)
  const int wg = tid / 128;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const bool derive_dc = kAndDc && dc == nullptr;
  const bool theta_by_col = ts_m == 0;
  if (theta_by_col && tid < kBinN && n0 + tid < p)
    theta_s[tid] = theta[z * ts_z + (n0 + tid) * ts_p];
  if (derive_dc && tid < kBinM) {
    int ones = 0;
    if (m0 + tid < m) {
      const uint32_t* row = az + static_cast<long long>(m0 + tid) * kp;
#pragma unroll 8
      for (int w = 0; w < kp; ++w) ones += __popc(row[w]);
    }
    ones_s[tid] = ones;
  }

  int32_t acc[kBinN / 2];
#pragma unroll
  for (int i = 0; i < kBinN / 2; ++i) acc[i] = 0;

  // Thread tid unpacks 16-byte chunk tid % 8 of rows tid / 8 + 32 j: the
  // chunk's 16 values are bits 16 * (c % 2) .. + 15 of the row's word c / 2
  // of the step.
  const int c = tid & 7;
  const int r0 = tid >> 3;
  // Step kt: unpack the stage's words into tile buffer kt % 3 (the words
  // go back to the producer at once), then issue its wgmmas and, while
  // they run, wait for those of step kt - 1.  Buffer kt % 3 was last read
  // by the wgmmas of step kt - 3, which every warpgroup waited for before
  // the barrier of step kt - 1.
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kBinStages;
    tc::mbar_wait(&full[s], (kt / kBinStages) & 1);
    uint8_t* tile = tiles + (kt % kBinBufs) * kBinTileBytes;
    const uint32_t* ws = words + s * kBinStageWords + (c >> 1);
    // words past Kp are zero operands: in ±1 form a zero word is all -1
    const bool live = kt * kBinWords + (c >> 1) < kp;
    const int shift = 16 * (c & 1);
#pragma unroll
    for (int j = 0; j < kBinChunks; ++j) {
      const int r = r0 + 32 * j;
      const uint32_t half = (ws[r * kBinWords] >> shift) & 0xFFFFu;
      *reinterpret_cast<uint4*>(tile + tc::swz(r, c)) =
          live ? tc::bits16_to_s8<!kAndDc>(half) : make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&empty[s]);
    tc::fence_proxy_async();
    tc::named_sync(1, kBinConsumers);
    const uint8_t* at = tile + wg * 64 * tc::kRowBytes;
    const uint8_t* bt = tile + kBinM * tc::kRowBytes;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_s8(acc, tc::desc_b128(at + 32 * kk),
                   tc::desc_b128(bt + 32 * kk));
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
  }
  tc::wgmma_wait<0>();
  tc::fence_operands(acc);
  tc::named_sync(1, kBinConsumers);   // theta_s and ones_s are complete

  const int tig = lane & 3;
  const int valid = min(kBinN, p - n0);   // true columns of the block
  const int pw = (p + 31) / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * h;
    const int row = m0 + rl;
    const bool row_ok = row < m;          // the same for the whole quad
    const long long zrow = z * m + row;
    // the score is dot - off (xnor: the ±1 pad correction) or 2 dot - off
    // (and_dc: off = K - d); a bit may be set only in the first lim
    // columns of the block: the true ones, and col <= row when causal
    int off = 32 * kp - k;
    if (kAndDc && row_ok) off = k - (derive_dc ? k - ones_s[rl] : dc[zrow]);
    int lim = row_ok ? valid : 0;
    if (causal) lim = min(lim, row - n0 + 1);
    const int32_t* th_row = theta + z * ts_z + row * ts_m + n0 * ts_p;
    uint32_t word[kBinN / 32];
#pragma unroll
    for (int q = 0; q < kBinN / 32; ++q) word[q] = 0u;
#pragma unroll
    for (int j = 0; j < kBinN / 8; ++j) {
      const int cl = 8 * j + 2 * tig;     // the pair's first column
      int2 th;
      if (theta_by_col) {
        th = *reinterpret_cast<const int2*>(&theta_s[cl]);
      } else {
        th.x = cl < lim ? th_row[cl * ts_p] : 0;
        th.y = cl + 1 < lim ? th_row[(cl + 1) * ts_p] : 0;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dot = acc[4 * j + 2 * h + e];
        const int score = (kAndDc ? 2 * dot : dot) - off;
        const bool bit = cl + e < lim && score >= (e ? th.y : th.x);
        word[j / 4] |= static_cast<uint32_t>(bit)
                       << (8 * (j % 4) + 2 * tig + e);
        if (!kPacked && row_ok && cl + e < valid)
          out[zrow * p + n0 + cl + e] = bit ? 1 : 0;
      }
    }
    int zeros = valid;
#pragma unroll
    for (int q = 0; q < kBinN / 32; ++q) {
      word[q] |= __shfl_xor_sync(0xffffffffu, word[q], 1);
      word[q] |= __shfl_xor_sync(0xffffffffu, word[q], 2);
      zeros -= __popc(word[q]);
      if (kPacked && row_ok && tig == (q & 3) && n0 / 32 + q < pw)
        out[zrow * pw + n0 / 32 + q] = static_cast<int32_t>(word[q]);
    }
    if (row_ok && tig == 0) atomicAdd(&dc_out[zrow], zeros);
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
  const dim3 grid(static_cast<unsigned>((p + kBinN - 1) / kBinN),
                  static_cast<unsigned>((m + kBinM - 1) / kBinM),
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
  // 16-byte copies of a row's 4 words when every row start is aligned
  const int vec16 = kp % kBinWords == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
#define COBRA_RBMM_BINARY(AND_DC, PACKED)                                   \
  do {                                                                       \
    static bool attr_set = false;                                            \
    if (!attr_set) {                                                         \
      const cudaError_t e = cudaFuncSetAttribute(                            \
          rbmm_binary_kernel<AND_DC, PACKED>,                                \
          cudaFuncAttributeMaxDynamicSharedMemorySize, kBinSmem);            \
      if (e != cudaSuccess) return static_cast<int>(e);                      \
      attr_set = true;                                                       \
    }                                                                        \
    rbmm_binary_kernel<AND_DC, PACKED><<<grid, kBinThreads, kBinSmem, s>>>(  \
        au, bu, dci, th, ts_z, ts_m, ts_p, mi, pi, kpi, ki, causal, vec16, o,  \
        dco);                                                                \
  } while (0)
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
