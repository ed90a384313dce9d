// rbmm_int and rbmm_binary: Eq. 7 integer RBMM on packed words, both
// schemes, and its quantization-fused variant (Eq. 10).
//
// rbmm_int replaces the TPU kernel src/repro/kernels/rbmm/kernel.py rbmm_int
// (_rbmm_int_kernel, _row_body):
//   xnor   : c = 2*popcount(~(a ^ b)) - (k + 2*pad)   (pad-0 correction)
//   and_dc : c = 2*popcount(a & b) - k + dc,  dc = k - popcount(a) if absent
// over a (batch, M, Kp) and b (batch, P, Kp) -> (batch, M, P) int32.  It has
// two routes, picked by the wrapper from the shape alone (ops.route):
//
//   * M <= 16 (decode, rbmm_int_dec_kernel): groups of lanes split each
//     column's Kp words (coalesced, 16-byte loads where Kp and the bases
//     allow) and meet in a shuffle reduce-scatter; a block's rows are held
//     in registers and each weight word is used against all of them.
//     Bound on the H100: bytes, far below the launch: wq at M = 8 moves 60
//     KB (0.018 us at 3.35 TB/s), w2 (M = 8, Kp = 48) 130 KB (0.04 us).
//     What sets the time past the launch is each warp's serial chain: one
//     round trip to L2 for both operands, then rows x words popcounts at
//     the SM's 16 a clock (a warp's takes 8 clocks on its sub-partition),
//     then the shuffles.  So the design keeps that chain short: no shared
//     memory and no barrier, one vector a lane, row blocks of at most 8
//     rows and 8 popcounts a lane per column (the weights are read once per
//     row block, from L2 after the first), and a grid of large blocks
//     spread over the SMs (ops.decode_tile; PERF.md section 6 has the
//     tile sweep that chose it).
//   * larger M (the encoder's F2, chunked prefill's scores and context): the
//     int8 tensor-core mainloop below, shared with rbmm_binary, and a plain
//     int32 epilogue.  Bound on the H100: bytes, of the output.  F2, M =
//     4096 tokens, K = 768 (24 words), P = 768, and_dc with dc given: 2.4 G
//     int8 multiply-adds (1.2 us at 1,979 TOP/s) against 12.6 MB of int32
//     output and 0.5 MB of words (3.90 us).  The epilogue turns each
//     accumulator into c = dot - (32 * Kp - K) (xnor) or 2 * dot - K + d
//     (and_dc; d = dc[row], or K - popcount of the row's words, pad bits
//     included, as the plain version counts them), stages the block's tile
//     in shared memory over the then idle unpacked tiles (rows padded by 8
//     words against bank conflicts), and writes it back row by row with
//     16-byte stores, one whole row segment of the tile after another.
//     Chosen over TMA stores: no tensor map to encode on the host per call
//     (the callers are host-bound), and the batch and ragged edges are plain
//     masks; rows of P % 4 != 0 columns are not 16-byte aligned and take
//     4-byte stores.  The wrapper takes the tile's N from P (64, 128 or 192
//     columns: the fewest padded columns, then the widest).
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
// The mainloop (tc_init, tc_produce, tc_consume): a block of two consumer
// warpgroups and one producer warp owns 128 rows x BN columns (rbmm_binary:
// BN = 192, 128 blocks at F1: one wave on 132 SMs) and walks K in steps of
// 128 values (4 words per row).  The producer warp copies a step's A and B
// words into a 4-stage mbarrier ring with cp.async (16-byte copies when
// Kp % 4 == 0 and the bases are aligned, 4-byte ones otherwise; zero past
// M, P or Kp).  The consumers unpack a stage into int8 tiles in the
// 128-byte-swizzled K-major wgmma layout, 16 bits to a 16-byte chunk
// (x * 0x204081 spreads a nibble into four bytes): ±1 for xnor, {0,1} for
// and_dc; the words go back to the producer at once.  Every bit of the Kp
// words unpacks, pad bits of the last word included, and the integer
// correction makes the score equal the plain version for any words.  Words
// past Kp in a stage unpack to 0: in ±1 form a zero word would be all -1.
// Then the proxy fence, a barrier among the consumers and four wgmma
// m64nBNk32 s8.s8 -> s32 per warpgroup, left running while the next step
// unpacks (three tile buffers).  The loop runs at least once (Kp = 0 is one
// step of zero words): a path that skipped it would make ptxas serialize the
// wgmmas.
//
// rbmm_binary's epilogue: the thresholds of the block's columns are staged
// in shared memory when theta does not depend on the row.  Each thread
// holds column pairs 8j + 2 * (lane % 4) + {0, 1} of two rows; it
// thresholds them, masks causally and past P, and an OR over the four
// lanes of a quad (__shfl_xor_sync) assembles each 32-column word, stored
// once.  A row's zeros in the block (true columns only) go to a cleared
// dc vector with one int32 atomic per row and block, exact in any order.
#include "common.cuh"
#include "tc_common.cuh"

namespace {

// -- rbmm_int's decode route (M <= 16) -------------------------------------
//
// A block owns MT rows of one batch item (MT: 1, 2, 4 or 8; more rows take
// more row blocks) and warps * 32 / G columns: a group of G lanes
// shares a column and splits its Kp words, lane j taking the V-word vectors
// j, j + G, j + 2G, ... (the tile rule makes that one vector where 32
// lanes allow).  Both operands are read straight into registers: the
// column's B words once per row block, each by one lane; the MT A rows'
// words at the same positions, which every group of the warp reads at the
// same addresses (one broadcast request).  Per word and row one LOP3 and
// one popcount: X = popc(a ^ b) (xnor and derived dc) or popc(a & b) (dc
// given), so that, over all 32 Kp bits, pad bits included as the plain
// version counts them,
//   xnor          c = k - 2 X
//   and_dc given  c = 2 popc(a & b) - k + dc
//   and_dc, derived  2 popc(a & b) - popc(a) = popc(b) - X:  c = popc(b) - X
// (popc(a & b) = (popc a + popc b - popc(a ^ b)) / 2 word by word): the
// ones of b are a column's, counted once per word, not once per row.  Rows
// past M add nothing that is stored.  The G lanes' partials then meet in a
// reduce-scatter over __shfl_xor_sync: each step a lane keeps half of its
// rows and sends the other half, so MT rows cost MT - 1 shuffles (plus
// log2(G / MT) when G > MT) and each lane ends with MT / G rows (or one)
// to store.
template <int V>
__device__ __forceinline__ void load_vec(const uint32_t* p, uint32_t* d) {
  if constexpr (V == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = __ldg(p);
  }
}

// v[0, H) are a lane's partial rows; lanes S apart swap halves and add.
template <int H, int S, int N>
__device__ __forceinline__ void reduce_scatter(int (&v)[N], int lane) {
  if constexpr (S >= 1) {
    if constexpr (H > 1) {
      const bool up = lane & S;
#pragma unroll
      for (int i = 0; i < H / 2; ++i) {
        const int send = up ? v[i] : v[i + H / 2];
        const int keep = up ? v[i + H / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
    }
    reduce_scatter<(H > 1 ? H / 2 : 1), S / 2>(v, lane);
  }
}

// The first row that reduce_scatter<H, S> leaves in v[0] of this lane.
template <int H, int S>
__device__ __forceinline__ int held_row(int lane) {
  if constexpr (S >= 1 && H > 1)
    return ((lane & S) ? H / 2 : 0) + held_row<H / 2, S / 2>(lane);
  return 0;
}

// mode: 0 xnor, 1 and_dc with dc given, 2 and_dc with dc derived.
template <int MT, int G, int V>
__global__ void __launch_bounds__(256)
rbmm_int_dec_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    const int32_t* __restrict__ dc, int m, int p, int kp,
                    int k, int mode, int32_t* __restrict__ out) {
  constexpr int kHeld = MT > G ? MT / G : 1;   // rows a lane stores
  const int lane = threadIdx.x & 31;
  const int j = lane % G;
  const long long z = blockIdx.z;
  const int row0 = blockIdx.y * MT;
  const int col = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool col_ok = col < p;
  const int rows = min(MT, m - row0);
  const uint32_t* bp = b + (z * p + col) * kp;
  const uint32_t* ap = a + (z * m + row0) * kp;
  const int my_row = held_row<MT, G / 2>(lane);
  // the stores' rows: lanes G / MT apart hold the same sums (G > MT)
  const bool stores = col_ok && (G <= MT || (j & (G / MT - 1)) == 0);
  int bias[kHeld];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int r = my_row + i;
    bias[i] = mode == 0 ? k : 0;
    if (mode == 1 && stores && r < rows) bias[i] = dc[z * m + row0 + r] - k;
  }
  // a & b when and_dc has dc given, else a ^ b: one LOP3 either way
  const uint32_t and_mask = mode == 1 ? 0xffffffffu : 0u;

  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;
  int b_ones = 0;
  const int nvec = col_ok ? kp / V : 0;   // kp % V == 0
#pragma unroll 2
  for (int vi = j; vi < nvec; vi += G) {
    const int w = vi * V;
    uint32_t bw[V], aw[MT][V];
    load_vec<V>(bp + w, bw);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < rows) {
        load_vec<V>(ap + static_cast<long long>(r) * kp + w, aw[r]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) aw[r][e] = 0;
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      b_ones += __popc(bw[e]);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const uint32_t x = aw[r][e], y = bw[e];
        acc[r] += __popc((x ^ y) ^ (and_mask & (x | y)));
      }
    }
  }
  int v[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r)
    v[r] = mode == 0 ? -2 * acc[r] : mode == 1 ? 2 * acc[r]
                                               : b_ones - acc[r];
  reduce_scatter<MT, G / 2>(v, lane);
  if (!stores) return;
  int32_t* o = out + (z * m + row0) * p + col;
#pragma unroll
  for (int i = 0; i < kHeld; ++i)
    if (my_row + i < rows)
      o[static_cast<long long>(my_row + i) * p] = v[i] + bias[i];
}

template <int MT, int G>
void launch_dec_v(int vec, dim3 grid, int threads, cudaStream_t s,
                  const uint32_t* a, const uint32_t* b, const int32_t* dc,
                  int m, int p, int kp, int k, int mode, int32_t* out) {
  if (vec == 4)
    rbmm_int_dec_kernel<MT, G, 4><<<grid, threads, 0, s>>>(
        a, b, dc, m, p, kp, k, mode, out);
  else if (vec == 2)
    rbmm_int_dec_kernel<MT, G, 2><<<grid, threads, 0, s>>>(
        a, b, dc, m, p, kp, k, mode, out);
  else
    rbmm_int_dec_kernel<MT, G, 1><<<grid, threads, 0, s>>>(
        a, b, dc, m, p, kp, k, mode, out);
}

template <int MT>
bool launch_dec_g(int lanes, int vec, dim3 grid, int threads,
                  cudaStream_t s, const uint32_t* a, const uint32_t* b,
                  const int32_t* dc, int m, int p, int kp, int k, int mode,
                  int32_t* out) {
#define COBRA_DEC_G(G)                                                     \
  case G:                                                                  \
    launch_dec_v<MT, G>(vec, grid, threads, s, a, b, dc, m, p, kp, k, mode, \
                        out);                                              \
    return true;
  switch (lanes) {
    COBRA_DEC_G(1) COBRA_DEC_G(2) COBRA_DEC_G(4) COBRA_DEC_G(8)
    COBRA_DEC_G(16) COBRA_DEC_G(32)
  }
#undef COBRA_DEC_G
  return false;
}

// -- the int8 tensor-core mainloop of rbmm_binary and large-M rbmm_int ------

constexpr int kTcM = 128;       // rows per block: two consumer warpgroups
constexpr int kTcWords = 4;     // words per row and K-step (128 values)
constexpr int kTcStages = 4;    // word ring depth
constexpr int kTcBufs = 3;      // unpacked tiles in flight (see tc_consume)
constexpr int kTcConsumers = 256;
constexpr int kTcThreads = kTcConsumers + 32;   // + producer warp

// Shared memory of a block with a BN-column tile: the unpacked tiles, the
// word ring, the ring's barriers, then what the kernel's epilogue keeps
// (from kExtraOff); the whole is 1,024-byte aligned at run time.
template <int BN>
struct TcTile {
  static constexpr int kRows = kTcM + BN;          // staged rows: A then B
  static constexpr int kStageWords = kRows * kTcWords;
  static constexpr int kChunks = kRows * 8 / kTcConsumers;  // per thread
  static constexpr int kTileBytes = kRows * tc::kRowBytes;  // A and B, int8
  static constexpr int kWordOff = kTcBufs * kTileBytes;
  static constexpr int kBarOff = kWordOff + kTcStages * kStageWords * 4;
  static constexpr int kExtraOff = kBarOff + 2 * kTcStages * 8;
  static constexpr int kAcc = BN / 2;   // int32 accumulators per thread
  static_assert(kRows * 8 % kTcConsumers == 0, "whole chunks per thread");
};

struct TcRing {
  uint8_t* tiles;
  uint32_t* words;
  uint64_t* full;
  uint64_t* empty;
};

template <int BN>
__device__ __forceinline__ TcRing tc_ring(uint8_t* smem) {
  using T = TcTile<BN>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  return {smem, reinterpret_cast<uint32_t*>(smem + T::kWordOff), full,
          full + kTcStages};
}

__device__ __forceinline__ uint8_t* tc_smem(uint8_t* raw) {
  return raw + ((1024 - (tc::smem_addr(raw) & 1023)) & 1023);
}

// K-steps of the loop: at least one (Kp = 0 is one step of zero words).
__device__ __forceinline__ int tc_ktiles(int kp) {
  return max(1, (kp + kTcWords - 1) / kTcWords);
}

// Thread 0 sets up the ring's barriers; the block syncs after.
__device__ __forceinline__ void tc_init(const TcRing& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      tc::mbar_init(&r.full[s], 32);                   // cp.async arrivals
      tc::mbar_init(&r.empty[s], kTcConsumers / 32);   // one per warp
    }
    tc::mbar_init_fence();
  }
}

// The producer warp: each step's words of the block's A rows (m0..) and B
// rows (n0..) into the ring, zero past M, P and Kp.
template <int BN>
__device__ __forceinline__ void tc_produce(const TcRing& r,
                                           const uint32_t* az,
                                           const uint32_t* bz, int m, int p,
                                           int kp, int m0, int n0, int vec16,
                                           int lane) {
  using T = TcTile<BN>;
  const int ktiles = tc_ktiles(kp);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kTcStages;
    if (kt >= kTcStages)
      tc::mbar_wait(&r.empty[s], (kt / kTcStages - 1) & 1);
    uint32_t* ws = r.words + s * T::kStageWords;
    const int w0 = kt * kTcWords;
    if (vec16) {
      for (int i = lane; i < T::kRows; i += 32) {
        const int gr = i < kTcM ? m0 + i : n0 + i - kTcM;
        const bool ok = i < kTcM ? gr < m : gr < p;
        const uint32_t* src =
            (i < kTcM ? az : bz) + static_cast<long long>(gr) * kp + w0;
        tc::cp_async<16>(ws + i * kTcWords, ok ? src : az, ok ? 16 : 0);
      }
    } else {
      for (int i = lane; i < T::kStageWords; i += 32) {
        const int row = i / kTcWords, ww = w0 + i % kTcWords;
        const int gr = row < kTcM ? m0 + row : n0 + row - kTcM;
        const bool ok = (row < kTcM ? gr < m : gr < p) && ww < kp;
        const uint32_t* src =
            (row < kTcM ? az : bz) + static_cast<long long>(gr) * kp + ww;
        tc::cp_async<4>(ws + i, ok ? src : az, ok ? 4 : 0);
      }
    }
    tc::cp_async_arrive(&r.full[s]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The consumer warpgroups: acc (the wgmma fragment of warpgroup tid / 128's
// 64 rows x BN columns) = the int8 product of the unpacked operands.
template <bool kAndDc, int BN>
__device__ __forceinline__ void tc_consume(const TcRing& r, int kp,
                                           int32_t (&acc)[BN / 2]) {
  using T = TcTile<BN>;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;
  // Thread tid unpacks 16-byte chunk tid % 8 of rows tid / 8 + 32 j: the
  // chunk's 16 values are bits 16 * (c % 2) .. + 15 of the row's word c / 2
  // of the step.
  const int c = tid & 7;
  const int r0 = tid >> 3;
  const int shift = 16 * (c & 1);
  const int ktiles = tc_ktiles(kp);
  // Step kt: unpack the stage's words into tile buffer kt % 3 (the words
  // go back to the producer at once), then issue its wgmmas and, while
  // they run, wait for those of step kt - 1.  Buffer kt % 3 was last read
  // by the wgmmas of step kt - 3, which every warpgroup waited for before
  // the barrier of step kt - 1.
  int kt = 0;
  do {
    const int s = kt % kTcStages;
    tc::mbar_wait(&r.full[s], (kt / kTcStages) & 1);
    uint8_t* tile = r.tiles + (kt % kTcBufs) * T::kTileBytes;
    const uint32_t* ws = r.words + s * T::kStageWords + (c >> 1);
    // words past Kp are zero operands: in ±1 form a zero word is all -1
    const bool live = kt * kTcWords + (c >> 1) < kp;
#pragma unroll
    for (int j = 0; j < T::kChunks; ++j) {
      const int row = r0 + 32 * j;
      const uint32_t half = (ws[row * kTcWords] >> shift) & 0xFFFFu;
      *reinterpret_cast<uint4*>(tile + tc::swz(row, c)) =
          live ? tc::bits16_to_s8<!kAndDc>(half) : make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    if ((tid & 31) == 0) tc::mbar_arrive(&r.empty[s]);
    tc::fence_proxy_async();
    tc::named_sync(1, kTcConsumers);
    const uint8_t* at = tile + wg * 64 * tc::kRowBytes;
    const uint8_t* bt = tile + kTcM * tc::kRowBytes;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_s8(acc, tc::desc_b128(at + 32 * kk),
                   tc::desc_b128(bt + 32 * kk));
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
  } while (++kt < ktiles);
  tc::wgmma_wait<0>();
  tc::fence_operands(acc);
}

// ones[i] = popcount of A row m0 + i over all its words (0 past M), for a
// dc derived from a; threads 0 .. kTcM - 1.
__device__ __forceinline__ void tc_row_ones(const uint32_t* az, int m, int kp,
                                            int m0, int* ones) {
  const int tid = threadIdx.x;
  if (tid >= kTcM) return;
  int n = 0;
  if (m0 + tid < m) {
    const uint32_t* row = az + static_cast<long long>(m0 + tid) * kp;
#pragma unroll 8
    for (int w = 0; w < kp; ++w) n += __popc(row[w]);
  }
  ones[tid] = n;
}

// -- rbmm_int on the tensor cores ---------------------------------------------

template <int BN>
struct IntTile {
  using T = TcTile<BN>;
  static constexpr int kPitch = BN + 8;   // staged int32 row, + 8 banks
  static constexpr int kOnesOff = T::kExtraOff;
  static constexpr int kSmem = kOnesOff + kTcM * 4 + 1024;   // + align
  static_assert(kTcM * kPitch * 4 <= kTcBufs * T::kTileBytes,
                "the staged output fits over the unpacked tiles");
};

template <bool kAndDc, int BN>
__global__ void __launch_bounds__(kTcThreads)
    rbmm_int_tc_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       const int32_t* __restrict__ dc, int m, int p, int kp,
                       int k, int vec16, int32_t* __restrict__ out) {
  using T = TcTile<BN>;
  using I = IntTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tc_smem(smem_raw);
  const TcRing ring = tc_ring<BN>(smem);
  int* ones_s = reinterpret_cast<int*>(smem + I::kOnesOff);

  const int tid = threadIdx.x;
  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * kTcM;
  const int n0 = blockIdx.x * BN;
  const uint32_t* az = a + z * m * static_cast<long long>(kp);
  const uint32_t* bz = b + z * p * static_cast<long long>(kp);

  tc_init(ring);
  __syncthreads();
  if (tid >= kTcConsumers) {   // the producer warp
    tc_produce<BN>(ring, az, bz, m, p, kp, m0, n0, vec16, tid - kTcConsumers);
    return;
  }
  const bool derive_dc = kAndDc && dc == nullptr;
  if (derive_dc) tc_row_ones(az, m, kp, m0, ones_s);
  int32_t acc[T::kAcc];
  tc_consume<kAndDc, BN>(ring, kp, acc);
  // every warpgroup is past its last wgmma (the tiles are free) and ones_s
  // is complete
  tc::named_sync(1, kTcConsumers);

  const int wg = tid / 128;
  const int lane = tid & 31;
  const int rw = 64 * wg + 16 * ((tid / 32) & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int32_t* st = reinterpret_cast<int32_t*>(smem);   // kTcM x kPitch
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = rw + 8 * h;
    const int row = m0 + rl;
    // score = dot - off (xnor: the ±1 pad correction) or 2 dot - off
    // (and_dc: off = K - d)
    int off = 32 * kp - k;
    if (kAndDc && row < m)
      off = k - (derive_dc ? k - ones_s[rl] : dc[z * m + row]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      *reinterpret_cast<int2*>(st + rl * I::kPitch + 8 * j + cq) =
          kAndDc ? make_int2(2 * x - off, 2 * y - off)
                 : make_int2(x - off, y - off);
    }
  }
  // each warpgroup writes back its own 64 rows, row-contiguous
  tc::named_sync(2 + wg, 128);
  const int t = tid & 127;
  int32_t* oz = out + z * m * static_cast<long long>(p);
  if (p % 4 == 0) {   // 16-byte aligned rows: 16-byte stores
    constexpr int kVec = BN / 4;   // 16-byte pieces of a tile row
#pragma unroll 4
    for (int i = t; i < 64 * kVec; i += 128) {
      const int rl = 64 * wg + i / kVec, cv = 4 * (i % kVec);
      if (m0 + rl < m && n0 + cv < p)
        *reinterpret_cast<int4*>(oz + static_cast<long long>(m0 + rl) * p +
                                 n0 + cv) =
            *reinterpret_cast<const int4*>(st + rl * I::kPitch + cv);
    }
  } else {
#pragma unroll 4
    for (int i = t; i < 64 * BN; i += 128) {
      const int rl = 64 * wg + i / BN, cl = i % BN;
      if (m0 + rl < m && n0 + cl < p)
        oz[static_cast<long long>(m0 + rl) * p + n0 + cl] =
            st[rl * I::kPitch + cl];
    }
  }
}

template <bool kAndDc, int BN>
int launch_int_tc(const uint32_t* a, const uint32_t* b, const int32_t* dc,
                  long long batch, long long m, long long p, long long kp,
                  long long k, int32_t* out, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rbmm_int_tc_kernel<kAndDc, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, IntTile<BN>::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(static_cast<unsigned>((p + BN - 1) / BN),
                  static_cast<unsigned>((m + kTcM - 1) / kTcM),
                  static_cast<unsigned>(batch));
  // 16-byte copies of a row's 4 words when every row start is aligned
  const int vec16 = kp > 0 && kp % kTcWords == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
  rbmm_int_tc_kernel<kAndDc, BN>
      <<<grid, kTcThreads, IntTile<BN>::kSmem, s>>>(
          a, b, dc, static_cast<int>(m), static_cast<int>(p),
          static_cast<int>(kp), static_cast<int>(k), vec16, out);
  return cobra_launch_status();
}

}  // namespace

// The decode route (M <= 16; any M works, in blocks of rows).  scheme: 0 =
// xnor, 1 = and_dc; dc may be null (derived from a).  rows (1, 2, 4 or 8)
// make a row block, lanes (1 to 32, a power of two) share a column,
// warps (1 to 8) make a block, vec (1, 2 or 4) words make a load:
// ops.decode_tile picks them from the shape; vec is lowered here where Kp
// or the operands' bases do not allow it.  The grid is (column tiles, row
// blocks, batch).
COBRA_API int cobra_rbmm_int(const void* a, const void* b, const void* dc,
                             long long batch, long long m, long long p,
                             long long kp, long long k, int scheme, int rows,
                             int lanes, int warps, int vec, void* out,
                             void* stream) {
  if (batch == 0 || m == 0 || p == 0) return 0;
  const long long cols = 32LL * warps / (lanes > 0 ? lanes : 1);
  const long long n_ct = (p + cols - 1) / cols;
  const long long n_rb = (m + rows - 1) / (rows > 0 ? rows : 1);
  if (warps < 1 || warps > 8 || lanes < 1 || lanes > 32 || rows < 1 ||
      n_ct > 0x7fffffffLL || n_rb > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b);
  while (vec > 1 && (kp % vec != 0 || bases % (4 * vec) != 0)) vec /= 2;
  const dim3 grid(static_cast<unsigned>(n_ct), static_cast<unsigned>(n_rb),
                  static_cast<unsigned>(batch));
  const int mode = scheme == 0 ? 0 : dc ? 1 : 2;
  auto s = static_cast<cudaStream_t>(stream);
  auto au = static_cast<const uint32_t*>(a);
  auto bu = static_cast<const uint32_t*>(b);
  auto dci = static_cast<const int32_t*>(dc);
  auto o = static_cast<int32_t*>(out);
  const int mi = static_cast<int>(m), pi = static_cast<int>(p),
            kpi = static_cast<int>(kp), ki = static_cast<int>(k);
  bool ok = false;
  switch (rows) {
#define COBRA_DEC_M(MT)                                                     \
  case MT:                                                                  \
    ok = launch_dec_g<MT>(lanes, vec, grid, 32 * warps, s, au, bu, dci, mi, \
                          pi, kpi, ki, mode, o);                            \
    break;
    COBRA_DEC_M(1) COBRA_DEC_M(2) COBRA_DEC_M(4) COBRA_DEC_M(8)
#undef COBRA_DEC_M
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return cobra_launch_status();
}

// The tensor-core route: the same contract; bn (64, 128 or 192) is the
// tile's N.
COBRA_API int cobra_rbmm_int_tc(const void* a, const void* b, const void* dc,
                                long long batch, long long m, long long p,
                                long long kp, long long k, int scheme, int bn,
                                void* out, void* stream) {
  if (batch == 0 || m == 0 || p == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto au = static_cast<const uint32_t*>(a);
  auto bu = static_cast<const uint32_t*>(b);
  auto dci = static_cast<const int32_t*>(dc);
  auto o = static_cast<int32_t*>(out);
#define COBRA_INT_TC(BN)                                                   \
  return scheme ? launch_int_tc<true, BN>(au, bu, dci, batch, m, p, kp, k, \
                                          o, s)                            \
                : launch_int_tc<false, BN>(au, bu, dci, batch, m, p, kp, k, \
                                           o, s)
  if (bn == 192) COBRA_INT_TC(192);
  if (bn == 128) COBRA_INT_TC(128);
  if (bn == 64) COBRA_INT_TC(64);
#undef COBRA_INT_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- rbmm_binary -------------------------------------------------------------

namespace {

constexpr int kBinN = 192;       // columns per block: wgmma n192
using BinTile = TcTile<kBinN>;
constexpr int kBinThetaOff = BinTile::kExtraOff;
constexpr int kBinOnesOff = kBinThetaOff + kBinN * 4;
constexpr int kBinSmem = kBinOnesOff + kTcM * 4 + 1024;   // + align

template <bool kAndDc, bool kPacked>
__global__ void __launch_bounds__(kTcThreads)
    rbmm_binary_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       const int32_t* __restrict__ dc,
                       const int32_t* __restrict__ theta, long long ts_z,
                       long long ts_m, long long ts_p, int m, int p, int kp,
                       int k, int causal, int vec16,
                       int32_t* __restrict__ out,
                       int32_t* __restrict__ dc_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tc_smem(smem_raw);
  const TcRing ring = tc_ring<kBinN>(smem);
  int32_t* theta_s = reinterpret_cast<int32_t*>(smem + kBinThetaOff);
  int* ones_s = reinterpret_cast<int*>(smem + kBinOnesOff);

  const int tid = threadIdx.x;
  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * kTcM;
  const int n0 = blockIdx.x * kBinN;
  const uint32_t* az = a + z * m * static_cast<long long>(kp);
  const uint32_t* bz = b + z * p * static_cast<long long>(kp);

  tc_init(ring);
  __syncthreads();
  if (tid >= kTcConsumers) {   // the producer warp
    tc_produce<kBinN>(ring, az, bz, m, p, kp, m0, n0, vec16,
                      tid - kTcConsumers);
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
  if (derive_dc) tc_row_ones(az, m, kp, m0, ones_s);

  int32_t acc[BinTile::kAcc];
  tc_consume<kAndDc, kBinN>(ring, kp, acc);
  tc::named_sync(1, kTcConsumers);   // theta_s and ones_s are complete

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
                  static_cast<unsigned>((m + kTcM - 1) / kTcM),
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
  const int vec16 = kp > 0 && kp % kTcWords == 0 &&
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
    rbmm_binary_kernel<AND_DC, PACKED><<<grid, kTcThreads, kBinSmem, s>>>(   \
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
