// sps_attention: fused SPS binary attention over packed words, on the int8
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/sps_attn/kernel.py
// sps_attention (_kernel_vpu, _kernel_mxu, _probs_tile, _pack_cols):
//   score  c = 2*popcount(~(q ^ k)) - (d_h + 2*pad)       (Eq. 7, pad-0)
//   prob   p = (c >= theta[h]) & (key < L_b) & (key <= row if causal)
//              & (key > row - window if window > 0)
//   ctx[row, d] = sum_key p * v[key, d] = 2*popcount(P & V^T[d]) - nnz(P)
// with no softmax state, so key tiles combine by plain integer addition
// and the L x L score matrix never leaves the registers and one shared
// tile.  Inputs are batched and GQA-aware: q (B, H, L, dhp), k (B, Hkv, L,
// dhp), vt (B, Hkv, d_h, ceil(L/32)) and query head h reads KV head
// h / (H/Hkv), so K and V are never repeated to H heads.  L_b is L, or
// lens[b] when the caller passes per-sequence key lengths (a ragged,
// right-padded batch: the JAX model's ragged prefill masks keys at columns
// >= seq_lens[b] in every row; the TPU kernel masks one global length
// only).  lens is read once per block, and key tiles past L_b are skipped.
// A causal sliding window (window > 0: key c visible from row r iff
// r - window < c <= r, as the JAX model's windowed prefill masks in its
// jnp body) skips the key tiles wholly before the block's first visible
// key, row i0's i0 - window + 1, so a windowed prefill costs O(L * window)
// tiles instead of O(L^2).  theta is one threshold per query head, or a
// row table (H, T), the `row` SPS granularity: row r reads column
// min(r, T - 1).  Neither operand is the TPU kernel's; with window = 0 and
// T = 0 the kernel is the one before them.
//
// Both products are int8 matrix products with exact int32 sums:
//   * the score is the ±1 dot product of q and k over all 32 * dhp bits,
//     minus pad: a pad bit adds +1 when q and k agree there and -1 when
//     they differ, exactly as the popcount form counts it, so
//     c = dot - pad for any words;
//   * the context is P ({0,1}) times V (±1): sum_key p * v is the and_dc
//     context itself, no nnz term.
//
// Bound on the H100: bytes.  The encoder shape (B=8, L=512, H=Hkv=12,
// d_h=64, bidirectional) writes 12.6 MB of int32 context (3.8 us at 3.35
// TB/s) against 3.2 G int8 multiply-adds (3.3 us at 1,979 TOP/s); the
// popcount design this replaces issued ~100 M popcounts, a floor of ~24 us
// at 16 per clock per SM.
//
// Design: a block owns 64 query rows of up to three query heads of one KV
// group (one consumer warpgroup each; more heads take more blocks), so a
// key tile is unpacked once for the group.  Per key tile of 128 keys all
// threads unpack K (±1 int8, 128 keys x 32 * dhp bytes) and the tile's
// V^T words (±1 int8, 64 d rows x 128 keys: the words are K-major along
// the keys already) into 128-byte-swizzled tiles; each warpgroup unpacked
// its Q rows once.  Then per warpgroup: S = Q K^T by dhp wgmma
// m64n128k32 (only the k-steps that hold bits are issued, so the unused
// half of a d_h = 64 row is never read or cleared); the thresholds and
// the masks by global index (key < L, key <= row) turn the accumulator
// fragment into {0,1} bytes in a swizzled P tile; the proxy fence and a
// warpgroup barrier; ctx += P V by four wgmma m64n64k32.  K and V^T words
// of the next tile are loaded into registers while S runs and unpacked
// into the other of two tile buffers while the context product runs, so
// the block meets once per tile.  Words past the tensors' ends are never
// read: they unpack from zero and P is 0 there.  d_h > 64 runs a pass per
// 64 context columns (the scores are recomputed per pass).
#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kBM = 64;        // query rows per block (one wgmma M)
constexpr int kBK = 128;       // keys per tile: one 128-byte row of P, V^T
constexpr int kBD = 64;        // context columns per pass (wgmma n64)
constexpr int kMaxWG = 3;      // query heads (consumer warpgroups) a block
constexpr int kMaxDhp = 8;     // d_h <= 256: two 128-byte panels of Q, K
constexpr int kPanelWords = 4; // words of one 128-byte panel row
constexpr int kQBytes = kBM * tc::kRowBytes;   // one Q panel
constexpr int kKBytes = kBK * tc::kRowBytes;   // one K panel
constexpr int kVBytes = kBD * tc::kRowBytes;   // one V^T tile
constexpr int kPBytes = kBM * tc::kRowBytes;   // one P tile
// V^T words a thread stages per tile at the narrowest block (128 threads)
constexpr int kVPer = kBD * kPanelWords / 128;
constexpr int kSmemMax = kMaxWG * 2 * kQBytes + 2 * 2 * kKBytes +
                         2 * kVBytes + kMaxWG * kPBytes + 1024;

struct Tiles {
  uint8_t* q;   // [warpgroup][panel]
  uint8_t* k;   // [buffer][panel]
  uint8_t* v;   // [buffer]
  uint8_t* p;   // [warpgroup]
};

// One packed word to two 16-byte chunks of ±1 int8 at chunks c, c + 1 of
// row r of a swizzled tile.
__device__ __forceinline__ void unpack_word(uint8_t* tile, int r, int c,
                                            uint32_t w) {
  *reinterpret_cast<uint4*>(tile + tc::swz(r, c)) =
      tc::bits16_to_s8<true>(w & 0xFFFFu);
  *reinterpret_cast<uint4*>(tile + tc::swz(r, c + 1)) =
      tc::bits16_to_s8<true>(w >> 16);
}

template <int kDhp>
struct Staged {
  static constexpr int kKPer = kBK * kDhp / 128;   // at 128 threads
  uint32_t k[kKPer];
  uint32_t v[kVPer];
};

// Load key tile jt's K words and its V^T words of context pass dc (zero
// past L, d_h and the words of a row).
template <int kDhp>
__device__ __forceinline__ void load_tile(Staged<kDhp>& s,
                                          const uint32_t* kb,
                                          const uint32_t* vb, int jt, int dc,
                                          int len, int dh, int lw, int tid,
                                          int nthreads) {
  const long long k0 = static_cast<long long>(jt) * kBK * kDhp;
  const long long kend = static_cast<long long>(len) * kDhp;
#pragma unroll
  for (int u = 0; u < Staged<kDhp>::kKPer; ++u) {
    const int i = tid + nthreads * u;
    s.k[u] = i < kBK * kDhp && k0 + i < kend ? kb[k0 + i] : 0u;
  }
#pragma unroll
  for (int u = 0; u < kVPer; ++u) {
    const int i = tid + nthreads * u;
    const int d = dc * kBD + i / kPanelWords;
    const int w = jt * kPanelWords + i % kPanelWords;
    s.v[u] = i < kBD * kPanelWords && d < dh && w < lw
                 ? vb[static_cast<long long>(d) * lw + w]
                 : 0u;
  }
}

template <int kDhp>
__device__ __forceinline__ void store_tile(const Staged<kDhp>& s,
                                           uint8_t* kt, uint8_t* vt, int tid,
                                           int nthreads) {
#pragma unroll
  for (int u = 0; u < Staged<kDhp>::kKPer; ++u) {
    const int i = tid + nthreads * u;
    if (i < kBK * kDhp) {
      const int r = i / kDhp, w = i % kDhp;
      unpack_word(kt + (w / kPanelWords) * kKBytes, r,
                  2 * (w % kPanelWords), s.k[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kVPer; ++u) {
    const int i = tid + nthreads * u;
    if (i < kBD * kPanelWords)
      unpack_word(vt, i / kPanelWords, 2 * (i % kPanelWords), s.v[u]);
  }
}

template <int kDhp>
__global__ void __launch_bounds__(kMaxWG * 128)
    sps_attention_kernel(const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ k,
                         const uint32_t* __restrict__ vt,
                         const int32_t* __restrict__ theta,
                         const int32_t* __restrict__ lens, int h_q,
                         int h_kv, int len, int dh, int lw, int window,
                         int theta_cols, int causal, int nwg,
                         int head_groups, int32_t* __restrict__ out) {
  constexpr int npan = kDhp > kPanelWords ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) &
                              1023);
  Tiles t;
  t.q = smem;
  t.k = t.q + nwg * npan * kQBytes;
  t.v = t.k + 2 * npan * kKBytes;
  t.p = t.v + 2 * kVBytes;

  const int tid = threadIdx.x;
  const int nthreads = nwg * 128;
  const int wg = tid / 128;
  const int lane = tid & 31;
  const int i0 = blockIdx.x * kBM;
  const int groups = h_q / h_kv;
  const int hk = blockIdx.y / head_groups;
  const int g = (blockIdx.y % head_groups) * nwg + wg;
  // a warpgroup past the group's last head computes that head again (no
  // branch around the wgmmas) and stores nothing
  const bool live = g < groups;
  const int h = hk * groups + min(g, groups - 1);
  const long long b = blockIdx.z;
  // this sequence's keys: L, or lens[b] (clamped to [0, L])
  const int len_b = lens ? min(max(lens[b], 0), len) : len;
  const uint32_t* kb = k + (b * h_kv + hk) * static_cast<long long>(len) *
                               kDhp;
  const uint32_t* vb = vt + (b * h_kv + hk) * static_cast<long long>(dh) *
                                lw;
  // the key tiles this block reads: from the one holding its first
  // visible key to the one holding its last; at least one tile, because
  // its first wgmma clears the context accumulator
  const int last_key = causal ? min(len_b - 1, i0 + kBM - 1) : len_b - 1;
  const int tiles = max(last_key, 0) / kBK + 1;
  const int jt0 = window > 0 ? min(max(i0 - window + 1, 0) / kBK, tiles - 1)
                             : 0;

  // this warpgroup's Q rows (zero past L), unpacked once; their words
  // and key tile jt0's are loaded together
  Staged<kDhp> st;
  load_tile(st, kb, vb, jt0, 0, len, dh, lw, tid, nthreads);
  {
    constexpr int kQPer = (kBM * kDhp + 127) / 128;
    const uint32_t* qb = q + (b * h_q + h) * static_cast<long long>(len) *
                                 kDhp + static_cast<long long>(i0) * kDhp;
    uint32_t qw[kQPer];
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int i = (tid & 127) + 128 * u;
      qw[u] = i < kBM * kDhp && i0 + i / kDhp < len ? qb[i] : 0u;
    }
    uint8_t* qt = t.q + wg * npan * kQBytes;
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int i = (tid & 127) + 128 * u;
      if (i < kBM * kDhp)
        unpack_word(qt + (i % kDhp / kPanelWords) * kQBytes, i / kDhp,
                    2 * (i % kDhp % kPanelWords), qw[u]);
    }
  }
  const int passes = (dh + kBD - 1) / kBD;

  // the accumulator fragment: rows wr and wr + 8, columns 8j + 2 tig + e
  const int wr = 16 * ((tid / 32) & 3) + (lane >> 2);
  const int tig = lane & 3;
  // the thresholds of those two rows; c >= theta  <=>  dot >= theta + pad
  int thp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    thp[hh] = (theta_cols > 0
                   ? theta[static_cast<long long>(h) * theta_cols +
                           min(i0 + wr + 8 * hh, theta_cols - 1)]
                   : theta[h]) +
              (kDhp * 32 - dh);
  const uint8_t* qt = t.q + wg * npan * kQBytes;
  uint8_t* pt = t.p + wg * kPBytes;
  int32_t s_acc[kBK / 2];
  int32_t ctx[kBD / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s_acc[i] = 0;
#pragma unroll
  for (int i = 0; i < kBD / 2; ++i) ctx[i] = 0;

  for (int dc = 0; dc < passes; ++dc) {
    if (dc > 0) load_tile(st, kb, vb, jt0, dc, len, dh, lw, tid, nthreads);
    store_tile(st, t.k, t.v, tid, nthreads);
    tc::fence_proxy_async();
    __syncthreads();
    for (int jt = jt0; jt < tiles; ++jt) {
      const int buf = (jt - jt0) & 1;
      const uint8_t* kt = t.k + buf * npan * kKBytes;
      const uint8_t* vtile = t.v + buf * kVBytes;
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDhp; ++kk)
        tc::wgmma_s8(s_acc,
                     tc::desc_b128(qt + (kk / kPanelWords) * kQBytes +
                                   32 * (kk % kPanelWords)),
                     tc::desc_b128(kt + (kk / kPanelWords) * kKBytes +
                                   32 * (kk % kPanelWords)),
                     kk > 0);
      tc::wgmma_commit();
      const bool next = jt + 1 < tiles;
      if (next)
        load_tile(st, kb, vb, jt + 1, dc, len, dh, lw, tid, nthreads);
      {
        tc::wgmma_wait<0>();
        tc::fence_operands(s_acc);
        // probabilities of the tile's keys as {0,1} bytes
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = wr + 8 * hh;
          const int row = i0 + rl;
          const int lim = (causal ? min(len_b, row + 1) : len_b) - jt * kBK;
          // the window's first visible column of the tile (every column
          // when there is no window)
          const int lo = window > 0 ? row - window + 1 - jt * kBK : 0;
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
            const int col = 8 * j + 2 * tig;
            const uint32_t b0 = col >= lo && col < lim &&
                                s_acc[4 * j + 2 * hh] >= thp[hh];
            const uint32_t b1 = col + 1 >= lo && col + 1 < lim &&
                                s_acc[4 * j + 2 * hh + 1] >= thp[hh];
            *reinterpret_cast<uint16_t*>(pt + tc::swz(rl, j >> 1) +
                                         8 * (j & 1) + 2 * tig) =
                static_cast<uint16_t>(b0 | (b1 << 8));
          }
        }
        tc::fence_proxy_async();
        tc::named_sync(1 + wg, 128);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          tc::wgmma_s8(ctx, tc::desc_b128(pt + 32 * kk),
                       tc::desc_b128(vtile + 32 * kk), jt > jt0 || kk > 0);
        tc::wgmma_commit();
      }
      if (next) {
        store_tile(st, t.k + (buf ^ 1) * npan * kKBytes,
                   t.v + (buf ^ 1) * kVBytes, tid, nthreads);
        tc::fence_proxy_async();
      }
      tc::wgmma_wait<0>();
      __syncthreads();   // tile jt is consumed, tile jt + 1 is in place
    }
    tc::fence_operands(ctx);
    int32_t* ob = out + (b * h_q + h) * static_cast<long long>(len) * dh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = i0 + wr + 8 * hh;
      int32_t* orow = ob + static_cast<long long>(row) * dh;
#pragma unroll
      for (int j = 0; j < kBD / 8; ++j) {
        const int d = dc * kBD + 8 * j + 2 * tig;
        const int x = ctx[4 * j + 2 * hh], y = ctx[4 * j + 2 * hh + 1];
        if (!live || row >= len) {
        } else if (d + 1 < dh && dh % 2 == 0) {
          *reinterpret_cast<int2*>(orow + d) = make_int2(x, y);
        } else {
          if (d < dh) orow[d] = x;
          if (d + 1 < dh) orow[d + 1] = y;
        }
      }
    }
  }
}

template <int kDhp>
int launch(const uint32_t* q, const uint32_t* k, const uint32_t* vt,
           const int32_t* theta, const int32_t* lens, long long batch,
           long long h_q, long long h_kv, long long len, long long dh,
           long long window, long long theta_cols, int causal,
           int32_t* out, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sps_attention_kernel<kDhp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  // the G query heads of a KV group in as few blocks as hold them, the
  // heads spread evenly over those blocks
  const long long groups = h_q / h_kv;
  const long long head_groups = (groups + kMaxWG - 1) / kMaxWG;
  const int nwg = static_cast<int>((groups + head_groups - 1) / head_groups);
  const int npan = kDhp > kPanelWords ? 2 : 1;
  const int smem = nwg * npan * kQBytes + 2 * npan * kKBytes + 2 * kVBytes +
                   nwg * kPBytes + 1024;
  const dim3 grid(static_cast<unsigned>((len + kBM - 1) / kBM),
                  static_cast<unsigned>(h_kv * head_groups),
                  static_cast<unsigned>(batch));
  sps_attention_kernel<kDhp><<<grid, nwg * 128, smem, stream>>>(
      q, k, vt, theta, lens, static_cast<int>(h_q), static_cast<int>(h_kv),
      static_cast<int>(len), static_cast<int>(dh),
      static_cast<int>((len + 31) / 32), static_cast<int>(window),
      static_cast<int>(theta_cols), causal, nwg,
      static_cast<int>(head_groups), out);
  return cobra_launch_status();
}

}  // namespace

COBRA_API int cobra_sps_attention(const void* q, const void* k,
                                  const void* vt, const void* theta,
                                  const void* lens, long long batch,
                                  long long h_q, long long h_kv,
                                  long long len, long long dh,
                                  long long window, long long theta_cols,
                                  int causal, void* out, void* stream) {
  if (batch * h_q * len == 0) return 0;
  const long long dhp = (dh + 31) / 32;
  if (dh <= 0 || dhp > kMaxDhp || h_kv <= 0 || h_q % h_kv || window < 0 ||
      (window > 0 && !causal) || theta_cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto qu = static_cast<const uint32_t*>(q);
  auto ku = static_cast<const uint32_t*>(k);
  auto vu = static_cast<const uint32_t*>(vt);
  auto th = static_cast<const int32_t*>(theta);
  auto ln = static_cast<const int32_t*>(lens);
  auto o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dhp) {
#define COBRA_SPS(DHP)                                                    \
  case DHP:                                                               \
    return launch<DHP>(qu, ku, vu, th, ln, batch, h_q, h_kv, len, dh,     \
                       window, theta_cols, causal, o, s)
    COBRA_SPS(1); COBRA_SPS(2); COBRA_SPS(3); COBRA_SPS(4);
    COBRA_SPS(5); COBRA_SPS(6); COBRA_SPS(7); COBRA_SPS(8);
#undef COBRA_SPS
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
