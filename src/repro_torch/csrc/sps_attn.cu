// sps_attention: fused causal SPS binary attention over packed words.
//
// Replaces the TPU kernel src/repro/kernels/sps_attn/kernel.py
// sps_attention (_kernel_vpu, _kernel_mxu, _probs_tile, _pack_cols):
//   score  c = 2*popcount(~(q ^ k)) - (d_h + 2*pad)       (Eq. 7, pad-0)
//   prob   p = (c >= theta[h]) & (key < L) & (key <= row if causal)
//   ctx[row, d] = sum_key p * v[key, d] = 2*popcount(P & V^T[d]) - nnz(P)
// with no softmax state, so key tiles combine by plain integer addition
// and the L x L score matrix never exists, not even per tile in memory.
// Inputs are batched and GQA-aware: q (B, H, L, dhp), k (B, Hkv, L, dhp),
// vt (B, Hkv, d_h, ceil(L/32)) and query head h reads KV head h / (H/Hkv),
// so K and V are never repeated to H heads.
//
// Bound on the H100: bytes.  At the main-path prefill shape (B=8, H=9,
// Hkv=3, L=128, d_h=64) it reads 0.12 MB of packed Q, K and V^T and writes
// 2.36 MB of int32 context (0.74 us at 3.35 TB/s); its ~2 M word-ops of
// scoring and ~4 M of context are below that at the non-tensor 32-bit rate.
// Design: one block per (query tile of 32 rows, head, sequence), four
// warps.  Per key tile of 32 keys the block stages K (32 x dhp words) and
// the tile's V^T words (one per d) in shared memory; each warp owns 8 query
// rows, a lane scores one key, and __ballot_sync packs the 32 probability
// bits of the row into one word in registers (lane i -> bit i, the V^T
// packing order).  That word is and_dc-popcounted against the d_h V^T words
// into a shared int32 accumulator.  The key loop stops at the causal limit
// of the tile.
#include "common.cuh"

namespace {

constexpr int kBQ = 32;      // query rows per block
constexpr int kWarps = 4;
constexpr int kMaxDhp = 8;   // d_h <= 256
constexpr int kMaxDh = kMaxDhp * 32;

__global__ void __launch_bounds__(kWarps * 32)
    sps_attention_kernel(const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ k,
                         const uint32_t* __restrict__ vt,
                         const int32_t* __restrict__ theta, int h_q,
                         int h_kv, int len, int dh, int dhp, int len_words,
                         int causal, int32_t* __restrict__ out) {
  __shared__ uint32_t q_s[kBQ][kMaxDhp];
  __shared__ uint32_t k_s[32][kMaxDhp + 1];
  __shared__ uint32_t vt_s[kMaxDh];
  __shared__ int32_t ctx_s[kBQ * kMaxDh];

  const int i0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (h_q / h_kv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const uint32_t* qb = q + (b * h_q + h) * static_cast<long long>(len) * dhp;
  const uint32_t* kb = k + (b * h_kv + hk) * static_cast<long long>(len) * dhp;
  const uint32_t* vb =
      vt + (b * h_kv + hk) * static_cast<long long>(dh) * len_words;

  for (int i = tid; i < kBQ * dhp; i += kWarps * 32) {
    const int r = i / dhp, w = i % dhp;
    q_s[r][w] = i0 + r < len ? qb[static_cast<long long>(i0 + r) * dhp + w]
                             : 0u;
  }
  for (int i = tid; i < kBQ * dh; i += kWarps * 32) ctx_s[i] = 0;

  const int score_const = dh + 2 * (dhp * 32 - dh);
  const int th = theta[h];
  const int last_key =
      causal ? min(len - 1, i0 + kBQ - 1) : len - 1;
  const int tiles = last_key / 32 + 1;

  for (int j = 0; j < tiles; ++j) {
    __syncthreads();  // previous tile's K / V^T reads are done
    for (int i = tid; i < 32 * dhp; i += kWarps * 32) {
      const int kk = i / dhp, w = i % dhp;
      const int key = j * 32 + kk;
      k_s[kk][w] = key < len ? kb[static_cast<long long>(key) * dhp + w] : 0u;
    }
    for (int d = tid; d < dh; d += kWarps * 32)
      vt_s[d] = vb[static_cast<long long>(d) * len_words + j];
    __syncthreads();

    const int key = j * 32 + lane;
    for (int rr = warp; rr < kBQ; rr += kWarps) {
      const int row = i0 + rr;
      if (row >= len) break;  // rows only grow: the whole warp leaves
      int pc = 0;
      for (int w = 0; w < dhp; ++w) pc += __popc(~(q_s[rr][w] ^ k_s[lane][w]));
      const bool bit = (2 * pc - score_const >= th) && key < len &&
                       (!causal || key <= row);
      const uint32_t pw = __ballot_sync(0xffffffffu, bit);
      if (pw == 0u) continue;  // warp-uniform
      const int nnz = __popc(pw);
      for (int d = lane; d < dh; d += 32)
        ctx_s[rr * dh + d] += 2 * __popc(pw & vt_s[d]) - nnz;
    }
  }
  __syncthreads();

  int32_t* ob = out + (b * h_q + h) * static_cast<long long>(len) * dh;
  for (int i = tid; i < kBQ * dh; i += kWarps * 32) {
    const int r = i / dh, d = i % dh;
    if (i0 + r < len) ob[static_cast<long long>(i0 + r) * dh + d] = ctx_s[i];
  }
}

}  // namespace

COBRA_API int cobra_sps_attention(const void* q, const void* k,
                                  const void* vt, const void* theta,
                                  long long batch, long long h_q,
                                  long long h_kv, long long len, long long dh,
                                  int causal, void* out, void* stream) {
  if (batch * h_q * len == 0) return 0;
  const long long dhp = (dh + 31) / 32;
  if (dhp > kMaxDhp || h_kv <= 0 || h_q % h_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((len + kBQ - 1) / kBQ),
                  static_cast<unsigned>(h_q), static_cast<unsigned>(batch));
  sps_attention_kernel<<<grid, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(vt), static_cast<const int32_t*>(theta),
      static_cast<int>(h_q), static_cast<int>(h_kv), static_cast<int>(len),
      static_cast<int>(dh), static_cast<int>(dhp),
      static_cast<int>((len + 31) / 32), causal, static_cast<int32_t*>(out));
  return cobra_launch_status();
}
