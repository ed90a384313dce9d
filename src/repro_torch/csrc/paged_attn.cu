// paged_gather_decode: SPS decode attention over the packed page arena.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn/kernel.py
// paged_gather_decode (_kernel): one decode query per sequence, attended
// over pages resolved through the block table (entries clipped to [0, P]),
//   score  c = 2*popcount(~(q ^ k)) - (d_h + 2*pad)          (Eq. 7, pad-0)
//   prob   p = c >= theta[b, h]  &  col <= len[b]  &  col < ring_len
//   ctx[b, h, d] = sum_col p * v[col, d] = 2*popcount(P & V^T[d]) - nnz(P)
// with query head h reading KV head h / (H/Hkv).  q (B, H, dhp),
// k_pages (P+1, Hkv, page, dhp), vt_pages (P+1, Hkv, d_h, page/32),
// block_table (B, nblk), lengths (B,), theta (B, H) -> (B, H, d_h) int32.
// Masking is positional only: a trash-page (entry 0) column is masked by
// its position, never skipped for its entry.
//
// Bound on the H100: launch latency.  At the main-path shape (16 slots,
// H=9 over Hkv=3, d_h=64, page 32, 12 blocks) the live pages hold at most
// 16 x 12 x 3 x (32*2 + 64*1) x 4 B = 0.29 MB (0.09 us at 3.35 TB/s) and
// the word operations are ~2e5, so the few microseconds of a launch are
// the floor.  Design: one block per (KV head, sequence), four warps.  The
// TPU grid carries the context across pages in one core's memory; here
// the block itself loops over its table's pages in order, reading
// block_table[b, j], and stops at the first page past the last valid
// column.  Per page, a warp owns 32 columns: each lane XNOR-popcounts its
// K row against the G query heads of the group (held in shared memory),
// and __ballot_sync packs the G probability bits into LSB-first words
// (lane i -> bit i, the V^T order).  Threads over (g, d) then add
// 2*popc(pword & vt[d][w]) to their own int32 accumulators and nnz is
// summed per g; every accumulator has one owner and pages are taken in
// order, so the result is exact with no atomics.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDhp = 8;        // d_h <= 256
constexpr int kMaxDh = kMaxDhp * 32;
constexpr int kMaxG = 16;         // query heads per KV head
constexpr int kMaxPageWords = 8;  // page_size <= 256

__global__ void __launch_bounds__(kThreads)
    paged_gather_decode_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ k_pages,
                               const uint32_t* __restrict__ vt_pages,
                               const int32_t* __restrict__ block_table,
                               const int32_t* __restrict__ lengths,
                               const int32_t* __restrict__ theta, int h_q,
                               int h_kv, int dh, int dhp, int page,
                               int nblk, int npages, int ring,
                               int32_t* __restrict__ out) {
  __shared__ uint32_t q_s[kMaxG][kMaxDhp];
  __shared__ int32_t th_s[kMaxG];
  __shared__ uint32_t p_s[kMaxG][kMaxPageWords];
  __shared__ int32_t acc_s[kMaxG * kMaxDh];
  __shared__ int32_t nnz_s[kMaxG];

  const int hk = blockIdx.x;
  const long long b = blockIdx.y;
  const int groups = h_q / h_kv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pw = page / 32;
  const long long h0 = b * h_q + static_cast<long long>(hk) * groups;

  for (int i = tid; i < groups * dhp; i += kThreads)
    q_s[i / dhp][i % dhp] = q[h0 * dhp + i];
  for (int g = tid; g < groups; g += kThreads) {
    th_s[g] = theta[h0 + g];
    nnz_s[g] = 0;
  }
  for (int i = tid; i < groups * dh; i += kThreads) acc_s[i] = 0;

  const int score_const = dh + 2 * (dhp * 32 - dh);
  // largest valid column: col <= len && col < ring  <=>  col <= last
  const int last = min(lengths[b], ring - 1);

  for (int j = 0; j < nblk && j * page <= last; ++j) {
    const int phys = min(max(block_table[b * nblk + j], 0), npages - 1);
    const uint32_t* kp =
        k_pages + (static_cast<long long>(phys) * h_kv + hk) * page * dhp;
    const uint32_t* vp =
        vt_pages + (static_cast<long long>(phys) * h_kv + hk) * dh * pw;
    __syncthreads();  // the previous page's probability words are consumed
    for (int cw = warp; cw < pw; cw += kWarps) {
      const int col_in = cw * 32 + lane;
      const bool valid = j * page + col_in <= last;
      uint32_t kr[kMaxDhp];
      for (int w = 0; w < dhp; ++w) kr[w] = kp[col_in * dhp + w];
      for (int g = 0; g < groups; ++g) {
        int pc = 0;
        for (int w = 0; w < dhp; ++w) pc += __popc(~(q_s[g][w] ^ kr[w]));
        const bool bit = valid && 2 * pc - score_const >= th_s[g];
        const uint32_t word = __ballot_sync(0xffffffffu, bit);
        if (lane == 0) p_s[g][cw] = word;
      }
    }
    __syncthreads();
    for (int i = tid; i < groups * dh; i += kThreads) {
      const int g = i / dh, d = i % dh;
      int acc = acc_s[i];
      for (int w = 0; w < pw; ++w)
        acc += 2 * __popc(p_s[g][w] & vp[d * pw + w]);
      acc_s[i] = acc;
    }
    for (int g = tid; g < groups; g += kThreads)
      for (int w = 0; w < pw; ++w) nnz_s[g] += __popc(p_s[g][w]);
  }
  __syncthreads();

  for (int i = tid; i < groups * dh; i += kThreads)
    out[h0 * dh + i] = acc_s[i] - nnz_s[i / dh];
}

}  // namespace

COBRA_API int cobra_paged_gather_decode(
    const void* q, const void* k_pages, const void* vt_pages,
    const void* block_table, const void* lengths, const void* theta,
    long long batch, long long h_q, long long h_kv, long long dh,
    long long page, long long nblk, long long npages, long long ring,
    void* out, void* stream) {
  if (batch * h_q == 0) return 0;
  const long long dhp = (dh + 31) / 32;
  if (h_kv <= 0 || h_q % h_kv || h_q / h_kv > kMaxG || dhp > kMaxDhp ||
      page % 32 || page / 32 > kMaxPageWords || page <= 0 || npages <= 0 ||
      ring <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(h_kv), static_cast<unsigned>(batch));
  paged_gather_decode_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k_pages),
      static_cast<const uint32_t*>(vt_pages),
      static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(theta), static_cast<int>(h_q),
      static_cast<int>(h_kv), static_cast<int>(dh), static_cast<int>(dhp),
      static_cast<int>(page), static_cast<int>(nblk),
      static_cast<int>(npages), static_cast<int>(ring),
      static_cast<int32_t*>(out));
  return cobra_launch_status();
}
