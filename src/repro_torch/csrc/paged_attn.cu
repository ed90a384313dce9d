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
// the word operations are ~2e5, so the time is the launch plus the chain
// of dependent global-memory round trips.  Design: one block per (KV head,
// sequence) of 16 warps, and the pages of the sequence in parallel, one
// warp per page (a warp takes page j, j + 16, ... when the table is
// longer).  The lengths, the warp's table entries (lane l holds page
// warp + 16 l) and the query words are read together, and each warp
// issues its first page's K and V^T loads before the block's one setup
// barrier, so the live pages of every sequence cost two round trips,
// not one per page.  Per page a lane XNOR-popcounts its column's K row
// against the G query heads of the group (in shared memory) and
// __ballot_sync packs the G probability bits into LSB-first words (lane
// i -> bit i, the V^T order); then the lanes walk the page's V^T words
// (coalesced, d-major) and add each (g, d) partial 2*popc(P & V^T) -
// popc(P) into a shared int32 accumulator with a shared-memory atomic.
// SPS has no softmax state, so the pages' partials combine by integer
// addition, exact in any order; one barrier after the last page, then
// the block writes its G x d_h outputs.  No global atomics, no zero-filled
// output, one launch.
#include "common.cuh"

namespace {

constexpr int kWarps = 16;        // pages in flight per (KV head, sequence)
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDhp = 8;        // d_h <= 256
constexpr int kMaxDh = kMaxDhp * 32;
constexpr int kMaxG = 16;         // query heads per KV head
constexpr int kMaxPageWords = 8;  // page_size <= 256
constexpr int kVPre = 4;          // V^T words a lane holds at once

struct PageRegs {
  uint32_t k[kMaxDhp];   // the lane's column of word-column 0
  uint32_t v[kVPre];     // V^T words lane + 32 u of the page
};

// Issue the loads of one page's first K column word and first V^T words.
__device__ __forceinline__ void load_page(PageRegs& r, const uint32_t* kp,
                                          const uint32_t* vp, int dhp,
                                          int vwords, int lane) {
#pragma unroll
  for (int w = 0; w < kMaxDhp; ++w)
    r.k[w] = w < dhp ? kp[lane * dhp + w] : 0u;
#pragma unroll
  for (int u = 0; u < kVPre; ++u) {
    const int e = lane + 32 * u;
    r.v[u] = e < vwords ? vp[e] : 0u;
  }
}

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
  __shared__ int32_t acc_s[kMaxG * kMaxDh];
  __shared__ uint32_t p_s[kWarps][kMaxG * kMaxPageWords];

  const int hk = blockIdx.x;
  const long long b = blockIdx.y;
  const int groups = h_q / h_kv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pw = page / 32;
  const int vwords = dh * pw;   // V^T words of one page, d-major
  const long long h0 = b * h_q + static_cast<long long>(hk) * groups;

  // round trip 1: the length, this warp's table entries, q and theta
  const int jl = warp + lane * kWarps;
  const int entry = jl < nblk ? block_table[b * nblk + jl] : 0;
  // largest valid column: col <= len && col < ring  <=>  col <= last
  const int last = min(lengths[b], ring - 1);
  const int nlive = last < 0 ? 0 : min(nblk, last / page + 1);
  for (int i = tid; i < groups * dhp; i += kThreads)
    q_s[i / dhp][i % dhp] = q[h0 * dhp + i];
  for (int g = tid; g < groups; g += kThreads) th_s[g] = theta[h0 + g];
  for (int i = tid; i < groups * dh; i += kThreads) acc_s[i] = 0;

  const long long k_stride = static_cast<long long>(page) * dhp;
  const long long v_stride = static_cast<long long>(dh) * pw;
  auto page_of = [&](int it, int j) -> long long {
    const int e = it < 32 ? __shfl_sync(0xffffffffu, entry, it)
                          : block_table[b * nblk + j];
    return static_cast<long long>(min(max(e, 0), npages - 1)) * h_kv + hk;
  };
  // round trip 2, issued before the barrier: the first page's K and V^T
  PageRegs r;
  long long pg = page_of(0, warp);
  if (warp < nlive)
    load_page(r, k_pages + pg * k_stride, vt_pages + pg * v_stride, dhp,
              vwords, lane);
  __syncthreads();

  const int score_const = dh + 2 * (dhp * 32 - dh);
  uint32_t* pws = p_s[warp];
  int it = 0;
  for (int j = warp; j < nlive; j += kWarps, ++it) {
    if (it > 0) {
      pg = page_of(it, j);
      load_page(r, k_pages + pg * k_stride, vt_pages + pg * v_stride, dhp,
                vwords, lane);
    }
    const uint32_t* kp = k_pages + pg * k_stride;
    const uint32_t* vp = vt_pages + pg * v_stride;
    // scores of the page's columns, packed per query head
    for (int cw = 0; cw < pw; ++cw) {
      uint32_t kr[kMaxDhp];
#pragma unroll
      for (int w = 0; w < kMaxDhp; ++w)
        kr[w] = cw == 0 ? r.k[w]
                        : (w < dhp ? kp[(cw * 32 + lane) * dhp + w] : 0u);
      const bool valid = j * page + cw * 32 + lane <= last;
      for (int g = 0; g < groups; ++g) {
        int pc = 0;
#pragma unroll
        for (int w = 0; w < kMaxDhp; ++w)
          if (w < dhp) pc += __popc(~(q_s[g][w] ^ kr[w]));
        const bool bit = valid && 2 * pc - score_const >= th_s[g];
        const uint32_t word = __ballot_sync(0xffffffffu, bit);
        if (lane == 0) pws[g * pw + cw] = word;
      }
    }
    __syncwarp();
    // the page's context partials: V^T word e is (d, cw) = (e / pw, e % pw)
    for (int e0 = 0; e0 < vwords; e0 += 32 * kVPre) {
      uint32_t v[kVPre];
#pragma unroll
      for (int u = 0; u < kVPre; ++u) {
        const int e = e0 + lane + 32 * u;
        v[u] = e0 == 0 ? r.v[u] : (e < vwords ? vp[e] : 0u);
      }
#pragma unroll
      for (int u = 0; u < kVPre; ++u) {
        const int e = e0 + lane + 32 * u;
        if (e >= vwords) break;
        const int d = e / pw, cw = e % pw;
        for (int g = 0; g < groups; ++g) {
          const uint32_t p = pws[g * pw + cw];
          if (p) atomicAdd(&acc_s[g * dh + d],
                           2 * __popc(p & v[u]) - __popc(p));
        }
      }
    }
    __syncwarp();   // the page's probability words are consumed
  }
  __syncthreads();

  for (int i = tid; i < groups * dh; i += kThreads)
    out[h0 * dh + i] = acc_s[i];
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
