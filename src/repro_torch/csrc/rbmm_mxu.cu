// rbmm_mxu: binary activation values x packed ±1 weights on Hopper's tensor
// cores (TMA, mbarrier ring, wgmma).
//
// Replaces the TPU kernel src/repro/kernels/rbmm_mxu/kernel.py rbmm_mxu
// (_kernel, _unpack_pm1): out (M, P) f32 = a (M, K) @ unpack±1(w).T, where
// a holds bf16 ±1 or {0,1} values and w is (P, Kw >= ceil(K/32)) packed
// words.  Every product is 0 or ±1 and every partial sum an integer below
// 2^24, so bf16 inputs with f32 accumulation are exact in any order.
//
// Bound on the H100: bytes at both main-path shapes.  w1 at prefill, M =
// 1024, K = 576, P = 1536: 1.18 MB of A, 0.11 MB of words and 6.29 MB of
// f32 output, 7.58 MB or 2.26 us at 3.35 TB/s, against 1.81 GFLOP (1.83 us
// at 989 TFLOP/s).  The encoder's Q/K/V/O, M = 4096, K = P = 768: 6.29 MB of
// A, 0.07 MB of words, 12.58 MB of output, 5.66 us (4.83 GFLOP, 4.89 us).
//
// Design.  A block owns a BM x BN output tile (BM, BN in {64, 128}, the
// wrapper's rule picks one that fills the card) and walks K in steps of 64
// values, one 128-byte swizzled row per M or N index:
//   * one producer warp keeps a 3- or 4-stage ring full: its lane 0 asks
//     TMA for the BM x 64 bf16 A box (out-of-bounds rows and K read as
//     zero; the batch is the tensor map's third dimension), and its 32
//     lanes copy the stage's two weight words per N row with cp.async (zero
//     past P or Kw), both completing on the stage's "full" mbarrier;
//   * BM / 64 consumer warpgroups unpack the words of a stage into the B
//     operand's swizzled K-major tile (eight bits to a 16-byte chunk of ±1
//     bf16 by bit operations: 0xBF80 ^ bit << 15), fence the generic proxy
//     against the async proxy, meet at a named barrier and issue four
//     wgmma m64nBNk16 on A and B from shared memory, accumulating in f32
//     registers; the wgmmas run while the next step unpacks (three B
//     tiles), and a stage goes back to the producer by its "empty"
//     mbarrier once its wgmmas are done;
//   * weights stay 1 bit per value in device memory; K pad values (A's zero
//     fill) meet whatever the pad bits unpack to and add nothing;
//   * the epilogue stages the f32 tile over the (then idle) ring and B
//     tiles as 128-byte swizzled rows and writes it with TMA stores, which
//     clip ragged M and P, when P * 4 is a multiple of 16; otherwise it
//     stores masked scalars.
// The wrapper pads A's K with zeros to a multiple of 8 (TMA's 16-byte row
// stride); ceil8(K) <= 32 * Kw always holds.
#include "tc_common.cuh"

namespace {

constexpr int kBK = 64;      // bf16 values per K-step: one 128-byte row
constexpr int kBBufs = 3;    // unpacked B tiles in flight (see the loop)

template <int BM, int BN>
struct MxuTile {
  // ring depth: 3 stages at 128 x 128 keep two blocks on an SM
  static constexpr int kStages = BM * BN >= 128 * 128 ? 3 : 4;
  static constexpr int kConsumers = BM / 64;            // warpgroups
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kThreads = kConsumerThreads + 32;  // + producer warp
  static constexpr int kABytes = BM * tc::kRowBytes;     // per stage
  static constexpr int kBBytes = BN * tc::kRowBytes;     // per B buffer
  static constexpr int kWWords = BN * 2;                 // per stage
  static constexpr int kAOff = 0;
  static constexpr int kBOff = kAOff + kStages * kABytes;
  static constexpr int kWOff = kBOff + kBBufs * kBBytes;
  static constexpr int kBarOff = kWOff + kStages * kWWords * 4;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + align
  static constexpr int kAcc = BN / 2;   // f32 accumulators per thread
  static constexpr int kBoxes = BN / 32;  // 32-float output boxes per row
  // the epilogue stages the output tile over the idle A ring and B tiles
  static_assert(kWOff >= BM * BN * 4, "epilogue staging fits");
};

template <int BM, int BN>
__global__ void __launch_bounds__(MxuTile<BM, BN>::kThreads)
    rbmm_mxu_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap out_map,
                    const uint32_t* __restrict__ w, float* __restrict__ out,
                    int m, int p, int kw, int ktiles, int tma_store) {
  using T = MxuTile<BM, BN>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_s = smem + T::kAOff;
  uint8_t* b_s = smem + T::kBOff;
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem + T::kWOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  w += static_cast<long long>(z) * p * kw;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 1 + 32);   // TMA's expect_tx + 32 cp.async
      tc::mbar_init(&empty[s], T::kConsumers * 4);   // one per warp
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= T::kConsumerThreads) {   // the producer warp
    const int lane = tid - T::kConsumerThreads;
    if (lane == 0) tc::prefetch_tensormap(&a_map);
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      if (kt >= kStages) tc::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
      if (lane == 0) {
        tc::mbar_arrive_expect_tx(&full[s], T::kABytes);
        tc::tma_load_3d(a_s + s * T::kABytes, &a_map, &full[s], kt * kBK, m0,
                        z);
      }
      uint32_t* ws = w_s + s * T::kWWords;
      for (int i = lane; i < T::kWWords; i += 32) {
        const int n = n0 + (i >> 1), word = 2 * kt + (i & 1);
        const bool ok = n < p && word < kw;
        tc::cp_async<4>(ws + i, ok ? w + static_cast<long long>(n) * kw + word
                                   : w, ok ? 4 : 0);
      }
      tc::cp_async_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer warpgroups
  const int wg = tid / 128;
  const int warp = tid / 32;
  const int lane = tid & 31;
  float acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.0f;

  // Step kt: unpack the stage's words into B buffer kt % 3, then issue
  // its wgmmas and, while they run, wait for those of step kt - 1 and give
  // that step's stage back.  B buffer kt % 3 was last read by the wgmmas of
  // step kt - 3, which every warpgroup waited for before the barrier of
  // step kt - 1 (two buffers would race with a warpgroup still in kt - 2).
  // The entry guarantees ktiles >= 1: a path that skipped the loop would
  // zero the accumulators inside the wgmma pipeline as ptxas sees it, and
  // it would serialize every wgmma.
  int kt = 0;
  do {
    const int s = kt % kStages;
    tc::mbar_wait(&full[s], (kt / kStages) & 1);
    uint8_t* bt = b_s + (kt % kBBufs) * T::kBBytes;
    const uint32_t* ws = w_s + s * T::kWWords;
#pragma unroll
    for (int i = tid; i < BN * 8; i += T::kConsumerThreads) {
      const int n = i >> 3, c = i & 7;
      const uint32_t bits = (ws[2 * n + (c >> 2)] >> (8 * (c & 3))) & 0xFFu;
      *reinterpret_cast<uint4*>(bt + tc::swz(n, c)) =
          tc::bits8_to_pm1_bf16(bits);
    }
    tc::fence_proxy_async();
    tc::named_sync(1, T::kConsumerThreads);
    const uint8_t* at = a_s + s * T::kABytes + wg * 64 * tc::kRowBytes;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      tc::wgmma_bf16(acc, tc::desc_b128(at + 32 * kk),
                     tc::desc_b128(bt + 32 * kk));
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
    if (kt > 0 && lane == 0) tc::mbar_arrive(&empty[(kt - 1) % kStages]);
  } while (++kt < ktiles);
  tc::wgmma_wait<0>();
  tc::fence_operands(acc);

  // every warpgroup is past its last wgmma: the A ring and B tiles are free
  tc::named_sync(1, T::kConsumerThreads);
  const int r0 = 16 * (warp & 3) + (lane >> 2);   // row in the warpgroup
  const int cq = 2 * (lane & 3);                  // column pair
  if (tma_store) {
    // the warpgroup's 64 rows as kBoxes boxes of 64 x 32 floats, each row
    // 128 bytes in the 128-byte swizzle
    uint8_t* st = smem + wg * T::kBoxes * 64 * tc::kRowBytes;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + cq;
      uint8_t* box = st + (col / 32) * 64 * tc::kRowBytes;
      const int cc = col % 32;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        *reinterpret_cast<float2*>(box + tc::swz(r, cc >> 2) +
                                   (cc & 3) * 4) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    tc::fence_proxy_async();
    tc::named_sync(2 + wg, 128);
    if ((tid & 127) == 0) {
#pragma unroll
      for (int b = 0; b < T::kBoxes; ++b)
        tc::tma_store_3d(&out_map, st + b * 64 * tc::kRowBytes, n0 + 32 * b,
                         m0 + 64 * wg, z);
      tc::tma_store_commit_and_wait();
    }
    return;
  }
  float* oz = out + static_cast<long long>(z) * m * p;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + cq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * wg + r0 + 8 * h;
      if (row >= m) continue;
      float* orow = oz + static_cast<long long>(row) * p;
      if (col < p) orow[col] = acc[4 * j + 2 * h];
      if (col + 1 < p) orow[col + 1] = acc[4 * j + 2 * h + 1];
    }
  }
}

template <int BM, int BN>
int launch_mxu(const void* a, const void* w, long long batch, long long m,
               long long p, long long k, long long kw, void* out,
               cudaStream_t stream) {
  using T = MxuTile<BM, BN>;
  CUtensorMap a_map, out_map;
  if (!tc::encode_3d(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, k, m,
                     batch, kBK, BM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tma_store = p % 4 == 0;
  if (tma_store) {
    if (!tc::encode_3d(&out_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, p,
                       m, batch, 32, 64))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    memset(&out_map, 0, sizeof(out_map));
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rbmm_mxu_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(static_cast<unsigned>((p + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>(batch));
  rbmm_mxu_kernel<BM, BN><<<grid, T::kThreads, T::kSmem, stream>>>(
      a_map, out_map, static_cast<const uint32_t*>(w),
      static_cast<float*>(out), static_cast<int>(m), static_cast<int>(p),
      static_cast<int>(kw), static_cast<int>((k + kBK - 1) / kBK),
      tma_store);
  return cobra_launch_status();
}

}  // namespace

// a (batch, M, K) bf16 with K % 8 == 0 and a 16-byte aligned base; w
// (batch, P, Kw) words; out (batch, M, P) f32.  (bm, bn) is one of the
// compiled tiles (128, 128), (128, 64), (64, 64).
COBRA_API int cobra_rbmm_mxu(const void* a, const void* w, long long batch,
                             long long m, long long p, long long k,
                             long long kw, int bm, int bn, void* out,
                             void* stream) {
  if (batch * m * p == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (k == 0)   // an empty sum; the kernel takes at least one K-step
    return static_cast<int>(
        cudaMemsetAsync(out, 0, batch * m * p * sizeof(float), s));
  if (bm == 128 && bn == 128)
    return launch_mxu<128, 128>(a, w, batch, m, p, k, kw, out, s);
  if (bm == 128 && bn == 64)
    return launch_mxu<128, 64>(a, w, batch, m, p, k, kw, out, s);
  if (bm == 64 && bn == 64)
    return launch_mxu<64, 64>(a, w, batch, m, p, k, kw, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
