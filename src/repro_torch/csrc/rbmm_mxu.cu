// rbmm_mxu: binary activation values x packed ±1 weights on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/rbmm_mxu/kernel.py rbmm_mxu
// (_kernel, _unpack_pm1): out (M, P) f32 = a (M, K) @ unpack±1(w).T, where
// a holds bf16 ±1 or {0,1} values and w is (P, Kw >= ceil(K/32)) packed
// words.  Every product is 0 or ±1 and every partial sum an integer below
// 2^24, so bf16 inputs with f32 accumulation are exact in any order.
//
// Bound on the H100: bytes at the main-path prefill shapes.  w1 at
// M=1024, K=576, P=1536 reads 1.18 MB of A and 0.11 MB of weights and
// writes 6.29 MB of f32 output: 7.58 MB, 2.26 us at 3.35 TB/s, against
// 1.81 GFLOP that take 1.83 us at the 989 TFLOP/s bf16 rate.  Design: the
// weights stay 1 bit per value in device memory; each block unpacks its
// 64 x 32 weight tile to ±1 bf16 in shared memory (one word per row and
// K-tile, so a thread turns one word into 16 values) next to its 64 x 32
// A tile, and four warps run mma.sync m16n8k16 (bf16 in, f32 accumulate)
// on 32 x 32 sub-tiles.  Ragged M, P and K are masked at load time (A pad
// is 0, so whatever a pad weight bit unpacks to adds nothing).  A leading
// batch dimension maps to gridDim.z.
#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;   // one packed word per weight row per K-tile
constexpr int kPadK = 8;  // shared-memory row padding against conflicts
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
    rbmm_mxu_kernel(const __nv_bfloat16* __restrict__ a,
                    const uint32_t* __restrict__ w, float* __restrict__ out,
                    int m, int p, int k, int kw) {
  __shared__ __align__(16) __nv_bfloat16 as[kBM][kBK + kPadK];
  __shared__ __align__(16) __nv_bfloat16 bs[kBN][kBK + kPadK];

  const long long z = blockIdx.z;
  a += z * m * static_cast<long long>(k);
  w += z * p * static_cast<long long>(kw);
  out += z * m * static_cast<long long>(p);

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp / 2) * 32;  // warp's 32 x 32 sub-tile
  const int wn = (warp % 2) * 32;
  const int grp = lane >> 2;       // mma fragment row / column group
  const int tig = lane & 3;        // thread in group

  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const __nv_bfloat16 plus = __float2bfloat16(1.0f);
  const __nv_bfloat16 minus = __float2bfloat16(-1.0f);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int ktiles = (k + kBK - 1) / kBK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      as[r][c] = (gm < m && gk < k) ? a[static_cast<long long>(gm) * k + gk]
                                    : zero;
    }
    {
      const int r = tid >> 1, half = tid & 1;
      const int gn = n0 + r;
      const uint32_t word =
          gn < p ? w[static_cast<long long>(gn) * kw + kt] : 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int bit = half * 16 + j;
        bs[r][bit] = ((word >> bit) & 1u) ? plus : minus;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm + mi * 16 + grp;
        const int col = kk + tig * 2;
        af[mi][0] = ld_pair(&as[row][col]);
        af[mi][1] = ld_pair(&as[row + 8][col]);
        af[mi][2] = ld_pair(&as[row][col + 8]);
        af[mi][3] = ld_pair(&as[row + 8][col + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + grp;
        const int col = kk + tig * 2;
        bf[ni][0] = ld_pair(&bs[n][col]);
        bf[ni][1] = ld_pair(&bs[n][col + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm + mi * 16 + grp;
      const int col = n0 + wn + ni * 8 + tig * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e >= 2 ? 8 : 0);
        const int c = col + (e & 1);
        if (r < m && c < p) out[static_cast<long long>(r) * p + c] =
            acc[mi][ni][e];
      }
    }
  }
}

}  // namespace

COBRA_API int cobra_rbmm_mxu(const void* a, const void* w, long long batch,
                             long long m, long long p, long long k,
                             long long kw, void* out, void* stream) {
  if (batch * m * p == 0) return 0;
  const dim3 grid(static_cast<unsigned>((p + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>(batch));
  rbmm_mxu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<float*>(out), static_cast<int>(m), static_cast<int>(p),
      static_cast<int>(k), static_cast<int>(kw));
  return cobra_launch_status();
}
