// Packed int2/int4/int8 weight dequant-matmul kernels for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/qmatmul/kernel.py:
//   qgemv    (kernel.py:140, body :115)  decode GEMV, M <= 8 batch rows
//   qmatmul  (kernel.py:83,  body :64)   prefill GEMM, any M
//
// Operands (all row-major, contiguous):
//   x      (M, K)            f32 activations
//   wp     (K * bits/8, N)   packed codes, read as uint8. Field i of packed
//                            row r holds K-row r*per+i at shift bits*i,
//                            offset-binary for 2/4 bits (code + 2^(bits-1));
//                            8-bit codes are plain two's-complement int8.
//   s      (G, N)            f32 scales, one row per group of K/G K-rows
//   out    (M, N)            f32
//
// Both kernels mask ragged M and N themselves, so no padding is needed on
// the caller's side. The math is f32 FMA on CUDA cores; tensor cores
// (wgmma, bf16/tf32) and TMA staging are later work.
//
// qgemv does 2*M*K*N f32 operations on K*N*bits/8 weight bytes (M <= 8):
// at M = 8 its f32 operations outweigh the bytes on paper, at M = 1 the
// bytes do; either way its real limit at the serving shapes is latency and
// parallelism, with under 1 MB per call. A block owns 64 columns and one
// eighth of the packed rows; the 8 blocks of a thread-block cluster cover
// all of K and are summed in rank order through distributed shared memory,
// so no partial sum is carried across blocks through global memory and the
// result is deterministic. A thread reads 4 packed bytes (4 columns) per row
// with one 32-bit load and the row's activations with one vector load per
// batch row, unpacks in registers and keeps M x 4 partial sums; each group's
// scale multiplies its partial sum.
//
// qmatmul is bound by f32 operations at the prefill shapes (M = 512). A
// block computes a 64 x 64 output tile over half of K in k-steps of 32 (a
// 2-block cluster covers K, so the N = 768 shapes fill the card): the x tile
// and the unpacked, scaled weight tile go through shared memory, the next
// step's global loads are in flight during the current step's math, and a
// thread keeps a 4 x 4 tile fed by float4 shared-memory reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxM = 8;  // qgemv rows (spec.QGEMV_M_MAX)

// qgemv: 16 column quads (64 columns) x 16 packed-row slices per block, and
// a cluster of kGemvSplit blocks along grid.y splitting the packed rows.
constexpr int kGemvTX = 16;
constexpr int kGemvTY = 16;
constexpr int kGemvThreads = kGemvTX * kGemvTY;
constexpr int kGemvCols = kGemvTX * 4;
constexpr int kGemvSplit = 8;

// qmatmul: 256 threads as 16 x 16, 64 x 64 outputs (4 x 4 each), k-step 32.
constexpr int kMmThreads = 256;
constexpr int kMmBM = 64;
constexpr int kMmBN = 64;
constexpr int kMmBK = 32;
constexpr int kMmSplit = 2;  // blocks per cluster, each one half of K

// Centred code of field i of a packed byte (the low byte of `byte`).
template <int BITS>
__device__ __forceinline__ float decode(uint32_t byte, int i) {
  if constexpr (BITS == 8) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(byte)));
  } else {
    constexpr uint32_t kMask = (1u << BITS) - 1u;
    constexpr int kOff = 1 << (BITS - 1);
    return static_cast<float>(static_cast<int>((byte >> (BITS * i)) & kMask) - kOff);
  }
}

// Four packed bytes of one row at columns n0..n0+3 (zero past N).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row,
                                          int n0, int N, bool vec) {
  if (vec && n0 + 3 < N) {
    return __ldg(reinterpret_cast<const unsigned int*>(row + n0));
  }
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (n0 + c < N) v |= static_cast<uint32_t>(__ldg(row + n0 + c)) << (8 * c);
  }
  return v;
}

// The PER activations x[m, r*PER .. r*PER+PER-1] of packed row r, for every
// row m < M (zero above M). One vector load per row: x is 16-byte aligned
// and K = rows * PER.
template <int PER>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int K, int M,
                                       int r, float (&xv)[kMaxM][PER]) {
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    const float* p = x + static_cast<size_t>(m) * K + static_cast<size_t>(r) * PER;
    if (m < M) {
      if constexpr (PER == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        xv[m][0] = v.x; xv[m][1] = v.y; xv[m][2] = v.z; xv[m][3] = v.w;
      } else if constexpr (PER == 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p));
        xv[m][0] = v.x; xv[m][1] = v.y;
      } else {
        xv[m][0] = __ldg(p);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) xv[m][i] = 0.f;
    }
  }
}

// Decode GEMV. Block (bx, rank) owns columns [64 bx, 64 bx + 64) and packed
// rows [rank * chunk, (rank + 1) * chunk) of the weight; its 16 row slices
// each walk every 16th row. Per scale group the partial sums are scaled and
// added to the accumulators (once at the end when G == 1); the 16 slices are
// summed through shared memory, then the cluster's 8 blocks are summed in
// rank order by block 0 through distributed shared memory (deterministic).
template <int BITS>
__global__ void __cluster_dims__(1, kGemvSplit, 1) __launch_bounds__(kGemvThreads)
qgemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
             const float* __restrict__ s, float* __restrict__ out,
             int M, int K, int N, int G, int vec) {
  constexpr int kPer = 8 / BITS;
  __shared__ float red[kGemvTY][kMaxM][kGemvCols];
  __shared__ float part_out[kMaxM * kGemvCols];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int n0 = blockIdx.x * kGemvCols + tx * 4;
  const int rows = K / kPer;
  const int rows_per_group = rows / G;
  const int chunk = (rows + kGemvSplit - 1) / kGemvSplit;
  const int r_lo = rank * chunk;
  const int r_hi = min(rows, r_lo + chunk);

  float acc[kMaxM][4];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n0 < N && r_lo < r_hi) {
    const int g_last = (r_hi - 1) / rows_per_group;
    for (int g = r_lo / rows_per_group; g <= g_last; ++g) {
      const int gr_lo = max(r_lo, g * rows_per_group);
      const int gr_hi = min(r_hi, (g + 1) * rows_per_group);
      float part[kMaxM][4];
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[m][c] = 0.f;

#pragma unroll 2
      for (int r = gr_lo + ty; r < gr_hi; r += kGemvTY) {
        const uint32_t w4 = load4(wp + static_cast<size_t>(r) * N, n0, N, vec != 0);
        float xv[kMaxM][kPer];
        load_x<kPer>(x, K, M, r, xv);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          float cv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) cv[c] = decode<BITS>(w4 >> (8 * c), i);
#pragma unroll
          for (int m = 0; m < kMaxM; ++m) {
            if (m < M) {
#pragma unroll
              for (int c = 0; c < 4; ++c) part[m][c] = fmaf(xv[m][i], cv[c], part[m][c]);
            }
          }
        }
      }
      // the group's scale multiplies its partial sum, never the codes
      float sc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[c] = (n0 + c < N) ? __ldg(s + static_cast<size_t>(g) * N + n0 + c) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(part[m][c], sc[c], acc[m][c]);
    }
  }

#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][m][tx * 4 + c] = acc[m][c];
  __syncthreads();

  const int tid = ty * kGemvTX + tx;
  for (int o = tid; o < kMaxM * kGemvCols; o += kGemvThreads) {
    const int m = o / kGemvCols;
    const int col = o % kGemvCols;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kGemvTY; ++t) sum += red[t][m][col];
    part_out[o] = sum;
  }
  cluster.sync();  // every block's part_out is written and visible
  if (rank == 0) {
    for (int o = tid; o < kMaxM * kGemvCols; o += kGemvThreads) {
      const int m = o / kGemvCols;
      const int n = blockIdx.x * kGemvCols + o % kGemvCols;
      if (m < M && n < N) {
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < kGemvSplit; ++b) {
          sum += cluster.map_shared_rank(part_out, b)[o];
        }
        out[static_cast<size_t>(m) * N + n] = sum;
      }
    }
  }
  cluster.sync();  // no block leaves while block 0 still reads its shared memory
}

// Prefill GEMM. Each block computes a 64 x 64 output tile over one half of K
// (a 2-block cluster along grid.z covers all of K) in k-steps of 32: the x
// tile (k-major) and the unpacked, scaled weight tile are staged in shared
// memory, the next step's global loads are issued into registers before the
// current step's math, and each thread keeps a 4 x 4 tile read as float4
// from shared memory. Each thread unpacks whole packed bytes: 4 columns of
// one packed row per 32-bit load. Block 1 hands its tile to block 0 through
// distributed shared memory, which adds it in a fixed order and writes.
template <int BITS>
__global__ void __cluster_dims__(1, 1, kMmSplit) __launch_bounds__(kMmThreads)
qmatmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
               const float* __restrict__ s, float* __restrict__ out,
               int M, int K, int N, int G, int vec) {
  constexpr int kPer = 8 / BITS;
  constexpr int kWRows = kMmBK / kPer;              // packed rows per k-step
  constexpr int kWWords = kWRows * (kMmBN / 4);     // 32-bit words per k-step
  constexpr int kWPerThread = (kWWords + kMmThreads - 1) / kMmThreads;
  constexpr int kXPerThread = kMmBM * (kMmBK / 4) / kMmThreads;  // float4s
  __shared__ __align__(16) float xs[kMmBK][kMmBM];
  __shared__ __align__(16) float ws[kMmBK][kMmBN];
  __shared__ __align__(16) float red[kMmBM * kMmBN];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kMmBM;
  const int n0 = blockIdx.x * kMmBN;
  const int rows = K / kPer;
  const int group = K / G;
  const bool xvec = (K & 3) == 0;
  const int steps = (K + kMmBK - 1) / kMmBK;
  const int k_begin = rank * ((steps + kMmSplit - 1) / kMmSplit) * kMmBK;
  const int k_end = min(K, k_begin + ((steps + kMmSplit - 1) / kMmSplit) * kMmBK);
  float4 xr[kXPerThread];
  uint32_t wr[kWPerThread];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int idx = tid + j * kMmThreads;
      const int q = idx / kMmBM;
      const int m = m0 + idx % kMmBM;
      const int k = k0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        const float* p = x + static_cast<size_t>(m) * K + k;
        if (xvec && k + 3 < K) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          if (k < K) v.x = __ldg(p);
          if (k + 1 < K) v.y = __ldg(p + 1);
          if (k + 2 < K) v.z = __ldg(p + 2);
          if (k + 3 < K) v.w = __ldg(p + 3);
        }
      }
      xr[j] = v;
    }
#pragma unroll
    for (int j = 0; j < kWPerThread; ++j) {
      const int w = tid + j * kMmThreads;
      const int r = k0 / kPer + w / (kMmBN / 4);
      wr[j] = (w < kWWords && r < rows)
                  ? load4(wp + static_cast<size_t>(r) * N, n0 + (w % (kMmBN / 4)) * 4, N, vec != 0)
                  : 0u;
    }
  };

  auto store_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int idx = tid + j * kMmThreads;
      const int q = idx / kMmBM;
      const int mm = idx % kMmBM;
      xs[4 * q + 0][mm] = xr[j].x;
      xs[4 * q + 1][mm] = xr[j].y;
      xs[4 * q + 2][mm] = xr[j].z;
      xs[4 * q + 3][mm] = xr[j].w;
    }
#pragma unroll
    for (int j = 0; j < kWPerThread; ++j) {
      const int w = tid + j * kMmThreads;
      if (w < kWWords) {
        const int prow = w / (kMmBN / 4);
        const int cq = (w % (kMmBN / 4)) * 4;
        const int n = n0 + cq;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int k = k0 + prow * kPer + i;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k < K) {
            const float* srow = s + static_cast<size_t>(k / group) * N;
            if (n < N) v.x = decode<BITS>(wr[j], i) * __ldg(srow + n);
            if (n + 1 < N) v.y = decode<BITS>(wr[j] >> 8, i) * __ldg(srow + n + 1);
            if (n + 2 < N) v.z = decode<BITS>(wr[j] >> 16, i) * __ldg(srow + n + 2);
            if (n + 3 < N) v.w = decode<BITS>(wr[j] >> 24, i) * __ldg(srow + n + 3);
          }
          *reinterpret_cast<float4*>(&ws[prow * kPer + i][cq]) = v;
        }
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (k_begin < k_end) load_tile(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kMmBK) {
    store_tile(k0);
    __syncthreads();
    if (k0 + kMmBK < k_end) load_tile(k0 + kMmBK);  // in flight during the math
#pragma unroll
    for (int kk = 0; kk < kMmBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // split-K reduction: ranks 1.. hand their tiles to rank 0 in order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(&red[(ty * 4 + i) * kMmBN + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  cluster.sync();
  if (rank == 0) {
#pragma unroll
    for (int b = 1; b < kMmSplit; ++b) {
      const float* other = cluster.map_shared_rank(red, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(&other[(ty * 4 + i) * kMmBN + tx * 4]);
        acc[i][0] += v.x;
        acc[i][1] += v.y;
        acc[i][2] += v.z;
        acc[i][3] += v.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      const int n = n0 + tx * 4;
      if (m >= M) continue;
      float* o = out + static_cast<size_t>(m) * N + n;
      if (vec && n + 3 < N) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j < N) o[j] = acc[i][j];
        }
      }
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its shared memory
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError():
// 0 when the launch was accepted.
int qgemv_launch(const void* x, const void* wp, const void* s, void* out,
                 int M, int K, int N, int G, int bits, int vec, void* stream) {
  if (M < 1 || M > kMaxM || K < 1 || N < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kGemvTX, kGemvTY);
  const dim3 grid((N + kGemvCols - 1) / kGemvCols, kGemvSplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(wp);
  const float* sf = static_cast<const float*>(s);
  float* of = static_cast<float*>(out);
  switch (bits) {
    case 2: qgemv_kernel<2><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
    case 4: qgemv_kernel<4><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
    case 8: qgemv_kernel<8><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int qmatmul_launch(const void* x, const void* wp, const void* s, void* out,
                   int M, int K, int N, int G, int bits, int vec, void* stream) {
  if (M < 1 || K < 1 || N < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kMmThreads);
  const dim3 grid((N + kMmBN - 1) / kMmBN, (M + kMmBM - 1) / kMmBM, kMmSplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(wp);
  const float* sf = static_cast<const float*>(s);
  float* of = static_cast<float*>(out);
  switch (bits) {
    case 2: qmatmul_kernel<2><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
    case 4: qmatmul_kernel<4><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
    case 8: qmatmul_kernel<8><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
