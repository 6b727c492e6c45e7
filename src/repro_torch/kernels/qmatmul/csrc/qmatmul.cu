// Packed int2/int4/int8 weight dequant-matmul kernels for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/qmatmul/kernel.py:
//   qgemv            (kernel.py:140, body :115)  decode GEMV, M <= 8 batch rows
//   qmatmul          (kernel.py:83,  body :64)   prefill GEMM, any M
//   qmatmul_grouped  (kernel.py:194, body :175)  stacked MoE experts, any M
//
// Operands (all row-major, contiguous; the grouped kernel takes a leading
// expert axis E on x, wp, s and out):
//   x      (M, K)            f32 activations
//   wp     (K * bits/8, N)   packed codes, read as uint8. Field i of packed
//                            row r holds K-row r*per+i at shift bits*i,
//                            offset-binary for 2/4 bits (code + 2^(bits-1));
//                            8-bit codes are plain two's-complement int8.
//   s      (G, N)            f32 scales, one row per group of K/G K-rows
//   out    (M, N)            f32
//
// Every kernel masks ragged M and N itself, so no padding is needed on
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
//
// qmatmul_grouped runs every routed-expert matmul of a MoE layer: x (E, M, K)
// @ dequant(wp (E, K*bits/8, N), s (E, G, N)) -> (E, M, N), with M the tokens
// each expert takes (8 at decode, 64 at deepseek-moe-16b's fixed-batch
// prefill). Each expert's operands are found by size_t offsets from the
// expert index on the grid, and the stacked codes are read directly, so no
// (E, K, N) dequantized copy exists. At M = 8 it is bound by f32 operations
// on paper (2*E*M*K*N against E*K*N*bits/8 bytes) and at M = 64 more so,
// but each 92 MB weight (W4) streams from device memory once per call, so
// the kernel needs ~25 KB in flight per SM to keep that stream going. The
// TPU kernel's blocks are not carried over. M <= 8: one 256-thread block per
// (64 columns, expert) over all of K (E x N/64 = 1,408 blocks fill the card
// without a split of K); K goes in stages through a 4-deep cp.async ring in
// shared memory, 3 stages ahead of the math, and each thread keeps 8 x 4
// sums. Larger M takes qmatmul's 64 x 64 tile with the expert on grid.z and
// all of K in one block. Both are deterministic.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
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

// qmatmul_grouped at M <= 8: k-values per stage and stages in the ring.
constexpr int kGgKS = 128;
constexpr int kGgStages = 4;

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

// Hand every row slice's accumulators to shared memory (red[ty][m][col]).
__device__ __forceinline__ void gemv_stage(float (&red)[kGemvTY][kMaxM][kGemvCols],
                                           const float (&acc)[kMaxM][4], int tx, int ty) {
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][m][tx * 4 + c] = acc[m][c];
  __syncthreads();
}

// Output o = m * kGemvCols + col of a block: its slices summed in order.
__device__ __forceinline__ float gemv_slice_sum(const float (&red)[kGemvTY][kMaxM][kGemvCols],
                                                int o) {
  const int m = o / kGemvCols;
  const int col = o % kGemvCols;
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kGemvTY; ++t) sum += red[t][m][col];
  return sum;
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
  gemv_stage(red, acc, tx, ty);

  const int tid = ty * kGemvTX + tx;
  for (int o = tid; o < kMaxM * kGemvCols; o += kGemvThreads) {
    part_out[o] = gemv_slice_sum(red, o);
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

// One 64 x 64 output tile over k in [k_begin, k_end), in k-steps of 32: the x
// tile (k-major) and the unpacked, scaled weight tile are staged in shared
// memory, the next step's global loads are issued into registers before the
// current step's math, and each thread keeps a 4 x 4 tile read as float4 from
// shared memory. Each thread unpacks whole packed bytes: 4 columns of one
// packed row per 32-bit load and scales each code as it unpacks it (a scale
// group may be shorter than a k-step).
template <int BITS>
__device__ __forceinline__ void mm_tile(const float* __restrict__ x,
                                        const uint8_t* __restrict__ wp,
                                        const float* __restrict__ s, int M, int K, int N,
                                        int G, bool vec, int m0, int n0, int k_begin,
                                        int k_end, float (&xs)[kMmBK][kMmBM],
                                        float (&ws)[kMmBK][kMmBN], float (&acc)[4][4]) {
  constexpr int kPer = 8 / BITS;
  constexpr int kWRows = kMmBK / kPer;              // packed rows per k-step
  constexpr int kWWords = kWRows * (kMmBN / 4);     // 32-bit words per k-step
  constexpr int kWPerThread = (kWWords + kMmThreads - 1) / kMmThreads;
  constexpr int kXPerThread = kMmBM * (kMmBK / 4) / kMmThreads;  // float4s
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int rows = K / kPer;
  const int group = K / G;
  const bool xvec = (K & 3) == 0;
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
                  ? load4(wp + static_cast<size_t>(r) * N, n0 + (w % (kMmBN / 4)) * 4, N, vec)
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
}

// Write a thread's 4 x 4 outputs of the tile at (m0, n0), masking ragged M, N.
__device__ __forceinline__ void mm_store(float* __restrict__ out, const float (&acc)[4][4],
                                         int M, int N, bool vec, int m0, int n0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
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

// Prefill GEMM. Each block computes a 64 x 64 output tile over one half of K
// (a 2-block cluster along grid.z covers all of K). Block 1 hands its tile to
// block 0 through distributed shared memory, which adds it in a fixed order
// and writes.
template <int BITS>
__global__ void __cluster_dims__(1, 1, kMmSplit) __launch_bounds__(kMmThreads)
qmatmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
               const float* __restrict__ s, float* __restrict__ out,
               int M, int K, int N, int G, int vec) {
  __shared__ __align__(16) float xs[kMmBK][kMmBM];
  __shared__ __align__(16) float ws[kMmBK][kMmBN];
  __shared__ __align__(16) float red[kMmBM * kMmBN];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kMmBM;
  const int n0 = blockIdx.x * kMmBN;
  const int steps = (K + kMmBK - 1) / kMmBK;
  const int k_begin = rank * ((steps + kMmSplit - 1) / kMmSplit) * kMmBK;
  const int k_end = min(K, k_begin + ((steps + kMmSplit - 1) / kMmSplit) * kMmBK);

  float acc[4][4];
  mm_tile<BITS>(x, wp, s, M, K, N, G, vec != 0, m0, n0, k_begin, k_end, xs, ws, acc);

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
    mm_store(out, acc, M, N, vec != 0, m0, n0);
  }
  cluster.sync();  // no block leaves while rank 0 still reads its shared memory
}

// Grouped expert GEMM, decode-shaped (M <= 8 rows per expert). One block per
// (64 columns, expert) walks all of K: E x N/64 blocks (1,408 at
// deepseek-moe-16b's widths) fill the card without a split of K. The weight
// streams from device memory once, so the kernel needs many bytes in flight:
// K goes in stages of kGgKS values through a kGgStages-deep cp.async ring in
// shared memory (the stage's packed rows x 64 columns, and x's kGgKS x 8
// values stored k-major), loads issued kGgStages - 1 stages ahead of the
// math. Rows of x past M and k past K arrive as zeros, so the math needs no
// guards. The 16 row slices' sums meet in shared memory in a fixed order.
// Per-channel scales multiply the finished sums; with scale groups (GROUPED)
// each code is scaled as it is decoded.
template <int BITS, bool GROUPED>
__global__ void __launch_bounds__(kGemvThreads)
qgemv_grouped_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                     const float* __restrict__ s, float* __restrict__ out,
                     int M, int K, int N, int G, int vec16) {
  constexpr int kPer = 8 / BITS;
  constexpr int kRS = kGgKS / kPer;             // packed rows per stage
  constexpr int kWStage = kRS * kGemvCols;      // weight bytes per stage
  constexpr int kStage = kWStage + kGgKS * kMaxM * 4;
  constexpr int kRing = kGgStages * kStage;
  constexpr int kRed = kGemvTY * kMaxM * kGemvCols * 4;
  __shared__ __align__(16) unsigned char smem[kRing > kRed ? kRing : kRed];

  const int e = blockIdx.y;
  const int rows = K / kPer;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kGemvTX + tx;
  const int n0 = blockIdx.x * kGemvCols;
  x += static_cast<size_t>(e) * M * K;
  wp += static_cast<size_t>(e) * rows * N;
  s += static_cast<size_t>(e) * G * N;
  out += static_cast<size_t>(e) * M * N;
  const int rows_per_group = rows / G;

  auto load_stage = [&](int slot, int k0) {
    unsigned char* ws = smem + slot * kStage;
    float* xs = reinterpret_cast<float*>(ws + kWStage);
    const int r0 = k0 / kPer;
    for (int p = tid; p < kRS * 4; p += kGemvThreads) {  // 16-byte pieces of rows
      const int r = r0 + p / 4;
      const int c = n0 + (p % 4) * 16;
      unsigned char* dst = ws + p * 16;
      if (vec16) {  // N % 16 == 0: a piece lies wholly inside N or outside
        const bool in = r < rows && c < N;
        __pipeline_memcpy_async(dst, in ? wp + static_cast<size_t>(r) * N + c : wp, 16,
                                in ? 0 : 16);
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          dst[b] = (r < rows && c + b < N) ? __ldg(wp + static_cast<size_t>(r) * N + c + b) : 0;
        }
      }
    }
    for (int p = tid; p < kGgKS * kMaxM; p += kGemvThreads) {  // xs[k][m] = x[m][k0 + k]
      const int m = p % kMaxM;
      const int k = k0 + p / kMaxM;
      const bool in = m < M && k < K;
      __pipeline_memcpy_async(xs + p, in ? x + static_cast<size_t>(m) * K + k : x, 4,
                              in ? 0 : 4);
    }
  };

  float acc[kMaxM][4];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  const int ncol = n0 + tx * 4;

  const int nstages = (K + kGgKS - 1) / kGgKS;
#pragma unroll
  for (int st = 0; st < kGgStages - 1; ++st) {
    if (st < nstages) load_stage(st, st * kGgKS);
    __pipeline_commit();
  }
  for (int it = 0; it < nstages; ++it) {
    __pipeline_wait_prior(kGgStages - 2);  // this thread's copies of stage `it` landed
    __syncthreads();  // everyone's landed, and the slot of stage it - 1 is free
    const int nxt = it + kGgStages - 1;
    if (nxt < nstages) load_stage(nxt % kGgStages, nxt * kGgKS);
    __pipeline_commit();

    const unsigned char* ws = smem + (it % kGgStages) * kStage;
    const float* xs = reinterpret_cast<const float*>(ws + kWStage);
#pragma unroll
    for (int j = 0; j < kRS / kGemvTY; ++j) {
      const int r = ty + kGemvTY * j;  // packed row within the stage
      const uint32_t w4 = *reinterpret_cast<const uint32_t*>(ws + r * kGemvCols + tx * 4);
      float sc[4] = {1.f, 1.f, 1.f, 1.f};
      if constexpr (GROUPED) {
        const int g = min((it * kRS + r) / rows_per_group, G - 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[c] = ncol + c < N ? __ldg(s + static_cast<size_t>(g) * N + ncol + c) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float4 xa = *reinterpret_cast<const float4*>(xs + (r * kPer + i) * kMaxM);
        const float4 xb = *reinterpret_cast<const float4*>(xs + (r * kPer + i) * kMaxM + 4);
        const float xv[kMaxM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        float cv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) cv[c] = decode<BITS>(w4 >> (8 * c), i) * sc[c];
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv[m], cv[c], acc[m][c]);
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is idle: reuse it for the slices' sums

  if constexpr (!GROUPED) {  // the per-channel scale multiplies the finished sum
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sc = ncol + c < N ? __ldg(s + ncol + c) : 0.f;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) acc[m][c] *= sc;
    }
  }
  auto& red = *reinterpret_cast<float (*)[kGemvTY][kMaxM][kGemvCols]>(smem);
  gemv_stage(red, acc, tx, ty);
  for (int o = tid; o < kMaxM * kGemvCols; o += kGemvThreads) {
    const int m = o / kGemvCols;
    const int n = n0 + o % kGemvCols;
    if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = gemv_slice_sum(red, o);
  }
}

// Grouped expert GEMM, any M: qmatmul's 64 x 64 tile with the expert on
// grid.z, over all of K (no cluster: E x N/64 x M/64 blocks fill the card).
template <int BITS>
__global__ void __launch_bounds__(kMmThreads)
qmatmul_grouped_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                       const float* __restrict__ s, float* __restrict__ out,
                       int M, int K, int N, int G, int vec) {
  constexpr int kPer = 8 / BITS;
  __shared__ __align__(16) float xs[kMmBK][kMmBM];
  __shared__ __align__(16) float ws[kMmBK][kMmBN];
  const int e = blockIdx.z;
  x += static_cast<size_t>(e) * M * K;
  wp += static_cast<size_t>(e) * (K / kPer) * N;
  s += static_cast<size_t>(e) * G * N;
  out += static_cast<size_t>(e) * M * N;

  const int m0 = blockIdx.y * kMmBM;
  const int n0 = blockIdx.x * kMmBN;
  float acc[4][4];
  mm_tile<BITS>(x, wp, s, M, K, N, G, vec != 0, m0, n0, 0, K, xs, ws, acc);
  mm_store(out, acc, M, N, vec != 0, m0, n0);
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

// Stacked experts: x (E, M, K), wp (E, K*bits/8, N), s (E, G, N), out
// (E, M, N). M <= 8 rows per expert take the decode body, more the tile.
int qmatmul_grouped_launch(const void* x, const void* wp, const void* s, void* out,
                           int E, int M, int K, int N, int G, int bits, int vec,
                           void* stream) {
  if (E < 1 || E > 65535 || M < 1 || K < 1 || N < 1 || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(wp);
  const float* sf = static_cast<const float*>(s);
  float* of = static_cast<float*>(out);
  if (M <= kMaxM) {
    const dim3 block(kGemvTX, kGemvTY);
    const dim3 grid((N + kGemvCols - 1) / kGemvCols, E);
    // 16-byte copies of packed rows: N % 16 == 0 and an aligned base
    const int v16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
#define QGG_LAUNCH(B, GR) \
  qgemv_grouped_kernel<B, GR><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, v16)
    switch (bits * 2 + (G > 1)) {
      case 4: QGG_LAUNCH(2, false); break;
      case 5: QGG_LAUNCH(2, true); break;
      case 8: QGG_LAUNCH(4, false); break;
      case 9: QGG_LAUNCH(4, true); break;
      case 16: QGG_LAUNCH(8, false); break;
      case 17: QGG_LAUNCH(8, true); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef QGG_LAUNCH
  } else {
    const dim3 block(kMmThreads);
    const dim3 grid((N + kMmBN - 1) / kMmBN, (M + kMmBM - 1) / kMmBM, E);
    switch (bits) {
      case 2: qmatmul_grouped_kernel<2><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
      case 4: qmatmul_grouped_kernel<4><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
      case 8: qmatmul_grouped_kernel<8><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, vec); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
