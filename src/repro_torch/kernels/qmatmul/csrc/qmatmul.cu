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
// the caller's side. Every body runs on the tensor cores, with CUDA-core
// bodies kept for scale groups too short for them.
//
// qgemv, and qmatmul_grouped at M <= 8: the decode body ("gemv_tc").
//   What bounds it. 2*M*K*N operations on K*N*bits/8 code bytes, M <= 8:
//   by bytes on the tensor cores. qgemv's serving matrices hold under 1 MB
//   of codes, so a call is latency: launch, one round trip to device
//   memory, the math, a meeting of warps. The stacked experts (92 MB of W4
//   codes a call at deepseek-moe-16b's widths) stream: the card's 3.35 TB/s
//   needs ~25 KB of code bytes in flight per SM.
//   Arithmetic. out^T = W^T x^T with mma.sync.m16n8k16 bf16: A is 16
//   weight columns x 16 k of codes, unpacked from the packed bytes straight
//   into A fragments (exact in bf16); B is x^T, the batch rows its 8
//   columns, so M <= 8 wastes no MMA row; x in three bf16 parts (the wide
//   tile's split, < 2^-21 relative a product). Each scale group's partial
//   sum is scaled, never the codes.
//   Structure. A block owns a strip of columns (16 for qgemv, so that 768
//   columns make 48 blocks; 128 for the experts, whose 64 x 11..16 strips
//   fill the card) and all of K, split across its warps in contiguous
//   shares of 16-k units. Each warp streams its units (the packed rows of
//   the strip and x's 8 x 16 values) through its own ring of shared-memory
//   slots by 16-byte cp.async copies, issued before its first MMA (9
//   slots: every unit of qgemv's warps at K <= 2048; 4 for the experts, so
//   that 5 blocks share an SM with ~60 KB of codes in flight), and syncs
//   only with itself in the mainloop. The warps meet once, in shared
//   memory, summed in warp order: no cluster, no float atomics, the same
//   bits for a shape, and a row's result does not depend on the other rows
//   of the call (the plan depends on K, N, G and bits only, and MMA
//   columns do not mix). Scale groups that are not a whole number of 16 k
//   (W4 group 8, W2 group 8) take the CUDA-core decode body ("gemv")
//   below.
//
// The CUDA-core decode body ("gemv"), of qgemv and qmatmul_grouped alike:
// one 256-thread block per (64 columns, expert) over all of K, fed by a
// 4-deep cp.async ring, each code scaled as it is decoded, so any scale
// group works.
//
// qmatmul, and qmatmul_grouped at M > 8: the tensor-core body ("tc").
//   Arithmetic. Tensor-core MMAs with f32 accumulators, on codes that are
//   exact in the operand type (|c| <= 128 in TF32 and in bf16), so the
//   weight operand needs no split; the scale is uniform within a group, so
//   it multiplies the group's partial sum (the JAX kernel's scale-after-dot
//   form), never the codes. Only x is rounded, and split so that the parts
//   carry it to < 2^-21 relative: each product of exact operands is exact
//   in f32, so a product carries < 2^-21 relative error before f32
//   accumulation, well inside the 1e-4 * max|ref| + 1e-5 every
//   kernel-vs-plain check uses.
//     short tile: mma.sync.m16n8k8 TF32, two passes, x = hi + lo; hi = x
//       rounded to 11 significant bits by Veltkamp's split (three IEEE f32
//       operations, exact in TF32), lo = x - hi (exact) with its low 13
//       bits cleared: |x - hi - lo| < 2^-10 |lo| < 2^-21 |x|. (cvt.rna.tf32
//       would round lo to nearest, 2^-22, but the conversion instruction
//       issues at a fraction of the FMA rate.)
//     wide tile: wgmma.m64n128k16 bf16, three passes, x = h1 + h2 + h3,
//       each the upper half (bf16 by truncation) of the remaining f32
//       residual: |x - h1 - h2 - h3| < 2^-21 |x|. bf16 runs at twice the
//       TF32 rate and halves the B tiles in shared memory, which this tile
//       is bound by; three bf16 passes cost less than two TF32 passes.
//   Per-channel scales (G = 1) multiply the finished sums in the epilogue;
//   with G > 1 a thread folds acc_total += acc_group * s[g, col] in
//   registers whenever its next k-unit (short: 8 k, 16 for W2; wide: 16 k)
//   lies in another group, so a group must be a whole number of k-units.
//   Bound. 4*M*K*N operations at 495 TFLOP/s (two TF32 passes) or 6*M*K*N
//   at 989 TFLOP/s (three bf16 passes), against the bytes (x, codes,
//   scales, out once) at 3.35 TB/s: operations at M 512 and at the MoE
//   prefill (E 64, M 64); at the engine's 32-row chunk the two are about
//   equal and well under a microsecond, so latency and parallelism are its
//   real limit.
//   Short tile (M <= 32, and groups of 8 k above): 32 x 32 outputs, 4
//   warps each on every fourth k-unit of the whole tile (two m16 x four n8
//   MMA tiles a warp), their sums met in shared memory. Codes go from packed bytes straight to B
//   fragments as floats (2^23 + field - offset, exact), with no dequantized
//   tile, under a k-permutation: within an MMA the sum over k does not
//   depend on order, so A and B take the same permutation of each k-unit
//   (the k one thread's B fragment spans: 8 for W4/W8, 16 for W2). Thread
//   (group g, lane-in-group t) holds logical k = t and t + 4 of an
//   m16n8k8; they map to physical k of the unit:
//     W4  2t, 2t + 1            (the two nibbles of packed row t)
//     W2  4t + 2j, 4t + 2j + 1  (fields 2j, 2j+1 of packed row t; MMA j = 0, 1)
//     W8  2t, 2t + 1            (packed rows 2t and 2t + 1)
//   so a thread's A values are neighbours in x: one float2 (float4 for W2)
//   shared-memory load. Columns: byte i of the 32-bit word at columns 4g ..
//   4g + 3 feeds n8 tile i, i.e. tile i's column g is column 4g + i; the
//   accumulators of thread (g, t) are then the 8 consecutive columns 8t ..
//   8t + 7 of rows g and g + 8.
//   Wide tile (M > 32): one warpgroup's wgmma, 64 x 128 outputs, A (h1,
//   h2, h3) from registers, B from shared memory: each stage's codes are
//   unpacked once per block into bf16 B tiles (the canonical K-major layout
//   without swizzle), which the wgmma reads by descriptor. Groups that are
//   not a whole number of 16 k (W4/W8 group 8) take the short tile.
//   Ring. x tiles (f32) and packed code tiles go through a cp.async ring in
//   shared memory (4 stages short, 3 wide), in 16-byte copies when K % 4
//   == 0 (x) and N % 16 == 0 on an aligned base (codes), 4-byte copies or
//   plain loads otherwise; past M, N and K they zero-fill (a code byte 0
//   decodes to -8 for W4, but meets x = 0). Row strides are padded so that
//   a warp's shared-memory reads and the unpacking's writes hit every bank
//   once.
//   Schedule, chosen in Python from the shape alone (kernels/spec.py
//   plan_qmatmul) and passed in: the tile by M, then K split across a
//   cluster of 1, 2, 4 or 8 blocks until the grid holds 264 blocks (short)
//   or 132 (wide; then further while a block keeps 8 stages within one wave
//   of resident blocks, and beyond a wave the split of 1 or 2 that fills the
//   last wave best): the engine's chunk (M 32) takes 8 and 192-512 blocks,
//   M 512 takes 2-8 and 192-384, the MoE prefill (E 64 on the grid) 1-2 and
//   1,024-1,408. Warps meet in shared memory and the cluster's blocks through
//   distributed shared memory, every block summing its slice of the tile
//   over ranks in a fixed order: no float atomics, so a shape always gives
//   the same bits.
//   CUDA-core body ("simt"): scale groups that are not a whole number of
//   k-units (W4 group 4, W2 group 8) take the previous mainloop (mm_tile:
//   64 x 64 tiles, scales applied per element as codes unpack, f32 FMA;
//   qmatmul splits K over a 2-block cluster).
//
// qmatmul_grouped runs every routed-expert matmul of a MoE layer: x (E, M, K)
// @ dequant(wp (E, K*bits/8, N), s (E, G, N)) -> (E, M, N), with M the tokens
// each expert takes (8 at decode, 64 at deepseek-moe-16b's fixed-batch
// prefill). Each expert's operands are found by size_t offsets from the
// expert index on the grid, and the stacked codes are read directly, so no
// (E, K, N) dequantized copy exists. M <= 8 takes the decode body above,
// larger M the tensor-core tiles with the expert on grid.z. All bodies are
// deterministic.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxM = 8;  // qgemv rows (spec.QGEMV_M_MAX)

// The CUDA-core decode body: 16 column quads (64 columns) x 16 packed-row
// slices per block.
constexpr int kGemvTX = 16;
constexpr int kGemvTY = 16;
constexpr int kGemvThreads = kGemvTX * kGemvTY;
constexpr int kGemvCols = kGemvTX * 4;

// The CUDA-core body of qmatmul / qmatmul_grouped: 256 threads as 16 x 16,
// 64 x 64 outputs (4 x 4 each), k-step 32.
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

// qmatmul's CUDA-core body (scale groups shorter than a k-unit). Each block
// computes a 64 x 64 output tile over one half of K (a 2-block cluster along
// grid.z covers all of K). Block 1 hands its tile to block 0 through
// distributed shared memory, which adds it in a fixed order and writes.
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

// The CUDA-core decode body (M <= 8 rows per expert; qgemv is E = 1), for
// scale groups that are not a whole number of 16 k. One block per (64
// columns, expert) walks all of K. The weight streams from device memory
// once, so the kernel needs many bytes in flight:
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

// qmatmul_grouped's CUDA-core body (M > 8, scale groups shorter than a
// k-unit): the 64 x 64 tile with the expert on grid.z, over all of K.
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

// ---- tensor-core bodies: qmatmul, and qmatmul_grouped at M > 8 -------------

constexpr int kTcBK = 32;  // k per ring stage (spec.QMM_TC_BK)

// k that one thread's B fragment spans in the short tile: one packed byte
// holds both of its k values of one m16n8k8 (W4, W8) or of two (W2)
template <int BITS>
__host__ __device__ constexpr int tc_unit() { return BITS == 2 ? 16 : 8; }

// v = hi + lo exactly, hi with 11 significant bits (exact in TF32):
// Veltkamp's split with C = 2^13 + 1, in IEEE operations that are never
// contracted into FMAs (hi is v rounded to 11 bits). lo (at most 13
// bits) goes to the MMA truncated to TF32: |error| < 2^-10 |lo| < 2^-21 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(v, 8193.f);
  const float h = __fsub_rn(c, __fsub_rn(c, v));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(v, h)) & 0xFFFFE000u;
}

// field - offset as an exact float, for an offset-binary field < 2^8:
// 2^23 + field is built in the mantissa, then bias = 2^23 + offset is
// subtracted.
__device__ __forceinline__ uint32_t code_tf32(uint32_t field, float bias) {
  return __float_as_uint(__uint_as_float(0x4B000000u | field) - bias);
}

// One ring stage: BM rows of x (k0 .. k0 + kTcBK, row stride XS floats)
// and the matching packed rows of BN code bytes (row stride WS bytes), by
// cp.async with zero fill past M, N and K. wvec: the widest copy of a
// packed row's pieces (16 bytes, 4, or 1 by plain loads).
template <int BITS, int BM, int BN, int XS, int WS, int THREADS>
__device__ __forceinline__ void tc_load_stage(float* xs, uint8_t* ws, const float* __restrict__ x,
                                              const uint8_t* __restrict__ wp, int M, int K,
                                              int N, int m0, int n0, int k0, int wvec) {
  constexpr int kPer = 8 / BITS;
  const int tid = threadIdx.x;
  const int rows = K / kPer;
  const bool xvec = (K & 3) == 0;  // x rows start 16-byte aligned (the wrapper aligns x)
  for (int c = tid; c < BM * (kTcBK / 4); c += THREADS) {  // 4 floats of a row
    const int r = c / (kTcBK / 4);
    const int m = m0 + r;
    const int k = k0 + 4 * (c % (kTcBK / 4));
    float* dst = xs + r * XS + (k - k0);
    if (xvec) {
      const bool in = m < M && k < K;
      __pipeline_memcpy_async(dst, in ? x + static_cast<size_t>(m) * K + k : x, 16, in ? 0 : 16);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = m < M && k + i < K;
        __pipeline_memcpy_async(dst + i, in ? x + static_cast<size_t>(m) * K + k + i : x, 4,
                                in ? 0 : 4);
      }
    }
  }
  const int r0 = k0 / kPer;
  for (int c = tid; c < (kTcBK / kPer) * (BN / 16); c += THREADS) {  // 16 bytes of a row
    const int r = c / (BN / 16);
    const int pr = r0 + r;
    const int n = n0 + 16 * (c % (BN / 16));
    uint8_t* dst = ws + r * WS + (n - n0);
    const uint8_t* src = wp + static_cast<size_t>(pr) * N + n;
    if (wvec == 16) {  // N % 16 == 0: a piece lies wholly inside N or outside
      const bool in = pr < rows && n < N;
      __pipeline_memcpy_async(dst, in ? src : wp, 16, in ? 0 : 16);
    } else if (wvec == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = pr < rows && n + 4 * i < N;
        __pipeline_memcpy_async(dst + 4 * i, in ? src + 4 * i : wp, 4, in ? 0 : 4);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) dst[i] = (pr < rows && n + i < N) ? __ldg(src + i) : 0;
    }
  }
}

// The tile's epilogue. red[w][row][col] (row stride BN + 4) holds each
// warp group's partial tile in every block of the cluster. The block first
// sums its own WK groups into red[0]; then each block sums its slice of the
// tile over the ranks in rank order (all remote loads issued together),
// scales it (G == 1, scales in scs) and writes it, masking ragged M and N.
template <int BM, int BN, int WK, int THREADS, bool GROUPED>
__device__ __forceinline__ void tc_reduce_store(float* red, const float* scs,
                                                float* __restrict__ out, int M, int N,
                                                int m0, int n0, int split, int rank) {
  constexpr int kRS = BN + 4;
  constexpr int kQuads = BM * BN / 4;
  const int tid = threadIdx.x;
  if constexpr (WK > 1) {
    __syncthreads();
    for (int o = tid; o < kQuads; o += THREADS) {
      float* r0 = red + (o / (BN / 4)) * kRS + 4 * (o % (BN / 4));
      float4 v = *reinterpret_cast<const float4*>(r0);
#pragma unroll
      for (int w = 1; w < WK; ++w) {
        const float4 p = *reinterpret_cast<const float4*>(r0 + w * BM * kRS);
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      *reinterpret_cast<float4*>(r0) = v;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  const int per = kQuads / split;
  const bool ovec = (N & 3) == 0;
  for (int o = rank * per + tid; o < (rank + 1) * per; o += THREADS) {
    const int r = o / (BN / 4);
    const int c4 = 4 * (o % (BN / 4));
    float4 v = *reinterpret_cast<const float4*>(red + r * kRS + c4);
    if (split > 1) {
      float4 p[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (b < split) {
          p[b] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, b) + r * kRS + c4);
        }
      }
      v = p[0];
#pragma unroll
      for (int b = 1; b < 8; ++b) {
        if (b < split) {
          v.x += p[b].x; v.y += p[b].y; v.z += p[b].z; v.w += p[b].w;
        }
      }
    }
    const int m = m0 + r;
    const int n = n0 + c4;
    if (m >= M || n >= N) continue;
    if constexpr (!GROUPED) {  // the per-channel scale multiplies the finished sum
      const float4 sc = *reinterpret_cast<const float4*>(scs + c4);
      v.x *= sc.x; v.y *= sc.y; v.z *= sc.z; v.w *= sc.w;
    }
    float* dst = out + static_cast<size_t>(m) * N + n;
    if (ovec && n + 3 < N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n + i < N) dst[i] = vv[i];
      }
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its shared memory
}

// -- the short tile (M <= 32): mma.sync ---------------------------------------
//
// A 32 x 32 output tile; its 4 warps each compute all of it over every
// fourth k-unit (m16n8k8 TF32, two m16 row tiles x four n8 tiles a warp).

constexpr int kShBM = 32;
constexpr int kShBN = 32;
constexpr int kShWK = 4;
constexpr int kShThreads = 32 * kShWK;
constexpr int kShStages = 4;  // cp.async ring depth

// Row strides. x (floats): a warp's float2 reads (rows g, columns 2t) need
// stride = 8 mod 16, its float4 reads (W2) 16 mod 32. Codes: a warp reads
// word g of rows t (W4/W2: 8 words a row, no padding) or of rows 2t (W8:
// stride = 4 mod 8 words).
template <int BITS>
__host__ __device__ constexpr int sh_xstride() { return kTcBK + (BITS == 2 ? 16 : 8); }
template <int BITS>
__host__ __device__ constexpr int sh_wstride() { return BITS == 8 ? kShBN + 16 : kShBN; }
template <int BITS>
__host__ __device__ constexpr int sh_stage_bytes() {
  return kShBM * sh_xstride<BITS>() * 4 + (kTcBK * BITS / 8) * sh_wstride<BITS>();
}
// The ring, or (after the mainloop, in the same memory) the warps' partial
// tiles; then the tile's per-channel scales. spec.qmm_tc_smem mirrors this.
template <int BITS>
__host__ __device__ constexpr int sh_union_bytes() {
  constexpr int ring = kShStages * sh_stage_bytes<BITS>();
  constexpr int red = kShWK * kShBM * (kShBN + 4) * 4;
  return ring > red ? ring : red;
}
template <int BITS>
__host__ __device__ constexpr int sh_smem_bytes() { return sh_union_bytes<BITS>() + kShBN * 4; }

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate. Fragments
// of thread (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g);
// d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of one k-unit for the 4 n8 tiles of the 32 columns, straight
// from the packed bytes (see the note: byte i of the word at column 4g
// feeds tile i; the k-permutation puts both k of a fragment in one byte,
// or in two rows for W8). b[j][i][0..1]: MMA j of the unit.
template <int BITS>
__device__ __forceinline__ void sh_b_frags(const uint8_t* ws, int unit, int g, int t,
                                           uint32_t (&b)[tc_unit<BITS>() / 8][4][2]) {
  constexpr int kWS = sh_wstride<BITS>();
  if constexpr (BITS == 8) {
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(ws + (unit * 8 + 2 * t) * kWS + 4 * g);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(ws + (unit * 8 + 2 * t + 1) * kWS + 4 * g);
    const uint32_t u0 = w0 ^ 0x80808080u, u1 = w1 ^ 0x80808080u;  // int8 -> offset binary
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[0][i][0] = code_tf32((u0 >> (8 * i)) & 0xFFu, 8388736.f);
      b[0][i][1] = code_tf32((u1 >> (8 * i)) & 0xFFu, 8388736.f);
    }
  } else {
    constexpr uint32_t kMask = (1u << BITS) - 1u;
    constexpr float kBias = 8388608.f + (1 << (BITS - 1));
    const uint32_t w = *reinterpret_cast<const uint32_t*>(ws + (unit * 4 + t) * kWS + 4 * g);
#pragma unroll
    for (int j = 0; j < tc_unit<BITS>() / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[j][i][0] = code_tf32((w >> (8 * i + BITS * 2 * j)) & kMask, kBias);
        b[j][i][1] = code_tf32((w >> (8 * i + BITS * (2 * j + 1))) & kMask, kBias);
      }
  }
}

// x (E, M, K) @ (codes (E, K*bits/8, N) . scales (E, G, N)) -> (E, M, N),
// short tile. Grid: (N / 32, M / 32, E * split); the `split` blocks of one
// (tile, expert) form a cluster along z and each takes a contiguous share
// of K's stages. GROUPED: G > 1, scales folded per group.
template <int BITS, bool GROUPED>
__global__ void __launch_bounds__(kShThreads)
qmm_short_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                 const float* __restrict__ s, float* __restrict__ out,
                 int M, int K, int N, int G, int split, int wvec) {
  constexpr int kUnit = tc_unit<BITS>();
  constexpr int kSub = kUnit / 8;           // MMAs per k-unit
  constexpr int kUnits = kTcBK / kUnit;     // k-units per stage
  constexpr int kXS = sh_xstride<BITS>();
  constexpr int kStage = sh_stage_bytes<BITS>();
  constexpr int kXBytes = kShBM * kXS * 4;
  constexpr int kMT = kShBM / 16;           // m16 row tiles
  constexpr int kRS = kShBN + 4;            // row stride of the partial tiles
  extern __shared__ __align__(16) unsigned char smem[];

  const int rank = blockIdx.z % split;
  const int e = blockIdx.z / split;
  x += static_cast<size_t>(e) * M * K;
  wp += static_cast<size_t>(e) * (K / (8 / BITS)) * N;
  s += static_cast<size_t>(e) * G * N;
  out += static_cast<size_t>(e) * M * N;
  const int m0 = blockIdx.y * kShBM;
  const int n0 = blockIdx.x * kShBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wk = tid >> 5;  // the warp's share of the k-units
  const int g = lane >> 2;
  const int t = lane & 3;

  // this block's stages: a contiguous share of K
  const int tiles = (K + kTcBK - 1) / kTcBK;
  const int share = (tiles + split - 1) / split;
  const int t_begin = min(tiles, rank * share);
  const int t_end = min(tiles, t_begin + share);
  const int k_end = min(K, t_end * kTcBK);
  const int ntiles = t_end - t_begin;
  auto load_stage = [&](int slot, int tile) {
    tc_load_stage<BITS, kShBM, kShBN, kXS, sh_wstride<BITS>(), kShThreads>(
        reinterpret_cast<float*>(smem + slot * kStage), smem + slot * kStage + kXBytes, x, wp,
        M, K, N, m0, n0, tile * kTcBK, wvec);
  };

  float acc[kMT][4][4];
  float tot[kMT][4][4];  // GROUPED: the scaled sum of the finished groups
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[mt][i][c] = 0.f;
        if constexpr (GROUPED) tot[mt][i][c] = 0.f;
      }

  // this thread's 8 output columns are ncol .. ncol + 7
  const int ncol = n0 + 8 * t;
  const int group = K / G;
  int cur_g = -1;
  auto fold = [&](int grp) {  // tot += acc * s[grp, col]; acc = 0
    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i] = ncol + i < N ? __ldg(s + static_cast<size_t>(grp) * N + ncol + i) : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          tot[mt][i][c] = fmaf(acc[mt][i][c], sc[4 * (c & 1) + i], tot[mt][i][c]);
          acc[mt][i][c] = 0.f;
        }
  };

  // per-channel scales of the tile's columns, fetched with the first stage
  float* scs = reinterpret_cast<float*>(smem + sh_union_bytes<BITS>());
  if constexpr (!GROUPED) {
    if (tid < kShBN) {
      const bool in = n0 + tid < N;
      __pipeline_memcpy_async(scs + tid, in ? s + n0 + tid : s, 4, in ? 0 : 4);
    }
  }
#pragma unroll
  for (int st = 0; st < kShStages - 1; ++st) {
    if (st < ntiles) load_stage(st, t_begin + st);
    __pipeline_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    __pipeline_wait_prior(kShStages - 2);  // this thread's copies of stage `it` landed
    __syncthreads();  // everyone's landed, and the slot of stage it - 1 is free
    const int nxt = it + kShStages - 1;
    if (nxt < ntiles) load_stage(nxt % kShStages, t_begin + nxt);
    __pipeline_commit();

    const int tile = t_begin + it;
    const float* xs = reinterpret_cast<const float*>(smem + (it % kShStages) * kStage);
    const uint8_t* ws = smem + (it % kShStages) * kStage + kXBytes;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int kk = tile * kTcBK + u * kUnit;
      if ((tile * kUnits + u) % kShWK != wk || kk >= k_end) continue;  // warp-uniform
      if constexpr (GROUPED) {
        const int grp = kk / group;
        if (grp != cur_g) {
          if (cur_g >= 0) fold(cur_g);
          cur_g = grp;
        }
      }
      // A: rows (g, g + 8) of each m16 tile, k-unit columns t * kUnit/4 ..
      uint32_t ahi[kSub][kMT][4], alo[kSub][kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* xa = xs + (mt * 16 + g) * kXS + u * kUnit + t * (kUnit / 4);
        const float* xb = xa + 8 * kXS;
        float va[2 * kSub], vb[2 * kSub];
        if constexpr (kSub == 1) {
          const float2 p = *reinterpret_cast<const float2*>(xa);
          const float2 q = *reinterpret_cast<const float2*>(xb);
          va[0] = p.x; va[1] = p.y; vb[0] = q.x; vb[1] = q.y;
        } else {
          const float4 p = *reinterpret_cast<const float4*>(xa);
          const float4 q = *reinterpret_cast<const float4*>(xb);
          va[0] = p.x; va[1] = p.y; va[2] = p.z; va[3] = p.w;
          vb[0] = q.x; vb[1] = q.y; vb[2] = q.z; vb[3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          split_tf32(va[2 * j], ahi[j][mt][0], alo[j][mt][0]);      // (g, t)
          split_tf32(vb[2 * j], ahi[j][mt][1], alo[j][mt][1]);      // (g + 8, t)
          split_tf32(va[2 * j + 1], ahi[j][mt][2], alo[j][mt][2]);  // (g, t + 4)
          split_tf32(vb[2 * j + 1], ahi[j][mt][3], alo[j][mt][3]);  // (g + 8, t + 4)
        }
      }
      uint32_t b[kSub][4][2];
      sh_b_frags<BITS>(ws, u, g, t, b);
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(acc[mt][i], ahi[j][mt], b[j][i][0], b[j][i][1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(acc[mt][i], alo[j][mt], b[j][i][0], b[j][i][1]);
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is idle: reuse it for the partial tiles
  if constexpr (GROUPED) {
    if (cur_g >= 0) fold(cur_g);
  }

  // every warp's partial tile, red[wk][row][col] (the n8 tile i, column
  // 2t + c of thread (g, t) is column 8t + 4c + i)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = 2 * h + q;
        float4 v;
        if constexpr (GROUPED) {
          v = make_float4(tot[mt][0][c], tot[mt][1][c], tot[mt][2][c], tot[mt][3][c]);
        } else {
          v = make_float4(acc[mt][0][c], acc[mt][1][c], acc[mt][2][c], acc[mt][3][c]);
        }
        *reinterpret_cast<float4*>(red + (wk * kShBM + mt * 16 + g + 8 * h) * kRS + 8 * t +
                                   4 * q) = v;
      }
  tc_reduce_store<kShBM, kShBN, kShWK, kShThreads, GROUPED>(red, scs, out, M, N, m0, n0, split,
                                                           rank);
}

// -- the wide tile (M > 32): wgmma in bf16 -----------------------------------
//
// One warpgroup (4 warps) per block: a 64 x 128 output tile, warp w owning
// rows 16w .. 16w + 15, with wgmma.m64n128k16 bf16 (twice the TF32 rate,
// half its shared memory a B tile). The codes are exact in bf16 too; x is
// split in three, x = h1 + h2 + h3, each the upper half (bf16 by
// truncation) of the remaining f32 residual: |x - h1 - h2 - h3| < 2^-21 |x|,
// the short tile's bound, for three passes that cost less than two TF32
// passes in tensor time and in shared-memory traffic. x stages through the
// cp.async ring as f32 rows of kTcBK + 8 floats (the A reads, float2 at k
// 2t and 2t + 8 of rows g and g + 8, hit every bank once), codes as packed
// rows; each stage's codes are unpacked once per block into bf16 B tiles,
// K-major in the canonical no-swizzle layout: per k16 step, core matrices
// of 8 columns x 8 k (128 contiguous bytes), the two k halves kWdLBO bytes
// apart and the 16 column groups kWdSBO apart (padded past 256 so that the
// unpacking stores hit every bank once). The wgmma reads B there and A
// (h1, h2, h3) from registers, in the natural k order.
constexpr int kWdBM = 64;
constexpr int kWdBN = 128;
constexpr int kWdThreads = 128;
constexpr int kWdStages = 3;          // cp.async ring depth
constexpr int kWdXS = kTcBK + 8;      // x row stride, floats
constexpr int kWdLBO = 128;           // bytes between the k halves of a core column
constexpr int kWdSBO = 272;           // bytes between groups of 8 columns
constexpr int kWdSteps = kTcBK / 16;  // k16 steps a stage
constexpr int kWdStepBytes = (kWdBN / 8) * kWdSBO;  // one step's B tile

template <int BITS>
__host__ __device__ constexpr int wd_stage_bytes() {
  return kWdBM * kWdXS * 4 + (kTcBK * BITS / 8) * kWdBN;
}
template <int BITS>
__host__ __device__ constexpr int wd_union_bytes() {  // the ring, or the epilogue's tile
  constexpr int ring = kWdStages * wd_stage_bytes<BITS>();
  constexpr int red = kWdBM * (kWdBN + 4) * 4;
  return ring > red ? ring : red;
}
// ring | one stage's B tiles | per-channel scales; spec.qmm_tc_smem mirrors this
template <int BITS>
__host__ __device__ constexpr int wd_smem_bytes() {
  return wd_union_bytes<BITS>() + kWdSteps * kWdStepBytes + kWdBN * 4;
}

// Shared-memory matrix descriptor of one k16 step's B tile (no swizzle).
__device__ __forceinline__ uint64_t wd_desc(const void* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kWdLBO >> 4) << 16) |
         (static_cast<uint64_t>(kWdSBO >> 4) << 32);
}

// d (64 x 128, f32) += a (64 x 16, bf16, registers) * b (16 x 128, bf16,
// shared). a: thread (g, t) of warp w holds rows 16w + g (a0, a2) and + 8
// (a1, a3), k pairs 2t (a0, a1) and 2t + 8 (a2, a3), the lower k in the
// low half; d[4j .. 4j + 3]: columns 8j + 2t, + 1 of rows g (d0, d1) and
// g + 8 (d2, d3).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The accumulators are written asynchronously: around the wgmmas, tell the
// compiler that every one of them may change.
__device__ __forceinline__ void wd_fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wd_wait_all(float (&d)[64]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wd_fence_acc(d);
}

// Two offset-binary fields as a bf16 pair, each field - offset: (128 +
// field) built in the mantissa minus bias = (128 + offset); the lower k in
// the low half.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t fields, uint32_t bias) {
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(fields | 0x43004300u), "r"(bias));
  return r;
}

// x (E, M, K) @ (codes (E, K*bits/8, N) . scales (E, G, N)) -> (E, M, N),
// wide tile; grid (N / 128, M / 64, E * split) and split as the short
// tile's. GROUPED: G > 1 with groups a whole number of k16 steps.
template <int BITS, bool GROUPED>
__global__ void __launch_bounds__(kWdThreads)
qmm_wide_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                const float* __restrict__ s, float* __restrict__ out,
                int M, int K, int N, int G, int split, int wvec) {
  constexpr int kStage = wd_stage_bytes<BITS>();
  constexpr int kXBytes = kWdBM * kWdXS * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* bt = smem + wd_union_bytes<BITS>();  // B tiles, bf16
  float* scs = reinterpret_cast<float*>(bt + kWdSteps * kWdStepBytes);

  const int rank = blockIdx.z % split;
  const int e = blockIdx.z / split;
  x += static_cast<size_t>(e) * M * K;
  wp += static_cast<size_t>(e) * (K / (8 / BITS)) * N;
  s += static_cast<size_t>(e) * G * N;
  out += static_cast<size_t>(e) * M * N;
  const int m0 = blockIdx.y * kWdBM;
  const int n0 = blockIdx.x * kWdBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int tiles = (K + kTcBK - 1) / kTcBK;
  const int share = (tiles + split - 1) / split;
  const int t_begin = min(tiles, rank * share);
  const int t_end = min(tiles, t_begin + share);
  const int k_end = min(K, t_end * kTcBK);
  const int ntiles = t_end - t_begin;
  auto load_stage = [&](int slot, int tile) {
    tc_load_stage<BITS, kWdBM, kWdBN, kWdXS, kWdBN, kWdThreads>(
        reinterpret_cast<float*>(smem + slot * kStage), smem + slot * kStage + kXBytes, x, wp,
        M, K, N, m0, n0, tile * kTcBK, wvec);
  };

  // Unpack a stage's codes into the B tiles: thread = item (step, k half h,
  // column quad q) takes 8 k x 4 columns and stores 4 core rows of 8 bf16
  // codes (16 bytes each); a warp's 32 items share (step, h), so its loads
  // are 32 consecutive words and its stores conflict-free.
  auto unpack_stage = [&](const uint8_t* ws) {
    const int q = tid % (kWdBN / 4);
    const int sh = tid / (kWdBN / 4);  // step * 2 + h
    const int k8 = 8 * sh;             // first k of the item within the stage
    uint32_t c[4][4];                  // c[column][k pair]
    if constexpr (BITS == 4) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // packed row k8/2 + r: k8 + 2r (low nibble), + 1
        const uint32_t w = *reinterpret_cast<const uint32_t*>(ws + (k8 / 2 + r) * kWdBN + 4 * q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t byte = __byte_perm(w, 0, 0x4440 + i);  // byte i, alone
          c[i][r] = bf16_pair((byte * 4097u) & 0x000F000Fu, 0x43084308u);
        }
      }
    } else if constexpr (BITS == 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // packed row k8/4 + r: k8 + 4r .. + 3
        const uint32_t w = *reinterpret_cast<const uint32_t*>(ws + (k8 / 4 + r) * kWdBN + 4 * q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t byte = __byte_perm(w, 0, 0x4440 + i);
          c[i][2 * r] = bf16_pair((byte * 16385u) & 0x00030003u, 0x43024302u);
          c[i][2 * r + 1] = bf16_pair(((byte >> 4) * 16385u) & 0x00030003u, 0x43024302u);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // packed rows k8 + 2r, + 1
        const uint32_t w0 =
            *reinterpret_cast<const uint32_t*>(ws + (k8 + 2 * r) * kWdBN + 4 * q) ^ 0x80808080u;
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(ws + (k8 + 2 * r + 1) * kWdBN + 4 * q) ^ 0x80808080u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // exact small integers: their upper halves are bf16
          const uint32_t lo = code_tf32((w0 >> (8 * i)) & 0xFFu, 8388736.f);
          const uint32_t hi = code_tf32((w1 >> (8 * i)) & 0xFFu, 8388736.f);
          c[i][r] = __byte_perm(lo, hi, 0x7632);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * q + i;
      *reinterpret_cast<uint4*>(bt + (sh / 2) * kWdStepBytes + (n / 8) * kWdSBO +
                                (sh % 2) * kWdLBO + (n % 8) * 16) =
          make_uint4(c[i][0], c[i][1], c[i][2], c[i][3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  };

  float d[64];
  float tot[64];  // GROUPED: the scaled sum of the finished groups
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    d[i] = 0.f;
    if constexpr (GROUPED) tot[i] = 0.f;
  }
  const int group = K / G;
  int cur_g = -1;
  auto fold = [&](int grp) {  // tot += d * s[grp, col]; d = 0 (d is settled)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 8 * j + 2 * t + q;
        const float sc = n < N ? __ldg(s + static_cast<size_t>(grp) * N + n) : 0.f;
        tot[4 * j + q] = fmaf(d[4 * j + q], sc, tot[4 * j + q]);
        tot[4 * j + 2 + q] = fmaf(d[4 * j + 2 + q], sc, tot[4 * j + 2 + q]);
        d[4 * j + q] = 0.f;
        d[4 * j + 2 + q] = 0.f;
      }
  };

  if constexpr (!GROUPED) {  // per-channel scales, fetched with the first stage
    const bool in = n0 + tid < N;
    __pipeline_memcpy_async(scs + tid, in ? s + n0 + tid : s, 4, in ? 0 : 4);
  }
#pragma unroll
  for (int st = 0; st < kWdStages - 1; ++st) {
    if (st < ntiles) load_stage(st, t_begin + st);
    __pipeline_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    __pipeline_wait_prior(kWdStages - 2);  // this thread's copies of stage `it` landed
    __syncthreads();  // everyone's landed; the slot of stage it - 1 is free
    const int nxt = it + kWdStages - 1;
    if (nxt < ntiles) load_stage(nxt % kWdStages, t_begin + nxt);
    __pipeline_commit();

    const int tile = t_begin + it;
    const unsigned char* cur = smem + (it % kWdStages) * kStage;
    unpack_stage(cur + kXBytes);
    // A of every step and level: a0 .. a3 are (row g, k 2t), (g + 8, 2t),
    // (g, 2t + 8), (g + 8, 2t + 8) of this warp's 16 rows, each a pair of
    // neighbours in x; level lv is the upper half of the residual after
    // the levels before it
    uint32_t a[kWdSteps][3][4];
    const float* xa = reinterpret_cast<const float*>(cur) + (16 * warp + g) * kWdXS + 2 * t;
#pragma unroll
    for (int st = 0; st < kWdSteps; ++st)
#pragma unroll
      for (int rg = 0; rg < 4; ++rg) {
        const float2 v = *reinterpret_cast<const float2*>(xa + (rg & 1) * 8 * kWdXS + 16 * st +
                                                          (rg >> 1) * 8);
        float r0 = v.x, r1 = v.y;
#pragma unroll
        for (int lv = 0; lv < 3; ++lv) {
          a[st][lv][rg] = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
          r0 = __fsub_rn(r0, __uint_as_float(__float_as_uint(r0) & 0xFFFF0000u));
          r1 = __fsub_rn(r1, __uint_as_float(__float_as_uint(r1) & 0xFFFF0000u));
        }
      }
    __syncthreads();  // every B tile of the stage is written
    wd_fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < kWdSteps; ++st) {
      const int kk = tile * kTcBK + 16 * st;
      if (kk >= k_end) break;  // block-uniform
      if constexpr (GROUPED) {
        const int grp = kk / group;
        if (grp != cur_g) {
          if (cur_g >= 0) {
            wd_wait_all(d);
            fold(cur_g);
            wd_fence_acc(d);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          }
          cur_g = grp;
        }
      }
      const uint64_t desc = wd_desc(bt + st * kWdStepBytes);
#pragma unroll
      for (int lv = 0; lv < 3; ++lv) wgmma_bf16(d, a[st][lv], desc);
    }
    wd_wait_all(d);  // A registers and the B tiles are free again
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is idle: reuse it for the tile
  if constexpr (GROUPED) {
    if (cur_g >= 0) fold(cur_g);
  }
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v;
      if constexpr (GROUPED) {
        v = make_float2(tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
      } else {
        v = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
      *reinterpret_cast<float2*>(red + (16 * warp + g + 8 * h) * (kWdBN + 4) + 8 * j + 2 * t) = v;
    }
  tc_reduce_store<kWdBM, kWdBN, 1, kWdThreads, GROUPED>(red, scs, out, M, N, m0, n0, split,
                                                         rank);
}

// -- the decode body (M <= 8): mma.sync with the operands swapped -----------
//
// out^T (N x M) = W^T (N x K) x^T (K x M), one mma.sync.m16n8k16 bf16 per
// 16 weight columns x 16 k: A is 16 columns of codes (exact in bf16), B is
// x^T with the batch rows as its 8 columns, so M <= 8 wastes no row; x in
// three bf16 parts (the wide tile's split). A thread (g, t) reads a piece of
// P bytes of a packed row at column P*g and so holds P columns; MMA tile j
// of its warp gives row g to column P*g + 2j and row g + 8 to column P*g +
// 2j + 1 (byte 2j and 2j + 1 of the piece), so the warp's 8P columns are P/2
// tiles. A thread's k of a tile are logical k 2t, 2t + 1 (registers a0, a1)
// and 2t + 8, 2t + 9 (a2, a3); they map to physical k of the 16-k unit:
//   W4  2t, 2t + 1 / 2t + 8, 2t + 9   (both nibbles of packed rows t, t + 4)
//   W2  4t, 4t + 1 / 4t + 2, 4t + 3   (fields 0, 1 / 2, 3 of packed row t)
//   W8  t, t + 4 / t + 8, t + 12      (packed rows t, t + 4, t + 8, t + 12)
// and B takes x at the same physical k. Each warp walks a contiguous share
// of K's units through its own ring of R slots (a unit's codes and x,
// 16-byte cp.async copies issued R - 1 units ahead), so warps meet only at
// the end, in shared memory, summed in warp order. A code pair costs three
// instructions: a byte_perm spreading the byte and its copy shifted by one
// field to bits 0 and 16, one lop3 masking the fields and setting bf16's
// exponent of 128, and one bf16x2 subtraction of 128 + offset. Per-channel
// scales multiply the finished sums; scale groups (a whole number of 16-k
// units) fold into totals when a warp's next unit lies in another group.

constexpr int kDecUnit = 16;  // k of one MMA
template <int BITS>
__host__ __device__ constexpr int dec_rows() { return 2 * BITS; }  // packed rows a unit
// x row stride (floats) in a slot: a warp's reads of x (float2 at k 2t and
// 2t + 8 for W4, float4 at 4t for W2, floats at t + 4i for W8, of rows g)
// hit every bank once
template <int BITS>
__host__ __device__ constexpr int dec_xstride() { return BITS == 4 ? 24 : (BITS == 2 ? 48 : 20); }
// code row stride (bytes) in a slot: pieces of 16 bytes (P 16) at rows t
// and t + 4 hit every bank once; pieces of 2 bytes (P 2) need no padding
template <int P>
__host__ __device__ constexpr int dec_wstride() { return P == 16 ? 160 : 16; }
template <int BITS, int P>
__host__ __device__ constexpr int dec_slot_bytes() {
  return dec_rows<BITS>() * dec_wstride<P>() + kMaxM * dec_xstride<BITS>() * 4;
}
// the warps' rings, or (after the mainloop, in the same memory) their
// partial tiles (NW x 8 rows x (8P + 4) floats); spec.qmm_dec_smem mirrors it
template <int BITS, int P, int NW, int R>
__host__ __device__ constexpr int dec_smem_bytes() {
  constexpr int ring = NW * R * dec_slot_bytes<BITS, P>();
  constexpr int red = NW * kMaxM * (8 * P + 4) * 4;
  return ring > red ? ring : red;
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
// Fragments of thread (g, t): a0 (g, k 2t..), a1 (g + 8, 2t..), a2 (g, 2t +
// 8..), a3 (g + 8, 2t + 8..); b0 (k 2t.., n g), b1 (k 2t + 8.., n g);
// d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's share of the copies of every unit into a warp's slot: its
// 16-byte pieces of the unit's packed rows of the block's 8P columns (rows
// lane / (P/2) + i * 32 / (P/2), column 16 * (lane % (P/2))) and 4 floats
// of x (row lane / 4, k 4 * (lane % 4) of the unit's 16), by cp.async with
// zero fill past M, N and K; the lane-fixed parts are worked out once.
template <int BITS, int P>
struct DecLoader {
  static constexpr int kRows = dec_rows<BITS>();
  static constexpr int kPieces = P / 2;  // 16-byte pieces of a packed row
  static constexpr int kStep = 32 / kPieces;
  static constexpr int kCopies = (kRows * kPieces + 31) / 32;
  const uint8_t* wsrc;  // this lane's first piece of unit 0
  const float* xsrc;    // this lane's x of unit 0
  int r0, col, ncol, rows, K, N, wvec;
  bool x_in;

  __device__ __forceinline__ DecLoader(const float* x, const uint8_t* wp, int M, int K_, int N_,
                                       int n0, int wvec_, int lane)
      : K(K_), N(N_), wvec(wvec_) {
    r0 = lane / kPieces;
    col = 16 * (lane % kPieces);
    ncol = n0 + col;
    rows = K * BITS / 8;
    wsrc = wp + static_cast<size_t>(r0) * N + ncol;
    x_in = (lane >> 2) < M;
    xsrc = x + static_cast<size_t>(lane >> 2) * K + 4 * (lane & 3);
  }

  __device__ __forceinline__ void load(uint8_t* slot, int u, int lane) const {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int r = r0 + kStep * i;
      if (r >= kRows) break;  // P 2: the lanes past the unit's rows
      const int pr = u * kRows + r;
      const uint8_t* src = wsrc + static_cast<size_t>(u * kRows + kStep * i) * N;
      uint8_t* dst = slot + r * dec_wstride<P>() + col;
      if (wvec == 16) {  // N % 16 == 0: a piece lies wholly inside N or outside
        const bool in = ncol < N && pr < rows;
        __pipeline_memcpy_async(dst, in ? src : wsrc, 16, in ? 0 : 16);
      } else if (wvec == 4) {
#pragma unroll
        for (int b = 0; b < 16; b += 4) {
          const bool in = ncol + b < N && pr < rows;
          __pipeline_memcpy_async(dst + b, in ? src + b : wsrc, 4, in ? 0 : 4);
        }
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b) dst[b] = (ncol + b < N && pr < rows) ? __ldg(src + b) : 0;
      }
    }
    float* dst = reinterpret_cast<float*>(slot + kRows * dec_wstride<P>()) +
                 (lane >> 2) * dec_xstride<BITS>() + 4 * (lane & 3);
    const int k = u * kDecUnit + 4 * (lane & 3);
    const float* src = xsrc + u * kDecUnit;
    if ((K & 3) == 0) {  // x rows start 16-byte aligned (the wrapper aligns x)
      const bool in = x_in && k < K;
      __pipeline_memcpy_async(dst, in ? src : xsrc, 16, in ? 0 : 16);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = x_in && k + q < K;
        __pipeline_memcpy_async(dst + q, in ? src + q : xsrc, 4, in ? 0 : 4);
      }
    }
  }
};

// The P bytes of packed row `row` of a slot at column P*g, in words.
template <int P>
__device__ __forceinline__ void dec_piece(const uint8_t* ws, int row, int g,
                                          uint32_t (&w)[(P + 3) / 4]) {
  static_assert(P == 2 || P == 16, "the decode tiles read 2- or 16-byte pieces");
  const uint8_t* p = ws + row * dec_wstride<P>() + P * g;
  if constexpr (P == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// Byte b of piece words `lo` at bits 0..7 and of `hi` at bits 16..23.
template <int P>
__device__ __forceinline__ uint32_t dec_spread(const uint32_t (&lo)[(P + 3) / 4],
                                               const uint32_t (&hi)[(P + 3) / 4], int b) {
  const int i = b % 4;
  return __byte_perm(lo[b / 4], hi[b / 4], i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
}

// The fields `MASK` keeps of t as a bf16 pair, each field - offset: one
// lop3 ((t & MASK) | (128 in both halves' exponent)) and one bf16x2
// subtraction of (128 + offset).
template <uint32_t MASK>
__device__ __forceinline__ uint32_t dec_pair(uint32_t t, uint32_t bias) {
  uint32_t f, r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(f) : "r"(t), "n"(MASK), "r"(0x43004300u));
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(f), "r"(bias));
  return r;
}

// Byte b of a piece, alone in the low byte.
template <int P>
__device__ __forceinline__ uint32_t dec_byte(const uint32_t (&w)[(P + 3) / 4], int b) {
  return __byte_perm(w[b / 4], 0, 0x4440 + (b % 4));
}

// An int8 code pair (lo: the lower k) as bf16: exact integers, whose f32
// upper halves are their bf16 values.
__device__ __forceinline__ uint32_t dec_int8_pair(uint32_t lo, uint32_t hi) {
  return __byte_perm(code_tf32(lo ^ 0x80u, 8388736.f), code_tf32(hi ^ 0x80u, 8388736.f), 0x7632);
}

// x (E, M <= 8, K) @ (codes (E, K*bits/8, N) . scales (E, G, N)) -> (E, M,
// N): block (column strip of 8P, expert), NW warps over K. GROUPED: G > 1
// with groups a whole number of 16-k units.
template <int BITS, bool GROUPED, int P, int NW, int R>
__global__ void __launch_bounds__(NW * 32)
qgemv_tc_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                const float* __restrict__ s, float* __restrict__ out, int M, int K, int N, int G,
                int wvec) {
  constexpr int kBN = 8 * P;
  constexpr int kTiles = P / 2;
  constexpr int kPasses = P <= 4 ? 3 : 1;  // accumulators per tile: one per pass when few
  constexpr int kSlot = dec_slot_bytes<BITS, P>();
  constexpr int kWS = dec_wstride<P>();
  constexpr int kXS = dec_xstride<BITS>();
  constexpr int kThreads = NW * 32;
  static_assert(kThreads % kBN == 0, "a thread's output column is fixed");
  extern __shared__ __align__(16) unsigned char smem[];

  const int e = blockIdx.y;
  x += static_cast<size_t>(e) * M * K;
  wp += static_cast<size_t>(e) * (K * BITS / 8) * N;
  s += static_cast<size_t>(e) * G * N;
  out += static_cast<size_t>(e) * M * N;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  // the per-channel scale of this thread's output column
  float sc_out = 0.f;
  if constexpr (!GROUPED) {
    if (tid < kMaxM * kBN && n0 + tid % kBN < N) sc_out = __ldg(s + n0 + tid % kBN);
  }

  float acc[kTiles][kPasses][4];
  float tot[kTiles][4];  // GROUPED: the scaled sum of the finished groups
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int p = 0; p < kPasses; ++p) acc[j][p][c] = 0.f;
      tot[j][c] = 0.f;
    }
  const int group = K / G;
  int cur_g = -1;
  auto fold = [&](int grp) {  // tot += acc * s[grp, col]; acc = 0
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int col = n0 + P * g + 2 * j;
      const float s0 = col < N ? __ldg(s + static_cast<size_t>(grp) * N + col) : 0.f;
      const float s1 = col + 1 < N ? __ldg(s + static_cast<size_t>(grp) * N + col + 1) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = acc[j][0][c];
#pragma unroll
        for (int p = 1; p < kPasses; ++p) v += acc[j][p][c];
        tot[j][c] = fmaf(v, c < 2 ? s0 : s1, tot[j][c]);
#pragma unroll
        for (int p = 0; p < kPasses; ++p) acc[j][p][c] = 0.f;
      }
    }
  };

  // this warp's units: a contiguous share of K, u_begin .. u_begin + nu - 1
  const int units = (K + kDecUnit - 1) / kDecUnit;
  const int nu = units / NW + (w < units % NW);
  const int u_begin = w * (units / NW) + min(w, units % NW);
  uint8_t* ring = smem + w * R * kSlot;
  const DecLoader<BITS, P> loader(x, wp, M, K, N, n0, wvec, lane);
#pragma unroll
  for (int i = 0; i < R - 1; ++i) {
    if (i < nu) loader.load(ring + i * kSlot, u_begin + i, lane);
    __pipeline_commit();
  }
  for (int i = 0; i < nu; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(R - 2) : "memory");  // unit i's copies landed
    __syncwarp();                  // every lane's; and the slot of unit i - 1 is free
    const int nxt = i + R - 1;
    if (nxt < nu) loader.load(ring + (nxt % R) * kSlot, u_begin + nxt, lane);
    __pipeline_commit();

    const int u = u_begin + i;
    if constexpr (GROUPED) {
      const int grp = u * kDecUnit / group;
      if (grp != cur_g) {
        if (cur_g >= 0) fold(cur_g);
        cur_g = grp;
      }
    }
    const uint8_t* ws = ring + (i % R) * kSlot;
    const float* xs = reinterpret_cast<const float*>(ws + dec_rows<BITS>() * kWS) + g * kXS;
    // B: x of batch row g at this thread's four physical k, in three parts
    float v[4];
    if constexpr (BITS == 4) {
      const float2 lo = *reinterpret_cast<const float2*>(xs + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(xs + 2 * t + 8);
      v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
    } else if constexpr (BITS == 2) {
      const float4 q = *reinterpret_cast<const float4*>(xs + 4 * t);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) v[i4] = xs[t + 4 * i4];
    }
    uint32_t b[3][2];
#pragma unroll
    for (int lv = 0; lv < 3; ++lv) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b[lv][h] = __byte_perm(__float_as_uint(v[2 * h]), __float_as_uint(v[2 * h + 1]), 0x7632);
      }
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        v[i4] = __fsub_rn(v[i4], __uint_as_float(__float_as_uint(v[i4]) & 0xFFFF0000u));
      }
    }
    // A: this thread's pieces of the unit's packed rows
    constexpr int kPieceRows = BITS == 2 ? 1 : (BITS == 4 ? 2 : 4);
    uint32_t pc[kPieceRows][(P + 3) / 4];
#pragma unroll
    for (int r = 0; r < kPieceRows; ++r) dec_piece<P>(ws, t + 4 * r, g, pc[r]);
    // the pieces shifted so that a byte's upper field lands on the next
    // byte's place: W4 pc >> 4 (row t, row t + 4); W2 pc >> 2, >> 4, >> 6
    constexpr int kShifts = BITS == 4 ? 2 : (BITS == 2 ? 3 : 0);
    uint32_t sh[kShifts > 0 ? kShifts : 1][(P + 3) / 4];
#pragma unroll
    for (int q = 0; q < (P + 3) / 4; ++q) {
      if constexpr (BITS == 4) {
        sh[0][q] = pc[0][q] >> 4;
        sh[1][q] = pc[1][q] >> 4;
      } else if constexpr (BITS == 2) {
        sh[0][q] = pc[0][q] >> 2;
        sh[1][q] = pc[0][q] >> 4;
        sh[2][q] = pc[0][q] >> 6;
      }
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // h: row g (byte 2j) or g + 8 (byte 2j + 1)
        const int by = 2 * j + h;  // byte of the pieces: column P g + 2j + h
        if constexpr (BITS == 4) {  // nibbles lo, hi of the byte to bits 0, 16
          a[h] = dec_pair<0x000F000Fu>(dec_spread<P>(pc[0], sh[0], by), 0x43084308u);
          a[2 + h] = dec_pair<0x000F000Fu>(dec_spread<P>(pc[1], sh[1], by), 0x43084308u);
        } else if constexpr (BITS == 2) {  // fields 0, 1 and 2, 3 of the byte to bits 0, 16
          a[h] = dec_pair<0x00030003u>(dec_spread<P>(pc[0], sh[0], by), 0x43024302u);
          a[2 + h] = dec_pair<0x00030003u>(dec_spread<P>(sh[1], sh[2], by), 0x43024302u);
        } else {
          a[h] = dec_int8_pair(dec_byte<P>(pc[0], by), dec_byte<P>(pc[1], by));
          a[2 + h] = dec_int8_pair(dec_byte<P>(pc[2], by), dec_byte<P>(pc[3], by));
        }
      }
#pragma unroll
      for (int lv = 0; lv < 3; ++lv) mma_bf16(acc[j][lv % kPasses], a, b[lv][0], b[lv][1]);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // every warp is done with its ring: reuse it for the partial tiles
  if constexpr (GROUPED) {
    if (cur_g >= 0) fold(cur_g);
  }

  // red[w][n][col] (row stride kBN + 4): d0/d2 are columns P g + 2j and + 1
  // of batch row 2t, d1/d3 the same of row 2t + 1
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kRS = kBN + 4;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    float d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (GROUPED) {
        d[c] = tot[j][c];
      } else {
        d[c] = acc[j][0][c];
#pragma unroll
        for (int p = 1; p < kPasses; ++p) d[c] += acc[j][p][c];
      }
    }
    float* r0 = red + (w * kMaxM + 2 * t) * kRS + P * g + 2 * j;
    *reinterpret_cast<float2*>(r0) = make_float2(d[0], d[2]);
    *reinterpret_cast<float2*>(r0 + kRS) = make_float2(d[1], d[3]);
  }
  __syncthreads();
  for (int o = tid; o < kMaxM * kBN; o += kThreads) {
    const int m = o / kBN;
    const int col = o % kBN;
    if (m >= M || n0 + col >= N) continue;
    float v = red[m * kRS + col];
#pragma unroll
    for (int ww = 1; ww < NW; ++ww) v += red[(ww * kMaxM + m) * kRS + col];
    if constexpr (!GROUPED) v *= sc_out;
    out[static_cast<size_t>(m) * N + n0 + col] = v;
  }
}

// The decode body's configurations (spec.QMM_DEC_TILES): columns a block
// (8P), warps over K (NW), ring slots a warp (R).
template <int BITS, bool GROUPED, int P, int NW, int R>
int launch_dec_kernel(const float* x, const uint8_t* wp, const float* s, float* out, int E, int M,
                      int K, int N, int G, int smem, int wvec, cudaStream_t st) {
  constexpr int need = dec_smem_bytes<BITS, P, NW, R>();
  if (smem != need) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = qgemv_tc_kernel<BITS, GROUPED, P, NW, R>;
  static bool cap_raised = false;  // once per instance: dynamic shared memory above 48 KB
  if (!cap_raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap_raised = true;
  }
  const dim3 grid((N + 8 * P - 1) / (8 * P), E);
  kern<<<grid, NW * 32, need, st>>>(x, wp, s, out, M, K, N, G, wvec);
  return static_cast<int>(cudaGetLastError());
}

// tile 2: 16 columns, 16 warps, 9 slots (qgemv's narrow matrices: a block
// per 16 columns, every unit of a warp in flight at K 2048); tile 3: 128
// columns, 4 warps, 4 slots (the stacked experts' stream: 32 KB a block, so
// 5 blocks share an SM, ~60 KB of codes in flight).
int launch_dec_any(const void* x, const void* wp, const void* s, void* out, int E, int M, int K,
                   int N, int G, int bits, int tile, int smem, int wvec, cudaStream_t st) {
  if (M > kMaxM || (tile != 2 && tile != 3) || (G > 1 && (K / G) % kDecUnit != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(wp);
  const float* sf = static_cast<const float*>(s);
  float* of = static_cast<float*>(out);
#define QDEC_LAUNCH(B, GR)                                                                  \
  return tile == 2                                                                          \
             ? launch_dec_kernel<B, GR, 2, 16, 9>(xf, w8, sf, of, E, M, K, N, G, smem, wvec, st) \
             : launch_dec_kernel<B, GR, 16, 4, 4>(xf, w8, sf, of, E, M, K, N, G, smem, wvec, st)
  switch (bits * 2 + (G > 1)) {
    case 4: QDEC_LAUNCH(2, false);
    case 5: QDEC_LAUNCH(2, true);
    case 8: QDEC_LAUNCH(4, false);
    case 9: QDEC_LAUNCH(4, true);
    case 16: QDEC_LAUNCH(8, false);
    case 17: QDEC_LAUNCH(8, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QDEC_LAUNCH
}

// Launch `kern` as the plan says: `threads` a block, `smem` bytes of
// dynamic shared memory (which must be what the instance needs: the plan
// and the kernel agree, or nothing runs), and K split over a cluster of
// `split` blocks along z.
template <int BITS, bool GROUPED, int TILE>
int launch_tc_kernel(void (*kern)(const float*, const uint8_t*, const float*, float*, int, int,
                                  int, int, int, int),
                     int need, int bm, int bn, int threads, const float* x, const uint8_t* wp,
                     const float* s, float* out, int E, int M, int K, int N, int G, int split,
                     int smem, int wvec, cudaStream_t st) {
  if (smem != need) return static_cast<int>(cudaErrorInvalidValue);
  static bool cap_raised = false;  // once per instance: dynamic shared memory above 48 KB
  if (!cap_raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap_raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + bn - 1) / bn, (M + bm - 1) / bm, E * split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = need;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, x, wp, s, out, M, K, N, G, split, wvec));
}

template <int BITS, bool GROUPED>
int launch_tc_tile(const float* x, const uint8_t* wp, const float* s, float* out, int E,
                   int M, int K, int N, int G, int tile, int split, int smem, int wvec,
                   cudaStream_t st) {
  if (tile == 0) {
    return launch_tc_kernel<BITS, GROUPED, 0>(qmm_short_kernel<BITS, GROUPED>,
                                              sh_smem_bytes<BITS>(), kShBM, kShBN, kShThreads,
                                              x, wp, s, out, E, M, K, N, G, split, smem, wvec,
                                              st);
  }
  return launch_tc_kernel<BITS, GROUPED, 1>(qmm_wide_kernel<BITS, GROUPED>,
                                            wd_smem_bytes<BITS>(), kWdBM, kWdBN, kWdThreads, x,
                                            wp, s, out, E, M, K, N, G, split, smem, wvec, st);
}

// The tensor-core bodies over E stacked problems, dispatched on bits and G.
// Scale groups must be a whole number of k-units: of the short tile's (8 k,
// 16 for W2), and of 16 k for the wide tile.
int launch_tc_any(const void* x, const void* wp, const void* s, void* out, int E, int M,
                  int K, int N, int G, int bits, int tile, int split, int smem, int wvec,
                  cudaStream_t st) {
  const int unit = tile == 1 ? 16 : (bits == 2 ? 16 : 8);
  if ((tile != 0 && tile != 1) || (split != 1 && split != 2 && split != 4 && split != 8) ||
      E * split > 65535 || (G > 1 && (K / G) % unit != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(wp);
  const float* sf = static_cast<const float*>(s);
  float* of = static_cast<float*>(out);
#define QTC_LAUNCH(B, GR) \
  return launch_tc_tile<B, GR>(xf, w8, sf, of, E, M, K, N, G, tile, split, smem, wvec, st)
  switch (bits * 2 + (G > 1)) {
    case 4: QTC_LAUNCH(2, false);
    case 5: QTC_LAUNCH(2, true);
    case 8: QTC_LAUNCH(4, false);
    case 9: QTC_LAUNCH(4, true);
    case 16: QTC_LAUNCH(8, false);
    case 17: QTC_LAUNCH(8, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QTC_LAUNCH
}

}  // namespace

extern "C" {

// Bodies of the entry points, chosen by the caller's plan
// (kernels/spec.py plan_qmatmul, plan_qgemv): the CUDA-core tile, the
// tensor-core tile, and at M <= 8 the CUDA-core decode body and the
// tensor-core one.
enum Body { kBodySimt = 0, kBodyTc = 1, kBodyGemv = 2, kBodyGemvTc = 3 };

// Each entry point launches on `stream` and returns cudaGetLastError():
// 0 when the launch was accepted. vec: the widest copy of packed-code row
// pieces that N and the codes' base allow, 16, 4 or 1 bytes. body, tile,
// split, smem: the plan. qgemv is qmatmul_grouped with one expert.
int qmatmul_launch(const void* x, const void* wp, const void* s, void* out,
                   int M, int K, int N, int G, int bits, int vec, int body, int tile,
                   int split, int smem, void* stream) {
  if (M < 1 || K < 1 || N < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == kBodyTc) {
    const int err = launch_tc_any(x, wp, s, out, 1, M, K, N, G, bits, tile, split, smem, vec, st);
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
  }
  if (body != kBodySimt) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kMmThreads);
  const dim3 grid((N + kMmBN - 1) / kMmBN, (M + kMmBM - 1) / kMmBM, kMmSplit);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(wp);
  const float* sf = static_cast<const float*>(s);
  float* of = static_cast<float*>(out);
  const int v4 = vec >= 4;
  switch (bits) {
    case 2: qmatmul_kernel<2><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, v4); break;
    case 4: qmatmul_kernel<4><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, v4); break;
    case 8: qmatmul_kernel<8><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, v4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stacked experts: x (E, M, K), wp (E, K*bits/8, N), s (E, G, N), out
// (E, M, N); E = 1 for qgemv. The decode bodies take M <= 8 rows per
// expert; the tiles any M.
int qmatmul_grouped_launch(const void* x, const void* wp, const void* s, void* out,
                           int E, int M, int K, int N, int G, int bits, int vec, int body,
                           int tile, int split, int smem, void* stream) {
  if (E < 1 || E > 65535 || M < 1 || K < 1 || N < 1 || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == kBodyTc) {
    const int err = launch_tc_any(x, wp, s, out, E, M, K, N, G, bits, tile, split, smem, vec, st);
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
  }
  if (body == kBodyGemvTc) {
    const int err = launch_dec_any(x, wp, s, out, E, M, K, N, G, bits, tile, smem, vec, st);
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
  }
  const float* xf = static_cast<const float*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(wp);
  const float* sf = static_cast<const float*>(s);
  float* of = static_cast<float*>(out);
  if (body == kBodyGemv) {
    if (M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(kGemvTX, kGemvTY);
    const dim3 grid((N + kGemvCols - 1) / kGemvCols, E);
    // 16-byte copies of packed rows: N % 16 == 0 and an aligned base
    const int v16 = vec == 16;
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
  } else if (body == kBodySimt) {
    const dim3 block(kMmThreads);
    const dim3 grid((N + kMmBN - 1) / kMmBN, (M + kMmBM - 1) / kMmBM, E);
    const int v4 = vec >= 4;
    switch (bits) {
      case 2: qmatmul_grouped_kernel<2><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, v4); break;
      case 4: qmatmul_grouped_kernel<4><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, v4); break;
      case 8: qmatmul_grouped_kernel<8><<<grid, block, 0, st>>>(xf, w8, sf, of, M, K, N, G, v4); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
