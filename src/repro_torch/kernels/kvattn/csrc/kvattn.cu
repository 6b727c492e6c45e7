// Decode attention over an int8 KV cache for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/kvattn/kernel.py::kv_decode (entry :70, body :31).
//
// Operands (row-major, contiguous):
//   q       (B, H, hd)     f32 queries of one decode step
//   k8, v8  (B, S, K, hd)  int8 cache codes
//   ks, vs  (B, S, K)      f32 per-(slot, kv-head) scales
//   kpos    (B, S)         i32 position held by each slot, -1 = empty
//   cur     (B,)           i32 position of the query
//   out     (B, H, hd)     f32
// Head h reads kv head h / G, G = H / K query rows per kv head (GQA, MQA
// and MHA alike). `window` < 0 means no sliding window.
//
// What bounds it: bytes. The kernel does 4*B*H*S*hd f32 operations on
// 2*B*S*K*hd bytes of int8 codes (plus 8 bytes of scales per slot and kv
// head), that is 2*G operations per byte read, against the card's ~20 f32
// operations per byte of device memory: bound by bytes up to G = 10, which
// covers the serve engine (G = 1) and GQA at TinyLlama's width (G = 8).
// The design reads each K/V byte once per (batch, kv-head) for all G query
// rows: one block per (batch, kv-head) keeps the G rows of q resident in
// shared memory while S streams through in tiles of 256 slots.
//
// Per tile: the int8 K/V codes and the V scales are staged in shared
// memory; each thread scores one slot against the G rows; a warp per row
// takes the online-softmax step in f32 with the TPU kernel's arithmetic
// (masked scores are -1e30, m starts at -inf, so a fully masked tile adds
// weight 1 per slot that a later valid tile wipes out through corr = 0,
// and a row with no valid slot returns the mean of V over S, as the plain
// softmax does); then the threads accumulate P @ V,
// splitting the tile's slots across thread groups when G * hd / 4 is
// below the block size and summing the groups in a fixed order. Slots past
// S in the last tile are left out of every sum, so they are not masked
// slots. Reductions use warp shuffles in a fixed pattern and no atomics:
// the result is deterministic.
//
// Loads: a thread issues up to kPre of its K/V load units of VB bytes,
// plus its slot's kpos and scales, before it stores any of them, so a tile
// costs about one device-memory round trip for hd <= 128. Two bodies, by
// the head dim (spec.plan_kv_decode): 16-byte units for hd % 16 == 0 (the
// codes 16-byte aligned), 8-byte units for the other multiples of 8 (hd
// 120 of h2o-danube3-4b; 8-byte aligned), with twice the units in flight
// per batch so the bytes in flight stay the same. A register prefetch of
// the next tile during the current tile's math was measured slower and
// left out. Splitting S
// across blocks (flash-decoding), cp.async/TMA staging and tensor cores
// are later work. What bounds it today is parallelism, not bytes: the
// engine's shape gives B * K = 96 blocks for 132 SMs, one block of 8 warps
// per SM, so every load, barrier and reduction step of a tile is exposed
// latency (PERF.md has the times per phase).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // one cache slot of a tile per thread
constexpr int kTile = kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;      // spec.KV_G_MAX
constexpr int kMaxHd = 256;    // spec.KV_HD_MAX
constexpr int kMaxUnits = kMaxG * kMaxHd / 4 / kThreads;  // output words per thread
// K (and V) load units of VB bytes a thread issues before storing: 128
// bytes of each
template <int VB>
constexpr int pre_units() { return 128 / VB; }
constexpr float kMask = -1e30f;  // the TPU kernel's MASK

__device__ __forceinline__ void put(uint32_t* dst, uint4 x) {
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

__device__ __forceinline__ void put(uint32_t* dst, uint2 x) {
  dst[0] = x.x;
  dst[1] = x.y;
}

// The load unit of VB bytes.
template <int VB>
using unit_t = typename std::conditional<VB == 16, uint4, uint2>::type;

// A batch of one tile's loads for one thread, held in registers until
// stored: load units j0 .. j0 + kPre - 1 of VB bytes of the tile's K and V
// codes (unit j covers item j * kThreads + tid of the tile's n * urow
// units), and with the first batch the thread's own slot's kpos and scales.
template <int VB>
struct Stage {
  static constexpr int kPre = pre_units<VB>();
  unit_t<VB> k[kPre], v[kPre];
  int kp;
  float ks, vs;

  __device__ __forceinline__ void load(const int8_t* kb, const int8_t* vb, const float* ksb,
                                       const float* vsb, const int* kpb, int K,
                                       size_t slot_bytes, int s0, int n, int urow, int j0,
                                       int tid) {
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int i = (j0 + j) * kThreads + tid;
      if (i < n * urow) {
        const int r = i / urow, u = i - r * urow;
        const size_t off = static_cast<size_t>(s0 + r) * slot_bytes + u * VB;
        k[j] = __ldg(reinterpret_cast<const unit_t<VB>*>(kb + off));
        v[j] = __ldg(reinterpret_cast<const unit_t<VB>*>(vb + off));
      }
    }
    if (j0 == 0 && tid < n) {
      const size_t s = static_cast<size_t>(s0 + tid);
      kp = __ldg(kpb + s);
      ks = __ldg(ksb + s * K);
      vs = __ldg(vsb + s * K);
    }
  }

  __device__ __forceinline__ void store(uint32_t* k_s, uint32_t* v_s, int W, int KW, int n,
                                        int urow, int j0, int tid) const {
    constexpr int kWords = VB / 4;
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int i = (j0 + j) * kThreads + tid;
      if (i < n * urow) {
        const int r = i / urow, u = i - r * urow;
        put(k_s + r * KW + u * kWords, k[j]);
        put(v_s + r * W + u * kWords, v[j]);
      }
    }
  }
};

// Four int8 codes packed in one little-endian word.
__device__ __forceinline__ float4 unpack(uint32_t w) {
  return make_float4(static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(w))),
                     static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(w >> 8))),
                     static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(w >> 16))),
                     static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(w >> 24))));
}

// sum over slots r = r0, r0 + step, ... < n of p[r] * (v[r] * vs[r]) for
// one word (4 values) of a V row; v points at that word of row 0.
__device__ __forceinline__ float4 pv_sum(const float* p, const uint32_t* v, int W,
                                         const float* vsc, int r0, int n, int step) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int r = r0; r < n; r += step) {
    const float pr = p[r];
    const float sc = vsc[r];
    const float4 x = unpack(v[r * W]);
    a.x = fmaf(pr, x.x * sc, a.x);
    a.y = fmaf(pr, x.y * sc, a.y);
    a.z = fmaf(pr, x.z * sc, a.z);
    a.w = fmaf(pr, x.w * sc, a.w);
  }
  return a;
}

__device__ __forceinline__ float4 scale_add(float4 a, float c, float4 b) {
  return make_float4(a.x * c + b.x, a.y * c + b.y, a.z * c + b.z, a.w * c + b.w);
}

size_t smem_bytes(int G, int hd) {
  const int W = hd / 4;
  return sizeof(float) * (static_cast<size_t>(G) * hd + 4 * kThreads + G * kTile + kTile + 3 * kMaxG)
       + sizeof(uint32_t) * static_cast<size_t>(kTile) * (2 * W + 1);
}

template <int VB>
__global__ void __launch_bounds__(kThreads)
kv_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ k8,
                 const int8_t* __restrict__ v8, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ kpos,
                 const int* __restrict__ cur, float* __restrict__ out,
                 int H, int K, int S, int hd, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / K;
  const int W = hd / 4;    // words of int8 codes per K/V row
  const int KW = W + 1;    // padded K row: a thread per row reads without bank conflicts
  const int U = G * W;     // output words of the block
  const int nsplit = U >= kThreads ? 1 : kThreads / U;  // slot groups in P @ V
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x - b * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* q_s = reinterpret_cast<float*>(smem);                 // (G, hd)
  float4* part_s = reinterpret_cast<float4*>(q_s + G * hd);    // (kThreads,) P @ V partials
  float* p_s = reinterpret_cast<float*>(part_s + kThreads);    // (G, kTile) scores, then p
  float* vs_s = p_s + G * kTile;                               // (kTile,) V scales
  float* m_s = vs_s + kTile;                                   // running max per row
  float* l_s = m_s + kMaxG;                                    // running sum per row
  float* c_s = l_s + kMaxG;                                    // this tile's correction
  uint32_t* k_s = reinterpret_cast<uint32_t*>(c_s + kMaxG);    // (kTile, KW)
  uint32_t* v_s = k_s + kTile * KW;                            // (kTile, W)

  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G;
  const float* qb = q + head0 * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = qb[i];
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const size_t slot_bytes = static_cast<size_t>(K) * hd;  // one slot to the next
  const size_t base = static_cast<size_t>(b) * S * K + kh;
  const int8_t* kb = k8 + base * hd;
  const int8_t* vb = v8 + base * hd;
  const float* ksb = ks + base;
  const float* vsb = vs + base;
  const int* kpb = kpos + static_cast<size_t>(b) * S;
  const int c = cur[b];
  const float rsd = sqrtf(static_cast<float>(hd));

  float4 acc[kMaxUnits];
#pragma unroll
  for (int i = 0; i < kMaxUnits; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int urow = hd / VB;  // load units per K/V row

  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int n = min(kTile, S - s0);  // real slots of this tile
    __syncthreads();  // the previous tile's readers are done
    Stage<VB> st;
    for (int j0 = 0; j0 * kThreads < n * urow; j0 += Stage<VB>::kPre) {
      st.load(kb, vb, ksb, vsb, kpb, K, slot_bytes, s0, n, urow, j0, tid);
      st.store(k_s, v_s, W, KW, n, urow, j0, tid);
    }
    bool valid = false;
    float kscale = 0.f;
    if (tid < n) {
      valid = st.kp >= 0 && st.kp <= c && (window < 0 || c - st.kp < window);
      kscale = st.ks;
      vs_s[tid] = st.vs;
    }
    __syncthreads();

    // scores of this thread's slot against the G query rows (two FMA
    // chains per row, summed at the end)
    if (tid < n) {
      const uint32_t* krow = k_s + tid * KW;
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * hd;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
        for (int w = 0; w < W; ++w) {
          const float4 kf = unpack(krow[w]);
          const float4 qv = *reinterpret_cast<const float4*>(qg + 4 * w);
          a0 = fmaf(qv.x, kf.x, a0);
          a1 = fmaf(qv.y, kf.y, a1);
          a0 = fmaf(qv.z, kf.z, a0);
          a1 = fmaf(qv.w, kf.w, a1);
        }
        p_s[g * kTile + tid] = valid ? (a0 + a1) * kscale / rsd : kMask;
      }
    }
    __syncthreads();

    // online softmax step: warp `warp` owns rows warp, warp + kWarps, ...
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kTile;
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, row[r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float e = expf(row[r] - m_new);
        row[r] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ (v * vs)
    if (nsplit == 1) {
#pragma unroll
      for (int i = 0; i < kMaxUnits; ++i) {
        const int u = tid + i * kThreads;
        if (u < U) {
          const int g = u / W, w = u - g * W;
          acc[i] = scale_add(acc[i], c_s[g], pv_sum(p_s + g * kTile, v_s + w, W, vs_s, 0, n, 1));
        }
      }
    } else {
      const int u = tid % U, j = tid / U;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nsplit) {
        const int g = u / W, w = u - g * W;
        a = pv_sum(p_s + g * kTile, v_s + w, W, vs_s, j, n, nsplit);
      }
      part_s[tid] = a;
      __syncthreads();
      if (tid < U) {
        float4 sum = part_s[tid];
        for (int jj = 1; jj < nsplit; ++jj) {
          const float4 x = part_s[jj * U + tid];
          sum = make_float4(sum.x + x.x, sum.y + x.y, sum.z + x.z, sum.w + x.w);
        }
        acc[0] = scale_add(acc[0], c_s[tid / W], sum);
      }
    }
  }

  // out = acc / max(l, 1e-30); l_s was last written before the final P @ V
#pragma unroll
  for (int i = 0; i < kMaxUnits; ++i) {
    const int u = tid + i * kThreads;
    if (u < U) {
      const int g = u / W, w = u - g * W;
      const float den = fmaxf(l_s[g], 1e-30f);
      *reinterpret_cast<float4*>(out + (head0 + g) * hd + 4 * w) =
          make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den, acc[i].w / den);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch
// was accepted. vb: the body's load unit, 16 bytes (hd % 16 == 0, codes
// 16-byte aligned) or 8 (hd % 8 == 0, codes 8-byte aligned).
int kv_decode_launch(const void* q, const void* k8, const void* v8, const void* ks,
                     const void* vs, const void* kpos, const void* cur, void* out,
                     int B, int H, int K, int S, int hd, int window, int vb, void* stream) {
  if (B < 1 || K < 1 || S < 1 || H % K != 0 || H / K > kMaxG || hd < 16 || hd > kMaxHd ||
      (vb != 16 && vb != 8) || hd % vb != 0 || reinterpret_cast<uintptr_t>(k8) % vb != 0 ||
      reinterpret_cast<uintptr_t>(v8) % vb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(H / K, hd);
  auto kern = vb == 16 ? &kv_decode_kernel<16> : &kv_decode_kernel<8>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<B * K, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kpos),
      static_cast<const int*>(cur), static_cast<float*>(out), H, K, S, hd, window);
  return static_cast<int>(cudaGetLastError());
}

const char* kvattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
