// Decode attention over an int8 KV cache for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/kvattn/kernel.py::kv_decode (entry :70, body :31).
//
// Two entries, one body. Dense (kv_decode_launch), row-major and contiguous:
//   q       (B, H, hd)     f32 queries of one decode step
//   k8, v8  (B, S, K, hd)  int8 cache codes
//   ks, vs  (B, S, K)      f32 per-(slot, kv-head) scales
//   kpos    (B, S)         i32 position held by each slot, -1 = empty
//   cur     (B,)           i32 position of the query
//   out     (B, H, hd)     f32
// Paged (kv_decode_paged_launch) reads the serve engine's pool as it is
// stored: codes (num_pages, page_size, K, hd) int8, scales (num_pages,
// page_size, K) f16, block tables (B, max_pages) i32. Slot t of stream b
// lives on page bt[b, t / page_size] (an unallocated page, -1, reads page 0),
// and its kpos is t where that page is allocated, -1 elsewhere: the dense
// view the engine would gather (kvattn/ref.py::paged_view), S = max_pages
// * page_size, without the gather. f16 scales widen exactly (__half2float),
// so the paged entry equals the dense one on the gathered view bit for bit.
// Head h reads kv head h / G, G = H / K query rows per kv head (GQA, MQA and
// MHA alike). `window` < 0 means no sliding window.
//
// What bounds it: bytes. The kernel does 4*B*H*S*hd f32 operations on
// 2*B*S*K*hd bytes of int8 codes (plus 8 bytes of scales per slot and kv
// head), that is 2*G operations per byte read, against the card's ~20 f32
// operations per byte of device memory: bound by bytes up to G = 10, which
// covers the serve engine (G = 1) and GQA at TinyLlama's width (G = 8). Each
// K/V byte is read once for the query rows a block keeps (all G up to 1,024
// values of q: a kv head with more takes ceil(G / rows) blocks).
//
// One block per (batch, kv-head) with register-staged tiles and four
// barriers a tile leaves most of the card idle and every load exposed. The
// design (spec.plan_kv_decode picks every choice from the shapes):
// - S splits over a thread-block cluster of `split` blocks (flash-decoding),
//   each over a contiguous share of whole tiles (never an empty one), and
//   within a block over its `warps` warps, each over a contiguous share of
//   the block's tiles. A warp runs the f32 online softmax over its tiles on
//   its own: no barrier inside the loop. Warps meet once in shared memory,
//   merged in warp order; blocks meet through distributed shared memory,
//   each block reading every block's (m, l, acc) in rank order: m* = max m_i,
//   l = sum l_i exp(m_i - m*), acc = sum acc_i exp(m_i - m*), out = acc /
//   max(l, 1e-30). No atomics, no second launch: the result is deterministic
//   and does not depend on other rows.
// - Each warp streams its tiles of 32 slots through its own cp.async ring of
//   kStages tiles: K rows (padded by 16 bytes in the 16-byte body, so the
//   lanes that each read their own row meet no bank conflict), V rows, the
//   scales, the dense kpos, and on the paged path the page numbers of the
//   tile kStages - 1 ahead of the copies that need them. Tile i + 1 is in
//   flight while tile i is scored and accumulated (a deeper ring was not
//   faster on the card: it costs shared memory, so fewer blocks fit an SM).
// - Per tile: a lane scores its slot against the rows of q (resident in
//   shared memory); masked scores are -1e30 (the TPU kernel's MASK); the max
//   (a warp reduction on ordered integers) and the sum (xor shuffles, so every lane
//   holds the same bits) take the online-softmax step (m starts at -inf, so a
//   fully masked tile adds weight 1 per slot that a later valid tile wipes out
//   through corr = 0, and a row with no valid slot returns the mean of V over
//   S, as the plain softmax does; a share's m is at least -1e30, so no merge
//   meets inf - inf); then lanes own output words and sum p * (v * vs) over a
//   fixed subset of the tile's slots, carrying their partials across tiles,
//   summed in a fixed order at the end. Slots past S in the last tile are
//   left out of every sum, so they are not masked slots.
// - int8 codes widen by a byte permute into 2^23 + 128 + code and one
//   subtraction (exact), in place of the quarter-rate int-to-float unit.
// Two bodies, by the head dim (spec.kv_decode_body): 16-byte copies for hd %
// 16 == 0 (codes 16-byte aligned), 8-byte copies for the other multiples of 8
// (hd 120 of h2o-danube3-4b; 8-byte aligned). Each keeps 1, 2, 4 or 8 float4
// accumulators a lane (`units`, from rows * hd), so the common shapes keep few
// registers.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

// Diagnostic cuts: scripts/kv_decode_breakdown.py builds this source with
// -DKV_CUT=n to time the body with one part taken out (1: the copies and
// waits only, no scores and no P @ V; 2: no merge and no output; 3: no
// tile, only the launch, the first copies, q and the merge; 4: return at
// once). The port builds it with KV_CUT 0, where every cut folds away.
#ifndef KV_CUT
#define KV_CUT 0
#endif

namespace {

constexpr int kTile = 32;        // slots of a warp's tile: a lane each
constexpr int kStages = 2;       // spec.KV_STAGES: tiles of a warp's cp.async ring
// Bytes after each K row in the ring: with 16-byte loads a row of hd % 32
// == 0 bytes would put the rows a quarter-warp reads on the same banks; the
// 8-byte body's rows (hd / 8 odd) already fall on distinct banks.
__host__ __device__ constexpr int k_pad(int vb) { return vb == 16 ? 16 : 0; }
constexpr int kMaxWarps = 8;     // spec.KV_WARPS[-1]
constexpr int kMaxG = 16;        // spec.KV_G_MAX
constexpr int kMaxHd = 256;      // spec.KV_HD_MAX
constexpr int kMaxValues = 1024; // spec.KV_BLOCK_VALUES: rows * hd a block keeps
constexpr int kMaxSplit = 8;     // spec.KV_SPLITS[-1]: a portable cluster
constexpr float kMask = -1e30f;  // the TPU kernel's MASK
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* q;
  const int8_t* k;      // codes: (B, S, K, hd) dense, (pages, page_size, K, hd) paged
  const int8_t* v;
  const void* ks;       // scales: f32 (B, S, K) dense, f16 (pages, page_size, K) paged
  const void* vs;
  const int* pos;       // dense: kpos (B, S); paged: block tables (B, max_pages)
  const int* cur;
  float* out;
  int H, K, S, hd, window;
  int warps, split;     // the plan: warps a block, blocks a cluster
  int rows, chunks;     // query rows a block keeps, blocks over one kv head's rows
  int page_size, max_pages;
  long long scale_count;  // paged: elements of a scale pool
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared memory of one block, in bytes from the start; mirrored by
// spec.kv_smem. q rows (later the block's accumulator for the cluster), the
// block's m and l per row, then a region per warp: its p * vs (rows, kTile),
// its m, l and corr per row, its page numbers (paged) and its ring, whose
// stage holds a tile's K rows (hd + k_pad bytes apart), V rows (hd apart), K
// and V scales (a 32-bit word a slot: f32, or the aligned word holding the
// f16) and, dense, kpos. After its last tile a warp's ring holds 32 float4 partials and its
// accumulator (rows * hd f32).
struct Layout {
  int krow;  // bytes from one K row to the next
  int k_off, v_off, ks_off, vs_off, kp_off, stage;  // within a ring stage
  int page_entries, page_slots;
  int pw_off, stat_off, page_off, ring_off, warp;   // within a warp's region
  int q_off, bstat_off, warp0, total;
};

__host__ __device__ inline Layout make_layout(int rows, int hd, int vb, int warps,
                                              int page_size) {
  Layout L;
  L.krow = hd + k_pad(vb);
  L.k_off = 0;
  L.v_off = L.k_off + kTile * L.krow;
  L.ks_off = L.v_off + kTile * hd;
  L.vs_off = L.ks_off + kTile * 4;
  L.kp_off = L.vs_off + kTile * 4;
  L.stage = L.kp_off + (page_size > 0 ? 0 : kTile * 4);
  L.page_entries = page_size > 0 ? (kTile - 1) / page_size + 2 : 0;
  L.page_slots = page_size > 0 ? 2 * (kStages - 1) + 1 : 0;
  L.pw_off = 0;
  L.stat_off = L.pw_off + rows * kTile * 4;
  L.page_off = L.stat_off + 3 * kMaxG * 4;
  L.ring_off = L.page_off + align16(L.page_slots * L.page_entries * 4);
  const int ring = kStages * L.stage, after = 32 * 16 + rows * hd * 4;
  L.warp = L.ring_off + align16(ring > after ? ring : after);
  L.q_off = 0;
  L.bstat_off = align16(rows * hd * 4);
  L.warp0 = L.bstat_off + 2 * kMaxG * 4;
  L.total = L.warp0 + warps * L.warp;
  return L;
}

// Four int8 codes packed in one little-endian word, widened exactly: the
// biased byte (code + 128) becomes the low mantissa byte of 2^23.
__device__ __forceinline__ float4 unpack(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias);
}

// The warp's max of x, every lane the same: a redux over integers ordered
// as the floats are.
__device__ __forceinline__ float warp_max(float x) {
  const int b = __float_as_int(x);
  const int key = __reduce_max_sync(kFull, b ^ ((b >> 31) & 0x7fffffff));
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// The load unit of VB bytes.
template <int VB>
using unit_t = typename std::conditional<VB == 16, uint4, uint2>::type;

// a0, a1 += q . k over one load unit of codes (two FMA chains).
__device__ __forceinline__ void dot_unit(const float* qg, uint4 x, float& a0, float& a1) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 kf = unpack(w[i]);
    const float4 qv = *reinterpret_cast<const float4*>(qg + 4 * i);
    a0 = fmaf(qv.x, kf.x, a0);
    a1 = fmaf(qv.y, kf.y, a1);
    a0 = fmaf(qv.z, kf.z, a0);
    a1 = fmaf(qv.w, kf.w, a1);
  }
}

__device__ __forceinline__ void dot_unit(const float* qg, uint2 x, float& a0, float& a1) {
  const uint32_t w[2] = {x.x, x.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 kf = unpack(w[i]);
    const float4 qv = *reinterpret_cast<const float4*>(qg + 4 * i);
    a0 = fmaf(qv.x, kf.x, a0);
    a1 = fmaf(qv.y, kf.y, a1);
    a0 = fmaf(qv.z, kf.z, a0);
    a1 = fmaf(qv.w, kf.w, a1);
  }
}

// sum over slots r = r0, r0 + step, ... < n of pw[r] * v[r] for one word
// (4 values) of a V row; pw = p * vs; v points at that word of row 0.
__device__ __forceinline__ float4 pv_sum(const float* pw, const uint32_t* v, int W, int r0,
                                         int n, int step) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int r = r0; r < n; r += step) {
    const float pr = pw[r];
    const float4 x = unpack(v[r * W]);
    a.x = fmaf(pr, x.x, a.x);
    a.y = fmaf(pr, x.y, a.y);
    a.z = fmaf(pr, x.z, a.z);
    a.w = fmaf(pr, x.w, a.w);
  }
  return a;
}

__device__ __forceinline__ float4 scale_add(float4 a, float c, float4 b) {
  return make_float4(a.x * c + b.x, a.y * c + b.y, a.z * c + b.z, a.w * c + b.w);
}

__device__ __forceinline__ float4 fma4(float4 x, float c, float4 a) {
  return make_float4(fmaf(x.x, c, a.x), fmaf(x.y, c, a.y), fmaf(x.z, c, a.z), fmaf(x.w, c, a.w));
}

template <int VB, bool PAGED, int MU>
__global__ void __launch_bounds__(32 * kMaxWarps) kv_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (KV_CUT == 4 && a.window > -1000) return;
  const int hd = a.hd, W = hd / 4, K = a.K, G = a.H / K;
  const int NW = a.warps;
  const Layout L = make_layout(a.rows, hd, VB, NW, PAGED ? a.page_size : 0);
  // split and warps are powers of two: their divisions are shifts
  const int split = a.split, ls = __ffs(split) - 1, lw = __ffs(NW) - 1;
  const int cl = blockIdx.x >> ls;             // (batch, kv-head, row chunk)
  const int rank = blockIdx.x & (split - 1);   // the block's rank in its cluster
  const int pair = a.chunks == 1 ? cl : cl / a.chunks;  // (batch, kv-head)
  const int g0 = (cl - pair * a.chunks) * a.rows;
  const int R = min(a.rows, G - g0);           // query rows of this block
  const int U = R * W;                         // output words of the block
  const int b = pair / K, kh = pair - b * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* q_s = reinterpret_cast<float*>(smem + L.q_off);
  float* bm_s = reinterpret_cast<float*>(smem + L.bstat_off);  // the block's m, l per row
  float* bl_s = bm_s + kMaxG;
  unsigned char* wreg = smem + L.warp0 + warp * L.warp;
  float* pw_s = reinterpret_cast<float*>(wreg + L.pw_off);
  float* m_s = reinterpret_cast<float*>(wreg + L.stat_off);
  float* l_s = m_s + kMaxG;
  float* c_s = l_s + kMaxG;
  int* pg_s = reinterpret_cast<int*>(wreg + L.page_off);
  unsigned char* ring = wreg + L.ring_off;

  // The cluster's share of tiles, then the warp's within it.
  const int nt = (a.S + kTile - 1) / kTile;
  const int bt0 = (rank * nt) >> ls, bnt = (((rank + 1) * nt) >> ls) - bt0;  // at least one
  auto warp_tiles = [&](int w) { return (((w + 1) * bnt) >> lw) - ((w * bnt) >> lw); };
  const int t0 = bt0 + ((warp * bnt) >> lw), my_nt = warp_tiles(warp);
  constexpr int ahead = kStages - 1;
  const int PS = a.page_size;
  const int* bt = a.pos + static_cast<size_t>(b) * a.max_pages;  // paged: this stream's table

  // First page and page count of local tile j; its page numbers' slot.
  auto first_page = [&](int j) { return (t0 + j) * kTile / PS; };
  auto page_count = [&](int j) {
    const int s0 = (t0 + j) * kTile;
    return (s0 + min(kTile, a.S - s0) - 1) / PS + 1 - s0 / PS;
  };
  auto page_list = [&](int j) { return pg_s + (j % L.page_slots) * L.page_entries; };
  // The page number (-1: unallocated) of the lane's slot of local tile j,
  // and the slot's row in the codes' (rows, K, hd) and the scales' (rows, K)
  // views: b * S + t dense, max(page, 0) * page_size + t % page_size paged.
  // Where the page size divides the tile, the lane's page entry and offset
  // are the same in every tile.
  const bool fast = PAGED && kTile % PS == 0;
  const int lane_e = fast ? lane / PS : 0, lane_o = fast ? lane - lane_e * PS : 0;
  auto lane_page = [&](int j) -> int {
    const int s0 = (t0 + j) * kTile;
    if (fast) return page_list(j)[lane_e];
    return page_list(j)[(s0 + lane) / PS - s0 / PS];
  };
  auto lane_row = [&](int j, int page) -> int {
    const int t = (t0 + j) * kTile + lane;
    if (!PAGED) return b * a.S + t;
    return max(page, 0) * PS + (fast ? lane_o : t % PS);
  };

  const int C = hd / VB;  // load units of a row; a lane's first unit of a tile and its stride
  const int r_first = lane / C, u_first = lane - r_first * C;
  const int dr = 32 / C, du = 32 - dr * C;

  auto issue_pages = [&](int j) {  // cp.async the page numbers of local tile j
    if (!PAGED || j >= my_nt) return;
    const int p0 = first_page(j), np = page_count(j);
    int* dst = page_list(j);
    for (int e = lane; e < np; e += 32) __pipeline_memcpy_async(dst + e, bt + p0 + e, 4);
  };
  auto issue_tile = [&](int j) {  // cp.async local tile j into its ring stage
    if (j >= my_nt) return;
    const int s0 = (t0 + j) * kTile;
    const int n = min(kTile, a.S - s0);
    unsigned char* st = ring + (j % kStages) * L.stage;
    const int row = lane < n ? lane_row(j, PAGED ? lane_page(j) : 0) : 0;
    int r = r_first, u = u_first;
    for (int i = 0; i < C; ++i) {  // 32 units a step, a row's on neighbouring lanes
      const int rr = __shfl_sync(kFull, row, r & 31);
      if (r < n) {
        const size_t off = (static_cast<size_t>(rr) * K + kh) * hd + u * VB;
        __pipeline_memcpy_async(st + L.k_off + r * L.krow + u * VB, a.k + off, VB);
        __pipeline_memcpy_async(st + L.v_off + r * hd + u * VB, a.v + off, VB);
      }
      r += dr;
      u += du;
      if (u >= C) {
        u -= C;
        ++r;
      }
    }
    if (lane < n) {
      const size_t si = static_cast<size_t>(row) * K + kh;
      if (!PAGED) {
        __pipeline_memcpy_async(st + L.ks_off + 4 * lane, static_cast<const float*>(a.ks) + si, 4);
        __pipeline_memcpy_async(st + L.vs_off + 4 * lane, static_cast<const float*>(a.vs) + si, 4);
        __pipeline_memcpy_async(st + L.kp_off + 4 * lane, a.pos + row, 4);
      } else if (static_cast<long long>(si | 1) < a.scale_count) {
        // the aligned 32-bit word that holds the f16 (the wrapper aligns the pools)
        const size_t w = si & ~static_cast<size_t>(1);
        __pipeline_memcpy_async(st + L.ks_off + 4 * lane, static_cast<const __half*>(a.ks) + w, 4);
        __pipeline_memcpy_async(st + L.vs_off + 4 * lane, static_cast<const __half*>(a.vs) + w, 4);
      } else {  // the pool's last f16 at an even index: its word would run past the pool
        reinterpret_cast<__half*>(st + L.ks_off)[2 * lane] = static_cast<const __half*>(a.ks)[si];
        reinterpret_cast<__half*>(st + L.vs_off)[2 * lane] = static_cast<const __half*>(a.vs)[si];
      }
    }
  };

  // Prologue: the warp's first tiles' page numbers (paged), then `ahead`
  // tiles in flight, then q and the running statistics while they land.
  if (PAGED) {
    for (int j = 0; j < min(ahead, my_nt); ++j) {
      const int p0 = first_page(j), np = page_count(j);
      for (int e = lane; e < np; e += 32) page_list(j)[e] = bt[p0 + e];
    }
    __syncwarp();
  }
  for (int j = 0; j < ahead; ++j) {
    issue_tile(j);
    issue_pages(j + ahead);
    __pipeline_commit();
  }
  const size_t head0 = static_cast<size_t>(b) * a.H + static_cast<size_t>(kh) * G + g0;
  const float* qb = a.q + head0 * hd;
  for (int i = tid; i < R * hd; i += 32 * NW) q_s[i] = __ldg(qb + i);
  if (lane < R) {
    m_s[lane] = -INFINITY;
    l_s[lane] = 0.f;
  }
  const int c = __ldg(a.cur + b);
  const float rsd = sqrtf(static_cast<float>(hd));
  const int nsplit = U >= 32 ? 1 : 32 / U;  // slot groups of a word in P @ V
  __syncthreads();  // q is in

  float4 acc[MU];
  int pv_g[MU], pv_w[MU];  // the row and word of each output word the lane owns (-1: none)
#pragma unroll
  for (int i = 0; i < MU; ++i) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int u = nsplit == 1 ? lane + 32 * i : (i == 0 ? lane % U : U);
    pv_g[i] = u < U ? u / W : -1;
    pv_w[i] = u < U ? u - pv_g[i] * W : 0;
  }

  for (int j = 0; j < my_nt && !(KV_CUT == 3 && a.window > -1000); ++j) {
    __pipeline_wait_prior(ahead - 1);  // this lane's copies of tile j landed
    __syncwarp();  // the warp's did; tile j - 1's readers are done
    issue_tile(j + ahead);
    issue_pages(j + 2 * ahead);
    __pipeline_commit();
    if (KV_CUT == 1 && a.window > -1000) continue;

    const int s0 = (t0 + j) * kTile;
    const int n = min(kTile, a.S - s0);
    const unsigned char* st = ring + (j % kStages) * L.stage;

    // the lane's slot: its kpos and scales
    const int t = s0 + lane;
    int kp = -1;
    float kscale = 0.f, vscale = 0.f;
    if (lane < n) {
      if (!PAGED) {
        kp = reinterpret_cast<const int*>(st + L.kp_off)[lane];
        kscale = reinterpret_cast<const float*>(st + L.ks_off)[lane];
        vscale = reinterpret_cast<const float*>(st + L.vs_off)[lane];
      } else {
        const int page = lane_page(j);
        kp = page >= 0 ? t : -1;
        const int half = static_cast<int>((static_cast<size_t>(lane_row(j, page)) * K + kh) & 1);
        kscale = __half2float(reinterpret_cast<const __half*>(st + L.ks_off)[2 * lane + half]);
        vscale = __half2float(reinterpret_cast<const __half*>(st + L.vs_off)[2 * lane + half]);
      }
    }
    const bool valid = kp >= 0 && kp <= c && (a.window < 0 || c - kp < a.window);
    const unsigned char* krow = st + L.k_off + lane * L.krow;

    // per query row: the lane's score (two FMA chains), then the online-
    // softmax step over the tile's slots; every lane holds the same m, l and
    // corr, so every lane writes them
    for (int g = 0; g < R; ++g) {
      const float m_old = m_s[g], l_old = l_s[g];
      float sc = -INFINITY;  // slots past S take no part
      if (lane < n) {
        const float* qg = q_s + g * hd;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
        for (int u = 0; u < C; ++u) {
          dot_unit(qg + u * VB, *reinterpret_cast<const unit_t<VB>*>(krow + u * VB), a0, a1);
        }
        sc = valid ? (a0 + a1) * kscale / rsd : kMask;
      }
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float e = lane < n ? expf(sc - m_new) : 0.f;
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      const float corr = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
      pw_s[g * kTile + lane] = e * vscale;
      __syncwarp();  // every lane has read the old statistics
      c_s[g] = corr;
      l_s[g] = l_old * corr + sum;
      m_s[g] = m_new;
    }
    __syncwarp();

    // acc = acc * corr + (p * vs) @ v over this lane's slots
    const uint32_t* v_s = reinterpret_cast<const uint32_t*>(st + L.v_off);
    if (nsplit == 1) {
#pragma unroll
      for (int i = 0; i < MU; ++i) {
        if (pv_g[i] >= 0) {
          acc[i] = scale_add(acc[i], c_s[pv_g[i]],
                             pv_sum(pw_s + pv_g[i] * kTile, v_s + pv_w[i], W, 0, n, 1));
        }
      }
    } else if (lane / U < nsplit) {
      acc[0] = scale_add(acc[0], c_s[pv_g[0]],
                         pv_sum(pw_s + pv_g[0] * kTile, v_s + pv_w[0], W, lane / U, n, nsplit));
    }
  }
  __pipeline_wait_prior(0);  // only empty groups are left
  if (KV_CUT == 2 && a.window > -1000) return;
  __syncwarp();

  // The warp's accumulator, in its ring: slot groups summed in group order.
  float4* red_w = reinterpret_cast<float4*>(ring);
  float4* acc_w = red_w + 32;
  if (my_nt > 0) {
    if (nsplit > 1) {
      red_w[lane] = acc[0];
      __syncwarp();
      if (lane < U) {
        float4 sum = red_w[lane];
        for (int jj = 1; jj < nsplit; ++jj) {
          const float4 x = red_w[jj * U + lane];
          sum = make_float4(sum.x + x.x, sum.y + x.y, sum.z + x.z, sum.w + x.w);
        }
        acc_w[lane] = sum;
      }
    } else {
#pragma unroll
      for (int i = 0; i < MU; ++i) {
        const int u = lane + 32 * i;
        if (u < U) acc_w[u] = acc[i];
      }
    }
  }
  __syncthreads();  // every warp's (m, l, acc) is ready; q is dead

  // The block's (m, l, acc): its warps that had tiles, merged in warp order.
  auto wbase = [&](int w) { return smem + L.warp0 + w * L.warp; };
  float* bacc_s = q_s;
  for (int u = tid; u < U; u += 32 * NW) {
    const int g = u / W, w = u - g * W;
    float mstar = -INFINITY;
    for (int v = 0; v < NW; ++v) {
      if (warp_tiles(v) > 0) {
        mstar = fmaxf(mstar, reinterpret_cast<const float*>(wbase(v) + L.stat_off)[g]);
      }
    }
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int v = 0; v < NW; ++v) {
      if (warp_tiles(v) == 0) continue;
      const float* st = reinterpret_cast<const float*>(wbase(v) + L.stat_off);
      const float wt = expf(st[g] - mstar);
      l = fmaf(st[kMaxG + g], wt, l);
      o = fma4(reinterpret_cast<const float4*>(wbase(v) + L.ring_off)[32 + u], wt, o);
    }
    if (split == 1) {  // out = acc / max(l, 1e-30)
      const float den = fmaxf(l, 1e-30f);
      *reinterpret_cast<float4*>(a.out + (head0 + g) * hd + 4 * w) =
          make_float4(o.x / den, o.y / den, o.z / den, o.w / den);
    } else {
      reinterpret_cast<float4*>(bacc_s)[u] = o;
      if (w == 0) {
        bm_s[g] = mstar;
        bl_s[g] = l;
      }
    }
  }
  if (split == 1) return;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's (m, l, acc) is ready
  // Word u of the output is combined by rank u % split, over ranks in order.
  for (int u = tid * split + rank; u < U; u += 32 * NW * split) {
    const int g = u / W, w = u - g * W;
    float mi[kMaxSplit];
    float mstar = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxSplit; ++i) {
      if (i < split) {
        mi[i] = cluster.map_shared_rank(bm_s, i)[g];
        mstar = fmaxf(mstar, mi[i]);
      }
    }
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kMaxSplit; ++i) {
      if (i < split) {
        const float wt = expf(mi[i] - mstar);
        l = fmaf(cluster.map_shared_rank(bl_s, i)[g], wt, l);
        o = fma4(reinterpret_cast<const float4*>(cluster.map_shared_rank(bacc_s, i))[u], wt, o);
      }
    }
    const float den = fmaxf(l, 1e-30f);
    *reinterpret_cast<float4*>(a.out + (head0 + g) * hd + 4 * w) =
        make_float4(o.x / den, o.y / den, o.z / den, o.w / den);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int VB, bool PAGED, int MU>
int launch_mu(const Args& a, int B, int smem, cudaStream_t st) {
  auto kern = &kv_decode_kernel<VB, PAGED, MU>;
  static int cap = 48 * 1024;  // per instance: dynamic shared memory above 48 KB
  if (smem > cap) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.K * a.chunks * a.split);
  cfg.blockDim = dim3(32 * a.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int VB, bool PAGED>
int launch(const Args& a, int B, int units, int smem, cudaStream_t st) {
  switch (units) {
    case 1: return launch_mu<VB, PAGED, 1>(a, B, smem, st);
    case 2: return launch_mu<VB, PAGED, 2>(a, B, smem, st);
    case 4: return launch_mu<VB, PAGED, 4>(a, B, smem, st);
    default: return launch_mu<VB, PAGED, 8>(a, B, smem, st);
  }
}

// The checks both entries share: shapes, the body's alignment, the plan.
bool plan_ok(const Args& a, int B, int vb, int units, int smem, int page_size) {
  if (B < 1 || a.K < 1 || a.S < 1 || a.H % a.K != 0 || a.H / a.K > kMaxG || a.hd < 16 ||
      a.hd > kMaxHd || (vb != 16 && vb != 8) || a.hd % vb != 0 ||
      reinterpret_cast<uintptr_t>(a.k) % vb != 0 || reinterpret_cast<uintptr_t>(a.v) % vb != 0) {
    return false;
  }
  const int G = a.H / a.K;
  if (a.warps < 1 || a.warps > kMaxWarps || (a.warps & (a.warps - 1)) != 0 ||
      (a.split != 1 && a.split != 2 && a.split != 4 && a.split != kMaxSplit) ||
      a.split > (a.S + kTile - 1) / kTile || a.rows < 1 ||
      a.rows * a.hd > kMaxValues || a.chunks != (G + a.rows - 1) / a.rows ||
      (units != 1 && units != 2 && units != 4 && units != 8) ||
      units * 128 < min(a.rows, G) * a.hd) {
    return false;
  }
  return smem == make_layout(a.rows, a.hd, vb, a.warps, page_size).total;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error: 0 when the launch was
// accepted. vb: the body's load unit, 16 bytes (hd % 16 == 0, codes 16-byte
// aligned) or 8 (hd % 8 == 0, codes 8-byte aligned). warps, split, rows,
// units: spec.plan_kv_decode's plan; smem: spec.kv_smem's bytes
// (the plan and the kernel agree, or nothing runs).
int kv_decode_launch(const void* q, const void* k8, const void* v8, const void* ks,
                     const void* vs, const void* kpos, const void* cur, void* out, int B, int H,
                     int K, int S, int hd, int window, int vb, int warps, int split,
                     int rows, int units, int smem, void* stream) {
  if (rows < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {static_cast<const float*>(q), static_cast<const int8_t*>(k8),
            static_cast<const int8_t*>(v8), ks, vs, static_cast<const int*>(kpos),
            static_cast<const int*>(cur), static_cast<float*>(out), H, K, S, hd, window,
            warps, split, rows, (H / K + rows - 1) / rows, 0, 0, 0};
  if (!plan_ok(a, B, vb, units, smem, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vb == 16 ? launch<16, false>(a, B, units, smem, st)
                  : launch<8, false>(a, B, units, smem, st);
}

// The paged entry: codes (num_pages, page_size, K, hd) int8, scales
// (num_pages, page_size, K) f16 (4-byte aligned), block tables (B,
// max_pages) i32 whose entries are -1 or a page below num_pages; S =
// max_pages * page_size.
int kv_decode_paged_launch(const void* q, const void* kp, const void* vp, const void* ks,
                           const void* vs, const void* bt, const void* cur, void* out, int B,
                           int H, int K, int num_pages, int page_size, int max_pages, int hd,
                           int window, int vb, int warps, int split, int rows, int units,
                           int smem, void* stream) {
  if (num_pages < 1 || page_size < 1 || max_pages < 1 || rows < 1 || K < 1 ||
      reinterpret_cast<uintptr_t>(ks) % 4 != 0 || reinterpret_cast<uintptr_t>(vs) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {static_cast<const float*>(q), static_cast<const int8_t*>(kp),
            static_cast<const int8_t*>(vp), ks, vs, static_cast<const int*>(bt),
            static_cast<const int*>(cur), static_cast<float*>(out), H, K,
            max_pages * page_size, hd, window, warps, split, rows,
            (H / K + rows - 1) / rows, page_size, max_pages,
            static_cast<long long>(num_pages) * page_size * K};
  if (!plan_ok(a, B, vb, units, smem, page_size)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vb == 16 ? launch<16, true>(a, B, units, smem, st)
                  : launch<8, true>(a, B, units, smem, st);
}

const char* kvattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
