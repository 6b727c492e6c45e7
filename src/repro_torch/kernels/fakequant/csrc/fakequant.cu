// Fused AdaRound forward for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/fakequant/kernel.py::fakequant (entry :38, body
// _fq_kernel :24).
//
// Operands (row-major, contiguous, f32):
//   w, v   (K, N)          weights and AdaRound rounding logits
//   s      (1, N) or (K, N) per-output-channel scales, or one per weight
//   out    (K, N)          clip(floor(w / s) + h, qmin, qmax) * s
// with h = (v >= 0) when `hard`, else clip(sigmoid(v) * 1.2 - 0.1, 0, 1)
// (the rectified sigmoid, zeta = 1.1, gamma = -0.1).
//
// What bounds it: bytes. Per weight it reads w and v (8 bytes) and writes
// out (4 bytes); the scale row is N * 4 bytes per call (K * N * 4 for a
// per-weight scale) and stays in L2. It does a few f32 operations per 12
// bytes, far below the card's ~20 operations per byte of device memory.
// The design is the TPU kernel's fusion (one read of w and v, one write of
// out, no temporaries) as a grid-stride loop: 16-byte vector loads and
// stores where N % 4 == 0 and every pointer is 16-byte aligned (four
// neighbouring weights of one row share one float4 of the scale row),
// scalar accesses otherwise. Every index is checked against K * N, so any
// K and N work.
//
// Arithmetic: w / s is the IEEE quotient (__fdiv_rn, whatever the flags),
// so the hardened forward is bit-identical to the plain formula and to
// PyTorch's division on the card; export recovers the integer codes from
// those baked weights. The soft path keeps PyTorch's separate multiply and
// add (__fmul_rn / __fadd_rn: no FMA contraction) and expf, not __expf.
// The clip propagates NaN, as torch.clamp and jnp.clip do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // NaN falls through
}

template <bool kHard>
__device__ __forceinline__ float fq(float w, float v, float s, float qmin, float qmax) {
  float h;
  if (kHard) {
    h = v >= 0.0f ? 1.0f : 0.0f;
  } else {
    const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
    h = clip(__fadd_rn(__fmul_rn(sig, 1.2f), -0.1f), 0.0f, 1.0f);
  }
  const float q = clip(__fadd_rn(floorf(__fdiv_rn(w, s)), h), qmin, qmax);
  return __fmul_rn(q, s);
}

template <bool kHard, bool kRowScale>
__global__ void __launch_bounds__(kThreads)
fq_vec4_kernel(const float4* __restrict__ w, const float4* __restrict__ v,
               const float4* __restrict__ s, float4* __restrict__ out, long long n4,
               int n4_row, float qmin, float qmax) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = w[i];
    const float4 b = v[i];
    const float4 c = kRowScale ? s[i % n4_row] : s[i];
    out[i] = make_float4(fq<kHard>(a.x, b.x, c.x, qmin, qmax),
                         fq<kHard>(a.y, b.y, c.y, qmin, qmax),
                         fq<kHard>(a.z, b.z, c.z, qmin, qmax),
                         fq<kHard>(a.w, b.w, c.w, qmin, qmax));
  }
}

template <bool kHard, bool kRowScale>
__global__ void __launch_bounds__(kThreads)
fq_scalar_kernel(const float* __restrict__ w, const float* __restrict__ v,
                 const float* __restrict__ s, float* __restrict__ out, long long n, int N,
                 float qmin, float qmax) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    out[i] = fq<kHard>(w[i], v[i], kRowScale ? s[i % N] : s[i], qmin, qmax);
  }
}

template <bool kHard, bool kRowScale>
void launch(const void* w, const void* v, const void* s, void* out, long long n, int N,
            float qmin, float qmax, bool vec, cudaStream_t stream) {
  const long long items = vec ? n / 4 : n;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  if (vec) {
    fq_vec4_kernel<kHard, kRowScale><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float4*>(w), static_cast<const float4*>(v),
        static_cast<const float4*>(s), static_cast<float4*>(out), items, N / 4, qmin, qmax);
  } else {
    fq_scalar_kernel<kHard, kRowScale><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(w), static_cast<const float*>(v),
        static_cast<const float*>(s), static_cast<float*>(out), n, N, qmin, qmax);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch
// was accepted. `s_rows` is 1 (one scale per column) or K (one per weight).
int fakequant_launch(const void* w, const void* v, const void* s, void* out, int K, int N,
                     int s_rows, int qmin, int qmax, int hard, void* stream) {
  if (K < 1 || N < 1 || (s_rows != 1 && s_rows != K) || qmin > qmax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(K) * N;
  const bool row = s_rows == 1 && K > 1;
  const bool vec = N % 4 == 0 && aligned16(w) && aligned16(v) && aligned16(s) && aligned16(out);
  const float lo = static_cast<float>(qmin), hi = static_cast<float>(qmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hard) {
    if (row) launch<true, true>(w, v, s, out, n, N, lo, hi, vec, st);
    else launch<true, false>(w, v, s, out, n, N, lo, hi, vec, st);
  } else {
    if (row) launch<false, true>(w, v, s, out, n, N, lo, hi, vec, st);
    else launch<false, false>(w, v, s, out, n, N, lo, hi, vec, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fakequant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
