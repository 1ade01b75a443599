// Hand-written Hopper (sm_90a) kernels of the PyTorch port's serving step.
//
// A plain C interface, compiled together with conv1x1_sm90.cu (the
// tensor-core 1x1 GEMM) and nms_sm90.cu (greedy NMS) by one nvcc call into
// one shared library and bound with ctypes (ops/_build.py). No PyTorch
// header is included. Every entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
//   zlt_conv1x1_bias_act  1x1 conv as a GEMM with a bias(+SiLU) epilogue on
//                         the CUDA cores: f32, and bf16 shapes the
//                         tensor-core kernel of conv1x1_sm90.cu does not take
//                         (replaces ops/conv1x1_pallas.py _mm_bias_silu_kernel
//                         and _mm_bias_kernel)
//   zlt_bias_silu         elementwise silu(y + b) over a flat NHWC buffer
//                         (replaces ops/act_pallas.py _bias_silu_kernel)
//
// dtype codes: 0 = float32, 1 = bfloat16. Arithmetic is f32 in registers;
// results are rounded once to the storage type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

// ---------------------------------------------------------------------------
// 1. 1x1 conv GEMM: out[m, n] = act(sum_k x[m, k] w[k, n] + b[n]), with w
// row-major (w[k * n + n']) or, for KMajor, K-major (w[n' * kdim + k]) as
// place_params lays it out. The layout is a template flag, not strides read
// at run time, so that each instance's address arithmetic stays what it
// would be with one layout only. 64x64 output tile per 256-thread block, 16-deep k-steps staged in shared
// memory as f32, a 4x4 register tile per thread, f32 accumulation, the bias
// and SiLU applied to the accumulator before the one store. Ragged M, N and
// K edges are masked.
// ---------------------------------------------------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kGemmThreads = 256;

template <typename T, bool KMajor>
__global__ void __launch_bounds__(kGemmThreads)
mm_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out, int m,
                   int kdim, int n, int act) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kGemmThreads; ++l) {
      const int idx = tid + kGemmThreads * l;
      const int r = idx / kBK, c = idx % kBK;
      const int gm = m0 + r, gk = k0 + c;
      as[c][r] = (gm < m && gk < kdim)
                     ? to_f32(x[static_cast<size_t>(gm) * kdim + gk])
                     : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kGemmThreads; ++l) {
      const int idx = tid + kGemmThreads * l;
      const int r = idx / kBN, c = idx % kBN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r][c] = (gk < kdim && gn < n)
                     ? to_f32(KMajor ? w[static_cast<size_t>(gn) * kdim + gk]
                                     : w[static_cast<size_t>(gk) * n + gn])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = bs[kk][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gn = n0 + tx + 16 * jj;
      if (gn >= n) continue;
      float z = acc[i][jj] + bias[gn];
      if (act) z = silu(z);
      out[static_cast<size_t>(gm) * n + gn] = from_f32<T>(z);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. Bias + SiLU over a flat NHWC buffer of n elements with c channels.
// Bound by bytes: one read and one write per element against a handful of
// f32 operations. At the HBM rate an SM must finish about 0.4 16-byte
// vectors a cycle, so the instructions spent on each vector may set the
// pace of a large map; a small map is set by the fixed cost of a launch.
//
// bias_silu_vec_kernel (c a multiple of the vector width kV, 16-byte
// aligned buffers): vector v of the buffer holds channels
// (v % (c / kV)) * kV .. + kV. Thread t takes vectors t, t + stride,
// t + 2 * stride, ..., where the host makes `stride` (the threads that work)
// a multiple of c / kV: so every vector of one thread has the same channel
// group, its kV biases are loaded into registers once, and no division is
// left in the loop. It starts kUnroll independent 16-byte loads before the
// math. Offsets are 32-bit (the wrapper refuses n >= 2^31). The host sizes
// the grid to one resident wave (zlt_bias_silu_wave_threads) or to the
// buffer, whichever is smaller. ops/act_cuda.py plan_bias_silu computes
// the stride, and the CPU tests model this mapping in NumPy.
//
// Instructions executed per bf16 vector (8 elements) on the common path,
// read from the SASS (cuobjdump -sass, sm_90a, CUDA 12.9): about 268 in the
// earlier kernel (a remainder per vector, 8 dependent bias loads, 8 expf
// and 8 IEEE divides), about 193 here (the 8 expf and 8 divides, the bf16
// unpack and pack, the address and the loop). Most of the 39 serving calls
// are small enough that a launch's fixed latency, not these instructions,
// sets their time (PERF.md gives the per-call split).
//
// bias_silu_kernel: the scalar grid-stride loop for any other c or
// alignment.
// ---------------------------------------------------------------------------
constexpr int kActThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kActThreads)
bias_silu_vec_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                     T* __restrict__ out, int nvec, int groups, int stride) {
  constexpr int kV = 16 / sizeof(T);
  const int t = blockIdx.x * kActThreads + threadIdx.x;
  if (t >= stride) return;
  float bv[kV];
  const int c0 = (t % groups) * kV;  // the thread's channel group, once
#pragma unroll
  for (int e = 0; e < kV; ++e) bv[e] = bias[c0 + e];
  const uint4* src = reinterpret_cast<const uint4*>(y);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (int v = t; v < nvec; v += kUnroll * stride) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * stride < nvec) raw[u] = src[v + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * stride >= nvec) break;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int q = 0; q < kV; ++q) r[q] = from_f32<T>(silu(to_f32(e[q]) + bv[q]));
      dst[v + u * stride] = res;
    }
  }
}

template <typename T>
__global__ void bias_silu_kernel(const T* __restrict__ y,
                                 const float* __restrict__ bias,
                                 T* __restrict__ out, int n, int c) {
  // Unsigned: i + stride stays below 2^32 for every n < 2^31.
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < unsigned(n);
       i += stride) {
    out[i] = from_f32<T>(silu(to_f32(y[i]) + bias[i % unsigned(c)]));
  }
}

template <typename T>
int launch_bias_silu(const void* y, const void* bias, void* out, int n, int c,
                     int vec, int stride, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (stride < 1) return cudaErrorInvalidValue;
  const int blocks = (stride + kActThreads - 1) / kActThreads;
  if (vec) {
    const int groups = c / kV;
    if (c % kV != 0 || stride % groups != 0 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return cudaErrorInvalidValue;
    bias_silu_vec_kernel<T><<<blocks, kActThreads, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const float*>(bias),
        static_cast<T*>(out), n / kV, groups, stride);
  } else {
    bias_silu_kernel<T><<<blocks, kActThreads, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const float*>(bias),
        static_cast<T*>(out), n, c);
  }
  return cudaGetLastError();
}

template <typename T>
void launch_mm(const void* x, const void* w, const void* bias, void* out,
               int m, int kdim, int n, int act, int w_kmajor,
               cudaStream_t stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  auto kernel = w_kmajor ? mm_bias_act_kernel<T, true>
                         : mm_bias_act_kernel<T, false>;
  kernel<<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), m, kdim, n, act);
}

}  // namespace

extern "C" {

const char* zlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w (kdim, n) row-major, or K-major where w_kmajor is 1.
int zlt_conv1x1_bias_act(const void* x, const void* w, const void* bias,
                         void* out, int m, int kdim, int n, int act, int dtype,
                         int w_kmajor, void* stream) {
  if (m < 0 || kdim < 1 || n < 1) return cudaErrorInvalidValue;
  if (m == 0) return cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_mm<float>(x, w, bias, out, m, kdim, n, act, w_kmajor, s);
  } else if (dtype == 1) {
    launch_mm<__nv_bfloat16>(x, w, bias, out, m, kdim, n, act, w_kmajor, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Threads of one resident wave of bias_silu_vec_kernel on the current
// device: blocks an SM holds at once x SMs x threads a block.
int zlt_bias_silu_wave_threads(int dtype) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const cudaError_t e =
      dtype == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, bias_silu_vec_kernel<float>, kActThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, bias_silu_vec_kernel<__nv_bfloat16>,
                       kActThreads, 0);
  return e == cudaSuccess ? per_sm * sms * kActThreads : -1;
}

// silu(y + bias) over n elements with c channels. vec = 1 takes the vector
// kernel with `stride` working threads (a multiple of c / vector width);
// vec = 0 the scalar loop on `stride` threads. Plan: ops/act_cuda.py.
int zlt_bias_silu(const void* y, const void* bias, void* out, int n, int c,
                  int dtype, int vec, int stride, void* stream) {
  if (n < 0 || c < 1 || n % c != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bias_silu<float>(y, bias, out, n, c, vec, stride, s);
  if (dtype == 1)
    return launch_bias_silu<__nv_bfloat16>(y, bias, out, n, c, vec, stride, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
