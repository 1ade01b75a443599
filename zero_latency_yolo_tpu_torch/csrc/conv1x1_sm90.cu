// 1x1 conv GEMM with a bias(+SiLU) epilogue on Hopper's tensor cores, bf16.
//
// Replaces the JAX package's TPU kernel ops/conv1x1_pallas.py:57,63
// (_mm_bias_silu_kernel / _mm_bias_kernel): out[m, n] = act(x[m, :] . w[:, n]
// + b[n]) for an NHWC activation viewed as x (M = B*H*W, Cin), f32
// accumulation, one rounding to bf16.
//
// What bounds it on the H100: bytes. YOLOv8n's 24 1x1 convs of one serving
// step at batch 8, 416 px, do 5.30 GFLOP and move 0.0304 ms of HBM traffic
// at 3.35 TB/s; the same work on the bf16 tensor cores takes about 0.005 ms
// at 989 TFLOP/s (NVIDIA H100 80GB HBM3, 700 W data-sheet peaks). The
// CUDA-core kernel of kernels.cu (mm_bias_act_kernel) cannot reach the byte
// bound: its f32 FMAs alone take at least 0.079 ms at 67 TFLOP/s.
//
// The design, so that the loads are the only cost:
// - wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators in registers), both
//   operands read from shared memory, K-major: x as it lies, w as
//   place_params lays it out once, K-major (its (Cout, Cin) transpose
//   contiguous).
// - A ring of STAGES (x, w) tile pairs in shared memory, filled by TMA
//   (cp.async.bulk.tensor) from one producer thread and completed on
//   mbarriers; one consumer warpgroup computes while later tiles load.
//   TMA's zero fill covers the ragged M edge, the K tail (Cin 48 or 96
//   against a K tile of 64) and the N padding (Cout 4 in an n8 tile), so
//   the main loop has no masks.
// - Tiles fitted to each call (ops/conv1x1_cuda.py plan_conv1x1): the N
//   tile follows Cout (8 .. 128) and is narrowed until the tiles reach the
//   SMs; the grid is persistent (up to four blocks an SM, as shared memory
//   allows) and walks its tiles, so the ring already holds the next tile's
//   loads while a tile's epilogue runs.
// - Epilogue in registers: f32 bias, SiLU with the same expf formula as the
//   CUDA-core kernel, one rounding to bf16, staged in shared memory and
//   written as 16-byte rows (masked element stores where Cout is not a
//   multiple of 8, as for the Cout = 4 class tips).
// 128-byte swizzle: a K tile is 64 bf16 = 128 bytes a row; the TMA maps and
// the wgmma descriptors both use it, and every tile starts 1024-aligned.

#include <cuda.h>  // CUtensorMap and its enums only: cuTensorMapEncodeTiled
                   // is looked up at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // rows of a tile: one warpgroup's m64
constexpr int kBK = 64;  // bf16 in one 128-byte swizzled row
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // one warpgroup + a producer warp

// Shared memory of one block; the kernel aligns its base to 1024 bytes, so
// a launch needs sizeof(Smem) + 1024 (plan_conv1x1's `smem` in Python).
template <int BN, int STAGES>
struct Smem {
  alignas(1024) bf16 a[STAGES][kBM * kBK];
  alignas(1024) bf16 b[STAGES][BN * kBK];
  alignas(16) bf16 c[kBM * (BN + 8)];  // epilogue staging, padded rows
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Returns once the phase of parity `parity` has completed. A wait of more
// than 2^32 cycles (over two seconds) traps: a pipeline fault then fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One TMA tile load: box at (c0 = column, c1 = row) of a 2-D map into dst,
// completing `bytes` on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The consumer warpgroup's own barrier (id 1; 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N]: both operands K-major in shared
// memory, f32 accumulators (N / 2 a thread).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads)
conv1x1_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int m, int n, int kiters, int tiles_n, int tiles,
                     int act) {
  extern __shared__ uint8_t smem_raw[];
  auto& sm = *reinterpret_cast<Smem<BN, STAGES>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&sm.empty[s], 1);  // one consumer arrive per use
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_x))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_w))
                 : "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread walks the block's tiles and keeps the ring full.
    // `it` counts k-steps over all the block's tiles, so a stage's phase
    // bit flips on every pass round the ring, across tile boundaries too.
    if (tid != kConsumers) return;
    constexpr uint32_t kBytes = (kBM + BN) * kBK * sizeof(bf16);
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM;
      const int n0 = (t % tiles_n) * BN;
      for (int kt = 0; kt < kiters; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], kBytes);
        tma_load_2d(sm.a[s], &map_x, &sm.full[s], kt * kBK, m0);
        tma_load_2d(sm.b[s], &map_w, &sm.full[s], kt * kBK, n0);
      }
    }
    return;
  }

  // Consumer warpgroup. Accumulator layout of m64nN: thread (warp w, lane
  // l) holds rows 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) + {0,1}.
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  constexpr int kLdc = BN + 8;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * kBM;
    const int n0 = (t % tiles_n) * BN;
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
    for (int kt = 0; kt < kiters; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&sm.full[s], (it / STAGES) & 1);
      const uint64_t da = smem_desc(sm.a[s]);
      const uint64_t db = smem_desc(sm.b[s]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        // k16 slice k starts 32 bytes further along the swizzled row.
        wgmma_bf16<BN>(d, da + 2 * k, db + 2 * k);
      }
      wgmma_commit();
      wgmma_wait_all();
      if (tid == 0) mbar_arrive(&sm.empty[s]);  // the stage may refill
    }

    // Epilogue: bias (+SiLU) in f32, one rounding, staged as bf16 rows.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      const float b0 = n0 + col < n ? bias[n0 + col] : 0.0f;
      const float b1 = n0 + col + 1 < n ? bias[n0 + col + 1] : 0.0f;
      float z[4] = {d[4 * j] + b0, d[4 * j + 1] + b1, d[4 * j + 2] + b0,
                    d[4 * j + 3] + b1};
      if (act) {
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = silu(z[q]);
      }
      *reinterpret_cast<__nv_bfloat162*>(&sm.c[r0 * kLdc + col]) =
          __floats2bfloat162_rn(z[0], z[1]);
      *reinterpret_cast<__nv_bfloat162*>(&sm.c[(r0 + 8) * kLdc + col]) =
          __floats2bfloat162_rn(z[2], z[3]);
    }
    consumer_sync();
    const int rows = min(kBM, m - m0);
    if (n % 8 == 0 && n0 + BN <= n) {
      constexpr int kVecs = BN / 8;  // 16-byte vectors a row
      for (int i = tid; i < rows * kVecs; i += kConsumers) {
        const int r = i / kVecs, v = i % kVecs;
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * n + n0 +
                                  v * 8) =
            *reinterpret_cast<const uint4*>(&sm.c[r * kLdc + v * 8]);
      }
    } else {
      for (int i = tid; i < rows * BN; i += kConsumers) {
        const int r = i / BN, c = i % BN;
        if (n0 + c < n) out[static_cast<size_t>(m0 + r) * n + n0 + c] =
            sm.c[r * kLdc + c];
      }
    }
    consumer_sync();  // the staging rows are read before the next tile's
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) bf16 matrix, read in boxes of box_rows x 64 with
// the 128-byte swizzle; reads past an edge fill zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int STAGES>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w,
           const float* bias, bf16* out, int m, int k, int n, int act,
           int grid, int smem, cudaStream_t stream) {
  if (smem != static_cast<int>(sizeof(Smem<BN, STAGES>)) + 1024)
    return cudaErrorInvalidValue;  // the Python plan and this file disagree
  auto kernel = conv1x1_wgmma_kernel<BN, STAGES>;
  // The opt-in to more than 48 KB of dynamic shared memory, once per device
  // (a repeat is harmless, so two threads racing here is too).
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64) return e ? e : cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in[dev] = true;
  }
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = ((m + kBM - 1) / kBM) * tiles_n;
  kernel<<<grid, kThreads, smem, stream>>>(map_x, map_w, bias, out, m, n,
                                          (k + kBK - 1) / kBK, tiles_n, tiles,
                                          act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (m, n) = act(x (m, k) @ w (k, n) + bias), bf16 in and out, bias f32,
// with w K-major: w[k, n] at w[n * k + k]. The tile plan (bn, stages, grid,
// smem) comes from ops/conv1x1_cuda.py plan_conv1x1. x and w must be
// 16-byte aligned with k a multiple of 8 (TMA's 16-byte row strides).
int zlt_conv1x1_wgmma(const void* x, const void* w, const void* bias,
                      void* out, int m, int k, int n, int act, int bn,
                      int stages, int grid, int smem, void* stream) {
  if (m < 0 || k < 8 || k % 8 != 0 || n < 1 || grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaGetLastError();
  CUtensorMap map_x, map_w;
  if (!encode_map(&map_x, x, m, k, kBM) || !encode_map(&map_w, w, n, k, bn))
    return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 8 && stages == 4)
    return launch<8, 4>(map_x, map_w, b, o, m, k, n, act, grid, smem, s);
  if (bn == 16 && stages == 4)
    return launch<16, 4>(map_x, map_w, b, o, m, k, n, act, grid, smem, s);
  if (bn == 32 && stages == 4)
    return launch<32, 4>(map_x, map_w, b, o, m, k, n, act, grid, smem, s);
  if (bn == 64 && stages == 4)
    return launch<64, 4>(map_x, map_w, b, o, m, k, n, act, grid, smem, s);
  if (bn == 128 && stages == 3)
    return launch<128, 3>(map_x, map_w, b, o, m, k, n, act, grid, smem, s);
  return cudaErrorInvalidValue;  // no such instance
}

// Host cost of one tensor-map encode (microseconds, mean over reps) for a
// (rows, cols) bf16 matrix: two run before each launch of the kernel above.
// Returns a negative value if cuTensorMapEncodeTiled is unavailable.
double zlt_tma_encode_us(const void* ptr, int rows, int cols, int box_rows,
                         int reps) {
  CUtensorMap map;
  if (reps < 1 || !encode_map(&map, ptr, rows, cols, box_rows)) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) encode_map(&map, ptr, rows, cols, box_rows);
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}

}  // extern "C"
