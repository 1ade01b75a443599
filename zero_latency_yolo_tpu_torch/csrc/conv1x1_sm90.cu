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
// the wgmma descriptors both use it, and every tile starts 1024-aligned
// (sm90.cuh).

#include "sm90.cuh"

#include <chrono>

namespace {

constexpr int kBM = 64;  // rows of a tile: one warpgroup's m64
constexpr int kBK = kSwizzleK;  // bf16 in one 128-byte swizzled row
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
// Host side: the launch.
// ---------------------------------------------------------------------------

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
