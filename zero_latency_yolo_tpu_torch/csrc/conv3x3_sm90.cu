// 3x3 convolution with its bias + SiLU fused into the epilogue, on Hopper's
// tensor cores, bf16: an implicit GEMM on wgmma.
//
// Replaces the JAX package's TPU kernel ops/act_pallas.py:40
// (_bias_silu_kernel), the bias + SiLU pass after every conv that is not a
// 1x1, by computing that pass inside the conv that produces its input, so
// that the conv output never goes to device memory unbiased and no
// separate pass is launched. The function is the JAX package's
// models/yolov8.py _conv at k=3 (pad 1, stride 1 or 2): for NHWC bf16 x
// (B, H, W, Cin), a folded weight w and an f32 bias b,
//
//   out[m, n] = bf16( silu( sum_k A[m, k] * w[n, k] + b[n] ) )
//
// with M = B*Ho*Wo output pixels, N = Cout, K = 9*Cin in (ky, kx, ci)
// order, A[m, k] the input value under tap (ky, kx) of output pixel m (zero
// outside the image), f32 accumulation, bias and SiLU in f32, one rounding.
//
// What bounds it on the H100: bytes. YOLOv8n's k=3 convs of one serving
// step at batch 8, 416 px, read and write about 129 MB of bf16 activations
// and do 22 GFLOP: 0.039 ms at 3.35 TB/s against 0.022 ms at 989 TFLOP/s
// (NVIDIA H100 80GB HBM3, 700 W data-sheet peaks). The 9 re-reads of each
// input pixel by neighbouring patches are L1/L2 traffic, not HBM traffic.
//
// The design (the skeleton of conv1x1_sm90.cu):
// - wgmma.mma_async m64nNk16, bf16 in, f32 accumulators in registers, both
//   operands K-major in shared memory with the 128-byte swizzle (sm90.cuh).
// - The weight: the placed kernel, OIHW in channels-last memory, is already
//   the K-major (Cout, 9*Cin) matrix in (ky, kx, ci) order
//   (models/weights.py place_params), read by TMA as in the 1x1 kernel; its
//   zero fill covers the K tail and the N padding.
// - The activations: gathered by cp.async, 16 bytes (8 channels of one
//   input pixel) a copy, zero-filled outside the image, past the last
//   output pixel and past K, written into the swizzled layout by hand.
//   Why cp.async and not TMA's im2col mode: a 128-byte K tile of a
//   narrow layer spans several taps (Cin 16: four taps of 32 bytes), and an
//   im2col box holds one tap's channels for a run of pixels, so Cin 16 and
//   32 would need the 32/64-byte swizzles with other wgmma descriptors and
//   several boxes a K tile; a 16-byte gather takes every Cin % 8 == 0 with
//   one layout, stride 2 is address arithmetic, and a channel slice of a
//   wider tensor (C2f's y[..., c:]) is read where it lies (pixel stride
//   ldx). The copies go through L1 (.ca), which catches the patches'
//   overlap within a tile.
// - One producer warpgroup (one warp's copies in flight bound the K steps
//   of a first version): thread p gathers 16-byte chunk p % 8 of rows
//   p / 8 + 16j (j < 4) of each K tile, a row's eight chunks by eight
//   neighbouring threads, from its rows' patch origins, computed once a
//   tile in registers; the tap of a thread's chunk advances by one K tile
//   without division (Tap). Completion: each thread's
//   cp.async.mbarrier.arrive.noinc plus thread 0's TMA bytes on the
//   stage's full barrier.
// - One consumer warpgroup (64-row tiles) or two (128-row tiles, sharing
//   each weight tile), a ring of STAGES stages on mbarriers, one step's
//   products left in flight while the next stage is awaited, a persistent
//   grid walking tiles with N fastest (the blocks of one M tile gather the
//   same rows, close in time, from L2). Tiles fitted to each call by
//   ops/conv3x3_cuda.py plan_conv3x3 from a sweep on the card; no split K,
//   so each call stays one launch.
// - The consumer reads the gathered tile through the async proxy (wgmma)
//   after the generic-proxy cp.async writes: a proxy fence after the full
//   barrier's wait orders the two.
// - Epilogue of the 1x1 kernel: f32 bias, SiLU (with the hardware's exp2 and
//   reciprocal, silu_fast), one rounding to bf16, staged in shared memory,
//   16-byte row stores (element stores where Cout is not a multiple of 8).
// Where the time goes (conv3x3_probe.py, PERF.md): at yolov8n's calls a
// fixed cost a call (launch, the ring's first fill, the epilogue) more than
// the gather or the MMAs; at yolov8s's the gather, then the epilogue.

#include "sm90.cuh"

namespace {

constexpr int kBK = kSwizzleK;  // K of a stage: 64 bf16, one swizzled row
constexpr int kProducers = 128;  // one warpgroup gathers
constexpr int kChunks = kBK / 8;                 // 16-byte chunks a row: 8
constexpr int kRowStep = kProducers / kChunks;   // rows one pass covers: 16

// Shared memory of one block; the kernel aligns its base to 1024 bytes, so
// a launch needs sizeof(Smem) + 1024 (plan_conv3x3's `smem` in Python).
template <int BM, int BN, int STAGES>
struct Smem {
  alignas(1024) bf16 a[STAGES][BM * kBK];
  alignas(1024) bf16 b[STAGES][BN * kBK];
  alignas(16) bf16 c[BM * (BN + 8)];  // epilogue staging, padded rows
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

struct Geom {
  int h, w, cin, ldx, ho, wo, stride, kdim, m, n;
};

// The tap and channel of K index k = (ky * 3 + kx) * cin + ci; `off` is
// the tap's pixel offset ky * w + kx from the patch origin.
struct Tap {
  int k, ci, ky, kx, off;
};

__device__ __forceinline__ Tap tap_of(int k, const Geom& g) {
  const int t = k / g.cin;
  const int ky = t / 3, kx = t - 3 * (t / 3);
  return {k, k - t * g.cin, ky, kx, ky * g.w + kx};
}

// k += kBK, with no division.
__device__ __forceinline__ void advance(Tap& t, const Geom& g) {
  t.k += kBK;
  t.ci += kBK;
  while (t.ci >= g.cin) {  // at most kBK / cin times
    t.ci -= g.cin;
    if (++t.kx == 3) {
      t.kx = 0;
      ++t.ky;
    }
  }
  t.off = t.ky * g.w + t.kx;
}

// 16 bytes global -> shared through L1, zero-filled past `src_bytes`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// SiLU with the hardware's exp2 and reciprocal (MUFU): a few f32 ulps from
// z / (1 + expf(-z)), well inside the one rounding to bf16 that follows.
// The accurate formula of sm90.cuh (expf and an IEEE division, tens of
// instructions an element) is spent by the consumer warpgroups while the
// tensor cores wait.
__device__ __forceinline__ float silu_fast(float z) {
  return __fdividef(z, 1.0f + __expf(-z));
}

// Consumer warpgroup wg's own barrier (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2 + kProducers)
conv3x3_wgmma_kernel(const bf16* __restrict__ x,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     const Geom g, int kiters, int tiles_n, int tiles) {
  constexpr int kGroups = BM / 64;  // consumer warpgroups, m64 rows each
  constexpr int kRowsPerThread = BM / kRowStep;
  extern __shared__ uint8_t smem_raw[];
  auto& sm = *reinterpret_cast<Smem<BM, BN, STAGES>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // The producers' cp.async arrivals + thread 0's arrive with the TMA
      // bytes; one arrive a consumer warpgroup when it is done with a use.
      mbar_init(&sm.full[s], kProducers + 1);
      mbar_init(&sm.empty[s], kGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_w))
                 : "memory");
  }
  __syncthreads();

  if (tid >= kGroups * 128) {
    // Producer warpgroup. Thread p gathers 16-byte chunk p % 8 of rows
    // p / 8 + 16j of every K tile. `it` counts k-steps over all the
    // block's tiles, so a stage's phase bit flips on every pass round the
    // ring.
    const int p = tid - kGroups * 128;
    const int chunk = p % kChunks, row0 = p / kChunks;
    constexpr uint32_t kBytesB = BN * kBK * sizeof(bf16);
    const int hw_out = g.ho * g.wo;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM;
      const int n0 = (t % tiles_n) * BN;
      // The patch origin of each of the thread's rows: input pixel index,
      // row and column of tap (0, 0); a row past M gets a row far outside
      // every image.
      int pix[kRowsPerThread], iy0[kRowsPerThread], ix0[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int m = m0 + row0 + kRowStep * j;
        const int img = m / hw_out, rem = m - img * hw_out;
        const int oy = rem / g.wo, ox = rem - oy * g.wo;
        iy0[j] = m < g.m ? oy * g.stride - 1 : -(1 << 28);
        ix0[j] = ox * g.stride - 1;
        pix[j] = (img * g.h + iy0[j]) * g.w + ix0[j];
      }
      Tap tap = tap_of(chunk * 8, g);
      for (int kt = 0; kt < kiters; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
        if (p == 0) {
          mbar_arrive_expect_tx(&sm.full[s], kBytesB);
          tma_load_2d(sm.b[s], &map_w, &sm.full[s], kt * kBK, n0);
        }
        const uint32_t a_base = smem_u32(sm.a[s]);
        const bool k_ok = tap.k < g.kdim;
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const bool ok = k_ok &&
                          static_cast<unsigned>(iy0[j] + tap.ky) <
                              static_cast<unsigned>(g.h) &&
                          static_cast<unsigned>(ix0[j] + tap.kx) <
                              static_cast<unsigned>(g.w);
          const bf16* src =
              ok ? x + (static_cast<size_t>(pix[j] + tap.off) * g.ldx + tap.ci)
                 : x;
          cp_async16(a_base + swizzle128(row0 + kRowStep * j, chunk), src,
                     ok ? 16u : 0u);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                         "r"(smem_u32(&sm.full[s]))
                     : "memory");
        advance(tap, g);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumer warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile.
  // Accumulator layout of m64nN: thread (warp w, lane l) holds rows 16w +
  // l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) + {0,1}.
  const int wg = tid / 128, wtid = tid % 128;
  const int lane = wtid % 32;
  const int r0 = wg * 64 + (wtid / 32) * 16 + lane / 4;
  constexpr int kLdc = BN + 8;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * BM;
    const int n0 = (t % tiles_n) * BN;
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
    for (int kt = 0; kt < kiters; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&sm.full[s], (it / STAGES) & 1);
      // The gathered tile was written by cp.async (generic proxy); wgmma
      // reads it through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint64_t da = smem_desc(sm.a[s] + wg * 64 * kBK);
      const uint64_t db = smem_desc(sm.b[s]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        // k16 slice k starts 32 bytes further along the swizzled row.
        wgmma_bf16<BN>(d, da + 2 * k, db + 2 * k);
      }
      wgmma_commit();
      // One step's products stay in flight while the next stage arrives;
      // the step before is done, so its stage may refill.
      wgmma_wait<1>();
      if (kt > 0 && wtid == 0) mbar_arrive(&sm.empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_operands(d);
    if (wtid == 0) mbar_arrive(&sm.empty[(it - 1) % STAGES]);

    // Epilogue: bias + SiLU in f32, one rounding, staged as bf16 rows.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      const float b0 = n0 + col < g.n ? bias[n0 + col] : 0.0f;
      const float b1 = n0 + col + 1 < g.n ? bias[n0 + col + 1] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(&sm.c[r0 * kLdc + col]) =
          __floats2bfloat162_rn(silu_fast(d[4 * j] + b0),
                                silu_fast(d[4 * j + 1] + b1));
      *reinterpret_cast<__nv_bfloat162*>(&sm.c[(r0 + 8) * kLdc + col]) =
          __floats2bfloat162_rn(silu_fast(d[4 * j + 2] + b0),
                                silu_fast(d[4 * j + 3] + b1));
    }
    wg_sync(wg);
    const int rbase = wg * 64;
    const int rows = min(64, g.m - m0 - rbase);
    if (g.n % 8 == 0 && n0 + BN <= g.n) {
      constexpr int kVecs = BN / 8;  // 16-byte vectors a row
      for (int i = wtid; i < rows * kVecs; i += 128) {
        const int r = rbase + i / kVecs, v = i % kVecs;
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * g.n +
                                  n0 + v * 8) =
            *reinterpret_cast<const uint4*>(&sm.c[r * kLdc + v * 8]);
      }
    } else {
      for (int i = wtid; i < rows * BN; i += 128) {
        const int r = rbase + i / BN, c = i % BN;
        if (n0 + c < g.n)
          out[static_cast<size_t>(m0 + r) * g.n + n0 + c] = sm.c[r * kLdc + c];
      }
    }
    wg_sync(wg);  // the staging rows are read before the next tile's
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch.
// ---------------------------------------------------------------------------

template <int BM, int BN, int STAGES>
int launch(const bf16* x, const CUtensorMap& map_w, const float* bias,
           bf16* out, const Geom& g, int grid, int smem, cudaStream_t stream) {
  if (smem != static_cast<int>(sizeof(Smem<BM, BN, STAGES>)) + 1024)
    return cudaErrorInvalidValue;  // the Python plan and this file disagree
  auto kernel = conv3x3_wgmma_kernel<BM, BN, STAGES>;
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
  const int tiles_n = (g.n + BN - 1) / BN;
  const int tiles = ((g.m + BM - 1) / BM) * tiles_n;
  kernel<<<grid, BM * 2 + kProducers, smem, stream>>>(
      x, map_w, bias, out, g, (g.kdim + kBK - 1) / kBK, tiles_n, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n, ho, wo, cout) = silu(conv3x3(x, w, stride, pad 1) + bias), bf16
// in and out, bias f32, ho = (h - 1) / stride + 1 (wo likewise). x is NHWC
// with pixel stride ldx elements (>= cin; a channel slice of a wider
// tensor has ldx > cin), w the K-major (cout, 9 * cin) matrix in (ky, kx,
// ci) order. The tile plan (bm, bn, stages, grid, smem) comes from
// ops/conv3x3_cuda.py plan_conv3x3. x and w must be 16-byte aligned, cin
// and ldx multiples of 8, and every offset within 32 bits.
int zlt_conv3x3_wgmma(const void* x, const void* w, const void* bias,
                      void* out, int n, int h, int wd, int cin, int ldx,
                      int cout, int stride, int bm, int bn, int stages,
                      int grid, int smem, void* stream) {
  if (n < 0 || h < 1 || wd < 1 || cin < 8 || cin % 8 != 0 || ldx < cin ||
      ldx % 8 != 0 || cout < 1 || (stride != 1 && stride != 2) || grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  Geom g{};
  g.h = h;
  g.w = wd;
  g.cin = cin;
  g.ldx = ldx;
  g.ho = (h - 1) / stride + 1;
  g.wo = (wd - 1) / stride + 1;
  g.stride = stride;
  g.kdim = 9 * cin;
  g.n = cout;
  const long long m = 1ll * n * g.ho * g.wo;
  if (1ll * n * h * wd * ldx >= (1ll << 31) || m * cout >= (1ll << 31) ||
      1ll * cout * g.kdim >= (1ll << 31))
    return cudaErrorInvalidValue;  // past 32-bit offsets
  g.m = static_cast<int>(m);
  if (m == 0) return cudaGetLastError();
  CUtensorMap map_w;
  if (!encode_map(&map_w, w, cout, g.kdim, bn)) return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 8 && stages == 4)
    return launch<64, 8, 4>(xp, map_w, b, o, g, grid, smem, s);
  if (bm == 64 && bn == 16 && stages == 4)
    return launch<64, 16, 4>(xp, map_w, b, o, g, grid, smem, s);
  if (bm == 64 && bn == 32 && stages == 4)
    return launch<64, 32, 4>(xp, map_w, b, o, g, grid, smem, s);
  if (bm == 64 && bn == 64 && stages == 4)
    return launch<64, 64, 4>(xp, map_w, b, o, g, grid, smem, s);
  if (bm == 64 && bn == 128 && stages == 3)
    return launch<64, 128, 3>(xp, map_w, b, o, g, grid, smem, s);
  if (bm == 128 && bn == 32 && stages == 4)
    return launch<128, 32, 4>(xp, map_w, b, o, g, grid, smem, s);
  if (bm == 128 && bn == 64 && stages == 3)
    return launch<128, 64, 3>(xp, map_w, b, o, g, grid, smem, s);
  return cudaErrorInvalidValue;  // no such instance
}

}  // extern "C"
