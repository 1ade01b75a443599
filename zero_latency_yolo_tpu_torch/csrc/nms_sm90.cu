// Greedy same-class NMS for the H100 (sm_90a): score-sorted boxes, classes
// and valid flags in, the keep mask out, in one launch.
//
// Replaces the TPU kernel zero_latency_yolo_tpu/ops/nms_pallas.py
// _suppress_kernel together with the pairwise IoU and same-class matrices
// that ops/nms.py built in front of it: the (B, K, K) IoU matrix and the
// same-class mask never reach device memory. Plain C interface, built with
// kernels.cu by one nvcc call (ops/_build.py) and bound with ctypes
// (ops/nms_cuda.py, which also holds the plain version and the host plan).
//
// What bounds it: not bytes (22 B a box in and out) and not operations (a
// few thousand IoUs a frame), but latency: greedy NMS is a serial chain,
// each kept box decides which later boxes are still alive. So the chain is
// made as short as it can be:
//
// 1. Stage. One block per frame. The frame's boxes become x1, y1, x2, y2 and
//    area in shared memory, with the operations of ops/nms.py
//    _iou_matrix_center; the valid flags become bit words (__ballot_sync).
// 2. Bitmask. mask word (w, i), bit b: candidate i suppresses j = 32w + b,
//    i.e. j > i, j valid, the same class, IoU(i, j) > thr. Every thread of
//    the block computes words, one (w, i) at a time, i fastest across a
//    warp (the warp reads box j as a broadcast). Only rows of valid i and
//    words holding some j > i are computed; only set bits of the valid word
//    are visited; the class is tested first, then the intersection, and
//    the division runs only for pairs that intersect (a pair that does not
//    has IoU 0, which is not above a threshold >= 0).
// 3. Scan. One warp: lane w holds keep word w (K <= 1024), and the warp
//    settles one word of 32 candidates at a time: the lanes hold the
//    word's 32 diagonal mask rows, and a warp-wide OR (__reduce_or_sync)
//    a round settles the word in as many rounds as its longest chain of
//    suppressions, plus one; one more OR a later word clears the kept
//    candidates' rows from it. No block barrier sits in the chain. (A
//    scan that keeps one candidate a step puts a shared-memory read on the
//    chain for every kept box: on an H100 about 100 ns each, some 18 of
//    33 us on the seeded case of chip_smoke.py.)
// 4. The keep bits are written as bytes straight into the bool output.
//
// Exactness: keep masks equal the plain version's bit for bit, so the IoU
// rounds as PyTorch's elementwise ops do: no FMA contraction (__fmul_rn,
// __fadd_rn, __fsub_rn), IEEE division (__fdiv_rn), the union as
// (area_i + area_j) - inter clamped below at 1e-9f, and max / min / clamp
// that propagate NaN as torch.maximum / torch.minimum / torch.clamp do, so
// a box with a NaN coordinate suppresses nothing and is suppressed by
// nothing (its IoUs are NaN, and NaN > thr is false). Never build this with
// --use_fast_math.
//
// Shared memory a block: the mask, words x stride u32 with a row stride of
// 32 * words + 1 (so the scan's lanes hit distinct banks), then five f32 and
// one i32 per box and the valid / keep words: 155,904 B at K = 1024, above
// the 48 KB default, so the launch opts in. ops/nms_cuda.py plan_nms_keep
// computes the same size and the thread count and passes them in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 1024;
constexpr int kMaxThreads = 1024;

// torch.maximum / torch.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
nms_keep_kernel(const float* __restrict__ boxes,
                const int32_t* __restrict__ classes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int k, float thr) {
  extern __shared__ uint32_t smem[];
  const int words = (k + 31) >> 5;
  const int stride = 32 * words + 1;
  uint32_t* mask = smem;  // [words][stride]: mask[w * stride + i]
  float* x1 = reinterpret_cast<float*>(mask + words * stride);
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  int32_t* cls = reinterpret_cast<int32_t*>(area + k);
  uint32_t* bits = reinterpret_cast<uint32_t*>(cls + k);  // valid, then keep
  const size_t frame = blockIdx.x;
  const float* box = boxes + frame * k * 4;
  const int tid = threadIdx.x;

  // 1. Stage. Whole warps run each pass (32 * words is a multiple of 32),
  // so the ballot sees every lane.
  for (int j = tid; j < 32 * words; j += blockDim.x) {
    bool v = false;
    if (j < k) {
      const float cx = box[4 * j], cy = box[4 * j + 1];
      const float w = box[4 * j + 2], h = box[4 * j + 3];
      const float hw = __fdiv_rn(w, 2.0f), hh = __fdiv_rn(h, 2.0f);
      x1[j] = __fsub_rn(cx, hw);
      y1[j] = __fsub_rn(cy, hh);
      x2[j] = __fadd_rn(cx, hw);
      y2[j] = __fadd_rn(cy, hh);
      area[j] = __fmul_rn(clamp_min(w, 0.0f), clamp_min(h, 0.0f));
      cls[j] = classes[frame * k + j];
      v = valid[frame * k + j] != 0;
    }
    const uint32_t word = __ballot_sync(kFull, v);
    if ((j & 31) == 0) bits[j >> 5] = word;
  }
  __syncthreads();

  // 2. Bitmask, word (w, i) by word.
  for (int item = tid; item < words * k; item += blockDim.x) {
    const int w = item / k;
    const int i = item - w * k;
    const int first = (i + 1) >> 5;  // the word of j = i + 1
    if (w < first || !((bits[i >> 5] >> (i & 31)) & 1u)) continue;
    uint32_t cand = bits[w];
    if (w == first) cand &= kFull << ((i + 1) & 31);  // j > i only
    // The class first, for all candidates of the word (the same ones for
    // every lane of the warp past the diagonal, so the reads broadcast);
    // the IoU then only for the pairs of one class, which the lanes of a
    // warp (different i) meet at different j.
    const int ci = cls[i];
    uint32_t same = 0;
    for (uint32_t c = cand; c; c &= c - 1) {
      const int b = __ffs(c) - 1;
      same |= static_cast<uint32_t>(cls[(w << 5) + b] == ci) << b;
    }
    const float ax1 = x1[i], ay1 = y1[i], ax2 = x2[i], ay2 = y2[i];
    const float aa = area[i];
    uint32_t row = 0;
    while (same) {
      const int b = __ffs(same) - 1;
      same &= same - 1;
      const int j = (w << 5) + b;
      const float iw =
          clamp_min(__fsub_rn(min_nan(ax2, x2[j]), max_nan(ax1, x1[j])), 0.0f);
      const float ih =
          clamp_min(__fsub_rn(min_nan(ay2, y2[j]), max_nan(ay1, y1[j])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      if (!(inter > 0.0f)) continue;  // IoU 0 or NaN: never above thr >= 0
      const float uni =
          clamp_min(__fsub_rn(__fadd_rn(aa, area[j]), inter), 1e-9f);
      if (__fdiv_rn(inter, uni) > thr) row |= 1u << b;
    }
    mask[w * stride + i] = row;
  }
  __syncthreads();

  // 3. Scan: one warp, word by word; lane w holds keep word w. For word
  // wl, lane r holds the diagonal mask row of candidate 32 * wl + r (the
  // later candidates of the word it suppresses; candidate 31 has none), and
  // the word's keep bits are the fixed point of
  //   word = todo & ~OR{ row r : bit r of word }
  // iterated from word = todo. Rows only point forward, so after t rounds
  // the first t bits are final, and a round that changes nothing has
  // reached greedy NMS's answer: as many rounds as the longest chain of
  // suppressions in the word, plus one. Then each later word w takes the OR
  // of the kept candidates' rows for w (lane r reads row r's word w).
  if (tid < 32) {
    const int lane = tid;
    uint32_t kept = lane < words ? bits[lane] : 0u;
    for (int wl = 0; wl < words; ++wl) {
      const uint32_t todo = __shfl_sync(kFull, kept, wl);
      if (!todo) continue;  // uniform: the shuffle gave every lane the word
      const uint32_t* rows = mask + 32 * wl + lane;  // rows[w * stride]
      const bool mine = (todo >> lane) & 1u;
      const uint32_t diag = mine && lane < 31 ? rows[wl * stride] : 0u;
      uint32_t word = todo, last;
      do {
        last = word;
        word = todo & ~__reduce_or_sync(kFull, (word >> lane) & 1u ? diag : 0u);
      } while (word != last);
      if (lane == wl) kept = word;
      const bool keeps = (word >> lane) & 1u;
      for (int w = wl + 1; w < words; ++w) {
        const uint32_t sup =
            __reduce_or_sync(kFull, keeps ? rows[w * stride] : 0u);
        if (lane == w) kept &= ~sup;
      }
    }
    if (lane < words) bits[lane] = kept;
  }
  __syncthreads();

  // 4. Keep bits to bool bytes, coalesced.
  for (int j = tid; j < k; j += blockDim.x)
    keep[frame * k + j] = (bits[j >> 5] >> (j & 31)) & 1u;
}

}  // namespace

extern "C" {

// Dynamic shared memory nms_keep_kernel needs for k candidates (the layout
// above; ops/nms_cuda.py plan_nms_keep computes the same).
int zlt_nms_keep_smem_bytes(int k) {
  const int words = (k + 31) >> 5;
  return 4 * (words * (32 * words + 1) + 6 * k + words);
}

// boxes (b, k, 4) f32 center format, classes (b, k) i32, valid and keep
// (b, k) bytes 0/1; every row score-sorted. thr >= 0. threads and smem
// come from plan_nms_keep and are checked here.
int zlt_nms_keep(const void* boxes, const void* classes, const void* valid,
                 void* keep, int b, int k, float thr, int threads, int smem,
                 void* stream) {
  if (b < 1 || k < 1 || k > kMaxK || !(thr >= 0.0f) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      smem != zlt_nms_keep_smem_bytes(k))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  nms_keep_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const int32_t*>(classes),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, thr);
  return cudaGetLastError();
}

}  // extern "C"
