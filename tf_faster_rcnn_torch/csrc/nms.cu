// Exact greedy NMS for Hopper (sm_90a): the two kernels of the detect path.
//
// K1  frcnn_nms_keep_mask   replaces tf_faster_rcnn_tpu/ops/pallas_nms.py
//                           _nms_kernel / pallas_nms_keep_mask: one keep mask
//                           per image over N score-sorted boxes, for all B
//                           images of a step in one call (RPN proposals).
// K2  frcnn_batched_nms_keep replaces _batched_nms_kernel /
//                           pallas_batched_nms_keep: G independent instances
//                           in one launch (per-class detection NMS).
//
// The IoU test is the JAX formula operation for operation
// (pallas_nms.py::_iou_tile, ops/boxes.py::bbox_overlaps), so the boolean
// masks are bit-identical to the reference. That holds only without FMA
// contraction: build with -fmad=false, never with --use_fast_math (the
// division must stay IEEE).
//
// A launcher returns cudaGetLastError() after its launches; it allocates
// nothing and never synchronises.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;  // boxes per suppression word (one uint64)

__device__ __forceinline__ bool suppresses(float4 a, float4 b, float e,
                                           float thresh, bool suppress_eq) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x) + e, 0.0f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y) + e, 0.0f);
  const float inter = iw * ih;
  const float area_a = (a.z - a.x + e) * (a.w - a.y + e);
  const float area_b = (b.z - b.x + e) * (b.w - b.y + e);
  const float uni = area_a + area_b - inter;
  const float iou = uni > 0.0f ? inter / uni : 0.0f;
  return suppress_eq ? iou >= thresh : iou > thresh;
}

// K1, pass 1. Grid (column block, row block, image), 64 threads. Thread t
// tests row box i = 64*row_block + t against the 64 column boxes staged in
// shared memory and writes one word: bit j set iff box i would suppress
// column box 64*col_block + j (> i). Words left of the diagonal are never
// read by the scan, so they are not written.
//
// Bound on this card: N^2/2 IoU tests (18M at N = 6000, B = 8 -> 144M per
// step) and an N x N/64 word matrix (4.5 MB per image) written once and read
// back only for kept rows; both fit the 50 MB L2. The tile keeps the column
// boxes in shared memory, so each IoU costs no device-memory traffic.
__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, int n, int col_blocks,
                float e, float thresh, int suppress_eq,
                unsigned long long* __restrict__ mask) {
  const int img = blockIdx.z;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;
  const float4* b = boxes + static_cast<size_t>(img) * n;
  const int row_size = min(n - row_block * kTile, kTile);
  const int col_size = min(n - col_block * kTile, kTile);

  __shared__ float4 cols[kTile];
  if (threadIdx.x < col_size) cols[threadIdx.x] = b[col_block * kTile + threadIdx.x];
  __syncthreads();
  if (threadIdx.x >= row_size) return;

  const int i = row_block * kTile + threadIdx.x;
  const float4 r = b[i];
  unsigned long long bits = 0ULL;
  const int start = row_block == col_block ? threadIdx.x + 1 : 0;
  for (int j = start; j < col_size; ++j) {
    if (suppresses(r, cols[j], e, thresh, suppress_eq != 0)) bits |= 1ULL << j;
  }
  mask[(static_cast<size_t>(img) * n + i) * col_blocks + col_block] = bits;
}

// K1, pass 2: the greedy scan, one warp per image, on the device so the step
// never waits on the host. Lane l holds the `removed` words l, l+32, ... in
// registers (WPL words per lane). Validity arrives 32 boxes at a time as one
// ballot, so invalid boxes cost no step. For box i the owner lane's word is
// broadcast with a shuffle; a kept box ORs its mask row into every lane's
// words. The scan stops once max_keep boxes are kept and writes keep = 0 for
// every later box (the prefix contract of ops/nms.py::nms_keep_mask).
//
// Bound: a chain of N dependent steps (latency, not bandwidth); each kept
// box adds one row read of col_blocks words, mostly from L2.
template <int WPL>
__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const unsigned char* __restrict__ valid, int n, int col_blocks,
                int max_keep, unsigned char* __restrict__ keep) {
  const int img = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + static_cast<size_t>(img) * n * col_blocks;
  const unsigned char* v = valid + static_cast<size_t>(img) * n;
  unsigned char* k = keep + static_cast<size_t>(img) * n;

  unsigned long long removed[WPL];
#pragma unroll
  for (int s = 0; s < WPL; ++s) removed[s] = 0ULL;

  int kept = 0;
  for (int base = 0; base < n; base += 32) {
    const int idx = base + lane;
    unsigned todo = __ballot_sync(0xffffffffu, idx < n && v[idx] != 0 && kept < max_keep);
    unsigned kbits = 0u;
    while (todo != 0u) {
      const int t = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int i = base + t;
      const int w = i >> 6;
      unsigned long long mine = 0ULL;
#pragma unroll
      for (int s = 0; s < WPL; ++s) {
        if (s == (w >> 5)) mine = removed[s];
      }
      const unsigned long long word = __shfl_sync(0xffffffffu, mine, w & 31);
      if ((word >> (i & 63)) & 1ULL) continue;
      kbits |= 1u << t;
      if (++kept == max_keep) break;
      const unsigned long long* row = m + static_cast<size_t>(i) * col_blocks;
#pragma unroll
      for (int s = 0; s < WPL; ++s) {
        const int ww = lane + 32 * s;
        if (ww >= w && ww < col_blocks) removed[s] |= row[ww];
      }
    }
    if (idx < n) k[idx] = static_cast<unsigned char>((kbits >> lane) & 1u);
  }
}

// K2: one CTA per instance. The instance's boxes and alive flags sit in
// shared memory (17 bytes a box: 17 KB at N = 1000). A sequential sweep over
// i; when box i is alive, the threads stride over j > i and clear alive[j]
// where row i suppresses it: _batched_nms_kernel's rule exactly
// (pallas_nms.py:172-187). alive[i] is settled by the time the sweep reaches
// i, so the branch is uniform and only alive rows pay a barrier.
//
// Bound: N sequential steps per instance (latency); the IoU work per step is
// N/blockDim tests per thread from shared memory. G = 160 instances fill the
// 132 SMs in one wave.
__global__ void batched_nms_kernel(const float4* __restrict__ boxes,
                                   const unsigned char* __restrict__ valid,
                                   int n, float e, float thresh, int suppress_eq,
                                   unsigned char* __restrict__ keep) {
  extern __shared__ float4 smem[];
  float4* sb = smem;
  unsigned char* alive = reinterpret_cast<unsigned char*>(sb + n);
  const size_t off = static_cast<size_t>(blockIdx.x) * n;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sb[j] = boxes[off + j];
    alive[j] = valid[off + j] != 0;
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (!alive[i]) continue;
    const float4 r = sb[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      if (alive[j] && suppresses(r, sb[j], e, thresh, suppress_eq != 0)) alive[j] = 0;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) keep[off + j] = alive[j];
}

template <int WPL>
cudaError_t launch_scan(const unsigned long long* mask, const unsigned char* valid,
                        int batch, int n, int col_blocks, int max_keep,
                        unsigned char* keep, cudaStream_t stream) {
  nms_scan_kernel<WPL><<<batch, 32, 0, stream>>>(mask, valid, n, col_blocks,
                                                   max_keep, keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N frcnn_nms_keep_mask takes: 16 words per lane x 32 lanes x 64.
int frcnn_nms_max_boxes() { return 16 * 32 * kTile; }

// boxes [batch, n, 4] f32 (16-byte aligned), valid/keep [batch, n] bytes,
// mask scratch [batch, n, ceil(n/64)] uint64. max_keep >= 1.
int frcnn_nms_keep_mask(const void* boxes, const void* valid, int batch, int n,
                        float thresh, int plus_one, int suppress_eq,
                        int max_keep, void* mask, void* keep, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > frcnn_nms_max_boxes() || max_keep < 1) return cudaErrorInvalidValue;
  const int col_blocks = (n + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float e = plus_one ? 1.0f : 0.0f;
  auto* words = static_cast<unsigned long long*>(mask);

  const dim3 grid(col_blocks, col_blocks, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(static_cast<const float4*>(boxes), n,
                                         col_blocks, e, thresh, suppress_eq, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const auto* v = static_cast<const unsigned char*>(valid);
  auto* k = static_cast<unsigned char*>(keep);
  const int wpl = (col_blocks + 31) / 32;
  if (wpl <= 1) return launch_scan<1>(words, v, batch, n, col_blocks, max_keep, k, s);
  if (wpl <= 2) return launch_scan<2>(words, v, batch, n, col_blocks, max_keep, k, s);
  if (wpl <= 4) return launch_scan<4>(words, v, batch, n, col_blocks, max_keep, k, s);
  if (wpl <= 8) return launch_scan<8>(words, v, batch, n, col_blocks, max_keep, k, s);
  return launch_scan<16>(words, v, batch, n, col_blocks, max_keep, k, s);
}

// Largest N frcnn_batched_nms_keep takes: 17 bytes a box in 227 KB.
int frcnn_batched_nms_max_boxes() { return 232448 / 17; }

// boxes [groups, n, 4] f32 (16-byte aligned), valid/keep [groups, n] bytes.
int frcnn_batched_nms_keep(const void* boxes, const void* valid, int groups,
                           int n, float thresh, int plus_one, int suppress_eq,
                           void* keep, void* stream) {
  if (groups <= 0 || n <= 0) return 0;
  if (n > frcnn_batched_nms_max_boxes()) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(n) * (sizeof(float4) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        batched_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = n >= 256 ? 256 : ((n + 31) / 32) * 32;
  batched_nms_kernel<<<groups, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const unsigned char*>(valid),
      n, plus_one ? 1.0f : 0.0f, thresh, suppress_eq,
      static_cast<unsigned char*>(keep));
  return cudaGetLastError();
}

}  // extern "C"
