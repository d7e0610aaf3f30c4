// Exact greedy NMS for Hopper (sm_90a): one engine for the two kernels of
// the detect path.
//
// K1  frcnn_nms_keep (max_keep >= 1) replaces tf_faster_rcnn_tpu/ops/
//     pallas_nms.py _nms_kernel / pallas_nms_keep_mask: one keep mask per
//     image over N score-sorted boxes, all B images of a step in one call,
//     stopping at max_keep survivors (RPN proposals).
// K2  frcnn_nms_keep (no cap) replaces _batched_nms_kernel /
//     pallas_batched_nms_keep: G independent instances in one launch
//     (per-class detection NMS).
//
// The masks are bit-identical to the reference's. The IoU is the JAX
// formula operation for operation (pallas_nms.py::_iou_tile): inter, the
// areas and uni round exactly as there, which needs -fmad=false and no
// --use_fast_math. The threshold test on inter / uni is decided exactly
// without the division (Threshold below), or by the IEEE division.
//
// What bounds it on this card. The work is a chain: box i's fate depends on
// every kept box before it. The IoU tests the answer needs are few (each
// box against the kept boxes before it, and only up to E, the index of the
// max_keep-th keep: E = 1298-1996 of N = 6000 on the RPN's boxes), so the
// time is the chain's latency, not operations or bytes. The design keeps
// device memory off that chain and does no IoU test the answer cannot use:
//
// * One CTA per instance; the boxes kept so far sit in shared memory, in
//   order (at most min(max_keep, N) of them; past 11,467 in device memory).
// * Block-serial over row blocks of 64 boxes, two CTA barriers a block.
//   Pull: each warp takes boxes of block j and tests one against 64 kept
//   boxes at a time, stopping at the first hit, which sets its `removed`
//   bit; a box that survives gets its in-block mask (`sup`, the boxes
//   before it in the block that would suppress it). Resolve: one warp
//   solves a = cand & ~(sup^T a), cand = valid & ~removed, the greedy
//   answer, in as many ballot rounds as the block's longest suppression
//   chain, keeps its first max_keep - total boxes and appends them. Block
//   j + 2's boxes are loaded from device memory while block j is pulled,
//   so no load waits on the chain.
// * Once max_keep boxes are kept, the loop stops: no later box is tested
//   and their keep bytes are written 0 (the prefix contract of
//   ops/nms.py::nms_keep_mask).
//
// The launcher returns cudaGetLastError() after its launch; it allocates
// nothing and never synchronises.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstring>

namespace {

constexpr int kTile = 64;           // boxes per row block (one uint64 word)
constexpr int kUnroll = 2;          // kept boxes a lane tests per step
constexpr int kSmemLimit = 232448;  // dynamic shared memory a CTA may use
constexpr int kMaxDevices = 64;     // devices whose settings are cached

typedef unsigned long long u64;

// Shared memory: the kept boxes and areas (20 bytes each), and the rest.
constexpr int kBytesPerKept = sizeof(float4) + sizeof(float);
constexpr int kBytesFixed = 2 * kTile * (sizeof(float4) + sizeof(float))
                            + kTile * sizeof(u64) + 8 * sizeof(unsigned);

// The threshold test `iou over thresh` of the reference, where
// iou = uni > 0 ? fl(inter / uni) : 0.
//
// * inter not > 0 (+0, or NaN from 0 * inf), or uni not > 0: iou is 0, so
//   the answer is `zero_over` and nothing is divided (the quick reject).
// * Otherwise fl(q) >= t is fl(q) > prev(t), so both conventions are
//   fl(q) > T. For 0 <= T < FLT_MAX and U = next(T), round-to-nearest-even
//   gives fl(q) > T iff q > m = (T + U) / 2, or q == m and U is even. m
//   has at most 25 significant bits and uni 24, so m * uni is exact in
//   double, and q > m is inter > m * uni: no division, the same bit.
// * Any other T (a threshold <= 0 with >=, or not finite): the division.
struct Threshold {
  float e;          // 1 for the +1-width IoU, else 0
  float thresh;
  int suppress_eq;  // >= instead of >
  int zero_over;    // is an IoU of 0 over the threshold?
  int exact;        // decide by m, tie_up
  double m;
  int tie_up;
};

__device__ __forceinline__ bool suppresses(float4 a, float aa, float4 b,
                                           float ab, const Threshold& th) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x) + th.e, 0.0f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y) + th.e, 0.0f);
  const float inter = iw * ih;
  if (!(inter > 0.0f)) return th.zero_over;
  const float uni = aa + ab - inter;
  if (!(uni > 0.0f)) return th.zero_over;
  if (th.exact) {
    const double p = th.m * static_cast<double>(uni);
    const double in = static_cast<double>(inter);
    return in > p || (in == p && th.tie_up);
  }
  const float iou = inter / uni;
  return th.suppress_eq ? iou >= th.thresh : iou > th.thresh;
}

__device__ __forceinline__ float area(float4 b, float e) {
  return (b.z - b.x + e) * (b.w - b.y + e);
}

// One CTA of kThreads per instance (blockIdx.x). The cap = min(max_keep, n)
// kept boxes live in shared memory, or with kSpill in `spill` ([groups, cap]
// boxes, then [groups, cap] areas), where they do not fit.
template <int kThreads, bool kSpill>
__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const unsigned char* __restrict__ valid, int n, Threshold th,
                int max_keep, int cap, float4* spill,
                unsigned char* __restrict__ keep) {
  constexpr int kWarps = kThreads / 32;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int nb = (n + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float4 smem[];
  const int held = kSpill ? 0 : cap;                    // kept boxes in smem
  float4* cbox = smem + held;                           // [2][64] block boxes
  u64* sup = reinterpret_cast<u64*>(cbox + 2 * kTile);  // [64] in-block masks
  float* carea = reinterpret_cast<float*>(sup + kTile);  // [2][64]
  float4* kbox = kSpill ? spill + static_cast<size_t>(blockIdx.x) * cap : smem;
  float* karea = kSpill ? reinterpret_cast<float*>(spill + static_cast<size_t>(gridDim.x) * cap) +
                              static_cast<size_t>(blockIdx.x) * cap
                        : carea + 2 * kTile;            // [cap] kept, in order
  unsigned* cvalid = reinterpret_cast<unsigned*>(carea + 2 * kTile + held);  // [2][2]
  unsigned* removed = cvalid + 4;                       // [2]
  int* kept_total = reinterpret_cast<int*>(removed + 2);

  // Stage block 0; warps 0 and 1 hold one box a thread.
  if (tid < kTile) {
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool v = false;
    if (tid < n) {
      b = boxes[base + tid];
      v = valid[base + tid] != 0;
    }
    cbox[tid] = b;
    carea[tid] = area(b, th.e);
    const unsigned bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) cvalid[tid >> 5] = bits;
    if (tid < 2) removed[tid] = 0u;
  }
  // Block j + 1 is loaded while block j - 1 is pulled, so its loads have a
  // whole block's time to land before it is staged.
  float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool next_valid = false;
  if (tid < kTile && kTile + tid < n) {
    next = boxes[base + kTile + tid];
    next_valid = valid[base + kTile + tid] != 0;
  }
  __syncthreads();

  int total = 0;   // boxes kept so far
  int done = nb;   // blocks >= done are never resolved
  for (int j = 0; j < nb; ++j) {
    const int buf = j & 1;
    const float4* cb = cbox + buf * kTile;
    const float* ca = carea + buf * kTile;

    // Pull: warp w takes boxes c = w, w + kWarps, ...; its lanes test box c
    // against 32 * kUnroll kept boxes at a time and stop at the first hit.
    // A box that survives gets its in-block mask: bit t of sup[c] iff box
    // t < c of the block suppresses it.
    for (int c = warp; c < kTile; c += kWarps) {
      if (!((cvalid[2 * buf + (c >> 5)] >> (c & 31)) & 1u)) continue;
      const float4 b = cb[c];
      const float a = ca[c];
      bool hit = false;
      for (int m0 = 0; m0 < total && !hit; m0 += 32 * kUnroll) {
        bool h = false;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int m = m0 + 32 * u + lane;
          h |= m < total && suppresses(kbox[m], karea[m], b, a, th);
        }
        hit = __any_sync(0xffffffffu, h);
      }
      if (hit) {
        if (lane == 0) atomicOr(&removed[c >> 5], 1u << (c & 31));
        continue;
      }
      const bool lo = lane < c && suppresses(cb[lane], ca[lane], b, a, th);
      const bool hi = lane + 32 < c && suppresses(cb[lane + 32], ca[lane + 32], b, a, th);
      const unsigned mlo = __ballot_sync(0xffffffffu, lo);
      const unsigned mhi = __ballot_sync(0xffffffffu, hi);
      if (lane == 0) sup[c] = (static_cast<u64>(mhi) << 32) | mlo;
    }
    if (tid < kTile) {
      cbox[(buf ^ 1) * kTile + tid] = next;
      carea[(buf ^ 1) * kTile + tid] = area(next, th.e);
      const unsigned vbits = __ballot_sync(0xffffffffu, next_valid);
      if (lane == 0) cvalid[2 * (buf ^ 1) + (tid >> 5)] = vbits;
      next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      next_valid = false;
      const int i_next = (j + 2) * kTile + tid;
      if (i_next < n) {
        next = boxes[base + i_next];
        next_valid = valid[base + i_next] != 0;
      }
    }
    __syncthreads();

    if (tid < 32) {
      // Resolve block j: the greedy answer is the one fixed point of
      // a = cand & ~(sup^T a), since sup[t] holds only boxes before t; from
      // a = cand each round fixes at least one more box, and a round that
      // changes nothing ends it. Lane l holds boxes l and l + 32.
      const u64 cand = ((static_cast<u64>(cvalid[2 * buf + 1]) << 32) | cvalid[2 * buf]) &
                       ~((static_cast<u64>(removed[1]) << 32) | removed[0]);
      const bool c0 = (cand >> lane) & 1ULL;
      const bool c1 = (cand >> (lane + 32)) & 1ULL;
      const u64 s0 = c0 ? sup[lane] : 0ULL;
      const u64 s1 = c1 ? sup[lane + 32] : 0ULL;
      u64 kept = cand;
      for (;;) {
        const u64 next_kept =
            (static_cast<u64>(__ballot_sync(0xffffffffu, c1 && !(s1 & kept))) << 32) |
            __ballot_sync(0xffffffffu, c0 && !(s0 & kept));
        if (next_kept == kept) break;
        kept = next_kept;
      }
      // the cap: only the first max_keep - total of them
      while (__popcll(kept) > max_keep - total) kept &= ~(1ULL << (63 - __clzll(kept)));
      for (int h = 0; h < 2; ++h) {
        const int t = lane + 32 * h;
        const int i = j * kTile + t;
        if (i < n) keep[base + i] = static_cast<unsigned char>((kept >> t) & 1ULL);
        if ((kept >> t) & 1ULL) {
          const int pos = total + __popcll(kept & ((1ULL << t) - 1ULL));
          kbox[pos] = cb[t];
          karea[pos] = ca[t];
        }
      }
      if (lane < 2) removed[lane] = 0u;
      if (lane == 0) *kept_total = total + __popcll(kept);
    }
    __syncthreads();
    total = *kept_total;
    if (total >= max_keep) {
      done = j + 1;
      break;
    }
  }

  // keep = 0 for every box of a block never resolved
  for (int i = done * kTile + tid; i < n; i += kThreads) keep[base + i] = 0;
}

Threshold make_threshold(float thresh, int plus_one, int suppress_eq) {
  Threshold th;
  th.e = plus_one ? 1.0f : 0.0f;
  th.thresh = thresh;
  th.suppress_eq = suppress_eq;
  th.zero_over = suppress_eq ? 0.0f >= thresh : 0.0f > thresh;
  const float t = suppress_eq ? nextafterf(thresh, -INFINITY) : thresh;
  th.exact = t >= 0.0f && t < FLT_MAX;
  th.m = 0.0;
  th.tie_up = 0;
  if (th.exact) {
    const float u = nextafterf(t, INFINITY);
    unsigned bits;
    std::memcpy(&bits, &u, sizeof bits);
    th.m = (static_cast<double>(t) + static_cast<double>(u)) * 0.5;
    th.tie_up = (bits & 1u) == 0u;
  }
  return th;
}

template <int kThreads, bool kSpill>
cudaError_t launch(int dev, const float4* boxes, const unsigned char* valid,
                   int groups, int n, const Threshold& th, int max_keep,
                   int cap, float4* spill, unsigned char* keep,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kSpill ? 0 : cap) * kBytesPerKept + kBytesFixed;
  // Raised once per device and size, so that a launch inside CUDA-graph
  // capture makes no other API call. 0 stands for the default 48 KB.
  static size_t smem_allowed[kMaxDevices] = {};
  if (smem > 48 * 1024 && smem > smem_allowed[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel<kThreads, kSpill>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_allowed[dev] = smem;
  }
  nms_keep_kernel<kThreads, kSpill><<<groups, kThreads, smem, stream>>>(
      boxes, valid, n, th, max_keep, cap, spill, keep);
  return cudaGetLastError();
}

template <int kThreads>
cudaError_t launch(int dev, const float4* boxes, const unsigned char* valid,
                   int groups, int n, const Threshold& th, int max_keep,
                   int cap, float4* spill, unsigned char* keep,
                   cudaStream_t stream) {
  if (spill != nullptr)
    return launch<kThreads, true>(dev, boxes, valid, groups, n, th, max_keep,
                                  cap, spill, keep, stream);
  return launch<kThreads, false>(dev, boxes, valid, groups, n, th, max_keep,
                                 cap, nullptr, keep, stream);
}

// The SM count of device dev, read once.
cudaError_t sm_count(int dev, int* sms) {
  static int cached[kMaxDevices] = {};
  if (cached[dev] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Most boxes an instance may keep (min(max_keep, N)) in one CTA's shared
// memory, at 20 bytes each; past it the caller passes spill scratch.
int frcnn_nms_max_kept() { return (kSmemLimit - kBytesFixed) / kBytesPerKept; }

// boxes [groups, n, 4] f32 (16-byte aligned), valid/keep [groups, n] bytes.
// Each instance keeps at most max_keep boxes (>= 1); pass n or more for no
// cap. spill: NULL, or where min(max_keep, n) > frcnn_nms_max_kept(),
// 20 * groups * min(max_keep, n) bytes of device scratch, 16-byte aligned.
// The stream belongs to the current device. Few instances get CTAs of 1024
// threads, many get smaller ones, so that all of them fit on the device's
// SMs at once where they can.
int frcnn_nms_keep(const void* boxes, const void* valid, int groups, int n,
                   float thresh, int plus_one, int suppress_eq, int max_keep,
                   void* spill, void* keep, void* stream) {
  if (groups <= 0 || n <= 0) return 0;
  const int cap = max_keep < n ? max_keep : n;
  if (max_keep < 1 || ((cap > frcnn_nms_max_kept()) != (spill != nullptr)))
    return cudaErrorInvalidValue;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  auto* sp = static_cast<float4*>(spill);
  const auto* b = static_cast<const float4*>(boxes);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* k = static_cast<unsigned char*>(keep);
  const Threshold th = make_threshold(thresh, plus_one, suppress_eq);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups <= sms) return launch<1024>(dev, b, v, groups, n, th, max_keep, cap, sp, k, s);
  if (groups <= 2 * sms) return launch<512>(dev, b, v, groups, n, th, max_keep, cap, sp, k, s);
  return launch<256>(dev, b, v, groups, n, th, max_keep, cap, sp, k, s);
}

}  // extern "C"
