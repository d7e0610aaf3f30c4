// The epilogue of a convolution as one pass over its output, forward and
// backward, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves the conv's epilogue to
// XLA, which fuses it into the convolution. In PyTorch each step of it is a
// pass of its own over the conv output (FrozenBN's multiply and add, or the
// conv's bias add; the Bottleneck's residual add; the ReLU; mask_valid's
// select), and on channels-last activations every per-channel broadcast
// runs on PyTorch's strided, non-vectorised path. Here, per element of
// x [B, C, H, W] stored channels-last ([B, H, W, C] in memory):
//
//   y = x * s_c + t_c           FrozenBN (s, t folded from mean, var, scale,
//                               bias, eps), or prefolded s and t, or t alone
//                               (a conv's bias)
//   y = y + residual            optional (the Bottleneck's shortcut)
//   y = relu(y)                 optional
//   y = valid(b, h, w) ? y : 0  optional: h < valid_hw[b, 0], w < valid_hw[b, 1]
//
// and backward, from the output's gradient g (and y, where there was a ReLU):
//
//   g = valid(b, h, w) ? g : 0;  g = y <= 0 ? 0 : g;  grad_s = g;
//   grad_x = g * s_c
//
// Bit-equal to the plain composition. Every rounding of the PyTorch ops
// happens here too, in their order: the fold in float32 as
// FrozenBatchNorm.forward runs it (IEEE division and square root), s and t
// rounded to the activation's type, then the product rounded, the sum
// rounded, the residual sum rounded; bf16 values are computed in float32
// and rounded to nearest even, as PyTorch's bf16 kernels do. The build's
// -fmad=false forbids contracting a product and a sum; the intrinsics below
// say the same where it matters. The ReLU is clamp_min's `isnan(v) ? v :
// max(v, 0)` and its gradient threshold_backward's `y <= 0 ? 0 : g`.
//
// What bounds it on this card: bytes. It reads x (and the residual) and
// writes y once, a few operations an element, far below the card's 295
// operations a byte. The design moves each byte once, 16 bytes a thread an
// access (8 bf16, 4 float32 or 2 float64 channels), neighbouring threads
// on neighbouring addresses; each thread keeps kUnroll vectors in flight
// (loads first, then the arithmetic), so a block of 512 threads holds 32 KB
// of loads in flight (64 KB with a residual). A block folds the per-channel
// constants once into shared memory; the pixel index and its (b, h, w),
// needed for the mask and for a strided residual, come from multiplicative
// division, not the slow integer divide. Blocks walk the vectors with a
// grid stride, two blocks an SM.
//
// The launchers return cudaGetLastError() after their launch; they allocate
// nothing and never synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 2;         // vectors a thread loads before computing
constexpr int kBlocksPerSm = 2;
constexpr int kMaxDevices = 64;    // devices whose SM count is cached

enum DType { kBF16 = 0, kF32 = 1, kF64 = 2 };

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery): m = ceil(2^p / d), p = 31 + ceil(log2 d).
struct Divider {
  unsigned d, mul, shr;

  static Divider make(unsigned d) {
    Divider v{d, 0u, 0u};
    if (d > 1) {
      unsigned l = 0;
      while ((1ull << l) < d) ++l;
      const unsigned p = 31 + l;
      v.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
      v.shr = p - 32;
    }
    return v;
  }

  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shr;
  }
};

// The element types, each with the type its arithmetic runs in: mul and
// add round to that type, round2 rounds a pair of results to T (keeping
// them in the arithmetic type), round one; store takes a value that is
// already a T.
template <typename T> struct Num;

template <> struct Num<__nv_bfloat16> {
  using C = float;
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(v) >> 16));
  }
  // cvt.rn.bf16x2.f32, one instruction a pair: PyTorch's float -> bf16
  // rounding (to nearest, ties to even; NaN to 0x7fff)
  static __device__ __forceinline__ void round2(float& a, float& b) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    a = __low2float(p);
    b = __high2float(p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }
};

template <> struct Num<float> {
  using C = float;
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ void round2(float&, float&) {}
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }
};

template <> struct Num<double> {
  using C = double;
  static __device__ __forceinline__ double load(double v) { return v; }
  static __device__ __forceinline__ double store(double v) { return v; }
  static __device__ __forceinline__ void round2(double&, double&) {}
  static __device__ __forceinline__ double round(double v) { return v; }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double relu(double v) { return isnan(v) ? v : fmax(v, 0.0); }
};

// 16 bytes of T.
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__device__ __forceinline__ Vec<T> ldg(const Vec<T>* p) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const Vec<T>*>(&raw);
}

// What both kernels share: the shape, the per-channel constants and the
// mask.
struct Shape {
  int b, c, h, w;
  unsigned n_vec;             // b * h * w * c / V
  Divider per_pixel;          // c / V vectors a pixel
  Divider per_image;          // h * w pixels an image
  Divider per_row;            // w pixels a row
  int valid_stride;           // elements from one image's valid_hw row to the next
};

struct Constants {
  const void* scale;          // fold: float32 scale; else T scale or null
  const void* shift;          // fold: float32 bias; else T shift or null
  const float* mean;          // fold only
  const float* var;           // fold only
  float eps;                  // the buffers' eps, already rounded to float32
};

// s and t of every channel into shared memory, in the arithmetic type,
// each rounded through T as the plain path's .to(x.dtype) rounds it.
template <typename T>
__device__ void fold_constants(const Constants& k, int channels,
                               typename Num<T>::C* s_sh,
                               typename Num<T>::C* t_sh) {
  using N = Num<T>;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    if (k.mean != nullptr) {
      const float* scale = static_cast<const float*>(k.scale);
      const float* bias = static_cast<const float*>(k.shift);
      const float inv = __fdiv_rn(scale[c], __fsqrt_rn(__fadd_rn(k.var[c], k.eps)));
      s_sh[c] = N::round(static_cast<typename N::C>(inv));
      if (bias != nullptr) {   // the backward needs s alone
        const float shift = __fsub_rn(bias[c], __fmul_rn(k.mean[c], inv));
        t_sh[c] = N::round(static_cast<typename N::C>(shift));
      }
    } else {
      s_sh[c] = k.scale ? N::load(static_cast<const T*>(k.scale)[c]) : 1;
      t_sh[c] = k.shift ? N::load(static_cast<const T*>(k.shift)[c]) : 0;
    }
  }
}

// Whether pixel p lies inside its image's valid extent, and its (b, h, w).
struct Pixel {
  unsigned b, h, w;
};

__device__ __forceinline__ Pixel pixel_of(const Shape& s, unsigned p) {
  Pixel q;
  q.b = s.per_image.div(p);
  const unsigned r = p - q.b * s.per_image.d;
  q.h = s.per_row.div(r);
  q.w = r - q.h * s.per_row.d;
  return q;
}

__device__ __forceinline__ bool inside(const Shape& s, const float* valid_hw, const Pixel& q) {
  const float* row = valid_hw + static_cast<size_t>(q.b) * s.valid_stride;
  return static_cast<float>(q.h) < __ldg(row) && static_cast<float>(q.w) < __ldg(row + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
frcnn_epilogue_elementwise_fwd(const Vec<T>* __restrict__ x, Vec<T>* __restrict__ y,
                               Shape s, Constants k, const Vec<T>* __restrict__ res,
                               long long rs_b, long long rs_h, long long rs_w,
                               int res_dense, const float* __restrict__ valid_hw,
                               int relu) {
  using N = Num<T>;
  using C = typename N::C;
  constexpr int V = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* s_sh = reinterpret_cast<C*>(smem_raw);
  C* t_sh = s_sh + s.c;
  const bool has_scale = k.mean != nullptr || k.scale != nullptr;
  const bool has_shift = k.mean != nullptr || k.shift != nullptr;
  if (has_scale || has_shift) {
    fold_constants<T>(k, s.c, s_sh, t_sh);
    __syncthreads();
  }
  const bool need_pixel = valid_hw != nullptr || (res != nullptr && !res_dense);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       base < s.n_vec; base += stride) {
    Vec<T> xv[kUnroll], rv[kUnroll];
    unsigned cv[kUnroll];
    bool keep[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      keep[u] = true;
      if (i < s.n_vec) {
        const unsigned iu = static_cast<unsigned>(i);
        const unsigned p = s.per_pixel.div(iu);
        cv[u] = iu - p * s.per_pixel.d;
        xv[u] = ldg(x + i);
        if (need_pixel) {
          const Pixel q = pixel_of(s, p);
          if (valid_hw != nullptr) keep[u] = inside(s, valid_hw, q);
          if (res != nullptr && !res_dense)
            rv[u] = ldg(res + (q.b * rs_b + q.h * rs_h + q.w * rs_w + cv[u]));
        }
        if (res != nullptr && res_dense) rv[u] = ldg(res + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i >= s.n_vec) continue;
      Vec<T> out;
#pragma unroll
      for (int e = 0; e < V; e += 2) {   // a pair of channels at a time
        C a = N::load(xv[u].v[e]), b = N::load(xv[u].v[e + 1]);
        const int c = cv[u] * V + e;
        if (has_scale) {
          a = N::mul(a, s_sh[c]);
          b = N::mul(b, s_sh[c + 1]);
          N::round2(a, b);
        }
        if (has_shift) {
          a = N::add(a, t_sh[c]);
          b = N::add(b, t_sh[c + 1]);
          N::round2(a, b);
        }
        if (res != nullptr) {
          a = N::add(N::load(rv[u].v[e]), a);
          b = N::add(N::load(rv[u].v[e + 1]), b);
          N::round2(a, b);
        }
        if (relu) {
          a = N::relu(a);
          b = N::relu(b);
        }
        out.v[e] = N::store(keep[u] ? a : C(0));
        out.v[e + 1] = N::store(keep[u] ? b : C(0));
      }
      y[i] = out;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
frcnn_epilogue_elementwise_bwd(const Vec<T>* __restrict__ grad, const Vec<T>* __restrict__ y,
                               Vec<T>* __restrict__ grad_x, Vec<T>* __restrict__ grad_s,
                               Shape s, Constants k, const float* __restrict__ valid_hw) {
  using N = Num<T>;
  using C = typename N::C;
  constexpr int V = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* s_sh = reinterpret_cast<C*>(smem_raw);
  C* t_sh = s_sh + s.c;
  const bool has_scale = k.mean != nullptr || k.scale != nullptr;
  if (has_scale) {
    fold_constants<T>(k, s.c, s_sh, t_sh);
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       base < s.n_vec; base += stride) {
    Vec<T> gv[kUnroll], yv[kUnroll];
    unsigned cv[kUnroll];
    bool keep[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      keep[u] = true;
      if (i < s.n_vec) {
        const unsigned iu = static_cast<unsigned>(i);
        const unsigned p = s.per_pixel.div(iu);
        cv[u] = iu - p * s.per_pixel.d;
        gv[u] = ldg(grad + i);
        if (y != nullptr) yv[u] = ldg(y + i);
        if (valid_hw != nullptr) keep[u] = inside(s, valid_hw, pixel_of(s, p));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i >= s.n_vec) continue;
      Vec<T> gs, gx;
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        C g[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          g[j] = keep[u] ? N::load(gv[u].v[e + j]) : C(0);
          if (y != nullptr && N::load(yv[u].v[e + j]) <= C(0)) g[j] = C(0);
          gs.v[e + j] = N::store(g[j]);
        }
        if (has_scale) {
          C a = N::mul(g[0], s_sh[cv[u] * V + e]);
          C b = N::mul(g[1], s_sh[cv[u] * V + e + 1]);
          N::round2(a, b);
          gx.v[e] = N::store(a);
          gx.v[e + 1] = N::store(b);
        } else {
          gx.v[e] = gs.v[e];
          gx.v[e + 1] = gs.v[e + 1];
        }
      }
      grad_x[i] = gx;
      if (grad_s != nullptr) grad_s[i] = gs;
    }
  }
}

// The SM count of device dev, read once.
cudaError_t sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

// The shape's dividers and the launch's grid and shared memory; false
// where the kernel does not take the shape.
template <typename T>
bool plan(int b, int c, int h, int w, int valid_stride, bool constants, Shape* s,
          int* grid, size_t* smem, int sms) {
  constexpr int V = Vec<T>::kN;
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0 || c % V != 0) return false;
  const long long pixels = static_cast<long long>(b) * h * w;
  const long long n_vec = pixels * (c / V);
  if (n_vec >= (1ll << 31)) return false;
  *smem = constants ? 2 * static_cast<size_t>(c) * sizeof(typename Num<T>::C) : 0;
  if (*smem > 48 * 1024) return false;
  s->b = b; s->c = c; s->h = h; s->w = w;
  s->n_vec = static_cast<unsigned>(n_vec);
  s->per_pixel = Divider::make(c / V);
  s->per_image = Divider::make(static_cast<unsigned>(h) * w);
  s->per_row = Divider::make(w);
  s->valid_stride = valid_stride;
  const long long blocks = (n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  *grid = static_cast<int>(blocks < kBlocksPerSm * sms ? blocks : kBlocksPerSm * sms);
  return true;
}

template <typename T>
int forward(const void* x, void* y, int b, int c, int h, int w, const Constants& k,
            const void* residual, long long rs_b, long long rs_h, long long rs_w,
            const float* valid_hw, int valid_stride, int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  Shape s;
  int grid = 0;
  size_t smem = 0;
  const bool constants = k.mean != nullptr || k.scale != nullptr || k.shift != nullptr;
  if (!plan<T>(b, c, h, w, valid_stride, constants, &s, &grid, &smem, sms))
    return cudaErrorInvalidValue;
  if (rs_b % V || rs_h % V || rs_w % V) return cudaErrorInvalidValue;
  const long long cl_w = c, cl_h = static_cast<long long>(w) * c, cl_b = cl_h * h;
  const int dense = rs_b == cl_b && rs_h == cl_h && rs_w == cl_w;
  frcnn_epilogue_elementwise_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const Vec<T>*>(x), static_cast<Vec<T>*>(y), s, k,
      static_cast<const Vec<T>*>(residual), rs_b / V, rs_h / V, rs_w / V, dense,
      valid_hw, relu);
  return cudaGetLastError();
}

template <typename T>
int backward(const void* grad, const void* y, void* grad_x, void* grad_s, int b,
             int c, int h, int w, const Constants& k, const float* valid_hw,
             int valid_stride, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  Shape s;
  int grid = 0;
  size_t smem = 0;
  if (!plan<T>(b, c, h, w, valid_stride, k.mean != nullptr || k.scale != nullptr, &s, &grid,
               &smem, sms))
    return cudaErrorInvalidValue;
  frcnn_epilogue_elementwise_bwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const Vec<T>*>(grad), static_cast<const Vec<T>*>(y),
      static_cast<Vec<T>*>(grad_x), static_cast<Vec<T>*>(grad_s), s, k, valid_hw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: [b, c, h, w] channels-last (c contiguous), 16-byte aligned, of
// dtype 0 bf16, 1 float32, 2 float64; c a multiple of 16 / element size.
// Constants: with mean (and var) non-null, scale, shift, mean and var are
// a FrozenBN's float32 buffers, folded here with eps; otherwise scale and
// shift, each optional, are [c] of x's dtype. residual: null, or x's shape
// and dtype with c contiguous and its b, h, w strides (elements) given, each
// a multiple of 16 / element size. valid_hw: null, or [b, 2] float32 with
// its columns contiguous and valid_stride elements from row to row.
int frcnn_epilogue_fwd(int dtype, const void* x, void* y, int b, int c, int h, int w,
                       const void* scale, const void* shift, const void* mean,
                       const void* var, float eps, const void* residual,
                       long long rs_b, long long rs_h, long long rs_w,
                       const void* valid_hw, int valid_stride, int relu, void* stream) {
  if ((mean == nullptr) != (var == nullptr)) return cudaErrorInvalidValue;
  const Constants k{scale, shift, static_cast<const float*>(mean),
                    static_cast<const float*>(var), eps};
  const auto* v = static_cast<const float*>(valid_hw);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return forward<__nv_bfloat16>(x, y, b, c, h, w, k, residual, rs_b, rs_h, rs_w, v,
                                    valid_stride, relu, st);
    case kF32:
      return forward<float>(x, y, b, c, h, w, k, residual, rs_b, rs_h, rs_w, v, valid_stride,
                            relu, st);
    case kF64:
      return forward<double>(x, y, b, c, h, w, k, residual, rs_b, rs_h, rs_w, v, valid_stride,
                             relu, st);
    default: return cudaErrorInvalidValue;
  }
}

// grad, y (null where the forward had no ReLU), grad_x, grad_s (null where
// not wanted): [b, c, h, w] channels-last, 16-byte aligned; the constants
// and valid_hw as in frcnn_epilogue_fwd (scale null: grad_x = grad_s).
int frcnn_epilogue_bwd(int dtype, const void* grad, const void* y, void* grad_x,
                       void* grad_s, int b, int c, int h, int w, const void* scale,
                       const void* mean, const void* var, float eps,
                       const void* valid_hw, int valid_stride, void* stream) {
  if ((mean == nullptr) != (var == nullptr)) return cudaErrorInvalidValue;
  const Constants k{scale, nullptr, static_cast<const float*>(mean),
                    static_cast<const float*>(var), eps};
  const auto* v = static_cast<const float*>(valid_hw);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return backward<__nv_bfloat16>(grad, y, grad_x, grad_s, b, c, h, w, k, v, valid_stride, st);
    case kF32:
      return backward<float>(grad, y, grad_x, grad_s, b, c, h, w, k, v, valid_stride, st);
    case kF64:
      return backward<double>(grad, y, grad_x, grad_s, b, c, h, w, k, v, valid_stride, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
