// The dense levels' epilogue for Hopper (sm_90a), bound through a plain C ABI
// (ctypes): one pass over a dense conv's fresh output that applies the
// level's mask, eval BatchNorm, the block's residual and ReLU in place.
//
// It replaces no TPU kernel: the JAX package leaves the dense levels of the
// sparse backbone (DENSE_FROM_LEVEL on) to XLA, which fuses this tail into
// the conv's consumer. In PyTorch the same arithmetic was a chain of
// elementwise operations (masked_fill, a float32 copy, multiply, add, where,
// the cast back, ReLU; add, ReLU and masked_fill again after a block's
// second conv), each a pass over a map of B x C x D x H x W, most of them
// broadcasting the (B, D, H, W) mask over the channels.
//
// For y (B, C, S) channels-first and contiguous (S = D*H*W, or H*W), the
// mask m (B, S) bool, eval BN's per-channel scale k and shift s (float32):
//   out = m ? act(r(r(y*k + s) + identity)) : 0     (with an identity)
//   out = m ? act(r(y*k + s)) : 0                   (without)
// written over y. r rounds to the tensor's type (round to nearest even for
// bf16, nothing for float32); y*k + s is a float32 multiply then a float32
// add (two roundings, no FMA); the residual is added in float32 and rounded
// again; act is ReLU or nothing. This is what the PyTorch chain computes,
// element for element.
//
// Bound: bytes. y read and written once, the identity read once, the mask
// once per sample (its 1-byte row serves the sample's C channel rows from
// L2); the arithmetic is a few operations an element.
// Design: a block takes a tile of one (b, c) row, so k and s are read once
// per run and the mask row of sample b stays in L2 while the blocks of its
// channels pass. Each thread moves 16 bytes at a time (8 bf16 or 4 float32
// of one run) with UNROLL loads in flight before it computes, and one 8- or
// 4-byte mask load serves those elements. y and the identity are streamed
// (evict-first loads and stores), so the mask keeps its place in L2. Where S
// is not a multiple of the vector or a pointer is not aligned to it, the
// same kernel runs one element a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// bf16 kept as its 16 bits, so vector unions stay trivial
struct BF16 {
  using store = unsigned short;
  static __device__ __forceinline__ float load(store b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  static __device__ __forceinline__ store round(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  static __device__ __forceinline__ store zero() { return 0; }
};

struct F32 {
  using store = float;
  static __device__ __forceinline__ float load(store f) { return f; }
  static __device__ __forceinline__ store round(float f) { return f; }
  static __device__ __forceinline__ store zero() { return 0.0f; }
};

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<1> { using type = unsigned char; };

template <typename T, int N>
union Pack {
  typename Raw<sizeof(T) * N>::type raw;
  T v[N];
};

template <class D, bool IDENT, bool RELU>
__device__ __forceinline__ typename D::store one(typename D::store x,
                                                 typename D::store i,
                                                 unsigned char m, float k,
                                                 float s) {
  typename D::store r = D::round(__fadd_rn(__fmul_rn(D::load(x), k), s));
  if (IDENT) r = D::round(__fadd_rn(D::load(r), D::load(i)));
  // a NaN passes ReLU, as torch.relu lets it
  if (!m || (RELU && D::load(r) < 0.0f)) return D::zero();
  return r;
}

// One tile = kThreads * kUnroll vectors of one (b, c) row of nvec vectors;
// rows run b-major, so row / channels is the sample.
template <class D, int VEC, bool IDENT, bool RELU>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(typename D::store* __restrict__ y,
                    const typename D::store* __restrict__ identity,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, long long nvec,
                    int channels, long long tiles_per_row, long long tiles) {
  using P = Pack<typename D::store, VEC>;
  using M = Pack<unsigned char, VEC>;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row = t / tiles_per_row;
    const long long v0 =
        (t - row * tiles_per_row) * (kThreads * kUnroll) + threadIdx.x;
    const float k = __ldg(scale + row % channels);
    const float s = __ldg(shift + row % channels);
    P* yr = reinterpret_cast<P*>(y) + row * nvec;
    const P* ir = reinterpret_cast<const P*>(identity) + row * nvec;
    const M* mr = reinterpret_cast<const M*>(mask) + (row / channels) * nvec;
    P xv[kUnroll], iv[kUnroll];
    M mv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nvec) {
        xv[u].raw = __ldcs(&yr[v].raw);
        if (IDENT) iv[u].raw = __ldcs(&ir[v].raw);
        mv[u].raw = __ldg(&mr[v].raw);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nvec) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = one<D, IDENT, RELU>(xv[u].v[j], IDENT ? iv[u].v[j] : xv[u].v[j],
                                       mv[u].v[j], k, s);
        __stcs(&yr[v].raw, o.raw);
      }
    }
  }
}

template <class D, int VEC>
int launch(void* y, const void* identity, const void* mask, const float* scale,
           const float* shift, long long rows, long long spatial, int channels,
           int relu, cudaStream_t stream) {
  using S = typename D::store;
  const long long nvec = spatial / VEC;
  const long long tiles_per_row =
      (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long tiles = rows * tiles_per_row;
  const unsigned grid =
      static_cast<unsigned>(tiles < 0x7fffffffLL ? tiles : 0x7fffffffLL);
  S* yp = static_cast<S*>(y);
  const S* ip = static_cast<const S*>(identity);
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  const int sel = (identity != nullptr) * 2 + (relu != 0);
  switch (sel) {
    case 0:
      epilogue_kernel<D, VEC, false, false><<<grid, kThreads, 0, stream>>>(
          yp, ip, mp, scale, shift, nvec, channels, tiles_per_row, tiles);
      break;
    case 1:
      epilogue_kernel<D, VEC, false, true><<<grid, kThreads, 0, stream>>>(
          yp, ip, mp, scale, shift, nvec, channels, tiles_per_row, tiles);
      break;
    case 2:
      epilogue_kernel<D, VEC, true, false><<<grid, kThreads, 0, stream>>>(
          yp, ip, mp, scale, shift, nvec, channels, tiles_per_row, tiles);
      break;
    default:
      epilogue_kernel<D, VEC, true, true><<<grid, kThreads, 0, stream>>>(
          yp, ip, mp, scale, shift, nvec, channels, tiles_per_row, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// In place over y (rows = B*C runs of `spatial` elements, channels-first,
// contiguous): the mask (B, spatial) bool, scale / shift (C,) float32, the
// identity (same layout as y) or null. dtype: 0 float32, 1 bf16. vector: 1
// for 16-byte accesses (spatial a multiple of 16 bytes' worth of elements,
// y, identity and mask aligned to it), 0 for one element a thread.
int fp_dense_epilogue(void* y, const void* identity, const void* mask,
                      const float* scale, const float* shift, long long rows,
                      long long spatial, int channels, int dtype, int vector,
                      int relu, void* stream) {
  if (rows <= 0 || spatial <= 0 || channels <= 0 || rows % channels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vector ? launch<BF16, 8>(y, identity, mask, scale, shift, rows,
                                    spatial, channels, relu, st)
                  : launch<BF16, 1>(y, identity, mask, scale, shift, rows,
                                    spatial, channels, relu, st);
  if (dtype == 0)
    return vector ? launch<F32, 4>(y, identity, mask, scale, shift, rows,
                                   spatial, channels, relu, st)
                  : launch<F32, 1>(y, identity, mask, scale, shift, rows,
                                   spatial, channels, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
