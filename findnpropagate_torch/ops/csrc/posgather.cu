// Position-gather sparse convolution for Hopper (sm_90a): the two kernels of
// the TransFusion inference path, bound through a plain C ABI (ctypes).
//
// K1 fp_positions replaces findnpropagate_tpu/ops/pallas_posgather.py
//    _positions_kernel / _positions_block (:75, :125; pallas_call :185).
//    For each target and each of the G (dy, dx) group-centre deltas D_g: the
//    left-insertion rank of tgt + D_g in the target block's sorted source-id
//    (sub-)window, and a hit flag, written as hit ? rank : ~rank; blocks
//    with has_real == 0 write -1.
//    Bound: bytes. Each thread reads its target id and does a binary search
//    of log2(span) ~ 11 steps over a window that the 1024 targets of a block
//    share, so the window stays in L1/L2 and device memory sees roughly the
//    ids once plus the (G, Vt) int32 output. Design: one thread per
//    (target, group), threads consecutive in the target so reads of the
//    target ids and writes of pos coalesce; no shared memory. The TPU's
//    compare-count over the whole window (a (span, block) plane per group)
//    becomes a log-time search giving the same rank.
//
// K2 fp_posgather_conv replaces pallas_posgather.py _conv_kernel /
//    _conv_block (:194, :296; pallas_call :485).
//    For each target, its 27 neighbours are fetched through K1's ranks: in
//    group g, z-1 sits at rank-1, z at rank (only on a hit), z+1 at
//    rank+hit, each accepted only if the source id there is exactly the one
//    wanted; misses are zeros. out = sum_g W_g (Cout x 3Cin) . G_g with bf16
//    operands and f32 sums, then optionally *scale + shift, ReLU, and zero
//    where the target id >= sentinel. Dead blocks write zeros.
//    Bound: at the main path's widths the arithmetic is 27*Cin*Cout*2 flop
//    per target against ~(27*Cin*4 gathered + Cout*4 written) bytes, so the
//    16-channel convs sit below the card's ridge (bytes) and the 64->128
//    strided conv above it (operations). Design: one 256-thread block per
//    tile of 32 targets x all Cout; per group, 96 threads resolve the 3
//    z-probes of the 32 targets to source rows, the block gathers those
//    rows (coalesced along C) into a 32 x 3Cin bf16 tile in shared memory,
//    and each thread accumulates its (rows, cout) outputs in f32 registers
//    from the tile and the group's weights (read coalesced along Cout,
//    cached). Only 3*Cin*32*2 bytes of shared memory are live, never the
//    27*Cin buffer. The TPU's f32 window, 128-lane bands, stacked rows,
//    per-tile one-hot fallback and DMA rings are not carried over: the
//    probes read global memory directly. The products run on the CUDA
//    cores (FMA), not the tensor cores: simple first, fast later.
//
// Every entry launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPosThreads = 256;
constexpr int kTile = 32;        // targets per conv block
constexpr int kThreads = 256;    // threads per conv block
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 128;
constexpr int kMaxRows = kTile * kMaxCout / kThreads;  // accumulators/thread

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void positions_kernel(const int* __restrict__ src,
                                 const int* __restrict__ tgt,
                                 const int* __restrict__ lo,
                                 const int* __restrict__ tap_lo,
                                 const int* __restrict__ has_real,
                                 const int* __restrict__ gdeltas,
                                 int* __restrict__ pos, int vs, int vt,
                                 int nb, int g_n, int block, int span,
                                 int use_tap) {
  const int b = blockIdx.y;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)g_n * vt) return;
  const int g = (int)(idx / vt);
  const int t = (int)(idx % vt);
  const int i = t / block;
  const int bi = b * nb + i;
  int out = -1;
  if (has_real[bi] != 0) {
    const int off = use_tap ? tap_lo[(size_t)bi * g_n + g] : 0;
    const int* win = src + (size_t)b * vs + lo[bi] + off;
    const int want = tgt[(size_t)b * vt + t] + gdeltas[g];
    const int r = lower_bound(win, span, want);
    const bool hit = r < span && win[r] == want;
    const int rank = r + off;
    out = hit ? rank : ~rank;
  }
  pos[((size_t)b * g_n + g) * vt + t] = out;
}

__global__ void __launch_bounds__(kThreads)
conv_kernel(const int* __restrict__ src, const float* __restrict__ feats,
            const int* __restrict__ tgt, const int* __restrict__ pos,
            const int* __restrict__ lo, const int* __restrict__ has_real,
            const int* __restrict__ gdeltas,
            const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ shift,
            float* __restrict__ out, int vs, int vt, int nb, int g_n,
            int block, int window, int cin, int cout, int epilogue, int relu,
            int sentinel) {
  __shared__ __nv_bfloat16 tile[kTile * 3 * kMaxCin];
  __shared__ int rows[kTile * 3];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int bi = b * nb + t0 / block;
  const int co = tid % cout;
  const int r0 = tid / cout;
  const int rstep = kThreads / cout;
  const int n_rows = kTile / rstep;
  float* outb = out + (size_t)b * vt * cout;

  if (has_real[bi] == 0) {
    for (int e = tid; e < kTile * cout; e += kThreads)
      outb[(size_t)t0 * cout + e] = 0.f;
    return;
  }

  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

  const int k3 = 3 * cin;
  const int lo_b = lo[bi];
  const int* srcb = src + (size_t)b * vs;
  const float* fb = feats + (size_t)b * vs * cin;

  for (int g = 0; g < g_n; ++g) {
    if (tid < kTile * 3) {
      const int row = tid / 3, zi = tid % 3;
      const int t = t0 + row;
      const int p = pos[((size_t)b * g_n + g) * vt + t];
      const int hit = p >= 0;
      const int rank = hit ? p : ~p;
      const int j = zi == 0 ? rank - 1 : (zi == 1 ? rank : rank + hit);
      const int want = tgt[(size_t)b * vt + t] + gdeltas[g] + (zi - 1);
      int s = -1;
      if (j >= 0 && j < window && (zi != 1 || hit)) {
        if (srcb[lo_b + j] == want) s = lo_b + j;
      }
      rows[tid] = s;
    }
    __syncthreads();
    for (int e = tid; e < kTile * k3; e += kThreads) {
      const int row = e / k3, rem = e - row * k3;
      const int zi = rem / cin, c = rem - zi * cin;
      const int s = rows[row * 3 + zi];
      tile[e] = __float2bfloat16(s >= 0 ? fb[(size_t)s * cin + c] : 0.f);
    }
    __syncthreads();
    const __nv_bfloat16* wg = w + (size_t)g * k3 * cout + co;
    for (int k = 0; k < k3; ++k) {
      const float wv = __bfloat162float(wg[(size_t)k * cout]);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < n_rows)
          acc[r] += __bfloat162float(tile[(r0 + r * rstep) * k3 + k]) * wv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < n_rows) {
      const int t = t0 + r0 + r * rstep;
      float v = acc[r];
      if (epilogue) {
        v = v * scale[co] + shift[co];
        if (relu) v = fmaxf(v, 0.f);
        if (tgt[(size_t)b * vt + t] >= sentinel) v = 0.f;
      }
      outb[(size_t)t * cout + co] = v;
    }
  }
}

}  // namespace

extern "C" {

// pos (B, G, Vt) int32 from src ids (B, Vs), tgt ids (B, Vt), lo / has_real
// (B, nb), tap_lo (B, nb, G), gdeltas (G,). span = tap window, or the union
// window when use_tap == 0.
int fp_positions(const int* src, const int* tgt, const int* lo,
                 const int* tap_lo, const int* has_real, const int* gdeltas,
                 int* pos, int batch, int vs, int vt, int nb, int g_n,
                 int block, int span, int use_tap, void* stream) {
  const long long n = (long long)g_n * vt;
  dim3 grid((unsigned)((n + kPosThreads - 1) / kPosThreads), batch);
  positions_kernel<<<grid, kPosThreads, 0, (cudaStream_t)stream>>>(
      src, tgt, lo, tap_lo, has_real, gdeltas, pos, vs, vt, nb, g_n, block,
      span, use_tap);
  return (int)cudaGetLastError();
}

// out (B, Vt, Cout) f32 from feats (B, Vs, Cin) f32 and w (G*3*Cin, Cout)
// bf16, row g*3Cin + zi*Cin + c. Cin % 16 == 0 and <= 128; Cout a power of
// two in [8, 128]; block % 32 == 0; Vt % block == 0 (checked by the caller).
int fp_posgather_conv(const int* src, const float* feats, const int* tgt,
                      const int* pos, const int* lo, const int* has_real,
                      const int* gdeltas, const void* w, const float* scale,
                      const float* shift, float* out, int batch, int vs,
                      int vt, int nb, int g_n, int block, int window,
                      int cin, int cout, int epilogue, int relu,
                      int sentinel, void* stream) {
  dim3 grid((unsigned)(vt / kTile), batch);
  conv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, feats, tgt, pos, lo, has_real, gdeltas,
      (const __nv_bfloat16*)w, scale, shift, out, vs, vt, nb, g_n, block,
      window, cin, cout, epilogue, relu, sentinel);
  return (int)cudaGetLastError();
}

}  // extern "C"
