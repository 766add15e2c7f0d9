// Union-window sparse convolution and its weight gradient for Hopper
// (sm_90a): the two kernels that the TransFusion training step adds to the
// position-gather pair, bound through a plain C ABI (ctypes).
//
// K3 fp_windowed_conv replaces findnpropagate_tpu/ops/pallas_sparse.py
//    _fused_kernel (:39; _fused_call :173, pallas_call :228).
//    For each target and tap k: the source row whose id equals
//    tgt + delta_k inside the target block's window
//    src[lo_b : lo_b + window), times W[k], summed over the taps in f32
//    (bf16 operands), then optionally *scale + shift, ReLU, and zero where
//    the target id >= sentinel. The transposed conv of the backward pass is
//    the same kernel on swapped id lists, negated deltas and W[k]^T.
//    Bound: 2*K*Cin*Cout flop per target against ~(K*Cin*4 gathered +
//    Cout*4 written) bytes — below the card's ridge at 16 channels (bytes),
//    above it from 64 channels on (operations). Design: the TPU kernel
//    aligns ids by a one-hot compare of the whole window against the block
//    (a (window, block) plane per tap, fed to the MXU); here each target
//    binary-searches the same window slice, log2(window) ~ 13 steps, which
//    finds the same row because the ids ascend strictly. One 256-thread
//    block takes 32 targets x all Cout; per pass of 3 taps, 96 threads
//    search, the block gathers the found rows (coalesced along C) into a
//    32 x 3Cin bf16 tile and stages the 3 taps' weights in shared memory
//    (dynamic, up to 3*Cin*Cout*2 bytes), and each thread accumulates its
//    (rows, cout) outputs in f32 registers. The 512-aligned DMA windows,
//    8-row channel padding, tap sub-windows, sub-blocks and tap unrolling
//    of the TPU kernel shrink its compare plane only and are not carried
//    over. Products run on the CUDA cores (FMA): simple first.
//
// K4 fp_windowed_dw replaces pallas_sparse.py _dw_kernel (:285; _dw_call
//    :345, pallas_call :380).
//    dW[k] = sum over samples and targets of gathered_k^T . g, (K, Cin,
//    Cout) f32 from bf16 operands.
//    Bound: operations (2*Cin*Cout flop per neighbour found against
//    Cin*4 + Cout*4 bytes read). Design: the TPU keeps the whole (K*Cin,
//    Cout) block resident across a sequential grid; here blocks run in any
//    order and the whole dW does not fit one, so the grid splits over
//    (tap) x (chunk of targets) x (sample). A block holds its tap's
//    Cin x Cout partial sum in registers (up to 32 per thread), walks its
//    chunk 32 targets at a time (search, gather the found rows and the g
//    rows into shared memory as bf16, rank-32 update; targets whose tap
//    misses are skipped), and writes one partial. A second kernel sums the
//    partials in chunk order, so the result is the same from run to run —
//    no atomics.
//
// Every entry launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;        // targets per pass
constexpr int kThreads = 256;
constexpr int kTaps = 3;         // taps per pass of the conv kernel
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 128;
constexpr int kMaxRows = kTile * kMaxCout / kThreads;  // conv accumulators
constexpr int kMaxDwCout = 256;
constexpr int kMaxDwAcc = 32;    // dW accumulators per thread

// Row of `want` in the ascending window a[0:n), or -1.
__device__ __forceinline__ int find_row(const int* __restrict__ a, int n,
                                        int want) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < want) lo = mid + 1; else hi = mid;
  }
  return (lo < n && a[lo] == want) ? lo : -1;
}

__global__ void __launch_bounds__(kThreads)
windowed_conv_kernel(const int* __restrict__ src,
                     const float* __restrict__ feats,
                     const int* __restrict__ tgt, const int* __restrict__ lo,
                     const int* __restrict__ deltas,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ out,
                     int vs, int vt, int nb, int k_n, int block, int window,
                     int cin, int cout, int epilogue, int relu,
                     int sentinel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* tile = wsm + (size_t)kTaps * cin * cout;
  __shared__ int rows[kTile * kTaps];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int co = tid % cout;
  const int r0 = tid / cout;
  const int rstep = kThreads / cout;
  const int n_rows = kTile / rstep;
  const int lo_b = lo[b * nb + t0 / block];
  const int* win = src + (size_t)b * vs + lo_b;
  const int* tgtb = tgt + (size_t)b * vt;
  const float* fb = feats + (size_t)b * vs * cin;

  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < k_n; k0 += kTaps) {
    const int nt = min(kTaps, k_n - k0);
    const int kc = nt * cin;
    if (tid < kTile * kTaps) {
      const int row = tid / kTaps, j = tid % kTaps;
      int s = -1;
      if (j < nt) {
        const int r = find_row(win, window, tgtb[t0 + row] + deltas[k0 + j]);
        if (r >= 0) s = lo_b + r;
      }
      rows[tid] = s;
    }
    const __nv_bfloat16* wk = w + (size_t)k0 * cin * cout;
    for (int e = tid; e < kc * cout; e += kThreads) wsm[e] = wk[e];
    __syncthreads();
    for (int e = tid; e < kTile * kc; e += kThreads) {
      const int row = e / kc, rem = e - row * kc;
      const int j = rem / cin, c = rem - j * cin;
      const int s = rows[row * kTaps + j];
      tile[e] = __float2bfloat16(s >= 0 ? fb[(size_t)s * cin + c] : 0.f);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float wv = __bfloat162float(wsm[kk * cout + co]);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < n_rows)
          acc[r] += __bfloat162float(tile[(r0 + r * rstep) * kc + kk]) * wv;
      }
    }
    __syncthreads();
  }

  float* outb = out + (size_t)b * vt * cout;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < n_rows) {
      const int t = t0 + r0 + r * rstep;
      float v = acc[r];
      if (epilogue) {
        v = v * scale[co] + shift[co];
        if (relu) v = fmaxf(v, 0.f);
        if (tgtb[t] >= sentinel) v = 0.f;
      }
      outb[(size_t)t * cout + co] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
windowed_dw_kernel(const int* __restrict__ src,
                   const float* __restrict__ feats,
                   const int* __restrict__ tgt, const float* __restrict__ g,
                   const int* __restrict__ lo, const int* __restrict__ deltas,
                   float* __restrict__ partial, int vs, int vt, int nb,
                   int k_n, int block, int window, int cin, int cout,
                   int chunk) {
  __shared__ __nv_bfloat16 fsm[kTile * kMaxCin];
  __shared__ __nv_bfloat16 gsm[kTile * kMaxDwCout];
  __shared__ int rows[kTile];
  __shared__ int any_hit;

  const int k = blockIdx.x;
  const int ch = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = vt / chunk;
  const int tid = threadIdx.x;
  const int co = tid % cout;
  const int c0 = tid / cout;
  const int cstep = kThreads / cout;
  const int n_acc = (cin + cstep - 1) / cstep;
  const int delta = deltas[k];
  const int* srcb = src + (size_t)b * vs;
  const int* tgtb = tgt + (size_t)b * vt;
  const float* fb = feats + (size_t)b * vs * cin;
  const float* gb = g + (size_t)b * vt * cout;

  float acc[kMaxDwAcc];
#pragma unroll
  for (int j = 0; j < kMaxDwAcc; ++j) acc[j] = 0.f;

  for (int t0 = ch * chunk; t0 < (ch + 1) * chunk; t0 += kTile) {
    if (tid == 0) any_hit = 0;
    __syncthreads();
    if (tid < kTile) {
      const int t = t0 + tid;
      const int lo_b = lo[b * nb + t / block];
      const int r = find_row(srcb + lo_b, window, tgtb[t] + delta);
      rows[tid] = r >= 0 ? lo_b + r : -1;
      if (r >= 0) any_hit = 1;
    }
    __syncthreads();
    if (any_hit) {
      for (int e = tid; e < kTile * cin; e += kThreads) {
        const int row = e / cin, c = e - row * cin;
        const int s = rows[row];
        fsm[e] = __float2bfloat16(s >= 0 ? fb[(size_t)s * cin + c] : 0.f);
      }
      for (int e = tid; e < kTile * cout; e += kThreads)
        gsm[e] = __float2bfloat16(gb[(size_t)t0 * cout + e]);
      __syncthreads();
      for (int t = 0; t < kTile; ++t) {
        if (rows[t] < 0) continue;
        const float gv = __bfloat162float(gsm[t * cout + co]);
#pragma unroll
        for (int j = 0; j < kMaxDwAcc; ++j) {
          if (j < n_acc) {
            const int c = c0 + j * cstep;
            if (c < cin) acc[j] += __bfloat162float(fsm[t * cin + c]) * gv;
          }
        }
      }
    }
    __syncthreads();
  }

  float* p = partial
      + (((size_t)b * n_chunks + ch) * k_n + k) * (size_t)cin * cout;
#pragma unroll
  for (int j = 0; j < kMaxDwAcc; ++j) {
    if (j < n_acc) {
      const int c = c0 + j * cstep;
      if (c < cin) p[(size_t)c * cout + co] = acc[j];
    }
  }
}

__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dw, int n_partials,
                                 int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < n_partials; ++i) s += partial[(size_t)i * n + e];
  dw[e] = s;
}

}  // namespace

extern "C" {

// out (B, Vt, Cout) f32 from src ids (B, Vs), feats (B, Vs, Cin) f32, tgt
// ids (B, Vt), lo (B, nb) window starts, deltas (K,), w (K*Cin, Cout) bf16
// with row k*Cin + c. Cin <= 128; Cout a power of two in [8, 128];
// block % 32 == 0; Vt % block == 0 (checked by the caller).
int fp_windowed_conv(const int* src, const float* feats, const int* tgt,
                     const int* lo, const int* deltas, const void* w,
                     const float* scale, const float* shift, float* out,
                     int batch, int vs, int vt, int nb, int k_n, int block,
                     int window, int cin, int cout, int epilogue, int relu,
                     int sentinel, void* stream) {
  const size_t smem = ((size_t)kTaps * cin * cout
                       + (size_t)kTile * kTaps * cin) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      windowed_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(vt / kTile), batch);
  windowed_conv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      src, feats, tgt, lo, deltas, (const __nv_bfloat16*)w, scale, shift,
      out, vs, vt, nb, k_n, block, window, cin, cout, epilogue, relu,
      sentinel);
  return (int)cudaGetLastError();
}

// dw (K, Cin, Cout) f32 from feats (B, Vs, Cin) f32 and g (B, Vt, Cout)
// f32, through partial (B * Vt / chunk, K, Cin, Cout) f32 scratch.
// Cout a power of two in [8, 256]; Cin <= 128 and Cin * Cout <= 8192;
// chunk % 32 == 0, block % 32 == 0, Vt % chunk == 0.
int fp_windowed_dw(const int* src, const float* feats, const int* tgt,
                   const float* g, const int* lo, const int* deltas,
                   float* partial, float* dw, int batch, int vs, int vt,
                   int nb, int k_n, int block, int window, int cin, int cout,
                   int chunk, void* stream) {
  const int n_chunks = vt / chunk;
  dim3 grid(k_n, n_chunks, batch);
  windowed_dw_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, feats, tgt, g, lo, deltas, partial, vs, vt, nb, k_n, block,
      window, cin, cout, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = k_n * cin * cout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partial, dw, batch * n_chunks, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
