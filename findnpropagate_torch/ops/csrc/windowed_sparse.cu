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
//    Bound: operations at 64 channels (2*Cin*Cout flop per neighbour found
//    against Cin*2 + Cout*2 bytes read), bytes and search latency at 16 and
//    32. Design: the K taps are K/3 (dy, dx) groups of three consecutive
//    ids (z-1, z, z+1), so one search of the group's centre id in the
//    target block's window gives all three rows (the probes of K2, with the
//    same exact-id checks and window edges, so the neighbours kept and
//    dropped are those of a per-tap search). The grid is (group) x (chunk
//    of targets) x (sample), chunks sized for about three blocks per SM. A
//    256-thread block keeps its group's 3Cin x Cout f32 sum in tensor-core
//    accumulators (3 x WN m16n8k16 tiles per warp, up to 96 registers per
//    thread) and walks its chunk in tiles of 64 targets with the target
//    axis as the product's depth: dW_g += A^T (3Cin x 64) . G (64 x Cout),
//    both read with ldmatrix.trans from [target][channel] tiles. The tiles
//    (gathered rows, zero on a miss, and the g rows once for all three
//    taps) arrive by 16-byte cp.async from bf16 copies that the wrapper
//    makes, in a two-stage ring: tile i+1 is searched and in flight while
//    tile i multiplies. A tile without any neighbour is skipped. The TPU
//    keeps dW resident across a sequential grid; here each block writes one
//    partial (samples x chunks x K*Cin*Cout floats of scratch: 1 to 25 MB
//    on the training step, chosen by the wrapper) and a second kernel sums
//    the partials in a fixed order into the (K, Cin, Cout) tap order: the
//    same result from run to run, no atomics.
//
// Every entry launches on the stream it is given, allocates nothing, and
// returns the launch's error code.

#include "gather_mma.cuh"

namespace {

constexpr int kTile = 32;        // targets per pass
constexpr int kThreads = 256;
constexpr int kTaps = 3;         // taps per pass of the conv kernel
constexpr int kMaxCout = 128;
constexpr int kMaxRows = kTile * kMaxCout / kThreads;  // conv accumulators
constexpr int kDwTile = 64;      // targets per weight-gradient tile

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

// Shared memory: two stages of [gather tile: kDwTile x (3Cin + 8) bf16]
// [g tile: kDwTile x (Cout + 8) bf16], then rows: 2 x 3 x kDwTile int.
// Warps: cin/16 along the 3Cin axis (3 m-tiles each) x cout/(8 WN) along
// Cout (WN n-tiles each); warps beyond that product only gather.
template <int WN>
__global__ void __launch_bounds__(kThreads, WN >= 8 ? 1 : 2)
windowed_dw_kernel(const int* __restrict__ src,
                   const __nv_bfloat16* __restrict__ feats,
                   const int* __restrict__ tgt,
                   const __nv_bfloat16* __restrict__ g,
                   const int* __restrict__ lo,
                   const int* __restrict__ centres,
                   float* __restrict__ partial, int vs, int vt, int nb,
                   int block, int window, int cin, int cout,
                   int tiles_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int g_n = gridDim.x, n_chunks = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int a_stride = fp::tile_stride(cin);
  const int g_stride = cout * 2 + 16;
  const int a_bytes = kDwTile * a_stride, g_bytes = kDwTile * g_stride;
  const uint32_t sa = fp::smem_addr(smem);
  int* rows = reinterpret_cast<int*>(smem + 2 * (a_bytes + g_bytes));
  const int wm = cin / 16;
  const int wn = cout / (8 * WN);
  const bool active = warp < wm * wn;
  const int wmi = warp % wm, wni = warp / wm;
  const int centre_d = centres[grp];
  const int* srcb = src + (size_t)b * vs;
  const int* tgtb = tgt + (size_t)b * vt;
  const __nv_bfloat16* fb = feats + (size_t)b * vs * cin;
  const __nv_bfloat16* gb = g + (size_t)b * vt * cout;
  const int n_tiles = vt / kDwTile;
  const int tile_lo = ch * tiles_per_chunk;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_chunk);

  float acc[3][WN][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // search one tile's targets, resolve their three probes into rows[st];
  // true (for every thread) if any neighbour was found
  auto resolve = [&](int tile, int st) {
    int found = 0;
    if (tid < kDwTile) {
      const int t = tile * kDwTile + tid;
      const int lo_b = lo[b * nb + t / block];
      const int* win = srcb + lo_b;
      const int centre = tgtb[t] + centre_d;
      const int r = fp::lower_bound(win, window, centre);
      const int hit = r < window && win[r] == centre;
      int* rw = rows + st * 3 * kDwTile;
      fp::resolve_probes(win, window, lo_b, r, hit, centre, rw, kDwTile, tid);
      found = (rw[tid] >= 0) | (rw[kDwTile + tid] >= 0)
          | (rw[2 * kDwTile + tid] >= 0);
    }
    return __syncthreads_or(found);
  };
  auto start_tile = [&](int tile, int st) {
    const uint32_t a_sa = sa + st * (a_bytes + g_bytes);
    fp::gather_tile<kDwTile>(a_sa, fb, rows + st * 3 * kDwTile, cin, tid,
                             kThreads);
    const int cpr = cout >> 3;
    const __nv_bfloat16* gt = gb + (size_t)tile * kDwTile * cout;
    for (int c = tid; c < kDwTile * cpr; c += kThreads) {
      const int r = c / cpr, cc = c - r * cpr;
      fp::cp_async16(a_sa + a_bytes + r * g_stride + cc * 16,
                     gt + (size_t)r * cout + cc * 8, 16);
    }
  };

  int live = 0;
  if (tile_lo < tile_hi) {
    live = resolve(tile_lo, 0);
    if (live) start_tile(tile_lo, 0);
  }
  fp::cp_async_commit();
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int st = (tile - tile_lo) & 1;
    int live_next = 0;
    if (tile + 1 < tile_hi) {
      live_next = resolve(tile + 1, st ^ 1);
      if (live_next) start_tile(tile + 1, st ^ 1);
    }
    fp::cp_async_commit();          // possibly empty: keeps the count even
    fp::cp_async_wait<1>();
    __syncthreads();
    if (live && active) {
      const uint32_t a_sa = sa + st * (a_bytes + g_bytes);
      const uint32_t g_sa = a_sa + a_bytes;
#pragma unroll
      for (int kt = 0; kt < kDwTile / 16; ++kt) {
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int c0 = (wmi * 3 + i) * 16;
          fp::ldmatrix_x4_trans(
              a[i], a_sa
              + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * a_stride
              + (c0 + ((lane >> 3) & 1) * 8) * 2);
        }
#pragma unroll
        for (int j = 0; j < WN; j += 2) {
          const int n0 = (wni * WN + j) * 8;
          uint32_t bq[4];
          fp::ldmatrix_x4_trans(
              bq, g_sa
              + (kt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * g_stride
              + (n0 + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            fp::mma_bf16(acc[i][j], a[i], bq[0], bq[1]);
            fp::mma_bf16(acc[i][j + 1], a[i], bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();
    live = live_next;
  }

  if (active) {
    float* p = partial
        + (((size_t)b * n_chunks + ch) * g_n + grp) * (size_t)(3 * cin) * cout;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = (wmi * 3 + i) * 16 + (lane >> 2) + half * 8;
          const int col = (wni * WN + j) * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(p + (size_t)row * cout + col) =
              make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
        }
  }
}

// dw[zi * g_n + grp][c][o] = sum over the partials, in their order, of
// partial[.][grp][zi * cin + c][o].
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dw, int n_partials,
                                 int g_n, int cin, int cout) {
  const int n = g_n * 3 * cin * cout;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int o = e % cout, c = (e / cout) % cin, k = e / (cout * cin);
  const int zi = k / g_n, grp = k - zi * g_n;
  const float* p = partial + ((size_t)grp * 3 * cin + zi * cin + c) * cout + o;
  float s = 0.f;
  for (int i = 0; i < n_partials; ++i) s += p[(size_t)i * n];
  dw[e] = s;
}

template <int WN>
int launch_dw(const int* src, const void* feats, const int* tgt,
              const void* g, const int* lo, const int* centres,
              float* partial, int batch, int vs, int vt, int nb, int g_n,
              int block, int window, int cin, int cout, int n_chunks,
              cudaStream_t stream) {
  const int smem = 2 * kDwTile * ((3 * cin * 2 + 16) + (cout * 2 + 16))
      + 2 * 3 * kDwTile * 4;
  cudaError_t err = cudaFuncSetAttribute(
      windowed_dw_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = vt / kDwTile;
  const int tiles_per_chunk = (n_tiles + n_chunks - 1) / n_chunks;
  dim3 grid(g_n, n_chunks, batch);
  windowed_dw_kernel<WN><<<grid, kThreads, smem, stream>>>(
      src, (const __nv_bfloat16*)feats, tgt, (const __nv_bfloat16*)g, lo,
      centres, partial, vs, vt, nb, block, window, cin, cout,
      tiles_per_chunk);
  return (int)cudaGetLastError();
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

// dw (3G, Cin, Cout) f32, tap k = zi * G + group, from feats (B, Vs, Cin)
// bf16 and g (B, Vt, Cout) bf16, through partial (B * n_chunks, G, 3Cin,
// Cout) f32 scratch; centres (G,) are the groups' dz = 0 deltas. Cin in
// {16, 32, 64, 128}; Cout a power of two in [16, 256]; Cin * Cout <= 8192;
// block % 64 == 0; Vt % block == 0 (checked by the caller).
int fp_windowed_dw(const int* src, const void* feats, const int* tgt,
                   const void* g, const int* lo, const int* centres,
                   float* partial, float* dw, int batch, int vs, int vt,
                   int nb, int g_n, int block, int window, int cin, int cout,
                   int n_chunks, void* stream) {
  const int wm = cin / 16, nt = cout / 8;
  int wn = 8 / wm < nt / 2 ? 8 / wm : nt / 2;
  if (wm < 1 || wm > 8 || wn < 1) return (int)cudaErrorInvalidValue;
  int status = (int)cudaErrorInvalidValue;
#define FP_DW_CASE(WN)                                                       \
  case WN:                                                                   \
    status = launch_dw<WN>(src, feats, tgt, g, lo, centres, partial, batch,  \
                           vs, vt, nb, g_n, block, window, cin, cout,        \
                           n_chunks, (cudaStream_t)stream);                  \
    break
  switch (nt / wn) {
    FP_DW_CASE(2);
    FP_DW_CASE(4);
    FP_DW_CASE(8);
  }
#undef FP_DW_CASE
  if (status != 0) return status;
  const int n = g_n * 3 * cin * cout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partial, dw, batch * n_chunks, g_n, cin, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
