// The gather probes for Hopper (sm_90a): three kernels bound through a
// plain C ABI (ctypes), the counterparts of the Pallas kernels in the
// probes under tools/ that ask what an in-kernel gather costs at sparse-conv
// shapes.
//
// P1 fp_take_along replaces the take / take_along_axis bodies of
//    tools/probe_gather.py (pallas_call :52 for body_take :85, body_taa :94,
//    body_take_flat :105; :127 for probe_sublane's body :120),
//    tools/probe_gather2.py (:29, bodies a-g) and tools/probe_gather3.py
//    (:29, taa1 / taa0 / taa0v / taa0b).
//    out = take_along_axis(x, idx, axis) on a 2-D x (f32 or bf16), idx read
//    through strides (0 where it is broadcast), or T such gathers of one
//    (T, N) index in one launch: along axis 1 stacked on rows (T*R, N),
//    along axis 0 side by side (N, T*C). Negative indices count from the
//    end; out of range the result is NaN, as jnp.take_along_axis gives.
//    Bound: bytes (no arithmetic): the output written once, the input and
//    index read. Design: each thread writes 16 consecutive output bytes (8
//    bf16 or 4 f32 values) with one store, decoding their (tap, row) once
//    where the 16 bytes lie in one output row; it loads the indices as int4
//    where they are contiguous, and along axis 0 with one index per row
//    (the stacked taps) copies the input row's 16 bytes with one load. The
//    grid is one wave at full occupancy (8 blocks on each SM), striding over
//    the output; the input, a few hundred KB at most in the probes, is read
//    through L1/L2.
//
// P2 fp_onehot_gather replaces the one-hot compare+matmul gathers of
//    tools/probe_gather.py (body_onehot :157, pallas_call :175) and
//    tools/probe_posgather.py (bench_onehot_ref's kernel :175, pallas_call
//    :203).
//    For tap k and target w, x[:, s] where ids[s] == want[k, w], else 0,
//    as bf16 (T*C, W) (probe_gather's body_onehot); with weights, among the
//    first n_ids ids only, the (Cout, T*C) weight product over that bf16
//    tile, f32 sums, bf16 out, for each of `blocks` identical output blocks
//    (probe_posgather's grid), at C = Cout = 16, the probes' width.
//    Bound: bytes for the gather alone (output written once); with the
//    weight stage operations on the tensor cores per block, which the probe
//    repeats. Design: the TPU builds a (tap_win x W) one-hot tile per tap
//    and multiplies it (Mosaic had no in-kernel gather); here the ids are
//    staged once per block in shared memory and each target finds its id by
//    a binary search (fp::lower_bound, as K1 and K3 do), which computes the
//    same function for sorted unique ids (the wrapper checks them). The
//    gather alone tiles over (tap, 128 targets); the weight stage runs K2's
//    tile body (conv_tile of gather_mma.cuh: each (targets x 3C) tile of
//    three taps gathered by 16-byte cp.async from a row-major bf16 copy of
//    x into a two-stage ring, mma.sync m16n8k16 against weights packed in
//    fragment order, all resident in shared memory).
//
// P3 fp_banded_gather_conv replaces tools/probe_posgather.py
//    bench_banded_taa's kernel (:103, pallas_call :139).
//    For block i, tap k and target t the source column starts[i, k, t/128]
//    + rel[k, t] (nothing where rel lies outside [0, band*128) or the column
//    outside [0, S)), then out[:, i*W + t] = sum_k wt_k . x[:, column], f32
//    sums, bf16 out, channel-major (Cout, nb*W), at C = Cout = 16.
//    Bound: bytes at the probe's 16 channels (27*16*16*2 flop per target
//    against 32 bytes of output). Design: K2's function with explicit
//    positions: per 128-target tile the positions are expanded in shared
//    memory from the per-(block, tap, tile) starts (no host sync), then the
//    same conv_tile as P2's weight stage; the bf16 result is stored
//    transposed from the accumulator fragments. The TPU's band tiles, lane
//    permutes and selects exist only for Mosaic's 128-lane gathers.
//
// Every entry launches on the stream it is given, allocates nothing, and
// returns the launch's error code.

#include "gather_mma.cuh"

namespace {

constexpr int kThreads = fp::kConvThreads;  // 8 warps
constexpr int kTile = fp::kConvTile;        // 128 targets per tile
constexpr int kC = 16;     // P2's and P3's channels in and out, as the
constexpr int kNT = 2;     // probes take them: kNT n-tiles of 8 = kC

__device__ __forceinline__ float nan_of(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ __nv_bfloat16 nan_of(__nv_bfloat16) {
  return __ushort_as_bfloat16(0x7fc0);
}

// 16 bytes of T.
template <typename T>
union Vec16 {
  uint4 u;
  T v[16 / sizeof(T)];
};

// x[i, idx] (axis 1) or x[idx, j] (axis 0); negative indices count from
// the end, out of range NaN.
template <typename T>
__device__ __forceinline__ T take_one(const T* __restrict__ x, int v,
                                      int axis, int i, int j, int len,
                                      int cols) {
  if (v < 0) v += len;
  if (v < 0 || v >= len) return nan_of(T());
  return x[axis == 1 ? (size_t)i * cols + v : (size_t)v * cols + j];
}

// Output element e, in memory order: axis 1 (t, i, j) of (T*m, n), axis 0
// (i, t, j) of (m, T*n); it reads x[i, idx] or x[idx, j], the index at
// idx[t*st_t + i*st_i + j*st_j]. Thread step: 16 output bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
take_along_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                  T* __restrict__ out, int axis, int rows, int cols,
                  int taps, int m, int n, int st_t, int st_i, int st_j) {
  constexpr int V = 16 / sizeof(T);
  const int total = taps * m * n;  // < 2^31 (the wrapper checks)
  const int len = axis == 1 ? cols : rows;
  const int vecs = (total + V - 1) / V;
  for (int vi = blockIdx.x * blockDim.x + threadIdx.x; vi < vecs;
       vi += gridDim.x * blockDim.x) {
    const int e0 = vi * V;
    const int j0 = e0 % n, q = e0 / n;
    Vec16<T> r;
    if (j0 + V <= n) {  // one output row: (t, i) decoded once
      const int i = axis == 1 ? q % m : q / taps;
      const int t = axis == 1 ? q / m : q % taps;
      const int* ip = idx + (long long)t * st_t + (long long)i * st_i
                      + (long long)j0 * st_j;
      if (st_j == 0) {
        int v = *ip;
        if (axis == 0) {  // V consecutive values of input row v
          if (v < 0) v += len;
          const T* row = x + (size_t)v * cols + j0;
          if (v < 0 || v >= len) {
#pragma unroll
            for (int k = 0; k < V; ++k) r.v[k] = nan_of(T());
          } else if (((uintptr_t)row & 15) == 0) {
            r.u = *reinterpret_cast<const uint4*>(row);
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) r.v[k] = row[k];
          }
        } else {
          const T g = take_one(x, v, axis, i, j0, len, cols);
#pragma unroll
          for (int k = 0; k < V; ++k) r.v[k] = g;
        }
      } else {
        int iv[V];
        if (st_j == 1 && ((uintptr_t)ip & 15) == 0) {
#pragma unroll
          for (int k = 0; k < V; k += 4)
            *reinterpret_cast<int4*>(iv + k) =
                *reinterpret_cast<const int4*>(ip + k);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) iv[k] = ip[(long long)k * st_j];
        }
#pragma unroll
        for (int k = 0; k < V; ++k)
          r.v[k] = take_one(x, iv[k], axis, i, j0 + k, len, cols);
      }
    } else {  // the 16 bytes span output rows, or end the output
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int e = e0 + k;
        if (e >= total) break;
        const int j = e % n, qe = e / n;
        const int i = axis == 1 ? qe % m : qe / taps;
        const int t = axis == 1 ? qe / m : qe % taps;
        r.v[k] = take_one(x, idx[(long long)t * st_t + (long long)i * st_i
                                 + (long long)j * st_j],
                          axis, i, j, len, cols);
      }
    }
    if (e0 + V <= total) {
      *reinterpret_cast<uint4*>(out + e0) = r.u;
    } else {
      for (int k = 0; e0 + k < total; ++k) out[e0 + k] = r.v[k];
    }
  }
}

// Blocks of kThreads threads in one wave at full occupancy on this device.
int wave_blocks() {
  static int blocks[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 1024;
  if (blocks[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess)
      return 1024;
    blocks[dev] = sms * (2048 / kThreads);
  }
  return blocks[dev];
}

// The rank of v among the sorted unique ids[0:n) where it is there, else -1.
__device__ __forceinline__ int find_id(const int* ids, int n, int v) {
  const int i = fp::lower_bound(ids, n, v);
  return i < n && ids[i] == v ? i : -1;
}

// P2 without weights. Shared memory: [ids: s][rows: kTile] int.
__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const __nv_bfloat16* __restrict__ x,
                     const int* __restrict__ ids, const int* __restrict__ want,
                     __nv_bfloat16* __restrict__ out, int c, int s, int taps,
                     int w_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ids_sm = reinterpret_cast<int*>(smem);
  int* rows = ids_sm + s;
  const int tid = threadIdx.x;
  for (int i = tid; i < s; i += kThreads) ids_sm[i] = ids[i];
  __syncthreads();
  const int tiles = w_len / kTile;
  for (int tile = blockIdx.x; tile < taps * tiles; tile += gridDim.x) {
    const int k = tile / tiles, w0 = (tile - k * tiles) * kTile;
    if (tid < kTile)
      rows[tid] = find_id(ids_sm, s, want[(size_t)k * w_len + w0 + tid]);
    __syncthreads();
    for (int e = tid; e < c * kTile; e += kThreads) {
      const int r = e % kTile, ch = e / kTile;
      const int src = rows[r];
      out[((size_t)k * c + ch) * w_len + w0 + r] =
          src >= 0 ? x[(size_t)ch * s + src] : __float2bfloat16(0.f);
    }
    __syncthreads();
  }
}

// The tile's bf16 outputs, channel-major: out points at the tile's first
// target of channel 0, a channel every ld elements.
__device__ __forceinline__ void store_tile_bf16_t(
    const float (&acc)[kNT][4], __nv_bfloat16* __restrict__ out, size_t ld,
    int tid) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + (lane >> 2) + half * 8;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = nt * 8 + (lane & 3) * 2;
      out[(size_t)col * ld + r] = __float2bfloat16(acc[nt][half * 2]);
      out[(size_t)(col + 1) * ld + r] =
          __float2bfloat16(acc[nt][half * 2 + 1]);
    }
  }
}

// P2 with weights (kBanded false: positions by search among the ids) and
// P3 (kBanded true: positions from starts + rel), kC channels in and out.
// Shared memory, as fp::conv_plan lays it out: [weights: all groups,
// resident][two gather tiles][rows: taps x kTile int][P2: ids, n_ids int].
// A tap group is three consecutive taps.
template <bool kBanded>
__global__ void __launch_bounds__(kThreads, 2)
gather_product_kernel(const __nv_bfloat16* __restrict__ xt,
                      const int* __restrict__ ids,
                      const int* __restrict__ want,
                      const int* __restrict__ starts,
                      const int* __restrict__ rel,
                      const unsigned char* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int s, int n_ids,
                      int taps, int w_len, int blocks, int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int g_n = taps / 3;
  const int w_bytes = g_n * 3 * kC * kC * 2;
  const uint32_t a_sa = fp::smem_addr(smem) + w_bytes;
  int* rows = reinterpret_cast<int*>(
      smem + w_bytes + 2 * kTile * fp::tile_stride(kC));
  int* ids_sm = rows + taps * kTile;

  fp::copy_async(fp::smem_addr(smem), w, w_bytes, tid, kThreads);
  fp::cp_async_commit();
  if (!kBanded)
    for (int i = tid; i < n_ids; i += kThreads) ids_sm[i] = ids[i];
  fp::cp_async_wait<0>();
  __syncthreads();

  const int tiles = w_len / kTile;
  const int n_tiles = blocks * tiles;
  const size_t ld = (size_t)blocks * w_len;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles, ot = tile - b * tiles, w0 = ot * kTile;
    for (int p = tid; p < taps * kTile; p += kThreads) {
      const int k = p / kTile, r = p - k * kTile;
      int src;
      if (kBanded) {
        const int d = rel[(size_t)k * w_len + w0 + r];
        const int q = starts[((size_t)b * taps + k) * tiles + ot] + d;
        src = d >= 0 && d < band * kTile && q >= 0 && q < s ? q : -1;
      } else {
        src = find_id(ids_sm, n_ids, want[(size_t)k * w_len + w0 + r]);
      }
      rows[p] = src;
    }
    __syncthreads();

    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    fp::conv_tile<kNT>(acc, (1u << g_n) - 1u, w, smem, a_sa, xt, rows, kC,
                       1, 2, tid);
    store_tile_bf16_t(acc, out + (size_t)b * w_len + w0, ld, tid);
  }
}

template <bool kBanded>
int launch_product(const void* xt, const int* ids, const int* want,
                   const int* starts, const int* rel, const void* w,
                   void* out, int c, int s, int n_ids, int taps, int w_len,
                   int cout, int blocks, int band, cudaStream_t stream) {
  // conv_tile takes the tap groups as a 32-bit mask; the weights of every
  // group stay resident and the ring has two stages
  if (c != kC || cout != kC || taps % 3 || taps / 3 > 31 || w_len % kTile)
    return (int)cudaErrorInvalidValue;
  const fp::ConvPlan plan = fp::conv_plan(
      taps / 3, kC, kC, taps * kTile * 4 + (kBanded ? 0 : n_ids * 4));
  if (!plan.resident || plan.stages != 2 || plan.smem > fp::kSmemMax)
    return (int)cudaErrorInvalidValue;
  int slots = 0;
  cudaError_t err = fp::persistent_slots(gather_product_kernel<kBanded>,
                                         plan.smem, &slots);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = blocks * (w_len / kTile);
  const int grid = n_tiles < slots ? n_tiles : slots;
  if (grid == 0) return 0;
  gather_product_kernel<kBanded><<<grid, kThreads, plan.smem, stream>>>(
      (const __nv_bfloat16*)xt, ids, want, starts, rel,
      (const unsigned char*)w, (__nv_bfloat16*)out, s, n_ids, taps, w_len,
      blocks, band);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = take_along(x, idx): x (rows, cols) with elem_bytes 4 (f32) or 2
// (bf16); element (t, i, j) of the (taps, m, n) gather reads idx at
// t*st_t + i*st_i + j*st_j. axis 1: out (taps*m, n), m == rows; axis 0:
// out (m, taps*n), n == cols. out is 16-byte aligned (a fresh allocation).
int fp_take_along(const void* x, const int* idx, void* out, int elem_bytes,
                  int axis, int rows, int cols, int taps, int m, int n,
                  int st_t, int st_i, int st_j, void* stream) {
  const long long total = (long long)taps * m * n;
  if (total == 0) return 0;
  if ((elem_bytes != 4 && elem_bytes != 2) || total >= (1ll << 31) - 16
      || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long vecs = (total + 16 / elem_bytes - 1) / (16 / elem_bytes);
  long long grid = (vecs + kThreads - 1) / kThreads;
  if (grid > wave_blocks()) grid = wave_blocks();
  if (elem_bytes == 4) {
    take_along_kernel<float><<<(int)grid, kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)x, idx, (float*)out, axis, rows, cols, taps, m, n,
        st_t, st_i, st_j);
  } else {
    take_along_kernel<__nv_bfloat16><<<(int)grid, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, idx, (__nv_bfloat16*)out, axis, rows, cols,
        taps, m, n, st_t, st_i, st_j);
  }
  return (int)cudaGetLastError();
}

// P2: x (c, s) bf16 (read by the gather alone), xt its (s, c) transpose
// (read by the weight stage), ids (s,) sorted unique int32, want (taps,
// w_len) int32; w_len % 128 == 0. weighted == 0: all s ids compared, out
// (taps*c, w_len) bf16 (n_ids == s, blocks == 1). Else the first n_ids ids
// compared, w = the (taps*c, cout) bf16 weights packed in mma fragment
// order, c == cout == 16, and out (cout, blocks*w_len) bf16.
int fp_onehot_gather(const void* x, const void* xt, const int* ids,
                     const int* want, const void* w, void* out, int c, int s,
                     int n_ids, int taps, int w_len, int cout, int blocks,
                     int weighted, void* stream) {
  if (w_len % kTile) return (int)cudaErrorInvalidValue;
  if (weighted)
    return launch_product<false>(xt, ids, want, nullptr, nullptr, w, out, c,
                                 s, n_ids, taps, w_len, cout, blocks, 0,
                                 (cudaStream_t)stream);
  if (n_ids != s || blocks != 1) return (int)cudaErrorInvalidValue;
  const int smem = (s + kTile) * 4;
  int slots = 0;
  cudaError_t err = fp::persistent_slots(onehot_gather_kernel, smem, &slots);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = taps * (w_len / kTile);
  const int grid = n_tiles < slots ? n_tiles : slots;
  if (grid == 0) return 0;
  onehot_gather_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, ids, want, (__nv_bfloat16*)out, c, s, taps,
      w_len);
  return (int)cudaGetLastError();
}

// P3: starts (blocks, taps, w_len/128) int32, xt (s, c) bf16 (the
// transpose of the probe's (c, s) features), rel (taps, w_len) int32, w
// the (taps*c, cout) bf16 weights packed in mma fragment order, c == cout
// == 16; out (cout, blocks*w_len) bf16.
int fp_banded_gather_conv(const int* starts, const void* xt, const int* rel,
                          const void* w, void* out, int c, int s, int taps,
                          int w_len, int cout, int blocks, int band,
                          void* stream) {
  return launch_product<true>(xt, nullptr, nullptr, starts, rel, w, out, c,
                              s, 0, taps, w_len, cout, blocks, band,
                              (cudaStream_t)stream);
}

}  // extern "C"
