// What the gather-and-multiply kernels share (K2 in posgather.cu, K3 and K4
// in windowed_sparse.cu): the search, the S z-probes of a tap group, the
// asynchronous 16-byte gather of bf16 source rows into a shared-memory tile,
// the tensor-core primitives (ldmatrix, mma.sync m16n8k16 bf16 -> f32), the
// body of the convs (K2, K3): the ring of gathered group tiles times the
// packed weights, and the fused epilogue, and the convs' launch plan (shared
// memory, grid). P2 and P3 in gather_probes.cu take only the tile sizes,
// the shared-memory limit and the tensor-core primitives from here: their
// window_product_kernel stages the window once per block and has a body of
// its own.
//
// Tap groups. A kernel's taps in zyx C-order are G (dy, dx) groups of S
// consecutive ids, S the kernel's z size: 3 for a 3x3x3 kernel (9 groups),
// 5 for 5x5x5 (25 groups), 1 for the (1, 3, 3) kernels of a 2D level (9
// groups of one). Tap zi * G + g has the id delta centres[g] + zi - S/2.
//
// Tile layout. A gather tile holds, per target row, the S*Cin bf16
// channels of one tap group: [z-S/2 | ... | z+S/2] x Cin, a row every
// S*Cin*2 + 16 bytes. The 16 bytes of padding make the row stride an odd
// number of 16-byte units, so the eight row addresses of every ldmatrix
// 8x8 block fall into eight different bank groups (no conflicts), with or
// without .trans.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fp {

// Left insertion point of v in the ascending a[0:n).
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The S z-neighbours of one (target, tap group), given the rank of the
// group's centre id in the window win[0:window) (win = src + lo_b) and
// whether the centre itself is there. The ids are unique and ascending, so
// an id centre - k (k <= S/2) lies among the S/2 places below the rank and
// centre + k among the S/2 places from rank + hit up: for S = 3, z-1 at
// rank-1, z at rank (only on a hit), z+1 at rank+hit. A probe is accepted
// only if the id there is exactly the one wanted; rows[zi * stride + r] gets
// the source row, or -1. Returns whether any of the S was found. S is a
// template argument, so the probes unroll.
template <int S>
__device__ __forceinline__ int resolve_probes_s(const int* __restrict__ win,
                                                int window, int lo_b,
                                                int rank, int hit, int centre,
                                                int* rows, int stride, int r) {
  constexpr int h = S / 2;
  int found = 0;
#pragma unroll
  for (int zi = 0; zi < S; ++zi) {
    const int dz = zi - h;
    int s = -1;
    if (dz == 0) {
      if (hit && rank < window && win[rank] == centre) s = lo_b + rank;
    } else {
#pragma unroll
      for (int k = 0; k < h; ++k) {
        const int j = dz < 0 ? rank - 1 - k : rank + hit + k;
        if (j >= 0 && j < window && win[j] == centre + dz) s = lo_b + j;
      }
    }
    rows[zi * stride + r] = s;
    found |= s >= 0;
  }
  return found;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without passing through registers; with
// bytes == 0 nothing is read and 16 zero bytes are written.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Bytes per row of a gather tile of `taps` x cin bf16 channels.
__host__ __device__ __forceinline__ int tile_stride(int cin, int taps) {
  return taps * cin * 2 + 16;
}

// Start the gather of one group's tile: ROWS targets x [taps][cin] bf16
// into `tile` (shared-memory address), from the sample's bf16 features;
// rows is resolve_probes' output ([taps][ROWS]); misses become zeros.
// cin % 8 == 0.
template <int ROWS>
__device__ __forceinline__ void gather_tile(uint32_t tile,
                                            const __nv_bfloat16* __restrict__ f,
                                            const int* rows, int cin, int taps,
                                            int tid, int n_threads) {
  const int cpr = cin >> 3;                 // 16-byte pieces per source row
  const int stride = tile_stride(cin, taps);
  const int n = taps * ROWS * cpr;
  for (int c = tid; c < n; c += n_threads) {
    const int cc = c % cpr, t = c / cpr;
    const int r = t % ROWS, zi = t / ROWS;
    const int s = rows[zi * ROWS + r];
    cp_async16(tile + r * stride + (zi * cin + cc * 8) * 2,
               f + (size_t)(s < 0 ? 0 : s) * cin + cc * 8, s < 0 ? 0 : 16);
  }
}

// Linear copy of `bytes` (a multiple of 16) global -> shared.
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src,
                                           int bytes, int tid, int n_threads) {
  const char* s = static_cast<const char*>(src);
  for (int o = tid * 16; o < bytes; o += n_threads * 16)
    cp_async16(dst + o, s + o, 16);
}

// Four 8x8 b16 blocks; lane l gives the address of row l%8 of block l/8 and
// gets, of each block, row l/4, columns 2(l%4), 2(l%4)+1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The same with each block transposed: lane l gets rows 2(l%4), 2(l%4)+1 of
// column l/4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row-major fragment) . b (16x8 bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// ---- the conv of one tile of kConvTile targets x all Cout (K2, K3)
//
// kConvThreads / 32 warps, one per 16 target rows, each with NT = Cout / 8
// n-tiles of m16n8k16 accumulators. The weights are (G*S*Cin, Cout) bf16
// packed in mma fragment order ([g][k-slab of 16][n-tile of 8][lane][4],
// lane l holding rows 2(l%4), 2(l%4)+1, 2(l%4)+8, 2(l%4)+9 of column l/4):
// in shared memory at w_sm, all groups when `resident`, else one group per
// stage streamed beside its rows.
constexpr int kConvTile = 128;
constexpr int kConvThreads = kConvTile * 2;

// acc += sum over the tap groups g in `mask` (ascending) of the gathered
// tile of rows[g] (kConvTile x S*Cin, S = taps) times W_g. With two stages, group g's
// successor is in flight while g multiplies. Every thread of the block
// calls it with the same mask; it leaves no copy pending.
template <int NT>
__device__ __forceinline__ void conv_tile(
    float (&acc)[NT][4], unsigned mask, const unsigned char* __restrict__ w,
    const unsigned char* w_sm, uint32_t a_sa,
    const __nv_bfloat16* __restrict__ f, const int* rows, int cin, int taps,
    int resident, int stages, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int ks_n = taps * cin / 16;
  const int wg_bytes = taps * cin * NT * 8 * 2;
  const int a_stride = tile_stride(cin, taps);
  const int a_bytes = kConvTile * a_stride;
  const uint32_t w_sa = smem_addr(w_sm);

  // one cp.async group per tap group: its gather tile and, unless all
  // weights are resident, its weights
  auto start_group = [&](int g, int st) {
    gather_tile<kConvTile>(a_sa + st * a_bytes, f,
                           rows + g * taps * kConvTile, cin, taps, tid,
                           kConvThreads);
    if (!resident)
      copy_async(w_sa + st * wg_bytes, w + (size_t)g * wg_bytes, wg_bytes,
                 tid, kConvThreads);
    cp_async_commit();
  };

  int g = mask ? __ffs(mask) - 1 : -1;
  if (stages == 2 && g >= 0) start_group(g, 0);
  for (int i = 0; g >= 0; ++i) {
    const unsigned rest = mask & ~((2u << g) - 1u);
    const int next = rest ? __ffs(rest) - 1 : -1;
    const int st = stages == 2 ? (i & 1) : 0;
    if (stages == 2) {
      if (next >= 0) {
        start_group(next, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      start_group(g, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t a_addr = a_sa + st * a_bytes
        + (warp * 16 + (lane & 15)) * a_stride + (lane >> 4) * 16;
    const unsigned char* wg = w_sm + (resident ? g : st) * wg_bytes
        + lane * 8;
    for (int ks = 0; ks < ks_n; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + ks * 32);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 bv = *reinterpret_cast<const uint2*>(
            wg + (ks * NT + nt) * 256);
        mma_bf16(acc[nt], a, bv.x, bv.y);
      }
    }
    __syncthreads();
    g = next;
  }
}

// The tile's outputs from acc: out and tgt point at its first row (Cout
// floats a row); with kAccumulate, acc is first added to what out holds
// (the sum of the earlier input-channel slices of the same conv); then
// optionally *scale + shift, ReLU, and zero where the target id is >=
// sentinel. 8 bytes per lane: a 32-byte sector per row and warp.
// store_tile picks the variant once per tile, outside the stores.
template <int NT, bool kAccumulate>
__device__ __forceinline__ void store_tile_as(
    const float (&acc)[NT][4], float* __restrict__ out,
    const int* __restrict__ tgt, const float* __restrict__ scale,
    const float* __restrict__ shift, int epilogue, int relu, int sentinel,
    int tid) {
  constexpr int cout = NT * 8;
  const int warp = tid >> 5, lane = tid & 31;
  const int col0 = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + (lane >> 2) + half * 8;
    const bool masked = epilogue && tgt[r] >= sentinel;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + col0;
      float2* o = reinterpret_cast<float2*>(out + (size_t)r * cout + col);
      float v0 = acc[nt][half * 2], v1 = acc[nt][half * 2 + 1];
      if (kAccumulate) {
        const float2 prev = *o;
        v0 += prev.x;
        v1 += prev.y;
      }
      if (epilogue) {
        v0 = v0 * scale[col] + shift[col];
        v1 = v1 * scale[col + 1] + shift[col + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (masked) v0 = v1 = 0.f;
      }
      *o = make_float2(v0, v1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void store_tile(
    const float (&acc)[NT][4], float* __restrict__ out,
    const int* __restrict__ tgt, const float* __restrict__ scale,
    const float* __restrict__ shift, int epilogue, int relu, int sentinel,
    int accumulate, int tid) {
  if (accumulate)
    store_tile_as<NT, true>(acc, out, tgt, scale, shift, epilogue, relu,
                            sentinel, tid);
  else
    store_tile_as<NT, false>(acc, out, tgt, scale, shift, epilogue, relu,
                             sentinel, tid);
}

// Zeros over a tile's kConvTile x cout outputs (cout % 4 == 0).
__device__ __forceinline__ void zero_tile(float* __restrict__ out, int cout,
                                          int tid) {
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int e = tid; e < kConvTile * cout / 4; e += kConvThreads)
    o4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}


// ---- the launch plan of a kernel over conv_tile (host side; K2, K3)

constexpr int kResidentMax = 112 * 1024;  // all groups' weights resident
constexpr int kSmemMax = 227 * 1024;      // dynamic shared memory per block

// Shared memory: [weights: all g_n groups when resident, else `stages` of
// one group][`stages` gather tiles][extra bytes of the kernel's own].
inline int conv_smem(int g_n, int taps, int cin, int cout, int resident,
                     int stages, int extra) {
  return (resident ? g_n : stages) * taps * cin * cout * 2
      + stages * kConvTile * tile_stride(cin, taps) + extra;
}

struct ConvPlan {
  int resident, stages, smem;
};

// All groups' weights resident where they fit in kResidentMax, two stages
// where they fit in kSmemMax, else one; smem > kSmemMax when not even that
// fits (the caller refuses the launch).
inline ConvPlan conv_plan(int g_n, int taps, int cin, int cout, int extra) {
  ConvPlan p;
  p.resident = g_n * taps * cin * cout * 2 <= kResidentMax;
  p.stages = conv_smem(g_n, taps, cin, cout, p.resident, 2, extra)
      <= kSmemMax ? 2 : 1;
  p.smem = conv_smem(g_n, taps, cin, cout, p.resident, p.stages, extra);
  return p;
}

// Opt `kernel` into `smem` bytes of dynamic shared memory and count the
// blocks of kConvThreads that the card holds at once (*slots), the grid of
// a persistent kernel.
template <typename Kernel>
cudaError_t persistent_slots(Kernel kernel, int smem, int* slots) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kConvThreads, smem)) != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *slots = per_sm * sms;
  return cudaSuccess;
}

}  // namespace fp
