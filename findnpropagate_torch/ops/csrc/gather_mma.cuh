// What the gather-and-multiply kernels share (K2 in posgather.cu, K4 in
// windowed_sparse.cu): the search, the three z-probes of a tap group, the
// asynchronous 16-byte gather of bf16 source rows into a shared-memory tile,
// and the tensor-core primitives (ldmatrix, mma.sync m16n8k16 bf16 -> f32).
//
// Tile layout. A gather tile holds, per target row, the 3*Cin bf16 channels
// of one (dy, dx) tap group: [z-1 | z | z+1] x Cin, a row every
// 3*Cin*2 + 16 bytes. The 16 bytes of padding make the row stride an odd
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

// The three z-neighbours of one (target, tap group), given the rank of the
// group's centre id in the window win[0:window) (win = src + lo_b) and
// whether the centre itself is there: z-1 sits at rank-1, z at rank (only on
// a hit), z+1 at rank+hit. Each is accepted only if the id there is exactly
// the one wanted; rows[zi * stride + r] gets the source row, or -1.
__device__ __forceinline__ void resolve_probes(const int* __restrict__ win,
                                               int window, int lo_b, int rank,
                                               int hit, int centre, int* rows,
                                               int stride, int r) {
#pragma unroll
  for (int zi = 0; zi < 3; ++zi) {
    const int j = zi == 0 ? rank - 1 : (zi == 1 ? rank : rank + hit);
    int s = -1;
    if (j >= 0 && j < window && (zi != 1 || hit)) {
      if (win[j] == centre + (zi - 1)) s = lo_b + j;
    }
    rows[zi * stride + r] = s;
  }
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

__device__ __forceinline__ int tile_stride(int cin) {
  return 3 * cin * 2 + 16;
}

// Start the gather of one group's tile: ROWS targets x [3][cin] bf16 into
// `tile` (shared-memory address), from the sample's bf16 features; rows is
// resolve_probes' output ([3][ROWS]); misses become zeros. cin % 8 == 0.
template <int ROWS>
__device__ __forceinline__ void gather_tile(uint32_t tile,
                                            const __nv_bfloat16* __restrict__ f,
                                            const int* rows, int cin, int tid,
                                            int n_threads) {
  const int cpr = cin >> 3;                 // 16-byte pieces per source row
  const int stride = tile_stride(cin);
  const int n = 3 * ROWS * cpr;
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

}  // namespace fp
