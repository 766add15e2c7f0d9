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
//    For tap k and target w, x[:, s] where ids[s] == want[k, w] among the
//    first n_ids ids, else 0, as bf16 (T*C, W) (probe_gather's
//    body_onehot); with weights the (Cout, T*C) weight product over that
//    bf16 tile, f32 sums, bf16 out, for each of `blocks` output blocks
//    (probe_posgather's grid), each computed from its own positions.
//    Bound: bytes for the gather alone (output written once); with the
//    weight stage the tensor cores' operations per block, which the probe
//    repeats. The TPU builds a (tap_win x W) one-hot tile per tap and
//    multiplies it (Mosaic had no in-kernel gather); here each target finds
//    its id by a search among the ids staged in shared memory, which
//    computes the same function for sorted unique ids: the kernel tests
//    every adjacent pair while it stages them and traps on a violation.
//
// P3 fp_banded_gather_conv replaces tools/probe_posgather.py
//    bench_banded_taa's kernel (:103, pallas_call :139).
//    For block i, tap k and target t the source column starts[i, k, t/128]
//    + rel[k, t] (nothing where rel lies outside [0, band*128) or the column
//    outside [0, S)), then out[:, i*W + t] = sum_k wt_k . x[:, column], f32
//    sums, bf16 out, channel-major (Cout, nb*W). The TPU's band tiles, lane
//    permutes and selects exist only for Mosaic's 128-lane gathers.
//    Bound: operations on the tensor cores at the probe's shape; what sets
//    the floor here is the shared-memory traffic of the gathered rows, the
//    staging and, for P2, the search.
//
// P2 with weights and P3 share one design, at C = Cout = 16 (the probes'
//    width): one block of 16 warps on each SM stages the window once, in
//    shared memory, as rows of 16 channels (32 bytes): the (C, S) input is
//    read as given and transposed on the way by stmatrix.trans, the rows'
//    two 16-byte halves XOR-swizzled by bit 2 of the row so that eight rows
//    spread over the eight bank groups as far as their row numbers allow;
//    one zero row stands for "nothing gathered". Beside it the plain (Cout,
//    T*C) weights (row-major (Cout, K) is the column-major B operand of
//    mma.m16n8k16; rows padded to an odd number of 16-byte units) and P2's
//    ids with a bucket index of their values. After one barrier each warp
//    owns 32 targets at a time and waits for no other warp: its lanes
//    resolve the source rows of 14 taps at once (the two half-warps take
//    alternate taps; P3 starts + rel, P2 a bucket and a few lock-step search
//    steps), with the next chunk's inputs loaded meanwhile; per tap one
//    ldmatrix.x4 of B from the weights and, per 16 targets, one ldmatrix.x4
//    of A straight from the window (shuffles hand each lane the row of its
//    address) and two mma.sync. The 16 x 16 results go through
//    stmatrix.trans into a 512-byte slice of the warp's own, so that each
//    lane stores 16 bytes of one channel's 8 consecutive targets.
//
// P2 without weights stages only its ids: a warp reads 16 of the rows, so
//    staging all of them in every block cost more on the card than it
//    saved. A warp takes 16 targets of one tap, searches their ids, and
//    each lane gathers 8 of them of one channel from the input through L1
//    into one 16-byte store.
//
// Limits (dynamic shared memory: window_smem, the ids) are refused, not
// worked around.
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

// ---- P2 and P3: a window of 16-channel rows staged in shared memory

constexpr int kWarps = 16;                   // warps of a P2 / P3 block
constexpr int kWinThreads = kWarps * 32;
constexpr int kRowBytes = kC * 2;            // a window row: 16 bf16
constexpr int kStoreBytes = kC * 16 * 2;     // a warp's 16 x 16 bf16 tile
constexpr int kMT = 2;                       // 16-target m-tiles a warp step
constexpr int kPairs = 7;                    // tap pairs of a chunk
constexpr int kSearch = 7;                   // ids searched in lock step
constexpr int kRowBatch = 8;                 // 16-row groups a warp stages
constexpr int kBatch = 4;                    // other staging loads in flight

// P2's search index: the ids' value range [lo, hi] cut into bucket_count
// buckets of 2^shift values; starts[j] (uint16) is the rank of the first
// id of bucket j, starts[bucket_count] = n.
__host__ __device__ __forceinline__ int bucket_count(int n) {
  int b = 1;
  while (2 * b <= n) b *= 2;
  return b;
}

// Bytes of shared memory, as the kernels lay it out: P2 without weights
// [ids: n_ids int]; P2 with weights and P3
// [window: rows + the zero row][weights: kC rows of taps*kC bf16 + 16
// bytes][a store tile per warp][P2's ids and bucket starts].
// ops/gather_probes.py::ids_smem and window_smem mirror them.
__host__ __device__ __forceinline__ int ids_smem(int n_ids) {
  return n_ids ? n_ids * 4 + (bucket_count(n_ids) + 1) * 2 : 0;
}
__host__ __device__ __forceinline__ int weight_stride(int taps) {
  return taps * kC * 2 + 16;
}
__host__ __device__ __forceinline__ int window_smem(int rows, int n_ids,
                                                    int taps) {
  return (rows + 1) * kRowBytes + kC * weight_stride(taps)
      + kWarps * kStoreBytes + ids_smem(n_ids);
}

// The byte offset of 16-byte half h (channels 8h..8h+7) of window row r:
// row_base(r) ^ (h << 4).
__device__ __forceinline__ uint32_t row_base(int r) {
  return (uint32_t)(r * kRowBytes + (((r >> 2) & 1) << 4));
}
__device__ __forceinline__ uint32_t row_half(int r, int h) {
  return row_base(r) ^ (uint32_t)(h << 4);
}

// Four 8x8 b16 blocks stored transposed: lane l gives the address of row
// l%8 of block l/8, which receives column l%8 of the fragment it holds
// (lane l holds row l/4, columns 2(l%4), 2(l%4)+1).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n"
      :: "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// n items through registers by the block's threads, kBatch loads of a
// thread in flight at once.
template <typename Load, typename Store>
__device__ __forceinline__ void batched(int n, int tid, Load load,
                                        Store store) {
  const int nt = blockDim.x;
  for (int e0 = tid; e0 < n; e0 += kBatch * nt) {
    decltype(load(0)) v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e0 + u * nt < n) v[u] = load(e0 + u * nt);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e0 + u * nt < n) store(e0 + u * nt, v[u]);
  }
}

// Rows [0, n_rows) of the (kC, ld) channel-major bf16 x into the window,
// transposed, and the zero row n_rows after them. Where x allows 4-byte
// loads (ld even, base 4-byte aligned) a warp stages 16 rows with one
// stmatrix.x4.trans: lane l loads the position pairs 2(l%4), 2(l%4)+1 of
// channel l/4 (+8) at positions 0-7 and 8-15, the fragments of four 8x8
// (channels x positions) blocks whose transposes are the rows' halves;
// kRowBatch groups of a warp in flight. The rest by 2-byte loads.
__device__ __forceinline__ void stage_rows(
    unsigned char* win, const unsigned short* __restrict__ x, int ld,
    int n_rows, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int groups = (ld & 1) == 0 && ((uintptr_t)x & 3) == 0
      ? n_rows >> 4 : 0;
  const uint32_t* x2 = reinterpret_cast<const uint32_t*>(x);
  const int ld2 = ld >> 1;
  const uint32_t win_sa = fp::smem_addr(win);
  for (int g0 = warp; g0 < groups; g0 += kRowBatch * kWarps) {
    uint32_t r[kRowBatch][4];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int g = g0 + u * kWarps;
      if (g < groups) {
#pragma unroll
        for (int i = 0; i < 4; ++i)     // block i: channels 8(i%2).., rows
          r[u][i] = x2[(size_t)((i & 1) * 8 + (lane >> 2)) * ld2  // 8(i/2)..
                       + g * 8 + (i >> 1) * 4 + (lane & 3)];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int g = g0 + u * kWarps, i = lane >> 3;
      if (g < groups)
        stmatrix_x4_trans(win_sa + row_half(g * 16 + (i >> 1) * 8
                                            + (lane & 7), i & 1), r[u]);
    }
  }
  for (int r = groups * 16 + tid; r < n_rows; r += kWinThreads) {
    uint32_t v[kC / 2];
#pragma unroll
    for (int i = 0; i < kC / 2; ++i)
      v[i] = (uint32_t)x[(size_t)(2 * i) * ld + r]
          | ((uint32_t)x[(size_t)(2 * i + 1) * ld + r] << 16);
    *reinterpret_cast<uint4*>(win + row_half(r, 0)) =
        make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(win + row_half(r, 1)) =
        make_uint4(v[4], v[5], v[6], v[7]);
  }
  if (tid < 2)
    *reinterpret_cast<uint4*>(win + row_half(n_rows, tid)) =
        make_uint4(0u, 0u, 0u, 0u);
}

// The (kC, taps*kC) bf16 weights as they are, each row padded to
// weight_stride bytes: 16-byte pieces where the base is aligned.
__device__ __forceinline__ void stage_weights(
    unsigned char* w_sm, const unsigned short* __restrict__ w, int taps,
    int tid) {
  const int stride = weight_stride(taps);
  if (((uintptr_t)w & 15) == 0) {
    const int pieces = taps * 2;                    // 16 bytes each
    batched(kC * pieces, tid,
            [&](int e) { return reinterpret_cast<const uint4*>(w)[e]; },
            [&](int e, uint4 v) {
              const int n = e / pieces;
              *reinterpret_cast<uint4*>(w_sm + n * stride
                                        + (e - n * pieces) * 16) = v;
            });
    return;
  }
  const int k_len = taps * kC;
  batched(kC * k_len, tid, [&](int e) { return w[e]; },
          [&](int e, unsigned short v) {
            const int n = e / k_len;
            *reinterpret_cast<unsigned short*>(
                w_sm + n * stride + (e - n * k_len) * 2) = v;
          });
}

// P2's ids staged in shared memory, with (P2 with weights) a search index:
// the value range [lo, hi] cut into bucket_count(n) buckets of 2^shift
// values, starts[j] (uint16) the rank of the first id of bucket j and
// starts[bucket_count(n)] = n. Without starts one bucket holds them all.
struct IdIndex {
  const int* ids;
  const unsigned short* starts;
  int n, lo, hi, shift;
};

// ids[0:n) into shared memory at `at` (16-byte aligned), by 16-byte pieces
// where the ids' base allows; trap unless they ascend strictly (the search
// needs them sorted and unique; a trap fails the launch, and the stream's
// next synchronisation reports it). Each piece is tested with the id after
// it, loaded beside it.
__device__ __forceinline__ void copy_ids(unsigned char* at,
                                         const int* __restrict__ ids, int n,
                                         int tid) {
  int* ids_sm = reinterpret_cast<int*>(at);
  const int quads = ((uintptr_t)ids & 15) == 0 ? n >> 2 : 0;
  for (int i = tid; i < quads; i += blockDim.x) {
    const int4 v = reinterpret_cast<const int4*>(ids)[i];
    const int next = 4 * i + 4 < n ? ids[4 * i + 4] : 0;
    reinterpret_cast<int4*>(ids_sm)[i] = v;
    if (!(v.x < v.y && v.y < v.z && v.z < v.w
          && (4 * i + 4 >= n || v.w < next)))
      __trap();
  }
  for (int i = quads * 4 + tid; i < n; i += blockDim.x) {
    ids_sm[i] = ids[i];
    if (i + 1 < n && ids[i] >= ids[i + 1]) __trap();
  }
}

// After the barrier that ends copy_ids (n >= 1): the index without
// buckets, or (`buckets`) with them, built and ended by a barrier.
__device__ __forceinline__ IdIndex index_ids(unsigned char* at, int n,
                                             int tid, bool buckets) {
  const int* ids_sm = reinterpret_cast<const int*>(at);
  const int lo = ids_sm[0], hi = ids_sm[n - 1];
  if (!buckets) return IdIndex{ids_sm, nullptr, n, lo, hi, 0};
  unsigned short* starts = reinterpret_cast<unsigned short*>(at + n * 4);
  const int nb = bucket_count(n);
  int shift = 0;
  while ((((long long)hi - lo) >> shift) >= nb) ++shift;
  // id i starts the buckets after its predecessor's, up to its own
  auto bucket = [&](int i) {
    return (int)(((long long)ids_sm[i] - lo) >> shift);
  };
  for (int i = tid; i < n; i += blockDim.x)
    for (int j = i ? bucket(i - 1) + 1 : 0; j <= bucket(i); ++j)
      starts[j] = (unsigned short)i;
  for (int j = bucket(n - 1) + 1 + tid; j <= nb; j += blockDim.x)
    starts[j] = (unsigned short)n;
  __syncthreads();
  return IdIndex{ids_sm, starts, n, lo, hi, shift};
}

// For each v[i], its rank among the indexed ids where it is there, else n
// (the zero row): the bucket of v, then K branchless searches in lock step
// within the buckets.
template <int K>
__device__ __forceinline__ void find_rows(const IdIndex& ix,
                                          const int (&v)[K], int (&r)[K]) {
  int base[K], len[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool in = v[i] >= ix.lo && v[i] <= ix.hi;
    if (ix.starts) {
      const int j = in ? (int)(((long long)v[i] - ix.lo) >> ix.shift) : 0;
      base[i] = ix.starts[j];
      len[i] = in ? ix.starts[j + 1] - base[i] : 0;
    } else {
      base[i] = 0;
      len[i] = in ? ix.n : 0;
    }
  }
  for (;;) {
    bool more = false;
#pragma unroll
    for (int i = 0; i < K; ++i) more |= len[i] > 1;
    if (!more) break;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (len[i] > 1) {
        const int h = len[i] >> 1;
        if (ix.ids[base[i] + h] <= v[i]) base[i] += h;
        len[i] -= h;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
    r[i] = len[i] > 0 && ix.ids[base[i]] == v[i] ? base[i] : ix.n;
}

// A warp's 16 targets x 16 channels, given as the four 8x8 fragments of an
// mma A operand or accumulator (targets 0-7 | 8-15 x channels 0-7, then
// the same for channels 8-15; lane l holding target l/4 and channels
// 2(l%4), 2(l%4)+1), stored channel-major: out points at target 0 of
// channel 0, a channel every ld elements. stmatrix.trans lays them out as
// [channel][16 targets] in the warp's slice, from which lane l stores the
// 16 bytes of channel l/2, targets 8(l%2)..8(l%2)+7.
__device__ __forceinline__ void store_tile(const uint32_t (&r)[4],
                                           uint32_t st_sa,
                                           const unsigned char* st,
                                           __nv_bfloat16* __restrict__ out,
                                           size_t ld, int lane) {
  const int j = lane >> 3;
  stmatrix_x4_trans(st_sa + ((lane & 7) + ((j >> 1) << 3)) * kRowBytes
                        + (j & 1) * 16, r);
  __syncwarp();
  const uint4 v = *reinterpret_cast<const uint4*>(st + lane * 16);
  *reinterpret_cast<uint4*>(out + (size_t)(lane >> 1) * ld
                            + (lane & 1) * 8) = v;
  __syncwarp();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// P2 without weights: only the ids are staged (with their bucket starts);
// a warp step takes 16 targets of one tap k, and lane l gathers channel
// l/2 of 8 of them from x (through L1; a miss reads row 0 and is masked,
// so that all 8 loads are in flight at once) into one 16-byte store ->
// rows k*kC.. of out. The first step's wanted ids are loaded before the
// staging.
__global__ void __launch_bounds__(kWinThreads)
window_gather_kernel(const unsigned short* __restrict__ x,
                     const int* __restrict__ ids,
                     const int* __restrict__ want,
                     __nv_bfloat16* __restrict__ out, int s, int taps,
                     int w_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int stride = gridDim.x * kWarps;
  const int m = lane & 15, ch = lane >> 1, t0 = (lane & 1) * 8;
  const int steps = w_len / 16, n_steps = taps * steps;
  int u = blockIdx.x * kWarps + warp;
  int v[1] = {u < n_steps ? want[(size_t)(u / steps) * w_len
                                 + (u % steps) * 16 + m] : 0};
  copy_ids(smem, ids, s, tid);
  __syncthreads();
  const IdIndex ix = index_ids(smem, s, tid, false);
  for (; u < n_steps; u += stride) {
    const int k = u / steps, w0 = (u - k * steps) * 16;
    int r[1];
    find_rows<1>(ix, v, r);
    const int nu = u + stride;
    if (nu < n_steps)
      v[0] = want[(size_t)(nu / steps) * w_len + (nu % steps) * 16 + m];
    uint32_t g[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int re = __shfl_sync(0xffffffffu, r[0], t0 + e);
      const uint32_t xe = x[(size_t)ch * s + (re < s ? re : 0)];
      g[e] = re < s ? xe : 0u;
    }
    *reinterpret_cast<uint4*>(out + ((size_t)k * kC + ch) * w_len + w0
                              + t0) =
        make_uint4(g[0] | (g[1] << 16), g[2] | (g[3] << 16),
                   g[4] | (g[5] << 16), g[6] | (g[7] << 16));
  }
}

// The inputs of a chunk's positions, loaded for taps k0 + 2p + half <
// taps (each load alone under its predicate, so that all are in flight at
// once) and targets w0 + 16mt + m of step u: P3 rel (ra) and the start of
// the step's 128-target tile (rb, the same for its kMT groups), P2 the
// wanted id (ra).
template <bool kBanded>
__device__ __forceinline__ void load_positions(
    const int* __restrict__ want, const int* __restrict__ starts,
    const int* __restrict__ rel, int u, int k0, int steps, int taps,
    int tiles, int w_len, int half, int m, int (&ra)[kMT][kPairs],
    int (&rb)[kPairs]) {
  const int b = u / steps, w0 = (u - b * steps) * 16 * kMT;
  const int* ap = (kBanded ? rel : want) + (size_t)(k0 + half) * w_len + w0
      + m;
  const int* bp = kBanded ? starts + ((size_t)b * taps + k0 + half) * tiles
      + (w0 >> 7) : nullptr;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const bool in = k0 + 2 * p + half < taps;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      ra[mt][p] = 0;
      if (in) ra[mt][p] = ap[(size_t)(2 * p) * w_len + mt * 16];
    }
    rb[p] = 0;
    if (kBanded && in) rb[p] = bp[(size_t)(2 * p) * tiles];
  }
}

// A chunk's source rows from its loaded inputs, as row_base offsets:
// n_rows (the zero row) for a tap beyond taps and for nothing gathered (P3:
// rel outside [0, band_len) or the column outside [0, s); P2: the id not
// among the staged). P3 adds in 32-bit unsigned arithmetic, which is exact
// wherever rel lies in the band.
template <bool kBanded>
__device__ __forceinline__ void resolve_positions(
    const IdIndex& ix, const int (&ra)[kMT][kPairs], const int (&rb)[kPairs],
    int k0, int taps, unsigned band_len,
    int s, int n_rows, int half, int (&mine)[kMT][kPairs]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (kBanded) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const unsigned d = (unsigned)ra[mt][p];
        const unsigned q = (unsigned)rb[p] + d;
        mine[mt][p] = (int)row_base(k0 + 2 * p + half < taps && d < band_len
                                    && q < (unsigned)s ? (int)q : n_rows);
      }
    } else {
#pragma unroll
      for (int p0 = 0; p0 < kPairs; p0 += kSearch) {
        int v[kSearch], r[kSearch];
#pragma unroll
        for (int i = 0; i < kSearch; ++i)
          v[i] = p0 + i < kPairs ? ra[mt][p0 + i] : 0;
        find_rows<kSearch>(ix, v, r);
#pragma unroll
        for (int i = 0; i < kSearch; ++i)
          if (p0 + i < kPairs)
            mine[mt][p0 + i] = (int)row_base(
                k0 + 2 * (p0 + i) + half < taps ? r[i] : n_rows);
      }
    }
  }
}

// P2 with weights (kBanded false: rows by search among the first n_rows
// ids) and P3 (kBanded true: rows starts + rel, n_rows == s): a warp step
// takes kMT groups of 16 targets of block b -> columns b*w_len + .. of the
// (kC, blocks*w_len) out; each B fragment read serves the kMT groups.
template <bool kBanded>
__global__ void __launch_bounds__(kWinThreads, 1)
window_product_kernel(const unsigned short* __restrict__ x,
                      const int* __restrict__ ids,
                      const int* __restrict__ want,
                      const int* __restrict__ starts,
                      const int* __restrict__ rel,
                      const unsigned short* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int s, int n_rows,
                      int taps, int w_len, int blocks, int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w_stride = weight_stride(taps);
  unsigned char* w_sm = smem + (n_rows + 1) * kRowBytes;
  unsigned char* st = w_sm + kC * w_stride + warp * kStoreBytes;
  // the first chunk's position inputs are loaded before the staging
  const int m = lane & 15, half = lane >> 4;
  const int steps = w_len / (16 * kMT), tiles = w_len / kTile;
  const int n_steps = blocks * steps, stride = gridDim.x * kWarps;
  int u = blockIdx.x * kWarps + warp, k0 = 0;
  int ra[kMT][kPairs], rb[kPairs];
  if (u < n_steps)
    load_positions<kBanded>(want, starts, rel, u, 0, steps, taps, tiles,
                            w_len, half, m, ra, rb);
  unsigned char* ids_at = w_sm + kC * w_stride + kWarps * kStoreBytes;
  if (!kBanded) copy_ids(ids_at, ids, n_rows, tid);
  stage_rows(smem, x, s, n_rows, tid);
  stage_weights(w_sm, w, taps, tid);
  __syncthreads();
  IdIndex ix{};
  if (!kBanded) ix = index_ids(ids_at, n_rows, tid, true);

  const uint32_t win_sa = fp::smem_addr(smem), st_sa = fp::smem_addr(st);
  // B of tap k: lane l gives row (l%8) + 8(l/16) (the output channel) of
  // the weights at channels 8((l/8)%2).. of the tap: blocks n-tile 0 k
  // 0-7, k 8-15, n-tile 1 k 0-7, k 8-15
  const uint32_t b_sa = fp::smem_addr(w_sm)
      + ((lane & 7) + ((lane >> 4) << 3)) * w_stride + ((lane >> 3) & 1) * 16;
  const size_t ld = (size_t)blocks * w_len;
  const unsigned band_len = band > (1 << 24) ? ~0u : (unsigned)band * kTile;
  float acc[kMT][kNT][4];
  // chunk (step u, taps k0..k0+2kPairs-1) after chunk: the next chunk's
  // position inputs are in flight while this one multiplies
  while (u < n_steps) {
    // row_base of target w0 + 16mt + m at tap k0 + 2p + half: mine[mt][p]
    int mine[kMT][kPairs];
    resolve_positions<kBanded>(ix, ra, rb, k0, taps, band_len, s, n_rows,
                               half, mine);
    const int b = u / steps, w0 = (u - b * steps) * 16 * kMT;
    const int k_this = k0;
    k0 += 2 * kPairs;
    if (k0 >= taps) {
      k0 = 0;
      u += stride;
    }
    if (u < n_steps)
      load_positions<kBanded>(want, starts, rel, u, k0, steps, taps, tiles,
                              w_len, half, m, ra, rb);
    if (k_this == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    // the chunk's taps k_this + q (the same in every lane): B from the
    // weights, then per 16 targets A straight from the window (a shuffle
    // hands each lane the row of its ldmatrix address) and two mma
#pragma unroll
    for (int q = 0; q < 2 * kPairs; ++q) {
      if (k_this + q < taps) {
        uint32_t fb[4];
        fp::ldmatrix_x4(fb, b_sa + (k_this + q) * kC * 2);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int r = __shfl_sync(0xffffffffu, mine[mt][q >> 1],
                                    m | ((q & 1) << 4));
          uint32_t fa[4];
          fp::ldmatrix_x4(fa, win_sa + ((uint32_t)r ^ (half << 4)));
          fp::mma_bf16(acc[mt][0], fa, fb[0], fb[1]);
          fp::mma_bf16(acc[mt][1], fa, fb[2], fb[3]);
        }
      }
    }
    if (k0 == 0) {                              // the step's last chunk
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint32_t d[4] = {pack_bf16(acc[mt][0][0], acc[mt][0][1]),
                               pack_bf16(acc[mt][0][2], acc[mt][0][3]),
                               pack_bf16(acc[mt][1][0], acc[mt][1][1]),
                               pack_bf16(acc[mt][1][2], acc[mt][1][3])};
        store_tile(d, st_sa, st, out + (size_t)b * w_len + w0 + mt * 16, ld,
                   lane);
      }
    }
  }
}

// Launch one of the window kernels over `steps` warp steps: a block of
// kWarps warps for every kWarps steps, one on each SM at most. The
// kernel's dynamic shared memory is opted up to the card's limit at its
// first launch on each device.
template <auto kKernel, typename... Args>
int launch_window(int smem, int steps, cudaStream_t stream, Args... args) {
  static int sms[64] = {};
  if (smem > fp::kSmemMax) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    if ((err = cudaFuncSetAttribute(
             kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             fp::kSmemMax)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    sms[dev] = n;
  }
  int grid = (steps + kWarps - 1) / kWarps;
  if (grid > sms[dev]) grid = sms[dev];
  if (grid == 0) return 0;
  kKernel<<<grid, kWinThreads, smem, stream>>>(args...);
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

// P2: x (c, s) bf16 channel-major, ids (s,) int32 sorted unique (the
// kernel traps otherwise), want (taps, w_len) int32; c == 16, w_len % 128
// == 0. weighted == 0: all s ids compared, out (taps*c, w_len) bf16 (n_ids
// == s, blocks == 1; the s ids must fit in the card's dynamic shared
// memory). Else the first n_ids ids compared, w the (cout, taps*c) bf16
// weights, cout == 16, out (cout, blocks*w_len) bf16, and window_smem of
// the staged rows and ids must fit.
int fp_onehot_gather(const void* x, const int* ids, const int* want,
                     const void* w, void* out, int c, int s, int n_ids,
                     int taps, int w_len, int cout, int blocks, int weighted,
                     void* stream) {
  if (c != kC || w_len % kTile || taps < 1 || n_ids < 1 || n_ids > s
      || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const auto xs = (const unsigned short*)x;
  if (!weighted) {
    if (n_ids != s || blocks != 1) return (int)cudaErrorInvalidValue;
    return launch_window<window_gather_kernel>(
        s * 4, taps * (w_len / 16),
        (cudaStream_t)stream, xs, ids, want, (__nv_bfloat16*)out, s, taps,
        w_len);
  }
  if (cout != kC) return (int)cudaErrorInvalidValue;
  return launch_window<window_product_kernel<false>>(
      window_smem(n_ids, n_ids, taps), blocks * (w_len / (16 * kMT)),
      (cudaStream_t)stream, xs, ids, want, (const int*)nullptr,
      (const int*)nullptr, (const unsigned short*)w, (__nv_bfloat16*)out, s,
      n_ids, taps, w_len, blocks, 0);
}

// P3: starts (blocks, taps, w_len/128) int32, x (c, s) bf16 channel-major,
// rel (taps, w_len) int32, w the (cout, taps*c) bf16 weights, c == cout ==
// 16; out (cout, blocks*w_len) bf16. window_smem of the s rows must fit in
// the card's dynamic shared memory.
int fp_banded_gather_conv(const int* starts, const void* x, const int* rel,
                          const void* w, void* out, int c, int s, int taps,
                          int w_len, int cout, int blocks, int band,
                          void* stream) {
  if (c != kC || cout != kC || w_len % kTile || taps < 1 || s < 1
      || blocks < 1)
    return (int)cudaErrorInvalidValue;
  return launch_window<window_product_kernel<true>>(
      window_smem(s, 0, taps), blocks * (w_len / (16 * kMT)),
      (cudaStream_t)stream, (const unsigned short*)x, (const int*)nullptr,
      (const int*)nullptr, starts, rel, (const unsigned short*)w,
      (__nv_bfloat16*)out, s, s, taps, w_len, blocks, band);
}

}  // extern "C"
