// Position-gather sparse convolution for Hopper (sm_90a): the two kernels of
// the TransFusion inference path, bound through a plain C ABI (ctypes).
//
// K1 fp_level_positions replaces findnpropagate_tpu/ops/pallas_posgather.py
//    _positions_kernel / _positions_block (:75, :125; pallas_call :185)
//    together with the XLA prelude around it in compute_positions (:523-:599).
//    One block of threads per target block of `block` targets: it computes
//    the block's prelude integer for integer as the plain version does
//    (window start lo = the lower bound of first + d_min floored to ALIGN and
//    clamped to lo_max, base = src[lo], has_real and the last real target,
//    the union and tap-window overflow terms, each group's tap offset), then
//    for each target and each of the G (dy, dx) group-centre deltas D_g the
//    left-insertion rank of tgt + D_g in the block's sorted source-id
//    (sub-)window and a hit flag, written as hit ? rank : ~rank; blocks
//    without a real target write -1.
//    fp_positions runs the same kernel with the prelude supplied (lo, tap
//    offsets, has_real and the deltas read from device memory): one search.
//    Bound: bytes. The targets read once, the source ids under the live
//    blocks' windows once (neighbouring windows overlap: each block stages
//    its own, so the kernel reads shared ids again, mostly from L2), the
//    (G, Vt) int32 output written once.
//    Design: the TPU's compare-count over the whole window (a (span, block)
//    plane per group) becomes a log-time search giving the same rank, and the
//    prelude that XLA fused into the TPU program is computed in the kernel
//    instead of ~20 eager PyTorch operations with a host sync; each block
//    adds its overflow conditions to its sample's count atomically. One search
//    over the sample's whole id list is left (lo's): one warp runs it as a
//    32-way search (a ballot per step, 4 dependent loads for 120k ids) while
//    the other warps find the last real target. The window [lo, lo +
//    window) is then staged in shared memory by one TMA bulk copy completing
//    on an mbarrier (lo and the window are multiples of ALIGN ids, so the
//    copy is aligned; windows beyond 40 KB are searched in device memory).
//    Upper bounds are not searched: an overflow term hi - start > span holds
//    exactly where the id at start + span exists and is at most the bound's
//    value, one load. The tap offsets are lower bounds inside the staged
//    window, one warp per group. Each thread searches all G groups of a
//    target at once: a branchless search whose step count depends on the
//    span only, so the G searches interleave and hide shared-memory latency.
//    pos is written coalesced per group.
//
// K2 fp_posgather_conv replaces pallas_posgather.py _conv_kernel /
//    _conv_block (:194, :296; pallas_call :485).
//    For each target, its 27 neighbours are fetched through K1's ranks: in
//    group g, z-1 sits at rank-1, z at rank (only on a hit), z+1 at
//    rank+hit, each accepted only if the source id there is exactly the one
//    wanted; misses are zeros. out = sum_g G_g (targets x 3Cin) . W_g
//    (3Cin x Cout) with bf16 operands and f32 sums, then optionally
//    *scale + shift, ReLU, and zero where the target id >= sentinel. Dead
//    blocks and all-sentinel tiles write zeros.
//    Bound: 27*Cin*Cout*2 flop per target against ~(27*Cin*2 gathered +
//    Cout*4 written) bytes: the 16- and 32-channel convs sit below the
//    card's ridge (bytes, and in practice the latency of the dependent
//    pos -> id -> row loads), the 64-channel ones near it (operations).
//    Design: the products run on the tensor cores. A 256-thread block takes
//    tiles of 128 targets x all Cout, each of its 8 warps a 16-row slab with
//    Cout/8 m16n8k16 accumulators in registers. Per tile every thread
//    resolves probes ((target, group) pairs, ids and ranks read coalesced)
//    into 27 source rows per target; then group by group the 128 x 3Cin
//    bf16 tile is gathered with 16-byte cp.async pieces (zero fill on a
//    miss) into a two-stage ring, so group g+1's rows are in flight while
//    group g multiplies: A fragments by ldmatrix from the padded tile, B
//    fragments by one 8-byte load per lane from weights that the wrapper
//    packed in fragment order. Blocks are persistent (a grid of as many as
//    fit the SMs walks the tiles), so the weights are staged once per block
//    when all groups fit (27*Cin*Cout*2 <= 112 KB); wider convs stream one
//    group's weights per stage alongside its rows. Where shared memory does
//    not hold two stages (Cin = 128) the ring has one. The features arrive
//    as one bf16 copy made by the wrapper (the operands are bf16 anyway), so
//    a row costs half the bytes of the f32 original and needs no conversion
//    in the kernel. TMA is not used: it copies boxes of a tensor, and these
//    are scattered rows. The epilogue is fused on the accumulator fragments
//    and stores 8 bytes per lane (a full 32-byte sector per row and warp).
//    The tile's body (the ring, the products, the epilogue) is conv_tile /
//    store_tile of gather_mma.cuh, which K3 shares.
//
// Every entry launches on the stream it is given, allocates nothing, and
// returns the launch's error code.

#include <climits>

#include "gather_mma.cuh"

// K1's group-centre deltas, passed by value (no device buffer, no copy);
// outside the anonymous namespace, so the C entry that takes it is
// exported.
struct Deltas {
  int n;
  int d[9];
};

namespace {

constexpr int kPosThreads = 512;
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kMaxGroups = 9;               // tap groups of a 3x3x3 kernel
static_assert(sizeof(Deltas::d) == kMaxGroups * sizeof(int), "Deltas");
constexpr int kAlign = 512;                 // window starts: ALIGN ids
constexpr int kStageMaxIds = 10240;         // windows staged: <= 40 KB
constexpr int kTile = fp::kConvTile;        // targets per conv tile
constexpr int kThreads = fp::kConvThreads;  // 8 warps x 16 rows

struct PosArgs {
  const int* src;            // (B, vs) sorted ids
  const int* tgt;            // (B, vt) sorted ids
  // the prelude supplied (fp_positions), else null
  const int* lo_in;          // (B, nb)
  const int* tap_lo_in;      // (B, nb, G)
  const int* has_real_in;    // (B, nb)
  const int* gdeltas_in;     // (G,)
  // the prelude computed (fp_level_positions), else null
  int* lo;                   // (B, nb)
  int* base;                 // (B, nb)
  int* has_real;             // (B, nb)
  unsigned long long* ovf;   // (B,) overflow conditions, zeroed first
  int* pos;                  // (B, G, vt)
  Deltas deltas;             // g_n always; the values when computed
  long long sentinel;        // targets >= sentinel are padding
  int has_sentinel;
  int vs, vt, nb, block, window, span, use_tap, lo_max, stage;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(fp::smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device to shared memory by the TMA, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(fp::smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(fp::smem_addr(dst)), "l"(src), "r"(bytes),
         "r"(fp::smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(fp::smem_addr(bar)), "r"(parity) : "memory");
  }
}

// One warp: the number of a[0:n) (sorted) below v, the lower bound as
// torch.searchsorted gives it. Each step the 32 lanes probe 32 evenly
// spaced ids of the range left and a ballot keeps 1/32 of it.
__device__ __forceinline__ int warp_search(const int* __restrict__ a, int n,
                                           long long v) {
  const int lane = threadIdx.x & 31;
  int l = 0, r = n;  // the answer lies in [l, r]
  while (l < r) {
    const int step = (r - l + 31) >> 5;
    const int at = l + (lane + 1) * step - 1;
    const bool below = at < r && a[at] < v;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const int miss = l + (c + 1) * step - 1;  // the first probe not below
    if (c < 32 && miss < r) r = miss;
    l += c * step;
  }
  return l;
}

// Grid (nb, B): one block of threads per target block. With kPrelude the
// block computes its prelude; else it reads lo, the tap offsets, has_real
// and the deltas.
template <bool kPrelude>
__global__ void __launch_bounds__(kPosThreads)
level_positions_kernel(const PosArgs a) {
  extern __shared__ __align__(128) int win_sm[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int gd[kMaxGroups], off[kMaxGroups], tap_ovf[kMaxGroups];
  __shared__ int red_max[kPosWarps], red_any[kPosWarps];
  __shared__ int s_lo, s_real, s_last, s_ovf;
  const int b = blockIdx.y, i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bi = b * a.nb + i;
  const int g_n = a.deltas.n;
  const int* src = a.src + (size_t)b * a.vs;
  const int* tgt = a.tgt + (size_t)b * a.vt + (size_t)i * a.block;

  if (tid < g_n) gd[tid] = kPrelude ? a.deltas.d[tid] : a.gdeltas_in[tid];
  if (tid == 0 && a.stage > 0) mbar_init(&bar);
  if (kPrelude) {
    int d_min = a.deltas.d[0];
    for (int g = 1; g < g_n; ++g) d_min = min(d_min, a.deltas.d[g]);
    if (warp == 0) {
      // lo's lower bound over the sample's whole id list, while the other
      // warps find the last real target (the largest below the sentinel)
      const int r = warp_search(src, a.vs, (long long)tgt[0] + d_min - 1);
      if (lane == 0) s_lo = min(r / kAlign * kAlign, a.lo_max);
    } else if (a.has_sentinel) {
      int last = INT_MIN, any = 0;
      for (int t = tid - 32; t < a.block; t += kPosThreads - 32) {
        const int v = tgt[t];
        if (v < a.sentinel) {
          any = 1;
          last = max(last, v);
        }
      }
      last = __reduce_max_sync(0xffffffffu, last);
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) {
        red_max[warp] = last;
        red_any[warp] = any;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int last = INT_MIN, any = 0;
      if (a.has_sentinel) {
        for (int w = 1; w < kPosWarps; ++w) {
          last = max(last, red_max[w]);
          any |= red_any[w];
        }
      } else {
        last = tgt[a.block - 1];
        any = 1;
      }
      const int lo = s_lo;
      s_last = last;
      s_real = any;
      a.lo[bi] = lo;
      a.has_real[bi] = any;
      a.base[bi] = src[lo];
      // hi = the upper bound of last + d_max; hi - lo > window exactly
      // where the id at lo + window exists and is at most last + d_max
      int d_max = gd[0];
      for (int g = 1; g < g_n; ++g) d_max = max(d_max, gd[g]);
      const int end = lo + a.window;
      s_ovf = any && end < a.vs && src[end] <= (long long)last + d_max + 1;
    }
  } else {
    if (tid == 0) {
      s_lo = a.lo_in[bi];
      s_real = a.has_real_in[bi] != 0;
    }
    if (tid < g_n)
      off[tid] = a.use_tap ? a.tap_lo_in[(size_t)bi * g_n + tid] : 0;
  }
  __syncthreads();

  int* pos = a.pos + (size_t)b * g_n * a.vt + (size_t)i * a.block;
  const int lo = s_lo;
  if (!s_real) {
    for (int g = 0; g < g_n; ++g)
      for (int t = tid; t < a.block; t += kPosThreads)
        pos[(size_t)g * a.vt + t] = -1;
    return;
  }
  const int* win = src + lo;
  const bool staged = a.stage > 0 && (a.stage & 3) == 0
                      && lo + a.stage <= a.vs
                      && ((uintptr_t)win & 15) == 0;
  if (staged) {
    if (tid == 0) bulk_load(win_sm, win, a.stage * 4, &bar);
    mbar_wait(&bar, 0);
    win = win_sm;
  }

  if (kPrelude) {
    if (a.use_tap && warp < g_n) {
      // group g's tap offset: its lower bound from the window start (at
      // least lo; one past the window reads as the window's end, which
      // clamps the same), and the tap overflow term as the union's
      const long long first = tgt[0], last = s_last;
      const int r = warp_search(win, a.window, first + gd[warp] - 1);
      if (lane == 0) {
        const int rel = min(max(r & ~127, 0), a.window - a.span);
        const int end = lo + rel + a.span;
        off[warp] = rel;
        tap_ovf[warp] = end < a.vs && src[end] <= last + gd[warp] + 1;
      }
    } else if (!a.use_tap && tid < g_n) {
      off[tid] = 0;
    }
    __syncthreads();
    if (tid == 0) {
      int ovf = s_ovf;
      if (a.use_tap)
        for (int g = 0; g < g_n; ++g) ovf += tap_ovf[g];
      if (ovf) atomicAdd(a.ovf + b, (unsigned long long)ovf);
    }
  }

  for (int t = tid; t < a.block; t += kPosThreads) {
    const long long v = tgt[t];
    long long want[kMaxGroups];
    int at[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      want[g] = g < g_n ? v + gd[g] : 0;
      at[g] = g < g_n ? off[g] : 0;
    }
    // branchless lower bound: after the loop the rank is at[g] - off[g]
    // plus (win[at[g]] < want)
    for (int len = a.span; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
        if (g < g_n && win[at[g] + half] < want[g]) at[g] += half;
      len -= half;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= g_n) break;
      const int x = win[at[g]];
      const int r = at[g] - off[g] + (x < want[g]);
      const bool hit = x < want[g]
                           ? r < a.span && win[off[g] + r] == want[g]
                           : x == want[g];
      const int rank = r + off[g];
      pos[(size_t)g * a.vt + t] = hit ? rank : ~rank;
    }
  }
}

template <bool kPrelude>
int launch_positions(const PosArgs& a, int batch, cudaStream_t stream) {
  if (a.deltas.n < 1 || a.deltas.n > kMaxGroups || a.block <= 0
      || a.vt % a.block || a.span < 1)
    return (int)cudaErrorInvalidValue;
  if (a.vt == 0 || batch == 0) return 0;
  dim3 grid(a.nb, batch);
  level_positions_kernel<kPrelude><<<grid, kPosThreads, a.stage * 4,
                                     stream>>>(a);
  return (int)cudaGetLastError();
}

// Shared memory: [weights: all groups, or `stages` of one group]
// [`stages` gather tiles][rows: g_n x 3 x kTile int].
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const int* __restrict__ src,
            const __nv_bfloat16* __restrict__ feats,
            const int* __restrict__ tgt, const int* __restrict__ pos,
            const int* __restrict__ lo, const int* __restrict__ has_real,
            const int* __restrict__ gdeltas,
            const unsigned char* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ shift,
            float* __restrict__ out, int batch, int vs, int vt, int nb,
            int g_n, int block, int window, int cin, int epilogue, int relu,
            int sentinel, int accumulate, int resident, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int cout = NT * 8;
  const int tid = threadIdx.x;
  const int wg_bytes = 3 * cin * cout * 2;
  const int a_bytes = kTile * fp::tile_stride(cin, 3);
  const int w_bytes = (resident ? g_n : stages) * wg_bytes;
  const uint32_t a_sa = fp::smem_addr(smem) + w_bytes;
  int* rows = reinterpret_cast<int*>(smem + w_bytes + stages * a_bytes);

  if (resident) {
    fp::copy_async(fp::smem_addr(smem), w, g_n * wg_bytes, tid, kThreads);
    fp::cp_async_commit();
    fp::cp_async_wait<0>();
    __syncthreads();
  }

  const int tiles_per_sample = vt / kTile;
  const int n_tiles = batch * tiles_per_sample;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_sample;
    const int t0 = (tile - b * tiles_per_sample) * kTile;
    const int bi = b * nb + t0 / block;
    const int* tgtb = tgt + (size_t)b * vt;
    float* outb = out + ((size_t)b * vt + t0) * cout;

    // targets ascend, so a tile whose first id is a sentinel is all
    // sentinels; the condition is the same for the whole block
    if (has_real[bi] == 0 || (epilogue && tgtb[t0] >= sentinel)) {
      fp::zero_tile(outb, cout, tid);
      continue;
    }

    const int lo_b = lo[bi];
    const int* win = src + (size_t)b * vs + lo_b;
    for (int p = tid; p < g_n * kTile; p += kThreads) {
      const int g = p / kTile, r = p - g * kTile;
      const int pv = pos[((size_t)b * g_n + g) * vt + t0 + r];
      const int hit = pv >= 0;
      fp::resolve_probes_s<3>(win, window, lo_b, hit ? pv : ~pv, hit,
                              tgtb[t0 + r] + gdeltas[g],
                              rows + g * 3 * kTile, kTile, r);
    }
    __syncthreads();

    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    fp::conv_tile<NT>(
        acc, (1u << g_n) - 1u, w, smem, a_sa, feats + (size_t)b * vs * cin,
        rows, cin, 3, resident, stages, tid);
    fp::store_tile<NT>(acc, outb, tgtb + t0, scale, shift, epilogue, relu,
                       sentinel, accumulate, tid);
  }
}

template <int NT>
int launch_conv(const int* src, const void* feats, const int* tgt,
                const int* pos, const int* lo, const int* has_real,
                const int* gdeltas, const void* w, const float* scale,
                const float* shift, float* out, int batch, int vs, int vt,
                int nb, int g_n, int block, int window, int cin, int epilogue,
                int relu, int sentinel, int accumulate, cudaStream_t stream) {
  // the rows: g_n x 3 x kTile int
  const fp::ConvPlan plan = fp::conv_plan(g_n, 3, cin, NT * 8,
                                          g_n * 3 * kTile * 4);
  if (plan.smem > fp::kSmemMax) return (int)cudaErrorInvalidValue;
  int slots = 0;
  cudaError_t err = fp::persistent_slots(conv_kernel<NT>, plan.smem, &slots);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = batch * (vt / kTile);
  const int grid = n_tiles < slots ? n_tiles : slots;
  conv_kernel<NT><<<grid, kThreads, plan.smem, stream>>>(
      src, (const __nv_bfloat16*)feats, tgt, pos, lo, has_real, gdeltas,
      (const unsigned char*)w, scale, shift, out, batch, vs, vt, nb, g_n,
      block, window, cin, epilogue, relu, sentinel, accumulate, plan.resident,
      plan.stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The level's positions: lo / base / has_real (B, nb) int32, ovf (B,) int64
// (the count of overflow conditions of each sample's blocks) and pos
// (B, G, Vt) int32 from src ids (B, Vs) and tgt ids (B, Vt), both sorted,
// Vs % ALIGN == 0 (the caller pads), Vt % block == 0, the G <= 9 group-centre
// deltas by value. window: the union window (ALIGN-rounded, <= Vs);
// tap_window: the tap sub-window span, 0 for none (then the union window is
// searched); sentinel: targets at or above it are padding (has_sentinel 0:
// none); stage: 1 stages a window of at most 40 KB in shared memory, 0
// searches every window in device memory.
int fp_level_positions(const int* src, const int* tgt, int* lo, int* base,
                       int* has_real, long long* ovf, int* pos,
                       Deltas deltas,
                       long long sentinel, int has_sentinel, int batch,
                       int vs, int vt, int block, int window, int tap_window,
                       int stage, void* stream) {
  if (block <= 0 || window < 1 || window > vs || vs % kAlign
      || tap_window < 0 || tap_window >= window)
    return (int)cudaErrorInvalidValue;
  PosArgs a = {};
  a.src = src;
  a.tgt = tgt;
  a.lo = lo;
  a.base = base;
  a.has_real = has_real;
  a.ovf = (unsigned long long*)ovf;
  a.pos = pos;
  a.deltas = deltas;
  a.sentinel = sentinel;
  a.has_sentinel = has_sentinel;
  a.vs = vs;
  a.vt = vt;
  a.nb = vt / block;
  a.block = block;
  a.window = window;
  a.use_tap = tap_window > 0;
  a.span = a.use_tap ? tap_window : window;
  a.lo_max = vs - window >= 0 ? (vs - window) / kAlign * kAlign : 0;
  a.stage = stage && window <= kStageMaxIds ? window : 0;
  const cudaError_t err = cudaMemsetAsync(ovf, 0, sizeof(long long) * batch,
                                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return launch_positions<true>(a, batch, (cudaStream_t)stream);
}

// K1 with the prelude supplied: pos (B, G, Vt) int32 from src ids (B, Vs),
// tgt ids (B, Vt), lo / has_real (B, nb), tap_lo (B, nb, G), gdeltas (G,),
// G <= 9; span = tap window, or the union window when use_tap == 0; each
// searched window lies inside src's row (lo + tap_lo + span <= Vs).
int fp_positions(const int* src, const int* tgt, const int* lo,
                 const int* tap_lo, const int* has_real, const int* gdeltas,
                 int* pos, int batch, int vs, int vt, int nb, int g_n,
                 int block, int span, int use_tap, void* stream) {
  PosArgs a = {};
  a.src = src;
  a.tgt = tgt;
  a.lo_in = lo;
  a.tap_lo_in = tap_lo;
  a.has_real_in = has_real;
  a.gdeltas_in = gdeltas;
  a.pos = pos;
  a.deltas.n = g_n;
  a.vs = vs;
  a.vt = vt;
  a.nb = nb;
  a.block = block;
  a.window = span;
  a.span = span;
  a.use_tap = use_tap;
  // without tap offsets the searched window is [lo, lo + span)
  a.stage = !use_tap && span <= kStageMaxIds ? span : 0;
  return launch_positions<false>(a, batch, (cudaStream_t)stream);
}

// out (B, Vt, Cout) f32 from feats (B, Vs, Cin) bf16 and w, the (G*3*Cin,
// Cout) bf16 weights (row g*3Cin + zi*Cin + c) packed in mma fragment order:
// [g][k-slab of 16][n-tile of 8][lane][4], lane l holding rows 2(l%4),
// 2(l%4)+1, 2(l%4)+8, 2(l%4)+9 of column l/4. Cin % 16 == 0 and <= 128;
// Cout a power of two in [8, 128]; block % 128 == 0; Vt % block == 0
// (checked by the caller). Wider convs are tiles of these: one call per
// (Cout slice, Cin slice), out being the Cout slice's own (B, Vt, Cout)
// buffer; `accumulate` adds the products to what out holds (the earlier
// Cin slices), and the epilogue goes with the last Cin slice only.
int fp_posgather_conv(const int* src, const void* feats, const int* tgt,
                      const int* pos, const int* lo, const int* has_real,
                      const int* gdeltas, const void* w, const float* scale,
                      const float* shift, float* out, int batch, int vs,
                      int vt, int nb, int g_n, int block, int window,
                      int cin, int cout, int epilogue, int relu,
                      int sentinel, int accumulate, void* stream) {
#define FP_CONV_CASE(NT)                                                    \
  case NT * 8:                                                              \
    return launch_conv<NT>(src, feats, tgt, pos, lo, has_real, gdeltas, w,  \
                           scale, shift, out, batch, vs, vt, nb, g_n,       \
                           block, window, cin, epilogue, relu, sentinel,    \
                           accumulate, (cudaStream_t)stream)
  switch (cout) {
    FP_CONV_CASE(1);
    FP_CONV_CASE(2);
    FP_CONV_CASE(4);
    FP_CONV_CASE(8);
    FP_CONV_CASE(16);
  }
#undef FP_CONV_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
