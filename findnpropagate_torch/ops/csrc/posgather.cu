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

#include "gather_mma.cuh"

namespace {

constexpr int kPosThreads = 256;
constexpr int kTile = fp::kConvTile;        // targets per conv tile
constexpr int kThreads = fp::kConvThreads;  // 8 warps x 16 rows

using fp::lower_bound;

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
            int sentinel, int resident, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int cout = NT * 8;
  const int tid = threadIdx.x;
  const int wg_bytes = 3 * cin * cout * 2;
  const int a_bytes = kTile * fp::tile_stride(cin);
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
      fp::resolve_probes(win, window, lo_b, hit ? pv : ~pv, hit,
                         tgtb[t0 + r] + gdeltas[g], rows + g * 3 * kTile,
                         kTile, r);
    }
    __syncthreads();

    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    fp::conv_tile<NT>(
        acc, (1u << g_n) - 1u, w, smem, a_sa, feats + (size_t)b * vs * cin,
        rows, cin, resident, stages, tid);
    fp::store_tile<NT>(acc, outb, tgtb + t0, scale, shift, epilogue, relu,
                       sentinel, tid);
  }
}

template <int NT>
int launch_conv(const int* src, const void* feats, const int* tgt,
                const int* pos, const int* lo, const int* has_real,
                const int* gdeltas, const void* w, const float* scale,
                const float* shift, float* out, int batch, int vs, int vt,
                int nb, int g_n, int block, int window, int cin, int epilogue,
                int relu, int sentinel, cudaStream_t stream) {
  // the rows: g_n x 3 x kTile int
  const fp::ConvPlan plan = fp::conv_plan(g_n, cin, NT * 8,
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
      block, window, cin, epilogue, relu, sentinel, plan.resident,
      plan.stages);
  return (int)cudaGetLastError();
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

// out (B, Vt, Cout) f32 from feats (B, Vs, Cin) bf16 and w, the (G*3*Cin,
// Cout) bf16 weights (row g*3Cin + zi*Cin + c) packed in mma fragment order:
// [g][k-slab of 16][n-tile of 8][lane][4], lane l holding rows 2(l%4),
// 2(l%4)+1, 2(l%4)+8, 2(l%4)+9 of column l/4. Cin % 16 == 0 and <= 128;
// Cout a power of two in [8, 128]; block % 128 == 0; Vt % block == 0
// (checked by the caller).
int fp_posgather_conv(const int* src, const void* feats, const int* tgt,
                      const int* pos, const int* lo, const int* has_real,
                      const int* gdeltas, const void* w, const float* scale,
                      const float* shift, float* out, int batch, int vs,
                      int vt, int nb, int g_n, int block, int window,
                      int cin, int cout, int epilogue, int relu,
                      int sentinel, void* stream) {
#define FP_CONV_CASE(NT)                                                    \
  case NT * 8:                                                              \
    return launch_conv<NT>(src, feats, tgt, pos, lo, has_real, gdeltas, w,  \
                           scale, shift, out, batch, vs, vt, nb, g_n,       \
                           block, window, cin, epilogue, relu, sentinel,    \
                           (cudaStream_t)stream)
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
