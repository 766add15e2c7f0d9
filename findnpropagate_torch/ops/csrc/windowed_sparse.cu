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
//    the same kernel on swapped id lists with the taps reversed and negated
//    and W[26-k]^T (the same (delta, weight) pairs in group order).
//    Bound: bytes, at every width of the model, for the least work (each
//    input read once, 2*Cin*Cout flop per neighbour found). The work done
//    is 27 gathered bf16 rows per target (from L2) times dense 27-tap
//    products, zeros on a miss: Cout flop per gathered byte, far below the
//    card's ridge at 16 channels (bytes, and the latency of the search ->
//    row loads), near it from 64 on (operations). Design: K2's body on the
//    tensor cores (gather_mma.cuh conv_tile / store_tile) with the ranks
//    searched in the kernel instead of read from K1. The K taps are G
//    (dy, dx) groups of S consecutive ids (S, the kernel's z size, a
//    template argument: 27 taps are 9 groups of three, 125 are 25 of five,
//    a 2D (1, 3, 3) kernel's 9 taps 9 groups of one): one binary search of
//    the group's middle in the block's window slice gives its S taps with
//    K2's exact-id probes (G searches per target instead of K; the TPU
//    aligns ids by a one-hot compare of the whole window instead). Tiles of
//    128 targets (one target block's window each) x all Cout; 8 warps of 16
//    rows with mma.sync m16n8k16 accumulators; A fragments by ldmatrix from
//    the gathered bf16 tile (16-byte cp.async, zero fill on a miss), B from
//    weights the wrapper packs in fragment order, resident in shared memory
//    up to 112 KB or streamed one group per stage. A two-stage ring keeps
//    group g+1's rows in flight while g multiplies; at 128 input channels
//    (transposed 128->64) two stages do not fit and the ring has one (64-row
//    tiles in two stages measured 14 % slower there: twice the weight
//    traffic per target). The block stages the window slice of its tile's
//    target block (up to 30 KB of ids) in shared memory with cp.async where
//    the budget allows, so the 9 x 128 searches of a tile read shared
//    memory (10 % faster at a strided shape than searching device memory);
//    persistent blocks walk contiguous runs of tiles, so a slice is staged
//    once per target block. A group without any neighbour in the tile is
//    neither gathered nor multiplied; the epilogue still runs, so a real
//    target without neighbours gets relu(shift). The wrapper picks the ring
//    and the staging (conv_plan). In the transposed direction a fine target
//    hits at most 8 of the 27 taps, but the 128 targets of a tile mix all
//    parities, so few groups are skipped: most products there are on zeros.
//
// K4 fp_windowed_dw replaces pallas_sparse.py _dw_kernel (:285; _dw_call
//    :345, pallas_call :380).
//    dW[k] = sum over samples and targets of gathered_k^T . g, (K, Cin,
//    Cout) f32 from bf16 operands.
//    Bound: operations at 64 channels (2*Cin*Cout flop per neighbour found
//    against Cin*2 + Cout*2 bytes read), bytes and search latency at 16 and
//    32. Design: the K taps are K/S (dy, dx) groups of S consecutive ids
//    (S in {1, 3, 5}, a template argument), so one search of the group's
//    middle id in the target block's window gives all S rows (the probes of
//    K2, with the same exact-id checks and window edges, so the neighbours
//    kept and dropped are those of a per-tap search). The grid is (group)
//    x (chunk of targets) x (sample), chunks sized for about three blocks
//    per SM. A 256-thread block keeps its group's S Cin x Cout f32 sum in
//    tensor-core accumulators (S x WN m16n8k16 tiles per warp, up to 96
//    registers per thread; the wrapper's channel slices keep it there) and
//    walks its chunk in tiles of 64 targets with the target axis as the
//    product's depth: dW_g += A^T (S Cin x 64) . G (64 x Cout), both read
//    with ldmatrix.trans from [target][channel] tiles. The tiles (gathered
//    rows, zero on a miss, and the g rows once for all S taps) arrive by 16-byte cp.async from bf16 copies that the wrapper
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

constexpr int kTile = fp::kConvTile;        // targets per conv tile
constexpr int kThreads = fp::kConvThreads;  // both kernels: 8 warps
constexpr int kDwTile = 64;      // targets per weight-gradient tile

// Shared memory of the conv: [weights: all groups, or `stages` of one
// group][`stages` gather tiles][rows: g_n x taps x kTile int][live-group
// mask, 16 bytes][window: `window` ids, when staged]. At Cout 128 (NT 16)
// the registers are not capped at 128 (the S-tap probes and the
// accumulating store spill there), so such a block may hold an SM alone;
// most 3D convs of that width need more than half an SM's shared memory
// and did so anyway.
template <int NT, int S>
__global__ void __launch_bounds__(kThreads, NT >= 16 ? 1 : 2)
windowed_conv_kernel(const int* __restrict__ src,
                     const __nv_bfloat16* __restrict__ feats,
                     const int* __restrict__ tgt, const int* __restrict__ lo,
                     const int* __restrict__ centres,
                     const unsigned char* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ out,
                     int vs, int vt, int nb, int g_n, int block,
                     int window, int cin, int epilogue, int relu,
                     int sentinel, int accumulate, int resident, int stages,
                     int stage_window, int n_tiles, int tiles_per_block) {
  constexpr int cout = NT * 8;
  constexpr int taps = S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg_bytes = taps * cin * cout * 2;
  const int a_bytes = kTile * fp::tile_stride(cin, taps);
  const int w_bytes = (resident ? g_n : stages) * wg_bytes;
  const uint32_t a_sa = fp::smem_addr(smem) + w_bytes;
  int* rows = reinterpret_cast<int*>(smem + w_bytes + stages * a_bytes);
  unsigned* live = reinterpret_cast<unsigned*>(rows + g_n * taps * kTile);
  int* win_sm = reinterpret_cast<int*>(live + 4);

  if (resident) {     // published by the first tile's barrier
    fp::copy_async(fp::smem_addr(smem), w, g_n * wg_bytes, tid, kThreads);
    fp::cp_async_commit();
    fp::cp_async_wait<0>();
  }

  const int tiles_per_sample = vt / kTile;
  const int tile_hi = min(n_tiles, (int)(blockIdx.x + 1) * tiles_per_block);
  int staged = -1;                 // the target block whose slice is staged
  for (int tile = blockIdx.x * tiles_per_block; tile < tile_hi; ++tile) {
    const int b = tile / tiles_per_sample;
    const int t0 = (tile - b * tiles_per_sample) * kTile;
    const int bi = b * nb + t0 / block;
    const int* tgtb = tgt + (size_t)b * vt;
    float* outb = out + ((size_t)b * vt + t0) * cout;

    // targets ascend, so a tile whose first id is a sentinel is all
    // sentinels; the condition is the same for the whole block
    if (epilogue && tgtb[t0] >= sentinel) {
      fp::zero_tile(outb, cout, tid);
      continue;
    }

    const int lo_b = lo[bi];
    const int* win = src + (size_t)b * vs + lo_b;
    if (tid == 0) *live = 0u;
    if (stage_window) {
      if (bi != staged) {
        fp::copy_async(fp::smem_addr(win_sm), win, window * 4, tid, kThreads);
        fp::cp_async_commit();
        fp::cp_async_wait<0>();
        staged = bi;
      }
      win = win_sm;
    }
    __syncthreads();

    // one search per (target, group); a warp's 32 targets share a group
    for (int p = tid; p < g_n * kTile; p += kThreads) {
      const int g = p / kTile, r = p - g * kTile;
      const int centre = tgtb[t0 + r] + centres[g];
      const int rank = fp::lower_bound(win, window, centre);
      const int hit = rank < window && win[rank] == centre;
      const int found = fp::resolve_probes_s<S>(
          win, window, lo_b, rank, hit, centre, rows + g * taps * kTile,
          kTile, r);
      if (__any_sync(0xffffffffu, found) && (tid & 31) == 0)
        atomicOr(live, 1u << g);
    }
    __syncthreads();
    const unsigned mask = *live;

    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    fp::conv_tile<NT>(acc, mask, w, smem, a_sa, feats + (size_t)b * vs * cin,
                      rows, cin, taps, resident, stages, tid);
    // conv_tile ends on a barrier unless no group was live; then this one
    // keeps the next tile's reset of `live` behind every read of it
    if (mask == 0u) __syncthreads();
    fp::store_tile<NT>(acc, outb, tgtb + t0, scale, shift, epilogue, relu,
                       sentinel, accumulate, tid);
  }
}

template <int NT, int S>
int launch_conv(const int* src, const void* feats, const int* tgt,
                const int* lo, const int* centres, const void* w,
                const float* scale, const float* shift, float* out,
                int batch, int vs, int vt, int nb, int g_n, int block,
                int window, int cin, int epilogue, int relu, int sentinel,
                int accumulate, int resident, int stages, int stage_window,
                cudaStream_t stream) {
  constexpr int taps = S;
  // the caller's plan, with the rows (g_n x taps x kTile int), the
  // live-group mask (16 bytes) and the staged window slice
  const int smem = fp::conv_smem(
      g_n, taps, cin, NT * 8, resident, stages,
      g_n * taps * kTile * 4 + 16 + (stage_window ? window * 4 : 0));
  if (smem > fp::kSmemMax
      || (resident && g_n * taps * cin * NT * 8 * 2 > fp::kResidentMax))
    return (int)cudaErrorInvalidValue;
  int slots = 0;
  cudaError_t err = fp::persistent_slots(windowed_conv_kernel<NT, S>, smem,
                                         &slots);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks, each a contiguous run of tiles (so a run shares
  // its target blocks' window slices)
  const int n_tiles = batch * (vt / kTile);
  const int per_block = (n_tiles + slots - 1) / slots;
  const int grid = (n_tiles + per_block - 1) / per_block;
  windowed_conv_kernel<NT, S><<<grid, kThreads, smem, stream>>>(
      src, (const __nv_bfloat16*)feats, tgt, lo, centres,
      (const unsigned char*)w, scale, shift, out, vs, vt, nb, g_n, block,
      window, cin, epilogue, relu, sentinel, accumulate, resident, stages,
      stage_window, n_tiles, per_block);
  return (int)cudaGetLastError();
}

// Shared memory: two stages of [gather tile: kDwTile x (S Cin + 8) bf16]
// [g tile: kDwTile x (Cout + 8) bf16], then rows: 2 x S x kDwTile int.
// Warps: cin/16 along the S Cin axis (S m-tiles each) x cout/(8 WN) along
// Cout (WN n-tiles each); warps beyond that product only gather. S * WN * 4
// accumulators a thread: one block per SM from 80 on.
template <int S, int WN>
__global__ void __launch_bounds__(kThreads, S * WN >= 20 ? 1 : 2)
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
  const int a_stride = fp::tile_stride(cin, S);
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

  float acc[S][WN][4];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // search one tile's targets, resolve their S probes into rows[st];
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
      found = fp::resolve_probes_s<S>(win, window, lo_b, r, hit, centre,
                                      rows + st * S * kDwTile, kDwTile, tid);
    }
    return __syncthreads_or(found);
  };
  auto start_tile = [&](int tile, int st) {
    const uint32_t a_sa = sa + st * (a_bytes + g_bytes);
    fp::gather_tile<kDwTile>(a_sa, fb, rows + st * S * kDwTile, cin, S, tid,
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
        uint32_t a[S][4];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int c0 = (wmi * S + i) * 16;
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
          for (int i = 0; i < S; ++i) {
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
        + (((size_t)b * n_chunks + ch) * g_n + grp) * (size_t)(S * cin) * cout;
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = (wmi * S + i) * 16 + (lane >> 2) + half * 8;
          const int col = (wni * WN + j) * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(p + (size_t)row * cout + col) =
              make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
        }
  }
}

// dw[zi * g_n + grp][c][o] = sum over the partials, in their order, of
// partial[.][grp][zi * cin + c][o], zi < taps.
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dw, int n_partials,
                                 int g_n, int taps, int cin, int cout) {
  const int n = g_n * taps * cin * cout;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int o = e % cout, c = (e / cout) % cin, k = e / (cout * cin);
  const int zi = k / g_n, grp = k - zi * g_n;
  const float* p =
      partial + ((size_t)grp * taps * cin + zi * cin + c) * cout + o;
  float s = 0.f;
  for (int i = 0; i < n_partials; ++i) s += p[(size_t)i * n];
  dw[e] = s;
}

template <int S, int WN>
int launch_dw(const int* src, const void* feats, const int* tgt,
              const void* g, const int* lo, const int* centres,
              float* partial, int batch, int vs, int vt, int nb, int g_n,
              int block, int window, int cin, int cout, int n_chunks,
              cudaStream_t stream) {
  const int smem = 2 * kDwTile * ((S * cin * 2 + 16) + (cout * 2 + 16))
      + 2 * S * kDwTile * 4;
  if (smem > fp::kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      windowed_dw_kernel<S, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = vt / kDwTile;
  const int tiles_per_chunk = (n_tiles + n_chunks - 1) / n_chunks;
  dim3 grid(g_n, n_chunks, batch);
  windowed_dw_kernel<S, WN><<<grid, kThreads, smem, stream>>>(
      src, (const __nv_bfloat16*)feats, tgt, (const __nv_bfloat16*)g, lo,
      centres, partial, vs, vt, nb, block, window, cin, cout,
      tiles_per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, Vt, Cout) f32 from src ids (B, Vs), feats (B, Vs, Cin) bf16, tgt
// ids (B, Vt), lo (B, nb) window starts, centres (G,) the tap groups'
// middle deltas (tap zi * G + g is centres[g] + zi - taps / 2), w the
// (G*taps*Cin, Cout) bf16 weights (row g*taps*Cin + zi*Cin + c) packed in
// mma fragment order as for fp_posgather_conv. A ring of `stages` (1 or 2),
// the weights `resident` or streamed, the window slice staged in shared
// memory or not (`stage_window`): the caller's plan, refused here if it does
// not fit. Cin % 16 == 0 and <= 128; Cout a power of two in [8, 128]; taps
// in {1, 3, 5}; G <= 32; block % 128 == 0; Vt % block == 0; window % 4 == 0
// and Vs % 4 == 0 (checked by the caller). Wider convs are tiles of these:
// one call per (Cout slice, Cin slice), out being the Cout slice's own
// buffer; `accumulate` adds the products to what out holds (the earlier
// Cin slices), and the epilogue goes with the last Cin slice only.
int fp_windowed_conv(const int* src, const void* feats, const int* tgt,
                     const int* lo, const int* centres, const void* w,
                     const float* scale, const float* shift, float* out,
                     int batch, int vs, int vt, int nb, int g_n, int block,
                     int window, int cin, int cout, int epilogue, int relu,
                     int sentinel, int stages, int resident,
                     int stage_window, int taps, int accumulate,
                     void* stream) {
  if (g_n < 1 || g_n > 32 || (stages != 1 && stages != 2)
      || (taps != 1 && taps != 3 && taps != 5))
    return (int)cudaErrorInvalidValue;
#define FP_K3_CASE(NT, S)                                                    \
  if (cout == NT * 8 && taps == S)                                           \
    return launch_conv<NT, S>(src, feats, tgt, lo, centres, w, scale, shift, \
                              out, batch, vs, vt, nb, g_n, block, window,    \
                              cin, epilogue, relu, sentinel, accumulate,     \
                              resident, stages, stage_window,                \
                              (cudaStream_t)stream)
#define FP_K3_TAPS(NT) FP_K3_CASE(NT, 1); FP_K3_CASE(NT, 3); FP_K3_CASE(NT, 5)
  FP_K3_TAPS(1);
  FP_K3_TAPS(2);
  FP_K3_TAPS(4);
  FP_K3_TAPS(8);
  FP_K3_TAPS(16);
#undef FP_K3_TAPS
#undef FP_K3_CASE
  return (int)cudaErrorInvalidValue;
}

// dw (taps G, Cin, Cout) f32, tap k = zi * G + group, from feats (B, Vs,
// Cin) bf16 and g (B, Vt, Cout) bf16, through partial (B * n_chunks, G,
// taps Cin, Cout) f32 scratch; centres (G,) are the groups' middle deltas.
// taps in {1, 3, 5}; Cin in {16, 32, 64, 128}; Cout a power of two in
// [16, 256]; Cin * Cout <= 8192, <= 4096 at taps 5 (the accumulators a
// thread holds); block % 64 == 0; Vt % block == 0 (checked by the caller).
// Wider gradients are tiles of these, one call per (Cin slice, Cout slice).
int fp_windowed_dw(const int* src, const void* feats, const int* tgt,
                   const void* g, const int* lo, const int* centres,
                   float* partial, float* dw, int batch, int vs, int vt,
                   int nb, int g_n, int block, int window, int cin, int cout,
                   int n_chunks, int taps, void* stream) {
  const int wm = cin / 16, nt = cout / 8;
  int wn = 8 / wm < nt / 2 ? 8 / wm : nt / 2;
  if (wm < 1 || wm > 8 || wn < 1) return (int)cudaErrorInvalidValue;
  int status = (int)cudaErrorInvalidValue;
#define FP_DW_CASE(S, WN)                                                    \
  if (taps == S && nt / wn == WN)                                            \
    status = launch_dw<S, WN>(src, feats, tgt, g, lo, centres, partial,      \
                              batch, vs, vt, nb, g_n, block, window, cin,    \
                              cout, n_chunks, (cudaStream_t)stream)
  FP_DW_CASE(1, 2);
  FP_DW_CASE(1, 4);
  FP_DW_CASE(1, 8);
  FP_DW_CASE(3, 2);
  FP_DW_CASE(3, 4);
  FP_DW_CASE(3, 8);
  FP_DW_CASE(5, 2);
  FP_DW_CASE(5, 4);
#undef FP_DW_CASE
  if (status != 0) return status;
  const int n = g_n * taps * cin * cout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partial, dw, batch * n_chunks, g_n, taps, cin, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
