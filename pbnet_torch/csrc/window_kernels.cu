// Banded-window clustering kernels for Hopper (sm_90a), plain C interface.
//
// Clustering (ops/cluster.py) sorts points by (group, l1 norm) and gives
// every chunk of `chunk` consecutive rows two windows of W sorted columns
// (left and right).  These four kernels are the passes over those tiles:
//
//   neighbor_pack        replaces pbnet_tpu/ops/pallas_kernels.py::neighbor_pack
//   masked_window_reduce replaces pallas_kernels.py::masked_window_reduce
//   masked_window_border replaces pallas_kernels.py::masked_window_border
//     and, in its PICK mode (a per-row target fixes the first-orig value),
//     pallas_kernels.py::masked_window_match_pick
//   window_1nn           replaces pallas_kernels.py::window_1nn
//
// Layouts (row-major, int32 unless noted):
//   rows_f (nchunks, 3, chunk) f32 row xyz;  rows_i (nchunks, 3, chunk)
//   (group, valid, global sorted index);  window planes wf (nchunks, 3, W)
//   f32 and wi (nchunks, 3|2, W);  bit words (nchunks, chunk, W/32): bit b
//   of word w is window column 32*w + b (stored as int32, uint32 pattern);
//   window values (nchunks, W).
//
// Exactness: squared distances are formed without FMA contraction, left to
// right, as the JAX reference does: ((dx*dx + dy*dy) + dz*dz) with every
// operation rounded on its own (__fmul_rn/__fadd_rn; the library is also
// built with -fmad=false).  A contracted d2 can flip a `d2 <= r2` bit or a
// 1-NN tie.
//
// Every launcher returns cudaGetLastError() so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // 8 warps
constexpr int ROWS_PER_BLOCK = 64;  // 8 rows per warp
constexpr int RPW = ROWS_PER_BLOCK / (THREADS / 32);
constexpr int TILE = 1024;          // window columns staged per pass (32 words)
constexpr int INF_I32 = 2147483647;

__device__ __forceinline__ float d2_rn(float rx, float ry, float rz,
                                       float cx, float cy, float cz) {
  const float dx = __fsub_rn(rx, cx);
  const float dy = __fsub_rn(ry, cy);
  const float dz = __fsub_rn(rz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// ---------------------------------------------------------------------------
// B1 neighbor_pack.  Bound on H100: operations — one pair test (9 f32 + 4
// int32 operations, chip_smoke.py PAIR_OPS) per VALID row and VALID window
// column.  At the bench shapes (55 chunks x 1,024 rows, W = 4,096) that is
// ~281 M pairs, against 461 M in the full 2 x nchunks x chunk x W grid: window
// 2 adds only the columns window 1 lacks (ops/cluster.py `fresh2`), so most
// of it is an invalid prefix, and padding rows are invalid.
//
// Design: lane = row.  A block owns 64 rows of one chunk, 2 per lane, in
// registers; its 8 warps share the window columns, 1,024 (32 words) per
// staged tile, both windows' tiles in one sequence.
// - Each thread loads its 4 columns of the NEXT tile into registers while
//   the current tile is tested, so the loads (L2 hits: neighboring chunks'
//   windows overlap) are hidden behind the pair tests.
// - Staging writes each column as a float4 (x, y, z, group bits) plus its
//   index, and a ballot over the 32 columns of a word flags the words with
//   any valid column.  Every warp takes its share of the FLAGGED words only;
//   the other words are written as zero without being tested, and a block
//   with no valid row tests nothing.  This is exact for any input, since an
//   invalid column or row never sets a bit.
// - Validity inside a tested word is folded into the float test: an invalid
//   column or row has x = NaN, so d2 is NaN and `d2 <= r2` is false, as the
//   validity test was.  The pair test is FSETP chained with the group and
//   index ISETPs into one predicate, then one predicated add of an immediate
//   bit (the 32 bit positions are fully unrolled).
// - All lanes read the same column (a shared-memory broadcast): one 16-byte
//   and one 4-byte load per column serve 2 pair tests per thread.
// - Each warp writes its words to a [64][33] tile in shared memory (lane =
//   row, stride 33: no bank conflict); after the tile, the block writes it
//   out as rows of 32 consecutive words (coalesced 128-byte stores).
// - Density: each thread adds __popc of its words; the 8 warps' partial
//   counts of a row meet in shared memory (integer atomics, exact).
// 2 rows per lane ran faster than 4 (880 blocks spread over the SMs more
// evenly than 440), and the register prefetch took a quarter off; a lower
// register cap for more blocks per SM, and an exact fast path that drops
// the index test where no index can match, gained nothing.
// At the bench shapes (chip_smoke.py on an H100 80GB HBM3 at 700 W): the
// kernel tests 280,983,552 pairs, exactly the pairs the bound counts; the
// hot loop is 829 SASS instructions for 64 pair tests, 12.95 per pair (5
// FADD, 3 FMUL, 1 FSETP, 2 ISETP, ~1 IADD3, 0.6 LDS); ptxas: 74 registers
// and 29,312 bytes of shared memory, so 3 blocks (24 warps) per SM, held by
// registers.
// ---------------------------------------------------------------------------
constexpr int NP_RPL = 2;                      // rows per lane
constexpr int NP_ROWS = 32 * NP_RPL;           // rows per block
constexpr int NP_WORDS = TILE / 32;            // words per staged tile
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
neighbor_pack_kernel(const float* __restrict__ rows_f, const int* __restrict__ rows_i,
                     const float* __restrict__ w1f, const int* __restrict__ w1i,
                     const float* __restrict__ w2f, const int* __restrict__ w2i,
                     float r2, uint32_t* __restrict__ bits1,
                     uint32_t* __restrict__ bits2, int* __restrict__ dens,
                     int chunk, int W) {
  __shared__ float4 scol[TILE];  // (x, or NaN for an invalid column; y; z; group)
  __shared__ int sidx[TILE];
  __shared__ uint32_t sout[NP_ROWS][NP_WORDS + 1];
  __shared__ int sflag[NP_WORDS];
  __shared__ int sdens[NP_ROWS];
  const float qnan = __int_as_float(0x7fc00000);
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = W >> 5;
  const int r0 = blockIdx.x * NP_ROWS;

  const float* rf = rows_f + (size_t)c * 3 * chunk;
  const int* ri = rows_i + (size_t)c * 3 * chunk;
  float x[NP_RPL], y[NP_RPL], z[NP_RPL];
  int g[NP_RPL], id[NP_RPL], cnt[NP_RPL];
  bool any_row = false;
#pragma unroll
  for (int k = 0; k < NP_RPL; ++k) {
    const int r = r0 + lane + 32 * k;
    const bool in = r < chunk;
    const bool ok = in && ri[chunk + r] > 0;
    x[k] = ok ? rf[r] : qnan;
    y[k] = in ? rf[chunk + r] : 0.f;
    z[k] = in ? rf[2 * chunk + r] : 0.f;
    g[k] = in ? ri[r] : 0;
    id[k] = in ? ri[2 * chunk + r] : 0;
    cnt[k] = 0;
    any_row |= ok;
  }
  if (threadIdx.x < NP_ROWS) sdens[threadIdx.x] = 0;
  const bool live = __syncthreads_or(any_row);  // uniform: the block has a valid row

  // tiles q = 0 .. 2 * ntiles - 1 over both windows; tile q + 1's columns
  // load into registers while tile q is tested (a warp holds 32 consecutive
  // columns, one word, per step)
  const int ntiles = (W + TILE - 1) / TILE;
  constexpr int PER = TILE / THREADS;  // columns staged per thread
  float px[PER], py[PER], pz[PER];
  int pg[PER], pv[PER], pi[PER];
  auto fetch = [&](int q) {
    const int win = q >= ntiles;
    const int t0 = (q - win * ntiles) * TILE;
    const float* wf = (win == 0 ? w1f : w2f) + (size_t)c * 3 * W;
    const int* wi = (win == 0 ? w1i : w2i) + (size_t)c * 3 * W;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int col = t0 + threadIdx.x + i * THREADS;
      const bool in = col < W;
      px[i] = in ? wf[col] : 0.f;
      py[i] = in ? wf[W + col] : 0.f;
      pz[i] = in ? wf[2 * W + col] : 0.f;
      pg[i] = in ? wi[col] : 0;
      pv[i] = in ? wi[W + col] : 0;
      pi[i] = in ? wi[2 * W + col] : 0;
    }
  };
  if (live) fetch(0);
  for (int q = 0; q < 2 * ntiles; ++q) {
    const int win = q >= ntiles;
    const int t0 = (q - win * ntiles) * TILE;
    uint32_t* out = (win == 0 ? bits1 : bits2) + (size_t)c * chunk * nw;
    uint32_t flagged = 0u;  // bit w: word t0/32 + w has a valid column
    if (live) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int j = threadIdx.x + i * THREADS;
        const bool cv = pv[i] > 0;
        const uint32_t word_valid = __ballot_sync(0xffffffffu, cv);
        if (lane == 0) sflag[j >> 5] = word_valid != 0u;
        scol[j] = make_float4(cv ? px[i] : qnan, py[i], pz[i], __int_as_float(pg[i]));
        sidx[j] = pi[i];
      }
      __syncthreads();
      if (q + 1 < 2 * ntiles) fetch(q + 1);
      flagged = __ballot_sync(0xffffffffu, sflag[lane] != 0);
      // this warp takes flagged words warp, warp + 8, ... in set-bit order
      uint32_t mine = flagged;
      for (int i = 0; i < warp && mine; ++i) mine &= mine - 1u;
      while (mine) {
        const int wl = __ffs(mine) - 1;
        const float4* pc = scol + (wl << 5);
        const int* pidx = sidx + (wl << 5);
        uint32_t bw[NP_RPL];
#pragma unroll
        for (int k = 0; k < NP_RPL; ++k) bw[k] = 0u;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const float4 p = pc[b];
          const int ci = pidx[b];
          const int cg = __float_as_int(p.w);
#pragma unroll
          for (int k = 0; k < NP_RPL; ++k) {
            const float d2 = d2_rn(x[k], y[k], z[k], p.x, p.y, p.z);
            if ((d2 <= r2) & (cg == g[k]) & (ci != id[k])) bw[k] |= 1u << b;
          }
        }
#pragma unroll
        for (int k = 0; k < NP_RPL; ++k) {
          sout[lane + 32 * k][wl] = bw[k];
          cnt[k] += __popc(bw[k]);
        }
        for (int i = 0; i < WARPS && mine; ++i) mine &= mine - 1u;
      }
      __syncthreads();
    }
    // write the tile out: each warp stores rows of 32 consecutive words;
    // unflagged words are zero.  The next tile's staging touches no sout,
    // and its tests start after a barrier that follows these reads.
    const int w = (t0 >> 5) + lane;
    if (w < nw) {
      for (int row = warp; row < NP_ROWS && r0 + row < chunk; row += WARPS) {
        out[(size_t)(r0 + row) * nw + w] = (flagged >> lane) & 1u ? sout[row][lane] : 0u;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NP_RPL; ++k)
    if (cnt[k]) atomicAdd(&sdens[lane + 32 * k], cnt[k]);
  __syncthreads();
  const int r = r0 + threadIdx.x;
  if (threadIdx.x < NP_ROWS && r < chunk) dens[(size_t)c * chunk + r] = sdens[threadIdx.x];
}

// ---------------------------------------------------------------------------
// B2 masked_window_reduce.  Bound on H100: integer operations, 4 per SET bit
// (chip_smoke.py SET_BIT_OPS: find, clear, form its column, reduce), or the
// bytes of the bit words read once, whichever is larger.  Oracle content at
// the bench shapes sets ~224 M bits of 461 M.
//
// Design: the TPU kernel's own formulation (pallas_kernels.py
// _reduce_kernel) moved into shared memory.  Lane = word.
// - Both windows' values are staged bit-lane-major, sval[win][b][w] = value
//   of column 32w + b, with a row stride of 32 * groups + 1 ints (odd, so
//   the staging stores hit 32 banks).
// - A warp owns 8 rows (a block 64).  Per group of 32 words, each lane
//   loads its word of the 8 rows (8 coalesced 128-byte loads).  A group
//   whose words are zero in all 8 rows is skipped, uniformly (__any_sync):
//   window 2's invalid prefix and rows with no HP neighbor there.
// - The 32 bit positions are fully unrolled: per b, one conflict-free load
//   of sval[b][w] serves the 8 rows, and row k does "if bit b of word k is
//   set, acc_k = min(acc_k, v)" (max for !MIN).  Written in PTX (and with an
//   immediate, setp, predicated min/max), ptxas emits one LOP3 to a
//   predicate and one predicated VIMNMX per bit and row; the same C
//   expression compiled to five (shift, and, compare, compare, select).  The
//   work is the same in dense and sparse words, with no branch on the data.
// - MIN is a template parameter, not a runtime test.  A shuffle butterfly
//   under the same order finishes each row; identity INT32_MAX (min) or -1
//   (max).
// Kept over B3's lane-per-bit walk: that walk issues a shuffle, a load, a
// test and an update per word and lane, this one two instructions per bit
// and row and one load per bit and 8 rows.  8 rows per warp ran faster than
// 4 or 16, and prefetching the next group's words gained nothing.
// At the bench shapes (chip_smoke.py on an H100 80GB HBM3 at 700 W, oracle
// content): 223,944,000 set bits x 4 operations = 895,776,000, 0.0535 ms
// at the INT32 rate; the design issues its two instructions on every bit
// and row of the groups it does not skip, set or not: the hot loop is 650
// SASS instructions for 256 bit-rows, 2.54 per bit-row (LOP3 and VIMNMX,
// plus the value load and its address); ptxas: 48 registers, and 33,024
// bytes of shared memory per block at W = 4,096 (2 x 32 x 129 ints), so 5
// blocks (40 warps) per SM, held by registers.
// ---------------------------------------------------------------------------
template <bool MIN>
__device__ __forceinline__ int reduce2(int a, int b) {
  return MIN ? min(a, b) : max(a, b);
}

// acc = reduce(acc, val) where `word & mask` is nonzero
template <bool MIN>
__device__ __forceinline__ void reduce_if(int& acc, uint32_t word, int val, uint32_t mask) {
  if (MIN)
    asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\tand.b32 t, %1, %3;\n\t"
        "setp.ne.b32 p, t, 0;\n\t@p min.s32 %0, %0, %2;\n\t}"
        : "+r"(acc) : "r"(word), "r"(val), "r"(mask));
  else
    asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\tand.b32 t, %1, %3;\n\t"
        "setp.ne.b32 p, t, 0;\n\t@p max.s32 %0, %0, %2;\n\t}"
        : "+r"(acc) : "r"(word), "r"(val), "r"(mask));
}

// the shared-memory row stride of the staged values for a window of W columns
inline __host__ __device__ int reduce_ld(int W) {
  return (((W >> 5) + 31) >> 5) * 32 + 1;
}

template <bool MIN>
__global__ void __launch_bounds__(THREADS)
masked_window_reduce_kernel(const uint32_t* __restrict__ bits1,
                            const uint32_t* __restrict__ bits2,
                            const int* __restrict__ vw1, const int* __restrict__ vw2,
                            int* __restrict__ out, int chunk, int W) {
  extern __shared__ int sval[];  // [2][32][ld]
  constexpr int init = MIN ? INF_I32 : -1;
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = W >> 5;
  const int ld = reduce_ld(W);
  const int ngroups = ld >> 5;
  const int span = ngroups * TILE;  // staged columns per window; past W: identity
  for (int i = threadIdx.x; i < 2 * span; i += THREADS) {
    const int win = i >= span;
    const int j = i - win * span;
    const int* vw = win ? vw2 : vw1;
    sval[(win * 32 + (j & 31)) * ld + (j >> 5)] = j < W ? vw[(size_t)c * W + j] : init;
  }
  __syncthreads();

  const int rbase = blockIdx.x * ROWS_PER_BLOCK + warp * RPW;
  const int nrows = min(RPW, chunk - rbase);
  const size_t roff = ((size_t)c * chunk + rbase) * nw + lane;
  int acc[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) acc[k] = init;
  for (int win = 0; win < 2; ++win) {
    const uint32_t* bits = (win == 0 ? bits1 : bits2) + roff;
    for (int g = 0; g < ngroups; ++g) {
      const bool in = (g << 5) + lane < nw;
      uint32_t wd[RPW];
      uint32_t any = 0u;
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        wd[k] = (in && k < nrows) ? bits[k * nw + (g << 5)] : 0u;
        any |= wd[k];
      }
      if (!__any_sync(0xffffffffu, any != 0u)) continue;  // uniform
      const int* v = sval + win * 32 * ld + (g << 5) + lane;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const int val = v[b * ld];
#pragma unroll
        for (int k = 0; k < RPW; ++k) reduce_if<MIN>(acc[k], wd[k], val, 1u << b);
      }
    }
  }
  int row_val = init;  // lane k keeps row rbase + k
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    int a = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = reduce2<MIN>(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == k) row_val = a;
  }
  if (lane < nrows) out[(size_t)c * chunk + rbase + lane] = row_val;
}

// ---------------------------------------------------------------------------
// B3 masked_window_border.  Bound on H100: as B2, integer operations per set
// bit (oracle content sets nearly half of all bits).
// Design: one warp per row, one pass.  The chunk's (first-orig, label) pairs
// of both windows sit in shared memory as int2, in column order.  The warp
// reads 32 of the row's words at once (coalesced, one per lane) and walks
// them one word at a time: the word is broadcast by shuffle (an all-zero
// word or group of words is skipped, uniformly), and lane b tests bit b and
// reads the pair of column 32w + b.  The 32 lanes read 32 consecutive pairs,
// so no bank conflicts, and every word costs the same few branch-free
// operations whatever its density.  Each lane keeps the lexicographic max of
// (first, label) over its set bits, starting from (-1, -1); a shuffle
// reduction under the same order finishes the row: best = first, root =
// max(label, -1).  That equals the two-pass definition (max first, then max
// label among set bits whose first equals it; -1 on an empty row) for any
// labels, rows whose set bits all have first = -1 included.
//
// B5 masked_window_match_pick is the same kernel with PICK: the row's target
// fixes `first`, the walk keeps the max label over set bits whose first
// equals it (a filtered max from -1), and only the label is written.  Its
// bound is B2's with the words read once.
// ---------------------------------------------------------------------------
template <bool PICK>
__global__ void __launch_bounds__(THREADS)
masked_window_border_kernel(const uint32_t* __restrict__ bits1,
                            const uint32_t* __restrict__ bits2,
                            const int* __restrict__ fw1, const int* __restrict__ fw2,
                            const int* __restrict__ lw1, const int* __restrict__ lw2,
                            const int* __restrict__ target,
                            int* __restrict__ best_out, int* __restrict__ root_out,
                            int chunk, int W) {
  extern __shared__ int2 spair[];  // [2][W] (first-orig, label) per window column
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = W >> 5;
  for (int j = threadIdx.x; j < W; j += THREADS) {
    const size_t o = (size_t)c * W + j;
    spair[j] = make_int2(fw1[o], lw1[o]);
    spair[W + j] = make_int2(fw2[o], lw2[o]);
  }
  __syncthreads();
  for (int k = 0; k < RPW; ++k) {
    const int r = blockIdx.x * ROWS_PER_BLOCK + warp * RPW + k;
    if (r >= chunk) break;  // uniform across the warp
    const size_t row = (size_t)c * chunk + r;
    int bf = PICK ? target[row] : -1;
    int bl = -1;
    for (int win = 0; win < 2; ++win) {
      const uint32_t* bits = (win == 0 ? bits1 : bits2) + row * nw;
      const int2* pairs = spair + win * W + lane;
      for (int w0 = 0; w0 < nw; w0 += 32) {
        const uint32_t mine = w0 + lane < nw ? bits[w0 + lane] : 0u;
        if (!__any_sync(0xffffffffu, mine != 0u)) continue;
        const int n = min(32, nw - w0);
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const uint32_t word = __shfl_sync(0xffffffffu, mine, j);
          if (word == 0u) continue;  // uniform
          const int2 p = pairs[(w0 + j) << 5];
          const bool bit = (word >> lane) & 1u;
          if (PICK) {
            if (bit && p.x == bf && p.y > bl) bl = p.y;
          } else if (bit && (p.x > bf || (p.x == bf && p.y > bl))) {
            bf = p.x;
            bl = p.y;
          }
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int of = __shfl_xor_sync(0xffffffffu, bf, o);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
      if (PICK) {
        bl = max(bl, ol);
      } else if (of > bf || (of == bf && ol > bl)) {
        bf = of;
        bl = ol;
      }
    }
    if (lane == 0) {
      if (!PICK) best_out[row] = bf;
      root_out[row] = max(bl, -1);
    }
  }
}

// ---------------------------------------------------------------------------
// B4 window_1nn.  Bound on H100: operations — chunk*W pair tests per needy
// chunk, few bytes; a chunk with need == 0 reads nothing.  Design: one warp per row (8 rows per warp held in
// registers), lanes striding over the window columns staged 1024 at a time
// in shared memory (consecutive lanes, consecutive banks).  Each lane keeps
// (d2, col) under the order "smaller d2, then larger col"; a shuffle
// reduction with the same order finishes the row.  Non-candidates count as
// d2 = inf, so a row with no candidate returns (inf, W-1), as the Pallas
// kernel's `<=` scan does; a chunk with need == 0 returns (inf, -1) without
// scanning.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
window_1nn_kernel(const int* __restrict__ need, const float* __restrict__ rows_f,
                  const int* __restrict__ rows_g, const float* __restrict__ wf,
                  const int* __restrict__ wi, float* __restrict__ d2_out,
                  int* __restrict__ col_out, int chunk, int W) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE];
  __shared__ int sg[TILE], sm[TILE];
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS_PER_BLOCK;
  if (need[c] == 0) {
    for (int t = threadIdx.x; t < ROWS_PER_BLOCK; t += THREADS) {
      const int r = row0 + t;
      if (r < chunk) {
        d2_out[(size_t)c * chunk + r] = INFINITY;
        col_out[(size_t)c * chunk + r] = -1;
      }
    }
    return;  // uniform for the whole block
  }
  const int rbase = row0 + warp * RPW;
  const float* rf = rows_f + (size_t)c * 3 * chunk;
  float x[RPW], y[RPW], z[RPW], bd[RPW];
  int g[RPW], bc[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = rbase + k;
    const bool in = r < chunk;
    x[k] = in ? rf[r] : 0.f;
    y[k] = in ? rf[chunk + r] : 0.f;
    z[k] = in ? rf[2 * chunk + r] : 0.f;
    g[k] = in ? rows_g[(size_t)c * chunk + r] : 0;
    bd[k] = INFINITY;
    bc[k] = -1;
  }
  const float* pf = wf + (size_t)c * 3 * W;
  const int* pi = wi + (size_t)c * 2 * W;
  for (int t0 = 0; t0 < W; t0 += TILE) {
    __syncthreads();
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const int col = t0 + j;
      const bool in = col < W;
      sx[j] = in ? pf[col] : 0.f;
      sy[j] = in ? pf[W + col] : 0.f;
      sz[j] = in ? pf[2 * W + col] : 0.f;
      sg[j] = in ? pi[col] : 0;
      sm[j] = in ? pi[W + col] : 0;
    }
    __syncthreads();
    const int ncol = min(TILE, W - t0);
    for (int j = lane; j < ncol; j += 32) {
      const float cx = sx[j], cy = sy[j], cz = sz[j];
      const int cg = sg[j];
      const bool cand = sm[j] > 0;
      const int col = t0 + j;
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        float d2 = d2_rn(x[k], y[k], z[k], cx, cy, cz);
        if (!(cand && cg == g[k])) d2 = INFINITY;
        if (d2 <= bd[k]) {  // columns ascend per lane: later ties win
          bd[k] = d2;
          bc[k] = col;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    float d = bd[k];
    int cc = bc[k];
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, o);
      const int oc = __shfl_xor_sync(0xffffffffu, cc, o);
      if (od < d || (od == d && oc > cc)) {
        d = od;
        cc = oc;
      }
    }
    const int r = rbase + k;
    if (lane == 0 && r < chunk) {
      d2_out[(size_t)c * chunk + r] = d;
      col_out[(size_t)c * chunk + r] = cc;
    }
  }
}

inline dim3 grid_for(int nchunks, int chunk, int rows = ROWS_PER_BLOCK) {
  return dim3((chunk + rows - 1) / rows, nchunks);
}

// Shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

int pbnet_neighbor_pack(const float* rows_f, const int* rows_i, const float* w1f,
                        const int* w1i, const float* w2f, const int* w2i, float r2,
                        int* bits1, int* bits2, int* dens, int nchunks, int chunk,
                        int W, void* stream) {
  neighbor_pack_kernel<<<grid_for(nchunks, chunk, NP_ROWS), THREADS, 0,
                         (cudaStream_t)stream>>>(
      rows_f, rows_i, w1f, w1i, w2f, w2i, r2, (uint32_t*)bits1, (uint32_t*)bits2,
      dens, chunk, W);
  return (int)cudaGetLastError();
}

int pbnet_masked_window_reduce(const int* bits1, const int* bits2, const int* vw1,
                               const int* vw2, int* out, int nchunks, int chunk,
                               int W, int minimize, void* stream) {
  const size_t smem = (size_t)2 * 32 * reduce_ld(W) * sizeof(int);
  const dim3 grid = grid_for(nchunks, chunk);
  const uint32_t* b1 = (const uint32_t*)bits1;
  const uint32_t* b2 = (const uint32_t*)bits2;
  cudaError_t e;
  if (minimize) {
    e = allow_smem(masked_window_reduce_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    masked_window_reduce_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        b1, b2, vw1, vw2, out, chunk, W);
  } else {
    e = allow_smem(masked_window_reduce_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    masked_window_reduce_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        b1, b2, vw1, vw2, out, chunk, W);
  }
  return (int)cudaGetLastError();
}

int pbnet_masked_window_border(const int* bits1, const int* bits2, const int* fw1,
                               const int* fw2, const int* lw1, const int* lw2,
                               int* best, int* root, int nchunks, int chunk, int W,
                               void* stream) {
  const size_t smem = (size_t)2 * W * sizeof(int2);
  cudaError_t e = allow_smem(masked_window_border_kernel<false>, smem);
  if (e != cudaSuccess) return (int)e;
  masked_window_border_kernel<false><<<grid_for(nchunks, chunk), THREADS, smem,
                                       (cudaStream_t)stream>>>(
      (const uint32_t*)bits1, (const uint32_t*)bits2, fw1, fw2, lw1, lw2, nullptr, best,
      root, chunk, W);
  return (int)cudaGetLastError();
}

int pbnet_masked_window_match_pick(const int* bits1, const int* bits2, const int* fw1,
                                   const int* fw2, const int* lw1, const int* lw2,
                                   const int* target, int* out, int nchunks, int chunk,
                                   int W, void* stream) {
  const size_t smem = (size_t)2 * W * sizeof(int2);
  cudaError_t e = allow_smem(masked_window_border_kernel<true>, smem);
  if (e != cudaSuccess) return (int)e;
  masked_window_border_kernel<true><<<grid_for(nchunks, chunk), THREADS, smem,
                                      (cudaStream_t)stream>>>(
      (const uint32_t*)bits1, (const uint32_t*)bits2, fw1, fw2, lw1, lw2, target, nullptr,
      out, chunk, W);
  return (int)cudaGetLastError();
}

int pbnet_window_1nn(const int* need, const float* rows_f, const int* rows_g,
                     const float* wf, const int* wi, float* d2, int* col, int nchunks,
                     int chunk, int W, void* stream) {
  window_1nn_kernel<<<grid_for(nchunks, chunk), THREADS, 0, (cudaStream_t)stream>>>(
      need, rows_f, rows_g, wf, wi, d2, col, chunk, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
