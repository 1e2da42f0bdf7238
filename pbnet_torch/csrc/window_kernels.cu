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
// B1 neighbor_pack.  Bound on H100: operations, not bytes — one pair test
// (9 f32 + 4 int32 operations) per valid row and valid window column, at
// most 2*nchunks*chunk*W (461 M at the bench shapes), against ~70 MB of
// traffic.  Design: one thread per (row, 32-column word), so a word is
// built in registers and written once (coalesced: a warp writes 32
// consecutive words of one row).  The chunk's window columns are staged in
// shared memory 1024 at a time in a bit-lane-major [32][33] layout, so the
// 32 lanes of a warp (32 consecutive words) read 32 different banks; each
// thread holds its warp's 8 rows in registers and tests each staged column
// against all 8.  Density is __popc of the words, summed across the warp.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
neighbor_pack_kernel(const float* __restrict__ rows_f, const int* __restrict__ rows_i,
                     const float* __restrict__ w1f, const int* __restrict__ w1i,
                     const float* __restrict__ w2f, const int* __restrict__ w2i,
                     float r2, uint32_t* __restrict__ bits1,
                     uint32_t* __restrict__ bits2, int* __restrict__ dens,
                     int chunk, int W) {
  __shared__ float sx[32][33], sy[32][33], sz[32][33];
  __shared__ int sg[32][33], sv[32][33], si[32][33];
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = W >> 5;
  const int rbase = blockIdx.x * ROWS_PER_BLOCK + warp * RPW;

  const float* rf = rows_f + (size_t)c * 3 * chunk;
  const int* ri = rows_i + (size_t)c * 3 * chunk;
  float x[RPW], y[RPW], z[RPW];
  int g[RPW], id[RPW];
  bool ok[RPW];
  int cnt[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = rbase + k;
    const bool in = r < chunk;
    x[k] = in ? rf[r] : 0.f;
    y[k] = in ? rf[chunk + r] : 0.f;
    z[k] = in ? rf[2 * chunk + r] : 0.f;
    g[k] = in ? ri[r] : 0;
    ok[k] = in && ri[chunk + r] > 0;
    id[k] = in ? ri[2 * chunk + r] : 0;
    cnt[k] = 0;
  }

  for (int win = 0; win < 2; ++win) {
    const float* wf = (win == 0 ? w1f : w2f) + (size_t)c * 3 * W;
    const int* wi = (win == 0 ? w1i : w2i) + (size_t)c * 3 * W;
    uint32_t* out = (win == 0 ? bits1 : bits2) + (size_t)c * chunk * nw;
    for (int t0 = 0; t0 < W; t0 += TILE) {
      __syncthreads();  // the previous tile is fully consumed
      for (int j = threadIdx.x; j < TILE; j += THREADS) {
        const int col = t0 + j;
        const bool in = col < W;
        const int b = j & 31, w = j >> 5;
        sx[b][w] = in ? wf[col] : 0.f;
        sy[b][w] = in ? wf[W + col] : 0.f;
        sz[b][w] = in ? wf[2 * W + col] : 0.f;
        sg[b][w] = in ? wi[col] : 0;
        sv[b][w] = in ? wi[W + col] : 0;
        si[b][w] = in ? wi[2 * W + col] : 0;
      }
      __syncthreads();
      const int word = (t0 >> 5) + lane;
      if (word < nw) {
        uint32_t bw[RPW];
#pragma unroll
        for (int k = 0; k < RPW; ++k) bw[k] = 0u;
#pragma unroll 4
        for (int b = 0; b < 32; ++b) {
          const float cx = sx[b][lane], cy = sy[b][lane], cz = sz[b][lane];
          const int cg = sg[b][lane], ci = si[b][lane];
          const bool cv = sv[b][lane] > 0;
#pragma unroll
          for (int k = 0; k < RPW; ++k) {
            const float d2 = d2_rn(x[k], y[k], z[k], cx, cy, cz);
            const bool m = ok[k] && cv && (d2 <= r2) && (cg == g[k]) && (ci != id[k]);
            bw[k] |= (uint32_t)m << b;
          }
        }
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
          const int r = rbase + k;
          if (r < chunk) {
            out[(size_t)r * nw + word] = bw[k];
            cnt[k] += __popc(bw[k]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    int v = cnt[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int r = rbase + k;
    if (lane == 0 && r < chunk) dens[(size_t)c * chunk + r] = v;
  }
}

// ---------------------------------------------------------------------------
// B2 masked_window_reduce.  Bound on H100: bytes (every bit word is read
// once, 2 x 28.8 MB at the bench shapes) or integer operations (find, clear
// and reduce each SET bit), whichever the bit density makes larger.
// Design: one warp per row, lanes striding over the row's words (coalesced
// reads), visiting only the SET bits of each word (__ffs); both windows'
// values for the chunk sit in shared memory; a shuffle reduction finishes
// the row.  Identity: INT32_MAX for min, -1 for max.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
masked_window_reduce_kernel(const uint32_t* __restrict__ bits1,
                            const uint32_t* __restrict__ bits2,
                            const int* __restrict__ vw1, const int* __restrict__ vw2,
                            int* __restrict__ out, int chunk, int W, int minimize) {
  extern __shared__ int sval[];  // [2][W]
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = W >> 5;
  for (int j = threadIdx.x; j < W; j += THREADS) {
    sval[j] = vw1[(size_t)c * W + j];
    sval[W + j] = vw2[(size_t)c * W + j];
  }
  __syncthreads();
  const int init = minimize ? INF_I32 : -1;
  for (int k = 0; k < RPW; ++k) {
    const int r = blockIdx.x * ROWS_PER_BLOCK + warp * RPW + k;
    if (r >= chunk) break;  // uniform across the warp
    int acc = init;
    for (int win = 0; win < 2; ++win) {
      const uint32_t* bits = (win == 0 ? bits1 : bits2) + ((size_t)c * chunk + r) * nw;
      const int* vals = sval + win * W;
      for (int w = lane; w < nw; w += 32) {
        uint32_t word = bits[w];
        while (word) {
          const int b = __ffs(word) - 1;
          word &= word - 1u;
          const int v = vals[(w << 5) + b];
          acc = minimize ? min(acc, v) : max(acc, v);
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int other = __shfl_xor_sync(0xffffffffu, acc, o);
      acc = minimize ? min(acc, other) : max(acc, other);
    }
    if (lane == 0) out[(size_t)c * chunk + r] = acc;
  }
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

inline dim3 grid_for(int nchunks, int chunk) {
  return dim3((chunk + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, nchunks);
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
  neighbor_pack_kernel<<<grid_for(nchunks, chunk), THREADS, 0, (cudaStream_t)stream>>>(
      rows_f, rows_i, w1f, w1i, w2f, w2i, r2, (uint32_t*)bits1, (uint32_t*)bits2,
      dens, chunk, W);
  return (int)cudaGetLastError();
}

int pbnet_masked_window_reduce(const int* bits1, const int* bits2, const int* vw1,
                               const int* vw2, int* out, int nchunks, int chunk,
                               int W, int minimize, void* stream) {
  const size_t smem = (size_t)2 * W * sizeof(int);
  cudaError_t e = allow_smem(masked_window_reduce_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  masked_window_reduce_kernel<<<grid_for(nchunks, chunk), THREADS, smem,
                                (cudaStream_t)stream>>>(
      (const uint32_t*)bits1, (const uint32_t*)bits2, vw1, vw2, out, chunk, W, minimize);
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
