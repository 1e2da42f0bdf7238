// Banded sparse convolution for Hopper (sm_90a), plain C interface.
//
// Replaces pbnet_tpu/nn/onehot_conv.py::onehot_conv (Pallas body `_kernel`).
//
//   y[m] = sum over slots s with rel[m, s] < span of
//          bf16(feats[starts[m / tm, s / kz] + rel[m, s]]) @ bf16(W[s])
//   accumulated in f32; y[m] = 0 where valid_out[m] is false.
//
// Layouts (row-major): feats (m_in, cin) f32; W (K, cin, cout) f32; starts
// (m_out / tm, K / kz) int32; rel (m_out, K) int32 (the plan's (nt, tm, K));
// valid_out (m_out,) bool; y (m_out, cout) f32.
//
// What bounds it on an H100: the products are 2 * (present in-band
// entries) * cin * cout flops, which the bf16 tensor cores do in
// microseconds; the floor is the bytes of the feature table, the weights,
// the plan and the output, read or written once (bytes bound every bench
// shape but main k3 L2 192->128, where the two are within 1.2x).  What a
// design pays beyond that is L2 traffic and tensor-core work on absent
// rows.
//
// Design.  The TPU kernel DMAs each (dx, dy) group's whole band into VMEM
// and gathers with a one-hot matrix product on the MXU.  A band does not
// fit in shared memory here (L1 k3: 1280 rows x 128 ch x 2 B = 320 KB), and
// a one-hot row times the band is exactly that band row, so the kernel
// gathers each present row straight from global memory; the band keeps a
// tile's reads in a narrow, L2-resident stretch of the table.
//
// 1. One pass (`to_bf16_kernel`) rounds the feature table and the weights
//    to bf16 once per call, zero-padded to cin_p = cin rounded up to 32 and
//    to the column pitch, so the conv reads 16-byte aligned bf16 rows with
//    no ragged edge.
// 2. A block owns BM = 64 or 128 output rows (4 or 8 warps, 16 rows each)
//    and all BN <= 128 output columns (cout rounded up to 32; wider outputs
//    take column strips), so each present (row, slot) entry is gathered
//    once.  It first writes the source row of each (row, slot) into shared
//    memory and ORs, per warp, the slots its 16 rows use.
// 3. It walks the slots some row of the block uses, 32 input channels per
//    step, through a ring of 4 stages in dynamic shared memory: cp.async
//    16-byte copies bring the step's gathered rows (absent rows zero-filled,
//    src-size 0: no read) and the slot's weight slice, while up to three
//    later steps are in flight.
// 4. Each warp multiplies its 16 rows on the tensor cores (ldmatrix and
//    mma.sync m16n8k16, bf16 -> f32 accumulators in registers) and skips a
//    slot that none of its own rows uses.  Row pitches of 80 B (A) and
//    2 * BN + 16 B (B) keep every ldmatrix free of bank conflicts.
// 5. The wrapper (nn/onehot_conv.py `tiling`) picks BM = 128 when that gives
//    at least two blocks per SM, else 64, and splits the slots across
//    `nsplit` blocks (grid z) while that gives fewer.  A split writes
//    partial tiles; `split_sum_kernel` adds them in split order (fixed: no
//    atomics), so every output repeats bit for bit from run to run.
//
// Per shape class at the bench shapes (132 SMs).  Bound: the larger of the
// bytes moved once and the flops of the present entries (chip_smoke.py
// `b6_bound`).  L2 MB: what this design moves between L2 and the SMs, at
// most: gathered rows 2 * entries * cin_p, weight slices 2 * K * cin_p * BN
// per row block, the bf16 pass, the output (and split partials).
//
//   class                    rows     bound  blocks (BM, split)  L2 MB (weights)
//   main k3 L1, Cin 96-128   39,424   bytes   308 (128, 1)       268-352 (153-204)
//   local k3 L1, Cin 96-128  20,992   bytes   328 (64, 1)        223-294 (163-218)
//   main k3 L2, Cin 64-192   10,240   bytes*  320 (64, 2)         68-298 (35-212)
//   local k3 L2, Cin 64-192   5,888   bytes   276 (64, 3)         42-178 (20-122)
//   up L0/L1 (K 8)           20,992-  bytes   308-722 (64-128, 1) 83-183 (48-107)
//                            92,416
//   down L3 (K 8)            1,536 /  bytes   192 / 256 (64, 8/4) 11-19 (2-4)
//                            4,096
//   (* main k3 L2 192->128: operations, by 1.1x.)  The weight slices are
//   most of the L2 bytes; they stay L2-resident (at most 1.3 MB per call).
//   Up maps use one slot of 8 per row, so their 16-row warps multiply mostly
//   zero rows.  PERF.md holds the measured times.
//
// f32 arithmetic outside the tensor cores: only the fixed-order adds of the
// split partials, so the library-wide -fmad=false changes nothing here.
//
// The launcher returns the first CUDA error so the caller can raise on a
// refused launch.

#include "tensor_core.cuh"

namespace {

constexpr int KC = 32;         // input channels per pipeline step
constexpr int STAGES = 4;      // cp.async ring depth
constexpr int MAX_SLOTS = 32;  // slots one block walks (a 32-bit mask)
constexpr int LDA = KC + 8;    // bf16 pitch of a staged row (80 B)

// ---------------------------------------------------------------------------
// bf16 operands: feats (m_in, cin) -> (m_in, cin_p); W (K, cin, cout) ->
// (K, cin_p, w_pitch); zero padding.  Eight outputs (16 bytes) per thread.
// ---------------------------------------------------------------------------
__global__ void to_bf16_kernel(const float* __restrict__ feats, __nv_bfloat16* __restrict__ fo,
                               int m_in, int cin, int cin_p, const float* __restrict__ w,
                               __nv_bfloat16* __restrict__ wo, int K, int cout, int w_pitch) {
  bf16_operands(feats, fo, m_in, cin, cin_p, w, wo, K, cout, K * cin_p, w_pitch);
}

template <int WARPS, int BN>
constexpr int conv_smem_bytes() {
  return STAGES * (16 * WARPS * LDA + KC * (BN + 8)) * 2 + MAX_SLOTS * (16 * WARPS + 1) * 4;
}

// ---------------------------------------------------------------------------
// The conv.  Grid (row blocks, column strips, slot splits).  With one split
// `out` is y (valid_out applied); with more, split z writes its partial
// tile to out + z * m_out * cout and split_sum_kernel finishes.
// ---------------------------------------------------------------------------
template <int WARPS, int BN>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 8 ? 2 : 3)
onehot_conv_kernel(const __nv_bfloat16* __restrict__ feats, const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ starts, const int* __restrict__ rel,
                   const bool* __restrict__ valid_out, float* __restrict__ out, int cin_p,
                   int cout, int w_pitch, int K, int kz, int tm, int m_out, int span,
                   int slots_per_split) {
  constexpr int BM = 16 * WARPS, THREADS = 32 * WARPS;
  constexpr int LDB = BN + 8, NT = BN / 8;
  constexpr int A_ELEMS = BM * LDA, B_ELEMS = KC * LDB;
  constexpr int SP = BM + 1;  // pitch of the source-row table
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDA]
  __nv_bfloat16* sb = sa + STAGES * A_ELEMS;                   // [STAGES][KC][LDB]
  int* src = reinterpret_cast<int*>(sb + STAGES * B_ELEMS);    // [slot][SP], -1 absent
  __shared__ int act[MAX_SLOTS];
  __shared__ unsigned warp_masks[WARPS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int s_lo = blockIdx.z * slots_per_split;
  const int nslots = min(slots_per_split, K - s_lo);
  const int G = K / kz;

  // source row of every (row, slot); consecutive threads read one row's slots
  for (int e = threadIdx.x; e < BM * nslots; e += THREADS) {
    const int r = e / nslots, j = e - r * nslots;
    const int m = row0 + r, s = s_lo + j;
    int v = -1;
    if (m < m_out) {
      const int off = rel[(size_t)m * K + s];
      if (off < span) v = starts[(m / tm) * G + s / kz] + off;
    }
    src[j * SP + r] = v;
  }
  __syncthreads();
  bool used = false;  // lane j: does a row of this warp use slot j?
  if (lane < nslots) {
#pragma unroll
    for (int i = 0; i < 16; ++i) used |= src[lane * SP + warp * 16 + i] >= 0;
  }
  const unsigned wmask = __ballot_sync(0xffffffffu, used);
  if (lane == 0) warp_masks[warp] = wmask;
  __syncthreads();
  unsigned bmask = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) bmask |= warp_masks[i];
  if (threadIdx.x == 0) {
    int n = 0;
    for (unsigned b = bmask; b; b &= b - 1) act[n++] = __ffs(b) - 1;
  }
  __syncthreads();

  const int nchunk = cin_p / KC;
  const int nsteps = __popc(bmask) * nchunk;

  // step -> (slot act[step / nchunk], channels c0..c0+KC) into ring buffer
  auto load = [&](int step, int buf) {
    const int q = step / nchunk, j = act[q];
    const int c0 = (step - q * nchunk) * KC;
    __nv_bfloat16* da = sa + buf * A_ELEMS;
    const int* sj = src + j * SP;
#pragma unroll
    for (int e = threadIdx.x; e < BM * (KC / 8); e += THREADS) {
      const int r = e >> 2, p = e & 3;
      const int sr = sj[r];
      cp_async16(da + r * LDA + p * 8, feats + (size_t)max(sr, 0) * cin_p + c0 + p * 8, sr >= 0);
    }
    __nv_bfloat16* db = sb + buf * B_ELEMS;
    const __nv_bfloat16* ws = w + ((size_t)(s_lo + j) * cin_p + c0) * w_pitch + col0;
#pragma unroll
    for (int e = threadIdx.x; e < KC * (BN / 8); e += THREADS) {
      const int k = e / (BN / 8), p = e - k * (BN / 8);
      cp_async16(db + k * LDB + p * 8, ws + (size_t)k * w_pitch + p * 8, true);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nsteps) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step i landed
    __syncthreads();              // everyone's; and step i-1's buffer is free
    const int nx = i + STAGES - 1;
    if (nx < nsteps) load(nx, nx % STAGES);
    cp_async_commit();
    if ((wmask >> act[i / nchunk]) & 1u) {
      const __nv_bfloat16* ta = sa + (i % STAGES) * A_ELEMS + warp * 16 * LDA;
      const __nv_bfloat16* tb = sb + (i % STAGES) * B_ELEMS;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, ta + (lane & 15) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, tb + (kk + (lane & 15)) * LDB + np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (n-tile n, h): row g + 8h, columns 2q, 2q + 1
  const bool split = gridDim.z > 1;
  float* o = out + (size_t)blockIdx.z * m_out * cout;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + warp * 16 + g + 8 * h;
    if (m >= m_out) continue;
    const bool keep = split || valid_out[m];
    float* orow = o + (size_t)m * cout;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = col0 + n * 8 + 2 * q;
      const float a = keep ? acc[n][2 * h] : 0.0f, b = keep ? acc[n][2 * h + 1] : 0.0f;
      if (col + 1 < cout && !(cout & 1)) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(a, b);
      } else {
        if (col < cout) orow[col] = a;
        if (col + 1 < cout) orow[col + 1] = b;
      }
    }
  }
}

// y[e] = sum over splits z = 0, 1, ... of part[z][e] (in that order), 0 where
// valid_out is false
__global__ void split_sum_kernel(const float* __restrict__ part, const bool* __restrict__ valid_out,
                                 float* __restrict__ out, int nsplit, int m_out, int cout) {
  const size_t n = (size_t)m_out * cout;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (valid_out[e / cout]) {
      s = part[e];
      for (int z = 1; z < nsplit; ++z) s = __fadd_rn(s, part[z * n + e]);
    }
    out[e] = s;
  }
}

// shared memory above the default 48 KB needs an opt-in
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int WARPS, int BN>
cudaError_t launch_conv(dim3 grid, cudaStream_t stream, const __nv_bfloat16* feats,
                        const __nv_bfloat16* w, const int* starts, const int* rel,
                        const bool* valid_out, float* out, int cin_p, int cout, int w_pitch,
                        int K, int kz, int tm, int m_out, int span, int slots_per_split) {
  constexpr int smem = conv_smem_bytes<WARPS, BN>();
  const cudaError_t e = allow_smem(onehot_conv_kernel<WARPS, BN>, smem);
  if (e != cudaSuccess) return e;
  onehot_conv_kernel<WARPS, BN><<<grid, WARPS * 32, smem, stream>>>(
      feats, w, starts, rel, valid_out, out, cin_p, cout, w_pitch, K, kz, tm, m_out, span,
      slots_per_split);
  return cudaGetLastError();
}

template <int WARPS>
cudaError_t launch_bn(int bn, dim3 grid, cudaStream_t stream, const __nv_bfloat16* feats,
                      const __nv_bfloat16* w, const int* starts, const int* rel,
                      const bool* valid_out, float* out, int cin_p, int cout, int w_pitch,
                      int K, int kz, int tm, int m_out, int span, int slots_per_split) {
#define PBNET_CONV(B)                                                                       \
  case B:                                                                                   \
    return launch_conv<WARPS, B>(grid, stream, feats, w, starts, rel, valid_out, out, cin_p, \
                                 cout, w_pitch, K, kz, tm, m_out, span, slots_per_split);
  switch (bn) {
    PBNET_CONV(32)
    PBNET_CONV(64)
    PBNET_CONV(96)
    PBNET_CONV(128)
  }
#undef PBNET_CONV
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// feats_bf16 (m_in, cin_p) and w_bf16 (K, cin_p, w_pitch) are scratch for
// the rounded operands; part (nsplit, m_out, cout) f32 is scratch when
// nsplit > 1 (else unused).  bm in {64, 128}; bn in {32, 64, 96, 128}
// divides w_pitch; cin_p is cin rounded up to 32; slots_per_split <= 32.
int pbnet_onehot_conv(const float* feats, const float* w, const int* starts, const int* rel,
                      const bool* valid_out, float* out, void* feats_bf16, void* w_bf16,
                      float* part, int m_in, int cin, int cin_p, int cout, int w_pitch, int K,
                      int kz, int tm, int m_out, int span, int bm, int bn,
                      int slots_per_split, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (slots_per_split < 1 || slots_per_split > MAX_SLOTS || cin_p % KC || w_pitch % bn)
    return (int)cudaErrorInvalidValue;
  auto* fb = static_cast<__nv_bfloat16*>(feats_bf16);
  auto* wb = static_cast<__nv_bfloat16*>(w_bf16);
  const size_t n8 = ((size_t)m_in * cin_p + (size_t)K * cin_p * w_pitch) / 8;
  to_bf16_kernel<<<grid_stride_blocks(n8, 256), 256, 0, st>>>(feats, fb, m_in, cin, cin_p, w,
                                                             wb, K, cout, w_pitch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nsplit = (K + slots_per_split - 1) / slots_per_split;
  const dim3 grid((m_out + bm - 1) / bm, w_pitch / bn, nsplit);
  float* dst = nsplit > 1 ? part : out;
  if (bm == 128)
    e = launch_bn<8>(bn, grid, st, fb, wb, starts, rel, valid_out, dst, cin_p, cout, w_pitch, K,
                     kz, tm, m_out, span, slots_per_split);
  else if (bm == 64)
    e = launch_bn<4>(bn, grid, st, fb, wb, starts, rel, valid_out, dst, cin_p, cout, w_pitch, K,
                     kz, tm, m_out, span, slots_per_split);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  split_sum_kernel<<<grid_stride_blocks((size_t)m_out * cout, 256), 256, 0, st>>>(
      part, valid_out, out, nsplit, m_out, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
