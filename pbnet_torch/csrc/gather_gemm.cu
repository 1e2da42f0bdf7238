// Sparse convolution as one gather-GEMM on the tensor cores, for Hopper
// (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves `gather_conv` to XLA (a
// row gather into an img2col buffer, then a matrix product), as the plain
// version nn/sparse_ops.py `_conv_fwd` does; `gather_conv` runs this kernel
// for every forward with gradients off.  It computes, in one pass over the
// output,
//
//   y[i, :] = valid_out[i] ? sum_k sum_c bf16(x[kmap[i, k], c]) * bf16(W[k, c, :]) (+ bias)
//                          : 0
//
// with f32 accumulators; kmap[i, k] == -1 reads a zero row.
//
// Layouts (row-major): feats (m_in, cin) f32; W (K, cin, cout) f32; kmap
// (m_out, K) int32; valid_out (m_out,) bool; bias (cout,) f32 or null; y
// (m_out, cout) f32.
//
// What bounds it on an H100: 2 * m_out * K * cin * cout operations against
// the map, the gathered rows and the output.  At the eval shapes most convs
// have Cout 32-128 and read K * cin bf16 values per output row, so the
// operations per byte of the rows they gather are Cout: under the card's
// ~295 at every width.  The gathered rows come mostly from L2 (a level's
// bf16 table is at most ~19 MB), so the design keeps the gathered rows out
// of device memory and lets the tensor cores run well below their peak.
//
// Design.
// 1. One pass (`conv_operands_copy_kernel`) rounds the feature table and the
//    weights to bf16 (round to nearest even, as `.to(torch.bfloat16)`), the
//    table zero-padded to cin_p = cin rounded up to 8 (16-byte rows: the
//    k=5 stem's 6 channels take 8), the weights laid out as the GEMM's
//    (depth, w_pitch) operand with row k * cin_p + c, zero past K * cin_p
//    (depth = K * cin_p rounded up to 32) and past cout.
// 2. A block owns BM = 128 output rows (8 warps, 16 rows each) or, where
//    K > 32, BM = 64 (4 warps), and BN <= 128 output columns (cout rounded
//    up to 32; wider outputs take column strips).  It first copies its rows
//    of the map into shared memory (row pitch K | 1 words: no bank
//    conflicts), -1 past the last row.
// 3. It walks the reduction in a fixed order, KC = 32 deep per step (one
//    offset's 32-channel chunk, or several offsets of a narrower table),
//    through a ring of 4 stages in dynamic shared memory: cp.async 16-byte
//    copies bring each row's piece through the map (an absent entry or a
//    padding row is zero-filled, src-size 0: no read) and the step's weight
//    slice, while up to three later steps are in flight.  No img2col
//    buffer is written to device memory.
// 4. Each warp multiplies its 16 rows on the tensor cores (ldmatrix and
//    mma.sync m16n8k16, bf16 -> f32 accumulators in registers).  Row
//    pitches of 80 B (A) and 2 * BN + 16 B (B) keep every ldmatrix free of
//    bank conflicts.
// 5. The epilogue adds the bias (f32, rounded as `y + bias`), writes 0
//    where valid_out is false, and stores f32.  No atomics and a fixed
//    order: every output repeats bit for bit from run to run.
//
// Every (row, offset) pair is multiplied, absent entries included, so the
// operations executed are 2 * m_out * depth * w_pitch whatever the map
// holds (the wrapper counts them so).  The wrapper (`gemm_tiling` in
// nn/sparse_ops.py) picks BM, BN and cin_p from (K, cin, cout) alone.
//
// f32 arithmetic outside the tensor cores: only the bias add, so the
// library-wide -fmad=false changes nothing here.
//
// The launcher returns the first CUDA error so the caller can raise on a
// refused launch.

#include "tensor_core.cuh"

namespace {

constexpr int KC = 32;       // reduction depth per pipeline step
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int LDA = KC + 8;  // bf16 pitch of a staged row (80 B)

// the operand pass (tensor_core.cuh); its name files its time with the
// copies in a trace
__global__ void conv_operands_copy_kernel(const float* __restrict__ feats,
                                          __nv_bfloat16* __restrict__ fo, int m_in, int cin,
                                          int cin_p, const float* __restrict__ w,
                                          __nv_bfloat16* __restrict__ wo, int K, int cout,
                                          int depth, int w_pitch) {
  bf16_operands(feats, fo, m_in, cin, cin_p, w, wo, K, cout, depth, w_pitch);
}

template <int WARPS, int BN>
constexpr int gemm_smem_bytes_base() {
  return STAGES * (16 * WARPS * LDA + KC * (BN + 8)) * 2;
}

// ---------------------------------------------------------------------------
// The gather-GEMM.  Grid (row blocks, column strips).
// ---------------------------------------------------------------------------
template <int WARPS, int BN>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 8 ? 2 : 3)
gather_gemm_kernel(const __nv_bfloat16* __restrict__ feats, const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ kmap, const bool* __restrict__ valid_out,
                   const float* __restrict__ bias, float* __restrict__ out, int m_out, int K,
                   int cin_p, int cout, int w_pitch, int steps) {
  constexpr int BM = 16 * WARPS, THREADS = 32 * WARPS;
  constexpr int LDB = BN + 8, NT = BN / 8;
  constexpr int A_ELEMS = BM * LDA, B_ELEMS = KC * LDB;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDA]
  __nv_bfloat16* sb = sa + STAGES * A_ELEMS;                   // [STAGES][KC][LDB]
  int* smap = reinterpret_cast<int*>(sb + STAGES * B_ELEMS);   // [BM][kp], -1 absent
  const int kp = K | 1;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  // the block's rows of the map (contiguous in kmap), -1 past the last row
  const int* kb = kmap + (size_t)row0 * K;
  for (int e = threadIdx.x; e < BM * K; e += THREADS) {
    const int r = e / K, k = e - r * K;
    smap[r * kp + k] = row0 + r < m_out ? kb[e] : -1;
  }
  __syncthreads();

  // step -> reduction rows d0 .. d0 + KC into ring buffer `buf`: the 16-byte
  // piece p of row r is (offset k, channels c .. c + 8) with d0 + 8p =
  // k * cin_p + c; offsets past K (depth padding) read nothing
  auto load = [&](int step, int buf) {
    const int d0 = step * KC;
    __nv_bfloat16* da = sa + buf * A_ELEMS;
#pragma unroll
    for (int e = threadIdx.x; e < BM * (KC / 8); e += THREADS) {
      const int r = e >> 2, p = e & 3;
      const int d = d0 + p * 8;
      const int k = d / cin_p, c = d - k * cin_p;
      const int sr = k < K ? smap[r * kp + k] : -1;
      cp_async16(da + r * LDA + p * 8, feats + (size_t)max(sr, 0) * cin_p + c, sr >= 0);
    }
    __nv_bfloat16* db = sb + buf * B_ELEMS;
    const __nv_bfloat16* ws = w + (size_t)d0 * w_pitch + col0;
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
    if (i < steps) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step i landed
    __syncthreads();              // everyone's; and step i-1's buffer is free
    const int nx = i + STAGES - 1;
    if (nx < steps) load(nx, nx % STAGES);
    cp_async_commit();
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
  cp_async_wait<0>();

  // accumulator (n-tile n, h): row g + 8h, columns 2q, 2q + 1
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + warp * 16 + g + 8 * h;
    if (m >= m_out) continue;
    const bool keep = valid_out[m];
    float* orow = out + (size_t)m * cout;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = col0 + n * 8 + 2 * q;
      float a = acc[n][2 * h], b = acc[n][2 * h + 1];
      if (bias != nullptr) {
        if (col < cout) a = __fadd_rn(a, bias[col]);
        if (col + 1 < cout) b = __fadd_rn(b, bias[col + 1]);
      }
      if (!keep) a = b = 0.0f;
      if (col + 1 < cout && !(cout & 1)) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(a, b);
      } else {
        if (col < cout) orow[col] = a;
        if (col + 1 < cout) orow[col + 1] = b;
      }
    }
  }
}

template <int WARPS, int BN>
cudaError_t launch_gemm(dim3 grid, cudaStream_t stream, const __nv_bfloat16* feats,
                        const __nv_bfloat16* w, const int* kmap, const bool* valid_out,
                        const float* bias, float* out, int m_out, int K, int cin_p, int cout,
                        int w_pitch, int steps) {
  // the map rows take 16 * WARPS * (K | 1) words; shared memory above the
  // default 48 KB needs an opt-in, raised only when a launch needs more
  static int allowed = 48 * 1024;
  const int smem = gemm_smem_bytes_base<WARPS, BN>() + 16 * WARPS * (K | 1) * 4;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(gather_gemm_kernel<WARPS, BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  gather_gemm_kernel<WARPS, BN><<<grid, WARPS * 32, smem, stream>>>(
      feats, w, kmap, valid_out, bias, out, m_out, K, cin_p, cout, w_pitch, steps);
  return cudaGetLastError();
}

template <int WARPS>
cudaError_t launch_bn(int bn, dim3 grid, cudaStream_t stream, const __nv_bfloat16* feats,
                      const __nv_bfloat16* w, const int* kmap, const bool* valid_out,
                      const float* bias, float* out, int m_out, int K, int cin_p, int cout,
                      int w_pitch, int steps) {
#define PBNET_GEMM(B)                                                                       \
  case B:                                                                                   \
    return launch_gemm<WARPS, B>(grid, stream, feats, w, kmap, valid_out, bias, out, m_out, \
                                 K, cin_p, cout, w_pitch, steps);
  switch (bn) {
    PBNET_GEMM(32)
    PBNET_GEMM(64)
    PBNET_GEMM(96)
    PBNET_GEMM(128)
  }
#undef PBNET_GEMM
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// feats_bf16 (m_in, cin_p) and w_bf16 (depth, w_pitch) are scratch for the
// rounded operands.  bm in {64, 128}; bn in {32, 64, 96, 128} divides
// w_pitch; cin_p is a multiple of 8 and >= cin; depth is a multiple of 32
// and >= K * cin_p; bias may be null.
int pbnet_gather_gemm(const float* feats, const float* w, const int* kmap, const bool* valid_out,
                      const float* bias, float* out, void* feats_bf16, void* w_bf16, int m_in,
                      int m_out, int K, int cin, int cin_p, int cout, int w_pitch, int depth,
                      int bm, int bn, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (cin_p % 8 || cin_p < cin || depth % KC || depth < K * cin_p || w_pitch % bn ||
      w_pitch < cout || m_out < 1)
    return (int)cudaErrorInvalidValue;
  auto* fb = static_cast<__nv_bfloat16*>(feats_bf16);
  auto* wb = static_cast<__nv_bfloat16*>(w_bf16);
  const size_t n8 = ((size_t)m_in * cin_p + (size_t)depth * w_pitch) / 8;
  conv_operands_copy_kernel<<<grid_stride_blocks(n8, 256), 256, 0, st>>>(
      feats, fb, m_in, cin, cin_p, w, wb, K, cout, depth, w_pitch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m_out + bm - 1) / bm, w_pitch / bn);
  if (bm == 128)
    e = launch_bn<8>(bn, grid, st, fb, wb, kmap, valid_out, bias, out, m_out, K, cin_p, cout,
                     w_pitch, depth / KC);
  else if (bm == 64)
    e = launch_bn<4>(bn, grid, st, fb, wb, kmap, valid_out, bias, out, m_out, K, cin_p, cout,
                     w_pitch, depth / KC);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
