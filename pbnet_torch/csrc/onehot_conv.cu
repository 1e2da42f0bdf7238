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
// the plan and the output, read or written once.  What a straight design
// pays beyond that is the re-reading: every output row reads up to K input
// rows, and every block reads every slot's weights.
//
// Design.  The TPU kernel DMAs each (dx, dy) group's whole band into VMEM
// and gathers with a one-hot matrix product on the MXU.  A band does not
// fit in shared memory here (L1 k3: 1280 rows x 128 ch x 2 B = 320 KB), and
// a one-hot row times the band is exactly that band row, so this kernel
// reads each present row straight from global memory: the band keeps a
// tile's reads within a narrow, L2-resident stretch of the table.  A block
// owns BM = 128 output rows and BN = 64 output columns.  Per slot and per
// 64-channel chunk it stages the 128 gathered rows (absent ones as zeros)
// and the weight chunk in shared memory, rounding f32 to bf16 on the way,
// and 8 warps multiply them on the tensor cores (WMMA 16x16x16 bf16, f32
// accumulators; warp w owns rows 16w..16w+15).  A slot that no row of the
// block uses is skipped.  The accumulators go through shared memory so the
// valid_out mask and the ragged column edge are applied on the way out.
// The kernel does no f32 arithmetic outside the tensor cores, so the
// library-wide -fmad=false changes nothing here.
//
// The launcher returns cudaGetLastError() so the caller can raise on a
// refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;            // output rows per block
constexpr int BN = 64;             // output columns per block
constexpr int KC = 64;             // input channels staged per pass
constexpr int THREADS = 256;       // 8 warps, one 16-row strip each
constexpr int LDA = KC + 8;        // bf16 row pitch of the staged rows
constexpr int LDB = BN + 8;        // bf16 row pitch of the staged weights
constexpr int LDC = BN + 4;        // f32 row pitch of the output tile
constexpr int A_BYTES = BM * LDA * 2;
constexpr int B_BYTES = KC * LDB * 2;
constexpr int C_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = (A_BYTES + B_BYTES > C_BYTES) ? A_BYTES + B_BYTES : C_BYTES;

__global__ void __launch_bounds__(THREADS)
onehot_conv_kernel(const float* __restrict__ feats, const float* __restrict__ w,
                   const int* __restrict__ starts, const int* __restrict__ rel,
                   const bool* __restrict__ valid_out, float* __restrict__ out,
                   int cin, int cout, int K, int kz, int tm, int m_out, int span) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int src[BM];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* sc = reinterpret_cast<float*>(smem);  // reused after the last product

  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int G = K / kz;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int s = 0; s < K; ++s) {
    // source row of each output row for this slot (-1: absent or dropped)
    int used = 0;
    if (threadIdx.x < BM) {
      const int m = row0 + threadIdx.x;
      int r = -1;
      if (m < m_out) {
        const int off = rel[(size_t)m * K + s];
        if (off < span) r = starts[(m / tm) * G + s / kz] + off;
      }
      src[threadIdx.x] = r;
      used = r >= 0;
    }
    // also orders the writes of src before its reads, and the previous
    // slot's products before this slot's staging
    if (!__syncthreads_or(used)) continue;

    for (int c0 = 0; c0 < cin; c0 += KC) {
      const int kc = min(KC, cin - c0);
      // gathered rows: thread -> (row, channel); consecutive threads read
      // consecutive channels of one row
      for (int e = threadIdx.x; e < BM * KC; e += THREADS) {
        const int r = e / KC, c = e % KC;
        const int sr = src[r];
        const float v = (sr >= 0 && c < kc) ? feats[(size_t)sr * cin + c0 + c] : 0.0f;
        sa[r * LDA + c] = __float2bfloat16_rn(v);
      }
      // weight chunk W[s, c0:c0+KC, col0:col0+BN]
      const float* ws = w + (size_t)s * cin * cout;
      for (int e = threadIdx.x; e < KC * BN; e += THREADS) {
        const int k = e / BN, n = e % BN;
        const float v = (k < kc && col0 + n < cout) ? ws[(size_t)(c0 + k) * cout + col0 + n] : 0.0f;
        sb[k * LDB + n] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      const int ksteps = (kc + 15) / 16;
      for (int k = 0; k < ksteps; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sa + warp * 16 * LDA + k * 16, LDA);
#pragma unroll
        for (int n = 0; n < BN / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sb + k * 16 * LDB + n * 16, LDB);
          wmma::mma_sync(acc[n], a, b, acc[n]);
        }
      }
      __syncthreads();  // the staged chunk is consumed
    }
  }

  __syncthreads();
#pragma unroll
  for (int n = 0; n < BN / 16; ++n)
    wmma::store_matrix_sync(sc + warp * 16 * LDC + n * 16, acc[n], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, n = e % BN;
    const int m = row0 + r, col = col0 + n;
    if (m < m_out && col < cout) out[(size_t)m * cout + col] = valid_out[m] ? sc[r * LDC + n] : 0.0f;
  }
}

}  // namespace

extern "C" {

int pbnet_onehot_conv(const float* feats, const float* w, const int* starts,
                      const int* rel, const bool* valid_out, float* out, int m_in,
                      int cin, int cout, int K, int kz, int tm, int m_out, int span,
                      void* stream) {
  (void)m_in;  // bounds every source row (starts + span <= m_in by the plan)
  const dim3 grid((m_out + BM - 1) / BM, (cout + BN - 1) / BN);
  onehot_conv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      feats, w, starts, rel, valid_out, out, cin, cout, K, kz, tm, m_out, span);
  return (int)cudaGetLastError();
}

}  // extern "C"
