// Pieces shared by the two sparse-conv kernels (onehot_conv.cu and
// gather_gemm.cu): async copies into shared memory, ldmatrix, the bf16
// mma.sync, and the pass that rounds a conv's operands to bf16.  The
// build hashes this header into every library's name, so an edit here
// rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; full == false zero-fills the destination, reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 operands (round to nearest even, as `.to(torch.bfloat16)`): feats
// (m_in, cin) -> (m_in, cin_p); W (K, cin, cout) -> (depth, w_pitch), row
// k * cin_p + c; zero padding past cin, past cout and past K * cin_p rows.
// Eight outputs (16 bytes) per thread, over a grid-stride loop.
__device__ __forceinline__ void bf16_operands(const float* __restrict__ feats,
                                              __nv_bfloat16* __restrict__ fo, int m_in, int cin,
                                              int cin_p, const float* __restrict__ w,
                                              __nv_bfloat16* __restrict__ wo, int K, int cout,
                                              int depth, int w_pitch) {
  const size_t pf = cin_p / 8, pw = w_pitch / 8;
  const size_t nf = (size_t)m_in * pf, n = nf + (size_t)depth * pw;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const float* src;
    int c0, len;
    __nv_bfloat16* dst;
    if (e < nf) {
      const size_t row = e / pf;
      c0 = (int)(e - row * pf) * 8;
      src = feats + row * cin;
      len = cin;
      dst = fo + e * 8;
    } else {
      const size_t e2 = e - nf, row = e2 / pw;  // row = k * cin_p + c
      const int k = (int)(row / cin_p), c = (int)(row % cin_p);
      c0 = (int)(e2 - row * pw) * 8;
      const bool live = k < K && c < cin;
      src = live ? w + ((size_t)k * cin + c) * cout : w;
      len = live ? cout : 0;
      dst = wo + e2 * 8;
    }
    uint32_t packed[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 2 * q;
      const float a = c < len ? src[c] : 0.0f;
      const float b = c + 1 < len ? src[c + 1] : 0.0f;
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      packed[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// one thread per element (the loops stride past 2^20 blocks)
inline int grid_stride_blocks(size_t n, int threads) {
  const size_t b = (n + threads - 1) / threads;
  return (int)(b < (1u << 20) ? (b > 0 ? b : 1) : (1u << 20));
}

}  // namespace
