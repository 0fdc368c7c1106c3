// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the float32 kernels' tile sizes and the -1e30 mask, and
// for K2 (flash_bwd_dq_bf16) bf16 tensor-core products (mma.sync m16n8k16,
// float32 accumulate), ldmatrix fragment loads and cp.async tile staging.
// The wgmma kernels (K1 and K3 in bf16) use flash_hopper.cuh.
//
// Fragment layout of mma.m16n8k16.row.col with g = lane / 4, t = lane % 4:
//   A (16x16):  a[0] = A[g][2t..2t+1]    a[1] = A[g+8][2t..2t+1]
//               a[2] = A[g][2t+8..+9]    a[3] = A[g+8][2t+8..+9]
//   B (16x8):   b0 = B[2t..2t+1][g]      b1 = B[2t+8..2t+9][g]
//   C (16x8):   c[0..1] = C[g][2t..2t+1] c[2..3] = C[g+8][2t..2t+1]
// so a C fragment pair (n-tiles 2kk, 2kk+1) re-packs as the A fragment of
// k-step kk without leaving the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int MMA_THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, whose fragment lands in r[i] (lane l holds row
// l / 4, columns 2(l % 4) and 2(l % 4) + 1; transposed with trans)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without passing through registers; with
// valid false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + 64) of a [S, D] bf16 slab with row
// stride ld (elements) into dst (row pitch D + 8); rows at or past n are
// zero.  With vec (16-byte aligned rows) every thread issues its cp.async
// copies at once and returns; otherwise plain loads and stores.  Either way
// the tile is complete after cp_async_wait and __syncthreads.  Called by
// all MMA_THREADS threads of a block.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t ld, int row0, int n,
                                          bool vec) {
  constexpr int CHUNKS = D / 8;  // 8 elements per chunk
#pragma unroll
  for (int it = 0; it < 64 * CHUNKS / MMA_THREADS; ++it) {
    const int i = threadIdx.x + it * MMA_THREADS;
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, row = row0 + r;
    bf16* d = dst + r * (D + 8) + c;
    if (vec) {
      const bool ok = row < n;
      cp_async16(d, ok ? src + (int64_t)row * ld + c : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = row < n ? src[(int64_t)row * ld + c + e]
                       : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ bool aligned16(const bf16* base, int64_t ld) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && ld % 8 == 0;
}

// The A fragments of 16 rows (r_lo and r_lo + 8 of a [*, D + 8] bf16 tile)
// over all D / 16 k-steps, into registers.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const bf16* tile, int r_lo,
                                             int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld32(tile + r_lo * LD + kk * 16 + 2 * t);
    a[kk][1] = ld32(tile + (r_lo + 8) * LD + kk * 16 + 2 * t);
    a[kk][2] = ld32(tile + r_lo * LD + kk * 16 + 8 + 2 * t);
    a[kk][3] = ld32(tile + (r_lo + 8) * LD + kk * 16 + 8 + 2 * t);
  }
}

}  // namespace
