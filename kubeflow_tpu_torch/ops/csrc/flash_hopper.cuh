// Hopper building blocks shared by the wgmma flash kernels (flash_fwd.cu's
// K1, flash_bwd.cu's K2 and K3): TMA tensor maps and loads, mbarrier rings,
// warpgroup products (wgmma) on 128-byte-swizzled tiles, and the register
// hand-over between a producer warpgroup and consumer warpgroups.
//
// Tiles.  Every bf16 tile is loaded by TMA from a [B, S, H, D] tensor seen
// as a 4-D tensor (D, H, S, B), innermost first, with a box of (64, 1,
// rows, 1): one box is `rows` rows of 64 elements (128 bytes), stored with
// the 128-byte swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)).
// A tile of D = 128 is two boxes, one per 64-column half, one after the
// other.  Out-of-range rows are zero-filled by TMA, so ragged lengths need
// no copies.  TMA takes 16-byte aligned base addresses and strides that
// are multiples of 16 bytes: the wrappers check that (ops/flash_attention.py
// _tma_compatible) and raise before a launch.
//
// Products.  wgmma m64nNk16 (bf16 in, float32 accumulate) with B from
// shared memory through a matrix descriptor, and A either from shared
// memory (K-major: D contiguous) or from registers.  A K-major operand of
// one box advances 32 bytes per 16-element k-step inside its swizzled row;
// an MN-major operand (V or dO in a P V product, K in K2's dS K: the
// product's N is D, contiguous in memory) advances 16 rows (2048 bytes) per
// k-step, with the two D halves one box apart (the descriptor's leading
// byte offset).
//
// Accumulator layout of m64nN (f32), thread lane l of warp w of the
// warpgroup, g = l / 4, t = l % 4:  d[4j + 2r + e] sits at row 16w + g + 8r,
// column 8j + 2t + e.  Columns 16kk .. 16kk + 15 of it re-pack as the A
// register fragment of k-step kk: a[i] = pack(d[8kk + 2i], d[8kk + 2i + 1]),
// so a score tile becomes the A operand of the next product in registers.
//
// Rows.  K3's lse and delta rows ([B, H, Sq] float32, contiguous) are read
// by TMA too, through a 1-D map over the whole tensor (a 2-D map's row
// stride, Sq x 4 bytes, would have to be a multiple of 16).  A box must
// start 16 bytes aligned, so a tile's 64 rows come in a box of 68 values
// from the aligned value at or before the first; the consumer reads from
// the offset.  Values past a head's Sq belong to the next head or are
// zero-filled; the kernel masks those columns.
//
// The tensor-map encoder (cuTensorMapEncodeTiled) is a driver API, and the
// libraries are built without -lcuda: it is fetched once through the
// runtime's cudaGetDriverEntryPoint[ByVersion].

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WG = 128;             // threads of a warpgroup
constexpr int BOX_BYTES = 128;      // bytes of one swizzled box row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// --- device ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed.  A wait that does
// not end within ~2^34 cycles (seconds; a launch of these kernels takes
// well under a millisecond) can only be a fault: it traps, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: one box of a 4-D map at coordinates (c0, c1, c2, c3) into shared
// memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// TMA: one box of a 1-D map starting at element c0
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// Registers per thread after the hand-over: the producer warpgroup gives
// (168 - 40) x 128 to the two consumer warpgroups, (232 - 168) x 256; a
// block of 384 threads starts at 168 (65,536 / 384, rounded down to 8).
// ptxas reports 168 for the kernel (its count at entry) but allocates up
// to 232 in the code after setmaxnreg.inc: K1's and K2's consumers at
// D = 256 hold 176 and 168 accumulator values with registers past R200
// and no spill (chip_smoke.py prints each kernel's highest register).
// K3's consumers stay within 168 whatever they ask (flash_bwd.cu,
// DkvTiles).  A consumer asking for more than the producer frees (240:
// 18,432 registers against 16,384) waits in setmaxnreg.inc for ever.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// barrier over the first `threads` threads to arrive at named barrier `id`
// (ids 1.. ; 0 is __syncthreads): one warpgroup, or both consumers
template <int THREADS = WG>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int id) { named_sync<WG>(id); }

// arrive at named barrier `id` without waiting (the other side syncs)
template <int THREADS>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

// order this thread's generic-proxy accesses of shared memory before later
// async-proxy ones (a TMA load into a tile the thread has written or read)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The M registers a thread holds of an m64n(2M) accumulator, seen as the N
// of the m64n(2N) accumulator over its columns 2NI .. 2N(I + 1) - 1 (the
// layout above repeats every 8 columns).  An m64n256 product is issued as
// two m64n128 ones on parts 0 and 1, the second with B two boxes on.
template <int I, int N, int M>
__device__ __forceinline__ float (&part(float (&a)[M]))[N] {
  static_assert(N * (I + 1) <= M, "part out of range");
  return *reinterpret_cast<float(*)[N]>(a + N * I);
}

// x, which the compiler may no longer assume it knows: what is computed
// from it inside a loop stays inside the loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous product that writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared address
// `addr`: leading and stride byte offsets as the PTX ISA defines them for
// the operand's major-ness (K-major: lbo unused, sbo = 1024 between 8-row
// groups; MN-major: lbo between 64-element blocks of N, sbo = 1024
// between 8-row groups of K)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x on the special-function unit, one instruction (exp2f adds a
// denormal-range fix-up around it); results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Store the m64nD accumulator `acc` (times `mul[r]` for its two rows r) as
// bf16 into a swizzled [64][D] tile (D / 64 boxes of 64 rows, one `half`
// bytes apart) at shared address `tile`, then, after the warpgroup's
// barrier, copy the tile's first `valid` rows to global rows of stride `ld`
// (elements) with 16-byte stores.  Called by the 128 threads of one
// warpgroup; `bar_id` is its named barrier.
template <int D>
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[D / 2],
                                                const float (&mul)[2],
                                                uint32_t tile, uint32_t half,
                                                __nv_bfloat16* dst, int64_t ld,
                                                int valid, int bar_id) {
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  warpgroup_sync(bar_id);  // every product that read the tile has retired
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r, chunk = j % 8;
      const uint32_t at = tile + (j / 8) * half + row * BOX_BYTES +
                          ((chunk ^ (row % 8)) * 16) + 4 * t;
      const uint32_t v =
          pack2_bf16(acc[4 * j + 2 * r] * mul[r], acc[4 * j + 2 * r + 1] * mul[r]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
    }
  warpgroup_sync(bar_id);
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < 64 * CHUNKS; i += WG) {
    const int row = i / CHUNKS, c = i % CHUNKS;
    if (row >= valid) break;  // rows are visited in order
    const uint32_t at = tile + (c / 8) * half + row * BOX_BYTES +
                        (((c % 8) ^ (row % 8)) * 16);
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(at));
    *reinterpret_cast<uint4*>(dst + row * ld + c * 8) = v;
  }
}

// wgmma m64nNk16, bf16 in, float32 accumulate.  ss: A and B from shared
// memory, both K-major; acc 0 overwrites d.  rs: A from registers (the
// m16n8k16 A fragment per warp), B MN-major (transposed).

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                            uint64_t b, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


// --- host ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;  // the same pointer for every caller
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a bf16 [B, S, H, D] view with element strides (sb, ss, sh)
// and a unit innermost stride, as (D, H, S, B) with a (64, 1, rows, 1)
// box and the 128-byte swizzle.
cudaError_t map_bshd(CUtensorMap* map, const void* base, int b, int s, int h,
                     int d, int64_t sb, int64_t ss, int64_t sh, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over `n` contiguous float32 values (16-byte aligned base) with a
// box of `box` values and no swizzle: a run of lse or delta rows, read
// from any element offset.
cudaError_t map_rows(CUtensorMap* map, const float* base, int64_t n, int box) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t unused[1] = {((cuuint64_t)n * 4 + 15) / 16 * 16};  // rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                      const_cast<float*>(base), dims, unused, boxes, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_NONE,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
