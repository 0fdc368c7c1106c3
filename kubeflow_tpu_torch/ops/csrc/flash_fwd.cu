// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash_attention.py:63-155
// (_fwd_kernel, launched by _flash_fwd through pl.pallas_call).  It computes
// the same function:
//     O   = softmax(Q K^T / sqrt(D) + causal mask) V       (input dtype)
//     lse = m + log(l) per query row                          (float32)
// with online softmax over key tiles, float32 running max / sum /
// accumulator, the causal mask offset by sk - sq, and key tiles past the
// last visible key skipped.  Masked scores are -1e30 (not -inf), as the TPU
// kernel's _NEG_INF, so a row that sees no key yields finite values.
//
// What bounds it on the H100.  At the serving prefill shapes (Sq 512, Sk
// 512..1536, 32 heads of 128) the work is 2-11 GFLOP against 17-34 MB of
// Q/K/V/O: at the bf16 tensor-core rate (989 TFLOP/s) and 3.35 TB/s the two
// bounds are within 2x of each other (5 us bytes-bound at 512x512, 11 us
// operations-bound at 512x1536).  So the design keeps every intermediate out
// of device memory (S and P live in registers, K/V are read once per
// 64-query tile, O and lse are written once) and puts the bf16 products on
// the tensor cores.
//
// Two kernels, one per input dtype:
// - bf16 (the serving path): flash_fwd_bf16_mma, QK^T and PV with
//   mma.sync m16n8k16 (float32 accumulate), 4 warps of 16 query rows, P kept
//   in registers and rounded to bf16 for PV (l sums the float32 values).
//   K/V tiles are double-buffered with cp.async, so the next tile's copy
//   overlaps this tile's products.  No TMA or wgmma yet: the next step
//   (PERF.md).
// - float32: flash_fwd_f32, both products on the CUDA cores in float32, so
//   the result is exact to float32 rounding (no TF32).
//
// Both: one block per (batch, head, 64-row query tile) and a loop over
// 64-key tiles staged in shared memory.  Inputs are [B, S, H, D] with
// arbitrary batch / sequence / head strides (innermost stride 1): no
// transpose copies.  GQA reads kv head h / (H / Hkv) instead of repeating.
// Ragged Sq / Sk are masked in-kernel; tail query rows are never written.
// Shared memory above 48 KB (f32 at D=128: 115 KB; bf16 at D=128: 85 KB)
// is requested with cudaFuncSetAttribute before each launch (the setting
// is per device).

#include "flash_common.cuh"

namespace {

constexpr int THREADS = 256;  // the float32 kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq], contiguous
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int sq, sk, h, group, causal;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// float32 inputs on the CUDA cores.  256 threads; a thread owns 4 query
// rows x 4 score columns of each 64x64 score tile and 4 rows x D/16 output
// columns; row max / sum reduce over the 16 lanes of a row group (shuffle
// xor 8,4,2,1).  Q (pre-scaled), K, V and P are staged in shared memory,
// rows padded by one word against bank conflicts.
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(const Params p) {
  constexpr int CPT = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D + 1]   (pre-scaled)
  float* ks = qs + BQ * (D + 1);     // [BK][D + 1]
  float* vs = ks + BK * (D + 1);     // [BK][D]
  float* ps = vs + BK * D;           // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // owns query rows rg*4 .. rg*4+3 of the tile
  const int cg = tid % 16;  // owns columns cg + 16*j
  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / p.group;
  const int offset = p.sk - p.sq;  // query i sits at absolute i + offset

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + hq * p.o_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    qs[r * (D + 1) + d] =
        qi < p.sq ? qg[(int64_t)qi * p.q_ss + d] * p.scale : 0.f;
  }

  int n_tiles = (p.sk + BK - 1) / BK;
  if (p.causal) {
    // only key tiles whose start is <= the last query's absolute position
    const int last_key = min(q0 + BQ, p.sq) - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / BK + 1);
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D, kj = k0 + r;
      const bool ok = kj < p.sk;
      ks[r * (D + 1) + d] = ok ? kg[(int64_t)kj * p.k_ss + d] : 0.f;
      vs[i] = ok ? vg[(int64_t)kj * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i + offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 16 * j;
        if (kj >= p.sk || (p.causal && kj > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(rg * 4 + i) * (BK + 1) + cg + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vs[kk * D + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();  // K, V and P are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= p.sq) continue;  // tail rows of the last tile
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      og[(int64_t)qi * p.o_ss + cg + 16 * c] = acc[i][c] / li;
    if (cg == 0)
      p.lse[((int64_t)b * p.h + hq) * p.sq + qi] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: both products on the tensor cores (mma.sync m16n8k16, f32
// accumulate).  128 threads; warp w owns query rows 16w..16w+15 of the
// tile.  Q fragments stay in registers for the whole key loop; K and V are
// staged row-major in shared memory (bf16, rows padded by 16 bytes so
// fragment loads are free of bank conflicts) and the B fragments of PV come
// from V through ldmatrix.trans.  The score fragment of QK^T is re-packed
// in registers as the A fragment of PV, so P never leaves the registers; P
// is rounded to bf16 for that product (the running sum l uses the float32
// values).

// shared memory: the Q tile and two stages of (K, V) tiles, row pitch D + 8
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t)((BQ + 4 * BK) * (D + 8));
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_bf16_mma(const Params p) {
  constexpr int LDK = D + 8;   // pitch of the Q, K and V tiles
  constexpr int KSTEPS = D / 16, NT_S = BK / 8, NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDK]
  bf16* kv = qs + BQ * LDK;  // stage s: K at kv + 2s*TILE, V one TILE on
  constexpr int TILE = BK * LDK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / p.group;
  const int offset = p.sk - p.sq;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + hq * p.o_sh;

  int n_tiles = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const int last_key = min(q0 + BQ, p.sq) - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / BK + 1);
  }
  const bool vec_kv = aligned16(kg, p.k_ss) && aligned16(vg, p.v_ss);

  // the Q tile and the first K/V stage, then Q's fragments into registers
  load_tile<D>(qs, qg, p.q_ss, q0, p.sq, aligned16(qg, p.q_ss));
  if (n_tiles > 0) {
    load_tile<D>(kv, kg, p.k_ss, 0, p.sk, vec_kv);
    load_tile<D>(kv + TILE, vg, p.v_ss, 0, p.sk, vec_kv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r_lo = warp * 16 + g;  // this thread's rows: r_lo and r_lo + 8
  uint32_t qa[KSTEPS][4];
  load_a_frags<D>(qa, qs, r_lo, t);
  const int qpos[2] = {q0 + r_lo + offset, q0 + r_lo + 8 + offset};

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const bf16* ks = kv + 2 * (tile & 1) * TILE;
    const bf16* vs = ks + TILE;
    if (tile + 1 < n_tiles) {  // the next stage loads while this one runs
      bf16* next = kv + 2 * ((tile + 1) & 1) * TILE;
      load_tile<D>(next, kg, p.k_ss, k0 + BK, p.sk, vec_kv);
      load_tile<D>(next + TILE, vg, p.v_ss, k0 + BK, p.sk, vec_kv);
    }
    cp_async_commit();   // an empty group on the last tile keeps the count
    cp_async_wait<1>();  // this tile's stage has landed (for this thread)
    __syncthreads();     // ... and for every thread

    // S = Q K^T.  One ldmatrix.x4 gives the B fragments of key steps kk
    // and kk+1 for keys 8j..8j+7: matrix i covers columns 16kk + 8i .. +7
    // of K.
    const bf16* klane = ks + (lane & 7) * LDK + (lane >> 3) * 8;
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, klane + 8 * j * LDK + kk * 16);
        mma_bf16(s[j], qa[kk], kb[0], kb[1]);
        mma_bf16(s[j], qa[kk + 1], kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax; element e of s[j] sits at row
    // r_lo + 8 * (e / 2), key k0 + 8j + 2t + (e % 2).  Only a tile that
    // reaches past Sk or past the block's first query position is masked.
    const bool masked =
        k0 + BK > p.sk || (p.causal && k0 + BK - 1 > q0 + offset);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          float v = s[j][e] * p.scale;
          if (masked && (kj >= p.sk || (p.causal && kj > qpos[r])))
            v = NEG_INF;
          s[j][e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);
          rs += s[j][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V: score tiles 2kk and 2kk+1 form the A fragment of key step
    // kk.  One ldmatrix.x4.trans gives the B fragments of output columns
    // 8n and 8(n+1): matrix i covers keys 16kk + 8(i & 1) .. +7 and
    // columns 8(n + i / 2) .. +7 of V.
    const bf16* vlane =
        vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDK + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vlane + kk * 16 * LDK + 8 * n);
        mma_bf16(acc[n], pa, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the next iteration refills the stage read here
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r_lo + 8 * r;
    if (qi >= p.sq) continue;  // tail rows of the last tile
    const float li = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      // O is the wrapper's contiguous allocation: 4-byte aligned pairs
      *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)qi * p.o_ss + 8 * n +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] / li, acc[n][2 * r + 1] / li);
    }
    if (t == 0) p.lse[((int64_t)b * p.h + hq) * p.sq + qi] = m[r] + logf(li);
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, batch);
  flash_fwd_bf16_mma<D><<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, batch);
  flash_fwd_f32<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// batch, sequence and head dims of q, k, v and o ([B, S, H, D] views whose
// innermost stride is 1).  Returns the cudaError_t of the launch.
extern "C" int kf_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int batch, int sq,
                            int sk, int h, int hkv, int d,
                            const int64_t* strides, float scale, int causal,
                            void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.group = h / hkv;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && d == 64) err = launch_f32<64>(p, batch, st);
  else if (dtype == 0 && d == 128) err = launch_f32<128>(p, batch, st);
  else if (dtype == 1 && d == 64) err = launch_mma<64>(p, batch, st);
  else if (dtype == 1 && d == 128) err = launch_mma<128>(p, batch, st);
  return (int)err;
}
