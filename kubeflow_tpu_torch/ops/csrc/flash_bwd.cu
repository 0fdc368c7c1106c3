// Flash-attention backward for Hopper (sm_90a), CUDA C++: dQ and dK/dV.
//
// Replaces the two TPU kernels of kubeflow_tpu/ops/flash_attention.py's
// backward (launched by _flash_bwd_pallas through pl.pallas_call):
// - flash_bwd_dq  <- _bwd_dq_kernel  (:158-198, pallas_call :264)
// - flash_bwd_dkv <- _bwd_dkv_kernel (:201-248, pallas_call :282)
// Both recompute the attention weights from the forward's log-sum-exp:
//     s  = Q K^T / sqrt(D)  (causal mask offset sk - sq; masked = -1e30)
//     P  = exp(s - lse)          dP = dO V^T
//     dS = P o (dP - delta) / sqrt(D),   delta = rowsum(dO o O)
//     dQ = dS K        dK = dS^T Q        dV = P^T dO
// with float32 accumulation; dQ, dK and dV are written in the input dtype.
// delta is one float32 reduction computed by the caller, as the reference
// computes it outside its kernels (:259-261).
//
// The scores are recomputed exactly as flash_fwd.cu produced lse: bf16
// products on mma.sync with the same k-step order, then the float32
// multiply by the scale; in float32, Q pre-scaled and one fmaf per d in
// order.  So P = exp(s - lse) stays <= 1 and rows sum to 1.
//
// What bounds them on the H100.  At BERT-large's training shape (B 24,
// S 512, H 16, D 64, non-causal, bf16) dq does 3 products (38.7 GFLOP over
// 127 MB) and dkv 4 (51.5 GFLOP over 151 MB): 0.039 and 0.052 ms at the
// bf16 tensor-core rate against 0.038 and 0.045 ms at 3.35 TB/s, so both
// are operations-bound, barely.  The design keeps S, P, dP and dS in
// registers (never in device memory), reads each K/V tile once per
// 64-query tile (dq) and each Q/dO tile once per 64-key tile (dkv), and
// puts every bf16 product on the tensor cores.  No atomics: each block owns
// its output rows, which costs the second recompute of P (the price of two
// kernels instead of one with atomic dQ; fusing them is later work).
//
// Two kernels per input dtype:
// - bf16: mma.sync m16n8k16 (float32 accumulate), 4 warps of 16 rows.
//   dq: warp rows are queries; Q and dO A fragments in registers; K/V tiles
//   double-buffered with cp.async; per 16-key slice S and dP come from
//   ldmatrix B fragments of K and V, dS is re-packed in registers as the A
//   fragment of dS K, whose B fragments come from K by ldmatrix.trans.
//   dkv: warp rows are keys; K and V A fragments in registers; Q/dO tiles
//   (and their lse / delta rows) double-buffered; per 16-query slice S^T =
//   K Q^T and dP^T = V dO^T, then P^T and dS^T are re-packed as the A
//   fragments of P^T dO and dS^T Q (B fragments by ldmatrix.trans).  Under
//   GQA the block loops over the G query heads of its kv head, so dK/dV sum
//   over the group in registers.  P and dS are rounded to bf16 for their
//   products, as every tensor-core flash backward does.
// - float32: the same loops on the CUDA cores in float32 (no TF32).
//
// Causal: dq visits key tiles up to its last query's position, dkv starts
// at the first query tile that sees its key tile (:213-217).  Ragged Sq/Sk
// tails are masked in-kernel, tail rows are never written.  Inputs are
// [B, S, H, D] views with any batch / sequence / head strides (innermost
// stride 1); outputs are the caller's contiguous [B, S, H, D] tensors.

#include "flash_common.cuh"

namespace {

constexpr int F32_THREADS = 256;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq], contiguous
  const float* delta;  // [B, H, Sq], contiguous
  void* dq;            // [B, Sq, H, D], contiguous
  void* dk;            // [B, Sk, Hkv, D], contiguous
  void* dv;            // [B, Sk, Hkv, D], contiguous
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int sq, sk, h, hkv, group, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16, dQ: one block per (64-query tile, query head, batch).

template <int D>
constexpr size_t dq_mma_smem_bytes() {  // Q, dO, two stages of (K, V)
  return sizeof(bf16) * (size_t)((2 * BQ + 4 * BK) * (D + 8));
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dq_bf16(const BwdParams p) {
  constexpr int LD = D + 8, KSTEPS = D / 16, NT_O = D / 8;
  constexpr int TILE = BK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dos = qs + BQ * LD;                      // [BQ][LD]
  bf16* kv = dos + BQ * LD;  // stage s: K at kv + 2s*TILE, V one TILE on

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / p.group;
  const int offset = p.sk - p.sq;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + hq * p.do_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* dqg = static_cast<bf16*>(p.dq) + ((int64_t)b * p.sq * p.h + hq) * D;
  const int64_t dq_ss = (int64_t)p.h * D;

  int n_tiles = (p.sk + BK - 1) / BK;
  if (p.causal) {  // only key tiles that some query of this tile sees
    const int last_key = min(q0 + BQ, p.sq) - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / BK + 1);
  }
  const bool vec_kv = aligned16(kg, p.k_ss) && aligned16(vg, p.v_ss);

  load_tile<D>(qs, qg, p.q_ss, q0, p.sq, aligned16(qg, p.q_ss));
  load_tile<D>(dos, dog, p.do_ss, q0, p.sq, aligned16(dog, p.do_ss));
  if (n_tiles > 0) {
    load_tile<D>(kv, kg, p.k_ss, 0, p.sk, vec_kv);
    load_tile<D>(kv + TILE, vg, p.v_ss, 0, p.sk, vec_kv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r_lo = warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8
  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
  load_a_frags<D>(qa, qs, r_lo, t);
  load_a_frags<D>(da, dos, r_lo, t);
  float lse[2], delta[2];
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r_lo + 8 * r;
    const int64_t at = ((int64_t)b * p.h + hq) * p.sq + qi;
    lse[r] = qi < p.sq ? p.lse[at] : 0.f;
    delta[r] = qi < p.sq ? p.delta[at] : 0.f;
    qpos[r] = qi + offset;
  }

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
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bool masked =
        k0 + BK > p.sk || (p.causal && k0 + BK - 1 > q0 + offset);
    // B fragments of S = Q K^T and dP = dO V^T (as flash_fwd.cu's S), and
    // of dS K (as flash_fwd.cu's PV, from K)
    const int nt_row = (lane & 7), nt_col = (lane >> 3) * 8;
    const bf16* klane = ks + nt_row * LD + nt_col;
    const bf16* vlane = vs + nt_row * LD + nt_col;
    const bf16* ktrans =
        ks + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // keys 16kk .. 16kk + 15
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
#pragma unroll
        for (int d = 0; d < KSTEPS; d += 2) {
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, klane + 8 * j * LD + d * 16);
          mma_bf16(s[jj], qa[d], kb[0], kb[1]);
          mma_bf16(s[jj], qa[d + 1], kb[2], kb[3]);
          ldmatrix_x4(vb, vlane + 8 * j * LD + d * 16);
          mma_bf16(dp[jj], da[d], vb[0], vb[1]);
          mma_bf16(dp[jj], da[d + 1], vb[2], vb[3]);
        }
      }
      // element e of s[jj]: row r_lo + 8(e / 2), key k0 + 16kk + 8jj +
      // 2t + (e % 2).  s becomes dS in place.
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kj = k0 + 16 * kk + 8 * jj + 2 * t + (e & 1);
          float sv = s[jj][e] * p.scale;
          if (masked && (kj >= p.sk || (p.causal && kj > qpos[r])))
            sv = NEG_INF;
          const float pv = expf(sv - lse[r]);
          s[jj][e] = pv * (dp[jj][e] - delta[r]) * p.scale;
        }
      const uint32_t dsa[4] = {pack_bf16(s[0][0], s[0][1]),
                               pack_bf16(s[0][2], s[0][3]),
                               pack_bf16(s[1][0], s[1][1]),
                               pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, ktrans + kk * 16 * LD + 8 * n);
        mma_bf16(acc[n], dsa, kb[0], kb[1]);
        mma_bf16(acc[n + 1], dsa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // the next iteration refills the stage read here
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r_lo + 8 * r;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqg + qi * dq_ss + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16, dK/dV: one block per (64-key tile, kv head, batch).

template <int D>
constexpr size_t dkv_mma_smem_bytes() {  // K, V, two stages of (Q, dO)
  return sizeof(bf16) * (size_t)((2 * BK + 4 * BQ) * (D + 8)) +
         sizeof(float) * 4 * BQ;         // two stages of (lse, delta)
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dkv_bf16(const BwdParams p) {
  constexpr int LD = D + 8, KSTEPS = D / 16, NT_O = D / 8;
  constexpr int TILE = BQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* vs = ks + BK * LD;                       // [BK][LD]
  bf16* qd = vs + BK * LD;  // stage s: Q at qd + 2s*TILE, dO one TILE on
  float* rows = reinterpret_cast<float*>(qd + 4 * TILE);  // stage s: lse at
                                                // rows + 2s*BQ, delta BQ on

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int offset = p.sk - p.sq;

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int64_t out_ss = (int64_t)p.hkv * D;
  const int64_t out_base = ((int64_t)b * p.sk * p.hkv + hk) * D;
  bf16* dkg = static_cast<bf16*>(p.dk) + out_base;
  bf16* dvg = static_cast<bf16*>(p.dv) + out_base;

  // query tiles that see this key tile: from the first whose last query
  // reaches key k0 (causal), for each of the group's query heads
  const int n_qt = (p.sq + BQ - 1) / BQ;
  const int first = p.causal ? max(k0 - offset, 0) / BQ : 0;
  const int per_head = max(n_qt - first, 0);
  const int n_iter = per_head * p.group;

  auto load_stage = [&](int it, int stage) {
    const int hq = hk * p.group + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    const bf16* qg =
        static_cast<const bf16*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const bf16* dog =
        static_cast<const bf16*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    bf16* dst = qd + 2 * stage * TILE;
    load_tile<D>(dst, qg, p.q_ss, q0, p.sq, aligned16(qg, p.q_ss));
    load_tile<D>(dst + TILE, dog, p.do_ss, q0, p.sq, aligned16(dog, p.do_ss));
    // threads 0..63 stage the lse rows, 64..127 the delta rows
    const int i = threadIdx.x % BQ, qi = q0 + i;
    const float* src = threadIdx.x < BQ ? p.lse : p.delta;
    rows[2 * stage * BQ + (threadIdx.x < BQ ? 0 : BQ) + i] =
        qi < p.sq ? src[((int64_t)b * p.h + hq) * p.sq + qi] : 0.f;
  };

  const bool vec_kv = aligned16(kg, p.k_ss) && aligned16(vg, p.v_ss);
  load_tile<D>(ks, kg, p.k_ss, k0, p.sk, vec_kv);
  load_tile<D>(vs, vg, p.v_ss, k0, p.sk, vec_kv);
  if (n_iter > 0) load_stage(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r_lo = warp * 16 + (lane >> 2);  // key rows r_lo and r_lo + 8
  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  load_a_frags<D>(ka, ks, r_lo, t);
  load_a_frags<D>(va, vs, r_lo, t);
  const int kpos[2] = {k0 + r_lo, k0 + r_lo + 8};

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) load_stage(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* qs = qd + 2 * stage * TILE;
    const bf16* dos = qs + TILE;
    const float* lse = rows + 2 * stage * BQ;
    const float* delta = lse + BQ;
    const int q0 = (first + it % per_head) * BQ;
    const bool masked =
        q0 + BQ > p.sq || (p.causal && k0 + BK - 1 > q0 + offset);
    const int nt_row = (lane & 7), nt_col = (lane >> 3) * 8;
    const bf16* qlane = qs + nt_row * LD + nt_col;
    const bf16* dolane = dos + nt_row * LD + nt_col;
    const int tr_row = ((lane >> 3) & 1) * 8 + (lane & 7);
    const bf16* qtrans = qs + tr_row * LD + (lane >> 4) * 8;
    const bf16* dotrans = dos + tr_row * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {  // queries 16kk .. 16kk + 15
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
#pragma unroll
        for (int d = 0; d < KSTEPS; d += 2) {
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, qlane + 8 * j * LD + d * 16);
          mma_bf16(s[jj], ka[d], qb[0], qb[1]);
          mma_bf16(s[jj], ka[d + 1], qb[2], qb[3]);
          ldmatrix_x4(ob, dolane + 8 * j * LD + d * 16);
          mma_bf16(dp[jj], va[d], ob[0], ob[1]);
          mma_bf16(dp[jj], va[d + 1], ob[2], ob[3]);
        }
      }
      // element e of s[jj]: key row r_lo + 8(e / 2), query column
      // c = 16kk + 8jj + 2t + (e % 2) of the tile.  s becomes P^T and dp
      // becomes dS^T in place.
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * kk + 8 * jj + 2 * t + (e & 1), qi = q0 + c;
          float sv = s[jj][e] * p.scale;
          if (masked &&
              (qi >= p.sq || (p.causal && kpos[e >> 1] > qi + offset)))
            sv = NEG_INF;
          const float pv = expf(sv - lse[c]);
          s[jj][e] = pv;
          dp[jj][e] = pv * (dp[jj][e] - delta[c]) * p.scale;
        }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      const uint32_t dsa[4] = {pack_bf16(dp[0][0], dp[0][1]),
                               pack_bf16(dp[0][2], dp[0][3]),
                               pack_bf16(dp[1][0], dp[1][1]),
                               pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, dotrans + kk * 16 * LD + 8 * n);
        mma_bf16(dv[n], pa, ob[0], ob[1]);
        mma_bf16(dv[n + 1], pa, ob[2], ob[3]);
        ldmatrix_x4_trans(qb, qtrans + kk * 16 * LD + 8 * n);
        mma_bf16(dk[n], dsa, qb[0], qb[1]);
        mma_bf16(dk[n + 1], dsa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // the next iteration refills the stage read here
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= p.sk) continue;
    const int64_t row = kpos[r] * out_ss;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores.  256 threads; a thread owns 4 rows x 4
// columns (cg + 16j) of each 64x64 score tile and 4 rows x D/16 output
// columns.  Q is staged pre-scaled, as flash_fwd_f32 stages it, and the
// score of a pair is one fmaf per d in order, as there.  Tiles are padded
// by one word per row against bank conflicts.

template <int D>
constexpr size_t dq_f32_smem_bytes() {  // Q, dO, K, V, dS, lse, delta
  return sizeof(float) * (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) +
                                  BQ * (BK + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_bwd_dq_f32(const BwdParams p) {
  constexpr int CPT = D / 16, LD = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][LD], pre-scaled
  float* dos = qs + BQ * LD;     // [BQ][LD]
  float* ks = dos + BQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* dss = vs + BK * LD;     // [BQ][BK + 1]
  float* lse = dss + BQ * (BK + 1);
  float* delta = lse + BQ;

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / p.group;
  const int offset = p.sk - p.sq;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.do_sb + hq * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* dqg = static_cast<float*>(p.dq) + ((int64_t)b * p.sq * p.h + hq) * D;
  const int64_t dq_ss = (int64_t)p.h * D;

  for (int i = tid; i < BQ * D; i += F32_THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    const bool ok = qi < p.sq;
    qs[r * LD + d] = ok ? qg[(int64_t)qi * p.q_ss + d] * p.scale : 0.f;
    dos[r * LD + d] = ok ? dog[(int64_t)qi * p.do_ss + d] : 0.f;
  }
  if (tid < 2 * BQ) {
    const int i = tid % BQ, qi = q0 + i;
    const float* src = tid < BQ ? p.lse : p.delta;
    (tid < BQ ? lse : delta)[i] =
        qi < p.sq ? src[((int64_t)b * p.h + hq) * p.sq + qi] : 0.f;
  }

  int n_tiles = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const int last_key = min(q0 + BQ, p.sq) - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / BK + 1);
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    for (int i = tid; i < BK * D; i += F32_THREADS) {
      const int r = i / D, d = i % D, kj = k0 + r;
      const bool ok = kj < p.sk;
      ks[r * LD + d] = ok ? kg[(int64_t)kj * p.k_ss + d] : 0.f;
      vs[r * LD + d] = ok ? vg[(int64_t)kj * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(rg * 4 + i) * LD + d];
        ov[i] = dos[(rg * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(cg + 16 * j) * LD + d];
        vv[j] = vs[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, qpos = q0 + r + offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 16 * j;
        const float sv =
            (kj >= p.sk || (p.causal && kj > qpos)) ? NEG_INF : s[i][j];
        const float pv = expf(sv - lse[r]);
        dss[r * (BK + 1) + cg + 16 * j] = pv * (dp[i][j] - delta[r]) * p.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(rg * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = ks[kk * LD + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
    __syncthreads();  // K, V and dS are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqg[qi * dq_ss + cg + 16 * c] = acc[i][c];
  }
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {  // K, V, Q, dO, P^T, dS^T, rows
  return sizeof(float) * (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BK * (BQ + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_bwd_dkv_f32(const BwdParams p) {
  constexpr int CPT = D / 16, LD = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;              // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* qs = vs + BK * LD;      // [BQ][LD], pre-scaled
  float* dos = qs + BQ * LD;     // [BQ][LD]
  float* pts = dos + BQ * LD;    // [BK][BQ + 1]: P^T
  float* dst = pts + BK * (BQ + 1);  // [BK][BQ + 1]: dS^T / scale
  float* lse = dst + BK * (BQ + 1);
  float* delta = lse + BQ;

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int offset = p.sk - p.sq;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int64_t out_ss = (int64_t)p.hkv * D;
  const int64_t out_base = ((int64_t)b * p.sk * p.hkv + hk) * D;
  float* dkg = static_cast<float*>(p.dk) + out_base;
  float* dvg = static_cast<float*>(p.dv) + out_base;

  for (int i = tid; i < BK * D; i += F32_THREADS) {
    const int r = i / D, d = i % D, kj = k0 + r;
    const bool ok = kj < p.sk;
    ks[r * LD + d] = ok ? kg[(int64_t)kj * p.k_ss + d] : 0.f;
    vs[r * LD + d] = ok ? vg[(int64_t)kj * p.v_ss + d] : 0.f;
  }

  const int n_qt = (p.sq + BQ - 1) / BQ;
  const int first = p.causal ? max(k0 - offset, 0) / BQ : 0;

  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < p.group; ++g) {
    const int hq = hk * p.group + g;
    const float* qg =
        static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const float* dog =
        static_cast<const float*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    for (int qt = first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      for (int i = tid; i < BQ * D; i += F32_THREADS) {
        const int r = i / D, d = i % D, qi = q0 + r;
        const bool ok = qi < p.sq;
        qs[r * LD + d] = ok ? qg[(int64_t)qi * p.q_ss + d] * p.scale : 0.f;
        dos[r * LD + d] = ok ? dog[(int64_t)qi * p.do_ss + d] : 0.f;
      }
      if (tid < 2 * BQ) {
        const int i = tid % BQ, qi = q0 + i;
        const float* src = tid < BQ ? p.lse : p.delta;
        (tid < BQ ? lse : delta)[i] =
            qi < p.sq ? src[((int64_t)b * p.h + hq) * p.sq + qi] : 0.f;
      }
      __syncthreads();

      // rows are keys rg*4 + i, columns queries cg + 16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(rg * 4 + i) * LD + d];
          vv[i] = vs[(rg * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(cg + 16 * j) * LD + d];
          ov[j] = dos[(cg + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
            dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i, kj = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j, qi = q0 + c;
          const float sv = (qi >= p.sq || (p.causal && kj > qi + offset))
                               ? NEG_INF
                               : s[i][j];
          const float pv = expf(sv - lse[c]);
          pts[r * (BQ + 1) + c] = pv;
          // Q is pre-scaled, so dS^T Q = (dS^T / scale) (scale Q)
          dst[r * (BQ + 1) + c] = pv * (dp[i][j] - delta[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pts[(rg * 4 + i) * (BQ + 1) + qq];
          dsv[i] = dst[(rg * 4 + i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float ov = dos[qq * LD + cg + 16 * c];
          const float qv = qs[qq * LD + cg + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
          }
        }
      }
      __syncthreads();  // Q, dO, P^T and dS^T are overwritten next
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + rg * 4 + i;
    if (kj >= p.sk) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkg[kj * out_ss + cg + 16 * c] = dk[i][c];
      dvg[kj * out_ss + cg + 16 * c] = dv[i][c];
    }
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, int threads,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      int sq, int sk, int h, int hkv, const int64_t* strides,
                      float scale, int causal) {
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.hkv = hkv;
  p.group = h / hkv;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// batch, sequence and head dims of q, k, v and dout ([B, S, H, D] views
// whose innermost stride is 1).  lse and delta are float32 [B, H, Sq];
// dq is a contiguous [B, Sq, H, D] tensor of the input dtype.  Returns the
// cudaError_t of the launch.
extern "C" int kf_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int dtype,
                               int batch, int sq, int sk, int h, int hkv,
                               int d, const int64_t* strides, float scale,
                               int causal, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, sq, sk, h, hkv,
                            strides, scale, causal);
  p.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((sq + BQ - 1) / BQ, h, batch);
  if (dtype == 1 && d == 64)
    return launch(flash_bwd_dq_bf16<64>, dq_mma_smem_bytes<64>(), grid,
                  MMA_THREADS, p, st);
  if (dtype == 1 && d == 128)
    return launch(flash_bwd_dq_bf16<128>, dq_mma_smem_bytes<128>(), grid,
                  MMA_THREADS, p, st);
  if (dtype == 0 && d == 64)
    return launch(flash_bwd_dq_f32<64>, dq_f32_smem_bytes<64>(), grid,
                  F32_THREADS, p, st);
  if (dtype == 0 && d == 128)
    return launch(flash_bwd_dq_f32<128>, dq_f32_smem_bytes<128>(), grid,
                  F32_THREADS, p, st);
  return (int)cudaErrorInvalidValue;
}

// As kf_flash_bwd_dq; dk and dv are contiguous [B, Sk, Hkv, D] tensors of
// the input dtype, each kv head's sum over its H / Hkv query heads.
extern "C" int kf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int dtype, int batch, int sq, int sk, int h,
                                int hkv, int d, const int64_t* strides,
                                float scale, int causal, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, sq, sk, h, hkv,
                            strides, scale, causal);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((sk + BK - 1) / BK, hkv, batch);
  if (dtype == 1 && d == 64)
    return launch(flash_bwd_dkv_bf16<64>, dkv_mma_smem_bytes<64>(), grid,
                  MMA_THREADS, p, st);
  if (dtype == 1 && d == 128)
    return launch(flash_bwd_dkv_bf16<128>, dkv_mma_smem_bytes<128>(), grid,
                  MMA_THREADS, p, st);
  if (dtype == 0 && d == 64)
    return launch(flash_bwd_dkv_f32<64>, dkv_f32_smem_bytes<64>(), grid,
                  F32_THREADS, p, st);
  if (dtype == 0 && d == 128)
    return launch(flash_bwd_dkv_f32<128>, dkv_f32_smem_bytes<128>(), grid,
                  F32_THREADS, p, st);
  return (int)cudaErrorInvalidValue;
}
