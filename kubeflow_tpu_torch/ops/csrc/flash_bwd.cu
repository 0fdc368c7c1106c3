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
// The scores are recomputed as flash_fwd.cu formed them, but not bit for
// bit: K1 sums Q K^T on wgmma, K2 on mma.sync and K3 as K Q^T on wgmma,
// each in its own order of float32 partial sums, so s may differ from K1's
// by float32 rounding and P = exp(s - lse) may exceed 1 by ~1e-6 relative
// (harmless at the stated tolerances).  In float32, Q pre-scaled and one
// fmaf per d in order, as K1's float32 kernel: exact there.
//
// What bounds them on the H100.  At BERT-large's training shape (B 24,
// S 512, H 16, D 64, non-causal, bf16) dq does 3 products (38.7 GFLOP over
// 127 MB) and dkv 4 (51.5 GFLOP over 151 MB): 0.039 and 0.052 ms at the
// bf16 tensor-core rate against 0.038 and 0.045 ms at 3.35 TB/s, so both
// are operations-bound, barely.  The design keeps S, P, dP and dS in
// registers (never in device memory), reads each K/V tile once per
// 64-query tile (dq) and each Q/dO tile once per 128-key tile (dkv; 64 at
// D = 128), and
// puts every bf16 product on the tensor cores.  No atomics: each block owns
// its output rows, which costs the second recompute of P (the price of two
// kernels instead of one with atomic dQ; fusing them is later work).
//
// Two kernels per input dtype:
// - bf16, dq (K2): mma.sync m16n8k16 (float32 accumulate), 4 warps of 16
//   query rows; Q and dO A fragments in registers; K/V tiles
//   double-buffered with cp.async; per 16-key slice S and dP come from
//   ldmatrix B fragments of K and V, dS is re-packed in registers as the A
//   fragment of dS K, whose B fragments come from K by ldmatrix.trans.
// - bf16, dkv (K3): a warp-specialised kernel on wgmma fed by TMA
//   (flash_bwd_dkv_bf16_wgmma below; flash_hopper.cuh).  Under GQA the
//   block loops over the G query heads of its kv head, so dK/dV sum over
//   the group in registers.
//   P and dS are rounded to bf16 for their products, as every tensor-core
//   flash backward does.
// - float32: the same loops on the CUDA cores in float32 (no TF32).
//
// Causal: dq visits key tiles up to its last query's position, dkv starts
// at the first query tile that sees its key tile (:213-217).  Ragged Sq/Sk
// tails are masked in-kernel, tail rows are never written.  Inputs are
// [B, S, H, D] views with a unit innermost stride; K3's TMA also needs a
// 16-byte aligned base and batch / sequence / head strides that are
// multiples of 8 elements (the wrapper checks, ops/flash_attention.py
// _tma_compatible), K2 and the float32 kernels take any strides.  Outputs
// are the caller's contiguous [B, S, H, D] tensors.

#include "flash_common.cuh"
#include "flash_hopper.cuh"

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
// bf16, dK/dV: a warp-specialised kernel on wgmma fed by TMA (see
// flash_hopper.cuh for the tile layout and the products).
//
// One block of 3 warpgroups per (128-key tile, kv head, batch).  Warpgroup
// 0 is the producer (setmaxnreg.dec): one thread loads the K and V tiles
// once, then streams tiles of 64 query rows of Q and dO, with their lse
// and delta rows (flash_hopper.cuh, "Rows"), through a 2-stage ring with
// `full` / `empty` mbarriers, in the order of the loop below.  Warpgroups 1
// and 2 (setmaxnreg.inc) each own 64 keys, whose K and V rows stay in
// shared memory; per query tile:
//     S^T  = K Q^T     wgmma m64n64k16, A = K, B = Q (both K-major)
//     dP^T = V dO^T    A = V, B = dO
//     P^T  = exp(S^T scale - lse[col]),  dS^T = P^T o (dP^T - delta[col]) scale
//     dK  += dS^T Q    A = dS^T (bf16, registers), B = Q MN-major
//     dV  += P^T dO    A = P^T (bf16, registers), B = dO MN-major
// then one lane per warp releases the stage.  dS^T is formed and its
// product issued before P^T is packed, so S^T and dP^T die early: the
// peak is the 64 accumulator registers of dK and dV plus the 64 of S^T
// and dP^T (at D = 64; D = 128 splits, below).  The loop visits, for each of the G query heads of
// the kv head, each query tile from the first that sees the key tile
// (causal), so dK and dV sum over the group in registers, with no atomics;
// a consumer skips the products of tiles that see none of its own keys.
// Tail query columns past Sq are masked to a weight of 0 (their Q and dO
// rows are zero); tail key rows are never written.  The epilogue writes dK
// and dV in bf16 through the consumer's rows of the K and V tiles.
//
// A masked weight is exp(-1e30 - lse) in natural units, as the reference
// forms it: 0, or 1 on a row that sees no key at all (its lse is -1e30).
// It is computed as exp2((-1e30 - lse) log2 e): the difference first, so
// no fused multiply-add can turn the two equal -1e30 log2 e terms into a
// rounding residue of 1e22, whose exp2 is 0 or infinity.
template <int D>
struct DkvTiles {
  // At D = 128 the two consumers split D instead of the keys: each owns
  // all 64 keys of the block and half of dK's and dV's columns, and both
  // form the same S^T and dP^T.  One consumer holding 128 accumulator
  // registers of dK and dV next to the 64 of S^T and dP^T spills
  // (ptxas), so D = 128 pays 1.5x the products for no spill.
  static constexpr bool SPLIT = D == 128;
  static constexpr int BKEY = SPLIT ? 64 : 128, BQR = 64, STAGES = 2;
  static constexpr int DO = SPLIT ? D / 2 : D;      // dK / dV columns owned
  static constexpr int KV_HALF = BKEY * BOX_BYTES;  // one 64-column box
  static constexpr int Q_HALF = BQR * BOX_BYTES;
  static constexpr int KV_BYTES = BKEY * D * 2, Q_BYTES = BQR * D * 2;
  // lse or delta rows: a box of BQR + 4 values from the 16-byte aligned
  // value at or before the tile's first row, in a slot of ROW_BYTES
  static constexpr int ROW_BOX = BQR + 4, ROW_BYTES = 384;
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;        // stage s: Q, then dO
  static constexpr int OFF_ROWS = OFF_Q + STAGES * 2 * Q_BYTES;  // lse, delta
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * ROW_BYTES;
  // barriers: kv_full, full[STAGES], empty[STAGES]
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // +align
};

struct DkvArgs {
  CUtensorMap q, k, v, dout, lse, delta;  // 64-byte aligned members first
  BwdParams p;
};

template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_bwd_dkv_bf16_wgmma(const __grid_constant__ DkvArgs a) {
  using T = DkvTiles<D>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t sk = base, sv = base + T::OFF_V;
  auto sq_tile = [&](int s) { return base + T::OFF_Q + s * 2 * T::Q_BYTES; };
  auto sdo_tile = [&](int s) { return sq_tile(s) + T::Q_BYTES; };
  auto slse = [&](int s) { return base + T::OFF_ROWS + s * 2 * T::ROW_BYTES; };
  const uint32_t kv_full = base + T::OFF_BAR;
  auto full = [&](int s) { return kv_full + 8 + 8 * s; };
  auto empty = [&](int s) { return kv_full + 8 + 8 * (STAGES + s); };

  const BwdParams& p = a.p;
  const int k0 = blockIdx.x * T::BKEY;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int offset = p.sk - p.sq;
  // query tiles that see this key tile: from the first whose last query
  // reaches key k0 (causal), for each of the group's query heads
  const int n_qt = (p.sq + T::BQR - 1) / T::BQR;
  const int first = p.causal ? max(k0 - offset, 0) / T::BQR : 0;
  const int per_head = max(n_qt - first, 0);
  const int n_iter = per_head * p.group;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one lane of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
      for (int h = 0; h < D / 64; ++h) {
        tma_load_4d(sk + h * T::KV_HALF, &a.k, kv_full, 64 * h, hk, k0, b);
        tma_load_4d(sv + h * T::KV_HALF, &a.v, kv_full, 64 * h, hk, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        const int hq = hk * p.group + it / per_head;
        const int q0 = (first + it % per_head) * T::BQR;
        const int row = (b * p.h + hq) * p.sq + q0;  // of lse and delta
        mbar_expect_tx(full(s), 2 * T::Q_BYTES + 2 * T::ROW_BOX * 4);
        for (int h = 0; h < D / 64; ++h) {
          tma_load_4d(sq_tile(s) + h * T::Q_HALF, &a.q, full(s), 64 * h, hq,
                      q0, b);
          tma_load_4d(sdo_tile(s) + h * T::Q_HALF, &a.dout, full(s), 64 * h,
                      hq, q0, b);
        }
        tma_load_1d(slse(s), &a.lse, full(s), row & ~3);
        tma_load_1d(slse(s) + T::ROW_BYTES, &a.delta, full(s), row & ~3);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int kc0 = k0 + (T::SPLIT ? 0 : 64 * c);  // first key owned
    const int my_first = p.causal ? max(kc0 - offset, 0) / T::BQR : 0;
    const float scale2 = p.scale * LOG2E;
    const uint32_t kv_row = T::SPLIT ? 0 : c * 64 * BOX_BYTES;
    const uint32_t k_rows = sk + kv_row, v_rows = sv + kv_row;  // A of S^T
    const uint32_t b_col = T::SPLIT ? c * T::Q_HALF : 0;  // B of dK, dV
    const int kpos[2] = {kc0 + 16 * warp + g, kc0 + 16 * warp + g + 8};

    float dk[T::DO / 2], dv[T::DO / 2];
#pragma unroll
    for (int i = 0; i < T::DO / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      const int hq = hk * p.group + it / per_head;
      const int qt = first + it % per_head, q0 = qt * T::BQR;
      if (qt >= my_first && kc0 < p.sk) {
        float st[32], dpt[32];
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns of a box row
          const uint32_t kq = (kk / 4) * T::KV_HALF + off;
          const uint32_t qq = (kk / 4) * T::Q_HALF + off;
          wgmma_ss_n64(st, desc_sw128(k_rows + kq, 16, 1024),
                       desc_sw128(sq_tile(s) + qq, 16, 1024), kk > 0);
          wgmma_ss_n64(dpt, desc_sw128(v_rows + kq, 16, 1024),
                       desc_sw128(sdo_tile(s) + qq, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // element 4j + 2r + e: key row kpos[r], query column 8j + 2t4 + e.
        // P^T in st, dS^T / scale in dpt (the epilogue scales dK).  Only a
        // tile that reaches past Sq or below the diagonal tests the mask.
        const uint32_t rows =  // lse, then delta (flash_hopper.cuh, "Rows")
            slse(s) + 4 * (((b * p.h + hq) * p.sq + q0) & 3);
        auto weights = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * t4 + e, qi = q0 + col;
              const float lse = lds_f32(rows + 4 * col);
              const float dl = lds_f32(rows + T::ROW_BYTES + 4 * col);
              const float l2 = lse * LOG2E;
              float pm = 0.f;  // the weight of a masked entry
              if constexpr (decltype(masked)::value)
                if (qi < p.sq) pm = ex2((NEG_INF - lse) * LOG2E);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 4 * j + 2 * r + e;
                float pv = ex2(st[i] * scale2 - l2);
                if constexpr (decltype(masked)::value)
                  if (qi >= p.sq || (p.causal && kpos[r] > qi + offset))
                    pv = pm;
                st[i] = pv;
                dpt[i] = pv * (dpt[i] - dl);
              }
            }
        };
        if (q0 + T::BQR > p.sq || (p.causal && kc0 + 63 > q0 + offset))
          weights(std::true_type{});
        else
          weights(std::false_type{});

        uint32_t dsa[4][4];  // dS^T as the A fragments of dS^T Q
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dsa[kk][i] = pack2_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // queries 16kk .. 16kk + 15
          const uint64_t dq = desc_sw128(
              sq_tile(s) + b_col + kk * 16 * BOX_BYTES, T::Q_HALF, 1024);
          if constexpr (T::DO == 128) wgmma_rs_n128(dk, dsa[kk], dq, 1);
          else wgmma_rs_n64(dk, dsa[kk], dq, 1);
        }
        wgmma_commit();
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pa[kk][i] = pack2_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t ddo = desc_sw128(
              sdo_tile(s) + b_col + kk * 16 * BOX_BYTES, T::Q_HALF, 1024);
          if constexpr (T::DO == 128) wgmma_rs_n128(dv, pa[kk], ddo, 1);
          else wgmma_rs_n64(dv, pa[kk], ddo, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // the stage may be refilled
    }

    // epilogue: dK (times the scale) and dV in bf16 through the consumer's
    // part of the K and V tiles: its rows, or under SPLIT its box, once
    // both consumers have done reading K and V
    if constexpr (T::SPLIT) named_sync<2 * WG>(3);
    const float scale[2] = {p.scale, p.scale}, one[2] = {1.f, 1.f};
    const int64_t out_ss = (int64_t)p.hkv * D;
    const int64_t out0 = (((int64_t)b * p.sk + kc0) * p.hkv + hk) * D +
                         (T::SPLIT ? 64 * c : 0);
    const uint32_t k_out = T::SPLIT ? sk + c * T::KV_HALF : k_rows;
    const uint32_t v_out = T::SPLIT ? sv + c * T::KV_HALF : v_rows;
    const int valid = min(64, p.sk - kc0);
    store_tile_bf16<T::DO>(dk, scale, k_out, T::KV_HALF,
                           static_cast<bf16*>(p.dk) + out0, out_ss, valid,
                           1 + c);
    store_tile_bf16<T::DO>(dv, one, v_out, T::KV_HALF,
                           static_cast<bf16*>(p.dv) + out0, out_ss, valid,
                           1 + c);
  }
}

template <int D>
cudaError_t launch_dkv_wgmma(const BwdParams& p, int batch, int d,
                             cudaStream_t stream) {
  using T = DkvTiles<D>;
  DkvArgs a;
  a.p = p;
  cudaError_t err = map_bshd(&a.q, p.q, batch, p.sq, p.h, d, p.q_sb, p.q_ss,
                             p.q_sh, T::BQR);
  if (err == cudaSuccess)
    err = map_bshd(&a.dout, p.dout, batch, p.sq, p.h, d, p.do_sb, p.do_ss,
                   p.do_sh, T::BQR);
  if (err == cudaSuccess)
    err = map_bshd(&a.k, p.k, batch, p.sk, p.hkv, d, p.k_sb, p.k_ss, p.k_sh,
                   T::BKEY);
  if (err == cudaSuccess)
    err = map_bshd(&a.v, p.v, batch, p.sk, p.hkv, d, p.v_sb, p.v_ss, p.v_sh,
                   T::BKEY);
  const int64_t rows = (int64_t)batch * p.h * p.sq;
  if (err == cudaSuccess) err = map_rows(&a.lse, p.lse, rows, T::ROW_BOX);
  if (err == cudaSuccess) err = map_rows(&a.delta, p.delta, rows, T::ROW_BOX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + T::BKEY - 1) / T::BKEY, p.hkv, batch);
  flash_bwd_dkv_bf16_wgmma<D><<<grid, 3 * WG, T::SMEM, stream>>>(a);
  return cudaGetLastError();
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
  if (dtype == 1 && d == 64) return launch_dkv_wgmma<64>(p, batch, d, st);
  if (dtype == 1 && d == 128) return launch_dkv_wgmma<128>(p, batch, d, st);
  if (dtype == 0 && d == 64)
    return launch(flash_bwd_dkv_f32<64>, dkv_f32_smem_bytes<64>(), grid,
                  F32_THREADS, p, st);
  if (dtype == 0 && d == 128)
    return launch(flash_bwd_dkv_f32<128>, dkv_f32_smem_bytes<128>(), grid,
                  F32_THREADS, p, st);
  return (int)cudaErrorInvalidValue;
}
