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
// bit: K1 and K2 sum Q K^T on wgmma, K1 over 128-key tiles at D = 64, K2
// over 64-key tiles, and K3 sums K Q^T, each in its own order of float32
// partial sums, so s may differ from K1's by float32 rounding and
// P = exp(s - lse) may exceed 1 by ~1e-6 relative (harmless at the stated
// tolerances).  In float32, Q pre-scaled and one fmaf per d in order, as
// K1's float32 kernel: exact there.
//
// What bounds them on the H100.  At BERT-large's training shape (B 24,
// S 512, H 16, D 64, non-causal, bf16) dq does 3 products (38.7 GFLOP over
// 127 MB) and dkv 4 (51.5 GFLOP over 151 MB): 0.039 and 0.052 ms at the
// bf16 tensor-core rate against 0.038 and 0.045 ms at 3.35 TB/s, so both
// are operations-bound, barely.  The design keeps S, P, dP and dS in
// registers (never in device memory), reads each K/V tile once per
// 128-query tile (dq) and each Q/dO tile once per 128-key tile (dkv; 64 at
// D = 128), and puts every bf16 product on the tensor cores through wgmma.
// No atomics: each block owns its output rows, so the gradients are the
// same bits on every run, which costs the second recompute of P (the price
// of two kernels instead of one with atomic dQ).
//
// Two kernels per input dtype:
// - bf16, dq (K2): a warp-specialised kernel on wgmma fed by TMA, in K1's
//   skeleton (flash_bwd_dq_bf16_wgmma below; flash_hopper.cuh): a producer
//   warpgroup streams K/V tiles through an mbarrier ring, two consumer
//   warpgroups of 64 query rows form S and dP, then dS in registers, and
//   add dS K into dQ while the next tile's S and dP are formed.
// - bf16, dkv (K3): the same structure with K and V resident and Q/dO
//   streamed (flash_bwd_dkv_bf16_wgmma below).  Under GQA the block loops
//   over the G query heads of its kv head, so dK/dV sum over the group in
//   registers.
//   P and dS are rounded to bf16 for their products, as every tensor-core
//   flash backward does.
// - float32: the same loops on the CUDA cores in float32 (no TF32).
//
// Causal: dq visits key tiles up to its last query's position, dkv starts
// at the first query tile that sees its key tile (:213-217).  Ragged Sq/Sk
// tails are masked in-kernel, tail rows are never written.  Inputs are
// [B, S, H, D] views with a unit innermost stride; the bf16 kernels' TMA
// also needs a 16-byte aligned base and batch / sequence / head strides
// that are multiples of 8 elements (the wrapper checks,
// ops/flash_attention.py _tma_compatible), the float32 kernels take any
// strides.  Outputs are the caller's contiguous [B, S, H, D] tensors.

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
// bf16, dQ: a warp-specialised kernel on wgmma fed by TMA, in K1's skeleton
// (flash_fwd.cu; flash_hopper.cuh for the tile layout and the products).
//
// One block of 3 warpgroups walks over work tiles (128-query tile, query
// head, batch).  Without the causal mask the grid is persistent, at most
// one block per SM, so that a block's next Q, dO and K/V tiles load while
// its consumers finish the current one (at BERT-large's shape, 12 waves of
// short work tiles).  Under the causal mask the work tiles differ in
// length, and a fixed stride over them does not balance (at 12 query
// tiles per head, block b of 132 would get query tile b % 12 every time),
// so there is one block per work tile, the longest first, and the
// hardware hands the next one to whichever SM frees up.
//
// Warpgroup 0 is the producer (setmaxnreg.dec): one thread loads a work
// tile's Q and dO once the consumers are done with the previous ones
// (`q_full` / `q_empty`), then its K and V tiles of BK keys
// of kv head hq / group into a ring of STAGES stages (`full` / `empty`),
// up to the last key tile that the tile's last query sees (causal).
// Warpgroups 1 and 2 (setmaxnreg.inc) each own 64 query rows, whose lse
// and delta each thread reads once per work tile.  Per key tile t:
//     S  = Q K^T      wgmma m64nBKk16, A = Q, B = K (both K-major)
//     dP = dO V^T     A = dO, B = V
//     P  = exp(S scale - lse),  dS / scale = P o (dP - delta)  (in dP)
//     dQ += dS K      A = dS (bf16, registers), B = K MN-major
// S(t) and dP(t) are issued ahead of dQ(t-1), and dS(t) is formed while
// that product is in flight; once it retires, one lane per warp releases
// tile t-1's stage.  The two consumers take turns at issuing (ping-pong,
// named barriers 4 and 5), so one's exponentials overlap the other's
// products.  A consumer skips the products of tiles past its own last
// visible key (it still waits for and releases them).  The epilogue
// writes dQ times the scale in bf16 through the consumer's rows of a dQ
// buffer; tail rows past Sq are never written, and no atomics are used:
// each work tile owns its rows, so dQ is the same bits on every run.
template <int D>
struct DqTiles {
  // keys per tile: a consumer holds dQ (D / 2 registers), S and dP (BK / 2
  // each) and dS packed (BK / 4), all live while dQ(t-1) is in flight:
  // 112 registers at D = 64 with 64-key tiles, 104 at D = 128 with 32-key
  // tiles, within ptxas's 168 (64-key tiles at D = 128 would need 144).
  static constexpr int BQ = 128, BK = D == 128 ? 32 : 64, STAGES = 4;
  static constexpr int Q_HALF = BQ * BOX_BYTES;   // one 64-column box
  static constexpr int KV_HALF = BK * BOX_BYTES;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_DQ = OFF_V + STAGES * KV_BYTES;  // laid out as Q
  static constexpr int OFF_BAR = OFF_DQ + Q_BYTES;
  // barriers: q_full, q_empty, full[STAGES], empty[STAGES]
  static constexpr int SMEM = OFF_BAR + 8 * (2 + 2 * STAGES) + 1024;  // +align
};

struct DqArgs {
  CUtensorMap q, k, v, dout;  // 64-byte aligned members first
  BwdParams p;
  int n_qt, n_work;           // query tiles per head; work tiles (B x H x n_qt)
};

template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_bwd_dq_bf16_wgmma(const __grid_constant__ DqArgs a) {
  using T = DqTiles<D>;
  constexpr int STAGES = T::STAGES, BK = T::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t sq_tile = base, sdo_tile = base + T::OFF_DO;
  const uint32_t sk = base + T::OFF_K, sv = base + T::OFF_V;
  const uint32_t sdq_tile = base + T::OFF_DQ;
  const uint32_t q_full = base + T::OFF_BAR, q_empty = q_full + 8;
  auto full = [&](int s) { return q_full + 16 + 8 * s; };
  auto empty = [&](int s) { return q_full + 16 + 8 * (STAGES + s); };

  const BwdParams& p = a.p;
  const int offset = p.sk - p.sq;  // query i sits at absolute i + offset
  // work tile w: query tile n_qt - 1 - w % n_qt (the longest first under
  // the causal mask) of head (w / n_qt) % H of batch w / (n_qt H); the
  // query tiles of one head run side by side and share K and V in L2
  struct Work {
    int q0, hq, b, n_tiles;
  };
  auto work = [&](int w) {
    Work x;
    x.q0 = (a.n_qt - 1 - w % a.n_qt) * T::BQ;
    x.hq = (w / a.n_qt) % p.h;
    x.b = w / (a.n_qt * p.h);
    x.n_tiles = (p.sk + BK - 1) / BK;
    if (p.causal) {  // only key tiles up to the tile's last query
      const int last_key = min(x.q0 + T::BQ, p.sq) - 1 + offset;
      x.n_tiles = min(x.n_tiles, last_key < 0 ? 0 : last_key / BK + 1);
    }
    return x;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one lane of each consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles loaded so far, over the block's work tiles
      for (int w = blockIdx.x, j = 0; w < a.n_work; w += gridDim.x, ++j) {
        const Work x = work(w);
        const int hk = x.hq / p.group;
        if (j > 0) mbar_wait(q_empty, (j - 1) & 1);
        mbar_expect_tx(q_full, 2 * T::Q_BYTES);
        for (int h = 0; h < D / 64; ++h) {
          tma_load_4d(sq_tile + h * T::Q_HALF, &a.q, q_full, 64 * h, x.hq,
                      x.q0, x.b);
          tma_load_4d(sdo_tile + h * T::Q_HALF, &a.dout, q_full, 64 * h,
                      x.hq, x.q0, x.b);
        }
        for (int t = 0; t < x.n_tiles; ++t, ++kv) {
          const int s = kv % STAGES;
          if (kv >= STAGES) mbar_wait(empty(s), ((kv / STAGES) - 1) & 1);
          mbar_expect_tx(full(s), 2 * T::KV_BYTES);
          for (int h = 0; h < D / 64; ++h) {
            tma_load_4d(sk + s * T::KV_BYTES + h * T::KV_HALF, &a.k, full(s),
                        64 * h, hk, t * BK, x.b);
            tma_load_4d(sv + s * T::KV_BYTES + h * T::KV_HALF, &a.v, full(s),
                        64 * h, hk, t * BK, x.b);
          }
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const float scale2 = p.scale * LOG2E;
    const uint32_t q_rows = sq_tile + c * 64 * BOX_BYTES;  // A of S
    const uint32_t do_rows = sdo_tile + c * 64 * BOX_BYTES;  // A of dP
    const uint32_t dq_rows = sdq_tile + c * 64 * BOX_BYTES;

    float dq[D / 2];
    float sc[BK / 2], dp[BK / 2];  // S(t); dP(t), then dS(t) / scale
    uint32_t dsa[BK / 16][4];      // dS as the A fragments of dS K
    int kv = 0;  // K/V tiles consumed so far, over the block's work tiles
    for (int w = blockIdx.x, j = 0; w < a.n_work; w += gridDim.x, ++j) {
      const Work x = work(w);
      const int row0 = x.q0 + 64 * c;  // this consumer's first query
      auto tiles_of = [&](int first_row) {  // key tiles a consumer computes
        int n = first_row < p.sq ? x.n_tiles : 0;
        if (p.causal) {
          const int last_key = min(first_row + 64, p.sq) - 1 + offset;
          n = min(n, last_key < 0 ? 0 : last_key / BK + 1);
        }
        return n;
      };
      const int my_tiles = tiles_of(row0);
      // ping-pong in loop iterations 1 .. turns, as K1 takes turns
      const int turns = min(my_tiles, tiles_of(x.q0 + 64 * (1 - c))) - 1;

      // this thread's rows 16 warp + g + 8r: lse in log2 units, delta, the
      // weight of a masked entry, and the absolute position.  A masked
      // weight is exp(-1e30 - lse) in natural units, as the reference forms
      // it (0, or 1 on a row that sees no key), computed as K3 computes it:
      // the difference first, so no fused multiply-add turns two equal
      // -1e30 log2 e terms into a residue whose exp2 is 0 or infinity.
      float l2[2], dl[2], pm[2];
      int qpos[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 16 * warp + g + 8 * r;
        const int64_t at = ((int64_t)x.b * p.h + x.hq) * p.sq + qi;
        const float lse = qi < p.sq ? p.lse[at] : 0.f;
        dl[r] = qi < p.sq ? p.delta[at] : 0.f;
        l2[r] = lse * LOG2E;
        pm[r] = ex2((NEG_INF - lse) * LOG2E);
        qpos[r] = qi + offset;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

      // The first tile is peeled, so no product sits in a branch of the
      // loop (ptxas serialises the products of a divergent path).  Stage of
      // tile t: (kv + t) % STAGES.
      auto stage = [&](int t) { return (kv + t) % STAGES; };
      auto parity = [&](int t) { return ((kv + t) / STAGES) & 1; };
      auto issue_s_dp = [&](int t) {  // S and dP over D / 16 k-steps
        const uint32_t kt = sk + stage(t) * T::KV_BYTES;
        const uint32_t vt = sv + stage(t) * T::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns of a box row
          const uint32_t qo = (kk / 4) * T::Q_HALF + off;
          const uint32_t ko = (kk / 4) * T::KV_HALF + off;
          const uint64_t dqa = desc_sw128(q_rows + qo, 16, 1024);
          const uint64_t dka = desc_sw128(kt + ko, 16, 1024);
          const uint64_t doa = desc_sw128(do_rows + qo, 16, 1024);
          const uint64_t dva = desc_sw128(vt + ko, 16, 1024);
          if constexpr (BK == 64) {
            wgmma_ss_n64(sc, dqa, dka, kk > 0);
            wgmma_ss_n64(dp, doa, dva, kk > 0);
          } else {
            wgmma_ss_n32(sc, dqa, dka, kk > 0);
            wgmma_ss_n32(dp, doa, dva, kk > 0);
          }
        }
        wgmma_commit();
      };
      auto issue_dq = [&](int t) {  // dQ += dS K, K MN-major (K1's V)
        const uint32_t kt = sk + stage(t) * T::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db =
              desc_sw128(kt + kk * 16 * BOX_BYTES, T::KV_HALF, 1024);
          if constexpr (D == 128) wgmma_rs_n128(dq, dsa[kk], db, 1);
          else wgmma_rs_n64(dq, dsa[kk], db, 1);
        }
        wgmma_commit();
      };
      // dS(t) / scale in dp, then packed as dsa.  Element 4jj + 2r + e:
      // row 16 warp + g + 8r, key t BK + 8jj + 2t4 + e.  Only a tile that
      // reaches past Sk or past this consumer's first query tests the mask.
      auto weights = [&](int t, auto masked) {
        const int k0 = t * BK;
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * jj + 2 * r + e;
              float pv = ex2(sc[i] * scale2 - l2[r]);
              if constexpr (decltype(masked)::value) {
                const int kj = k0 + 8 * jj + 2 * t4 + e;
                if (kj >= p.sk || (p.causal && kj > qpos[r])) pv = pm[r];
              }
              dp[i] = pv * (dp[i] - dl[r]);
            }
      };
      auto form_ds = [&](int t) {
        const int k0 = t * BK;
        if (k0 + BK > p.sk || (p.causal && k0 + BK - 1 > row0 + offset))
          weights(t, std::true_type{});
        else
          weights(t, std::false_type{});
      };
      auto pack_ds = [&]() {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dsa[kk][i] = pack2_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      };
      auto arrive = [&](uint32_t bar) {  // one lane per consumer warp
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };

      mbar_wait(q_full, j & 1);
      if (c == 1 && turns > 0) named_arrive<2 * WG>(4);  // consumer 0's turn 1
      if (my_tiles > 0) {
        mbar_wait(full(stage(0)), parity(0));
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        issue_s_dp(0);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        form_ds(0);
        pack_ds();
        for (int t = 1; t < my_tiles; ++t) {
          mbar_wait(full(stage(t)), parity(t));
          if (t <= turns) named_sync<2 * WG>(4 + c);  // this consumer's turn
          fence_regs(sc);
          fence_regs(dp);
          fence_regs(dq);
          wgmma_fence();
          issue_s_dp(t);
          issue_dq(t - 1);
          if (t + c <= turns) named_arrive<2 * WG>(5 - c);  // the other's turn
          wgmma_wait<1>();  // S(t) and dP(t) are done; dQ(t - 1) may run on
          fence_regs(sc);
          fence_regs(dp);
          form_ds(t);
          wgmma_wait<0>();  // dQ(t - 1) has retired: dsa and its K are free
          fence_regs(dq);
          arrive(empty(stage(t - 1)));
          pack_ds();
        }
      }
      arrive(q_empty);  // no more S or dP products: the next Q and dO may load
      if (my_tiles > 0) {
        const int last = my_tiles - 1;  // its dS K
        fence_regs(dq);
        wgmma_fence();
        issue_dq(last);
        wgmma_wait<0>();
        fence_regs(dq);
        arrive(empty(stage(last)));
      }
      for (int t = my_tiles; t < x.n_tiles; ++t) {  // past its last key
        mbar_wait(full(stage(t)), parity(t));
        arrive(empty(stage(t)));
      }
      kv += x.n_tiles;

      // epilogue: dQ times the scale through this consumer's rows of the
      // dQ buffer; dq is a contiguous [B, Sq, H, D] tensor
      const float mul[2] = {p.scale, p.scale};
      const int64_t ld = (int64_t)p.h * D;
      bf16* dqg = static_cast<bf16*>(p.dq) +
                  ((int64_t)x.b * p.sq + row0) * ld + (int64_t)x.hq * D;
      store_tile_bf16<D>(dq, mul, dq_rows, T::Q_HALF, dqg, ld,
                         min(64, p.sq - row0), 1 + c);
    }
  }
}

template <int D>
cudaError_t launch_dq_wgmma(const BwdParams& p, int batch, int d,
                            cudaStream_t stream) {
  using T = DqTiles<D>;
  DqArgs a;
  a.p = p;
  cudaError_t err = map_bshd(&a.q, p.q, batch, p.sq, p.h, d, p.q_sb, p.q_ss,
                             p.q_sh, T::BQ);
  if (err == cudaSuccess)
    err = map_bshd(&a.dout, p.dout, batch, p.sq, p.h, d, p.do_sb, p.do_ss,
                   p.do_sh, T::BQ);
  if (err == cudaSuccess)
    err = map_bshd(&a.k, p.k, batch, p.sk, p.hkv, d, p.k_sb, p.k_ss, p.k_sh,
                   T::BK);
  if (err == cudaSuccess)
    err = map_bshd(&a.v, p.v, batch, p.sk, p.hkv, d, p.v_sb, p.v_ss, p.v_sh,
                   T::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  a.n_qt = (p.sq + T::BQ - 1) / T::BQ;
  a.n_work = a.n_qt * p.h * batch;
  // persistent without the causal mask (one block fits on an SM); one
  // block per work tile with it (see the kernel's note)
  const int grid = p.causal ? a.n_work : min(a.n_work, sms);
  flash_bwd_dq_bf16_wgmma<D><<<grid, 3 * WG, T::SMEM, stream>>>(a);
  return cudaGetLastError();
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
  if (dtype == 1 && d == 64) return launch_dq_wgmma<64>(p, batch, d, st);
  if (dtype == 1 && d == 128) return launch_dq_wgmma<128>(p, batch, d, st);
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
