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
// operations-bound at 512x1536; at D = 256 with 8 query heads over one KV
// head, 5.4 GFLOP against 5.8 MB at 512x1536: operations-bound).  So the
// design keeps every intermediate out of device memory (S and P live in
// registers, K/V are read once per 128-query tile, O and lse are written
// once) and puts the bf16 products on the tensor cores.
//
// Two kernels, one per input dtype:
// - bf16 (the serving and training paths): flash_fwd_bf16_wgmma, a
//   warp-specialised kernel with QK^T and PV on wgmma (float32 accumulate)
//   and every tile loaded by TMA into a ring of mbarrier-guarded stages
//   (below; flash_hopper.cuh).  P stays in registers, rounded to bf16 for
//   PV (l sums the float32 values).  128-query work tiles, tiles of 128
//   keys at D = 64 and 64 at D = 128 and 256.
// - float32: flash_fwd_f32, both products on the CUDA cores in float32, so
//   the result is exact to float32 rounding (no TF32).  One block per
//   (64-query tile, head, batch) and a loop over 64-key tiles.
//
// Inputs are [B, S, H, D] views (innermost stride 1): no transpose copies.
// The bf16 kernel's TMA needs a 16-byte aligned base and batch / sequence /
// head strides that are multiples of 8 elements; the wrapper checks that
// and raises (ops/flash_attention.py _tma_compatible); the float32 kernel
// takes any strides.  GQA reads kv head h / (H / Hkv) instead of
// repeating.  Ragged Sq / Sk are masked in-kernel; tail query rows are
// never written.  Shared memory above 48 KB (f32: 115 KB at D=128, 209 KB
// at D=256; bf16: 129 KB at D=64, 161 KB at D=128, 193 KB at D=256) is
// requested with cudaFuncSetAttribute before each launch (the setting is
// per device).

#include "flash_common.cuh"
#include "flash_hopper.cuh"

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
// bf16 inputs: a warp-specialised kernel on wgmma fed by TMA (see
// flash_hopper.cuh for the tile layout and the products).
//
// Without the causal mask, a persistent grid: at most one block of 3
// warpgroups per SM, each walking over work tiles (128-query tile, head,
// batch), so that a block's next Q and K/V tiles load while its consumers
// finish the current one (at BERT-large's shape, 12 waves of short blocks,
// a block's first load and its epilogue are a large share of its time).
// Under the causal mask, one block per work tile, the longest first (see
// `launch_wgmma`).  Warpgroup 0 is the producer: it
// gives up registers (setmaxnreg.dec) and one of its threads issues every
// TMA load: a work tile's Q once the consumers are done with the previous
// one (`q_full` / `q_empty`), then its K and V tiles of BK keys into a ring
// of STAGES stages, each stage with a `k_full`, a `v_full` and an `empty`
// mbarrier.  Warpgroups 1 and 2 are consumers (setmaxnreg.inc), each
// owning 64 query rows.  Per key tile t a consumer issues S(t) = Q K^T
// (wgmma m64nBKk16, both operands from shared memory) and then O += P(t-1)
// V (wgmma with A = P rounded to bf16 from registers, B = V MN-major),
// waits for S(t) only, and runs the scale, mask and online softmax of S(t)
// (float32 m and l, exp2 with log2(e) folded into the scale) while that PV
// product is in flight; once it retires, one lane per warp arrives on the
// stage's `empty` barrier and O is rescaled to the new running max.  A
// consumer skips the products of tiles past its own last visible key (it
// still waits and releases them).  The two consumers take turns at
// issuing their products (ping-pong), so one's softmax overlaps the
// other's products.  The epilogue writes O / l in bf16 through the
// consumer's rows of an O buffer (at D = 256, of Q's buffer) with 16-byte
// stores, and lse = m ln 2 + ln l (-1e30 + ln l on a row that saw no key).
template <int D>
struct FwdTiles {
  // Registers.  A consumer holds O (D / 2 accumulator values a thread), S
  // (BK / 2) and P (BK / 4) at once.  Under __launch_bounds__(384, 1)
  // ptxas reports 168 registers, the count at entry, but allocates up to
  // CONSUMER_REGS (232) in the code after setmaxnreg.inc (flash_hopper.cuh):
  // at D = 256, BK = 64 (176 accumulator values) builds with no spill and
  // BK = 128 (224) would not fit.  So 64-key tiles at D = 128 (112 values)
  // and 256 (176); 128 at D = 64 (112).
  // Stages: a stage is released only when the PV product of the next
  // tile's iteration retires, so two starve the producer a little; at
  // D = 256 three do not fit beside Q (and O goes out through Q's buffer).
  static constexpr int BQ = 128, BK = D == 64 ? 128 : 64;
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr bool O_IN_Q = D == 256;  // Q's rows take O once read
  static constexpr int Q_HALF = BQ * BOX_BYTES;   // one 64-column box
  static constexpr int KV_HALF = BK * BOX_BYTES;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_O =  // O, laid out as Q
      O_IN_Q ? 0 : OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR =
      OFF_V + STAGES * KV_BYTES + (O_IN_Q ? 0 : Q_BYTES);
  // barriers: q_full, q_empty, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int SMEM = OFF_BAR + 8 * (2 + 3 * STAGES) + 1024;  // +align
};

struct FwdArgs {
  CUtensorMap q, k, v;  // 64-byte aligned members first
  Params p;
  int n_qt, n_work;     // query tiles per head; work tiles (B x H x n_qt)
};

template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_fwd_bf16_wgmma(const __grid_constant__ FwdArgs a) {
  using T = FwdTiles<D>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t sq_tile = base, sk = base + T::OFF_K, sv = base + T::OFF_V;
  const uint32_t so_tile = base + T::OFF_O;
  const uint32_t q_full = base + T::OFF_BAR, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 16 + 8 * s; };
  auto v_full = [&](int s) { return q_full + 16 + 8 * (STAGES + s); };
  auto empty = [&](int s) { return q_full + 16 + 8 * (2 * STAGES + s); };

  const Params& p = a.p;
  const int offset = p.sk - p.sq;  // query i sits at absolute i + offset
  // Work tile w is query tile w % n_qt of head (w / n_qt) % H of batch
  // w / (n_qt H), counted from the last under the causal mask (the longest
  // first); the block takes w = blockIdx.x, + gridDim.x, ... so the query
  // tiles of one head run side by side and share K and V in L2.
  struct Work {
    int q0, hq, b, n_tiles;
  };
  auto work = [&](int w) {
    Work x;
    const int qt = w % a.n_qt;
    x.q0 = (p.causal ? a.n_qt - 1 - qt : qt) * T::BQ;
    x.hq = (w / a.n_qt) % p.h;
    x.b = w / (a.n_qt * p.h);
    x.n_tiles = (p.sk + T::BK - 1) / T::BK;
    if (p.causal) {  // only key tiles up to the tile's last query
      const int last_key = min(x.q0 + T::BQ, p.sq) - 1 + offset;
      x.n_tiles = min(x.n_tiles, last_key < 0 ? 0 : last_key / T::BK + 1);
    }
    return x;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one lane of each consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
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
        mbar_expect_tx(q_full, T::Q_BYTES);
        for (int h = 0; h < D / 64; ++h)
          tma_load_4d(sq_tile + h * T::Q_HALF, &a.q, q_full, 64 * h, x.hq,
                      x.q0, x.b);
        for (int t = 0; t < x.n_tiles; ++t, ++kv) {
          const int s = kv % STAGES;
          if (kv >= STAGES) mbar_wait(empty(s), ((kv / STAGES) - 1) & 1);
          mbar_expect_tx(k_full(s), T::KV_BYTES);
          for (int h = 0; h < D / 64; ++h)
            tma_load_4d(sk + s * T::KV_BYTES + h * T::KV_HALF, &a.k,
                        k_full(s), 64 * h, hk, t * T::BK, x.b);
          mbar_expect_tx(v_full(s), T::KV_BYTES);
          for (int h = 0; h < D / 64; ++h)
            tma_load_4d(sv + s * T::KV_BYTES + h * T::KV_HALF, &a.v,
                        v_full(s), 64 * h, hk, t * T::BK, x.b);
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const float scale2 = p.scale * LOG2E;
    const uint32_t q_rows = sq_tile + c * 64 * BOX_BYTES;  // A of Q K^T
    const uint32_t o_rows =
        T::O_IN_Q ? q_rows : so_tile + c * 64 * BOX_BYTES;

    float m[2], l[2], o[D / 2], alpha[2];
    float sc[T::BK / 2];         // S(t), then P(t) in float32
    uint32_t pa[T::BK / 16][4];  // P(t - 1) as the A fragments of P V
    int kv = 0;  // K/V tiles consumed so far, over the block's work tiles
    for (int w = blockIdx.x, j = 0; w < a.n_work; w += gridDim.x, ++j) {
      const Work x = work(w);
      const int row0 = x.q0 + 64 * c;  // this consumer's first query
      auto tiles_of = [&](int first_row) {  // key tiles a consumer computes
        int n = first_row < p.sq ? x.n_tiles : 0;
        if (p.causal) {
          const int last_key = min(first_row + 64, p.sq) - 1 + offset;
          n = min(n, last_key < 0 ? 0 : last_key / T::BK + 1);
        }
        return n;
      };
      const int my_tiles = tiles_of(row0);
      // Ping-pong: in loop iterations 1 .. turns both consumers have, they
      // take turns at issuing their products (consumer 0 first, named
      // barriers 4 and 5 over both), so one's softmax runs while the
      // other's products keep the tensor cores busy.  Every arrival is
      // matched within the work tile.
      const int turns = min(my_tiles, tiles_of(x.q0 + 64 * (1 - c))) - 1;
      const int qpos[2] = {row0 + 16 * warp + g + offset,
                           row0 + 16 * warp + g + 8 + offset};

      // m in log2 units: m ln 2 is the natural running max
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = NEG_INF * LOG2E;
        l[r] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

      // Tile t: S(t) = Q K_t^T is issued, then O += P(t-1) V_(t-1); the
      // softmax of S(t) runs while that PV product is in flight, and O is
      // rescaled to tile t's running max once it has retired.  The first
      // tile is peeled, so no product sits in a branch of the loop (ptxas
      // serialises the products of a divergent path).  Stage of tile t:
      // (kv + t) % STAGES.
      auto stage = [&](int t) { return (kv + t) % STAGES; };
      auto parity = [&](int t) { return ((kv + t) / STAGES) & 1; };
      auto issue_s = [&](int t) {  // S = Q K^T over D / 16 k-steps
        const uint32_t kt = sk + stage(t) * T::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns of a box row
          const uint64_t da =
              desc_sw128(q_rows + (kk / 4) * T::Q_HALF + off, 16, 1024);
          const uint64_t db =
              desc_sw128(kt + (kk / 4) * T::KV_HALF + off, 16, 1024);
          if constexpr (T::BK == 128) wgmma_ss_n128(sc, da, db, kk > 0);
          else wgmma_ss_n64(sc, da, db, kk > 0);
        }
        wgmma_commit();
      };
      auto issue_pv = [&](int t) {
        const uint32_t vt = sv + stage(t) * T::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < T::BK / 16; ++kk) {
          const uint64_t db =
              desc_sw128(vt + kk * 16 * BOX_BYTES, T::KV_HALF, 1024);
          if constexpr (D == 256) {  // two n128 halves, two boxes apart
            wgmma_rs_n128(part<0, 64>(o), pa[kk], db, 1);
            wgmma_rs_n128(part<1, 64>(o), pa[kk],
                          desc_sw128(vt + 2 * T::KV_HALF + kk * 16 * BOX_BYTES,
                                     T::KV_HALF, 1024),
                          1);
          } else if constexpr (D == 128) {
            wgmma_rs_n128(o, pa[kk], db, 1);
          } else {
            wgmma_rs_n64(o, pa[kk], db, 1);
          }
        }
        wgmma_commit();
      };
      // scale, mask, online softmax of S(t) (log2 domain): sc becomes
      // P(t), m and l move to tile t, alpha rescales what O holds.  Only a
      // tile that reaches past Sk or past this consumer's first query is
      // masked.
      auto softmax = [&](int t) {
#pragma unroll
        for (int i = 0; i < T::BK / 2; ++i) sc[i] *= scale2;
        const int k0 = t * T::BK;
        if (k0 + T::BK > p.sk ||
            (p.causal && k0 + T::BK - 1 > row0 + offset)) {
#pragma unroll
          for (int jj = 0; jj < T::BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kj = k0 + 8 * jj + 2 * t4 + e;
#pragma unroll
              for (int r = 0; r < 2; ++r)
                if (kj >= p.sk || (p.causal && kj > qpos[r]))
                  sc[4 * jj + 2 * r + e] = NEG_INF * LOG2E;  // -1e30, log2
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx[4] = {m[r], m[r], m[r], m[r]};  // four chains, then one
#pragma unroll
          for (int jj = 0; jj < T::BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              mx[jj % 4] = fmaxf(mx[jj % 4], sc[4 * jj + 2 * r + e]);
          float m_new = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
          m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
          m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
          alpha[r] = ex2(m[r] - m_new);
          float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int jj = 0; jj < T::BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pv = ex2(sc[4 * jj + 2 * r + e] - m_new);
              sc[4 * jj + 2 * r + e] = pv;
              rs[jj % 4] += pv;
            }
          float sum = (rs[0] + rs[1]) + (rs[2] + rs[3]);
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l[r] = l[r] * alpha[r] + sum;
          m[r] = m_new;
        }
      };
      auto rescale_and_pack = [&]() {
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            o[4 * jj + 2 * r] *= alpha[r];
            o[4 * jj + 2 * r + 1] *= alpha[r];
          }
#pragma unroll
        for (int kk = 0; kk < T::BK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pa[kk][i] = pack2_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      };
      auto arrive = [&](uint32_t bar) {  // one lane per consumer warp
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };

      mbar_wait(q_full, j & 1);
      if (c == 1 && turns > 0) named_arrive<2 * WG>(4);  // consumer 0's turn 1
      if (my_tiles > 0) {
        mbar_wait(k_full(stage(0)), parity(0));
        fence_regs(sc);
        wgmma_fence();
        issue_s(0);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(0);
        rescale_and_pack();
        for (int t = 1; t < my_tiles; ++t) {
          mbar_wait(k_full(stage(t)), parity(t));
          mbar_wait(v_full(stage(t - 1)), parity(t - 1));
          if (t <= turns) named_sync<2 * WG>(4 + c);  // this consumer's turn
          fence_regs(sc);
          fence_regs(o);
          wgmma_fence();
          issue_s(t);
          issue_pv(t - 1);
          if (t + c <= turns) named_arrive<2 * WG>(5 - c);  // the other's turn
          wgmma_wait<1>();  // S(t) is done; PV(t - 1) may run on
          fence_regs(sc);
          softmax(t);
          wgmma_wait<0>();  // PV(t - 1) has retired: O, pa and its V are free
          fence_regs(o);
          arrive(empty(stage(t - 1)));
          rescale_and_pack();
        }
      }
      // no more S products: the next Q may load (under O_IN_Q once O has
      // gone out through this consumer's rows of it)
      if constexpr (!T::O_IN_Q) arrive(q_empty);
      if (my_tiles > 0) {
        const int last = my_tiles - 1;  // its P V
        mbar_wait(v_full(stage(last)), parity(last));
        fence_regs(o);
        wgmma_fence();
        issue_pv(last);
        wgmma_wait<0>();
        fence_regs(o);
        arrive(empty(stage(last)));
      }
      for (int t = my_tiles; t < x.n_tiles; ++t) {  // past its last key
        mbar_wait(k_full(stage(t)), parity(t));
        arrive(empty(stage(t)));
      }
      kv += x.n_tiles;

      // epilogue: O / l through this consumer's rows of the O buffer
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      bf16* og = static_cast<bf16*>(p.o) + x.b * p.o_sb + x.hq * p.o_sh +
                 (int64_t)row0 * p.o_ss;
      store_tile_bf16<D>(o, inv, o_rows, T::Q_HALF, og, p.o_ss,
                         min(64, p.sq - row0), 1 + c);
      if constexpr (T::O_IN_Q) {  // the rows were read: TMA may refill them
        fence_proxy_async();
        arrive(q_empty);
      }
      if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = row0 + 16 * warp + g + 8 * r;
          // a row that saw no key keeps m = -1e30 log2 e: its lse is the
          // natural -1e30 + ln l = -1e30 exactly, as the reference's and
          // the backward's masked scores (m ln 2 would round off by ~1e22)
          const float m_ln = m[r] == NEG_INF * LOG2E ? NEG_INF : m[r] * LN2;
          if (qi < p.sq)
            p.lse[((int64_t)x.b * p.h + x.hq) * p.sq + qi] =
                m_ln + logf(fmaxf(l[r], 1e-30f));
        }
      }
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const Params& p, int batch, int hkv, int d,
                         cudaStream_t stream) {
  using T = FwdTiles<D>;
  FwdArgs a;
  a.p = p;
  cudaError_t err = map_bshd(&a.q, p.q, batch, p.sq, p.h, d, p.q_sb, p.q_ss,
                             p.q_sh, T::BQ);
  if (err == cudaSuccess)
    err = map_bshd(&a.k, p.k, batch, p.sk, hkv, d, p.k_sb, p.k_ss, p.k_sh,
                   T::BK);
  if (err == cudaSuccess)
    err = map_bshd(&a.v, p.v, batch, p.sk, hkv, d, p.v_sb, p.v_ss, p.v_sh,
                   T::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_bf16_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  a.n_qt = (p.sq + T::BQ - 1) / T::BQ;
  a.n_work = a.n_qt * p.h * batch;
  // Without the causal mask the grid is persistent: at most one block per
  // SM (one fits), each walking over work tiles, so a block's next Q and
  // K/V load under its current epilogue.  Under the mask the work tiles
  // differ in length and a fixed stride does not balance them (at 4 query
  // tiles per head, block b of 132 would get query tile b % 4 every time),
  // so there is one block per work tile, the longest first, and the
  // hardware hands the next one to whichever SM frees up (K2's rule).
  const int grid = p.causal ? a.n_work : min(a.n_work, sms);
  flash_fwd_bf16_wgmma<D><<<grid, 3 * WG, T::SMEM, stream>>>(a);
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
  else if (dtype == 0 && d == 256) err = launch_f32<256>(p, batch, st);
  else if (dtype == 1 && d == 64) err = launch_wgmma<64>(p, batch, hkv, d, st);
  else if (dtype == 1 && d == 128)
    err = launch_wgmma<128>(p, batch, hkv, d, st);
  else if (dtype == 1 && d == 256)
    err = launch_wgmma<256>(p, batch, hkv, d, st);
  return (int)err;
}
