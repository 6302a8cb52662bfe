// K2: flash-attention backward for Hopper (sm_90a), as two kernels.
//
// Replaces the Pallas TPU kernels in lxt_tpu/ops/flash_attention.py:
// _fused_bwd_kernel and _fused_bwd_kernel_split (one kv block, launched by
// _fused_bwd) and _dq_kernel with _dkv_kernel (launched by _split_bwd),
// for flash_attention's backward and for flash_attention_lse's (_flash_lse_bwd).
// From the forward's out and lse, and the lse cotangent dlse where the
// caller uses the lse (flash_attention_lse; the ring merges by it):
//   Δ = rowsum(out∘do) − dlse, p = exp(s − lse), dv = pᵀ·do, dp = do·vᵀ,
//   ds = p∘(dp − Δ), dq = ds·k·scale, dk = dsᵀ·q·scale,
// with dk/dv summed over each GQA group and the transposed RoPE rotation
// applied to dq and dk (dlse folds in as −Δ does: ∂lse/∂s = p, as
// _make_delta does in lxt_tpu). Rows with lse <= −5e29 (no visible key)
// give p = 0. flash_bwd_dq computes Δ of its own rows in its prologue and
// writes it out (lxt_tpu's inline_delta option, _delta_block); without a
// dlse its arithmetic is that of flash_attention's backward bit for bit.
// flash_bwd_dkv, which runs after it, reads that Δ. The backward runs no
// separate Δ pass. The masks take the call's global q_start / k_start
// offsets (Mask in flash_common.cuh), as _block_mask does.
//
// What bounds it on the H100: five products per score (against two in the
// forward; flash_bwd_dq recomputes s and dp, so the two kernels do seven),
// ~120 GFLOP at the main path's call (B 8, H 32 / Hkv 4, T 1024, head dim
// 64, bf16, causal), again far above the card's ridge: the tensor cores
// and the elementwise work per score are the roofline bound, not device
// memory.
//
// The split into a kv-major and a q-major kernel makes every output be
// written once by one CTA — no atomics, deterministic.
//
// The Hopper body of flash_bwd_dkv (bf16 at head dim 64 and 128, the main
// and NF4 8B paths' calls):
// - one CTA per (b, kv head, 64-row kv tile), launched lowest kv tile
//   first: under the causal mask those see the most q tiles. The CTA's
//   work items are the visible (q head of the group, 64-row q tile) pairs;
//   its two consumer warpgroups take the even and the odd items, each
//   holding a whole dk and dv partial of the kv tile in registers, and sum
//   them in a fixed order through shared memory at the end: deterministic,
//   no atomics. A producer warpgroup gives its registers to them
//   (setmaxnreg), which the two [64, D] partials need at head dim 128.
// - one producer thread TMA-loads k and v once and keeps a 4-stage ring of
//   (q, do) tiles with their lse and Δ slices in flight (two stages for
//   each warpgroup).
// - per item, in the transposed formulation: sᵀ = k qᵀ and dpᵀ = v doᵀ are
//   wgmma chains from shared memory; pᵀ and dsᵀ = pᵀ∘(dpᵀ − Δ) are rounded
//   to bf16 in registers, where they are the A operands of dv += pᵀ do and
//   dk += dsᵀ q (do and q MN-major from shared memory). exp2 is one
//   ex2.approx; the mask is two bounds per kv row, applied only on tiles it
//   cuts.
// - RoPE: q arrives rotated by the rotation pass (rope.cu), once per
//   backward call (a [B, H, T, D] scratch copy); k is rotated once, in
//   shared memory, in the prologue; dk gets the transposed rotation in the
//   epilogue.
//
// The Hopper body of flash_bwd_dkv at head dim 256 (bf16, Gemma-3-4B's
// calls: 137 GFLOP at the global one, 0.139 ms at 989 TFLOP/s, on ~0.1 GB).
// The body above cannot take it: a whole [64, 256] dk and dv partial is 256
// fp32 accumulators a thread, and the mma.sync body that ran before spilled
// 1396 bytes a thread at 255 registers. So the two consumer warpgroups
// split the head dim, not the items:
// - one CTA per (b, kv head, 64-row kv tile), lowest kv tile first; k and v
//   (32 KiB each) load once, k is rotated in the prologue; a producer
//   thread keeps a 2-stage ring of (q, do, lse, Δ) items (65 KiB a stage).
// - both warpgroups take every item. Warpgroup wg computes q columns
//   [32 wg, 32 wg + 32) of sᵀ = k qᵀ and dpᵀ = v doᵀ (wgmma m64n32, depth
//   256), turns them into pᵀ and dsᵀ in registers and writes them in bf16
//   to a swizzled [64, 64] exchange panel each, double-buffered by item
//   parity, behind one named barrier per item. Then each warpgroup runs
//   dv += pᵀ do and dk += dsᵀ q for the head-dim panels wg and wg + 2 it
//   owns (one m64n128 product whose MN-major B steps two panels), 64 x 128
//   fp32 of each: 128 accumulators a thread, 168 registers, no spills.
//   Computing all of sᵀ and dpᵀ in each warpgroup instead would need no
//   exchange but do 1.5x the tensor work and hold 64 more registers.
// - the transposed-RoPE pair (c, c + 128) lies in panels (wg, wg + 2),
//   both in one lane, so the epilogue rotates dk in registers; every
//   element of dk and dv has one writer: deterministic, no atomics, and no
//   partial sum between the warpgroups.
//
// The Hopper body of flash_bwd_dq (bf16 at head dim 64, 128 and 256). What
// bounds it: three products per visible pair (s, dp, ds·k; 51.5 and 206
// GFLOP at the two paths' calls, 0.0522 / 0.2085 ms at 989 TFLOP/s, and 45.1
// / 103.1 GFLOP at Gemma-3-4B's local and global calls) against ~0.1-0.15
// GB of q/do/out/dq/k/v (~0.03-0.045 ms at 3.35 TB/s), so the tensor cores,
// and beside them the exp2 and the ds arithmetic per score. The mma.sync
// body reached 5.6-7.7% of that bound: unpipelined loads behind
// __syncthreads, p and ds through shared strips, a branchy mask per
// element, and at head dim 256 the k tile rotated again for every q tile.
// This body is K1's shape:
// - one CTA per (b, h, q tile of 64 rows per consumer warpgroup): three
//   warpgroups at head dim 64, two at 128 and 256, and a producer
//   warpgroup that gives its registers to them (setmaxnreg); q tiles
//   last-first, so under the causal mask the CTAs with the most kv tiles
//   start first.
// - one producer thread TMA-loads the q and do tiles once and keeps a ring
//   of 4 (k, v) stages of 64 rows over the visible kv tiles. lse and Δ of
//   a q-major CTA are per-row constants in registers: no per-stage copy.
// - at head dim 256 q and do take 128 KiB and dq 128 fp32 registers a
//   thread, so the kv tiles have 32 rows: s and dp are m64n32 chains of
//   depth 256 (16 registers each), ds·k two m64n256k16 products, and the
//   ring 3 stages of 32 KiB (225 KiB in all). q rotates in two batches of
//   32 rows, and dq's tables load after the main loop (ahead of it, they
//   would not fit beside dq, s and dp).
// - per kv tile and warpgroup: s = q kᵀ and dp = do vᵀ are two wgmma
//   chains from shared memory (all four K-major); p = ex2.approx(s·scale·
//   log2e − lse·log2e), a row with no visible key subtracting +inf; the
//   mask is two bounds per row, applied only on tiles it cuts; ds =
//   p∘(dp − Δ) is rounded to bf16 in registers (as the TPU kernel casts ds
//   to k's dtype) and is the A operand of dq += ds·k, k MN-major from the
//   stage. That product of one tile runs while the next tile's s and dp
//   become ds (the first tile is peeled: a product in flight across a
//   branch would serialize). Every dq row has one writer: no atomics.
// - Δ in the prologue, while the tiles load: each lane reads out and do at
//   its own accumulator columns, multiplies in fp32 and sums over the
//   quad (row_delta, shared with the mma.sync body); lane t == 0 writes it.
// - RoPE: q is rotated once, in shared memory, in the prologue (as K1); k
//   arrives rotated by the rotation pass, once per call (the same k tile
//   serves s = q kᵀ and dq += ds·k); dq gets the scale and the transposed
//   rotation in registers in the epilogue.
// - A CTA's fixed costs weigh at the main path's call (~9 kv tiles a
//   warpgroup): the prologue issues the Δ, lse and q-table loads together
//   before it waits for the tiles, the epilogue's tables load during the
//   last tile, and dq is stored as bf16 pairs.
//
// The mma.sync bodies (float32 and float16; lxt_flash_bwd_dq_mma keeps every
// bf16 dq body callable and lxt_flash_bwd_dkv_mma the bf16 dkv body at 256,
// as controls):
// - flash_bwd_dkv: one CTA per (b, kv head, 64-row kv tile); each warp owns
//   16 kv rows and accumulates dk and dv in registers while the CTA loops
//   over the n_rep q heads of the group and over the visible q tiles.
// - flash_bwd_dq: one CTA per (b, h, 64-row q tile); each warp owns 16 q
//   rows, computes their Δ first (row_delta, as the Hopper body) and
//   accumulates dq over the visible kv tiles.
// Both recompute p from lse (no probabilities are stored), skip fully
// masked tiles, and pass p and ds through per-warp shared strips in the
// activation dtype for the next product, as the TPU kernels cast them.
// Products use mma.sync (bf16, float16) or FMAs (float32) with fp32
// accumulation; loads are not pipelined.
#include "hopper.cuh"

namespace lxt {

template <typename T, int D>
struct BwdTiles {
  static constexpr int BM = kTile;                  // rows a CTA owns
  static constexpr int BN = D <= 128 ? 64 : 32;     // rows per inner step
  static constexpr int P = pitch<T, D>();
  static constexpr int PN = pitch<T, BN>();         // per-warp p/ds strip
  static constexpr size_t strips = sizeof(T) * kWarps * kRows * PN;
  static constexpr size_t smem_dq = sizeof(T) * (2 * BM * P + 2 * BN * P) + strips;
  static constexpr size_t smem_dkv =
      sizeof(T) * (2 * BM * P + 2 * BN * P) + strips + 2 * sizeof(float) * BN;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const FlashArgs a) {
  using C = BwdTiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + C::BM * C::P;
  T* sK = sDO + C::BM * C::P;
  T* sV = sK + C::BN * C::P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  T* sS = sV + C::BN * C::P + warp * kRows * C::PN;

  const int q0 = blockIdx.x * C::BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const T* cos = static_cast<const T*>(a.cos);
  const T* sin = static_cast<const T*>(a.sin);
  const Mask mask = make_mask(a, b);

  load_tile<T, D, C::BM>(sQ, static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1] + q0 * a.sq[2],
                         a.sq[2]);
  load_tile<T, D, C::BM>(sDO, static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1] +
                                  q0 * a.sdo[2], a.sdo[2]);
  if (cos) {
    __syncthreads();
    rope_tile<T, D, C::BM>(sQ, cos, sin, q0);
  }

  const int row0 = q0 + warp * kRows + g;
  const long long stat0 = ((long long)b * a.H + h) * a.T;
  float lse2[2], delta[2];
  bool dead[2];
  row_delta<T, D>(static_cast<const T*>(a.out) + b * a.sout[0] + h * a.sout[1], a.sout[2],
                  static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1], a.sdo[2], row0,
                  delta);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (a.dlse) delta[r] -= a.dlse[stat0 + row0 + 8 * r];
    const float lse = a.lse[stat0 + row0 + 8 * r];
    dead[r] = lse <= kNegInf / 2;
    lse2[r] = lse * kLog2e;
    if (t == 0) a.lse_out[stat0 + row0 + 8 * r] = delta[r];
  }
  float dq[D / 8][4] = {};

  for (int k0 = 0; k0 < a.Tk; k0 += C::BN) {
    if (mask.skip(q0, C::BM, k0, C::BN)) continue;
    __syncthreads();
    load_tile<T, D, C::BN>(sK, kg + k0 * a.sk[2], a.sk[2]);
    load_tile<T, D, C::BN>(sV, vg + k0 * a.sv[2], a.sv[2]);
    if (cos) {
      __syncthreads();
      rope_tile<T, D, C::BN>(sK, cos, sin, k0);
    }
    __syncthreads();

    float s[C::BN / 8][4] = {}, dp[C::BN / 8][4] = {};
    warp_mma<true, C::BN / 8, D>(s, sQ + warp * kRows * C::P, C::P, sK, C::P);
    warp_mma<true, C::BN / 8, D>(dp, sDO + warp * kRows * C::P, C::P, sV, C::P);
    const bool inner = mask.interior(q0, C::BM, k0, C::BN);
#pragma unroll
    for (int nt = 0; nt < C::BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float p = exp2f(s[nt][e] * a.scale_log2 - lse2[r]);
        if (dead[r] || (!inner && !mask.allowed(row0 + 8 * r, k0 + nt * 8 + 2 * t + (e & 1))))
          p = 0.f;
        s[nt][e] = p * (dp[nt][e] - delta[r]);
      }
    }
    store_strip<T, C::BN / 8>(sS, C::PN, s);
    __syncwarp();
    warp_mma<false, D / 8, C::BN>(dq, sS, C::PN, sK, C::P);
    __syncwarp();
  }

#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] *= a.scale;
  if (cos) rope_transpose<T, D>(dq, cos, sin, row0);
  store_rows<T, D>(static_cast<T*>(a.out0) + b * a.so0[0] + h * a.so0[1] +
                       (q0 + warp * kRows) * a.so0[2],
                   a.so0[2], dq);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const FlashArgs a) {
  using C = BwdTiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + C::BM * C::P;
  T* sQ = sV + C::BM * C::P;
  T* sDO = sQ + C::BN * C::P;
  T* sStrips = sDO + C::BN * C::P;
  float* sLse = reinterpret_cast<float*>(sStrips + kWarps * kRows * C::PN);
  float* sDelta = sLse + C::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  T* sS = sStrips + warp * kRows * C::PN;

  const int k0 = blockIdx.x * C::BM, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = a.H / a.Hkv;
  const T* cos = static_cast<const T*>(a.cos);
  const T* sin = static_cast<const T*>(a.sin);
  const Mask mask = make_mask(a, b);

  load_tile<T, D, C::BM>(sK, static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1] + k0 * a.sk[2],
                         a.sk[2]);
  load_tile<T, D, C::BM>(sV, static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1] + k0 * a.sv[2],
                         a.sv[2]);
  if (cos) {
    __syncthreads();
    rope_tile<T, D, C::BM>(sK, cos, sin, k0);
  }

  const int krow0 = k0 + warp * kRows + g;  // this lane's kv rows: krow0, +8
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};

  for (int h = hk * n_rep; h < (hk + 1) * n_rep; ++h) {
    const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
    const T* dog = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
    const long long stat0 = ((long long)b * a.H + h) * a.T;
    for (int q0 = 0; q0 < a.T; q0 += C::BN) {
      if (mask.skip(q0, C::BN, k0, C::BM)) continue;
      __syncthreads();
      load_tile<T, D, C::BN>(sQ, qg + q0 * a.sq[2], a.sq[2]);
      load_tile<T, D, C::BN>(sDO, dog + q0 * a.sdo[2], a.sdo[2]);
      for (int i = threadIdx.x; i < C::BN; i += kThreads) {
        sLse[i] = a.lse[stat0 + q0 + i];
        sDelta[i] = a.delta[stat0 + q0 + i];
      }
      if (cos) {
        __syncthreads();
        rope_tile<T, D, C::BN>(sQ, cos, sin, q0);
      }
      __syncthreads();

      // transposed scores: rows are this warp's kv rows, columns q rows
      float st[C::BN / 8][4] = {};
      warp_mma<true, C::BN / 8, D>(st, sK + warp * kRows * C::P, C::P, sQ, C::P);
      const bool inner = mask.interior(q0, C::BN, k0, C::BM);
#pragma unroll
      for (int nt = 0; nt < C::BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t + (e & 1);
          const float lse = sLse[c];
          float p = exp2f(st[nt][e] * a.scale_log2 - lse * kLog2e);
          if (lse <= kNegInf / 2 || (!inner && !mask.allowed(q0 + c, krow0 + 8 * (e / 2))))
            p = 0.f;
          st[nt][e] = p;
        }
      }
      store_strip<T, C::BN / 8>(sS, C::PN, st);
      __syncwarp();
      warp_mma<false, D / 8, C::BN>(dv, sS, C::PN, sDO, C::P);
      __syncwarp();

      float dpt[C::BN / 8][4] = {};
      warp_mma<true, C::BN / 8, D>(dpt, sV + warp * kRows * C::P, C::P, sDO, C::P);
#pragma unroll
      for (int nt = 0; nt < C::BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[nt][e] *= dpt[nt][e] - sDelta[nt * 8 + 2 * t + (e & 1)];
      }
      store_strip<T, C::BN / 8>(sS, C::PN, st);
      __syncwarp();
      warp_mma<false, D / 8, C::BN>(dk, sS, C::PN, sQ, C::P);
      __syncwarp();
    }
  }

#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] *= a.scale;
  if (cos) rope_transpose<T, D>(dk, cos, sin, krow0);
  const int wrow = k0 + warp * kRows;
  store_rows<T, D>(static_cast<T*>(a.out0) + b * a.so0[0] + hk * a.so0[1] + wrow * a.so0[2],
                   a.so0[2], dk);
  store_rows<T, D>(static_cast<T*>(a.out1) + b * a.so1[0] + hk * a.so1[1] + wrow * a.so1[2],
                   a.so1[2], dv);
}

template <typename T, int D>
cudaError_t launch_bwd_dq(const FlashArgs& a, cudaStream_t stream) {
  using C = BwdTiles<T, D>;
  return launch(flash_bwd_dq_kernel<T, D>, dim3(a.T / C::BM, a.H, a.B), C::smem_dq, stream, a);
}

template <typename T, int D>
cudaError_t launch_bwd_dkv(const FlashArgs& a, cudaStream_t stream) {
  using C = BwdTiles<T, D>;
  return launch(flash_bwd_dkv_kernel<T, D>, dim3(a.Tk / C::BM, a.Hkv, a.B), C::smem_dkv, stream,
                a);
}

namespace hopper {

template <int D>
struct DkvTiles {
  static constexpr int BM = 64, BN = 64, STAGES = 4, PANELS = D / 64;
  static constexpr int PANEL = 64 * kPanelBytes;            // 64 rows of a panel
  static constexpr int TILE_BYTES = PANELS * PANEL;          // a [64, D] tile
  // a stage: q, do, then lse and Δ (64 floats each), padded to 1024 bytes
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 1024;
  static constexpr int STAGE_OFF = 2 * TILE_BYTES;           // after k and v
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr size_t smem = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
  // the second warpgroup's dk and dv partials reuse the ring at the end
  static_assert(2 * 64 * D * 4 <= STAGES * STAGE_BYTES, "partials must fit the ring");
};

struct DkvMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
__global__ void __launch_bounds__(Roles<2>::kThreads, 1)
    flash_bwd_dkv_hopper(const __grid_constant__ FlashArgs a, const __grid_constant__ DkvMaps m) {
  using C = DkvTiles<D>;
  using R = Roles<2>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::TILE_BYTES;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + C::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.z * C::BM, hk = blockIdx.x, b = blockIdx.y;
  const int n_rep = a.H / a.Hkv, h_begin = hk * n_rep, h_end = h_begin + n_rep;
  const Mask mask = make_mask(a, b);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // stage s serves warpgroup s % 2 only
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= R::kConsumers / 32) {
    // producer warpgroup: one thread issues the loads
    reg_dealloc<R::kProducerRegs>();
    if (warp == R::kConsumers / 32 && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * C::TILE_BYTES);
      for (int p = 0; p < C::PANELS; ++p) {
        tma_load(sK + p * C::PANEL, &m.k, bar_kv, 64 * p, k0, hk, b);
        tma_load(sV + p * C::PANEL, &m.v, bar_kv, 64 * p, k0, hk, b);
      }
      int it = 0;
      for (int h = h_begin; h < h_end; ++h) {
        const long long stat = ((long long)b * a.H + h) * a.T;
        for (int q0 = 0; q0 < a.T; q0 += C::BN) {
          if (mask.skip(q0, C::BN, k0, C::BM)) continue;
          const int s = it % C::STAGES;
          const uint32_t n = it / C::STAGES;
          ++it;
          mbar_wait(&empty[s], (n & 1) ^ 1);
          unsigned char* st = smem + C::STAGE_OFF + s * C::STAGE_BYTES;
          mbar_expect_tx(&full[s], 2 * C::TILE_BYTES + 2 * C::BN * 4);
          for (int p = 0; p < C::PANELS; ++p) {
            tma_load(st + p * C::PANEL, &m.q, &full[s], 64 * p, q0, h, b);
            tma_load(st + C::TILE_BYTES + p * C::PANEL, &m.dout, &full[s], 64 * p, q0, h, b);
          }
          bulk_load(st + 2 * C::TILE_BYTES, a.lse + stat + q0, C::BN * 4, &full[s]);
          bulk_load(st + 2 * C::TILE_BYTES + C::BN * 4, a.delta + stat + q0, C::BN * 4,
                    &full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup wg takes the items with index % 2 == wg
    reg_alloc<R::kConsumerRegs>();
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    mbar_wait(bar_kv, 0);
    if (a.cos) {
      rope_swizzled<D, C::BM, R::kConsumers>(sK, C::PANEL, static_cast<const bf16*>(a.cos),
                                             static_cast<const bf16*>(a.sin), k0,
                                             threadIdx.x);
      fence_proxy_async();
    }
    named_sync(1, R::kConsumers);

    const int krow0 = k0 + 16 * (warp % 4) + g;  // this lane's kv rows: krow0, krow0 + 8
    int q_lo[2], q_hi[2];  // the visible query columns of those rows
    mask.query_span(krow0, q_lo[0], q_hi[0]);
    mask.query_span(krow0 + 8, q_lo[1], q_hi[1]);
    float dk[D / 8][4] = {}, dv[D / 8][4] = {};
    int it = 0;
    for (int h = h_begin; h < h_end; ++h) {
      for (int q0 = 0; q0 < a.T; q0 += C::BN) {
        if (mask.skip(q0, C::BN, k0, C::BM)) continue;
        const int item = it++;
        if ((item & 1) != wg) continue;
        const int s = item % C::STAGES;
        const uint32_t n = item / C::STAGES;
        mbar_wait(&full[s], n & 1);
        const unsigned char* sQ = smem + C::STAGE_OFF + s * C::STAGE_BYTES;
        const unsigned char* sDO = sQ + C::TILE_BYTES;
        const float* sLse = reinterpret_cast<const float*>(sQ + 2 * C::TILE_BYTES);
        const float* sDelta = sLse + C::BN;

        // transposed scores and dp: rows are kv rows, columns q rows
        float st[8][4] = {}, dpt[8][4] = {};
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * C::PANEL + (kk % 4) * 32;
          wgmma_ss<C::BN>(st, desc(sK + off, 16, 1024), desc(sQ + off, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * C::PANEL + (kk % 4) * 32;
          wgmma_ss<C::BN>(dpt, desc(sV + off, 16, 1024), desc(sDO + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);

        // p = 2^(s·scale·log2e − lse·log2e); a row with no visible key
        // (lse −1e30) subtracts +inf and gets p = 0
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 lse = *reinterpret_cast<const float2*>(sLse + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse_c = (e & 1) ? lse.y : lse.x;
            const float sub = lse_c <= kNegInf / 2 ? __int_as_float(0x7f800000) : lse_c * kLog2e;
            st[j][e] = exp2_fast(st[j][e] * a.scale_log2 - sub);
          }
        }
        if (!mask.interior(q0, C::BN, k0, C::BM)) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = q0 + 8 * j + 2 * t + (e & 1), r = e / 2;
              st[j][e] = c >= q_lo[r] && c < q_hi[r] ? st[j][e] : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 del = *reinterpret_cast<const float2*>(sDelta + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? del.y : del.x));
        }
        uint32_t pa[4][4], dsa[4][4];
        to_a_operand(st, pa);
        to_a_operand(dpt, dsa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk)
          wgmma_rs<D>(dv, pa[kk], desc(sDO + kk * 16 * kPanelBytes, C::PANEL, 1024));
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk)
          wgmma_rs<D>(dk, dsa[kk], desc(sQ + kk * 16 * kPanelBytes, C::PANEL, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
        mbar_arrive(&empty[s]);
      }
    }

    // the two partials, summed in a fixed order (warpgroup 0's + warpgroup
    // 1's) through the ring, which every item has released by now
    float* red = reinterpret_cast<float*>(smem + C::STAGE_OFF);
    const int wt = threadIdx.x % 128;
    named_sync(1, R::kConsumers);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(4 * j + e) * 128 + wt] = dk[j][e];
          red[(D / 2 + 4 * j + e) * 128 + wt] = dv[j][e];
        }
    }
    named_sync(1, R::kConsumers);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[j][e] = (dk[j][e] + red[(4 * j + e) * 128 + wt]) * a.scale;
          dv[j][e] += red[(D / 2 + 4 * j + e) * 128 + wt];
        }
      if (a.cos) rope_transpose<bf16, D>(dk, static_cast<const bf16*>(a.cos),
                                         static_cast<const bf16*>(a.sin), krow0);
      const int wrow = k0 + 16 * (warp % 4);
      store_rows<bf16, D>(static_cast<bf16*>(a.out0) + b * a.so0[0] + hk * a.so0[1] +
                              wrow * a.so0[2], a.so0[2], dk);
      store_rows<bf16, D>(static_cast<bf16*>(a.out1) + b * a.so1[0] + hk * a.so1[1] +
                              wrow * a.so1[2], a.so1[2], dv);
    }
  }
}

template <int D>
cudaError_t launch_bwd_dkv(const FlashArgs& a, cudaStream_t stream) {
  using C = DkvTiles<D>;
  DkvMaps m;
  cudaError_t err = tensor_map(&m.q, a.q, a.sq, a.B, a.H, a.T, D, C::BN);
  if (err == cudaSuccess) err = tensor_map(&m.dout, a.dout, a.sdo, a.B, a.H, a.T, D, C::BN);
  if (err == cudaSuccess) err = tensor_map(&m.k, a.k, a.sk, a.B, a.Hkv, a.Tk, D, C::BM);
  if (err == cudaSuccess) err = tensor_map(&m.v, a.v, a.sv, a.B, a.Hkv, a.Tk, D, C::BM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B, a.Tk / C::BM);
  return launch_hopper(flash_bwd_dkv_hopper<D>, grid, Roles<2>::kThreads, C::smem, stream, a, m);
}

// shared memory of the dkv body at head dim 256 (the file's header)
struct Dkv256Tiles {
  static constexpr int D = 256, BM = 64, BN = 64, STAGES = 2, PANELS = D / 64;
  static constexpr int PANEL = 64 * kPanelBytes;                  // 64 rows of a panel
  static constexpr int TILE_BYTES = PANELS * PANEL;                // a [64, 256] tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;               // q, then do
  static constexpr int STAGE_OFF = 2 * TILE_BYTES;                 // after k and v
  // pᵀ and dsᵀ ([64 kv rows, 64 q rows] bf16, one swizzled panel each),
  // double-buffered by item parity
  static constexpr int EX_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int EX_BYTES = 2 * PANEL;
  static constexpr int STAT_OFF = EX_OFF + 2 * EX_BYTES;          // lse, Δ of each stage
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BN * 4;
  static constexpr size_t smem = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

__global__ void __launch_bounds__(Roles<2>::kThreads, 1)
    flash_bwd_dkv_hopper256(const __grid_constant__ FlashArgs a,
                            const __grid_constant__ DkvMaps m) {
  using C = Dkv256Tiles;
  using R = Roles<2>;
  constexpr int D = C::D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::TILE_BYTES;
  float* sStat = reinterpret_cast<float*>(smem + C::STAT_OFF);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + C::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.z * C::BM, hk = blockIdx.x, b = blockIdx.y;
  const int n_rep = a.H / a.Hkv, h_begin = hk * n_rep, h_end = h_begin + n_rep;
  const Mask mask = make_mask(a, b);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R::kConsumers);  // both warpgroups read every stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= R::kConsumers / 32) {
    // producer warpgroup: one thread issues the loads
    reg_dealloc<R::kProducerRegs>();
    if (warp == R::kConsumers / 32 && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * C::TILE_BYTES);
      for (int p = 0; p < C::PANELS; ++p) {
        tma_load(sK + p * C::PANEL, &m.k, bar_kv, 64 * p, k0, hk, b);
        tma_load(sV + p * C::PANEL, &m.v, bar_kv, 64 * p, k0, hk, b);
      }
      int it = 0;
      for (int h = h_begin; h < h_end; ++h) {
        const long long stat = ((long long)b * a.H + h) * a.T;
        for (int q0 = 0; q0 < a.T; q0 += C::BN) {
          if (mask.skip(q0, C::BN, k0, C::BM)) continue;
          const int s = it % C::STAGES;
          const uint32_t n = it / C::STAGES;
          ++it;
          mbar_wait(&empty[s], (n & 1) ^ 1);
          unsigned char* st = smem + C::STAGE_OFF + s * C::STAGE_BYTES;
          mbar_expect_tx(&full[s], C::STAGE_BYTES + 2 * C::BN * 4);
          for (int p = 0; p < C::PANELS; ++p) {
            tma_load(st + p * C::PANEL, &m.q, &full[s], 64 * p, q0, h, b);
            tma_load(st + C::TILE_BYTES + p * C::PANEL, &m.dout, &full[s], 64 * p, q0, h, b);
          }
          bulk_load(sStat + s * 2 * C::BN, a.lse + stat + q0, C::BN * 4, &full[s]);
          bulk_load(sStat + s * 2 * C::BN + C::BN, a.delta + stat + q0, C::BN * 4, &full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup wg computes q columns [32 wg, 32 wg + 32) of each
    // item's sᵀ and dpᵀ, and dk/dv columns of panels wg and wg + 2
    reg_alloc<R::kConsumerRegs>();
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const bf16* cos = static_cast<const bf16*>(a.cos);
    const bf16* sin = static_cast<const bf16*>(a.sin);
    mbar_wait(bar_kv, 0);
    if (cos) {
      rope_swizzled<D, C::BM, R::kConsumers>(sK, C::PANEL, cos, sin, k0, threadIdx.x);
      fence_proxy_async();
    }
    named_sync(1, R::kConsumers);

    const int r0 = 16 * (warp % 4) + g;  // this lane's kv rows in the tile: r0, r0 + 8
    const int krow0 = k0 + r0;
    const int cw = 32 * wg;              // this warpgroup's first q column of an item
    int q_lo[2], q_hi[2];                // the visible query columns of those rows
    mask.query_span(krow0, q_lo[0], q_hi[0]);
    mask.query_span(krow0 + 8, q_lo[1], q_hi[1]);
    // accumulator block j holds columns 64 wg + 8 j (j < 8) and 128 + 64 wg
    // + 8 (j - 8) (j >= 8): the transposed-RoPE pair (c, c + 128) is blocks
    // (j, j + 8) of one lane
    float dk[16][4] = {}, dv[16][4] = {};
    int it = 0;
    for (int h = h_begin; h < h_end; ++h) {
      for (int q0 = 0; q0 < a.T; q0 += C::BN) {
        if (mask.skip(q0, C::BN, k0, C::BM)) continue;
        const int item = it++;
        const int s = item % C::STAGES;
        const uint32_t n = item / C::STAGES;
        mbar_wait(&full[s], n & 1);
        const unsigned char* sQ = smem + C::STAGE_OFF + s * C::STAGE_BYTES;
        const unsigned char* sDO = sQ + C::TILE_BYTES;
        const float* sLse = sStat + s * 2 * C::BN;
        const float* sDelta = sLse + C::BN;
        unsigned char* sP = smem + C::EX_OFF + (item & 1) * C::EX_BYTES;
        unsigned char* sDS = sP + C::PANEL;

        // this warpgroup's half of the transposed scores and dp: rows are
        // the 64 kv rows, columns q rows cw..cw + 31 (a 1024-byte-aligned
        // row offset keeps the swizzle)
        float st[4][4] = {}, dpt[4][4] = {};
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * C::PANEL + (kk % 4) * 32;
          wgmma_ss<32>(st, desc(sK + off, 16, 1024), desc(sQ + cw * kPanelBytes + off, 16, 1024),
                       kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * C::PANEL + (kk % 4) * 32;
          wgmma_ss<32>(dpt, desc(sV + off, 16, 1024),
                       desc(sDO + cw * kPanelBytes + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);

        // p = 2^(s·scale·log2e − lse·log2e); a row with no visible key
        // (lse −1e30) subtracts +inf and gets p = 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 lse = *reinterpret_cast<const float2*>(sLse + cw + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse_c = (e & 1) ? lse.y : lse.x;
            const float sub = lse_c <= kNegInf / 2 ? __int_as_float(0x7f800000) : lse_c * kLog2e;
            st[j][e] = exp2_fast(st[j][e] * a.scale_log2 - sub);
          }
        }
        if (!mask.interior(q0, C::BN, k0, C::BM)) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = q0 + cw + 8 * j + 2 * t + (e & 1), r = e / 2;
              st[j][e] = c >= q_lo[r] && c < q_hi[r] ? st[j][e] : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 del = *reinterpret_cast<const float2*>(sDelta + cw + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? del.y : del.x));
        }
        // pᵀ and dsᵀ in bf16 into the swizzled exchange panels; the other
        // warpgroup writes the other 32 columns. This buffer was last read
        // by item − 2's products, which both warpgroups finished before
        // they passed item − 1's barrier.
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r, col = cw + 8 * j;
            const int off = row * kPanelBytes + (((col >> 3) ^ (row & 7)) << 4) + 4 * t;
            *reinterpret_cast<uint32_t*>(sP + off) = pack_bf16x2(st[j][2 * r], st[j][2 * r + 1]);
            *reinterpret_cast<uint32_t*>(sDS + off) =
                pack_bf16x2(dpt[j][2 * r], dpt[j][2 * r + 1]);
          }
        fence_proxy_async();
        named_sync(1, R::kConsumers);

        // dv += pᵀ do and dk += dsᵀ q over this warpgroup's two panels: one
        // 128-column product whose B (do, q: MN-major) steps two panels
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk)
          wgmma_ss_n128_mn(dv, desc(sP + kk * 32, 16, 1024),
                           desc(sDO + wg * C::PANEL + kk * 16 * kPanelBytes, 2 * C::PANEL, 1024),
                           1);
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk)
          wgmma_ss_n128_mn(dk, desc(sDS + kk * 32, 16, 1024),
                           desc(sQ + wg * C::PANEL + kk * 16 * kPanelBytes, 2 * C::PANEL, 1024),
                           1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
        mbar_arrive(&empty[s]);
      }
    }

    // scale and the transposed rotation of dk (rope_transpose's arithmetic;
    // column c in block j pairs with c + 128 in block j + 8), then both
    // partials to their columns: every element has one writer
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][e] *= a.scale;
    if (cos) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long pos = krow0 + 8 * (e / 2);
          const int c = 64 * wg + 8 * j + 2 * t + (e & 1), c2 = c + D / 2;
          const float x1 = dk[j][e], x2 = dk[j + 8][e];
          dk[j][e] = x1 * to_f(cos[pos * D + c]) + x2 * to_f(sin[pos * D + c2]);
          dk[j + 8][e] = x2 * to_f(cos[pos * D + c2]) - x1 * to_f(sin[pos * D + c]);
        }
    }
    bf16* dkg = static_cast<bf16*>(a.out0) + b * a.so0[0] + hk * a.so0[1];
    bf16* dvg = static_cast<bf16*>(a.out1) + b * a.so1[0] + hk * a.so1[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* dk_row = dkg + (krow0 + 8 * r) * a.so0[2];
      bf16* dv_row = dvg + (krow0 + 8 * r) * a.so1[2];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 64 * wg + 128 * (j / 8) + 8 * (j % 8) + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dk_row + c) =
            __floats2bfloat162_rn(dk[j][2 * r], dk[j][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + c) =
            __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

inline cudaError_t launch_bwd_dkv256(const FlashArgs& a, cudaStream_t stream) {
  using C = Dkv256Tiles;
  DkvMaps m;
  cudaError_t err = tensor_map(&m.q, a.q, a.sq, a.B, a.H, a.T, C::D, C::BN);
  if (err == cudaSuccess) err = tensor_map(&m.dout, a.dout, a.sdo, a.B, a.H, a.T, C::D, C::BN);
  if (err == cudaSuccess) err = tensor_map(&m.k, a.k, a.sk, a.B, a.Hkv, a.Tk, C::D, C::BM);
  if (err == cudaSuccess) err = tensor_map(&m.v, a.v, a.sv, a.B, a.Hkv, a.Tk, C::D, C::BM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B, a.Tk / C::BM);
  return launch_hopper(flash_bwd_dkv_hopper256, grid, Roles<2>::kThreads, C::smem, stream, a,
                       m);
}

template <int D>
struct DqTiles {
  // three consumer warpgroups at head dim 64, two at 128 and 256 (dq's
  // accumulator is two and four times as wide); kv tiles of 64 rows (s and
  // dp take 32 registers each). Two warpgroups at head dim 64, or 128-row kv
  // tiles with them, measured slower. At head dim 256 the kv tiles have 32
  // rows: dq holds 128 fp32 a thread beside s and dp (16 each) and ds (8),
  // and a (k, v) stage is 32 KiB beside the 128 KiB of q and do, so three
  // stages fit the 227 KiB a block can use.
  static constexpr int NWG = D == 64 ? 3 : 2;
  static constexpr int BN = D == 256 ? 32 : 64;
  static constexpr int STAGES = D == 256 ? 3 : 4;
  static constexpr int BQ = 64 * NWG, PANELS = D / 64;
  static constexpr int Q_PANEL = BQ * kPanelBytes, KV_PANEL = BN * kPanelBytes;
  static constexpr int Q_BYTES = PANELS * Q_PANEL, KV_BYTES = PANELS * KV_PANEL;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // k, then v
  static constexpr int STAGE_OFF = 2 * Q_BYTES;     // after q and do
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr size_t smem = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
  static_assert(smem <= 232448, "the dynamic shared memory a block can use");
};

struct DqMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
__global__ void __launch_bounds__(Roles<DqTiles<D>::NWG>::kThreads, 1)
    flash_bwd_dq_hopper(const __grid_constant__ FlashArgs a, const __grid_constant__ DqMaps m) {
  using C = DqTiles<D>;
  using R = Roles<C::NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sDO = smem + C::Q_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + C::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ, h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(C::BQ, a.T - q0);  // rows of this tile inside [0, T)
  const Mask mask = make_mask(a, b);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= R::kConsumers / 32) {
    // producer warpgroup: one thread issues the loads
    reg_dealloc<R::kProducerRegs>();
    if (warp == R::kConsumers / 32 && lane == 0) {
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
      for (int p = 0; p < C::PANELS; ++p) {
        tma_load(sQ + p * C::Q_PANEL, &m.q, bar_q, 64 * p, q0, h, b);
        tma_load(sDO + p * C::Q_PANEL, &m.dout, bar_q, 64 * p, q0, h, b);
      }
      int it = 0;
      for (int k0 = 0; k0 < a.Tk; k0 += C::BN) {
        if (mask.skip(q0, nq, k0, C::BN)) continue;
        const int s = it % C::STAGES;
        const uint32_t n = it / C::STAGES;
        ++it;
        mbar_wait(&empty[s], (n & 1) ^ 1);
        unsigned char* sK = smem + C::STAGE_OFF + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load(sK + p * C::KV_PANEL, &m.k, &full[s], 64 * p, k0, hk, b);
          tma_load(sK + C::KV_BYTES + p * C::KV_PANEL, &m.v, &full[s], 64 * p, k0, hk, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows [q0w, q0w + 64)
    reg_alloc<R::kConsumerRegs>();
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const int q0w = q0 + 64 * wg;
    const bool active = q0w < a.T;  // T % 64 == 0: a warpgroup is all in or all out
    unsigned char* sQw = sQ + 64 * wg * kPanelBytes;
    const unsigned char* sDOw = sDO + 64 * wg * kPanelBytes;
    const int row0 = q0w + 16 * (warp % 4) + g;  // this lane's rows: row0, row0 + 8
    const long long stat = ((long long)b * a.H + h) * a.T;

    // Δ of this lane's rows from out and do (written out for flash_bwd_dkv),
    // and lse·log2e as the exp2 subtrahend: a row with no visible key (lse
    // −1e30) subtracts +inf and gets p = 0. Both run while the tiles load.
    const bool rope = active && a.cos != nullptr;
    const bf16* cos = static_cast<const bf16*>(a.cos);
    const bf16* sin = static_cast<const bf16*>(a.sin);
    // the q tile's tables, loaded with Δ; at head dim 256 in batches of 32
    // rows, as K1 (the tables of 64 rows would hold 128 registers a thread)
    constexpr int RR = D == 256 ? 32 : 64;
    RopeChunks<D, RR, 128> q_tab;
    if (rope) q_tab.load(cos, sin, q0w, threadIdx.x % 128);
    float delta[2] = {0.f, 0.f}, sub[2] = {0.f, 0.f};
    if (active) {
      row_delta<bf16, D>(static_cast<const bf16*>(a.out) + b * a.sout[0] + h * a.sout[1],
                         a.sout[2],
                         static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[1],
                         a.sdo[2], row0, delta);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (a.dlse) delta[r] -= a.dlse[stat + row0 + 8 * r];
        const float lse = a.lse[stat + row0 + 8 * r];
        sub[r] = lse <= kNegInf / 2 ? __int_as_float(0x7f800000) : lse * kLog2e;
        if (t == 0) a.lse_out[stat + row0 + 8 * r] = delta[r];
      }
    }
    mbar_wait(bar_q, 0);
    if (rope) {
      q_tab.apply(sQw, C::Q_PANEL, threadIdx.x % 128);
#pragma unroll
      for (int r0 = RR; r0 < 64; r0 += RR) {
        q_tab.load(cos, sin, q0w + r0, threadIdx.x % 128);
        q_tab.apply(sQw + r0 * kPanelBytes, C::Q_PANEL, threadIdx.x % 128);
      }
      fence_proxy_async();
    }
    named_sync(1 + wg, 128);

    float dq[D / 8][4] = {};
    constexpr int NB = C::BN / 8;  // 8-column blocks of a score tile
    // the next kv tile this warpgroup computes on: the CTA's visible tiles
    // in the producer's order, releasing at once those all masked here
    int k0 = -C::BN, it = 0, s = 0;
    auto next_tile = [&]() -> bool {
      for (k0 += C::BN; k0 < a.Tk; k0 += C::BN) {
        if (mask.skip(q0, nq, k0, C::BN)) continue;
        s = it % C::STAGES;
        const uint32_t n = it / C::STAGES;
        ++it;
        mbar_wait(&full[s], n & 1);
        if (active && !mask.skip(q0w, 64, k0, C::BN)) return true;
        mbar_arrive(&empty[s]);
      }
      return false;
    };
    // s = q kᵀ and dp = do vᵀ: two wgmma chains from shared memory, one group
    auto scores = [&](float (&sc)[NB][4], float (&dp)[NB][4]) {
      const unsigned char* sK = smem + C::STAGE_OFF + s * C::STAGE_BYTES;
      const unsigned char* sV = sK + C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;  // the 16 columns inside a 64-column panel
        wgmma_ss<C::BN>(sc, desc(sQw + (kk / 4) * C::Q_PANEL + off, 16, 1024),
                        desc(sK + (kk / 4) * C::KV_PANEL + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_ss<C::BN>(dp, desc(sDOw + (kk / 4) * C::Q_PANEL + off, 16, 1024),
                        desc(sV + (kk / 4) * C::KV_PANEL + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // dq += ds·k, ds in registers, k MN-major from the stage's tile
    auto dq_product = [&](const uint32_t (&dsa)[NB / 2][4], int stage) {
      const unsigned char* sK = smem + C::STAGE_OFF + stage * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        wgmma_rs<D>(dq, dsa[kk], desc(sK + kk * 16 * kPanelBytes, C::KV_PANEL, 1024));
      wgmma_commit();
    };
    // the visible key columns of this lane's two rows
    int key_lo[2], key_hi[2];
    mask.key_span(row0, key_lo[0], key_hi[0]);
    mask.key_span(row0 + 8, key_lo[1], key_hi[1]);
    // p = 2^(s·scale·log2e − lse·log2e), masked to 0 on tiles the mask
    // cuts; ds = p∘(dp − Δ) in place of dp
    auto grad = [&](float (&sc)[NB][4], float (&dp)[NB][4]) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = exp2_fast(sc[j][e] * a.scale_log2 - sub[e / 2]);
      if (!mask.interior(q0w, 64, k0, C::BN)) {
        const int c0 = k0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 8 * j + (e & 1), r = e / 2;
            sc[j][e] = c >= key_lo[r] && c < key_hi[r] ? sc[j][e] : 0.f;
          }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = sc[j][e] * (dp[j][e] - delta[e / 2]);
    };

    // the epilogue's tables, loaded ahead so that their latency overlaps
    // products: one half when the last visible kv tile arrives, the other
    // with the last dq product (all of them at once spilled registers). At
    // head dim 256 even half of them would not fit beside dq, s and dp: they
    // load after the main loop, when s and dp are dead.
    constexpr bool kAhead = D != 256;
    RopeFrags<D> dq_tab;
    int k_last = -1;
    if constexpr (kAhead)
      for (int kt = 0; kt < a.Tk; kt += C::BN)
        if (!mask.skip(q0w, 64, kt, C::BN)) k_last = kt;
    auto prefetch = [&]() {
      if constexpr (kAhead)
        if (rope && k0 == k_last) dq_tab.load<0>(cos, sin, row0);
    };
    if (next_tile()) {
      prefetch();
      // ds of the previous tile: its dq product runs while the next tile's
      // s and dp become ds
      uint32_t dsa[NB / 2][4];
      {
        float sc[NB][4] = {}, dp[NB][4] = {};
        wgmma_fence();
        scores(sc, dp);
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dp);
        grad(sc, dp);
        to_a_operand(dp, dsa);
      }
      int s_prev = s;
      while (next_tile()) {
        prefetch();
        float sc[NB][4] = {}, dp[NB][4] = {};
        wgmma_fence();
        scores(sc, dp);
        dq_product(dsa, s_prev);
        wgmma_wait<1>();  // s and dp; the previous dq product may still run
        fence_acc(sc);
        fence_acc(dp);
        grad(sc, dp);
        wgmma_wait<0>();
        fence_acc(dq);
        fence_regs(dsa);
        mbar_arrive(&empty[s_prev]);
        to_a_operand(dp, dsa);
        s_prev = s;
      }
      wgmma_fence();
      dq_product(dsa, s_prev);
      if constexpr (kAhead)
        if (rope) dq_tab.load<1>(cos, sin, row0);
      wgmma_wait<0>();
      fence_acc(dq);
      mbar_arrive(&empty[s_prev]);
    }

    if (active) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] *= a.scale;
      // a warpgroup that saw no key has dq = 0, which the rotation keeps
      if constexpr (kAhead) {
        if (rope && k_last >= 0) dq_tab.apply(dq);
      } else if (rope) {
        rope_transpose<bf16, D>(dq, cos, sin, row0);
      }
      bf16* dqg = static_cast<bf16*>(a.out0) + b * a.so0[0] + h * a.so0[1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* row = dqg + (row0 + 8 * r) * a.so0[2];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
              __floats2bfloat162_rn(dq[j][2 * r], dq[j][2 * r + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_bwd_dq(const FlashArgs& a, cudaStream_t stream) {
  using C = DqTiles<D>;
  DqMaps m;
  cudaError_t err = tensor_map(&m.q, a.q, a.sq, a.B, a.H, a.T, D, C::BQ);
  if (err == cudaSuccess) err = tensor_map(&m.dout, a.dout, a.sdo, a.B, a.H, a.T, D, C::BQ);
  if (err == cudaSuccess) err = tensor_map(&m.k, a.k, a.sk, a.B, a.Hkv, a.Tk, D, C::BN);
  if (err == cudaSuccess) err = tensor_map(&m.v, a.v, a.sv, a.B, a.Hkv, a.Tk, D, C::BN);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.T + C::BQ - 1) / C::BQ);
  return launch_hopper(flash_bwd_dq_hopper<D>, grid, Roles<C::NWG>::kThreads, C::smem, stream,
                       a, m);
}

}  // namespace hopper

}  // namespace lxt

// dtype: 0 float32, 1 bfloat16, 2 float16. Each returns the cudaError_t of
// its launch.
// The mma.sync body of flash_bwd_dq at every (dtype, head dim): the body
// bf16 at head dim 64, 128 and 256 ran before its Hopper body, kept callable
// so that chip_smoke.py can time the two side by side.
extern "C" int lxt_flash_bwd_dq_mma(const lxt::FlashArgs* a, int dtype, int head_dim,
                                    void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + head_dim) {
    case 64: return launch_bwd_dq<float, 64>(*a, s);
    case 128: return launch_bwd_dq<float, 128>(*a, s);
    case 256: return launch_bwd_dq<float, 256>(*a, s);
    case 1064: return launch_bwd_dq<bf16, 64>(*a, s);
    case 1128: return launch_bwd_dq<bf16, 128>(*a, s);
    case 1256: return launch_bwd_dq<bf16, 256>(*a, s);
    case 2064: return launch_bwd_dq<f16, 64>(*a, s);
    case 2128: return launch_bwd_dq<f16, 128>(*a, s);
    case 2256: return launch_bwd_dq<f16, 256>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int lxt_flash_bwd_dq(const lxt::FlashArgs* a, int dtype, int head_dim,
                                void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + head_dim) {
    case 1064: return hopper::launch_bwd_dq<64>(*a, s);
    case 1128: return hopper::launch_bwd_dq<128>(*a, s);
    case 1256: return hopper::launch_bwd_dq<256>(*a, s);
    default: return lxt_flash_bwd_dq_mma(a, dtype, head_dim, stream);
  }
}

// The mma.sync body of flash_bwd_dkv at every (dtype, head dim) but bf16 at
// 64 and 128: the body bf16 at head dim 256 ran before its Hopper body, kept
// callable so that chip_smoke.py can time the two side by side.
extern "C" int lxt_flash_bwd_dkv_mma(const lxt::FlashArgs* a, int dtype, int head_dim,
                                     void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + head_dim) {
    case 64: return launch_bwd_dkv<float, 64>(*a, s);
    case 128: return launch_bwd_dkv<float, 128>(*a, s);
    case 256: return launch_bwd_dkv<float, 256>(*a, s);
    case 1256: return launch_bwd_dkv<bf16, 256>(*a, s);
    case 2064: return launch_bwd_dkv<f16, 64>(*a, s);
    case 2128: return launch_bwd_dkv<f16, 128>(*a, s);
    case 2256: return launch_bwd_dkv<f16, 256>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int lxt_flash_bwd_dkv(const lxt::FlashArgs* a, int dtype, int head_dim,
                                 void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + head_dim) {
    case 1064: return hopper::launch_bwd_dkv<64>(*a, s);
    case 1128: return hopper::launch_bwd_dkv<128>(*a, s);
    case 1256: return hopper::launch_bwd_dkv256(*a, s);
    default: return lxt_flash_bwd_dkv_mma(a, dtype, head_dim, stream);
  }
}
