// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in lxt_tpu/ops/flash_attention.py:
// _fwd_kernel, _fwd_kernel_single (one kv block) and
// _fwd_kernel_single_split (the causal diagonal split), launched by _fwd for
// flash_attention and flash_attention_lse. All three compute one function:
// out = softmax(q k^T * scale + mask) v and the natural-log logsumexp of
// each row, by online softmax in the exp2 domain. Rows with no visible key
// give out 0 and lse -1e30. The masks run in global positions: the call's
// q_start / k_start offsets (a ring step's shards) shift the causal and
// window tests and kv_begin / kv_end compare with global key positions
// (Mask in flash_common.cuh). Under an offset a call may be entirely
// visible (keys wholly in the past) or entirely masked (wholly in the
// future, every row empty); the bodies below need nothing more for either,
// since every skip, span and interior test goes through Mask.
//
// What bounds it on the H100: at the paths' calls (B 8, H 32 / Hkv 4,
// T 1024, head dim 64; B 1, H 32 / Hkv 8, T 4096, head dim 128; Gemma-3-4B's
// B 1, H 8 / Hkv 4, T 4096, head dim 256, causal with and without a 1024
// window; bf16) it does 34, 137, 30 and 69 GFLOP of products on 50-100 MB
// of q/k/v/out, far above the card's ~295 FLOP/byte ridge: the tensor cores
// (989 TFLOP/s) are the roofline bound, and beside them the exp2 and
// max/sum work per score on the FP32 and special-function units, which at
// head dim 64 costs as much as the products.
//
// Two bodies; the switch at the end picks one by (dtype, head dim) only.
// The mma.sync body stays callable in bf16 at head dim 256
// (lxt_flash_fwd_mma), the control that chip_smoke.py times beside the
// Hopper body.
//
// The Hopper body (bf16 at head dim 64, 128 and 256, the paths' calls):
// - one CTA per (b, h, q tile of 64 rows per consumer warpgroup): three
//   warpgroups (192 rows) at head dim 64, two (128 rows) at 128 and 256,
//   whose accumulators are two and four times as wide (128 fp32 a thread
//   at 256), and one producer warpgroup that gives its registers to them
//   (setmaxnreg). The grid runs the q tiles last-first, so under the
//   causal mask the CTAs with the most kv tiles start first.
// - one producer thread TMA-loads the q tile once and keeps a ring of 4
//   (k, v) tile pairs (2 at head dim 256, where a pair of 64-row tiles is
//   64 KiB beside the 64 KiB q tile) in flight (128-byte swizzled, one
//   mbarrier pair per stage); rows past T read as zeros and are not stored.
// - s = q kᵀ is a wgmma m64n64k16 chain per warpgroup from shared memory;
//   p is rescaled, rounded to bf16 and kept in registers as the A operand
//   of the p·v chain (v MN-major from shared memory). The p·v chain of one
//   tile runs while the next tile's scores become probabilities.
// - the softmax is branch-free: masks are two bounds per row, applied only
//   on tiles the mask cuts, and exp2 is one ex2.approx each; empty rows give
//   out 0 and lse -1e30 as in the body below.
// - RoPE: q is rotated once, in shared memory, in the prologue (at head dim
//   256 in two batches of 32 rows, whose tables hold 64 registers a thread
//   instead of 128); k arrives rotated by the rotation pass (rope.cu), once
//   per call. This body never rotates k.
//
// The mma.sync body (float32 and float16): one CTA per (b, h, 64-row q
// tile); the 4 warps own 16 q rows each and loop over the kv tiles
// (a loop in the block replaces the TPU's sequential kv grid axis; blocks
// run in any order and share nothing). Fully masked kv tiles are skipped
// and fully visible ones skip the per-element mask. GQA reads kv head
// h / n_rep in place; k/v are never repeated. RoPE rotates the q and k
// tiles in shared memory after the load. Products use mma.sync (bf16,
// float16) or FMAs (float32) with fp32 accumulation; p goes through shared memory for
// the p·v product, as the TPU kernel casts p to v's dtype. Loads are plain
// 16-byte vectors with no pipelining.
#include "hopper.cuh"

namespace lxt {

template <typename T, int D>
struct FwdTiles {
  static constexpr int BQ = kTile;                  // q rows per CTA
  static constexpr int BK = D <= 128 ? 64 : 32;     // kv rows per step
  static constexpr int P = pitch<T, D>();
  static constexpr int PP = pitch<T, BK>();         // per-warp p strip
  static constexpr size_t smem = sizeof(T) * (BQ * P + 2 * BK * P + kWarps * kRows * PP);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  using C = FwdTiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + C::BQ * C::P;
  T* sV = sK + C::BK * C::P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  T* sP = sV + C::BK * C::P + warp * kRows * C::PP;

  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1] + q0 * a.sq[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const T* cos = static_cast<const T*>(a.cos);
  const T* sin = static_cast<const T*>(a.sin);
  const Mask mask = make_mask(a, b);

  load_tile<T, D, C::BQ>(sQ, qg, a.sq[2]);
  if (cos) {
    __syncthreads();
    rope_tile<T, D, C::BQ>(sQ, cos, sin, q0);
  }

  const int row0 = q0 + warp * kRows + g;  // this lane's rows: row0, row0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4] = {};

  for (int k0 = 0; k0 < a.Tk; k0 += C::BK) {
    if (mask.skip(q0, C::BQ, k0, C::BK)) continue;
    __syncthreads();  // the previous step's readers of sK/sV are done
    load_tile<T, D, C::BK>(sK, kg + k0 * a.sk[2], a.sk[2]);
    load_tile<T, D, C::BK>(sV, vg + k0 * a.sv[2], a.sv[2]);
    if (cos) {
      __syncthreads();
      rope_tile<T, D, C::BK>(sK, cos, sin, k0);
    }
    __syncthreads();

    float s[C::BK / 8][4] = {};
    warp_mma<true, C::BK / 8, D>(s, sQ + warp * kRows * C::P, C::P, sK, C::P);

    // scores in the exp2 domain; masked entries to -1e30
    const bool inner = mask.interior(q0, C::BQ, k0, C::BK);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < C::BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale_log2;
        if (!inner && !mask.allowed(row0 + 8 * (e / 2), k0 + nt * 8 + 2 * t + (e & 1)))
          x = kNegInf;
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], row_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < C::BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row fully masked so far has m = -1e30 and would get p = 1 on
        // its masked entries: its probabilities are 0
        const float mr = m[e / 2];
        const float p = mr <= kNegInf / 2 ? 0.f : exp2f(s[nt][e] - mr);
        s[nt][e] = p;
        sum[e / 2] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_sum(sum[r]);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    store_strip<T, C::BK / 8>(sP, C::PP, s);
    __syncwarp();
    warp_mma<false, D / 8, C::BK>(acc, sP, C::PP, sV, C::P);
    __syncwarp();
  }

  T* og = static_cast<T*>(a.out0) + b * a.so0[0] + h * a.so0[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const bool empty = l[r] <= 0.f;
    const float lsafe = empty ? 1.f : l[r];
    T* orow = og + qi * a.so0[2];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      orow[c] = from_f<T>(empty ? 0.f : acc[nt][2 * r] / lsafe);
      orow[c + 1] = from_f<T>(empty ? 0.f : acc[nt][2 * r + 1] / lsafe);
    }
    if (t == 0)
      a.lse_out[((long long)b * a.H + h) * a.T + qi] =
          empty ? kNegInf : (m[r] + log2f(lsafe)) * kLn2;
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const FlashArgs& a, cudaStream_t stream) {
  using C = FwdTiles<T, D>;
  return launch(flash_fwd_kernel<T, D>, dim3(a.T / C::BQ, a.H, a.B), C::smem, stream, a);
}

namespace hopper {

template <int D>
struct FwdTiles {
  // three consumer warpgroups at head dim 64, two at 128 and 256 (their
  // accumulators are two and four times as wide: 128 fp32 a thread at 256)
  static constexpr int NWG = D == 64 ? 3 : 2;
  // kv rows per step: 128 at head dim 64 (the softmax's fixed costs per step
  // weigh most there), 64 at 128 and 256 (shared memory)
  static constexpr int BK = D == 64 ? 128 : 64;
  // stages of the (k, v) ring: at head dim 256 a stage is 64 KiB beside the
  // 64 KiB q tile, so two fit the 227 KiB a block can use
  static constexpr int STAGES = D == 256 ? 2 : 4;
  static constexpr int BQ = 64 * NWG, PANELS = D / 64;
  static constexpr int Q_PANEL = BQ * kPanelBytes, KV_PANEL = BK * kPanelBytes;
  static constexpr int Q_BYTES = PANELS * Q_PANEL, KV_BYTES = PANELS * KV_PANEL;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // k, then v
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // barriers: q, then full and empty of each stage; 1024 bytes of slack
  // for aligning the dynamic shared memory
  static constexpr size_t smem = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

struct FwdMaps {
  CUtensorMap q, k, v;
};

template <int D>
__global__ void __launch_bounds__(Roles<FwdTiles<D>::NWG>::kThreads, 1)
    flash_fwd_hopper(const __grid_constant__ FlashArgs a, const __grid_constant__ FwdMaps m) {
  using C = FwdTiles<D>;
  using R = Roles<C::NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;
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
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int p = 0; p < C::PANELS; ++p)
        tma_load(sQ + p * C::Q_PANEL, &m.q, bar_q, 64 * p, q0, h, b);
      int it = 0;
      for (int k0 = 0; k0 < a.Tk; k0 += C::BK) {
        if (mask.skip(q0, nq, k0, C::BK)) continue;
        const int s = it % C::STAGES;
        const uint32_t n = it / C::STAGES;
        ++it;
        mbar_wait(&empty[s], (n & 1) ^ 1);
        unsigned char* sK = smem + C::Q_BYTES + s * C::STAGE_BYTES;
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
    mbar_wait(bar_q, 0);
    if (active && a.cos) {
      // in batches of 32 rows at head dim 256: the tables of all 64 rows
      // would hold 128 registers a thread
      constexpr int RR = D == 256 ? 32 : 64;
#pragma unroll
      for (int r0 = 0; r0 < 64; r0 += RR)
        rope_swizzled<D, RR, 128>(sQw + r0 * kPanelBytes, C::Q_PANEL,
                                  static_cast<const bf16*>(a.cos),
                                  static_cast<const bf16*>(a.sin), q0w + r0, threadIdx.x % 128);
      fence_proxy_async();
    }
    named_sync(1 + wg, 128);

    const int row0 = q0w + 16 * (warp % 4) + g;  // this lane's rows: row0, row0 + 8
    float m_[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[D / 8][4] = {};
    constexpr int NB = C::BK / 8;  // 8-column blocks of a score tile

    // the next kv tile this warpgroup computes on: the CTA's visible tiles
    // in the producer's order, releasing at once those all masked here
    int k0 = -C::BK, it = 0, s = 0;
    auto next_tile = [&]() -> bool {
      for (k0 += C::BK; k0 < a.Tk; k0 += C::BK) {
        if (mask.skip(q0, nq, k0, C::BK)) continue;
        s = it % C::STAGES;
        const uint32_t n = it / C::STAGES;
        ++it;
        mbar_wait(&full[s], n & 1);
        if (active && !mask.skip(q0w, 64, k0, C::BK)) return true;
        mbar_arrive(&empty[s]);
      }
      return false;
    };
    auto scores = [&](float (&sc)[NB][4]) {
      const unsigned char* sK = smem + C::Q_BYTES + s * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;  // the 16 columns inside a 64-column panel
        wgmma_ss<C::BK>(sc, desc(sQw + (kk / 4) * C::Q_PANEL + off, 16, 1024),
                        desc(sK + (kk / 4) * C::KV_PANEL + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    auto pv = [&](const uint32_t (&pa)[NB / 2][4], int stage) {
      const unsigned char* sV = smem + C::Q_BYTES + stage * C::STAGE_BYTES + C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], desc(sV + kk * 16 * kPanelBytes, C::KV_PANEL, 1024));
      wgmma_commit();
    };
    // the visible key columns of this lane's two rows
    int key_lo[2], key_hi[2];
    mask.key_span(row0, key_lo[0], key_hi[0]);
    mask.key_span(row0 + 8, key_lo[1], key_hi[1]);
    // scores -> probabilities in place (the exp2 domain, masked entries to
    // -1e30); updates m and l and returns each row's rescale of acc
    auto softmax = [&](float (&sc)[NB][4], float (&alpha)[2]) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= a.scale_log2;
      if (!mask.interior(q0w, 64, k0, C::BK)) {
        const int c0 = k0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 8 * j + (e & 1), r = e / 2;
            sc[j][e] = c >= key_lo[r] && c < key_hi[r] ? sc[j][e] : kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f}, base[2];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_[r], row_max(mx[r]));
        alpha[r] = exp2_fast(m_[r] - m_new);
        m_[r] = m_new;
        // a row fully masked so far has m = -1e30: subtracting 0 instead
        // sends its masked entries' probabilities to 2^-1e30 = 0, not 1
        base[r] = m_new <= kNegInf / 2 ? 0.f : m_new;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2_fast(sc[j][e] - base[e / 2]);
          sum[e / 2] += sc[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_sum(sum[r]);
    };

    if (next_tile()) {
      // p of the previous tile: its p·v product runs while the next tile's
      // scores become probabilities
      uint32_t pa[NB / 2][4];
      float alpha[2];
      {
        float sc[NB][4] = {};
        wgmma_fence();
        scores(sc);
        wgmma_wait<0>();
        fence_acc(sc);
        softmax(sc, alpha);
        to_a_operand(sc, pa);
      }
      int s_prev = s;
      while (next_tile()) {
        float sc[NB][4] = {};
        wgmma_fence();
        scores(sc);
        pv(pa, s_prev);
        wgmma_wait<1>();  // the scores; the previous p·v may still run
        fence_acc(sc);
        softmax(sc, alpha);
        wgmma_wait<0>();
        fence_acc(acc);
        fence_regs(pa);
        mbar_arrive(&empty[s_prev]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
        to_a_operand(sc, pa);
        s_prev = s;
      }
      wgmma_fence();
      pv(pa, s_prev);
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[s_prev]);
    }

    if (active) {
      bf16* og = static_cast<bf16*>(a.out0) + b * a.so0[0] + h * a.so0[1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        const bool empty_row = l[r] <= 0.f;
        const float inv = empty_row ? 0.f : 1.f / l[r];
        bf16* orow = og + qi * a.so0[2];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
              __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
        if (t == 0)
          a.lse_out[((long long)b * a.H + h) * a.T + qi] =
              empty_row ? kNegInf : (m_[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

template <int D>
cudaError_t launch_fwd(const FlashArgs& a, cudaStream_t stream) {
  using C = FwdTiles<D>;
  FwdMaps m;
  cudaError_t err = tensor_map(&m.q, a.q, a.sq, a.B, a.H, a.T, D, C::BQ);
  if (err == cudaSuccess) err = tensor_map(&m.k, a.k, a.sk, a.B, a.Hkv, a.Tk, D, C::BK);
  if (err == cudaSuccess) err = tensor_map(&m.v, a.v, a.sv, a.B, a.Hkv, a.Tk, D, C::BK);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.T + C::BQ - 1) / C::BQ);
  return launch_hopper(flash_fwd_hopper<D>, grid, Roles<C::NWG>::kThreads, C::smem, stream,
                       a, m);
}

}  // namespace hopper

}  // namespace lxt

// kernel: 0 K1, 1 flash_bwd_dq, 2 flash_bwd_dkv. 1 when (dtype, head_dim)
// runs that kernel's Hopper body, which reads k (K1, flash_bwd_dq) or q
// (flash_bwd_dkv) rotated by the rotation pass: bf16 at head dim 64, 128
// and 256 for all three. float32 and float16 run the mma.sync bodies, which
// rotate q and k themselves. The kernel argument stays so that a body can
// be routed on its own.
extern "C" int lxt_flash_hopper(int kernel, int dtype, int head_dim) {
  (void)kernel;
  return dtype == 1 && (head_dim == 64 || head_dim == 128 || head_dim == 256);
}

// dtype: 0 float32, 1 bfloat16, 2 float16. Each returns the cudaError_t of
// its launch.
// The mma.sync body of K1 at every (dtype, head dim) but bf16 at 64 and
// 128: the body bf16 at head dim 256 ran before its Hopper body, kept
// callable so that chip_smoke.py can time the two side by side.
extern "C" int lxt_flash_fwd_mma(const lxt::FlashArgs* a, int dtype, int head_dim,
                                 void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + head_dim) {
    case 64: return launch_fwd<float, 64>(*a, s);
    case 128: return launch_fwd<float, 128>(*a, s);
    case 256: return launch_fwd<float, 256>(*a, s);
    case 1256: return launch_fwd<bf16, 256>(*a, s);
    case 2064: return launch_fwd<f16, 64>(*a, s);
    case 2128: return launch_fwd<f16, 128>(*a, s);
    case 2256: return launch_fwd<f16, 256>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int lxt_flash_fwd(const lxt::FlashArgs* a, int dtype, int head_dim,
                             void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + head_dim) {
    case 1064: return hopper::launch_fwd<64>(*a, s);
    case 1128: return hopper::launch_fwd<128>(*a, s);
    case 1256: return hopper::launch_fwd<256>(*a, s);
    default: return lxt_flash_fwd_mma(a, dtype, head_dim, stream);
  }
}
