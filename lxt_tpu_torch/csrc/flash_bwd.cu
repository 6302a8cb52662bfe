// K2: flash-attention backward for Hopper (sm_90a), as two kernels.
//
// Replaces the Pallas TPU kernels in lxt_tpu/ops/flash_attention.py:
// _fused_bwd_kernel and _fused_bwd_kernel_split (one kv block, launched by
// _fused_bwd) and _dq_kernel with _dkv_kernel (launched by _split_bwd).
// From the forward's lse and Δ = rowsum(out∘do) (computed outside, as
// lxt_tpu's _make_delta does):
//   p = exp(s − lse), dv = pᵀ·do, dp = do·vᵀ, ds = p∘(dp − Δ),
//   dq = ds·k·scale, dk = dsᵀ·q·scale,
// with dk/dv summed over each GQA group and the transposed RoPE rotation
// applied to dq and dk. Rows with lse <= −5e29 (no visible key) give p = 0.
//
// What bounds it on the H100: five products per score (against two in the
// forward), ~86 GFLOP at the main path's shapes (B 8, H 32 / Hkv 4, T 1024,
// head dim 64, bf16, causal), again far above the card's ridge: the tensor
// cores and the elementwise work per score are the roofline bound, not
// device memory. This first version reaches neither: loads are not
// overlapped with the products, and flash_bwd_dkv's causal CTAs carry
// unequal work (PERF.md has the times).
//
// Design: the usual split into a kv-major and a q-major kernel, so that
// every output is written once by one CTA — no atomics, deterministic.
// - flash_bwd_dkv: one CTA per (b, kv head, 64-row kv tile); each warp owns
//   16 kv rows and accumulates dk and dv in registers while the CTA loops
//   over the n_rep q heads of the group and over the visible q tiles.
// - flash_bwd_dq: one CTA per (b, h, 64-row q tile); each warp owns 16 q
//   rows and accumulates dq over the visible kv tiles.
// Both recompute p from lse (no probabilities are stored), skip fully
// masked tiles, and pass p and ds through per-warp shared strips in the
// activation dtype for the next product, as the TPU kernels cast them.
// Products use mma.sync (bf16) with fp32 accumulation; wgmma, TMA and
// pipelined loads are later work.
#include "flash_common.cuh"

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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lse = a.lse[stat0 + row0 + 8 * r];
    dead[r] = lse <= kNegInf / 2;
    lse2[r] = lse * kLog2e;
    delta[r] = a.delta[stat0 + row0 + 8 * r];
  }
  float dq[D / 8][4] = {};

  for (int k0 = 0; k0 < a.T; k0 += C::BN) {
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
  return launch(flash_bwd_dkv_kernel<T, D>, dim3(a.T / C::BM, a.Hkv, a.B), C::smem_dkv, stream,
                a);
}

}  // namespace lxt

// dtype: 0 float32, 1 bfloat16. Each returns the cudaError_t of its launch.
extern "C" int lxt_flash_bwd_dq(const lxt::FlashArgs* a, int dtype, int head_dim,
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
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int lxt_flash_bwd_dkv(const lxt::FlashArgs* a, int dtype, int head_dim,
                                 void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + head_dim) {
    case 64: return launch_bwd_dkv<float, 64>(*a, s);
    case 128: return launch_bwd_dkv<float, 128>(*a, s);
    case 256: return launch_bwd_dkv<float, 256>(*a, s);
    case 1064: return launch_bwd_dkv<bf16, 64>(*a, s);
    case 1128: return launch_bwd_dkv<bf16, 128>(*a, s);
    case 1256: return launch_bwd_dkv<bf16, 256>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}
