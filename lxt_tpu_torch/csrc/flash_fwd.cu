// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in lxt_tpu/ops/flash_attention.py:
// _fwd_kernel, _fwd_kernel_single (one kv block) and
// _fwd_kernel_single_split (the causal diagonal split), launched by _fwd.
// All three compute one function: out = softmax(q k^T * scale + mask) v and
// the natural-log logsumexp of each row, by online softmax in the exp2
// domain. Rows with no visible key give out 0 and lse -1e30.
//
// What bounds it on the H100: at the main path's shapes (B 8, H 32 / Hkv 4,
// T 1024, head dim 64, bf16, causal) it does ~34 GFLOP of products on ~0.1
// GB of q/k/v/out, far above the card's ~295 FLOP/byte ridge, so the
// roofline bound is the tensor cores and, at head dim 64, the exp2 and
// max/sum work per score on the FP32 and special-function units. This
// first version reaches neither: its loads are not overlapped with the
// products, so it is bound by load latency (PERF.md has the times).
//
// Design: one CTA per (b, h, 64-row q tile); the 4 warps own 16 q rows each
// and loop over the kv tiles (a loop in the block replaces the TPU's
// sequential kv grid axis; blocks run in any order and share nothing).
// Fully masked kv tiles are skipped and fully visible ones skip the
// per-element mask, so a causal row pays for about half the kv span. GQA
// reads kv head h / n_rep in place; k/v are never repeated. RoPE rotates
// the q and k tiles in shared memory after the load. Products use
// mma.sync (bf16) with fp32 accumulation; p goes through shared memory in
// bf16 for the p·v product, as the TPU kernel casts p to v's dtype. Loads
// are plain 16-byte vectors with no pipelining: cp.async/TMA double
// buffering, wgmma and warp specialisation are the next steps for speed.
#include "flash_common.cuh"

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

  for (int k0 = 0; k0 < a.T; k0 += C::BK) {
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

}  // namespace lxt

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int lxt_flash_fwd(const lxt::FlashArgs* a, int dtype, int head_dim,
                             void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + head_dim) {
    case 64: return launch_fwd<float, 64>(*a, s);
    case 128: return launch_fwd<float, 128>(*a, s);
    case 256: return launch_fwd<float, 256>(*a, s);
    case 1064: return launch_fwd<bf16, 64>(*a, s);
    case 1128: return launch_fwd<bf16, 128>(*a, s);
    case 1256: return launch_fwd<bf16, 256>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}
