// Shared pieces of the flash-attention kernels K1 (flash_fwd.cu) and K2
// (flash_bwd.cu): the argument block, tile loads, in-kernel RoPE, the masks
// and the warp-level matrix product.
//
// Work split: a CTA has 4 warps; each warp owns 16 rows of the tile the CTA
// holds (q rows in flash_fwd and flash_bwd_dq, kv rows in flash_bwd_dkv).
// Products run per warp on 16-row strips: bf16 and float16 through
// mma.sync.m16n8k16 (fp32 accumulate), fp32 through FMAs that own the same
// accumulator fragment, so the softmax and masking code is shared by all
// three types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lxt {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float kNegInf = -1e30f;  // masked score / empty-row lse
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kNoPad = 1 << 30;    // kv_end when there is no right padding
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;          // rows of a warp's strip (the mma M)
constexpr int kTile = kWarps * kRows;  // rows of a CTA's own tile (64)

// Mirror of lxt_tpu_torch.ops.flash_attention._FlashArgs (ctypes). Strides
// are in elements, (batch, head, time) for each tensor; the head dim is
// contiguous. Unused pointers are null.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;       // the forward's out (bwd_dq reads it for Δ)
  const float* lse;
  const float* delta;    // Δ = rowsum(out∘do) − dlse, as bwd_dq wrote it (bwd_dkv)
  const float* dlse;     // [B, H, T] lse cotangent (bwd_dq) or null
  const void* cos;       // [T, D] rope tables in the activation dtype (T == Tk)
  const void* sin;
  const int* kv_begin;   // [B] or null
  const int* kv_end;     // [B] or null
  void* out0;            // out (fwd), dq (bwd_dq), dk (bwd_dkv)
  void* out1;            // dv (bwd_dkv)
  float* lse_out;        // [B, H, T]: lse (fwd), Δ (bwd_dq)
  long long sq[3], sk[3], sv[3], sdo[3], sout[3], so0[3], so1[3];
  int B, H, Hkv;
  int T, Tk;             // rows of q, do, out, dq, lse, Δ; rows of k, v, dk, dv
  int window, causal;
  int q_start, k_start;  // global positions of query row 0 and key row 0
  float scale, scale_log2;  // scale, and scale * log2(e)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ f16 from_f<f16>(float x) {
  return __float2half_rn(x);
}

// Shared-memory row pitch: 16 bytes of padding keeps 16-byte row alignment
// and spreads the 8 row groups of a fragment load over distinct banks.
template <typename T, int W>
__host__ __device__ constexpr int pitch() { return W + 16 / (int)sizeof(T); }

// Copy rows [0, R) x [0, D) of a global tile (row stride in elements) into
// shared memory, 16 bytes per thread and step.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long row_stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int P = pitch<T, D>();
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    *reinterpret_cast<uint4*>(s + r * P + c) =
        *reinterpret_cast<const uint4*>(g + r * row_stride + c);
  }
}

// HF rotate-half RoPE on a shared tile whose row r sits at position pos0 + r:
// x * cos + rotate_half(x) * sin, each product and the sum rounded to T as
// the activation-dtype rotation of lxt_tpu does.
template <typename T, int D, int R>
__device__ __forceinline__ void rope_tile(T* s, const T* cos, const T* sin, int pos0) {
  constexpr int P = pitch<T, D>();
  constexpr int kHalf = D / 2;
  for (int i = threadIdx.x; i < R * kHalf; i += kThreads) {
    const int r = i / kHalf, c = i % kHalf;
    const T* cr = cos + (long long)(pos0 + r) * D;
    const T* sr = sin + (long long)(pos0 + r) * D;
    const float x1 = to_f(s[r * P + c]), x2 = to_f(s[r * P + c + kHalf]);
    const float a1 = to_f(from_f<T>(x1 * to_f(cr[c])));
    const float b1 = to_f(from_f<T>(-x2 * to_f(sr[c])));
    const float a2 = to_f(from_f<T>(x2 * to_f(cr[c + kHalf])));
    const float b2 = to_f(from_f<T>(x1 * to_f(sr[c + kHalf])));
    s[r * P + c] = from_f<T>(a1 + b1);
    s[r * P + c + kHalf] = from_f<T>(a2 + b2);
  }
}

// The same rotation on 16 bytes of each half of a row: x1 holds columns
// c.., x2 columns c + D/2.., and (c1, s1), (c2, s2) the tables at those
// columns. __fmul_rn / __fadd_rn forbid FMA contraction, so float32 rounds
// as the separate PyTorch products and sum of models/common.apply_rope do.
template <typename T>
__device__ __forceinline__ void rope_vec(uint4& x1, uint4& x2, const uint4& c1,
                                         const uint4& c2, const uint4& s1, const uint4& s2) {
  constexpr int kVec = 16 / sizeof(T);
  const T* a = reinterpret_cast<const T*>(&x1);
  const T* b = reinterpret_cast<const T*>(&x2);
  const T* ca = reinterpret_cast<const T*>(&c1);
  const T* cb = reinterpret_cast<const T*>(&c2);
  const T* sa = reinterpret_cast<const T*>(&s1);
  const T* sb = reinterpret_cast<const T*>(&s2);
  alignas(16) T o1[kVec], o2[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float x = to_f(a[e]), y = to_f(b[e]);
    o1[e] = from_f<T>(__fadd_rn(to_f(from_f<T>(__fmul_rn(x, to_f(ca[e])))),
                                to_f(from_f<T>(__fmul_rn(-y, to_f(sa[e]))))));
    o2[e] = from_f<T>(__fadd_rn(to_f(from_f<T>(__fmul_rn(y, to_f(cb[e])))),
                                to_f(from_f<T>(__fmul_rn(x, to_f(sb[e]))))));
  }
  x1 = *reinterpret_cast<const uint4*>(o1);
  x2 = *reinterpret_cast<const uint4*>(o2);
}

// The transpose of the RoPE rotation (its vjp) on fp32 accumulator fragments
// of a 16 x D strip: column c pairs with c + D/2, which the same lane holds
// in n-tile nt + D/16. `row0` is the position of the lane's first row.
template <typename T, int D>
__device__ __forceinline__ void rope_transpose(float (&acc)[D / 8][4], const T* cos,
                                               const T* sin, int row0) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long pos = row0 + 8 * (e / 2);
      const int c = nt * 8 + 2 * t + (e & 1), c2 = c + D / 2;
      const float x1 = acc[nt][e], x2 = acc[nt + D / 16][e];
      acc[nt][e] = x1 * to_f(cos[pos * D + c]) + x2 * to_f(sin[pos * D + c2]);
      acc[nt + D / 16][e] = x2 * to_f(cos[pos * D + c2]) - x1 * to_f(sin[pos * D + c]);
    }
  }
}

// Causal / sliding-window / padding mask in global positions: key j is
// visible from query i when j > i - window, kv_begin <= j < kv_end and, if
// causal, j <= i. Query row i of a call sits at global position i + q_start
// and key row j at j + k_start; the mask works in the call's key rows: query
// row i stands at key row i + shift (shift = q_start - k_start), and kv0, kv1
// are the valid keys moved by -k_start and cut at Tk. Every method takes and
// returns the call's own row indices.
struct Mask {
  int window, kv0, kv1, shift;
  bool causal;

  __device__ __forceinline__ bool allowed(int i, int j) const {
    const int p = i + shift;
    return j > p - window && j >= kv0 && j < kv1 && (!causal || j <= p);
  }
  // the tile [q0, q0 + nq) x [k0, k0 + nk) is entirely masked
  __device__ __forceinline__ bool skip(int q0, int nq, int k0, int nk) const {
    const int p0 = q0 + shift;
    return k0 + nk - 1 <= p0 - window || k0 + nk - 1 < kv0 || k0 >= kv1 ||
           (causal && k0 > p0 + nq - 1);
  }
  // the visible keys [lo, hi) of query i, and the visible queries [lo, hi)
  // of key j: the same test as allowed() as two bounds
  __device__ __forceinline__ void key_span(int i, int& lo, int& hi) const {
    const int p = i + shift;
    lo = max(p - window + 1, kv0);
    hi = causal ? min(p + 1, kv1) : kv1;
  }
  __device__ __forceinline__ void query_span(int j, int& lo, int& hi) const {
    lo = causal ? j - shift : -kNoPad;
    hi = j >= kv0 && j < kv1 ? j + window - shift : lo;
  }
  // the tile is entirely visible, so no element needs the mask
  __device__ __forceinline__ bool interior(int q0, int nq, int k0, int nk) const {
    const int p0 = q0 + shift;
    return k0 > p0 + nq - 1 - window && k0 >= kv0 && k0 + nk - 1 < kv1 &&
           (!causal || k0 + nk - 1 <= p0);
  }
};

// keys at or past Tk do not exist: a kv tile may run past Tk (the Hopper K1
// body's 128-row kv tiles at Tk % 128 == 64), and its rows there are masked
__device__ __forceinline__ Mask make_mask(const FlashArgs& a, int b) {
  return Mask{a.window, (a.kv_begin ? a.kv_begin[b] : 0) - a.k_start,
              min((a.kv_end ? a.kv_end[b] : kNoPad) - a.k_start, a.Tk),
              a.q_start - a.k_start, a.causal != 0};
}

// ---------------------------------------------------------------------------
// warp-level product on accumulator fragments
//
// acc[NT][4] holds the m16n8 C fragments of a 16 x 8*NT strip: lane
// (g = lane/4, t = lane%4) owns rows g (elements 0, 1) and g + 8 (elements
// 2, 3), columns nt*8 + 2t and +1. warp_mma adds A (16 x K, row-major,
// pitch lda) times B (K x 8*NT); with B_NT the element (k, n) of B sits at
// B[n * ldb + k] (B given as rows of its transpose), otherwise at
// B[k * ldb + n].
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ uint32_t ld_u32(const T* p) {
  static_assert(sizeof(T) == 2, "two 16-bit elements");
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits16(bf16 x) { return __bfloat16_as_ushort(x); }
__device__ __forceinline__ uint32_t bits16(f16 x) { return __half_as_ushort(x); }

template <typename T>
__device__ __forceinline__ uint32_t pack16(T lo, T hi) {
  return bits16(lo) | (bits16(hi) << 16);
}

template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, bf16>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same_v<T, f16>, "bf16 or float16");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// bf16 and float16: one mma.sync per 16 x 8 x 16 block
template <bool B_NT, int NT, int K, typename T, std::enable_if_t<sizeof(T) == 2, int> = 0>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const T* A, int lda,
                                         const T* B, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    a[0] = ld_u32(A + g * lda + k0 + 2 * t);
    a[1] = ld_u32(A + (g + 8) * lda + k0 + 2 * t);
    a[2] = ld_u32(A + g * lda + k0 + 8 + 2 * t);
    a[3] = ld_u32(A + (g + 8) * lda + k0 + 8 + 2 * t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      uint32_t b0, b1;
      if constexpr (B_NT) {
        b0 = ld_u32(B + n * ldb + k0 + 2 * t);
        b1 = ld_u32(B + n * ldb + k0 + 8 + 2 * t);
      } else {
        b0 = pack16(B[(k0 + 2 * t) * ldb + n], B[(k0 + 2 * t + 1) * ldb + n]);
        b1 = pack16(B[(k0 + 8 + 2 * t) * ldb + n], B[(k0 + 9 + 2 * t) * ldb + n]);
      }
      mma_16816<T>(acc[nt], a, b0, b1);
    }
  }
}

// fp32: the same fragment ownership, one FMA per element and k (the fp32
// instances exist for parity checks against the fp32 plain versions)
template <bool B_NT, int NT, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A, int lda,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      float b0, b1;
      if constexpr (B_NT) {
        b0 = B[n * ldb + k];
        b1 = B[(n + 1) * ldb + k];
      } else {
        b0 = B[k * ldb + n];
        b1 = B[k * ldb + n + 1];
      }
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

// Write a 16 x 8*NT fragment strip to a per-warp shared tile (pitch ld) in T.
template <typename T, int NT>
__device__ __forceinline__ void store_strip(T* s, int ld, const float (&x)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * t;
    s[g * ld + c] = from_f<T>(x[nt][0]);
    s[g * ld + c + 1] = from_f<T>(x[nt][1]);
    s[(g + 8) * ld + c] = from_f<T>(x[nt][2]);
    s[(g + 8) * ld + c + 1] = from_f<T>(x[nt][3]);
  }
}

// Write a 16 x D strip to global rows (row stride in elements) starting at
// this warp's first row `g0`.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* g0, long long row_stride,
                                           const float (&x)[D / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    T* r0 = g0 + g * row_stride + c;
    T* r1 = g0 + (g + 8) * row_stride + c;
    r0[0] = from_f<T>(x[nt][0]);
    r0[1] = from_f<T>(x[nt][1]);
    r1[0] = from_f<T>(x[nt][2]);
    r1[1] = from_f<T>(x[nt][3]);
  }
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error ~2^-22,
// 2^-inf and 2^-1e30 give +0), one instruction
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the four lanes that share a fragment row
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float2 to_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 to_f2(const f16* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// Δ = rowsum(out∘do) of the two rows a lane's accumulator fragments hold
// (r0 and r0 + 8), as lxt_tpu's inline_delta computes it in the backward
// kernel: each lane multiplies out and do in fp32 at its own columns
// (8j + 2t and + 1) and the quad sums. `out` and `dout` point at row 0 of
// the head; row strides in elements. All lanes of the warp take part.
template <typename T, int D>
__device__ __forceinline__ void row_delta(const T* out, long long so, const T* dout,
                                          long long sdo, int r0, float (&delta)[2]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const T* o = out + (long long)(r0 + 8 * r) * so + 2 * t;
    const T* d = dout + (long long)(r0 + 8 * r) * sdo + 2 * t;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = to_f2(o + 8 * j), y = to_f2(d + 8 * j);
      acc += x.x * y.x + x.y * y.y;
    }
    delta[r] = row_sum(acc);
  }
}

// Set the kernel's dynamic shared memory and launch it on `stream`;
// returns the launch's error code.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const FlashArgs& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace lxt
