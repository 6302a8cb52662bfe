// K3: NF4 dequantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _nf4_dequant_kernel in lxt_tpu/ops/quant.py
// (launched by nf4_dequant). For half-split packed codes q[l, K/2, N]
// (uint8) and per-block scales absmax[l, K/block, N] (float32) it writes
//   w[l, k, n] = NF4[nibble] * absmax[l, k / block, n]
// where rows k < K/2 take the low nibble of packed row k and rows k >= K/2
// the high nibble of packed row k - K/2. The product is taken in float32 and
// rounded once to the output type (round to nearest even), which is what
// the plain version (lxt_tpu_torch.ops.quant.dequantize) does: the kernel is
// bit-exact against it. Any K with K % block == 0 is taken, and a leading
// layer axis l (layer-stacked weights) is part of the grid.
//
// What bounds it on the H100: memory traffic. Per weight element it reads
// half a byte of codes and 4/block bytes of scales and writes 2 (bf16,
// float16) or 4 (float32) bytes, about 2.56 bytes per element in bf16, with
// no reuse: one coalesced pass at the card's bandwidth is the whole design.
// Each thread
// reads 16 contiguous packed bytes of one packed row with one 16-byte load
// (neighbouring threads, neighbouring bytes) and writes the 16 low-nibble
// values to row j and the 16 high-nibble values to row j + K/2 as 16-byte
// stores. The 8 warps of a block take 8 consecutive packed rows, which share
// their scale rows, so the repeated scale loads hit L1. The 16-entry
// codebook lives in registers: lane i of each warp holds entry i & 15 and a
// lookup is one warp shuffle. A ragged N (N % 16 != 0) or a misaligned base
// takes the scalar instance, which loads and stores each column under a mask.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lxt {

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

constexpr int kCols = 16;       // packed bytes (output columns) per thread
constexpr int kLanes = 32;      // threads along N in a block (one warp)
constexpr int kRowsPerBlock = 8;  // packed rows per block (one per warp)

__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(__half* dst, float x) { *dst = __float2half_rn(x); }

// two values rounded to a 16-bit type, packed low then high
__device__ __forceinline__ uint32_t pair(__nv_bfloat16*, float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ uint32_t pair(__half*, float lo, float hi) {
  return (uint32_t)__half_as_ushort(__float2half_rn(lo)) |
         ((uint32_t)__half_as_ushort(__float2half_rn(hi)) << 16);
}

// 16 consecutive output values as 16-byte stores (dst 16-byte aligned)
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
#pragma unroll
  for (int c = 0; c < kCols; c += 4)
    *reinterpret_cast<float4*>(dst + c) = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
}
template <typename OutT>
__device__ __forceinline__ void store_vec(OutT* dst, const float* v) {
  static_assert(sizeof(OutT) == 2, "bf16 or float16");
#pragma unroll
  for (int c = 0; c < kCols; c += 8)
    *reinterpret_cast<uint4*>(dst + c) =
        make_uint4(pair(dst, v[c], v[c + 1]), pair(dst, v[c + 2], v[c + 3]),
                   pair(dst, v[c + 4], v[c + 5]), pair(dst, v[c + 6], v[c + 7]));
}

// grid: (ceil(rows / 8), ceil(chunks / 32)); block: (32, 8). rows = l * K/2
// packed rows over all layers; chunks = ceil(N / 16).
template <typename OutT, bool kAligned>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
nf4_dequant_kernel(const uint8_t* __restrict__ q, const float* __restrict__ absmax,
                   OutT* __restrict__ out, int rows, int Kh, int N, int block) {
  // every lane reaches the shuffles below, so no thread returns early
  const float code = kNF4[threadIdx.x & 15];
  const int prow = blockIdx.x * kRowsPerBlock + threadIdx.y;
  const int n0 = (blockIdx.y * kLanes + threadIdx.x) * kCols;
  const bool live = prow < rows && n0 < N;
  const int layer = live ? prow / Kh : 0;
  const int j = live ? prow - layer * Kh : 0;
  const int64_t K = 2 * (int64_t)Kh;
  const int64_t srows = K / block;

  uint32_t packed[4] = {0u, 0u, 0u, 0u};
  const uint8_t* src = q + (int64_t)prow * N + n0;
  if (live) {
    if (kAligned) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      packed[0] = v.x; packed[1] = v.y; packed[2] = v.z; packed[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (n0 + c < N) packed[c >> 2] |= (uint32_t)src[c] << (8 * (c & 3));
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const uint32_t byte = (packed[c >> 2] >> (8 * (c & 3))) & 0xFFu;
      v[c] = __shfl_sync(0xffffffffu, code, half ? (int)(byte >> 4) : (int)(byte & 0xFu));
    }
    if (!live) continue;
    const int64_t row = j + half * (int64_t)Kh;            // row within the layer
    const float* s = absmax + ((int64_t)layer * srows + row / block) * N + n0;
    OutT* dst = out + ((int64_t)layer * K + row) * N + n0;
    if (kAligned) {
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 f = *reinterpret_cast<const float4*>(s + c);
        v[c] *= f.x; v[c + 1] *= f.y; v[c + 2] *= f.z; v[c + 3] *= f.w;
      }
      store_vec(dst, v);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (n0 + c < N) put(dst + c, v[c] * s[c]);
    }
  }
}

template <typename OutT>
int launch_nf4(const void* q, const void* absmax, void* out, int rows, int Kh,
               int N, int block, bool aligned, cudaStream_t stream) {
  const int chunks = (N + kCols - 1) / kCols;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock,
                  (chunks + kLanes - 1) / kLanes);
  const dim3 threads(kLanes, kRowsPerBlock);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const float*>(absmax);
  auto* op = static_cast<OutT*>(out);
  if (aligned)
    nf4_dequant_kernel<OutT, true><<<grid, threads, 0, stream>>>(qp, sp, op, rows, Kh, N, block);
  else
    nf4_dequant_kernel<OutT, false><<<grid, threads, 0, stream>>>(qp, sp, op, rows, Kh, N, block);
  return (int)cudaGetLastError();
}

}  // namespace lxt

// q [layers, Kh, N] uint8, absmax [layers, 2*Kh/block, N] float32, out
// [layers, 2*Kh, N] float32 (dtype 0), bfloat16 (dtype 1) or float16 (dtype
// 2). aligned != 0 promises N % 16 == 0 and 16-byte aligned q and absmax
// (out is fresh).
extern "C" int lxt_nf4_dequant(const void* q, const void* absmax, void* out,
                               int layers, int Kh, int N, int block, int dtype,
                               int aligned, void* stream) {
  using namespace lxt;
  const long long rows = (long long)layers * Kh;
  if (layers <= 0 || Kh <= 0 || N <= 0 || block <= 0 || (2LL * Kh) % block ||
      rows > (1LL << 31) - 1 - kRowsPerBlock ||
      (N + kCols - 1) / kCols > kLanes * 65535LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_nf4<float>(q, absmax, out, (int)rows, Kh, N, block, aligned != 0, s);
    case 1: return launch_nf4<__nv_bfloat16>(q, absmax, out, (int)rows, Kh, N, block, aligned != 0, s);
    case 2: return launch_nf4<__half>(q, absmax, out, (int)rows, Kh, N, block, aligned != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
