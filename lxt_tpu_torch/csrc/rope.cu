// The RoPE rotation pass for the Hopper bodies of K1 and K2 (sm_90a).
//
// Replaces the in-kernel rotation of the Pallas TPU kernels
// (_rope_block in lxt_tpu/ops/flash_attention.py, applied to every q and k
// block a grid step loads): out = x * cos + rotate_half(x) * sin, each
// product and the sum rounded to the activation dtype as rope_tile and
// models/common.apply_rope do, so the result is bit-identical to both.
// K1's Hopper body reads k rotated once per call from this pass instead of
// rotating every k tile in each of the up to H/Hkv * T/128 CTAs that read
// it; flash_bwd_dq's Hopper body reads k, and flash_bwd_dkv's q, rotated
// by it.
//
// What bounds it: it moves 2 bytes in and out per element plus the tables
// and does three FLOPs an element, so device memory (3.35 TB/s) is the
// bound. The design keeps the memory system busy and the threads' own
// work small:
// - one CTA per (b, run of positions t, batch of kHeads heads); its threads
//   own (t, 16-byte chunk of the first half of the row). The model hands
//   over head-split views ([B, T, H, D] in memory), where the H rows of one
//   (b, t) are H * D contiguous elements.
// - a thread loads its cos/sin chunks of row t once, into registers, and
//   rotates that chunk of each head of its batch with them (the tables are
//   read once per (b, t, batch) instead of once per (b, h, t)).
// - every load of the batch (2 x 16 bytes a head) is issued before the
//   first rotation, so each thread keeps up to kHeads * 32 bytes in flight;
//   stores are 16-byte stores into the contiguous [B, H, T, D] output.
//   Batches of 4 heads ran faster on the H100 than batches of 8 or 16
//   (fewer registers, more CTAs resident) and than 256-thread CTAs.
// - indexing is 32-bit within the CTA, with the (b, t) and head bases in
//   64 bits: no division or modulo beyond one by a power of two.
#include "flash_common.cuh"

namespace lxt {

constexpr int kRopeThreads = 128;
constexpr int kHeads = 4;  // heads a CTA rotates, their loads in flight together

template <typename T, int D>
__global__ void __launch_bounds__(kRopeThreads) rope_rotate_kernel(
    const T* __restrict__ x, long long sb, long long sh, long long st,
    const T* __restrict__ cos, const T* __restrict__ sin, T* __restrict__ out, int H,
    int T_len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / 2 / kVec;          // 16-byte chunks of a half row
  constexpr int kRun = kRopeThreads / kChunks;   // positions per CTA
  const int t = blockIdx.x * kRun + threadIdx.x / kChunks;
  if (t >= T_len) return;
  const int c = threadIdx.x % kChunks;
  const int b = blockIdx.y, h0 = blockIdx.z * kHeads;
  const uint4* cv = reinterpret_cast<const uint4*>(cos + (long long)t * D);
  const uint4* sv = reinterpret_cast<const uint4*>(sin + (long long)t * D);
  const uint4 c1 = cv[c], c2 = cv[c + kChunks], s1 = sv[c], s2 = sv[c + kChunks];
  const T* xt = x + b * sb + t * st + h0 * sh;
  const long long so = (long long)T_len * D;  // head stride of the output
  T* ot = out + ((long long)b * H + h0) * so + (long long)t * D;
  uint4 x1[kHeads] = {}, x2[kHeads] = {};
#pragma unroll
  for (int u = 0; u < kHeads; ++u) {
    if (h0 + u < H) {
      const uint4* xv = reinterpret_cast<const uint4*>(xt + u * sh);
      x1[u] = xv[c];
      x2[u] = xv[c + kChunks];
    }
  }
#pragma unroll
  for (int u = 0; u < kHeads; ++u) {
    if (h0 + u < H) {
      rope_vec<T>(x1[u], x2[u], c1, c2, s1, s2);
      uint4* ov = reinterpret_cast<uint4*>(ot + u * so);
      ov[c] = x1[u];
      ov[c + kChunks] = x2[u];
    }
  }
}

template <typename T, int D>
cudaError_t launch_rope_dim(const void* x, long long sb, long long sh, long long st,
                            const void* cos, const void* sin, void* out, int B, int H,
                            int T_len, cudaStream_t stream) {
  constexpr int kRun = kRopeThreads / (D / 2 / (16 / (int)sizeof(T)));
  const dim3 grid((unsigned)((T_len + kRun - 1) / kRun), (unsigned)B,
                  (unsigned)((H + kHeads - 1) / kHeads));
  rope_rotate_kernel<T, D><<<grid, kRopeThreads, 0, stream>>>(
      static_cast<const T*>(x), sb, sh, st, static_cast<const T*>(cos),
      static_cast<const T*>(sin), static_cast<T*>(out), H, T_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rope(const void* x, long long sb, long long sh, long long st,
                        const void* cos, const void* sin, void* out, int B, int H, int T_len,
                        int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_rope_dim<T, 64>(x, sb, sh, st, cos, sin, out, B, H, T_len, stream);
    case 128: return launch_rope_dim<T, 128>(x, sb, sh, st, cos, sin, out, B, H, T_len, stream);
    case 256: return launch_rope_dim<T, 256>(x, sb, sh, st, cos, sin, out, B, H, T_len, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace lxt

// x [B, H, T, D] with element strides (sb, sh, st) and a contiguous last
// dim; cos/sin [T, D] contiguous; out [B, H, T, D] contiguous; D 64, 128 or
// 256. dtype: 0 float32, 1 bfloat16, 2 float16. Returns the cudaError_t of
// the launch.
extern "C" int lxt_rope_rotate(const void* x, long long sb, long long sh, long long st,
                               const void* cos, const void* sin, void* out, int B, int H,
                               int T, int D, int dtype, void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 65535 || H > 65535 * kHeads) return cudaErrorInvalidValue;
  if (dtype == 1) return launch_rope<bf16>(x, sb, sh, st, cos, sin, out, B, H, T, D, s);
  if (dtype == 0) return launch_rope<float>(x, sb, sh, st, cos, sin, out, B, H, T, D, s);
  if (dtype == 2) return launch_rope<f16>(x, sb, sh, st, cos, sin, out, B, H, T, D, s);
  return cudaErrorInvalidValue;
}
