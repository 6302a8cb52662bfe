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
// bound. Each thread rotates 16 bytes of both halves of one row, with
// 16-byte loads and stores; the output is contiguous [B, H, T, D].
#include "flash_common.cuh"

namespace lxt {

template <typename T>
__global__ void __launch_bounds__(256) rope_rotate_kernel(
    const T* x, long long sb, long long sh, long long st, const T* cos, const T* sin,
    T* out, int H, int T_len, int D, long long items) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = D / 2 / kVec;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= items) return;
  const long long row = i / chunks;
  const int c = (int)(i % chunks) * kVec, half = D / 2;
  const int t = (int)(row % T_len);
  const long long bh = row / T_len;
  const T* xr = x + (bh / H) * sb + (bh % H) * sh + t * st;
  const T* cr = cos + (long long)t * D;
  const T* sr = sin + (long long)t * D;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  const uint4* cv = reinterpret_cast<const uint4*>(cr);
  const uint4* sv = reinterpret_cast<const uint4*>(sr);
  uint4 x1 = xv[c / kVec], x2 = xv[(c + half) / kVec];
  rope_vec<T>(x1, x2, cv[c / kVec], cv[(c + half) / kVec], sv[c / kVec], sv[(c + half) / kVec]);
  uint4* ov = reinterpret_cast<uint4*>(out + row * D);
  ov[c / kVec] = x1;
  ov[(c + half) / kVec] = x2;
}

template <typename T>
cudaError_t launch_rope(const void* x, long long sb, long long sh, long long st,
                        const void* cos, const void* sin, void* out, int B, int H, int T_len,
                        int D, cudaStream_t stream) {
  const long long items = (long long)B * H * T_len * (D / 2 / (16 / (int)sizeof(T)));
  const int threads = 256;
  const unsigned blocks = (unsigned)((items + threads - 1) / threads);
  rope_rotate_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), sb, sh, st, static_cast<const T*>(cos),
      static_cast<const T*>(sin), static_cast<T*>(out), H, T_len, D, items);
  return cudaGetLastError();
}

}  // namespace lxt

// x [B, H, T, D] with element strides (sb, sh, st) and a contiguous last
// dim; cos/sin [T, D] contiguous; out [B, H, T, D] contiguous. dtype: 0
// float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int lxt_rope_rotate(const void* x, long long sb, long long sh, long long st,
                               const void* cos, const void* sin, void* out, int B, int H,
                               int T, int D, int dtype, void* stream) {
  using namespace lxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0) return cudaErrorInvalidValue;
  if (dtype == 1) return launch_rope<bf16>(x, sb, sh, st, cos, sin, out, B, H, T, D, s);
  if (dtype == 0) return launch_rope<float>(x, sb, sh, st, cos, sin, out, B, H, T, D, s);
  return cudaErrorInvalidValue;
}
