// Fused InstanceNorm epilogue of the int8 serving path, for sm_90a.
//
// Replaces the TPU kernel cycle_depth_estimation_tpu/ops/pallas/
// int8_epilogue.py (fused_in_epilogue; body _kernel, _epilogue_math,
// _pad_sp_kernel). On an NHWC conv output y (int32 accumulator, or bf16 at
// the up1 site), per (n, c):
//
//   mean, var = fp32 one-pass statistics over H×W
//   z = (y − mean)·rsqrt(var + eps)  [+ residual | ReLU]
//   q = clip(rint(z·inv_scale), ±127) as int8, reflect/edge-padded by `pad`
//   z also stored as bf16 when asked (keep_float), unpadded
//
// With q == nullptr only z is written (the float-only sites).
//
// Bound on the H100: bytes (a few flops per element). Design: one block per
// (sample, tile of 8 channels). Threads are laid out 8 channels × 128 pixel
// lanes, so a warp reads 4 neighbouring pixels × 8 channels: full 32-byte
// sectors for int32 input. Pass 1 accumulates per-thread fp32 partial sums,
// reduced across the pixel lanes in shared memory. Pass 2 walks the padded
// output, maps each position to its reflected/clamped source pixel, re-reads
// y (and the residual) and writes q and z. That is two reads of y; a single
// read, or fusing this into the int8 conv's epilogue, is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 8;   // channels per block
constexpr int kLanes = 128;    // pixel lanes per block

__device__ __forceinline__ float to_float(int32_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// jnp.pad semantics: 'reflect' mirrors without repeating the edge,
// 'edge' repeats it. Valid for pad < size.
__device__ __forceinline__ int source_index(int i, int size, int edge) {
  if (edge) return i < 0 ? 0 : (i >= size ? size - 1 : i);
  if (i < 0) return -i;
  if (i >= size) return 2 * (size - 1) - i;
  return i;
}

template <typename T>
__global__ void __launch_bounds__(kChannels * kLanes)
in_epilogue_kernel(const T* __restrict__ y,
                   const __nv_bfloat16* __restrict__ residual,
                   int8_t* __restrict__ q, __nv_bfloat16* __restrict__ z,
                   int h, int w, int c, float inv_scale, int relu, int pad,
                   int edge, float eps) {
  __shared__ float s1[kLanes][kChannels];
  __shared__ float s2[kLanes][kChannels];
  __shared__ float s_mean[kChannels];
  __shared__ float s_rstd[kChannels];

  const int tc = threadIdx.x;  // channel within the tile
  const int lane = threadIdx.y;
  const int n = blockIdx.x;
  const int ch = blockIdx.y * kChannels + tc;
  const bool active = ch < c;
  const int hw = h * w;
  const size_t plane = (size_t)n * hw * c;

  float a1 = 0.f, a2 = 0.f;
  if (active) {
#pragma unroll 4
    for (int p = lane; p < hw; p += kLanes) {
      float v = to_float(y[plane + (size_t)p * c + ch]);
      a1 += v;
      a2 += v * v;
    }
  }
  s1[lane][tc] = a1;
  s2[lane][tc] = a2;
  __syncthreads();
  if (lane == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < kLanes; ++l) {
      t1 += s1[l][tc];
      t2 += s2[l][tc];
    }
    float mean = t1 / (float)hw;
    float var = t2 / (float)hw - mean * mean;
    s_mean[tc] = mean;
    s_rstd[tc] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  if (!active) return;
  const float mean = s_mean[tc];
  const float rstd = s_rstd[tc];

  if (q == nullptr) pad = 0;
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const size_t qplane = (size_t)n * hp * wp * c;
  for (int o = lane; o < hp * wp; o += kLanes) {
    const int oh = o / wp, ow = o - (o / wp) * wp;
    const int ih = source_index(oh - pad, h, edge);
    const int iw = source_index(ow - pad, w, edge);
    const size_t src = plane + ((size_t)ih * w + iw) * c + ch;
    float v = (to_float(y[src]) - mean) * rstd;
    if (residual != nullptr) {
      v += __bfloat162float(residual[src]);
    } else if (relu) {
      v = fmaxf(v, 0.f);
    }
    if (q != nullptr) {
      float r = fminf(fmaxf(rintf(v * inv_scale), -127.f), 127.f);
      q[qplane + (size_t)o * c + ch] = (int8_t)r;
    }
    const bool interior = oh >= pad && oh < pad + h && ow >= pad && ow < pad + w;
    if (z != nullptr && interior) z[src] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// y_is_bf16 selects the input type (0: int32, 1: bf16). residual, q and z
// may be null. Returns cudaGetLastError() after the launch.
extern "C" int int8_epilogue(const void* y, int y_is_bf16,
                             const void* residual, void* q, void* z, int n,
                             int h, int w, int c, float inv_scale, int relu,
                             int pad, int edge, float eps, void* stream) {
  dim3 grid(n, (c + kChannels - 1) / kChannels);
  dim3 block(kChannels, kLanes);
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* res = (const __nv_bfloat16*)residual;
  if (y_is_bf16) {
    in_epilogue_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)y, res, (int8_t*)q, (__nv_bfloat16*)z, h, w, c,
        inv_scale, relu, pad, edge, eps);
  } else {
    in_epilogue_kernel<int32_t><<<grid, block, 0, s>>>(
        (const int32_t*)y, res, (int8_t*)q, (__nv_bfloat16*)z, h, w, c,
        inv_scale, relu, pad, edge, eps);
  }
  return (int)cudaGetLastError();
}
