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
// Bound on the H100: bytes (about 9 flops for 5 to 9 bytes an element). The
// statistics must be whole before any output is written, so a block works
// in two passes, and what the design can do is move few bytes, in wide
// aligned pieces, from enough blocks to fill 132 SMs, with few instructions
// around them:
//
// * Vector access along C. A thread owns 4 neighbouring channels of a pixel:
//   one 16-byte load of int32 y (8 bytes of a bf16 y and of the residual),
//   one 4-byte store of q, one 8-byte store of z. The ct/4 threads of a pixel
//   sit side by side, so a warp touches whole 32-byte sectors.
// * The plane is split over a thread-block cluster. The S blocks of a cluster
//   share one (sample, tile of ct channels); each takes ceil(H/S) rows, sums
//   them (per-thread fp32 partials, warp shuffles, then a short sum over the
//   warps), and the blocks read each other's partial sums through
//   distributed shared memory, in rank order, so that all hold bit-identical
//   statistics. Each block then writes its own rows of q and z; the first
//   and the last block also write the padded border rows, whose source rows
//   they own (the launcher refuses a split where they would not).
// * One read of y for the rows that shared memory holds. Pass 1 brings the
//   first `staged` rows of a block in with cp.async, all copies in flight at
//   once, sums the other rows straight from device memory meanwhile, then
//   the staged ones; pass 2 reads the staged rows from shared memory and
//   only the others again from device memory (from L2, where y fits it).
//   How many rows to stage is the plan's trade: all of them is one read of
//   y, fewer lets more blocks share an SM and leaves more of it to L1.
// * Few instructions per element, because with that few bytes instruction
//   throughput is the next limit: no division per element (pass 2 walks the
//   block's own pixels with a row counter, the identity map, and only the
//   thin border goes through the reflect map), 32-bit offsets inside a
//   plane, mean and 1/std worked out once per channel, one convert for
//   round-and-clip. The residual's loads are started two pixels ahead of
//   the arithmetic.
//
// Channel tile, cluster size, threads, staged rows and shared-memory bytes
// are chosen per shape by plan_epilogue() in ops/kernels/int8_epilogue.py.
// Shapes the vector path cannot take (C not a multiple of 4, unaligned
// pointers) go to the generic kernel below: one block per (sample, 8
// channels), scalar access, two reads of y.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block may take

// jnp.pad semantics: 'reflect' mirrors without repeating the edge,
// 'edge' repeats it. Valid for pad < size.
__device__ __forceinline__ int source_index(int i, int size, int edge) {
  if (edge) return i < 0 ? 0 : (i >= size ? size - 1 : i);
  if (i < 0) return -i;
  if (i >= size) return 2 * (size - 1) - i;
  return i;
}

// ---------------------------------------------------------------------------
// The cluster kernel
// ---------------------------------------------------------------------------

// Four neighbouring channels as fp32, from device or shared memory.
__device__ __forceinline__ float4 load4(const int32_t* p) {
  const int4 t = *reinterpret_cast<const int4*>(p);
  return make_float4((float)t.x, (float)t.y, (float)t.z, (float)t.w);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(t.x << 16),
                     __uint_as_float(t.x & 0xffff0000u),
                     __uint_as_float(t.y << 16),
                     __uint_as_float(t.y & 0xffff0000u));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// clip(rint(x), ±127) == rint(clip(x, ±127)): the bounds are integers and
// rint is monotonic, so one convert (round to nearest even) does both.
__device__ __forceinline__ uint32_t quantize(float v, float inv_scale) {
  return (uint32_t)__float2int_rn(fminf(fmaxf(v * inv_scale, -127.f), 127.f)) &
         0xffu;
}

// Scratch floats at the head of dynamic shared memory: per-warp partials
// [nwarps][2·ct], this block's sums [2·ct] (read by the other blocks of the
// cluster), mean and 1/std of the tile's channels [2·ct]. The staged rows of
// y follow.
__host__ __device__ inline int scratch_floats(int threads, int ct) {
  return (threads / 32 + 2) * 2 * ct;
}

// What the launcher works out once for all threads.
struct Geometry {
  int h, w, c;
  int lg_groups;  // log2 of the threads across the channel tile (ct / 4)
  int rows;       // rows of the plane per block
  int staged;     // of these, rows kept in shared memory
  int dr, dc;     // a step of `lanes` pixels is dr rows and dc columns
  int pad, edge;
};

// IN → [+residual | ReLU] of four channels of one pixel.
struct Epilogue {
  float mean[4], rstd[4];
  int relu;

  __device__ __forceinline__ float4 operator()(float4 v) const {
    v.x = (v.x - mean[0]) * rstd[0];
    v.y = (v.y - mean[1]) * rstd[1];
    v.z = (v.z - mean[2]) * rstd[2];
    v.w = (v.w - mean[3]) * rstd[3];
    if (relu) {
      v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
    }
    return v;
  }
  // with the residual stream's four values (bf16 pairs, as loaded) added
  __device__ __forceinline__ float4 operator()(float4 v, uint2 r) const {
    v.x = (v.x - mean[0]) * rstd[0] + __uint_as_float(r.x << 16);
    v.y = (v.y - mean[1]) * rstd[1] + __uint_as_float(r.x & 0xffff0000u);
    v.z = (v.z - mean[2]) * rstd[2] + __uint_as_float(r.y << 16);
    v.w = (v.w - mean[3]) * rstd[3] + __uint_as_float(r.y & 0xffff0000u);
    return v;
  }
};

__device__ __forceinline__ void store_q(int8_t* q, float4 v, float inv_scale) {
  *reinterpret_cast<uint32_t*>(q) =
      quantize(v.x, inv_scale) | quantize(v.y, inv_scale) << 8 |
      quantize(v.z, inv_scale) << 16 | quantize(v.w, inv_scale) << 24;
}

// Grid (S, channel tiles, N), cluster (S, 1, 1), ct a power of two in
// 4..128, blockDim.x a multiple of 32, at least 2·ct. The first geo.staged of
// a block's rows are kept in shared memory and read from device memory
// once; the others are read again in pass 2. Offsets inside one sample's
// plane are 32-bit (the launcher checks that they fit).
template <typename T>
__global__ void __launch_bounds__(1024) in_epilogue_cluster_kernel(
    const T* __restrict__ y, const __nv_bfloat16* __restrict__ residual,
    int8_t* __restrict__ q, __nv_bfloat16* __restrict__ z, const Geometry geo,
    float inv_scale, int relu, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int h = geo.h, w = geo.w, c = geo.c, pad = geo.pad;
  const int tid = threadIdx.x;
  const int groups = 1 << geo.lg_groups;  // threads across the channel tile
  const int ct = groups << 2;
  const int g = tid & (groups - 1);       // this thread's group of 4 channels
  const int lane = tid >> geo.lg_groups;  // pixel lane
  const int lanes = blockDim.x >> geo.lg_groups;
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int rank = (int)cluster.block_rank();
  const int nblk = (int)cluster.num_blocks();
  const int ch0 = blockIdx.y * ct + g * 4;
  // Inactive threads (beyond C in a ragged last tile) skip the memory work
  // but take part in every barrier.
  const bool active = ch0 < c;
  const int r0 = min(rank * geo.rows, h), r1 = min(r0 + geo.rows, h);
  const int npix = (r1 - r0) * w;
  const int staged = min(geo.staged, r1 - r0);  // rows in shared memory
  const int spix = staged * w;
  const size_t plane = (size_t)blockIdx.z * h * w * c + ch0;
  // this block's rows of the sample's plane, at this thread's channels
  const int own = r0 * w * c;
  const T* ysrc = y + plane + own;

  float* part = reinterpret_cast<float*>(smem);
  float* stat = part + nwarps * 2 * ct;
  float* norm = stat + 2 * ct;
  // 16-byte aligned: the scratch is a multiple of 32 bytes (ct ≥ 4). Staged
  // pixel i of this thread: slab + i * ct.
  T* slab = reinterpret_cast<T*>(norm + 2 * ct) + g * 4;

  // Pass 1: partial sum and sum of squares of this block's rows. The
  // staged rows come in with cp.async, all copies in flight at once, while
  // the other rows are summed straight from device memory.
  float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
  auto add = [&](float4 v) {
    a1[0] += v.x; a2[0] += v.x * v.x;
    a1[1] += v.y; a2[1] += v.y * v.y;
    a1[2] += v.z; a2[2] += v.z * v.z;
    a1[3] += v.w; a2[3] += v.w * v.w;
  };
  if (active) {
    for (int i = lane; i < spix; i += lanes)
      cp_async<4 * sizeof(T)>(slab + i * ct, ysrc + i * c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 4
    for (int i = spix + lane; i < npix; i += lanes) add(load4(ysrc + i * c));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll 4
    for (int i = lane; i < spix; i += lanes) add(load4(slab + i * ct));
  }
  // Threads of a warp with the same g sit `groups` apart.
  for (int off = 16; off >= groups; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a1[k] += __shfl_xor_sync(0xffffffffu, a1[k], off);
      a2[k] += __shfl_xor_sync(0xffffffffu, a2[k], off);
    }
  }
  if ((tid & 31) < groups) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      part[warp * 2 * ct + g * 4 + k] = a1[k];
      part[warp * 2 * ct + ct + g * 4 + k] = a2[k];
    }
  }
  __syncthreads();
  if (tid < 2 * ct) {
    float t = 0.f;
    for (int i = 0; i < nwarps; ++i) t += part[i * 2 * ct + tid];
    stat[tid] = t;
  }
  // Every block's sums (and staged rows) are written before any is read.
  cluster.sync();
  if (tid < ct) {
    // In rank order, so that every block of the cluster holds the same bits.
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < nblk; ++r) {
      const float* remote = cluster.map_shared_rank(stat, r);
      t1 += remote[tid];
      t2 += remote[ct + tid];
    }
    const float hw = (float)(h * w);
    const float mean = t1 / hw;
    const float var = t2 / hw - mean * mean;
    norm[tid] = mean;
    norm[ct + tid] = 1.0f / sqrtf(var + eps);
  }
  // The other blocks may still be reading this block's sums: arrive now,
  // wait before the block ends.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  if (active && npix > 0) {
    Epilogue ep;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ep.mean[k] = norm[g * 4 + k];
      ep.rstd[k] = norm[ct + g * 4 + k];
    }
    const __nv_bfloat16* rplane =
        residual == nullptr ? nullptr : residual + plane;
    ep.relu = relu;
    const int wp = w + 2 * pad, hp = h + 2 * pad;
    int8_t* qplane =
        q == nullptr ? nullptr : q + (size_t)blockIdx.z * hp * wp * c + ch0;

    // Pass 2, interior: this block's own pixels [first_row · w, end), the
    // identity map; first the staged ones, then the others. Pixel i lies
    // `row` rows below r0; q skips 2·pad border pixels per row.
    __nv_bfloat16* zdst = z == nullptr ? nullptr : z + plane + own;
    int8_t* qdst = qplane + ((r0 + pad) * wp + pad) * c;
    const int qskip = 2 * pad * c;
    auto interior = [&](int first_row, int end, auto from_shared,
                        auto with_residual) {
      // Pixels whose loads from device memory a thread starts before it
      // turns to the arithmetic and the stores. Two help where the residual
      // is read; more, or two where it is not, cost more in registers than
      // they hide in latency (measured).
      constexpr int kBatch = decltype(with_residual)::value ? 2 : 1;
      int row = first_row, col = lane;
      while (col >= w) { col -= w; ++row; }
      for (int i0 = first_row * w + lane; i0 < end; i0 += kBatch * lanes) {
        float4 raw[kBatch];
        uint2 res[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * lanes;
          if (i < end) {
            if (!from_shared.value) raw[u] = load4(ysrc + i * c);
            if (with_residual.value)
              res[u] = *reinterpret_cast<const uint2*>(rplane + own + i * c);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * lanes;
          if (i < end) {
            const int off = i * c;
            if (from_shared.value) raw[u] = load4(slab + i * ct);
            const float4 v =
                with_residual.value ? ep(raw[u], res[u]) : ep(raw[u]);
            if (q != nullptr) store_q(qdst + off + row * qskip, v, inv_scale);
            if (z != nullptr) {
              *reinterpret_cast<uint2*>(zdst + off) =
                  make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
            }
            row += geo.dr; col += geo.dc;
            if (col >= w) { col -= w; ++row; }
          }
        }
      }
    };
    if (rplane != nullptr) {
      interior(0, spix, std::true_type(), std::true_type());
      interior(staged, npix, std::false_type(), std::true_type());
    } else {
      interior(0, spix, std::true_type(), std::false_type());
      interior(staged, npix, std::false_type(), std::false_type());
    }

    // Pass 2, border: the 2·pad side columns of the block's own rows; the
    // first and the last block also take the pad rows above and below,
    // whose source rows they own.
    if (q != nullptr && pad > 0) {
      auto border = [&](int orow, int ocol) {
        const int ih = source_index(orow - pad, h, geo.edge);
        const int iw = source_index(ocol - pad, w, geo.edge);
        const int off = (ih * w + iw) * c;
        const float4 raw = ih - r0 < staged
                               ? load4(slab + ((ih - r0) * w + iw) * ct)
                               : load4(y + plane + off);
        store_q(qplane + (orow * wp + ocol) * c,
                rplane != nullptr
                    ? ep(raw, *reinterpret_cast<const uint2*>(rplane + off))
                    : ep(raw),
                inv_scale);
      };
      for (int r = r0 + lane; r < r1; r += lanes) {
        for (int k = 0; k < pad; ++k) {
          border(r + pad, k);
          border(r + pad, pad + w + k);
        }
      }
      const int top = rank == 0 ? pad : 0, bottom = r1 == h ? pad : 0;
      for (int k = 0; k < top + bottom; ++k) {
        const int orow = k < top ? k : pad + h + (k - top);
        for (int ocol = lane; ocol < wp; ocol += lanes) border(orow, ocol);
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Opt the kernel into the full dynamic shared memory once per device; not a
// stream operation, so it must not wait for a launch inside a graph capture.
template <typename K>
cudaError_t allow_full_shared_memory(K kernel, unsigned long long* done) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (device & 63);
  if (*done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSharedBytes);
  if (e == cudaSuccess) *done |= bit;
  return e;
}

struct Args {
  const void* y;
  const __nv_bfloat16* residual;
  int8_t* q;
  __nv_bfloat16* z;
  int n, h, w, c;
  float inv_scale;
  int relu, pad, edge;
  float eps;
};

struct Plan {
  int ct, cluster, threads, shared_bytes;
  int staged;  // rows of a block kept in shared memory
};

// With occupancy != nullptr nothing is launched: *occupancy receives the
// number of clusters of this plan that the device can hold at once.
template <typename T>
cudaError_t launch_cluster(const Args& a, const Plan& p, cudaStream_t stream,
                           int* occupancy) {
  static unsigned long long done = 0;
  auto kernel = in_epilogue_cluster_kernel<T>;
  cudaError_t e = allow_full_shared_memory(kernel, &done);
  if (e != cudaSuccess) return e;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, (a.c + p.ct - 1) / p.ct, a.n);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.shared_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveClusters(occupancy, kernel, &cfg);
  Geometry geo = {a.h, a.w, a.c};
  while ((4 << geo.lg_groups) < p.ct) ++geo.lg_groups;
  const int lanes = p.threads >> geo.lg_groups;
  geo.rows = (a.h + p.cluster - 1) / p.cluster;
  geo.staged = p.staged;
  geo.dr = lanes / a.w;
  geo.dc = lanes % a.w;
  geo.pad = a.pad;
  geo.edge = a.edge;
  return cudaLaunchKernelEx(&cfg, kernel, (const T*)a.y, a.residual, a.q, a.z,
                            geo, a.inv_scale, a.relu, a.eps);
}

// The plan is legal: the vector path's alignment, the thread layout, a
// split in which every block has rows and the first and the last own the
// source rows of the border, and enough shared memory.
bool plan_is_legal(const Args& a, const Plan& p, int itemsize) {
  if (a.c % 4 != 0 || a.n > 65535) return false;
  // 32-bit offsets inside one sample's padded plane
  if ((size_t)(a.h + 2 * a.pad) * (a.w + 2 * a.pad) * a.c > 0x7fffffffull)
    return false;
  if (p.ct < 4 || p.ct > 128 || (p.ct & (p.ct - 1)) != 0) return false;
  // 2·ct threads of a block add up its warps' sums
  if (p.threads < 2 * p.ct || p.threads > 1024 || p.threads % 32 != 0)
    return false;
  if (p.cluster < 1 || p.cluster > 8) return false;  // the portable size
  const int rows = (a.h + p.cluster - 1) / p.cluster;
  const int last = a.h - (p.cluster - 1) * rows;
  const int need = (a.pad > 0 && !a.edge) ? a.pad + 1 : 1;
  if (p.cluster > 1 && (last < need || rows < need)) return false;
  size_t bytes = (size_t)scratch_floats(p.threads, p.ct) * sizeof(float);
  if (p.staged < 0 || p.staged > rows) return false;
  bytes += (size_t)p.staged * a.w * p.ct * itemsize;
  return bytes <= (size_t)p.shared_bytes && p.shared_bytes <= kMaxSharedBytes;
}

template <typename T>
cudaError_t dispatch_cluster(const Args& a, const Plan& p, cudaStream_t stream,
                             int* occupancy) {
  if (!plan_is_legal(a, p, (int)sizeof(T))) return cudaErrorInvalidValue;
  return launch_cluster<T>(a, p, stream, occupancy);
}

// ---------------------------------------------------------------------------
// The generic kernel: any C, scalar access
// ---------------------------------------------------------------------------

constexpr int kChannels = 8;   // channels per block
constexpr int kLanes = 128;    // pixel lanes per block

__device__ __forceinline__ float to_float(int32_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

template <typename T>
cudaError_t launch_generic(const Args& a, cudaStream_t stream) {
  dim3 grid(a.n, (a.c + kChannels - 1) / kChannels);
  dim3 block(kChannels, kLanes);
  in_epilogue_kernel<T><<<grid, block, 0, stream>>>(
      (const T*)a.y, a.residual, a.q, a.z, a.h, a.w, a.c, a.inv_scale, a.relu,
      a.pad, a.edge, a.eps);
  return cudaGetLastError();
}

}  // namespace

// y_is_bf16 selects the input type (0: int32, 1: bf16). residual, q and z
// may be null. cluster_kernel 0 launches the generic kernel (the plan's
// numbers are ignored), 1 the cluster kernel with channel tile ct, `cluster`
// blocks to a plane, `threads` to a block, `staged_rows` of a block's rows
// kept in shared memory and shared_bytes of dynamic shared memory. Returns
// the launch's cudaError_t (0 on success); a plan the kernel cannot run
// gives cudaErrorInvalidValue without a launch.
extern "C" int int8_epilogue(const void* y, int y_is_bf16,
                             const void* residual, void* q, void* z, int n,
                             int h, int w, int c, float inv_scale, int relu,
                             int pad, int edge, float eps, int cluster_kernel,
                             int ct, int cluster, int threads,
                             int shared_bytes, int staged_rows, void* stream) {
  const Args a = {y, (const __nv_bfloat16*)residual, (int8_t*)q,
                  (__nv_bfloat16*)z, n, h, w, c, inv_scale, relu,
                  q == nullptr ? 0 : pad, edge, eps};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (!cluster_kernel) {
    e = y_is_bf16 ? launch_generic<__nv_bfloat16>(a, s)
                  : launch_generic<int32_t>(a, s);
  } else {
    const Plan p = {ct, cluster, threads, shared_bytes, staged_rows};
    e = y_is_bf16 ? dispatch_cluster<__nv_bfloat16>(a, p, s, nullptr)
                  : dispatch_cluster<int32_t>(a, p, s, nullptr);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// How many clusters of a plan of the cluster kernel the device holds at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t. 0 means the
// plan cannot be placed at all.
extern "C" int int8_epilogue_active_clusters(int y_is_bf16, int h, int w,
                                             int c, int n, int pad, int edge,
                                             int ct, int cluster, int threads,
                                             int shared_bytes,
                                             int staged_rows) {
  const Args a = {nullptr, nullptr, nullptr, nullptr, n, h, w, c, 1.f, 0,
                  pad, edge, 0.f};
  const Plan p = {ct, cluster, threads, shared_bytes, staged_rows};
  int clusters = 0;
  const cudaError_t e =
      y_is_bf16 ? dispatch_cluster<__nv_bfloat16>(a, p, nullptr, &clusters)
                : dispatch_cluster<int32_t>(a, p, nullptr, &clusters);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return clusters;
}
