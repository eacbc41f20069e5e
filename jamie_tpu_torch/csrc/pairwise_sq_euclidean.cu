// K3: pairwise squared euclidean distances, out[i][j] = max(|x_i|^2 + |y_j|^2
// - 2 x_i . y_j, 0), with an optional sqrt and a zero diagonal for
// self-distance, on Hopper's tensor cores.
//
// Replaces jamie_tpu/ops/ab_archive.py::pairwise_sq_euclidean_pallas (body
// _pairwise_kernel). The TPU kernel walks a sequential grid over the feature
// axis and carries the x.y^T sum in a VMEM scratch tile from one grid step to
// the next. Here each block owns one 128x128 output tile (or one slice of
// its feature axis, see split-K below) and loops over the features itself,
// with the sum in registers.
//
// Numerics: 3xTF32. Each operand is split as v = hi + lo: hi is v with the
// low 13 mantissa bits cleared (exact in TF32), lo = v - hi (exact in f32)
// rounded to TF32 with cvt.rna. x.y ~= hi.hi + hi.lo + lo.hi, three TF32
// tensor-core products into one f32 accumulator, leaves about 2^-21 relative
// error per product: float32-accurate (the port's semantics), where plain
// TF32 (2^-11) fails the Gram cancellation at thousands of features. It is
// not bit-exact float32, and (i, j) and (j, i) may differ in the last bits.
//
// What bounds it on an H100: 3 * 2*m*n*f TF32 operations (495 TFLOP/s
// dense) against (m*f + n*f + m*n) * 4 bytes, so operations at the main
// path's shapes. The design:
// - TMA (cp.async.bulk.tensor.2d, 128-byte swizzle) brings 128-row x 32-float
//   tiles of x and y into a 3-stage ring, driven by mbarriers; one producer
//   warp issues the loads. x (m, f) and y (n, f) are both K-major, the only
//   layout wgmma takes for TF32, so y needs no transpose.
// - Two consumer warpgroups (64 rows of x each) split each arrived stage in
//   shared memory (hi in place, lo beside it; the split is elementwise, so
//   the swizzle does not matter), fence it to the async proxy, and run 12
//   wgmma.m64n128k8 TF32 products per stage. The split of stage s+1 runs
//   while the products of stage s are in flight. Each stage's products
//   start from zero and are added to the running sum in float32 after
//   the stage (the tensor cores' accumulation truncates).
// - The epilogue (norms, clamp, sqrt, zero diagonal) maps the accumulator
//   fragment to (row, col) and stores once, so the Gram matrix never goes to
//   device memory.
// - Split-K: where the output tiles alone would leave SMs idle (81 tiles at
//   1047^2 on 132 SMs), the caller asks for `splits` slices of the feature
//   axis; each block then writes its f32 partial sums to a workspace and a
//   second pass sums them and applies the epilogue.
// TMA needs a 16-byte aligned base and a row stride that is a multiple of 16
// bytes (f % 4 == 0): the caller zero-pads the feature axis otherwise. Ragged
// rows and the feature tail are zero-filled by TMA; the store is masked.
//
// Row norms come from the caller (computed in torch, as the Pallas wrapper
// computes them outside its kernel). Tensor maps are encoded on the host for
// each call with cuTensorMapEncodeTiled, reached through the runtime's
// driver entry point, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                       // rows of x per block
constexpr int BN = 128;                       // rows of y per block
constexpr int BK = 32;                        // features per stage: one 128 B swizzle row
constexpr int STAGES = 3;
constexpr int TILE_BYTES = BM * BK * 4;       // 16 KB; BM == BN
constexpr int SLAB_FLOATS = 64 * BK;          // one warpgroup's 64 rows of a tile
constexpr int STAGE_BYTES = 4 * TILE_BYTES;   // x, y, x_lo, y_lo
constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int THREADS = CONSUMERS + 32;       // + one producer warp
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

static_assert(BM == BN, "one tensor-map box serves both operands");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// Barrier over the two consumer warpgroups only (the producer warp never
// joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// 8-row atoms of 1024 bytes (stride byte offset), leading byte offset unused.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64x128 f32, the m64n128 fragment) = A (64x8 TF32) . B (128x8 TF32)^T
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float tf32_hi(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
}

// Split 2048 floats (one warpgroup's 64-row slab) in place: raw <- hi,
// lo <- rna_tf32(raw - hi). t is the thread's index in its warpgroup.
__device__ __forceinline__ void split_slab(float* raw, float* lo, int t) {
  float4* r4 = reinterpret_cast<float4*>(raw);
  uint4* l4 = reinterpret_cast<uint4*>(lo);
#pragma unroll
  for (int q = 0; q < SLAB_FLOATS / 4 / 128; ++q) {
    const int i = t + q * 128;
    const float4 v = r4[i];
    const float4 h = make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z),
                                 tf32_hi(v.w));
    l4[i] = make_uint4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                       tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
    r4[i] = h;
  }
}

__device__ __forceinline__ float finish(float dot, float xn, float yn, int r,
                                        int c, int take_sqrt, int self_dist) {
  float d = fmaxf(xn + yn - 2.f * dot, 0.f);
  if (take_sqrt) d = sqrtf(d);
  if (self_dist && r == c) d = 0.f;
  return d;
}

// grid (ceil(n/BN), ceil(m/BM), splits). With splits == 1 the block writes
// the distances; otherwise it writes its partial x.y^T for feature steps
// [z * steps_per_split, ...) to out[z] of an (splits, m, n) workspace.
__global__ void __launch_bounds__(THREADS, 1)
pairwise_tf32x3_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmy,
                       const float* __restrict__ xsq,
                       const float* __restrict__ ysq, float* __restrict__ out,
                       int m, int n, int ksteps, int steps_per_split,
                       int take_sqrt, int self_dist) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms must sit on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + STAGES * STAGE_BYTES;   // full[s]: full0 + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;           // empty[s]: empty0 + 8 s

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kb0 = blockIdx.z * steps_per_split;
  const int nk = min(ksteps, kb0 + steps_per_split) - kb0;   // >= 1 (host)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {   // producer warp: one lane issues the loads
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * TILE_BYTES);
        const int k = (kb0 + i) * BK;
        const uint32_t st = base + s * STAGE_BYTES;
        tma_load_2d(st, &tmx, k, m0, full0 + 8 * s);
        tma_load_2d(st + TILE_BYTES, &tmy, k, n0, full0 + 8 * s);
      }
    }
    return;
  }

  // Consumers: warpgroup g owns rows [64 g, 64 g + 64) of the x tile and
  // splits those rows of both tiles.
  // acc holds one stage's products; sum, the running dot product, takes
  // them with a float32 add after each stage. The tensor cores' own
  // accumulation truncates, which over a thousand accumulations of
  // same-sign products biases the dot by ~1e-5 relative (more than the
  // tolerance); an add per stage keeps that to the 12 products of a stage.
  const int g = warp / 4;
  const int t = threadIdx.x % 128;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;

  auto split_stage = [&](int s) {
    float* st = reinterpret_cast<float*>(smem + s * STAGE_BYTES);
    constexpr int TILE = TILE_BYTES / 4;
    split_slab(st + g * SLAB_FLOATS, st + 2 * TILE + g * SLAB_FLOATS, t);
    split_slab(st + TILE + g * SLAB_FLOATS, st + 3 * TILE + g * SLAB_FLOATS,
               t);
    fence_proxy_async();   // make the generic-proxy writes visible to wgmma
  };

  mbar_wait(full0, 0);
  split_stage(0);
  consumer_sync();
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint32_t st = base + s * STAGE_BYTES;
    const uint32_t x_hi = st + g * (SLAB_FLOATS * 4);
    const uint32_t x_lo = x_hi + 2 * TILE_BYTES;
    const uint32_t y_hi = st + TILE_BYTES;
    const uint32_t y_lo = y_hi + 2 * TILE_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {   // k8 slices: 32 bytes along the row
      const uint32_t off = kk * 32;
      wgmma_tf32(acc, smem_desc(x_lo + off), smem_desc(y_hi + off), kk > 0);
      wgmma_tf32(acc, smem_desc(x_hi + off), smem_desc(y_lo + off), 1);
      wgmma_tf32(acc, smem_desc(x_hi + off), smem_desc(y_hi + off), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (i + 1 < nk) {   // split the next stage while the products run
      const int s1 = (i + 1) % STAGES;
      mbar_wait(full0 + 8 * s1, ((i + 1) / STAGES) & 1);
      split_stage(s1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int j = 0; j < 64; ++j) sum[j] += acc[j];
    consumer_sync();
  }

  // Fragment of m64n128 f32: sum[4c + 2h + e] is row 16 w + lane/4 + 8 h,
  // column 8 c + 2 (lane % 4) + e of the warpgroup's 64x128 tile.
  const int row_base = m0 + g * 64 + (warp % 4) * 16 + lane / 4;
  const int col_base = n0 + 2 * (lane % 4);
  const bool partial = gridDim.z > 1;
  float* dst = out + static_cast<size_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_base + 8 * h;
    if (r >= m) continue;
    const float xn = partial ? 0.f : xsq[r];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col_base + 8 * c + e;
        if (col >= n) continue;
        const float v = sum[4 * c + 2 * h + e];
        dst[static_cast<size_t>(r) * n + col] =
            partial ? v : finish(v, xn, ysq[col], r, col, take_sqrt, self_dist);
      }
    }
  }
}

// Second split-K pass: out = epilogue(sum over z of ws[z]).
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws,
                     const float* __restrict__ xsq,
                     const float* __restrict__ ysq, float* __restrict__ out,
                     int m, int n, int splits, int take_sqrt, int self_dist) {
  const size_t total = static_cast<size_t>(m) * n;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float dot = 0.f;
    for (int z = 0; z < splits; ++z) dot += ws[z * total + idx];
    const int r = static_cast<int>(idx / n);
    const int c = static_cast<int>(idx - static_cast<size_t>(r) * n);
    out[idx] = finish(dot, xsq[r], ysq[c], r, c, take_sqrt, self_dist);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (rows, cols) row-major float32 -> tensor map with (BK, BM) boxes.
CUresult encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int rows,
                int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // out of bounds reads as 0
}

}  // namespace

// Error codes besides cudaError_t values: no driver entry point for
// cuTensorMapEncodeTiled; a split-K factor that leaves a slice empty; a
// device index past MAX_DEVICES; a tensor map the driver refused
// (ENCODE_FAILED + its CUresult).
enum { NO_ENTRY_POINT = -1, BAD_SPLITS = -2, BAD_DEVICE = -3,
       ENCODE_FAILED = -1000 };
constexpr int MAX_DEVICES = 64;

// Dynamic shared memory per block of the main kernel (ptxas reports only
// static shared memory).
extern "C" int pairwise_sq_euclidean_smem_bytes() { return SMEM_BYTES; }

// x (m, f), y (n, f), xsq (m), ysq (n), out (m, n): contiguous float32 on the
// device, x and y 16-byte aligned with f % 4 == 0. ws: (splits, m, n) float32
// when splits > 1, else unused. Launches on `stream` and returns 0 once the
// kernels are queued, else an error code.
extern "C" int pairwise_sq_euclidean_f32(const void* x, const void* y,
                                         const void* xsq, const void* ysq,
                                         void* out, void* ws, int m, int n,
                                         int f, int splits, int take_sqrt,
                                         int self_dist, void* stream) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return NO_ENTRY_POINT;
  const int ksteps = (f + BK - 1) / BK;
  if (splits < 1) return BAD_SPLITS;
  const int per = (ksteps + splits - 1) / splits;
  if ((splits - 1) * per >= ksteps) return BAD_SPLITS;
  CUtensorMap tmx, tmy;
  CUresult r = encode(fn, &tmx, x, m, f);
  if (r == CUDA_SUCCESS) r = encode(fn, &tmy, y, n, f);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED - static_cast<int>(r);

  // The shared-memory attribute is set once per device, on the first call
  // there, so that a later call may be captured into a CUDA graph.
  static bool smem_set[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return BAD_DEVICE;
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(pairwise_tf32x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  pairwise_tf32x3_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      tmx, tmy, static_cast<const float*>(xsq), static_cast<const float*>(ysq),
      dst, m, n, ksteps, per, take_sqrt, self_dist);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * n;
  const int blocks = static_cast<int>(
      (total + 255) / 256 < 132 * 16 ? (total + 255) / 256 : 132 * 16);
  splitk_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(xsq),
      static_cast<const float*>(ysq), static_cast<float*>(out), m, n, splits,
      take_sqrt, self_dist);
  return static_cast<int>(cudaGetLastError());
}
