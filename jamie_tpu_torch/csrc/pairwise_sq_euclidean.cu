// K3: pairwise squared euclidean distances, out[i][j] = max(|x_i|^2 + |y_j|^2
// - 2 x_i . y_j, 0), with an optional sqrt and a zero diagonal for
// self-distance.
//
// Replaces jamie_tpu/ops/ab_archive.py::pairwise_sq_euclidean_pallas (body
// _pairwise_kernel). The TPU kernel walks a sequential grid over the feature
// axis and carries the x.y^T sum in a VMEM scratch tile from one grid step to
// the next. Here blocks run in parallel and in no order, so each block owns
// one 64x64 output tile and loops over the feature axis itself, staging
// 16-wide K-steps of x and y in shared memory and keeping the 4x4 partial sums
// of each of its 256 threads in registers. The epilogue (norms, clamp, sqrt,
// zero diagonal) is applied to the registers before the single store, so the
// (m, n) Gram matrix never goes to device memory.
//
// What bounds it: 2*m*n*f FP32 FMAs on the CUDA cores (exact float32, no
// TF32, the semantics the CPU tests hold the port to), against m*f + n*f +
// m*n floats of traffic, so it is bound by operations at the main path's
// shapes. This first version is the plain register-tiled SGEMM: no TMA, no
// wgmma, no double buffering. Ragged edges are masked, not padded.
//
// Row norms come from the caller (computed in torch, as the Pallas wrapper
// computes them outside its kernel).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = 4;
constexpr int TN = 4;

__global__ void __launch_bounds__(THREADS)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ xsq, const float* __restrict__ ysq,
                float* __restrict__ out, int m, int n, int f,
                int take_sqrt, int self_dist) {
  // K-major tiles: thread (ty, tx) reads xs[k][ty + 16 i] and ys[k][tx + 16 j]
  __shared__ float xs[BK][BM];
  __shared__ float ys[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // Loader mapping: each thread copies 4 consecutive features of one row of
  // the x tile and of the y tile.
  const int lr = tid / 4;          // 0..63
  const int lk = (tid % 4) * 4;    // 0, 4, 8, 12
  const int xr = row0 + lr;
  const int yr = col0 + lr;
  const float* xrow = x + static_cast<size_t>(xr) * f;
  const float* yrow = y + static_cast<size_t>(yr) * f;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < f; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + lk + q;
      xs[lk + q][lr] = (xr < m && k < f) ? xrow[k] : 0.f;
      ys[lk + q][lr] = (yr < n && k < f) ? yrow[k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
    const float xn = xsq[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      float d = fmaxf(xn + ysq[c] - 2.f * acc[i][j], 0.f);
      if (take_sqrt) d = sqrtf(d);
      if (self_dist && r == c) d = 0.f;
      out[static_cast<size_t>(r) * n + c] = d;
    }
  }
}

}  // namespace

// x (m, f), y (n, f), xsq (m), ysq (n), out (m, n): contiguous float32 on the
// device. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int pairwise_sq_euclidean_f32(const void* x, const void* y,
                                         const void* xsq, const void* ysq,
                                         void* out, int m, int n, int f,
                                         int take_sqrt, int self_dist,
                                         void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  pairwise_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(xsq), static_cast<const float*>(ysq),
      static_cast<float*>(out), m, n, f, take_sqrt, self_dist);
  return static_cast<int>(cudaGetLastError());
}
