// K4: all-pairs shortest paths of a weighted graph, a blocked Floyd-Warshall
// in float64 on the card.
//
// Replaces no TPU kernel. jamie_tpu runs the geodesic closure on the host
// as scipy's all-pairs Dijkstra (jamie_tpu/ops/distances.py:429-460), and
// so did the port, where it took ~60% of a 3654-cell geodesic fit. This
// kernel computes the same closure on the card: d(i, j) = min over k of
// d(i, k) + d(k, j), in float64 path sums as scipy's Dijkstra takes them.
//
// The matrix w (n, n), row-major float64, holds the edge weights, +inf
// where there is no edge and 0 on the diagonal; n is a multiple of TILE
// (the caller pads with isolated vertices). It is closed in place.
//
// What bounds it on an H100: n^3 min-plus pairs, each an FP64 add and an
// FP64 compare (sm_90 has no single FP64 min: fmin is a DSETP and selects),
// at 64 FP64 lanes an SM a clock. The bytes, the whole matrix read and
// written once a pivot round, come to (n / TILE) * 2 * 8 n^2, below the
// operations' time at TILE = 64. The tiling (Venkataraman et al. 2003, Katz
// and Kider 2008) takes the closure in n / TILE pivot rounds of three
// launches:
// - fw_diagonal: the pivot tile (k, k) closed alone in shared memory.
// - fw_panels: each tile of the pivot row against the closed pivot tile,
//   and each of the pivot column, in shared memory.
// - fw_rest: every other tile, c = min(c, a (x) b), the min-plus product
//   of its pivot-column tile a and pivot-row tile b, both staged in shared
//   memory and read TILE times each; each thread keeps a 4x4 block of c in
//   registers. ~97% of the n^3 pairs run here, with no barrier in the loop.
//
// The two in-tile loops update their tile in place with one barrier a step:
// at step kk, row kk and column kk of the tile being closed cannot change
// (the pivot's diagonal entry is exactly 0 and no weight is negative, and
// the update takes a strictly smaller sum), so no thread reads an entry that
// another one writes in the same step.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 64;                  // rows and columns of a tile
constexpr int SIDE = 16;                  // threads along a tile side
constexpr int PER = TILE / SIDE;          // rows (and columns) per thread
constexpr int PAD = TILE + 1;             // row stride of the staged a tile
constexpr int PANEL_SMEM = 2 * TILE * TILE * sizeof(double);
constexpr int REST_SMEM = (TILE * PAD + TILE * TILE) * sizeof(double);
constexpr int MAX_DEVICES = 64;

enum { BAD_SIZE = -1, BAD_DEVICE = -2 };

// Thread (ty, tx) of a tile owns rows ty + SIDE a and columns tx + SIDE b:
// a half-warp reads 16 consecutive doubles of a row, 128 bytes.
__device__ __forceinline__ void load_tile(double (*s)[TILE],
                                          const double* __restrict__ g,
                                          size_t ld) {
  for (int a = 0; a < PER; ++a)
    for (int b = 0; b < PER; ++b) {
      const int r = threadIdx.y + SIDE * a, c = threadIdx.x + SIDE * b;
      s[r][c] = g[r * ld + c];
    }
}

__device__ __forceinline__ void store_tile(double* __restrict__ g,
                                           double (*s)[TILE], size_t ld) {
  for (int a = 0; a < PER; ++a)
    for (int b = 0; b < PER; ++b) {
      const int r = threadIdx.y + SIDE * a, c = threadIdx.x + SIDE * b;
      g[r * ld + c] = s[r][c];
    }
}

__device__ __forceinline__ double* tile_at(double* w, size_t ld, int i,
                                           int j) {
  return w + static_cast<size_t>(i) * TILE * ld +
         static_cast<size_t>(j) * TILE;
}

__global__ void __launch_bounds__(SIDE * SIDE)
    fw_diagonal_kernel(double* __restrict__ w, int n, int k) {
  __shared__ double d[TILE][TILE];
  const size_t ld = n;
  double* g = tile_at(w, ld, k, k);
  load_tile(d, g, ld);
  __syncthreads();
  for (int kk = 0; kk < TILE; ++kk) {
    for (int a = 0; a < PER; ++a) {
      const int r = threadIdx.y + SIDE * a;
      const double dr = d[r][kk];
      for (int b = 0; b < PER; ++b) {
        const int c = threadIdx.x + SIDE * b;
        const double t = dr + d[kk][c];
        if (t < d[r][c]) d[r][c] = t;
      }
    }
    __syncthreads();
  }
  store_tile(g, d, ld);
}

// Blocks [0, T - 1) take the pivot row's tiles, [T - 1, 2 (T - 1)) the
// pivot column's, the pivot tile skipped.
__global__ void __launch_bounds__(SIDE * SIDE)
    fw_panels_kernel(double* __restrict__ w, int n, int k) {
  extern __shared__ double smem[];
  double(*d)[TILE] = reinterpret_cast<double(*)[TILE]>(smem);
  double(*c)[TILE] = reinterpret_cast<double(*)[TILE]>(smem + TILE * TILE);
  const size_t ld = n;
  const int others = n / TILE - 1;
  const int bx = blockIdx.x;
  const bool row = bx < others;
  int t = row ? bx : bx - others;
  t += t >= k;
  double* g = row ? tile_at(w, ld, k, t) : tile_at(w, ld, t, k);
  load_tile(d, tile_at(w, ld, k, k), ld);
  load_tile(c, g, ld);
  __syncthreads();
  for (int kk = 0; kk < TILE; ++kk) {
    for (int a = 0; a < PER; ++a) {
      const int r = threadIdx.y + SIDE * a;
      const double left = row ? d[r][kk] : c[r][kk];
      for (int b = 0; b < PER; ++b) {
        const int col = threadIdx.x + SIDE * b;
        const double s = left + (row ? c[kk][col] : d[kk][col]);
        if (s < c[r][col]) c[r][col] = s;
      }
    }
    __syncthreads();
  }
  store_tile(g, c, ld);
}

// Block (x, y) takes tile (i, j) = (y, x), each index past the pivot's
// moved up by one.
__global__ void __launch_bounds__(SIDE * SIDE)
    fw_rest_kernel(double* __restrict__ w, int n, int k) {
  extern __shared__ double smem[];
  double(*a_s)[PAD] = reinterpret_cast<double(*)[PAD]>(smem);
  double(*b_s)[TILE] = reinterpret_cast<double(*)[TILE]>(smem + TILE * PAD);
  const size_t ld = n;
  const int by = blockIdx.y, bx = blockIdx.x;
  const int i = by + (by >= k), j = bx + (bx >= k);
  const double* ga = tile_at(w, ld, i, k);
  const double* gb = tile_at(w, ld, k, j);
  double* gc = tile_at(w, ld, i, j);
  double acc[PER][PER];
  for (int a = 0; a < PER; ++a)
    for (int b = 0; b < PER; ++b) {
      const int r = threadIdx.y + SIDE * a, col = threadIdx.x + SIDE * b;
      a_s[r][col] = ga[r * ld + col];
      b_s[r][col] = gb[r * ld + col];
      acc[a][b] = gc[r * ld + col];
    }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < TILE; ++kk) {
    double av[PER], bv[PER];
    for (int a = 0; a < PER; ++a) av[a] = a_s[threadIdx.y + SIDE * a][kk];
    for (int b = 0; b < PER; ++b) bv[b] = b_s[kk][threadIdx.x + SIDE * b];
    for (int a = 0; a < PER; ++a)
      for (int b = 0; b < PER; ++b) {
        const double t = av[a] + bv[b];
        acc[a][b] = t < acc[a][b] ? t : acc[a][b];
      }
  }
  for (int a = 0; a < PER; ++a)
    for (int b = 0; b < PER; ++b) {
      const int r = threadIdx.y + SIDE * a, col = threadIdx.x + SIDE * b;
      gc[r * ld + col] = acc[a][b];
    }
}

}  // namespace

extern "C" int floyd_warshall_tile() { return TILE; }

// Closes w (n, n) in place: n / TILE rounds of the three launches on
// `stream`. Returns 0 once they are queued, else an error code.
extern "C" int floyd_warshall_f64(void* w, int n, void* stream) {
  if (n <= 0 || n % TILE != 0) return BAD_SIZE;
  static bool smem_set[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return BAD_DEVICE;
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(fw_panels_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PANEL_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(fw_rest_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               REST_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* m = static_cast<double*>(w);
  const int tiles = n / TILE;
  const dim3 block(SIDE, SIDE);
  for (int k = 0; k < tiles; ++k) {
    fw_diagonal_kernel<<<1, block, 0, s>>>(m, n, k);
    if (tiles > 1) {
      fw_panels_kernel<<<2 * (tiles - 1), block, PANEL_SMEM, s>>>(m, n, k);
      fw_rest_kernel<<<dim3(tiles - 1, tiles - 1), block, REST_SMEM, s>>>(
          m, n, k);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
