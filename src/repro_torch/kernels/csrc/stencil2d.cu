// EBISU 2-D temporal blocking on Hopper: one CTA applies t fused Jacobi
// steps of a 2-D tap set to one tile held in shared memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil2d.py::_strip_kernel
// (launched by ebisu2d_padded).  The TPU kernel streams full-width strips
// through 128 MiB of VMEM; here a block has at most 227 KB of shared memory,
// so the domain is tiled on both axes.  A CTA owns a (bh + 2*halo) x
// (bw + 2*halo) tile, halo = t*rad, loaded once from device memory (cells
// outside [0, height) x [0, width) read as 0).  The t steps ping-pong between
// two shared-memory buffers, with __syncthreads() between steps; step s
// computes only the (bh + 2*(halo - s*rad)) x (bw + 2*(halo - s*rad)) cells
// that can still reach the output (the trapezoid narrows on both axes), and
// every cell outside the domain is set to 0 after every step.  The CTA then
// writes its inner bh x bw cells, so cells of the padded layout that lie
// outside the domain are written as 0 (the zero-outside contract the
// program's chained sweeps rely on).
//
// What bounds it on the card: one sweep must read and write every cell of
// the padded array once, 2 * hp * wp * sizeof(T) bytes against 3.35 TB/s of
// HBM3, and it does flops_per_cell * t * height * width operations against
// 67 TFLOP/s fp32 (34 fp64).  This simple version also pays the tiles'
// overlap (each loads (bh+2h)(bw+2h) cells for bh*bw outputs, and computes
// the trapezoid's redundant cells), reads the taps from kernel parameters in
// a run-time loop, and keeps every intermediate in shared memory.  Making it
// fast (TMA tile loads, persistent CTAs, register streaming, taps unrolled
// per stencil signature) is later work.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared (see
// src/repro_torch/kernels/_build.py); bound from Python with ctypes, through
// the plain C functions at the end of this file.

#include <cuda_runtime.h>

#define STENCIL2D_MAX_TAPS 128
#define STENCIL2D_MAX_RADIUS 8

template <typename T>
struct TapSet {
  int n;
  int rad;
  int dy[STENCIL2D_MAX_TAPS];
  int dx[STENCIL2D_MAX_TAPS];
  T c[STENCIL2D_MAX_TAPS];
};

template <typename T>
__global__ void __launch_bounds__(512)
strip2d_kernel(const T* __restrict__ x, T* __restrict__ y, int wp,
               int height, int width, int t, int bh, int bw,
               const __grid_constant__ TapSet<T> taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int halo = t * taps.rad;
  const int sh = bh + 2 * halo;
  const int sw = bw + 2 * halo;
  T* src = reinterpret_cast<T*>(smem_raw);
  T* dst = src + sh * sw;
  const int r0 = blockIdx.y * bh - halo;  // global row of tile row 0
  const int c0 = blockIdx.x * bw - halo;  // global column of tile column 0

  for (int lr = threadIdx.y; lr < sh; lr += blockDim.y) {
    const int gr = r0 + lr;
    const bool row_in = gr >= 0 && gr < height;
    for (int lc = threadIdx.x; lc < sw; lc += blockDim.x) {
      const int gc = c0 + lc;
      T v = T(0);
      if (row_in && gc >= 0 && gc < width) {
        v = x[static_cast<size_t>(gr) * wp + gc];
      }
      src[lr * sw + lc] = v;
    }
  }
  __syncthreads();

  for (int s = 1; s <= t; ++s) {
    const int lo = s * taps.rad;  // live region: [lo, sh - lo) x [lo, sw - lo)
    for (int lr = lo + threadIdx.y; lr < sh - lo; lr += blockDim.y) {
      const int gr = r0 + lr;
      const bool row_in = gr >= 0 && gr < height;
      for (int lc = lo + threadIdx.x; lc < sw - lo; lc += blockDim.x) {
        const int gc = c0 + lc;
        T acc = T(0);
        if (row_in && gc >= 0 && gc < width) {
          const T* p = src + lr * sw + lc;
          acc = p[taps.dy[0] * sw + taps.dx[0]] * taps.c[0];
          for (int k = 1; k < taps.n; ++k) {
            acc += p[taps.dy[k] * sw + taps.dx[k]] * taps.c[k];
          }
        }
        dst[lr * sw + lc] = acc;
      }
    }
    __syncthreads();
    T* tmp = src;
    src = dst;
    dst = tmp;
  }

  for (int r = threadIdx.y; r < bh; r += blockDim.y) {
    const size_t gr = static_cast<size_t>(blockIdx.y) * bh + r;
    for (int c = threadIdx.x; c < bw; c += blockDim.x) {
      y[gr * wp + static_cast<size_t>(blockIdx.x) * bw + c] =
          src[(r + halo) * sw + c + halo];
    }
  }
}

template <typename T>
static int launch(const T* x, T* y, int hp, int wp, int height, int width,
                  int t, int bh, int bw, int threads, int ntaps,
                  const int* dy, const int* dx, const double* coef,
                  void* stream) {
  if (ntaps < 1 || ntaps > STENCIL2D_MAX_TAPS || t < 1 || bh < 1 ||
      bw < 1 || hp % bh != 0 || wp % bw != 0 || threads < 32 ||
      threads % 32 != 0 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapSet<T> taps;
  taps.n = ntaps;
  taps.rad = 0;
  for (int k = 0; k < ntaps; ++k) {
    taps.dy[k] = dy[k];
    taps.dx[k] = dx[k];
    taps.c[k] = static_cast<T>(coef[k]);
    const int ay = dy[k] < 0 ? -dy[k] : dy[k];
    const int ax = dx[k] < 0 ? -dx[k] : dx[k];
    if (ay > taps.rad) taps.rad = ay;
    if (ax > taps.rad) taps.rad = ax;
  }
  if (taps.rad < 1 || taps.rad > STENCIL2D_MAX_RADIUS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int halo = t * taps.rad;
  const size_t smem =
      2 * static_cast<size_t>(bh + 2 * halo) * (bw + 2 * halo) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      strip2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, threads / 32);
  const dim3 grid(wp / bw, hp / bh);
  strip2d_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, wp, height, width, t, bh, bw, taps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int stencil2d_f32(const float* x, float* y, int hp, int wp, int height,
                  int width, int t, int bh, int bw, int threads, int ntaps,
                  const int* dy, const int* dx, const double* coef,
                  void* stream) {
  return launch<float>(x, y, hp, wp, height, width, t, bh, bw, threads,
                       ntaps, dy, dx, coef, stream);
}

int stencil2d_f64(const double* x, double* y, int hp, int wp, int height,
                  int width, int t, int bh, int bw, int threads, int ntaps,
                  const int* dy, const int* dx, const double* coef,
                  void* stream) {
  return launch<double>(x, y, hp, wp, height, width, t, bh, bw, threads,
                        ntaps, dy, dx, coef, stream);
}

const char* stencil2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
