// EBISU 3-D temporal blocking on Hopper: one CTA streams a z column of a
// 3-D field through t rings in shared memory (the paper's circular
// multi-queue, §4.2) and applies t fused Jacobi steps of a 3-D tap set.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil3d.py::_stream_kernel
// (launched by ebisu3d_padded).  The function is the same: one sweep of t
// zero-Dirichlet steps on the padded layout, which holds the zdim x ydim x
// xdim domain at the origin and zeros outside it, on input and on output.
//
// Work of a CTA.  It owns a (zc, ty, tx) tile of output cells.  It reads the
// zc + 2*halo input planes of its column (halo = t*rad), one plane per
// iteration, into ring 0; ring s (s = 0..t-1) holds planes of time level s,
// ring slots ring = 2*rad + 2 deep, plane z in slot z % ring (the port's
// repro_torch.core.multiqueue.MultiQueueLayout, the reference's "shifting"
// addressing).
// On a tiled in-plane axis a level-s plane spans tile + 2*(t-s)*rad cells:
// the trapezoid narrows by rad per step.  An untiled axis (its tile covers
// the domain) has no rim: its planes span the domain plus a zero frame as
// wide as the taps' reach on that axis, so the array's edge is the
// boundary, as the reference's untiled axes are; the lifted 2-D spec has y
// extent 1 and y reach 0, so its planes are single rows.
//
// Schedule.  In iteration k the CTA loads input plane k into ring 0 and, for
// every level s = 1..t, computes plane j = k - s*(rad+1) of level s from
// planes j-rad..j+rad of ring s-1 (levels lag one plane more than the
// reference's "plane z - s*rad once plane z is in").  The newest plane it
// reads was written in iteration k-1, and the one slot it does not read is
// where level s-1 writes its plane of iteration k, so the t levels of one
// iteration need no barrier between them: one __syncthreads() per
// iteration orders every write before its reads and every read before the
// write that reuses its slot.  Level t writes straight to the output, and
// only the CTA's zc body planes reach it (z trapezoid: level s computes
// strip planes s*rad .. zc + 2*halo - 1 - s*rad only).  Every cell outside
// the global domain is set to 0 on load and after every step, on all three
// axes, so the output's padding is written as 0.
//
// What bounds it on the card: one sweep must read the domain and write the
// padded layout once, (domain + padded) cells * sizeof(T) bytes against
// 3.35 TB/s of HBM3, and it does flops_per_cell * t * domain operations
// against 67 TFLOP/s fp32 (34 fp64) -- at t = 5 j3d27pt does 76 GFLOP
// against 2.3 GB, so the deep box stencils are bound by operations and the
// stars by bytes.  This simple version leaves on the table: the rim each
// CTA reloads and the trapezoid's redundant cells (tiles of 32 x 32 at
// depth 8 load 2.25x their body), one plane per barrier, the taps read
// from kernel parameters in a run-time loop with a modulo-free but
// per-tap ring index, every intermediate held in shared memory rather than
// in registers, and plain loads instead of TMA.  Batched or register-
// resident z windows, TMA plane loads and per-signature unrolled taps are
// later work.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared (see
// src/repro_torch/kernels/_build.py); bound from Python with ctypes, through
// the plain C functions at the end of this file.  Global offsets are 64-bit:
// the f64 padded field at the paper's 2560 x 288 x 384 is 2.3 GB.

#include <cuda_runtime.h>

#include <cstddef>

#define STENCIL3D_MAX_TAPS 128
#define STENCIL3D_MAX_RADIUS 8
#define STENCIL3D_THREADS 512

template <typename T>
struct TapSet3 {
  int n;
  int dz[STENCIL3D_MAX_TAPS];
  int dy[STENCIL3D_MAX_TAPS];
  int dx[STENCIL3D_MAX_TAPS];
  T c[STENCIL3D_MAX_TAPS];
};

struct Geom3 {
  int zdim, ydim, xdim;  // the domain
  int yp, xp;            // padded plane: yp rows of xp cells
  int zc, ty, tx;        // tile of output cells (ty == ydim: y untiled, ...)
  int tiled_y, tiled_x;
  int fy, fx;            // zero frame of an untiled axis (tap reach), else 0
  int t, rad, ring;
};

// Plane extent of time level s on one in-plane axis.
__device__ __forceinline__ int level_extent(int tiled, int tile, int dim,
                                            int frame, int t, int s,
                                            int rad) {
  return tiled ? tile + 2 * (t - s) * rad : dim + 2 * frame;
}

template <typename T>
__global__ void __launch_bounds__(STENCIL3D_THREADS)
stream3d_kernel(const T* __restrict__ x, T* __restrict__ y, const Geom3 g,
                const __grid_constant__ TapSet3<T> taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rings = reinterpret_cast<T*>(smem_raw);
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int rad = g.rad;
  const int halo = g.t * rad;
  const int span = g.zc + 2 * halo;
  const int z_base = blockIdx.z * g.zc - halo;  // global z of strip plane 0
  const int y_tile = blockIdx.y * g.ty;         // global y of output row 0
  const int x_tile = blockIdx.x * g.tx;
  // level s+1 index i reads level s index i + shift on each axis
  const int shift_y = g.tiled_y ? rad : 0;
  const int shift_x = g.tiled_x ? rad : 0;

  // Zero every ring once: the frames of untiled axes are never written.
  // Shared-memory offsets are 32-bit: the rings hold < 2^16 cells.
  int total = 0;
  for (int s = 0; s < g.t; ++s) {
    total += g.ring *
             level_extent(g.tiled_y, g.ty, g.ydim, g.fy, g.t, s, rad) *
             level_extent(g.tiled_x, g.tx, g.xdim, g.fx, g.t, s, rad);
  }
  for (int i = tid; i < total; i += nthreads) rings[i] = T(0);
  __syncthreads();

  for (int k = 0; k < span + g.t; ++k) {
    // ---- level 0: input plane k into ring 0 ----------------------------
    {
      const int ey = level_extent(g.tiled_y, g.ty, g.ydim, g.fy, g.t, 0, rad);
      const int ex = level_extent(g.tiled_x, g.tx, g.xdim, g.fx, g.t, 0, rad);
      if (k < span) {
        const int gz = z_base + k;
        const bool z_in = gz >= 0 && gz < g.zdim;
        const int y_lo = g.tiled_y ? 0 : g.fy;
        const int x_lo = g.tiled_x ? 0 : g.fx;
        const int ny = g.tiled_y ? ey : g.ydim;
        const int nx = g.tiled_x ? ex : g.xdim;
        const int y_org = g.tiled_y ? y_tile - halo : -g.fy;
        const int x_org = g.tiled_x ? x_tile - halo : -g.fx;
        T* dst = rings + (k % g.ring) * ey * ex;
        for (int idx = tid; idx < ny * nx; idx += nthreads) {
          const int iy = y_lo + idx / nx;
          const int ix = x_lo + idx % nx;
          const int gy = y_org + iy;
          const int gx = x_org + ix;
          T v = T(0);
          if (z_in && gy >= 0 && gy < g.ydim && gx >= 0 && gx < g.xdim) {
            v = x[(static_cast<size_t>(gz) * g.yp + gy) * g.xp + gx];
          }
          dst[iy * ex + ix] = v;
        }
      }
    }
    // ---- levels 1..t: plane k - s*(rad+1) of level s from ring s-1 -----
    int prev_base = 0;
    for (int s = 1; s <= g.t; ++s) {
      const int ey_prev =
          level_extent(g.tiled_y, g.ty, g.ydim, g.fy, g.t, s - 1, rad);
      const int ex_prev =
          level_extent(g.tiled_x, g.tx, g.xdim, g.fx, g.t, s - 1, rad);
      const int prev_plane = ey_prev * ex_prev;
      const int cur_base = prev_base + g.ring * prev_plane;
      const int j = k - s * (rad + 1);
      if (j >= s * rad && j <= span - 1 - s * rad) {
        const int ey = level_extent(g.tiled_y, g.ty, g.ydim, g.fy, g.t, s,
                                    rad);
        const int ex = level_extent(g.tiled_x, g.tx, g.xdim, g.fx, g.t, s,
                                    rad);
        const int gz = z_base + j;
        const bool z_in = gz >= 0 && gz < g.zdim;
        const int y_lo = g.tiled_y ? 0 : g.fy;
        const int x_lo = g.tiled_x ? 0 : g.fx;
        const int ny = g.tiled_y ? ey : g.ydim;
        const int nx = g.tiled_x ? ex : g.xdim;
        const int y_org = g.tiled_y ? y_tile - (g.t - s) * rad : -g.fy;
        const int x_org = g.tiled_x ? x_tile - (g.t - s) * rad : -g.fx;
        const int jm = j % g.ring;
        const T* src = rings + prev_base;
        T* dst = rings + cur_base + jm * ey * ex;
        for (int idx = tid; idx < ny * nx; idx += nthreads) {
          const int iy = y_lo + idx / nx;
          const int ix = x_lo + idx % nx;
          const int gy = y_org + iy;
          const int gx = x_org + ix;
          T acc = T(0);
          if (z_in && gy >= 0 && gy < g.ydim && gx >= 0 && gx < g.xdim) {
            const int cell = (iy + shift_y) * ex_prev + ix + shift_x;
            for (int q = 0; q < taps.n; ++q) {
              int slot = jm + taps.dz[q];
              slot += slot < 0 ? g.ring : 0;
              slot -= slot >= g.ring ? g.ring : 0;
              const int off = cell + taps.dy[q] * ex_prev + taps.dx[q];
              const T v = src[slot * prev_plane + off];
              acc = q == 0 ? v * taps.c[0] : acc + v * taps.c[q];
            }
          }
          if (s < g.t) {
            dst[iy * ex + ix] = acc;
          } else {
            y[(static_cast<size_t>(gz) * g.yp + gy) * g.xp + gx] = acc;
          }
        }
      }
      prev_base = cur_base;
    }
    __syncthreads();
  }
}

template <typename T>
static int launch(const T* x, T* y, int zp, int yp, int xp, int zdim,
                  int ydim, int xdim, int t, int zc, int ty, int tx,
                  int ring, int threads, int ntaps, const int* dz,
                  const int* dy, const int* dx, const double* coef,
                  void* stream) {
  if (ntaps < 1 || ntaps > STENCIL3D_MAX_TAPS || t < 1 || zc < 1 ||
      ty < 1 || tx < 1 || threads < 32 || threads % 32 != 0 ||
      threads > STENCIL3D_THREADS || zdim < 1 || ydim < 1 || xdim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapSet3<T> taps;
  taps.n = ntaps;
  int rad = 0, reach_y = 0, reach_x = 0;
  for (int q = 0; q < ntaps; ++q) {
    taps.dz[q] = dz[q];
    taps.dy[q] = dy[q];
    taps.dx[q] = dx[q];
    taps.c[q] = static_cast<T>(coef[q]);
    const int az = dz[q] < 0 ? -dz[q] : dz[q];
    const int ay = dy[q] < 0 ? -dy[q] : dy[q];
    const int ax = dx[q] < 0 ? -dx[q] : dx[q];
    if (az > rad) rad = az;
    if (ay > rad) rad = ay;
    if (ax > rad) rad = ax;
    if (ay > reach_y) reach_y = ay;
    if (ax > reach_x) reach_x = ax;
  }
  if (rad < 1 || rad > STENCIL3D_MAX_RADIUS || ring < 2 * rad + 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geom3 g;
  g.zdim = zdim;
  g.ydim = ydim;
  g.xdim = xdim;
  g.yp = yp;
  g.xp = xp;
  g.zc = zc;
  g.tiled_y = ty < ydim;
  g.tiled_x = tx < xdim;
  g.ty = g.tiled_y ? ty : ydim;
  g.tx = g.tiled_x ? tx : xdim;
  g.fy = g.tiled_y ? 0 : reach_y;
  g.fx = g.tiled_x ? 0 : reach_x;
  g.t = t;
  g.rad = rad;
  g.ring = ring;
  // the padded layout: z and tiled axes whole tiles, untiled axes the domain
  if (zp % zc != 0 || zp < zdim || (g.tiled_y ? yp % g.ty != 0 || yp < ydim
                                              : yp != ydim) ||
      (g.tiled_x ? xp % g.tx != 0 || xp < xdim : xp != xdim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t cells = 0;
  for (int s = 0; s < t; ++s) {
    const size_t ey = g.tiled_y ? g.ty + 2 * (t - s) * rad : ydim + 2 * g.fy;
    const size_t ex = g.tiled_x ? g.tx + 2 * (t - s) * rad : xdim + 2 * g.fx;
    cells += static_cast<size_t>(ring) * ey * ex;
  }
  const size_t smem = cells * sizeof(T);
  const dim3 grid(xp / g.tx, yp / g.ty, zp / zc);
  if (smem > 0x7fffffff || grid.y > 65535 || grid.z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      stream3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stream3d_kernel<T><<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(x, y, g, taps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int stencil3d_f32(const float* x, float* y, int zp, int yp, int xp,
                  int zdim, int ydim, int xdim, int t, int zc, int ty,
                  int tx, int ring, int threads, int ntaps, const int* dz,
                  const int* dy, const int* dx, const double* coef,
                  void* stream) {
  return launch<float>(x, y, zp, yp, xp, zdim, ydim, xdim, t, zc, ty, tx,
                       ring, threads, ntaps, dz, dy, dx, coef, stream);
}

int stencil3d_f64(const double* x, double* y, int zp, int yp, int xp,
                  int zdim, int ydim, int xdim, int t, int zc, int ty,
                  int tx, int ring, int threads, int ntaps, const int* dz,
                  const int* dy, const int* dx, const double* coef,
                  void* stream) {
  return launch<double>(x, y, zp, yp, xp, zdim, ydim, xdim, t, zc, ty, tx,
                        ring, threads, ntaps, dz, dy, dx, coef, stream);
}

const char* stencil3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
