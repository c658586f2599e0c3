// EBISU 2-D temporal blocking on Hopper: one CTA applies t fused Jacobi
// steps of a 2-D tap set to one tile held in shared memory, each thread
// computing R vertically consecutive cells of a step in registers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil2d.py::_strip_kernel
// (launched by ebisu2d_padded).  The function is the same: one sweep of t
// zero-Dirichlet steps on the padded (hp, wp) layout, which holds the
// height x width domain at the origin and zeros outside it, on input and
// on output (the input's padding may hold anything: it is read as 0).
// A launch may take a batch of such layouts, one after another in memory
// (the reference vmaps its kernel over a leading batch axis): blockIdx.z
// is the field, and its CTAs read and write that field's layout alone.
// Memory rows count through the batch (field f's row r is row f*hp + r),
// so a CTA keeps one row offset, not two moved pointers; an interior CTA
// keeps no domain row at all.
// The TPU kernel streams full-width strips through 128 MiB of VMEM; here
// a block has at most 227 KB of shared memory, so both axes are tiled.
//
// Taps.  This is a template: it includes stencil2d_taps.cuh, which
// repro_torch/kernels/stencil2d_gen.py writes for one tap set (the taps
// grouped by column offset dx, each with its (dy, coefficient) list, the
// coefficients as exact hexadecimal literals, the compile-time bounds), so
// every tap loop below unrolls into shared loads at constant offsets and
// FMAs with constant coefficients.  One library per tap set; f32 and f64
// are two instantiations in it.  The tile (bh, bw), the extents and the
// depth t are run-time arguments.
//
// Work of a CTA.  It owns a bh x bw tile of output cells and loads the
// (bh + 2*halo) x (bw + 2*halo) tile around it (halo = t*rad, the padded
// layout's rim), cells outside the domain as 0.  Step s = 1..t computes
// the level-s region: the output tile widened by (t-s)*ry rows and
// (t-s)*rx columns on each side (ry, rx: the taps' reach on each axis),
// the trapezoid that can still reach the output.  Steps ping-pong between
// two shared buffers of the whole tile with one barrier between steps;
// step t writes its region, the output tile, straight to device memory.
//
// Rows blocked in registers.  A step's region is cut into blocks of R rows
// (R = ST2_ROWS_F32/F64) by column; consecutive threads take consecutive
// columns, and a thread walks its blocks at strides computed once per
// step (no division per cell).  For its block a thread keeps R
// accumulators, walks the R + 2*ry input rows of its column once, reads
// each column offset dx of a row once, and adds it, times each
// coefficient, into the accumulator of every cell whose tap dy reaches
// that row: shared reads per cell-update fall from taps + 1 to about
// sum over dx of (R + dy span)/R, and the R accumulators are R independent
// FMA chains.  Each accumulator takes its terms row by row (dy ascending),
// within a row in the header's column order.  The last block of a column
// starts R rows before the region's end, so it overlaps its neighbour
// (which computes the same values from the same reads) and never reads
// outside the level below; a step whose region has fewer than R rows runs
// one row a thread.
//
// Edges.  A CTA whose loaded tile lies wholly inside the domain runs the
// interior variant: no domain test in its load or in any step.  The others
// run the edge variant, which loads 0 outside the domain and stores 0 for
// every cell outside it at every step, on both axes, so the output's
// padding is written as 0.
//
// What bounds it on the card: one sweep must read the domain and write the
// padded layout once, against 3.35 TB/s of HBM3, and do flops_per_cell * t
// * height * width operations against 67 TFLOP/s fp32 (34 fp64).  Above
// that bound it pays the tiles' overlap and the trapezoid's redundant
// cell-updates (j2d5pt at its plan: 1.25x the outputs), the shared reads
// (3.25 a cell-update for j2d5pt at R = 8), and the instructions around
// the FMAs (address and loop arithmetic, stores, the barrier per step).
// Shared memory is the planner's two buffers of the whole tile
// (smem_bytes_2d); 512 threads a CTA, at most 64 registers a thread, so
// that two CTAs share an SM.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared -I<dir of
// the generated header> (see src/repro_torch/kernels/_build.py); bound
// from Python with ctypes, through the plain C functions at the end of
// this file.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "stencil2d_taps.cuh"

struct Geom2 {
  int hp, wp;         // rows of one field's padded layout, and its pitch
  int height, width;  // the domain
  int t, bh, bw, halo;
  int pitch;          // bw + 2*halo: the row pitch of both shared buffers
  int buf_cells;      // (bh + 2*halo) * pitch: one shared buffer
};

template <typename T>
__device__ __forceinline__ T fma_t(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_t<float>(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
template <>
__device__ __forceinline__ double fma_t<double>(double a, double b,
                                                double c) {
  return __fma_rn(a, b, c);
}

// 0 <= i < n
__device__ __forceinline__ bool inside(int i, int n) {
  return i >= 0 && i < n;
}

// One step: the level-s region, rows [ly, ly + ny) x columns [lx, lx + nx)
// of the tile, from the level below in src; into dst, or at the last step
// into y.  RB rows a thread (RB <= ny).  r0: the domain row of tile row 0
// (edge tests), rm: its memory row.
template <typename T, int RB, bool EDGE>
__device__ __forceinline__ void step_rows(const T* __restrict__ src,
                                          T* __restrict__ dst,
                                          T* __restrict__ y, const Geom2& g,
                                          int r0, int rm, int c0, int ly,
                                          int lx, int ny, int nx, bool last) {
  constexpr int RY = ST2_REACH_Y;
  const int nb = (ny + RB - 1) / RB;
  const int items = nb * nx;
  const int q = ST2_THREADS / nx, rq = ST2_THREADS % nx;
  int b = static_cast<int>(threadIdx.x) / nx;
  int c = static_cast<int>(threadIdx.x) % nx;
  for (int idx = threadIdx.x; idx < items; idx += ST2_THREADS) {
    const int rb = ly + min(b * RB, ny - RB);  // first row of the block
    const int cc = lx + c;
    T acc[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[j] = T(0);
    const T* col = src + (rb - RY) * g.pitch + cc;
#pragma unroll
    for (int i = 0; i < RB + 2 * RY; ++i) {
      const T* p = col + i * g.pitch;
#define ST2_COLUMN(DX, TERMS) \
  {                           \
    const T v = p[(DX)];      \
    TERMS                     \
  }
#define ST2_TAP(DY, COEF)                                          \
  {                                                                \
    const int j = i - RY - (DY);                                   \
    if (j >= 0 && j < RB) {                                        \
      acc[j] = fma_t<T>(static_cast<T>(COEF), v, acc[j]);          \
    }                                                              \
  }
      ST2_COLUMNS(ST2_COLUMN, ST2_TAP)
#undef ST2_TAP
#undef ST2_COLUMN
    }
    const bool col_in = !EDGE || inside(c0 + cc, g.width);
    if (last) {
      T* out = y + static_cast<size_t>(rm + rb) * g.wp + (c0 + cc);
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        T o = acc[j];
        if (EDGE && !(col_in && inside(r0 + rb + j, g.height))) o = T(0);
        out[static_cast<size_t>(j) * g.wp] = o;
      }
    } else {
      T* out = dst + rb * g.pitch + cc;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        T o = acc[j];
        if (EDGE && !(col_in && inside(r0 + rb + j, g.height))) o = T(0);
        out[j * g.pitch] = o;
      }
    }
    c += rq;
    b += q;
    if (c >= nx) {
      c -= nx;
      ++b;
    }
  }
}

template <typename T, int R, bool EDGE>
__device__ __forceinline__ void tile_cta(const T* __restrict__ x,
                                         T* __restrict__ y, const Geom2& g,
                                         T* sm) {
  constexpr int RY = ST2_REACH_Y, RX = ST2_REACH_X;
  // global row and column of tile cell (0, 0), and its memory row
  const int r0 = static_cast<int>(blockIdx.y) * g.bh - g.halo;
  const int c0 = static_cast<int>(blockIdx.x) * g.bw - g.halo;
  const int rm = r0 + static_cast<int>(blockIdx.z) * g.hp;
  T* src = sm;
  T* dst = sm + g.buf_cells;

  // level 0: rows [ly, ly + ny) x columns [lx, lx + nx) of the tile
  {
    const int ly = g.halo - g.t * RY, lx = g.halo - g.t * RX;
    const int ny = g.bh + 2 * g.t * RY, nx = g.bw + 2 * g.t * RX;
    const int n = ny * nx;
    const int q = ST2_THREADS / nx, rq = ST2_THREADS % nx;
    int iy = static_cast<int>(threadIdx.x) / nx;
    int ix = static_cast<int>(threadIdx.x) % nx;
    for (int idx = threadIdx.x; idx < n; idx += ST2_THREADS) {
      const int gr = r0 + ly + iy, gc = c0 + lx + ix;
      const size_t at = static_cast<size_t>(rm + ly + iy) * g.wp + gc;
      T v;
      if (EDGE) {
        v = inside(gr, g.height) && inside(gc, g.width) ? x[at] : T(0);
      } else {
        v = x[at];
      }
      src[(ly + iy) * g.pitch + lx + ix] = v;
      ix += rq;
      iy += q;
      if (ix >= nx) {
        ix -= nx;
        ++iy;
      }
    }
  }
  __syncthreads();

  for (int s = 1; s <= g.t; ++s) {
    const int ly = g.halo - (g.t - s) * RY, lx = g.halo - (g.t - s) * RX;
    const int ny = g.bh + 2 * (g.t - s) * RY, nx = g.bw + 2 * (g.t - s) * RX;
    const bool last = s == g.t;
    if (ny >= R) {
      step_rows<T, R, EDGE>(src, dst, y, g, r0, rm, c0, ly, lx, ny, nx,
                            last);
    } else {
      step_rows<T, 1, EDGE>(src, dst, y, g, r0, rm, c0, ly, lx, ny, nx,
                            last);
    }
    if (!last) {
      __syncthreads();
      T* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(ST2_THREADS, 2)
    tile2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const __grid_constant__ Geom2 g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  // global row and column of the loaded tile's first cell
  const int gr = static_cast<int>(blockIdx.y) * g.bh - g.t * ST2_REACH_Y;
  const int gc = static_cast<int>(blockIdx.x) * g.bw - g.t * ST2_REACH_X;
  const bool interior = gr >= 0 &&
                        gr + g.bh + 2 * g.t * ST2_REACH_Y <= g.height &&
                        gc >= 0 &&
                        gc + g.bw + 2 * g.t * ST2_REACH_X <= g.width;
  if (interior) {
    tile_cta<T, R, false>(x, y, g, sm);
  } else {
    tile_cta<T, R, true>(x, y, g, sm);
  }
}

template <typename T, int R>
static int launch(const T* x, T* y, int batch, int hp, int wp, int height,
                  int width, int t, int bh, int bw, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || bh < 1 || bw < 1 ||
      height < 1 || width < 1 || height > hp || width > wp ||
      hp % bh != 0 || wp % bw != 0 || t > INT_MAX / 2 / ST2_RADIUS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long halo = static_cast<long long>(t) * ST2_RADIUS;
  const long long cells = (bh + 2 * halo) * (bw + 2 * halo);
  const long long smem = 2 * cells * static_cast<long long>(sizeof(T));
  if (bw + 2 * halo > INT_MAX || 2 * cells > INT_MAX || smem > INT_MAX ||
      hp / bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geom2 g;
  g.hp = hp;
  g.wp = wp;
  g.height = height;
  g.width = width;
  g.t = t;
  g.bh = bh;
  g.bw = bw;
  g.halo = static_cast<int>(halo);
  g.pitch = static_cast<int>(bw + 2 * halo);
  g.buf_cells = static_cast<int>(cells);
  cudaError_t err = cudaFuncSetAttribute(
      tile2d_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(wp / bw, hp / bh, batch);
  tile2d_kernel<T, R><<<grid, ST2_THREADS, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(x, y, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// batch padded layouts of (hp, wp), one after another; batch 1 is one field
int stencil2d_f32(const float* x, float* y, int batch, int hp, int wp,
                  int height, int width, int t, int bh, int bw,
                  void* stream) {
  return launch<float, ST2_ROWS_F32>(x, y, batch, hp, wp, height, width, t,
                                     bh, bw, stream);
}

int stencil2d_f64(const double* x, double* y, int batch, int hp, int wp,
                  int height, int width, int t, int bh, int bw,
                  void* stream) {
  return launch<double, ST2_ROWS_F64>(x, y, batch, hp, wp, height, width, t,
                                      bh, bw, stream);
}

const char* stencil2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
