// EBISU 3-D temporal blocking on Hopper: one CTA streams a z column of a
// 3-D field and applies t fused Jacobi steps of a 3-D tap set, the
// partial sums of each z column held in registers (the paper's register
// streaming, §4.3) and one plane buffer per time level in shared memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil3d.py::_stream_kernel
// (launched by ebisu3d_padded).  The function is the same: one sweep of t
// zero-Dirichlet steps on the padded layout, which holds the zdim x ydim x
// xdim domain at the origin and zeros outside it, on input and on output.
// A launch may take a batch of such layouts, one after another in memory
// (the reference vmaps its kernel over a leading batch axis): blockIdx.z
// runs over the z chunks of every field, field-major (blockIdx.z =
// field * nzc + chunk), and a CTA reads and writes its field's layout alone.
// Memory planes count through the batch (field f's plane z is plane
// f*zp + z), so a CTA keeps one plane offset, not two moved pointers; an
// interior CTA keeps no domain plane at all.
//
// Taps.  This is a template: it includes stencil3d_taps.cuh, which
// repro_torch/kernels/stencil3d_gen.py writes for one tap set (offsets,
// coefficients as exact hexadecimal literals, the compile-time bounds), so
// every tap loop below unrolls into loads and FMAs with constant offsets
// and coefficients.  One library per tap set; f32 and f64 are two
// instantiations in it.  The tile, the extents and the depth t are
// run-time arguments.
//
// Work of a CTA.  It owns a (zc, ty, tx) tile of output cells and reads
// the span = zc + 2*halo input planes of its column (halo = t*rad).  On a
// tiled in-plane axis a level-s plane spans tile + 2*(t-s)*rad cells: the
// trapezoid narrows by rad per step.  An untiled axis (its tile covers the
// domain) has no rim: its planes span the domain plus a zero frame as wide
// as the taps' reach on that axis; the lifted 2-D spec has y extent 1 and y
// reach 0, so its planes are single rows.  Each thread computes one level
// s = 1..t: the level's plane cells are spread over its threads, cell idx
// to thread idx % n_s (consecutive threads on consecutive cells), k cells
// a thread.  The caller passes k (the planner's kernel_threads_3d); the
// launcher refuses k above ST3_SLOTS_F32/F64, the cells a thread's
// registers hold, and a spread of more than ST3_THREADS threads.
//
// Register streaming.  For each of its cells a thread keeps the 2*rad
// partial sums of the output planes still waiting for input.  When plane j
// of level s-1 arrives it reads each distinct in-plane offset of the
// cell's neighbourhood once (5 reads for j3d7pt, 9 for the box and
// 13-point stars) and adds it, times each coefficient, into the partial
// sum of output plane j - dz of every tap at that offset; output plane
// j - rad is then complete, is masked to the domain and is stored: to the
// level's plane buffer, or to device memory at level t.  A sum gets its
// terms plane by plane (dz = -rad first), within a plane in the header's
// offset order.
//
// Schedule.  Every level advances B = ST3_PLANES planes between two
// barriers.  Level 0 (the input) is copied into its buffer with cp.async,
// batch it of the span in iteration it, and waited for just before the
// barrier, so the trip to device memory overlaps the levels' compute.
// Level s computes in iteration it the batch its level s-1 wrote in
// iteration it-1, so each level keeps two batches of B planes (parity
// it & 1: one written, one read) and one barrier per iteration orders
// every write before its reads and every read before the write that
// reuses its buffer.  A level skips planes outside its z trapezoid
// (level s needs strip planes s*rad .. span-1-s*rad); level t writes
// exactly the zc body planes.  Shared memory: 2*B planes of each level
// 0..t-1, B <= rad+1, so it never exceeds the planner's budget of 2*rad+2
// planes a level (kernel_smem_bytes_3d <= smem_bytes_3d).
//
// Edges.  A CTA whose whole input column (z span and in-plane rim) lies in
// the domain runs the interior variant: no domain test at all.  The others
// run the edge variant, which zero-fills input cells outside the domain
// (cp.async with source size 0) and stores 0 for every level cell outside
// it, on all three axes, so the output's padding is written as 0.
//
// What bounds it on the card: one sweep must read the domain and write the
// padded layout once, against 3.35 TB/s of HBM3, and do flops_per_cell * t
// * domain operations against 67 TFLOP/s fp32 (34 fp64).  The trapezoid's
// redundant cells (tiles of 32 x 32 at depth 8 compute 1.5x their body)
// and the instructions per cell-update (offset loads, FMAs, the index walk
// of each cell once per batch) stay above that bound.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared -I<dir of
// the generated header> (see src/repro_torch/kernels/_build.py); bound
// from Python with ctypes, through the plain C functions at the end of this
// file.  Global offsets are 64-bit: the f64 padded field at the paper's
// 2560 x 288 x 384 is 2.3 GB.

#include <cuda_runtime.h>

#include <cstddef>

#include "stencil3d_taps.cuh"

// One time level's plane (levels 0..t), computed by the launcher.
struct Level3 {
  int ey, ex;      // plane extent: rows, and the row pitch of its buffer
  int y_lo, x_lo;  // first row and column the level computes (level 0: loads)
  int ny, nx;      // rows and columns it computes
  int oy, ox;      // global y, x of plane index 0, less the tile's origin
  int smem;        // element offset of its two batches (levels 0..t-1)
  int first;       // its first thread (levels 1..t)
};

struct Geom3 {
  int zdim, ydim, xdim;  // the domain
  int yp, xp;            // padded plane: yp rows of xp cells
  int zc, ty, tx;        // output tile (ty == ydim: y untiled, ...)
  int zp, nzc;           // planes of one field's padded layout; zp / zc
  int t, halo, span, nbatch;
  int threads;           // threads that compute (the end of level t's)
  int shy, shx;          // level s index i reads level s-1 index i + sh
  int smem_cells;
  Level3 lv[ST3_MAX_DEPTH + 1];
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

// Copy N bytes from device to shared memory asynchronously; src_bytes 0
// writes zeros and reads nothing.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int K, bool EDGE>
__device__ __forceinline__ void stream_cta(const T* __restrict__ x,
                                           T* __restrict__ y,
                                           const Geom3& g, int chunk,
                                           int field, T* sm) {
  constexpr int R = ST3_RADIUS;
  constexpr int B = ST3_PLANES;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int z_base = chunk * g.zc - g.halo;  // global z of strip plane 0
  const int zm_base = z_base + field * g.zp;  // its memory plane
  const int y_tile = blockIdx.y * g.ty;
  const int x_tile = blockIdx.x * g.tx;
  const size_t gplane = static_cast<size_t>(g.yp) * g.xp;

  // level 0: this thread loads cells tid, tid + nth, ... of each plane
  const Level3& L0 = g.lv[0];
  const int n0 = L0.ny * L0.nx;
  const int plane0 = L0.ey * L0.ex;
  const int q0 = nth / L0.nx, r0 = nth % L0.nx;
  const int iy0 = tid / L0.nx, ix0 = tid % L0.nx;
  const int gy00 = y_tile + L0.oy + L0.y_lo;  // global y of load row 0
  const int gx00 = x_tile + L0.ox + L0.x_lo;

  // the level this thread computes, and its first cell
  int s = 1;
  while (s < g.t && tid >= g.lv[s + 1].first) ++s;
  const bool computes = tid < g.threads;
  const bool last = s == g.t;
  const Level3& L = g.lv[s];
  const Level3& Lp = g.lv[s - 1];
  const int n_s = (last ? g.threads : g.lv[s + 1].first) - L.first;
  const int lt = computes ? tid - L.first : 0;
  const int q = n_s / L.nx, r = n_s % L.nx;
  const int iys = lt / L.nx, ixs = lt % L.nx;
  const int plane = L.ey * L.ex;
  const int plane_p = Lp.ey * Lp.ex;
  const int src0 = (L.y_lo + g.shy) * Lp.ex + L.x_lo + g.shx;
  const int dst0 = L.y_lo * L.ex + L.x_lo;
  const int gy0 = y_tile + L.oy + L.y_lo;  // global y of computed row 0
  const int gx0 = x_tile + L.ox + L.x_lo;

  T acc[K][2 * R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) acc[k][i] = T(0);
  }
  // Zero every buffer once: the frames of untiled axes are never written.
  for (int i = tid; i < g.smem_cells; i += nth) sm[i] = T(0);
  __syncthreads();

  for (int it = 0; it < g.nbatch + g.t; ++it) {
    // ---- level 0: input batch it into its buffer it & 1, asynchronously
    if (it < g.nbatch) {
      T* buf = sm + L0.smem + (it & 1) * B * plane0 + L0.y_lo * L0.ex +
               L0.x_lo;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int p = it * B + b;
        if (p < g.span) {
          const int gz = z_base + p;
          const bool z_in = !EDGE || (gz >= 0 && gz < g.zdim);
          int iy = iy0, ix = ix0;
          for (int idx = tid; idx < n0; idx += nth) {
            const int gy = gy00 + iy;
            const int gx = gx00 + ix;
            bool in = true;
            if (EDGE) {
              in = z_in && gy >= 0 && gy < g.ydim && gx >= 0 && gx < g.xdim;
            }
            const T* src = in ? x + static_cast<size_t>(zm_base + p) * gplane +
                                    static_cast<size_t>(gy) * g.xp + gx
                              : x;
            cp_async<sizeof(T)>(buf + b * plane0 + iy * L0.ex + ix, src,
                                in ? static_cast<int>(sizeof(T)) : 0);
            ix += r0;
            iy += q0;
            if (ix >= L0.nx) {
              ix -= L0.nx;
              ++iy;
            }
          }
        }
      }
    }
    // ---- level s: batch m = it - s, from level s-1's batch of it-1 ------
    const int m = it - s;
    if (computes && m >= 0 && m < g.nbatch) {
      const T* src_b = sm + Lp.smem + ((it - 1) & 1) * B * plane_p + src0;
      T* dst_b = sm + L.smem + (it & 1) * B * plane + dst0;
      bool in_ok[B], out_ok[B], z_in[B];
      size_t gz_off[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int p_in = m * B - (s - 1) * R + b;  // plane of level s-1
        const int p_out = p_in - R;                // plane it completes
        in_ok[b] = p_in >= (s - 1) * R && p_in < g.span - (s - 1) * R;
        out_ok[b] = p_out >= s * R && p_out < g.span - s * R;
        const int gz = z_base + p_out;
        z_in[b] = !EDGE || (gz >= 0 && gz < g.zdim);
        gz_off[b] = out_ok[b] && last
                        ? static_cast<size_t>(zm_base + p_out) * gplane
                        : 0;
      }
      int iy = iys, ix = ixs;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (iy < L.ny) {
          const T* c0 = src_b + iy * Lp.ex + ix;
          const int d = iy * L.ex + ix;
          bool in_plane = true;
          if (EDGE) {
            in_plane = gy0 + iy >= 0 && gy0 + iy < g.ydim && gx0 + ix >= 0 &&
                       gx0 + ix < g.xdim;
          }
          const size_t go = static_cast<size_t>(gy0 + iy) * g.xp + gx0 + ix;
#pragma unroll
          for (int b = 0; b < B; ++b) {
            T w[2 * R + 1];
#pragma unroll
            for (int i = 0; i < 2 * R; ++i) w[i] = acc[k][i];
            w[2 * R] = T(0);
            if (in_ok[b]) {
              const T* c = c0 + b * plane_p;
#define ST3_OFFSET(DY, DX, TERMS)              \
  {                                            \
    const T v = c[(DY) * Lp.ex + (DX)];        \
    TERMS                                      \
  }
#define ST3_TAP(DZ, COEF) \
  w[R - (DZ)] = fma_t<T>(static_cast<T>(COEF), v, w[R - (DZ)]);
              ST3_OFFSETS(ST3_OFFSET, ST3_TAP)
#undef ST3_TAP
#undef ST3_OFFSET
            }
            if (out_ok[b]) {
              T o = w[0];
              if (EDGE && !(z_in[b] && in_plane)) o = T(0);
              if (last) {
                y[gz_off[b] + go] = o;
              } else {
                dst_b[b * plane + d] = o;
              }
            }
#pragma unroll
            for (int i = 0; i < 2 * R; ++i) acc[k][i] = w[i + 1];
          }
        }
        ix += r;
        iy += q;
        if (ix >= L.nx) {
          ix -= L.nx;
          ++iy;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(ST3_THREADS, 1)
    stream3d_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const __grid_constant__ Geom3 g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int chunk = static_cast<int>(blockIdx.z) % g.nzc;
  const int field = static_cast<int>(blockIdx.z) / g.nzc;
  const Level3& L0 = g.lv[0];
  const int z_base = chunk * g.zc - g.halo;
  const int gy = blockIdx.y * g.ty + L0.oy + L0.y_lo;
  const int gx = blockIdx.x * g.tx + L0.ox + L0.x_lo;
  const bool interior = z_base >= 0 && z_base + g.span <= g.zdim &&
                        gy >= 0 && gy + L0.ny <= g.ydim && gx >= 0 &&
                        gx + L0.nx <= g.xdim;
  if (interior) {
    stream_cta<T, K, false>(x, y, g, chunk, field, sm);
  } else {
    stream_cta<T, K, true>(x, y, g, chunk, field, sm);
  }
}

// The launch's geometry: levels, thread spread (k cells a thread) and
// shared memory, as the planner's kernel_threads_3d and
// kernel_smem_bytes_3d compute them.  Returns cudaErrorInvalidValue for
// what the kernel cannot run.
static int plan_launch(int itemsize, int slots, int zdim, int ydim, int xdim,
                       int t, int zc, int ty, int tx, int k, Geom3* g,
                       int* block, size_t* smem) {
  constexpr int R = ST3_RADIUS;
  constexpr int B = ST3_PLANES;
  if (t < 1 || t > ST3_MAX_DEPTH || zc < 1 || ty < 1 || tx < 1 ||
      zdim < 1 || ydim < 1 || xdim < 1 || k < 1 || k > slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tiled_y = ty < ydim, tiled_x = tx < xdim;
  const int fy = tiled_y ? 0 : ST3_REACH_Y;
  const int fx = tiled_x ? 0 : ST3_REACH_X;
  g->zdim = zdim;
  g->ydim = ydim;
  g->xdim = xdim;
  g->zc = zc;
  g->ty = tiled_y ? ty : ydim;
  g->tx = tiled_x ? tx : xdim;
  g->t = t;
  g->halo = t * R;
  g->span = zc + 2 * g->halo;
  g->nbatch = (g->span + B - 1) / B;
  g->shy = tiled_y ? R : 0;
  g->shx = tiled_x ? R : 0;
  long long cells = 0, first = 0;
  for (int s = 0; s <= t; ++s) {
    Level3& L = g->lv[s];
    const int rim = (t - s) * R;
    L.ey = tiled_y ? g->ty + 2 * rim : ydim + 2 * fy;
    L.ex = tiled_x ? g->tx + 2 * rim : xdim + 2 * fx;
    L.y_lo = tiled_y ? 0 : fy;
    L.x_lo = tiled_x ? 0 : fx;
    L.ny = tiled_y ? L.ey : ydim;
    L.nx = tiled_x ? L.ex : xdim;
    L.oy = tiled_y ? -rim : -fy;
    L.ox = tiled_x ? -rim : -fx;
    L.smem = static_cast<int>(cells);
    L.first = static_cast<int>(first);
    if (s < t) cells += 2LL * B * L.ey * L.ex;
    if (s > 0) first += (static_cast<long long>(L.ny) * L.nx + k - 1) / k;
    if (first > ST3_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  }
  g->threads = static_cast<int>(first);
  g->smem_cells = static_cast<int>(cells);
  *block = (g->threads + 31) / 32 * 32;
  *smem = static_cast<size_t>(cells) * itemsize;
  return 0;
}

template <typename T, int K>
static int launch(const T* x, T* y, int batch, int zp, int yp, int xp,
                  int zdim, int ydim, int xdim, int t, int zc, int ty, int tx,
                  int k, void* stream) {
  Geom3 g;
  int block = 0;
  size_t smem = 0;
  int err = plan_launch(sizeof(T), K, zdim, ydim, xdim, t, zc, ty, tx, k, &g,
                        &block, &smem);
  if (err != 0) return err;
  g.yp = yp;
  g.xp = xp;
  g.zp = zp;
  g.nzc = zp / zc;
  // the padded layout: z and tiled axes whole tiles, untiled axes the domain
  if (batch < 1 || zp % zc != 0 || zp < zdim ||
      (g.ty < ydim ? yp % g.ty != 0 || yp < ydim : yp != ydim) ||
      (g.tx < xdim ? xp % g.tx != 0 || xp < xdim : xp != xdim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long zgrid = static_cast<long long>(g.nzc) * batch;
  if (smem > 0x7fffffff || yp / g.ty > 65535 || zgrid > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(xp / g.tx, yp / g.ty, static_cast<unsigned>(zgrid));
  cudaError_t e = cudaFuncSetAttribute(
      stream3d_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  stream3d_kernel<T, K><<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(x, y, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// batch padded layouts of (zp, yp, xp), one after another; batch 1 is one
// field
int stencil3d_f32(const float* x, float* y, int batch, int zp, int yp,
                  int xp, int zdim, int ydim, int xdim, int t, int zc,
                  int ty, int tx, int k, void* stream) {
  return launch<float, ST3_SLOTS_F32>(x, y, batch, zp, yp, xp, zdim, ydim,
                                      xdim, t, zc, ty, tx, k, stream);
}

int stencil3d_f64(const double* x, double* y, int batch, int zp, int yp,
                  int xp, int zdim, int ydim, int xdim, int t, int zc,
                  int ty, int tx, int k, void* stream) {
  return launch<double, ST3_SLOTS_F64>(x, y, batch, zp, yp, xp, zdim, ydim,
                                       xdim, t, zc, ty, tx, k, stream);
}

// The block size and shared memory a launch of k cells a thread would take
// (0), or the error code it would return.
int stencil3d_shape(int itemsize, int zdim, int ydim, int xdim, int t,
                    int zc, int ty, int tx, int k, int* block,
                    long long* smem_bytes) {
  Geom3 g;
  size_t smem = 0;
  const int slots = itemsize == 8 ? ST3_SLOTS_F64 : ST3_SLOTS_F32;
  const int err = plan_launch(itemsize, slots, zdim, ydim, xdim, t, zc, ty,
                              tx, k, &g, block, &smem);
  *smem_bytes = static_cast<long long>(smem);
  return err;
}

const char* stencil3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
