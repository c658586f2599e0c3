// Flash attention, backward, for Hopper (sm_90a): two kernels in one
// source, both recomputing the probabilities from the forward's per-row
// logsumexp instead of reading an S x Sk matrix.
//
// Replaces the reference's Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_bwd_kernel
// whose grid (B*H, q-chunks, kv-chunks) runs in order on one core: dq for
// a query chunk is carried in VMEM across the kv axis, and dk/dv for a key
// chunk are read, added to and written back in device memory once per
// query chunk, per query head, and summed over each GQA group outside the
// kernel.  On a GPU the blocks of a grid run in parallel and in no order,
// so that read-modify-write would race.  Here the work is cut twice:
//
//   * flash_bwd_dq_kernel, query-major: one CTA per (batch*head, 64-query
//     tile) loops over the key tiles its rows keep and sums
//     dQ += dS K in registers, written once;
//   * flash_bwd_dkdv_kernel, key-major: one CTA per (batch, kv head, key
//     tile) keeps its K and V tile in shared memory and loops over the G
//     query heads of its group and, for each, over the query tiles that
//     keep some key of the tile (causal: q >= k; window: q < k + window),
//     summing dV += P^T dO and dK += dS^T Q in registers.  dK and dV are
//     written once, already summed over the group: no per-head f32 buffers
//     and no atomics.
//
// Both recompute, per (query tile, key tile):
//   s  = q k^T * scale,  p = exp(s - lse) where the mask keeps, else 0,
//   dp = do v^T,          ds = p * (dp - delta) * scale,
// with delta = rowsum(do * o) made by the wrapper (the reference makes it
// outside its kernel too).  A row that keeps no key (possible only when
// S >= Sk + window) has p = 0 everywhere and so gets no gradient, as in
// the reference's backward kernel.
//
// Threads: 256 as a 16 x 16 grid (ty, tx) = (tid / 16, tid % 16).  In the
// dQ kernel a thread owns query rows ty + 16*i (i < 4), keys tx + 16*j
// (j < KT) of the score tile, and output columns tx + 16*c (c < hd/16); in
// the dK/dV kernel it owns keys ty + 16*i (i < KT), queries tx + 16*j
// (j < 4) and the same columns.  Key tiles are 16*KT keys: 64 up to
// hd 128, 32 above, so that a CTA's shared memory stays under 227 KB.
// Everything is float32; q, k, v and do are read in their storage type
// (float32 or bfloat16) in place through strides, and dq, dk, dv are
// written in it, as the reference casts them.
//
// What bounds it on this card: 10*hd flops per kept (query, key) pair
// (two recomputed products and three gradient products) against q, k, v,
// o, do and lse read once and dq, dk, dv written once: the operations, at
// the tensor cores' bf16 rate.  This first version, like the forward, does
// them on the float32 FMA pipes out of shared memory, and the two kernels
// each recompute s and dp, so 14*hd flops per pair are issued; mma/wgmma,
// TMA and one pass are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FB_BQ 64
#define FB_THREADS 256
#define FB_MAX_HD 256

// error codes beyond cudaError_t's range (the forward's)
#define FB_ERR_HEAD_DIM 10001
#define FB_ERR_GROUPS 10002
#define FB_ERR_DTYPE 10003
#define FB_ERR_SHAPE 10004
#define FB_ERR_KERNEL 10005

struct FbArgs {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;    // (B*H, S)
    const float* delta;  // (B*H, S)
    void* dq;
    void* dk;
    void* dv;
    int S, Sk, H, KV, hd;
    long long q_sb, q_ss, q_sh;  // element strides; the last dim is dense
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long do_sb, do_ss, do_sh;
    long long dq_sb, dq_ss, dq_sh;
    long long dk_sb, dk_ss, dk_sh;
    long long dv_sb, dv_ss, dv_sh;
    int causal;
    int window;  // <= 0: no window
    float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as a cast
}

// the reference's mask: causal keeps key <= qpos, a window keeps
// key > qpos - window; rows past S and keys past Sk do not exist
__device__ __forceinline__ bool fb_keep(const FbArgs& a, int qpos, int key) {
    return qpos < a.S && key < a.Sk && !(a.causal && key > qpos)
           && !(a.window > 0 && key <= qpos - a.window);
}

// rows row0 .. row0+nrows-1 of a (rows, hd) slab into shared memory as
// float32 at row stride ld; rows at or past `limit` are zero
template <typename T>
__device__ __forceinline__ void fb_load_rows(float* dst, int ld, const T* src,
                                             long long row_stride, int row0,
                                             int nrows, int limit, int hd) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < nrows; r += FB_THREADS / 32) {
        const int row = row0 + r;
        const bool in = row < limit;
        const T* p = src + (long long)row * row_stride;
        for (int c = lane; c < hd; c += 32)
            dst[r * ld + c] = in ? to_f32(p[c]) : 0.f;
    }
}

// shared memory, in floats.  dQ: Q, dO (64 x hd+1), K, V (BK x hd+1),
// dS (64 x BK+1).  dK/dV: K, V (BK x hd+1), Q, dO (64 x hd+1), P, dS
// (BK x 65).  Odd row strides keep the rows a warp reads at once in
// different banks.
__host__ __device__ inline int fb_key_tile(int hd) {
    return hd <= 128 ? 64 : 32;
}
__host__ __device__ inline int fb_smem_floats(int kernel, int hd) {
    const int bk = fb_key_tile(hd);
    if (kernel == 0)
        return (2 * FB_BQ + 2 * bk) * (hd + 1) + FB_BQ * (bk + 1);
    return (2 * bk + 2 * FB_BQ) * (hd + 1) + 2 * bk * (FB_BQ + 1);
}

template <typename T, int MAXC, int KT>
__global__ void __launch_bounds__(FB_THREADS)
    flash_bwd_dq_kernel(FbArgs a) {
    extern __shared__ float smem[];
    constexpr int BK = 16 * KT;
    const int hd = a.hd;
    const int rs = hd + 1, dss = BK + 1;
    float* Qs = smem;
    float* dOs = Qs + FB_BQ * rs;
    float* Ks = dOs + FB_BQ * rs;
    float* Vs = Ks + BK * rs;
    float* dSs = Vs + BK * rs;

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    // the last query tiles keep the most keys under a causal mask: start
    // them first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FB_BQ;
    const int bh = blockIdx.y;
    const int b = bh / a.H, h = bh % a.H;
    const int kvh = h / (a.H / a.KV);  // GQA: kv row b*KV + h // G
    const int ncol = hd >> 4;

    const T* qg = (const T*)a.q + b * a.q_sb + h * a.q_sh;
    const T* dog = (const T*)a.dout + b * a.do_sb + h * a.do_sh;
    const T* kg = (const T*)a.k + b * a.k_sb + kvh * a.k_sh;
    const T* vg = (const T*)a.v + b * a.v_sb + kvh * a.v_sh;
    T* dqg = (T*)a.dq + b * a.dq_sb + h * a.dq_sh;

    fb_load_rows(Qs, rs, qg, a.q_ss, q0, FB_BQ, a.S, hd);
    fb_load_rows(dOs, rs, dog, a.do_ss, q0, FB_BQ, a.S, hd);
    float lse_r[4], dl_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        const bool in = qpos < a.S;
        lse_r[i] = in ? a.lse[(long long)bh * a.S + qpos] : 0.f;
        dl_r[i] = in ? a.delta[(long long)bh * a.S + qpos] : 0.f;
    }

    // the key tiles some row of this query tile keeps
    const int q_last = min(q0 + FB_BQ, a.S) - 1;
    int k_lo = 0, k_hi = a.Sk;
    if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
    if (a.causal) k_hi = min(a.Sk, q_last + 1);
    const int t_lo = k_lo / BK;
    const int t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;

    float acc[4][MAXC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.f;

    for (int t = t_lo; t < t_hi; ++t) {
        const int k0 = t * BK;
        __syncthreads();  // the previous tile's K and dS are consumed
        fb_load_rows(Ks, rs, kg, a.k_ss, k0, BK, a.Sk, hd);
        fb_load_rows(Vs, rs, vg, a.v_ss, k0, BK, a.Sk, hd);
        __syncthreads();

        float s[4][KT], dp[4][KT];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < KT; ++j) s[i][j] = dp[i][j] = 0.f;
        for (int d = 0; d < hd; ++d) {
            float qv[4], ov[4], kv[KT], vv[KT];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                qv[i] = Qs[(ty + 16 * i) * rs + d];
                ov[i] = dOs[(ty + 16 * i) * rs + d];
            }
#pragma unroll
            for (int j = 0; j < KT; ++j) {
                kv[j] = Ks[(tx + 16 * j) * rs + d];
                vv[j] = Vs[(tx + 16 * j) * rs + d];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < KT; ++j) {
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
                    dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < KT; ++j) {
                const int key = k0 + tx + 16 * j;
                float ds = 0.f;
                if (fb_keep(a, qpos, key)) {
                    const float p = expf(s[i][j] * a.scale - lse_r[i]);
                    ds = p * (dp[i][j] - dl_r[i]) * a.scale;
                }
                dSs[(ty + 16 * i) * dss + tx + 16 * j] = ds;
            }
        }
        __syncthreads();

        for (int kk = 0; kk < BK; ++kk) {
            float dsv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * dss + kk];
#pragma unroll
            for (int c = 0; c < MAXC; ++c) {
                if (c < ncol) {
                    const float kval = Ks[kk * rs + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][c] = fmaf(dsv[i], kval, acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        if (qpos >= a.S) continue;
        T* row = dqg + (long long)qpos * a.dq_ss;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
            if (c < ncol) row[tx + 16 * c] = from_f32<T>(acc[i][c]);
    }
}

template <typename T, int MAXC, int KT>
__global__ void __launch_bounds__(FB_THREADS)
    flash_bwd_dkdv_kernel(FbArgs a) {
    extern __shared__ float smem[];
    constexpr int BK = 16 * KT;
    const int hd = a.hd;
    const int rs = hd + 1, ps = FB_BQ + 1;
    float* Ks = smem;
    float* Vs = Ks + BK * rs;
    float* Qs = Vs + BK * rs;
    float* dOs = Qs + FB_BQ * rs;
    float* Ps = dOs + FB_BQ * rs;
    float* dSs = Ps + BK * ps;

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int k0 = blockIdx.x * BK;
    const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
    const int G = a.H / a.KV;
    const int ncol = hd >> 4;

    const T* kg = (const T*)a.k + b * a.k_sb + kvh * a.k_sh;
    const T* vg = (const T*)a.v + b * a.v_sb + kvh * a.v_sh;
    fb_load_rows(Ks, rs, kg, a.k_ss, k0, BK, a.Sk, hd);
    fb_load_rows(Vs, rs, vg, a.v_ss, k0, BK, a.Sk, hd);

    // the query tiles with a row that keeps some key of this tile
    const int k_last = min(k0 + BK, a.Sk) - 1;
    int q_lo = 0, q_hi = a.S;
    if (a.causal) q_lo = k0;
    if (a.window > 0) q_hi = min(a.S, k_last + a.window);
    const int t_lo = q_lo / FB_BQ;
    const int t_hi = q_hi > q_lo ? (q_hi + FB_BQ - 1) / FB_BQ : t_lo;

    float dk[KT][MAXC], dv[KT][MAXC];
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int c = 0; c < MAXC; ++c) dk[i][c] = dv[i][c] = 0.f;

    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const long long lrow = (long long)(b * a.H + h) * a.S;
        const T* qg = (const T*)a.q + b * a.q_sb + h * a.q_sh;
        const T* dog = (const T*)a.dout + b * a.do_sb + h * a.do_sh;
        for (int t = t_lo; t < t_hi; ++t) {
            const int q0 = t * FB_BQ;
            __syncthreads();  // the previous tile's Q, dO, P and dS consumed
            fb_load_rows(Qs, rs, qg, a.q_ss, q0, FB_BQ, a.S, hd);
            fb_load_rows(dOs, rs, dog, a.do_ss, q0, FB_BQ, a.S, hd);
            float lse_r[4], dl_r[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int qpos = q0 + tx + 16 * j;
                const bool in = qpos < a.S;
                lse_r[j] = in ? a.lse[lrow + qpos] : 0.f;
                dl_r[j] = in ? a.delta[lrow + qpos] : 0.f;
            }
            __syncthreads();

            float s[KT][4], dp[KT][4];
#pragma unroll
            for (int i = 0; i < KT; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
            for (int d = 0; d < hd; ++d) {
                float kv[KT], vv[KT], qv[4], ov[4];
#pragma unroll
                for (int i = 0; i < KT; ++i) {
                    kv[i] = Ks[(ty + 16 * i) * rs + d];
                    vv[i] = Vs[(ty + 16 * i) * rs + d];
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    qv[j] = Qs[(tx + 16 * j) * rs + d];
                    ov[j] = dOs[(tx + 16 * j) * rs + d];
                }
#pragma unroll
                for (int i = 0; i < KT; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
                        dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
                    }
            }

#pragma unroll
            for (int i = 0; i < KT; ++i) {
                const int key = k0 + ty + 16 * i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int qpos = q0 + tx + 16 * j;
                    float p = 0.f, ds = 0.f;
                    if (fb_keep(a, qpos, key)) {
                        p = expf(s[i][j] * a.scale - lse_r[j]);
                        ds = p * (dp[i][j] - dl_r[j]) * a.scale;
                    }
                    Ps[(ty + 16 * i) * ps + tx + 16 * j] = p;
                    dSs[(ty + 16 * i) * ps + tx + 16 * j] = ds;
                }
            }
            __syncthreads();

            for (int qq = 0; qq < FB_BQ; ++qq) {
                float pv[KT], dsv[KT];
#pragma unroll
                for (int i = 0; i < KT; ++i) {
                    pv[i] = Ps[(ty + 16 * i) * ps + qq];
                    dsv[i] = dSs[(ty + 16 * i) * ps + qq];
                }
#pragma unroll
                for (int c = 0; c < MAXC; ++c) {
                    if (c < ncol) {
                        const float ov = dOs[qq * rs + tx + 16 * c];
                        const float qv = Qs[qq * rs + tx + 16 * c];
#pragma unroll
                        for (int i = 0; i < KT; ++i) {
                            dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
                            dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
                        }
                    }
                }
            }
        }
    }

    T* dkg = (T*)a.dk + b * a.dk_sb + kvh * a.dk_sh;
    T* dvg = (T*)a.dv + b * a.dv_sb + kvh * a.dv_sh;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
        const int key = k0 + ty + 16 * i;
        if (key >= a.Sk) continue;
        T* dkr = dkg + (long long)key * a.dk_ss;
        T* dvr = dvg + (long long)key * a.dv_ss;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
            if (c < ncol) {
                dkr[tx + 16 * c] = from_f32<T>(dk[i][c]);
                dvr[tx + 16 * c] = from_f32<T>(dv[i][c]);
            }
    }
}

template <typename T, int MAXC, int KT>
static cudaError_t launch_one(int kernel, const FbArgs& a, int batch,
                              cudaStream_t st) {
    const int smem = fb_smem_floats(kernel, a.hd) * (int)sizeof(float);
    if (kernel == 0) {
        auto kern = flash_bwd_dq_kernel<T, MAXC, KT>;
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        dim3 grid((a.S + FB_BQ - 1) / FB_BQ, batch * a.H);
        kern<<<grid, FB_THREADS, smem, st>>>(a);
    } else {
        auto kern = flash_bwd_dkdv_kernel<T, MAXC, KT>;
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        dim3 grid((a.Sk + 16 * KT - 1) / (16 * KT), batch * a.KV);
        kern<<<grid, FB_THREADS, smem, st>>>(a);
    }
    return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_hd(int kernel, const FbArgs& a, int batch,
                             cudaStream_t st) {
    if (a.hd <= 64) return launch_one<T, 4, 4>(kernel, a, batch, st);
    if (a.hd <= 128) return launch_one<T, 8, 4>(kernel, a, batch, st);
    return launch_one<T, 16, 2>(kernel, a, batch, st);
}

extern "C" {

// kernel: 0 = dQ, 1 = dK/dV.  dtype: 0 float32, 1 bfloat16.  strides: 21
// element strides, in the order (batch, seq, head) for q, k, v, do, dq,
// dk and dv; each last dim is dense.  lse and delta: (B*H, S) float32.
// window <= 0: none.
int flash_bwd(int kernel, int dtype, const void* q, const void* k,
              const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, void* dk, void* dv, int batch,
              int S, int Sk, int H, int KV, int hd, const long long* strides,
              int causal, int window, float scale, void* stream) {
    if (kernel != 0 && kernel != 1) return FB_ERR_KERNEL;
    if (hd < 16 || hd > FB_MAX_HD || hd % 16) return FB_ERR_HEAD_DIM;
    if (KV < 1 || H % KV) return FB_ERR_GROUPS;
    if (batch < 1 || S < 1 || Sk < 1) return FB_ERR_SHAPE;
    FbArgs a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.dout = dout;
    a.lse = lse;
    a.delta = delta;
    a.dq = dq;
    a.dk = dk;
    a.dv = dv;
    a.S = S;
    a.Sk = Sk;
    a.H = H;
    a.KV = KV;
    a.hd = hd;
    long long* f[21] = {&a.q_sb,  &a.q_ss,  &a.q_sh,  &a.k_sb,  &a.k_ss,
                        &a.k_sh,  &a.v_sb,  &a.v_ss,  &a.v_sh,  &a.do_sb,
                        &a.do_ss, &a.do_sh, &a.dq_sb, &a.dq_ss, &a.dq_sh,
                        &a.dk_sb, &a.dk_ss, &a.dk_sh, &a.dv_sb, &a.dv_ss,
                        &a.dv_sh};
    for (int i = 0; i < 21; ++i) *f[i] = strides[i];
    a.causal = causal;
    a.window = window;
    a.scale = scale;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (dtype == 0)
        err = launch_hd<float>(kernel, a, batch, st);
    else if (dtype == 1)
        err = launch_hd<__nv_bfloat16>(kernel, a, batch, st);
    else
        return FB_ERR_DTYPE;
    return (int)err;
}

int flash_bwd_smem_bytes(int kernel, int hd) {
    return fb_smem_floats(kernel, hd) * (int)sizeof(float);
}

const char* flash_bwd_error_string(int err) {
    switch (err) {
        case FB_ERR_HEAD_DIM:
            return "head_dim must be a multiple of 16 in [16, 256]";
        case FB_ERR_GROUPS:
            return "kv_heads must divide heads";
        case FB_ERR_DTYPE:
            return "dtype must be float32 or bfloat16";
        case FB_ERR_SHAPE:
            return "batch, S and Sk must be >= 1";
        case FB_ERR_KERNEL:
            return "kernel must be 0 (dQ) or 1 (dK/dV)";
        default:
            return cudaGetErrorString((cudaError_t)err);
    }
}

}  // extern "C"
