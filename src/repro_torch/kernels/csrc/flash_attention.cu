// Flash attention, forward, for Hopper (sm_90a): one CTA per
// (batch*head, 64-query tile), looping over 64-key tiles of K and V
// staged in shared memory, with an online softmax kept in registers.
//
// Replaces the reference's Pallas TPU kernels
//   src/repro/kernels/flash_attention.py::_kernel          (lse off)
//   src/repro/kernels/flash_attention.py::_fwd_kernel_lse  (lse on)
// which run a grid (B*H, q-chunks, kv-chunks) whose kv axis is sequential
// and carries (acc, m, l) in VMEM scratch from one grid step to the next.
// Here the sequential axis is a loop inside the CTA, and the running
// state lives in registers:
//
//   * 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns query rows
//     ty + 16*i (i < 4) and, in the 64x64 score tile, keys tx + 16*j
//     (j < 4); in the output it owns columns tx + 16*c (c < hd/16).
//   * S = Q K^T is a 4x4 register micro-tile per thread; the row max and
//     row sum are butterfly reductions over the 16 lanes of a half-warp
//     (every lane ends with the same bits), so m and l are per-thread
//     registers, not the reference's (qc, 128) lane-broadcast scratch.
//   * P goes through shared memory once for P V.
//   * Everything is float32, as the reference computes (:45-47); q, k, v
//     are read in their storage type (float32 or bfloat16) and the output
//     is written in it, at its (B, S, H, hd) place through the strides the
//     wrapper passes, so no transposed copy is made on either side.
//
// Masks are the reference's: causal keeps kpos <= qpos, a window keeps
// kpos > qpos - window; a masked score is the finite -1e30 (never -inf),
// so a key tile that is wholly masked before a row's first valid key adds
// terms that the later correction exp(-1e30 - m) = 0 erases exactly.
// Keys past the end of K (a ragged last tile) are -inf: they do not exist.
// Key tiles wholly above the causal diagonal or before the window are
// skipped, which leaves the result unchanged unless some row of the tile
// has no valid key at all (possible only when S >= Sk + window); such a
// tile runs over every key tile, and its fully masked rows average all
// keys, as the reference's finite sentinel makes them do.
//
// What bounds it on this card: at h2o-danube-1.8b's prefill (S = 8192,
// window 4096, hd 80) the work is 4*hd flops per valid (query, key) pair,
// far above the bytes (q, k, v read once, o written once): the bound is
// the operations, at the tensor cores' bf16 rate.  The tile skipping keeps
// the operations to what the mask needs, to a tile's granularity.  This
// first kernel does them on the float32 FMA pipes, with one shared-memory
// load per two FMAs in the score loop and no overlap of the K/V loads
// with compute; wgmma, TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG_INF (-1e30f)
#define FA_MAX_HD 256

// error codes beyond cudaError_t's range
#define FA_ERR_HEAD_DIM 10001
#define FA_ERR_GROUPS 10002
#define FA_ERR_DTYPE 10003
#define FA_ERR_SHAPE 10004

struct FaArgs {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;  // (B*H, S) or null
    int S, Sk, H, KV, hd;
    long long q_sb, q_ss, q_sh;  // element strides; the last dim is dense
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_ss, o_sh;
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

// shared-memory layout, in floats: Q (BQ x hd+1), K (BK x hd+1),
// V (BK x hd), P (BQ x BK+1).  The odd row strides of Q, K and P keep the
// two rows a warp reads at once in different banks.
__host__ __device__ inline int fa_smem_floats(int hd) {
    return FA_BQ * (hd + 1) + FA_BK * (hd + 1) + FA_BK * hd
           + FA_BQ * (FA_BK + 1);
}

template <typename T, bool LSE, int MAXC>
__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd_kernel(FaArgs a) {
    extern __shared__ float smem[];
    const int hd = a.hd;
    const int qs = hd + 1, ks = hd + 1, ps = FA_BK + 1;
    float* Qs = smem;
    float* Ks = Qs + FA_BQ * qs;
    float* Vs = Ks + FA_BK * ks;
    float* Ps = Vs + FA_BK * hd;

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int warp = tid >> 5, lane = tid & 31;
    // the last query tiles carry the most causal work: start them first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
    const int bh = blockIdx.y;
    const int b = bh / a.H, h = bh % a.H;
    const int kvh = h / (a.H / a.KV);  // GQA: kv row b*KV + h // G
    const int ncol = hd >> 4;

    const T* qg = (const T*)a.q + b * a.q_sb + h * a.q_sh;
    const T* kg = (const T*)a.k + b * a.k_sb + kvh * a.k_sh;
    const T* vg = (const T*)a.v + b * a.v_sb + kvh * a.v_sh;
    T* og = (T*)a.o + b * a.o_sb + h * a.o_sh;

    for (int r = warp; r < FA_BQ; r += FA_THREADS / 32) {
        const int qpos = q0 + r;
        for (int c = lane; c < hd; c += 32)
            Qs[r * qs + c] =
                qpos < a.S ? to_f32(qg[(long long)qpos * a.q_ss + c]) : 0.f;
    }

    // the key tiles this query tile needs
    const int q_last = min(q0 + FA_BQ, a.S) - 1;
    const bool windowed = a.window > 0;
    int k_lo = 0, k_hi = a.Sk;
    if (!(windowed && q_last >= a.Sk + a.window - 1)) {
        if (windowed) k_lo = max(0, q0 - a.window + 1);
        if (a.causal) k_hi = min(a.Sk, q_last + 1);
    }
    const int t_lo = k_lo / FA_BK, t_hi = (k_hi + FA_BK - 1) / FA_BK;

    float m_r[4], l_r[4], acc[4][MAXC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_r[i] = FA_NEG_INF;
        l_r[i] = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.f;
    }

    for (int t = t_lo; t < t_hi; ++t) {
        const int k0 = t * FA_BK;
        __syncthreads();  // the previous tile's K, V and P are consumed
        for (int r = warp; r < FA_BK; r += FA_THREADS / 32) {
            const int key = k0 + r;
            const bool in = key < a.Sk;
            const T* kr = kg + (long long)key * a.k_ss;
            const T* vr = vg + (long long)key * a.v_ss;
            for (int c = lane; c < hd; c += 32) {
                Ks[r * ks + c] = in ? to_f32(kr[c]) : 0.f;
                Vs[r * hd + c] = in ? to_f32(vr[c]) : 0.f;
            }
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int d = 0; d < hd; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * qs + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ks + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int key = k0 + tx + 16 * j;
                float x = s[i][j] * a.scale;
                if (key >= a.Sk) {
                    x = -INFINITY;
                } else if ((a.causal && key > qpos)
                           || (windowed && key <= qpos - a.window)) {
                    x = FA_NEG_INF;
                }
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_r[i], mx);
            const float corr = expf(m_r[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                sum += p;
                Ps[(ty + 16 * i) * ps + tx + 16 * j] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l_r[i] = l_r[i] * corr + sum;
            m_r[i] = m_new;
#pragma unroll
            for (int c = 0; c < MAXC; ++c) acc[i][c] *= corr;
        }
        __syncthreads();

        for (int kk = 0; kk < FA_BK; ++kk) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * ps + kk];
#pragma unroll
            for (int c = 0; c < MAXC; ++c) {
                if (c < ncol) {
                    const float vv = Vs[kk * hd + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        if (qpos >= a.S) continue;
        const float l = fmaxf(l_r[i], 1e-30f);
        T* orow = og + (long long)qpos * a.o_ss;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
            if (c < ncol) orow[tx + 16 * c] = from_f32<T>(acc[i][c] / l);
        if (LSE && tx == 0)
            a.lse[(long long)bh * a.S + qpos] = m_r[i] + logf(l);
    }
}

template <typename T, bool LSE, int MAXC>
static cudaError_t launch_one(const FaArgs& a, int batch, cudaStream_t st) {
    const int smem = fa_smem_floats(a.hd) * (int)sizeof(float);
    auto kern = flash_fwd_kernel<T, LSE, MAXC>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.S + FA_BQ - 1) / FA_BQ, batch * a.H);
    kern<<<grid, FA_THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

template <typename T, bool LSE>
static cudaError_t launch_hd(const FaArgs& a, int batch, cudaStream_t st) {
    if (a.hd <= 64) return launch_one<T, LSE, 4>(a, batch, st);
    if (a.hd <= 128) return launch_one<T, LSE, 8>(a, batch, st);
    return launch_one<T, LSE, 16>(a, batch, st);
}

extern "C" {

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, in the
// order (batch, seq, head) for q, k, v and o; each last dim is dense.
// lse: (B*H, S) float32 when with_lse, else ignored.  window <= 0: none.
int flash_fwd(int dtype, int with_lse, const void* q, const void* k,
              const void* v, void* o, float* lse, int batch, int S, int Sk,
              int H, int KV, int hd, const long long* strides, int causal,
              int window, float scale, void* stream) {
    if (hd < 16 || hd > FA_MAX_HD || hd % 16) return FA_ERR_HEAD_DIM;
    if (KV < 1 || H % KV) return FA_ERR_GROUPS;
    if (batch < 1 || S < 1 || Sk < 1) return FA_ERR_SHAPE;
    FaArgs a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    a.lse = lse;
    a.S = S;
    a.Sk = Sk;
    a.H = H;
    a.KV = KV;
    a.hd = hd;
    a.q_sb = strides[0];
    a.q_ss = strides[1];
    a.q_sh = strides[2];
    a.k_sb = strides[3];
    a.k_ss = strides[4];
    a.k_sh = strides[5];
    a.v_sb = strides[6];
    a.v_ss = strides[7];
    a.v_sh = strides[8];
    a.o_sb = strides[9];
    a.o_ss = strides[10];
    a.o_sh = strides[11];
    a.causal = causal;
    a.window = window;
    a.scale = scale;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (dtype == 0)
        err = with_lse ? launch_hd<float, true>(a, batch, st)
                       : launch_hd<float, false>(a, batch, st);
    else if (dtype == 1)
        err = with_lse ? launch_hd<__nv_bfloat16, true>(a, batch, st)
                       : launch_hd<__nv_bfloat16, false>(a, batch, st);
    else
        return FA_ERR_DTYPE;
    return (int)err;
}

int flash_smem_bytes(int hd) {
    return fa_smem_floats(hd) * (int)sizeof(float);
}

const char* flash_error_string(int err) {
    switch (err) {
        case FA_ERR_HEAD_DIM:
            return "head_dim must be a multiple of 16 in [16, 256]";
        case FA_ERR_GROUPS:
            return "kv_heads must divide heads";
        case FA_ERR_DTYPE:
            return "dtype must be float32 or bfloat16";
        case FA_ERR_SHAPE:
            return "batch, S and Sk must be >= 1";
        default:
            return cudaGetErrorString((cudaError_t)err);
    }
}

}  // extern "C"
