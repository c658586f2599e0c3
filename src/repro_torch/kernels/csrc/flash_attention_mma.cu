// Flash attention, forward, bfloat16, on Hopper's tensor cores (sm_90a):
// the same online softmax as flash_attention.cu (which keeps serving
// float32 inputs), with both products an mma.sync of bf16 operands into
// float32 accumulators.
//
// Replaces the reference's Pallas TPU kernels
//   src/repro/kernels/flash_attention.py::_kernel          (lse off)
//   src/repro/kernels/flash_attention.py::_fwd_kernel_lse  (lse on)
// for bfloat16 q, k and v.  As in flash_attention.cu, the reference's
// sequential kv grid axis is a loop inside the CTA and the running state
// (m, l, acc) lives in registers:
//
//   * one CTA of 128 threads (four warps) per (batch*head, 64-query tile),
//     the last query tiles first (they keep the most keys under a causal
//     mask); a warp owns 16 query rows, the m of mma.sync.m16n8k16;
//   * the CTA loops over the key tiles some row of its tile keeps, with
//     flash_attention.cu's tile-range formulas: BK keys a tile (64, or 32
//     above hd 128, where the accumulators take 128 registers);
//   * s = q k^T: Q's fragments come from shared memory by ldmatrix each
//     tile (kept in registers, they would cost hd / 4 registers a thread:
//     at hd <= 80 a fourth CTA on the SM, above 128 the accumulators'
//     room), K is the B operand by non-transposed ldmatrix;
//   * softmax in registers: each thread holds two rows (gr and gr + 8 of
//     its warp's 16) against BK/4 keys; the row max is reduced across the
//     four lanes of a quad, l is kept per thread and reduced once at the
//     end; p = 2^(s * scale * log2 e - m) by ex2.approx, one fma and one
//     ex2 per element, with m kept in log2 units;
//   * p v: the C->A fragment identity makes the s accumulators the A
//     operand without a trip through shared memory; V is the B operand by
//     ldmatrix.trans.  The hi and lo halves of p (below) go into the same
//     accumulators, so they are issued a group of column tiles apart: hi
//     into 2 (4 above hd 80) tiles, then lo into the same ones: never two
//     dependent mma back to back, each of which would wait out the
//     latency of the one before.
// At hd <= 80 the kernel is held to 128 registers, four CTAs per SM (it
// takes 150-odd unbounded, three CTAs); above, two.
// K and V tiles are bf16 at a row stride of hd + 8 elements (an odd
// multiple of 16 bytes: the eight rows one ldmatrix phase reads fall in
// eight different bank groups at hd 80's 160-byte rows), double-buffered
// by cp.async with one barrier per tile.  Rows past S and Sk are
// zero-filled, so no stale bits reach an mma.
//
// Masks are the reference's, exactly as flash_attention.cu applies them:
// causal keeps key <= qpos, a window keeps key > qpos - window; a masked
// score is the finite -1e30, and keys past Sk are -inf.  Key tiles wholly
// masked for the CTA are skipped, unless some row of the tile keeps no key
// at all (possible only when S >= Sk + window): such a tile runs over every
// key tile, and its fully masked rows average all keys.  In log2 units the
// sentinel is carried as itself: a masked element contributes
// 2^(-1e30 - m), which is 1 while the row has seen no kept key (m is still
// -1e30) and 0 after, and the lse of such a row is -1e30 + log l, as the
// reference's.  A warp whose 16 rows keep every key of the tile skips the
// per-pair mask test (most tiles under a 4096-token window).
//
// Precision.  s is the exact product of bf16 operands summed in float32.
// p is float32; rounded once to bf16 before p v it would break the port's
// two-ulp bf16 limit against the plain version (about 10x in a CPU replay,
// tests/test_torch_flash_fwd.py).  So p is carried as the pair hi =
// bf16(p), lo = bf16(p - hi), two mma into one float32 accumulator; l sums
// the float32 p.  The output is acc / max(l, 1e-30), rounded once to bf16
// and written through the strides.  No atomics and a fixed order of sums:
// a launch repeats bit for bit, and the lse-on and lse-off instantiations
// differ only in writing the lse.
//
// What bounds it on this card: 4*hd flops per kept (query, key) pair (the
// two products) against q, k, v read once and o written once: the
// operations, at the tensor cores' bf16 rate.  This design issues 6*hd
// per computed pair (the hi/lo pair doubles p v), plus the pairs at the
// tile edges; wgmma, TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define FFM_THREADS 128  // four warps
#define FFM_BQ 64        // the query tile: 16 rows a warp
#define FFM_MAX_HD 256
#define FFM_NEG_INF (-1e30f)  // the reference's masked score
#define FFM_LOG2E 1.4426950408889634f
#define FFM_LN2 0.6931471805599453f

// error codes beyond cudaError_t's range (flash_attention.cu's, plus
// alignment)
#define FFM_ERR_HEAD_DIM 10001
#define FFM_ERR_GROUPS 10002
#define FFM_ERR_DTYPE 10003
#define FFM_ERR_SHAPE 10004
#define FFM_ERR_ALIGN 10005

typedef __nv_bfloat16 bf16;

struct FfmArgs {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    bf16* o;
    float* lse;  // (B*H, S) or null
    int S, Sk, H, KV, hd;
    long long q_sb, q_ss, q_sh;  // element strides; the last dim is dense
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_ss, o_sh;
    int causal;
    int window;        // <= 0: no window
    float scale_log2;  // scale * log2(e): p = 2^(s * scale_log2 - m)
};

// ---- tensor-core and copy primitives (inline PTX) -------------------------
__device__ __forceinline__ uint32_t ffm_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void ffm_cp16(void* dst, const void* src,
                                         bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     ffm_smem_addr(dst)),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void ffm_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ffm_cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register m receives row lane / 4, columns 2 (lane % 4) + {0, 1}
// of matrix m (of its transpose with .trans)
__device__ __forceinline__ void ffm_ldsm(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(ffm_smem_addr(p))
        : "memory");
}

__device__ __forceinline__ void ffm_ldsm_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(ffm_smem_addr(p))
        : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 float32
__device__ __forceinline__ void ffm_mma(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, to 2 ulp (flushes results below 2^-126 to zero)
__device__ __forceinline__ float ffm_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t ffm_bits(__nv_bfloat162 x) {
    uint32_t u;
    memcpy(&u, &x, sizeof u);
    return u;
}

// (x0, x1) as hi + lo, each a packed pair of bf16 (x0 in the low half)
__device__ __forceinline__ void ffm_split(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 f = __bfloat1622float2(h);
    hi = ffm_bits(h);
    lo = ffm_bits(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

__device__ __forceinline__ void ffm_store2(bf16* p, float x0, float x1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// ---- kernel ----------------------------------------------------------------
// rows row0 .. row0+nrows-1 of a (rows, hd) bf16 slab into shared memory
// at row stride ld, by 16-byte cp.async; rows at or past `limit` are zero
__device__ __forceinline__ void ffm_load_rows(bf16* dst, int ld,
                                              const bf16* src,
                                              long long row_stride, int row0,
                                              int nrows, int limit, int hd) {
    const int chunks = hd >> 3;
    for (int i = threadIdx.x; i < nrows * chunks; i += FFM_THREADS) {
        const int r = i / chunks, c = (i - r * chunks) << 3;
        const bool in = row0 + r < limit;
        ffm_cp16(dst + r * ld + c,
                 in ? src + (long long)(row0 + r) * row_stride + c : src, in);
    }
}

// whether the mask keeps the pair (qpos, key), key < Sk
__device__ __forceinline__ bool ffm_keep(const FfmArgs& a, int qpos,
                                         int key) {
    return !(a.causal && key > qpos)
           && !(a.window > 0 && key <= qpos - a.window);
}

// whether the mask keeps every pair of queries q0 .. q1 x keys k0 .. k1
__device__ __forceinline__ bool ffm_keeps_all(const FfmArgs& a, int q0,
                                              int q1, int k0, int k1) {
    return q1 < a.S && k1 < a.Sk && !(a.causal && k1 > q0)
           && !(a.window > 0 && k0 <= q1 - a.window);
}

// the online-softmax step of one key tile for a thread's two rows: s (the
// scores of NT n-tiles; element e of n-tile n is row i = e / 2, query
// qpos[i], key kb + 8 n + e % 2) becomes p against the new running max;
// m, l and the accumulator scale `corr` are updated.  MASK: check each
// pair (a tile the warp's rows keep whole skips it).
template <int NT, bool MASK>
__device__ __forceinline__ void ffm_softmax(float (&s)[NT][4],
                                            const FfmArgs& a,
                                            const int (&qpos)[2], int kb,
                                            float (&m)[2], float (&l)[2],
                                            float (&corr)[2]) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = kb + n * 8 + (e & 1);
            if (!MASK || (key < a.Sk && ffm_keep(a, qpos[e >> 1], key)))
                mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // m >= -1e30 always, so a row with no kept key here keeps its m
        m_new[i] = fmaxf(m[i], mx[i] * a.scale_log2);
        corr[i] = ffm_exp2(m[i] - m_new[i]);
        m[i] = m_new[i];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float p;
            if (!MASK) {
                p = ffm_exp2(fmaf(s[n][e], a.scale_log2, -m_new[i]));
            } else {
                const int key = kb + n * 8 + (e & 1);
                if (key >= a.Sk)
                    p = 0.f;  // -inf: the key does not exist
                else if (ffm_keep(a, qpos[i], key))
                    p = ffm_exp2(fmaf(s[n][e], a.scale_log2, -m_new[i]));
                else  // the finite sentinel: 1 until the row keeps a key
                    p = ffm_exp2(FFM_NEG_INF - m_new[i]);
            }
            sum[i] += p;
            s[n][e] = p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

template <int HDB, int BK, bool LSE>
__global__ void __launch_bounds__(FFM_THREADS, HDB <= 80 ? 4 : 1)
    ffm_kernel(FfmArgs a) {
    extern __shared__ __align__(16) unsigned char ffm_smem[];
    const int hd = a.hd, ld = hd + 8;
    bf16* Qs = reinterpret_cast<bf16*>(ffm_smem);
    bf16* Ks = Qs + FFM_BQ * ld;  // [2][BK][ld]
    bf16* Vs = Ks + 2 * BK * ld;  // [2][BK][ld]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tq = lane & 3;
    // the last query tiles carry the most causal work: start them first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FFM_BQ;
    const int bh = blockIdx.y;
    const int b = bh / a.H, h = bh % a.H;
    const int kvh = h / (a.H / a.KV);  // GQA: kv row b*KV + h // G

    const bf16* qg = a.q + b * a.q_sb + h * a.q_sh;
    const bf16* kg = a.k + b * a.k_sb + kvh * a.k_sh;
    const bf16* vg = a.v + b * a.v_sb + kvh * a.v_sh;

    // the key tiles this query tile needs (flash_attention.cu's formulas);
    // a tile with a row that keeps no key runs over all of them
    const int q_last = min(q0 + FFM_BQ, a.S) - 1;
    const bool windowed = a.window > 0;
    int k_lo = 0, k_hi = a.Sk;
    if (!(windowed && q_last >= a.Sk + a.window - 1)) {
        if (windowed) k_lo = max(0, q0 - a.window + 1);
        if (a.causal) k_hi = min(a.Sk, q_last + 1);
    }
    const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

    ffm_load_rows(Qs, ld, qg, a.q_ss, q0, FFM_BQ, a.S, hd);
    ffm_load_rows(Ks, ld, kg, a.k_ss, t_lo * BK, BK, a.Sk, hd);
    ffm_load_rows(Vs, ld, vg, a.v_ss, t_lo * BK, BK, a.Sk, hd);
    ffm_cp_commit();

    // this thread's rows of the accumulator tiles: gr and gr + 8 of the
    // warp's 16
    const int qw = q0 + warp * 16;
    const int qpos[2] = {qw + gr, qw + gr + 8};
    float m[2] = {FFM_NEG_INF, FFM_NEG_INF}, l[2] = {0.f, 0.f};
    float acc[HDB / 8][4];
#pragma unroll
    for (int n = 0; n < HDB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // A operands of this warp's rows: row lane % 16, column 8 (lane / 16)
    const bf16* qa_p = Qs + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    // B operands: rows of the stored tile are the n (keys) of s = q k^T ...
    const int nb_off = ((lane & 7) + ((lane >> 4) << 3)) * ld
                       + ((lane >> 3) & 1) * 8;
    // ... and the k (keys) of o = p v, read transposed
    const int tb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld
                       + (lane >> 4) * 8;

    for (int t = t_lo; t < t_hi; ++t) {
        const int buf = (t - t_lo) & 1;
        ffm_cp_wait_all();
        __syncthreads();  // tile t landed; every warp is done with t - 1
        if (t + 1 < t_hi) {
            ffm_load_rows(Ks + (buf ^ 1) * BK * ld, ld, kg, a.k_ss,
                          (t + 1) * BK, BK, a.Sk, hd);
            ffm_load_rows(Vs + (buf ^ 1) * BK * ld, ld, vg, a.v_ss,
                          (t + 1) * BK, BK, a.Sk, hd);
        }
        ffm_cp_commit();
        const bf16* Kt = Ks + buf * BK * ld;
        const bf16* Vt = Vs + buf * BK * ld;
        const int k0 = t * BK;

        // s = q k^T
        float s[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HDB / 16; ++kk) {
            if (kk * 16 < hd) {
                uint32_t qa[4];
                ffm_ldsm(qa, qa_p + kk * 16);
#pragma unroll
                for (int nn = 0; nn < BK / 16; ++nn) {
                    uint32_t kb[4];
                    ffm_ldsm(kb, Kt + nn * 16 * ld + nb_off + kk * 16);
                    ffm_mma(s[2 * nn], qa, kb[0], kb[1]);
                    ffm_mma(s[2 * nn + 1], qa, kb[2], kb[3]);
                }
            }
        }

        float corr[2];
        if (ffm_keeps_all(a, qw, qw + 15, k0, k0 + BK - 1))
            ffm_softmax<BK / 8, false>(s, a, qpos, k0 + tq * 2, m, l, corr);
        else
            ffm_softmax<BK / 8, true>(s, a, qpos, k0 + tq * 2, m, l, corr);
#pragma unroll
        for (int n = 0; n < HDB / 8; ++n) {
            acc[n][0] *= corr[0];
            acc[n][1] *= corr[0];
            acc[n][2] *= corr[1];
            acc[n][3] *= corr[1];
        }

        // acc += p v: the score tiles of keys 16 kk .. 16 kk + 15 are the A
        // operand of one k step, p as its hi/lo pair, over groups of DG
        // column tiles (16 columns each): hi into the group, then lo
        constexpr int DG = HDB <= 80 ? 2 : 4;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t hi[4], lo[4];
            ffm_split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
            ffm_split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
            ffm_split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
            ffm_split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int d0 = 0; d0 < HDB / 16; d0 += DG) {
                uint32_t vb[DG][4];
#pragma unroll
                for (int g = 0; g < DG; ++g)
                    if (d0 + g < HDB / 16 && (d0 + g) * 16 < hd)
                        ffm_ldsm_t(vb[g], Vt + kk * 16 * ld + tb_off
                                              + (d0 + g) * 16);
#pragma unroll
                for (int g = 0; g < DG; ++g)
                    if (d0 + g < HDB / 16 && (d0 + g) * 16 < hd) {
                        ffm_mma(acc[2 * (d0 + g)], hi, vb[g][0], vb[g][1]);
                        ffm_mma(acc[2 * (d0 + g) + 1], hi, vb[g][2],
                                vb[g][3]);
                    }
#pragma unroll
                for (int g = 0; g < DG; ++g)
                    if (d0 + g < HDB / 16 && (d0 + g) * 16 < hd) {
                        ffm_mma(acc[2 * (d0 + g)], lo, vb[g][0], vb[g][1]);
                        ffm_mma(acc[2 * (d0 + g) + 1], lo, vb[g][2],
                                vb[g][3]);
                    }
            }
        }
    }

    bf16* og = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        // each lane of the quad summed its own keys
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if (qpos[i] >= a.S) continue;
        const float li = fmaxf(l[i], 1e-30f);
        bf16* row = og + (long long)qpos[i] * a.o_ss + tq * 2;
#pragma unroll
        for (int n = 0; n < HDB / 8; ++n)
            if (n * 8 < hd)
                ffm_store2(row + n * 8, acc[n][2 * i] / li,
                           acc[n][2 * i + 1] / li);
        if (LSE && tq == 0)  // natural-log units; a row with no kept key
            a.lse[(long long)bh * a.S + qpos[i]] =  // keeps the sentinel
                (m[i] == FFM_NEG_INF ? FFM_NEG_INF : m[i] * FFM_LN2)
                + logf(li);
    }
}

// ---- launch and C interface ------------------------------------------------
// tiles per instantiation; kernels/flash_attention.py's fwd_tiles mirrors
// them
__host__ inline int ffm_hd_bound(int hd) {
    return hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 128 ? 128 : 256;
}
__host__ inline int ffm_bk(int hd) {
    return ffm_hd_bound(hd) <= 128 ? 64 : 32;
}

// Q; K and V double-buffered
__host__ inline int ffm_smem_bytes(int hd) {
    return (FFM_BQ + 4 * ffm_bk(hd)) * (hd + 8) * 2;
}

template <int HDB, int BK, bool LSE>
static cudaError_t ffm_launch(const FfmArgs& a, int batch, cudaStream_t st) {
    const int smem = ffm_smem_bytes(a.hd);
    auto kern = ffm_kernel<HDB, BK, LSE>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.S + FFM_BQ - 1) / FFM_BQ, batch * a.H);
    kern<<<grid, FFM_THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

template <bool LSE>
static cudaError_t ffm_run(const FfmArgs& a, int batch, cudaStream_t st) {
    switch (ffm_hd_bound(a.hd)) {
        case 64:
            return ffm_launch<64, 64, LSE>(a, batch, st);
        case 80:
            return ffm_launch<80, 64, LSE>(a, batch, st);
        case 128:
            return ffm_launch<128, 64, LSE>(a, batch, st);
        default:
            return ffm_launch<256, 32, LSE>(a, batch, st);
    }
}

extern "C" {

// The arguments, and the codes, are flash_attention.cu's flash_fwd's.
// dtype: 1 bfloat16, the only one taken.  strides: 12 element strides, in
// the order (batch, seq, head) for q, k, v and o; each last dim is dense,
// and each pointer and stride (of a dim longer than 1) keeps rows 16-byte
// aligned.  lse: (B*H, S) float32 when with_lse, else ignored.  window <=
// 0: none.
int flash_fwd_mma(int dtype, int with_lse, const void* q, const void* k,
                  const void* v, void* o, float* lse, int batch, int S,
                  int Sk, int H, int KV, int hd, const long long* strides,
                  int causal, int window, float scale, void* stream) {
    if (dtype != 1) return FFM_ERR_DTYPE;
    if (hd < 16 || hd > FFM_MAX_HD || hd % 16) return FFM_ERR_HEAD_DIM;
    if (KV < 1 || H % KV) return FFM_ERR_GROUPS;
    if (batch < 1 || S < 1 || Sk < 1) return FFM_ERR_SHAPE;
    const void* ptrs[4] = {q, k, v, o};
    for (int t = 0; t < 4; ++t) {
        if ((uintptr_t)ptrs[t] % 16) return FFM_ERR_ALIGN;
        const int kv_side = t == 1 || t == 2;
        const int dims[3] = {batch, kv_side ? Sk : S, kv_side ? KV : H};
        for (int d = 0; d < 3; ++d)
            if (dims[d] > 1 && strides[3 * t + d] % 8) return FFM_ERR_ALIGN;
    }
    FfmArgs a;
    a.q = (const bf16*)q;
    a.k = (const bf16*)k;
    a.v = (const bf16*)v;
    a.o = (bf16*)o;
    a.lse = lse;
    a.S = S;
    a.Sk = Sk;
    a.H = H;
    a.KV = KV;
    a.hd = hd;
    long long* f[12] = {&a.q_sb, &a.q_ss, &a.q_sh, &a.k_sb, &a.k_ss, &a.k_sh,
                        &a.v_sb, &a.v_ss, &a.v_sh, &a.o_sb, &a.o_ss, &a.o_sh};
    for (int i = 0; i < 12; ++i) *f[i] = strides[i];
    a.causal = causal;
    a.window = window;
    a.scale_log2 = scale * FFM_LOG2E;
    cudaStream_t st = (cudaStream_t)stream;
    return (int)(with_lse ? ffm_run<true>(a, batch, st)
                          : ffm_run<false>(a, batch, st));
}

int flash_fwd_mma_smem_bytes(int hd) { return ffm_smem_bytes(hd); }

const char* flash_fwd_mma_error_string(int err) {
    switch (err) {
        case FFM_ERR_HEAD_DIM:
            return "head_dim must be a multiple of 16 in [16, 256]";
        case FFM_ERR_GROUPS:
            return "kv_heads must divide heads";
        case FFM_ERR_DTYPE:
            return "this kernel takes bfloat16 only (dtype code 1)";
        case FFM_ERR_SHAPE:
            return "batch, S and Sk must be >= 1";
        case FFM_ERR_ALIGN:
            return "every tensor's rows must be 16-byte aligned (pointers "
                   "and strides in multiples of 8 elements)";
        default:
            return cudaGetErrorString((cudaError_t)err);
    }
}

}  // extern "C"
