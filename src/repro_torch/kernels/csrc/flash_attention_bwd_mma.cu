// Flash attention, backward, bfloat16, on Hopper's tensor cores (sm_90a):
// the same two kernels as flash_attention_bwd.cu (which keeps serving
// float32 inputs), with every product an mma.sync of bf16 operands into
// float32 accumulators.
//
// Replaces the reference's Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_bwd_kernel
// for bfloat16 q, k, v and do.  As in flash_attention_bwd.cu, the work is
// cut twice so that no sum needs grid order or atomics:
//
//   * fbm_dq_kernel, query-major: one CTA per (batch*head, 64-query tile)
//     loops over the key tiles its rows keep and sums dQ += dS K in
//     registers, written once;
//   * fbm_dkdv_kernel, key-major: one CTA per (batch, kv head, 64-key
//     tile) keeps its K and V tile in shared memory and loops over the G
//     query heads of its group and, for each, over the query tiles that
//     keep some key of the tile (causal: q >= k; window: q < k + window),
//     summing dV += P^T dO and dK += dS^T Q in registers.  dK and dV are
//     written once, already summed over the group.
//
// Both recompute, per (query tile, key tile), with delta = rowsum(do * o)
// from the wrapper:
//   s  = q k^T,           p  = exp(s * scale - lse) where the mask keeps,
//   dp = do v^T,          ds = p * (dp - delta) * scale.
// A row that keeps no key gets no gradient, as in the reference's kernel.
//
// Threads: 128, four warps.  A warp owns 16 query rows (dQ) or 16 keys
// (dK/dV), the m of mma.sync.m16n8k16.  Operand fragments come from
// shared memory by ldmatrix (.trans where the product needs the stored
// tile transposed); s, dp, p and ds stay in the accumulator registers and
// become the A operand of the gradient products without a trip through
// shared memory.  Tiles are stored as bf16 at a row stride of hd + 8
// elements: an odd multiple of 16 bytes, so the eight rows one ldmatrix
// phase reads fall in eight different bank groups (at hd 80 a dense row
// is 160 B and would pair them up).  The streamed tiles (K and V in dQ;
// Q, dO, lse and delta in dK/dV) are double-buffered: cp.async fills the
// next buffer while the current one computes.  Rows past the end of the
// sequence are zero-filled, so the products never meet stale bits.
//
// Precision.  s and dp are exact products of bf16 operands summed in
// float32.  p and ds are float32 values; rounding them once to bf16 for
// the next product would throw away their low bits, which the plain
// version keeps.  Each is carried as a pair hi = bf16(x), lo = bf16(x -
// hi), two mma into one float32 accumulator (about 16 significant bits).
// p = 2^(s * scale * log2 e - lse * log2 e) by ex2.approx (2 ulp of
// float32), one fma and one ex2 per element.
//
// Between the products each thread turns its 32 (at 64-wide tiles) score
// elements into p and ds; that scalar work is a large share of the
// kernels' instructions, so a tile the mask keeps whole (most of them
// under a 4096-token window) skips the per-pair mask test.
//
// Tiles per head-dim bound HDB (hd is a multiple of 16 in [16, 256]; a
// kernel instantiated for HDB serves every hd <= HDB, guarding the column
// loops at run time):
//   dQ:    64 queries x BK keys, BK = 64 (32 at HDB 256);
//   dK/dV: 64 keys x BQ queries, BQ = 64 up to HDB 80, else 32; dK and dV
//          are summed NC = min(HDB, 128) columns at a time, so at HDB 256
//          two passes each recompute s and dp (register room: dK and dV
//          of 256 columns would need 256 accumulators per thread).
// The accumulators: dQ takes HDB/2 registers per thread, dK and dV NC.
//
// What bounds it on this card: 10*hd flops per kept (query, key) pair (the
// two recomputed products and the three gradient products) against q, k,
// v, o, do and lse read once and dq, dk, dv written once: the operations,
// at the tensor cores' bf16 rate.  This design issues 8*hd of them per
// computed pair in dQ and 12*hd in dK/dV (s and dp twice, the hi/lo pairs
// double the gradient products), 16*hd in dK/dV above hd 128; wgmma, TMA
// and one pass are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define FBM_THREADS 128  // four warps
#define FBM_ROWS 64      // dQ's query tile and dK/dV's key tile: 16 a warp
#define FBM_MAX_HD 256

// error codes beyond cudaError_t's range (flash_attention_bwd.cu's, plus
// alignment)
#define FBM_ERR_HEAD_DIM 10001
#define FBM_ERR_GROUPS 10002
#define FBM_ERR_DTYPE 10003
#define FBM_ERR_SHAPE 10004
#define FBM_ERR_KERNEL 10005
#define FBM_ERR_ALIGN 10006

typedef __nv_bfloat16 bf16;

struct FbmArgs {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const bf16* dout;
    const float* lse;    // (B*H, S)
    const float* delta;  // (B*H, S)
    bf16* dq;
    bf16* dk;
    bf16* dv;
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
    float scale_log2;  // scale * log2(e): p = 2^(s * scale_log2 - lse_log2)
};

// ---- tensor-core and copy primitives (inline PTX) -------------------------
__device__ __forceinline__ uint32_t fbm_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void fbm_cp16(void* dst, const void* src,
                                         bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     fbm_smem_addr(dst)),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void fbm_cp4(void* dst, const void* src,
                                        bool full) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     fbm_smem_addr(dst)),
                 "l"(src), "r"(full ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void fbm_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fbm_cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register m receives row lane / 4, columns 2 (lane % 4) + {0, 1}
// of matrix m (of its transpose with .trans)
__device__ __forceinline__ void fbm_ldsm(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(fbm_smem_addr(p))
        : "memory");
}

__device__ __forceinline__ void fbm_ldsm_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(fbm_smem_addr(p))
        : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 float32
__device__ __forceinline__ void fbm_mma(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, to 2 ulp (flushes results below 2^-126 to zero)
__device__ __forceinline__ float fbm_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t fbm_bits(__nv_bfloat162 x) {
    uint32_t u;
    memcpy(&u, &x, sizeof u);
    return u;
}

// (x0, x1) as hi + lo, each a packed pair of bf16 (x0 in the low half)
__device__ __forceinline__ void fbm_split(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 f = __bfloat1622float2(h);
    hi = fbm_bits(h);
    lo = fbm_bits(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

__device__ __forceinline__ void fbm_store2(bf16* p, float x0, float x1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// ---- kernels ----------------------------------------------------------------
// the reference's mask: causal keeps key <= qpos, a window keeps
// key > qpos - window; rows past S and keys past Sk do not exist
__device__ __forceinline__ bool fbm_keep(const FbmArgs& a, int qpos,
                                         int key) {
    return qpos < a.S && key < a.Sk && !(a.causal && key > qpos)
           && !(a.window > 0 && key <= qpos - a.window);
}

#define FBM_LOG2E 1.4426950408889634f

// whether the mask keeps every pair of queries q0 .. q1 x keys k0 .. k1
__device__ __forceinline__ bool fbm_keeps_all(const FbmArgs& a, int q0,
                                              int q1, int k0, int k1) {
    return q1 < a.S && k1 < a.Sk && !(a.causal && k1 > q0)
           && !(a.window > 0 && k0 <= q1 - a.window);
}

// ds in place of s for a warp's 16 query rows against NT n-tiles of keys
// from kb (this thread's first key): element e of n-tile n is row i = e / 2
// (query qpos[i]), key kb + 8 n + e % 2.  MASK: check each pair (a tile
// the mask keeps whole skips it).
template <int NT, bool MASK>
__device__ __forceinline__ void fbm_dq_ds(float (&s)[NT][4],
                                          const float (&dp)[NT][4],
                                          const FbmArgs& a,
                                          const int (&qpos)[2],
                                          const float (&lse2)[2],
                                          const float (&dl)[2], int kb) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float ds = 0.f;
            if (!MASK || fbm_keep(a, qpos[i], kb + n * 8 + (e & 1))) {
                const float p =
                    fbm_exp2(fmaf(s[n][e], a.scale_log2, -lse2[i]));
                ds = p * (dp[n][e] - dl[i]) * a.scale;
            }
            s[n][e] = ds;
        }
}

// p^T in place of s^T and ds^T in place of dp^T for a warp's 16 keys
// against NT n-tiles of queries from q0: element e of n-tile n is key
// key[e / 2], query column 8 n + 2 tq + e % 2, whose lse and delta are
// lt[column] and dlt[column].  MASK as in fbm_dq_ds.
template <int NT, bool MASK>
__device__ __forceinline__ void fbm_dkdv_p_ds(float (&st)[NT][4],
                                              float (&dpt)[NT][4],
                                              const FbmArgs& a,
                                              const int (&key)[2], int q0,
                                              int tq, const float* lt,
                                              const float* dlt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + tq * 2;
        const float2 l = *reinterpret_cast<const float2*>(lt + col);
        const float2 d = *reinterpret_cast<const float2*>(dlt + col);
        const float l2[2] = {l.x * FBM_LOG2E, l.y * FBM_LOG2E};
        const float dl[2] = {d.x, d.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = e & 1;
            float p = 0.f, ds = 0.f;
            if (!MASK || fbm_keep(a, q0 + col + j, key[e >> 1])) {
                p = fbm_exp2(fmaf(st[n][e], a.scale_log2, -l2[j]));
                ds = p * (dpt[n][e] - dl[j]) * a.scale;
            }
            st[n][e] = p;
            dpt[n][e] = ds;
        }
    }
}

// rows row0 .. row0+nrows-1 of a (rows, hd) bf16 slab into shared memory
// at row stride ld, by 16-byte cp.async; rows at or past `limit` are zero
__device__ __forceinline__ void fbm_load_rows(bf16* dst, int ld,
                                              const bf16* src,
                                              long long row_stride, int row0,
                                              int nrows, int limit, int hd) {
    const int chunks = hd >> 3;
    for (int i = threadIdx.x; i < nrows * chunks; i += FBM_THREADS) {
        const int r = i / chunks, c = (i - r * chunks) << 3;
        const bool in = row0 + r < limit;
        fbm_cp16(dst + r * ld + c,
                 in ? src + (long long)(row0 + r) * row_stride + c : src, in);
    }
}

// n floats of one (S,) row of lse or delta from row0; past `limit`, zero
__device__ __forceinline__ void fbm_load_vec(float* dst, const float* src,
                                             int row0, int n, int limit) {
    for (int i = threadIdx.x; i < n; i += FBM_THREADS) {
        const bool in = row0 + i < limit;
        fbm_cp4(dst + i, in ? src + row0 + i : src, in);
    }
}

// the key tiles (of bk keys) some row of the query tile at q0 keeps
__device__ __forceinline__ void fbm_key_tiles(int q0, int bq, int bk, int S,
                                              int Sk, int causal, int window,
                                              int& t_lo, int& t_hi) {
    const int q_last = (q0 + bq < S ? q0 + bq : S) - 1;
    int k_lo = 0, k_hi = Sk;
    if (window > 0) k_lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
    if (causal) k_hi = Sk < q_last + 1 ? Sk : q_last + 1;
    t_lo = k_lo / bk;
    t_hi = k_hi > k_lo ? (k_hi + bk - 1) / bk : t_lo;
}

// the query tiles (of bq queries) with a row that keeps some key of the
// key tile at k0
__device__ __forceinline__ void fbm_query_tiles(int k0, int bk, int bq,
                                                int S, int Sk, int causal,
                                                int window, int& t_lo,
                                                int& t_hi) {
    const int k_last = (k0 + bk < Sk ? k0 + bk : Sk) - 1;
    int q_lo = 0, q_hi = S;
    if (causal) q_lo = k0;
    if (window > 0) q_hi = S < k_last + window ? S : k_last + window;
    t_lo = q_lo / bq;
    t_hi = q_hi > q_lo ? (q_hi + bq - 1) / bq : t_lo;
}

template <int HDB, int BK>
__global__ void __launch_bounds__(FBM_THREADS) fbm_dq_kernel(FbmArgs a) {
    extern __shared__ __align__(16) unsigned char fbm_smem[];
    const int hd = a.hd, ld = hd + 8;
    bf16* Qs = reinterpret_cast<bf16*>(fbm_smem);
    bf16* dOs = Qs + FBM_ROWS * ld;
    bf16* Ks = dOs + FBM_ROWS * ld;  // [2][BK][ld]
    bf16* Vs = Ks + 2 * BK * ld;     // [2][BK][ld]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tq = lane & 3;
    // the last query tiles keep the most keys under a causal mask: start
    // them first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FBM_ROWS;
    const int bh = blockIdx.y;
    const int b = bh / a.H, h = bh % a.H;
    const int kvh = h / (a.H / a.KV);  // GQA: kv row b*KV + h // G

    const bf16* qg = a.q + b * a.q_sb + h * a.q_sh;
    const bf16* dog = a.dout + b * a.do_sb + h * a.do_sh;
    const bf16* kg = a.k + b * a.k_sb + kvh * a.k_sh;
    const bf16* vg = a.v + b * a.v_sb + kvh * a.v_sh;

    int t_lo, t_hi;
    fbm_key_tiles(q0, FBM_ROWS, BK, a.S, a.Sk, a.causal, a.window, t_lo,
                  t_hi);
    if (t_lo < t_hi) {
        fbm_load_rows(Qs, ld, qg, a.q_ss, q0, FBM_ROWS, a.S, hd);
        fbm_load_rows(dOs, ld, dog, a.do_ss, q0, FBM_ROWS, a.S, hd);
        fbm_load_rows(Ks, ld, kg, a.k_ss, t_lo * BK, BK, a.Sk, hd);
        fbm_load_rows(Vs, ld, vg, a.v_ss, t_lo * BK, BK, a.Sk, hd);
    }
    fbm_cp_commit();

    // this thread's rows of the accumulator tiles: gr and gr + 8 of the
    // warp's 16
    int qpos[2];
    float lse2[2], dl_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        qpos[i] = q0 + warp * 16 + gr + 8 * i;
        const bool in = qpos[i] < a.S;
        lse2[i] = in ? a.lse[(long long)bh * a.S + qpos[i]] * FBM_LOG2E : 0.f;
        dl_r[i] = in ? a.delta[(long long)bh * a.S + qpos[i]] : 0.f;
    }

    float acc[HDB / 8][4];
#pragma unroll
    for (int n = 0; n < HDB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // A operands of this warp's rows: row lane % 16, column 8 (lane / 16)
    const bf16* qa_p = Qs + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    const bf16* oa_p = dOs + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    // B operands, rows of the stored tile are the n (keys) of s = q k^T ...
    const int nb_off = ((lane & 7) + ((lane >> 4) << 3)) * ld
                       + ((lane >> 3) & 1) * 8;
    // ... and the k (keys) of dq = ds k, read transposed
    const int tb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld
                       + (lane >> 4) * 8;

    for (int t = t_lo; t < t_hi; ++t) {
        const int buf = (t - t_lo) & 1;
        fbm_cp_wait_all();
        __syncthreads();  // tile t landed; every warp is done with t - 1
        if (t + 1 < t_hi) {
            fbm_load_rows(Ks + (buf ^ 1) * BK * ld, ld, kg, a.k_ss,
                          (t + 1) * BK, BK, a.Sk, hd);
            fbm_load_rows(Vs + (buf ^ 1) * BK * ld, ld, vg, a.v_ss,
                          (t + 1) * BK, BK, a.Sk, hd);
        }
        fbm_cp_commit();
        const bf16* Kt = Ks + buf * BK * ld;
        const bf16* Vt = Vs + buf * BK * ld;
        const int k0 = t * BK;

        float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HDB / 16; ++kk) {
            if (kk * 16 < hd) {
                uint32_t qa[4], oa[4];
                fbm_ldsm(qa, qa_p + kk * 16);
                fbm_ldsm(oa, oa_p + kk * 16);
#pragma unroll
                for (int nn = 0; nn < BK / 16; ++nn) {
                    uint32_t kb[4], vb[4];
                    fbm_ldsm(kb, Kt + nn * 16 * ld + nb_off + kk * 16);
                    fbm_ldsm(vb, Vt + nn * 16 * ld + nb_off + kk * 16);
                    fbm_mma(s[2 * nn], qa, kb[0], kb[1]);
                    fbm_mma(s[2 * nn + 1], qa, kb[2], kb[3]);
                    fbm_mma(dp[2 * nn], oa, vb[0], vb[1]);
                    fbm_mma(dp[2 * nn + 1], oa, vb[2], vb[3]);
                }
            }
        }

        if (fbm_keeps_all(a, q0, q0 + FBM_ROWS - 1, k0, k0 + BK - 1))
            fbm_dq_ds<BK / 8, false>(s, dp, a, qpos, lse2, dl_r,
                                     k0 + tq * 2);
        else
            fbm_dq_ds<BK / 8, true>(s, dp, a, qpos, lse2, dl_r, k0 + tq * 2);

        // dq += ds k: the accumulator tiles of keys 16 kk .. 16 kk + 15 are
        // the A operand of one k step
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t hi[4], lo[4];
            fbm_split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
            fbm_split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
            fbm_split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
            fbm_split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int dd = 0; dd < HDB / 16; ++dd) {
                if (dd * 16 < hd) {
                    uint32_t kb[4];
                    fbm_ldsm_t(kb, Kt + kk * 16 * ld + tb_off + dd * 16);
                    fbm_mma(acc[2 * dd], hi, kb[0], kb[1]);
                    fbm_mma(acc[2 * dd], lo, kb[0], kb[1]);
                    fbm_mma(acc[2 * dd + 1], hi, kb[2], kb[3]);
                    fbm_mma(acc[2 * dd + 1], lo, kb[2], kb[3]);
                }
            }
        }
    }

    bf16* dqg = a.dq + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (qpos[i] >= a.S) continue;
        bf16* row = dqg + (long long)qpos[i] * a.dq_ss + tq * 2;
#pragma unroll
        for (int n = 0; n < HDB / 8; ++n)
            if (n * 8 < hd)
                fbm_store2(row + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
    }
}

template <int HDB, int NC, int BQ>
__global__ void __launch_bounds__(FBM_THREADS) fbm_dkdv_kernel(FbmArgs a) {
    extern __shared__ __align__(16) unsigned char fbm_smem[];
    const int hd = a.hd, ld = hd + 8;
    bf16* Ks = reinterpret_cast<bf16*>(fbm_smem);
    bf16* Vs = Ks + FBM_ROWS * ld;
    bf16* Qs = Vs + FBM_ROWS * ld;  // [2][BQ][ld]
    bf16* dOs = Qs + 2 * BQ * ld;   // [2][BQ][ld]
    float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * ld);  // [2][BQ]
    float* dl_s = lse_s + 2 * BQ;                                // [2][BQ]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const int k0 = blockIdx.x * FBM_ROWS;
    const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
    const int G = a.H / a.KV;

    const bf16* kg = a.k + b * a.k_sb + kvh * a.k_sh;
    const bf16* vg = a.v + b * a.v_sb + kvh * a.v_sh;
    int t_lo, t_hi;
    fbm_query_tiles(k0, FBM_ROWS, BQ, a.S, a.Sk, a.causal, a.window, t_lo,
                    t_hi);
    const int n_t = t_hi - t_lo;
    const int items = G * n_t;  // (head of the group, query tile) pairs
    if (items > 0) {
        fbm_load_rows(Ks, ld, kg, a.k_ss, k0, FBM_ROWS, a.Sk, hd);
        fbm_load_rows(Vs, ld, vg, a.v_ss, k0, FBM_ROWS, a.Sk, hd);
    }

    // item it into buffer buf: Q, dO, lse and delta of one query tile
    auto load_item = [&](int it, int buf) {
        const int h = kvh * G + it / n_t;
        const int q0 = (t_lo + it % n_t) * BQ;
        const long long lrow = (long long)(b * a.H + h) * a.S;
        fbm_load_rows(Qs + buf * BQ * ld, ld, a.q + b * a.q_sb + h * a.q_sh,
                      a.q_ss, q0, BQ, a.S, hd);
        fbm_load_rows(dOs + buf * BQ * ld, ld,
                      a.dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0, BQ,
                      a.S, hd);
        fbm_load_vec(lse_s + buf * BQ, a.lse + lrow, q0, BQ, a.S);
        fbm_load_vec(dl_s + buf * BQ, a.delta + lrow, q0, BQ, a.S);
    };

    // this thread's keys: rows gr and gr + 8 of the warp's 16
    int key[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) key[i] = k0 + warp * 16 + gr + 8 * i;

    const bf16* ka_p = Ks + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    const bf16* va_p = Vs + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    const int nb_off = ((lane & 7) + ((lane >> 4) << 3)) * ld
                       + ((lane >> 3) & 1) * 8;
    const int tb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld
                       + (lane >> 4) * 8;
    bf16* dkg = a.dk + b * a.dk_sb + kvh * a.dk_sh;
    bf16* dvg = a.dv + b * a.dv_sb + kvh * a.dv_sh;

    for (int c0 = 0; c0 < hd; c0 += NC) {
        float dk[NC / 8][4], dv[NC / 8][4];
#pragma unroll
        for (int n = 0; n < NC / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

        __syncthreads();  // the previous pass is done with buffer 0
        if (items > 0) load_item(0, 0);
        fbm_cp_commit();
        for (int it = 0; it < items; ++it) {
            const int buf = it & 1;
            fbm_cp_wait_all();
            __syncthreads();  // item it landed; every warp is done with it-1
            if (it + 1 < items) load_item(it + 1, buf ^ 1);
            fbm_cp_commit();
            const int q0 = (t_lo + it % n_t) * BQ;
            const bf16* Qt = Qs + buf * BQ * ld;
            const bf16* dOt = dOs + buf * BQ * ld;
            const float* lt = lse_s + buf * BQ;
            const float* dlt = dl_s + buf * BQ;

            // s^T = k q^T and dp^T = v do^T: rows are this warp's keys,
            // columns the tile's queries
            float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < HDB / 16; ++kk) {
                if (kk * 16 < hd) {
                    uint32_t ka[4], va[4];
                    fbm_ldsm(ka, ka_p + kk * 16);
                    fbm_ldsm(va, va_p + kk * 16);
#pragma unroll
                    for (int nn = 0; nn < BQ / 16; ++nn) {
                        uint32_t qb[4], ob[4];
                        fbm_ldsm(qb, Qt + nn * 16 * ld + nb_off + kk * 16);
                        fbm_ldsm(ob, dOt + nn * 16 * ld + nb_off + kk * 16);
                        fbm_mma(st[2 * nn], ka, qb[0], qb[1]);
                        fbm_mma(st[2 * nn + 1], ka, qb[2], qb[3]);
                        fbm_mma(dpt[2 * nn], va, ob[0], ob[1]);
                        fbm_mma(dpt[2 * nn + 1], va, ob[2], ob[3]);
                    }
                }
            }

            if (fbm_keeps_all(a, q0, q0 + BQ - 1, k0, k0 + FBM_ROWS - 1))
                fbm_dkdv_p_ds<BQ / 8, false>(st, dpt, a, key, q0, tq, lt,
                                             dlt);
            else
                fbm_dkdv_p_ds<BQ / 8, true>(st, dpt, a, key, q0, tq, lt,
                                            dlt);

            // dv += p^T do and dk += ds^T q over columns c0 .. c0 + NC - 1
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {
                uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    // registers 0-3 of an A operand: (rows gr, gr+8) x
                    // (queries of n-tile 2 kk, then 2 kk + 1)
                    const int n = 2 * kk + (r >> 1), e = (r & 1) * 2;
                    fbm_split(st[n][e], st[n][e + 1], ph[r], pl[r]);
                    fbm_split(dpt[n][e], dpt[n][e + 1], sh[r], sl[r]);
                }
#pragma unroll
                for (int dd = 0; dd < NC / 16; ++dd) {
                    if (c0 + dd * 16 < hd) {
                        uint32_t ob[4], qb[4];
                        const int off = kk * 16 * ld + tb_off + c0 + dd * 16;
                        fbm_ldsm_t(ob, dOt + off);
                        fbm_ldsm_t(qb, Qt + off);
                        fbm_mma(dv[2 * dd], ph, ob[0], ob[1]);
                        fbm_mma(dv[2 * dd], pl, ob[0], ob[1]);
                        fbm_mma(dv[2 * dd + 1], ph, ob[2], ob[3]);
                        fbm_mma(dv[2 * dd + 1], pl, ob[2], ob[3]);
                        fbm_mma(dk[2 * dd], sh, qb[0], qb[1]);
                        fbm_mma(dk[2 * dd], sl, qb[0], qb[1]);
                        fbm_mma(dk[2 * dd + 1], sh, qb[2], qb[3]);
                        fbm_mma(dk[2 * dd + 1], sl, qb[2], qb[3]);
                    }
                }
            }
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            if (key[i] >= a.Sk) continue;
            bf16* dkr = dkg + (long long)key[i] * a.dk_ss + c0 + tq * 2;
            bf16* dvr = dvg + (long long)key[i] * a.dv_ss + c0 + tq * 2;
#pragma unroll
            for (int n = 0; n < NC / 8; ++n)
                if (c0 + n * 8 < hd) {
                    fbm_store2(dkr + n * 8, dk[n][2 * i], dk[n][2 * i + 1]);
                    fbm_store2(dvr + n * 8, dv[n][2 * i], dv[n][2 * i + 1]);
                }
        }
    }
}

// ---- launch and C interface ------------------------------------------------
// tiles per instantiation; kernels/flash_attention.py's bwd_mma_tiles
// mirrors them
__host__ inline int fbm_hd_bound(int hd) {
    return hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 128 ? 128 : 256;
}
__host__ inline int fbm_dq_bk(int hd) {
    return fbm_hd_bound(hd) <= 128 ? 64 : 32;
}
__host__ inline int fbm_dkdv_bq(int hd) {
    return fbm_hd_bound(hd) <= 80 ? 64 : 32;
}

__host__ inline int fbm_smem_bytes(int kernel, int hd) {
    const int ld = hd + 8;
    if (kernel == 0)  // Q, dO; K, V double-buffered
        return (2 * FBM_ROWS + 4 * fbm_dq_bk(hd)) * ld * 2;
    const int bq = fbm_dkdv_bq(hd);  // K, V; Q, dO, lse, delta double
    return (2 * FBM_ROWS + 4 * bq) * ld * 2 + 4 * bq * 4;
}

template <typename Kern>
static cudaError_t fbm_launch(Kern kern, dim3 grid, int smem,
                              const FbmArgs& a, cudaStream_t st) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, FBM_THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

static cudaError_t fbm_run(int kernel, const FbmArgs& a, int batch,
                           cudaStream_t st) {
    const int smem = fbm_smem_bytes(kernel, a.hd);
    const int hdb = fbm_hd_bound(a.hd);
    if (kernel == 0) {
        dim3 grid((a.S + FBM_ROWS - 1) / FBM_ROWS, batch * a.H);
        if (hdb == 64)
            return fbm_launch(fbm_dq_kernel<64, 64>, grid, smem, a, st);
        if (hdb == 80)
            return fbm_launch(fbm_dq_kernel<80, 64>, grid, smem, a, st);
        if (hdb == 128)
            return fbm_launch(fbm_dq_kernel<128, 64>, grid, smem, a, st);
        return fbm_launch(fbm_dq_kernel<256, 32>, grid, smem, a, st);
    }
    dim3 grid((a.Sk + FBM_ROWS - 1) / FBM_ROWS, batch * a.KV);
    if (hdb == 64)
        return fbm_launch(fbm_dkdv_kernel<64, 64, 64>, grid, smem, a, st);
    if (hdb == 80)
        return fbm_launch(fbm_dkdv_kernel<80, 80, 64>, grid, smem, a, st);
    if (hdb == 128)
        return fbm_launch(fbm_dkdv_kernel<128, 128, 32>, grid, smem, a, st);
    return fbm_launch(fbm_dkdv_kernel<256, 128, 32>, grid, smem, a, st);
}

extern "C" {

// kernel: 0 = dQ, 1 = dK/dV.  dtype: 1 bfloat16, the only one taken (the
// codes, and the arguments, are flash_attention_bwd.cu's flash_bwd's).
// Every tensor is bfloat16 but lse and delta: (B*H, S) float32.  strides: 21 element strides, in the order (batch,
// seq, head) for q, k, v, do, dq, dk and dv; each last dim is dense, and
// each pointer and stride (of a dim longer than 1) keeps rows 16-byte
// aligned.  window <= 0: none.
int flash_bwd_mma(int kernel, int dtype, const void* q, const void* k,
                  const void* v, const void* dout, const float* lse,
                  const float* delta, void* dq, void* dk, void* dv,
                  int batch, int S, int Sk, int H, int KV, int hd,
                  const long long* strides, int causal, int window,
                  float scale, void* stream) {
    if (kernel != 0 && kernel != 1) return FBM_ERR_KERNEL;
    if (dtype != 1) return FBM_ERR_DTYPE;
    if (hd < 16 || hd > FBM_MAX_HD || hd % 16) return FBM_ERR_HEAD_DIM;
    if (KV < 1 || H % KV) return FBM_ERR_GROUPS;
    if (batch < 1 || S < 1 || Sk < 1) return FBM_ERR_SHAPE;
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    for (int t = 0; t < 7; ++t) {
        if ((uintptr_t)ptrs[t] % 16) return FBM_ERR_ALIGN;
        const int rows = t == 1 || t == 2 || t == 5 || t == 6 ? Sk : S;
        const int heads = t == 1 || t == 2 || t == 5 || t == 6 ? KV : H;
        const int dims[3] = {batch, rows, heads};
        for (int d = 0; d < 3; ++d)
            if (dims[d] > 1 && strides[3 * t + d] % 8) return FBM_ERR_ALIGN;
    }
    FbmArgs a;
    a.q = (const bf16*)q;
    a.k = (const bf16*)k;
    a.v = (const bf16*)v;
    a.dout = (const bf16*)dout;
    a.lse = lse;
    a.delta = delta;
    a.dq = (bf16*)dq;
    a.dk = (bf16*)dk;
    a.dv = (bf16*)dv;
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
    a.scale_log2 = scale * 1.4426950408889634f;
    return (int)fbm_run(kernel, a, batch, (cudaStream_t)stream);
}

int flash_bwd_mma_smem_bytes(int kernel, int hd) {
    return fbm_smem_bytes(kernel, hd);
}

const char* flash_bwd_mma_error_string(int err) {
    switch (err) {
        case FBM_ERR_HEAD_DIM:
            return "head_dim must be a multiple of 16 in [16, 256]";
        case FBM_ERR_GROUPS:
            return "kv_heads must divide heads";
        case FBM_ERR_DTYPE:
            return "these kernels take bfloat16 only (dtype code 1)";
        case FBM_ERR_SHAPE:
            return "batch, S and Sk must be >= 1";
        case FBM_ERR_KERNEL:
            return "kernel must be 0 (dQ) or 1 (dK/dV)";
        case FBM_ERR_ALIGN:
            return "every tensor's rows must be 16-byte aligned (pointers "
                   "and strides in multiples of 8 elements)";
        default:
            return cudaGetErrorString((cudaError_t)err);
    }
}

}  // extern "C"
