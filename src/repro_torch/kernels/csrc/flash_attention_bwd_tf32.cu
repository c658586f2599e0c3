// Flash attention, backward, float32, on Hopper's tensor cores (sm_90a):
// the two kernels of flash_attention_bwd_mma.cu (the bfloat16 route), with
// every product an mma.sync of TF32 operands into float32 accumulators,
// three of them a product (3xTF32) so that the gradients keep float32's
// accuracy.
//
// Replaces the reference's Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_bwd_kernel
// for float32 q, k, v and do.  Its grid (B*H, q-chunks, kv-chunks) runs in
// order on one core: dq is carried in VMEM across the kv axis, and dk/dv
// are read, added to and written back in device memory once per query
// chunk and head.  On a GPU the blocks of a grid run in parallel and in no
// order, so the work is cut twice and no sum needs grid order or atomics:
//
//   * fbt_dq_kernel, query-major: one CTA per (batch*head, 64-query tile)
//     loops over the key tiles its rows keep and sums dQ += dS K in
//     registers, written once;
//   * fbt_dkdv_kernel, key-major: one CTA per (batch, kv head, 64-key
//     tile) keeps its K and V tile in shared memory and loops over the G
//     query heads of its group and, for each, over the query tiles that
//     keep some key of the tile (causal: q >= k; window: q < k + window),
//     summing dV += P^T dO and dK += dS^T Q in registers.  dK and dV are
//     written once, already summed over the group.
//
// Both recompute, per (query tile, key tile), with delta = rowsum(do * o)
// from the wrapper (the reference makes it outside its kernel too):
//   s  = q k^T,           p  = exp(s * scale - lse) where the mask keeps,
//   dp = do v^T,          ds = p * (dp - delta) * scale.
// A row that keeps no key gets no gradient, as in the reference's kernel.
//
// Threads: 128, four warps.  A warp owns 16 query rows (dQ) or 16 keys
// (dK/dV), the m of mma.sync.m16n8k8.  Fragments are 32-bit shared loads
// (ldmatrix moves 16-bit elements only), split into TF32 hi/lo in
// registers at each load.  s, dp, p and ds stay in the accumulator
// registers and become the A operand of the gradient products as they
// stand: m16n8k8's accumulator holds (row gr, columns 2 tq, 2 tq + 1) and
// its A operand wants (row gr, columns tq, tq + 4), so k step kk takes A
// column tq as column 2 tq and tq + 4 as 2 tq + 1 of n-tile kk, and the B
// fragment reads the same rows (the sum does not care about their order).
// Output columns are interleaved: the two n-tiles of a 16-column group
// take its even and odd columns, so the B fragments of the gradient
// products are 64-bit pairs and a thread writes four consecutive columns
// as one 16-byte store.  Tiles are float32 at a row stride of hd + 4
// floats: the 32-bit row fragments (8 rows x 4 columns) and the 64-bit
// column fragments (rows 2 tq, columns 2 gr) each hit 32 different banks.
// The streamed tiles (K and V in dQ; Q, dO, lse and delta in dK/dV) are
// double-buffered: cp.async fills the next buffer while the current one
// computes.  Rows past the end of the sequence are zero-filled, so the
// products never meet stale bits.
//
// Precision: 3xTF32.  Each operand x is split at load into hi =
// tf32_rna(x) and lo = tf32_rna(x - hi) (cvt.rna.tf32.f32: round to
// nearest, ties away from zero), and each product is hi_a lo_b + lo_a
// hi_b + hi_a hi_b: about 2^-21 relative, where one TF32 pass (about
// 1e-3) misses the port's float32 limit of 1e-4.  The small terms go
// into accumulators of their own, and the large one into another: every
// mma rounds its sum at the accumulator's magnitude, and toward zero, not
// to nearest, so three mma into one accumulator a k step triple that
// drift.  The long sums (dq over the key tiles, dk and dv over the query
// tiles and the group's heads) take each tile's products in fresh
// accumulators and add them to the running float32 sum with a rounded
// add, as flash_attention_tf32.cu does (its notes give the measurement
// that showed the drift).  p = 2^(s * scale * log2 e - lse * log2 e) by
// ex2.approx (2 ulp of float32), one fma and one ex2 per element; a tile
// the mask keeps whole skips the per-pair mask test.  No atomics and a
// fixed order of sums: a launch repeats bit for bit.
//
// Tiles per head-dim bound HDB (hd is a multiple of 16 in [16, 256]; a
// kernel instantiated for HDB serves every hd <= HDB, guarding the column
// loops at run time), with float32 tiles twice the bf16 kernels' bytes:
//   dQ:    64 queries x BK keys, BK = 32 up to HDB 128, 16 at HDB 256;
//   dK/dV: 64 keys x BQ queries, BQ = 32 at HDB 64, 16 above (the small
//          terms' accumulators and the tile's split p and ds take the
//          registers); dK and dV are summed NC = min(HDB, 128) columns at
//          a time, so at HDB 256 two passes each recompute s and dp
//          (register room: dK and dV of 256 columns would need 256
//          accumulators a thread).
//
// What bounds it on this card: 10*hd flops per kept (query, key) pair (the
// two recomputed products and the three gradient products) against q, k,
// v, o, do and lse read once and dq, dk, dv written once: the operations,
// at the tensor cores' dense TF32 rate (495 TFLOP/s).  3xTF32 issues
// 18*hd per computed pair in dQ (s, dp, ds k) and 24*hd in dK/dV (s and dp
// again, p^T do, ds^T q), 36*hd above hd 128; every operand is split (two
// cvt and a subtract) at every load, and the splits and the 32-bit shared
// loads compete with the mma for issue slots.  wgmma (TF32 only K-major),
// TMA, one pass and split tiles shared by the warps are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FBT_THREADS 128  // four warps
#define FBT_ROWS 64      // dQ's query tile and dK/dV's key tile: 16 a warp
#define FBT_MAX_HD 256
#define FBT_LOG2E 1.4426950408889634f

// error codes beyond cudaError_t's range (flash_attention_bwd_mma.cu's)
#define FBT_ERR_HEAD_DIM 10001
#define FBT_ERR_GROUPS 10002
#define FBT_ERR_DTYPE 10003
#define FBT_ERR_SHAPE 10004
#define FBT_ERR_KERNEL 10005
#define FBT_ERR_ALIGN 10006

struct FbtArgs {
    const float* q;
    const float* k;
    const float* v;
    const float* dout;
    const float* lse;    // (B*H, S)
    const float* delta;  // (B*H, S)
    float* dq;
    float* dk;
    float* dv;
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
__device__ __forceinline__ uint32_t fbt_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void fbt_cp16(void* dst, const void* src,
                                         bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     fbt_smem_addr(dst)),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void fbt_cp4(void* dst, const void* src,
                                        bool full) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     fbt_smem_addr(dst)),
                 "l"(src), "r"(full ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void fbt_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fbt_cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits, the low 13 bits of the word zero),
// to nearest with ties away from zero
__device__ __forceinline__ uint32_t fbt_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo + (x's bits below lo's), hi and lo TF32
__device__ __forceinline__ void fbt_split(float x, uint32_t& hi,
                                          uint32_t& lo) {
    hi = fbt_tf32(x);
    lo = fbt_tf32(x - __uint_as_float(hi));
}

// d += a b: a 16x8 (row), b 8x8 (col), TF32; d 16x8 float32.  Fragments
// (gr = lane / 4, tq = lane % 4): a = (gr, tq), (gr + 8, tq), (gr, tq + 4),
// (gr + 8, tq + 4); b = (k tq, n gr), (k tq + 4, n gr); d = (gr, 2 tq),
// (gr, 2 tq + 1), (gr + 8, 2 tq), (gr + 8, 2 tq + 1)
__device__ __forceinline__ void fbt_mma(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, to 2 ulp (flushes results below 2^-126 to zero)
__device__ __forceinline__ float fbt_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// the A operand (hi, lo) of a k step from the accumulator tile c: column
// tq is c's column 2 tq, column tq + 4 its column 2 tq + 1
__device__ __forceinline__ void fbt_c_as_a(const float (&c)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
    fbt_split(c[0], hi[0], lo[0]);
    fbt_split(c[2], hi[1], lo[1]);
    fbt_split(c[1], hi[2], lo[2]);
    fbt_split(c[3], hi[3], lo[3]);
}

// the A operand (hi, lo) of rows gr and gr + 8 from a row-major tile at
// p = &tile[row gr][k step's column tq], row stride ld
__device__ __forceinline__ void fbt_rows_as_a(const float* p, int ld,
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
    fbt_split(p[0], hi[0], lo[0]);
    fbt_split(p[8 * ld], hi[1], lo[1]);
    fbt_split(p[4], hi[2], lo[2]);
    fbt_split(p[8 * ld + 4], hi[3], lo[3]);
}

// the B operands (hi, lo) of the even- and odd-column n-tiles of a
// 16-column group from a row-major tile at p = &tile[row 2 tq][column
// 2 gr of the group]: rows 2 tq and 2 tq + 1 for k tq and tq + 4
__device__ __forceinline__ void fbt_pairs_as_b(const float* p, int ld,
                                               uint32_t (&hi)[2][2],
                                               uint32_t (&lo)[2][2]) {
    const float2 r0 = *reinterpret_cast<const float2*>(p);
    const float2 r1 = *reinterpret_cast<const float2*>(p + ld);
    fbt_split(r0.x, hi[0][0], lo[0][0]);
    fbt_split(r1.x, hi[0][1], lo[0][1]);
    fbt_split(r0.y, hi[1][0], lo[1][0]);
    fbt_split(r1.y, hi[1][1], lo[1][1]);
}

// a b in 3xTF32: the small terms hi_a lo_b and lo_a hi_b into small, the
// large one hi_a hi_b into big
__device__ __forceinline__ void fbt_mma3(float (&big)[4], float (&small)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
    fbt_mma(small, ah, bl[0], bl[1]);
    fbt_mma(big, ah, bh[0], bh[1]);
    fbt_mma(small, al, bh[0], bh[1]);
}

// a running float32 sum += a tile's (big + small), rounded to nearest
__device__ __forceinline__ void fbt_fold(float (&sum)[4],
                                         const float (&big)[4],
                                         const float (&small)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] += big[e] + small[e];
}

// ---- kernels ----------------------------------------------------------------
// the reference's mask: causal keeps key <= qpos, a window keeps
// key > qpos - window; rows past S and keys past Sk do not exist
__device__ __forceinline__ bool fbt_keep(const FbtArgs& a, int qpos,
                                         int key) {
    return qpos < a.S && key < a.Sk && !(a.causal && key > qpos)
           && !(a.window > 0 && key <= qpos - a.window);
}

// whether the mask keeps every pair of queries q0 .. q1 x keys k0 .. k1
__device__ __forceinline__ bool fbt_keeps_all(const FbtArgs& a, int q0,
                                              int q1, int k0, int k1) {
    return q1 < a.S && k1 < a.Sk && !(a.causal && k1 > q0)
           && !(a.window > 0 && k0 <= q1 - a.window);
}

// ds in place of s for a warp's 16 query rows against NT n-tiles of keys
// from kb (this thread's first key): element e of n-tile n is row i = e / 2
// (query qpos[i]), key kb + 8 n + e % 2.  MASK: check each pair (a tile
// the mask keeps whole skips it).
template <int NT, bool MASK>
__device__ __forceinline__ void fbt_dq_ds(float (&s)[NT][4],
                                          const float (&dp)[NT][4],
                                          const FbtArgs& a,
                                          const int (&qpos)[2],
                                          const float (&lse2)[2],
                                          const float (&dl)[2], int kb) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float ds = 0.f;
            if (!MASK || fbt_keep(a, qpos[i], kb + n * 8 + (e & 1))) {
                const float p =
                    fbt_exp2(fmaf(s[n][e], a.scale_log2, -lse2[i]));
                ds = p * (dp[n][e] - dl[i]) * a.scale;
            }
            s[n][e] = ds;
        }
}

// p^T in place of s^T and ds^T in place of dp^T for a warp's 16 keys
// against NT n-tiles of queries from q0: element e of n-tile n is key
// key[e / 2], query column 8 n + 2 tq + e % 2, whose lse and delta are
// lt[column] and dlt[column].  MASK as in fbt_dq_ds.
template <int NT, bool MASK>
__device__ __forceinline__ void fbt_dkdv_p_ds(float (&st)[NT][4],
                                              float (&dpt)[NT][4],
                                              const FbtArgs& a,
                                              const int (&key)[2], int q0,
                                              int tq, const float* lt,
                                              const float* dlt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + tq * 2;
        const float2 l = *reinterpret_cast<const float2*>(lt + col);
        const float2 d = *reinterpret_cast<const float2*>(dlt + col);
        const float l2[2] = {l.x * FBT_LOG2E, l.y * FBT_LOG2E};
        const float dl[2] = {d.x, d.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = e & 1;
            float p = 0.f, ds = 0.f;
            if (!MASK || fbt_keep(a, q0 + col + j, key[e >> 1])) {
                p = fbt_exp2(fmaf(st[n][e], a.scale_log2, -l2[j]));
                ds = p * (dpt[n][e] - dl[j]) * a.scale;
            }
            st[n][e] = p;
            dpt[n][e] = ds;
        }
    }
}

// rows row0 .. row0+nrows-1 of a (rows, hd) float32 slab into shared
// memory at row stride ld, by 16-byte cp.async; rows at or past `limit`
// are zero
__device__ __forceinline__ void fbt_load_rows(float* dst, int ld,
                                              const float* src,
                                              long long row_stride, int row0,
                                              int nrows, int limit, int hd) {
    const int chunks = hd >> 2;
    for (int i = threadIdx.x; i < nrows * chunks; i += FBT_THREADS) {
        const int r = i / chunks, c = (i - r * chunks) << 2;
        const bool in = row0 + r < limit;
        fbt_cp16(dst + r * ld + c,
                 in ? src + (long long)(row0 + r) * row_stride + c : src, in);
    }
}

// n floats of one (S,) row of lse or delta from row0; past `limit`, zero
__device__ __forceinline__ void fbt_load_vec(float* dst, const float* src,
                                             int row0, int n, int limit) {
    for (int i = threadIdx.x; i < n; i += FBT_THREADS) {
        const bool in = row0 + i < limit;
        fbt_cp4(dst + i, in ? src + row0 + i : src, in);
    }
}

// the key tiles (of bk keys) some row of the query tile at q0 keeps
__device__ __forceinline__ void fbt_key_tiles(int q0, int bq, int bk, int S,
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
__device__ __forceinline__ void fbt_query_tiles(int k0, int bk, int bq,
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

// a thread's four consecutive columns 16 j + 4 tq .. + 3 of row i (0: gr,
// 1: gr + 8) from the even- and odd-column n-tiles of group j
__device__ __forceinline__ float4 fbt_row4(const float (&even)[4],
                                           const float (&odd)[4], int i) {
    return make_float4(even[2 * i], odd[2 * i], even[2 * i + 1],
                       odd[2 * i + 1]);
}

template <int HDB, int BK>
__global__ void __launch_bounds__(FBT_THREADS) fbt_dq_kernel(FbtArgs a) {
    extern __shared__ __align__(16) float fbt_smem[];
    const int hd = a.hd, ld = hd + 4;
    float* Qs = fbt_smem;
    float* dOs = Qs + FBT_ROWS * ld;
    float* Ks = dOs + FBT_ROWS * ld;  // [2][BK][ld]
    float* Vs = Ks + 2 * BK * ld;     // [2][BK][ld]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tq = lane & 3;
    // the last query tiles keep the most keys under a causal mask: start
    // them first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FBT_ROWS;
    const int bh = blockIdx.y;
    const int b = bh / a.H, h = bh % a.H;
    const int kvh = h / (a.H / a.KV);  // GQA: kv row b*KV + h // G

    const float* qg = a.q + b * a.q_sb + h * a.q_sh;
    const float* dog = a.dout + b * a.do_sb + h * a.do_sh;
    const float* kg = a.k + b * a.k_sb + kvh * a.k_sh;
    const float* vg = a.v + b * a.v_sb + kvh * a.v_sh;

    int t_lo, t_hi;
    fbt_key_tiles(q0, FBT_ROWS, BK, a.S, a.Sk, a.causal, a.window, t_lo,
                  t_hi);
    if (t_lo < t_hi) {
        fbt_load_rows(Qs, ld, qg, a.q_ss, q0, FBT_ROWS, a.S, hd);
        fbt_load_rows(dOs, ld, dog, a.do_ss, q0, FBT_ROWS, a.S, hd);
        fbt_load_rows(Ks, ld, kg, a.k_ss, t_lo * BK, BK, a.Sk, hd);
        fbt_load_rows(Vs, ld, vg, a.v_ss, t_lo * BK, BK, a.Sk, hd);
    }
    fbt_cp_commit();

    // this thread's rows of the accumulator tiles: gr and gr + 8 of the
    // warp's 16
    int qpos[2];
    float lse2[2], dl_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        qpos[i] = q0 + warp * 16 + gr + 8 * i;
        const bool in = qpos[i] < a.S;
        lse2[i] = in ? a.lse[(long long)bh * a.S + qpos[i]] * FBT_LOG2E : 0.f;
        dl_r[i] = in ? a.delta[(long long)bh * a.S + qpos[i]] : 0.f;
    }

    float acc[HDB / 8][4];
#pragma unroll
    for (int n = 0; n < HDB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // A operands of this warp's rows gr (+ 8), column tq (+ 4)
    const float* qa_p = Qs + (warp * 16 + gr) * ld + tq;
    const float* oa_p = dOs + (warp * 16 + gr) * ld + tq;
    // B operands: key gr of each n-tile of s = q k^T and dp = do v^T ...
    const int nb_off = gr * ld + tq;
    // ... and keys 2 tq, 2 tq + 1, columns 2 gr of dq = ds k
    const int pb_off = 2 * tq * ld + 2 * gr;

    for (int t = t_lo; t < t_hi; ++t) {
        const int buf = (t - t_lo) & 1;
        fbt_cp_wait_all();
        __syncthreads();  // tile t landed; every warp is done with t - 1
        if (t + 1 < t_hi) {
            fbt_load_rows(Ks + (buf ^ 1) * BK * ld, ld, kg, a.k_ss,
                          (t + 1) * BK, BK, a.Sk, hd);
            fbt_load_rows(Vs + (buf ^ 1) * BK * ld, ld, vg, a.v_ss,
                          (t + 1) * BK, BK, a.Sk, hd);
        }
        fbt_cp_commit();
        const float* Kt = Ks + buf * BK * ld;
        const float* Vt = Vs + buf * BK * ld;
        const int k0 = t * BK;

        // s = q k^T and dp = do v^T, 3xTF32: the small terms and the large
        // one in accumulators of their own, added once at the end
        float s[BK / 8][4], ssm[BK / 8][4], dp[BK / 8][4], dps[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                s[n][e] = ssm[n][e] = dp[n][e] = dps[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HDB / 8; ++kk) {
            if (kk * 8 < hd) {
                uint32_t qh[4], ql[4], oh[4], ol[4];
                fbt_rows_as_a(qa_p + kk * 8, ld, qh, ql);
                fbt_rows_as_a(oa_p + kk * 8, ld, oh, ol);
                uint32_t kh[BK / 8][2], kl[BK / 8][2];
                uint32_t vh[BK / 8][2], vl[BK / 8][2];
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    const int off = n * 8 * ld + nb_off + kk * 8;
                    fbt_split(Kt[off], kh[n][0], kl[n][0]);
                    fbt_split(Kt[off + 4], kh[n][1], kl[n][1]);
                    fbt_split(Vt[off], vh[n][0], vl[n][0]);
                    fbt_split(Vt[off + 4], vh[n][1], vl[n][1]);
                }
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    fbt_mma(ssm[n], qh, kl[n][0], kl[n][1]);
                    fbt_mma(dps[n], oh, vl[n][0], vl[n][1]);
                }
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    fbt_mma(ssm[n], ql, kh[n][0], kh[n][1]);
                    fbt_mma(dps[n], ol, vh[n][0], vh[n][1]);
                }
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    fbt_mma(s[n], qh, kh[n][0], kh[n][1]);
                    fbt_mma(dp[n], oh, vh[n][0], vh[n][1]);
                }
            }
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[n][e] += ssm[n][e];
                dp[n][e] += dps[n][e];
            }

        if (fbt_keeps_all(a, q0, q0 + FBT_ROWS - 1, k0, k0 + BK - 1))
            fbt_dq_ds<BK / 8, false>(s, dp, a, qpos, lse2, dl_r,
                                     k0 + tq * 2);
        else
            fbt_dq_ds<BK / 8, true>(s, dp, a, qpos, lse2, dl_r, k0 + tq * 2);

        // dq += ds k: k step kk is ds n-tile kk (keys 8 kk + 2 tq, + 1);
        // the tile's sum goes into fresh accumulators, one 16-column group
        // at a time, and is added to dq once
        uint32_t dh[BK / 8][4], dl[BK / 8][4];
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) fbt_c_as_a(s[kk], dh[kk], dl[kk]);
#pragma unroll
        for (int j = 0; j < HDB / 16; ++j) {
            if (j * 16 < hd) {
                float tb[2][4], ts[2][4];
#pragma unroll
                for (int x = 0; x < 2; ++x)
#pragma unroll
                    for (int e = 0; e < 4; ++e) tb[x][e] = ts[x][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < BK / 8; ++kk) {
                    uint32_t bh[2][2], bl[2][2];
                    fbt_pairs_as_b(Kt + kk * 8 * ld + pb_off + j * 16, ld, bh,
                                   bl);
                    fbt_mma3(tb[0], ts[0], dh[kk], dl[kk], bh[0], bl[0]);
                    fbt_mma3(tb[1], ts[1], dh[kk], dl[kk], bh[1], bl[1]);
                }
                fbt_fold(acc[2 * j], tb[0], ts[0]);
                fbt_fold(acc[2 * j + 1], tb[1], ts[1]);
            }
        }
    }

    float* dqg = a.dq + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (qpos[i] >= a.S) continue;
        float* row = dqg + (long long)qpos[i] * a.dq_ss + tq * 4;
#pragma unroll
        for (int j = 0; j < HDB / 16; ++j)
            if (j * 16 < hd)
                *reinterpret_cast<float4*>(row + j * 16) =
                    fbt_row4(acc[2 * j], acc[2 * j + 1], i);
    }
}

template <int HDB, int NC, int BQ>
__global__ void __launch_bounds__(FBT_THREADS) fbt_dkdv_kernel(FbtArgs a) {
    extern __shared__ __align__(16) float fbt_smem[];
    const int hd = a.hd, ld = hd + 4;
    float* Ks = fbt_smem;
    float* Vs = Ks + FBT_ROWS * ld;
    float* Qs = Vs + FBT_ROWS * ld;  // [2][BQ][ld]
    float* dOs = Qs + 2 * BQ * ld;   // [2][BQ][ld]
    float* lse_s = dOs + 2 * BQ * ld;  // [2][BQ]
    float* dl_s = lse_s + 2 * BQ;      // [2][BQ]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const int k0 = blockIdx.x * FBT_ROWS;
    const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
    const int G = a.H / a.KV;

    const float* kg = a.k + b * a.k_sb + kvh * a.k_sh;
    const float* vg = a.v + b * a.v_sb + kvh * a.v_sh;
    int t_lo, t_hi;
    fbt_query_tiles(k0, FBT_ROWS, BQ, a.S, a.Sk, a.causal, a.window, t_lo,
                    t_hi);
    const int n_t = t_hi - t_lo;
    const int items = G * n_t;  // (head of the group, query tile) pairs
    if (items > 0) {
        fbt_load_rows(Ks, ld, kg, a.k_ss, k0, FBT_ROWS, a.Sk, hd);
        fbt_load_rows(Vs, ld, vg, a.v_ss, k0, FBT_ROWS, a.Sk, hd);
    }

    // item it into buffer buf: Q, dO, lse and delta of one query tile
    auto load_item = [&](int it, int buf) {
        const int h = kvh * G + it / n_t;
        const int q0 = (t_lo + it % n_t) * BQ;
        const long long lrow = (long long)(b * a.H + h) * a.S;
        fbt_load_rows(Qs + buf * BQ * ld, ld, a.q + b * a.q_sb + h * a.q_sh,
                      a.q_ss, q0, BQ, a.S, hd);
        fbt_load_rows(dOs + buf * BQ * ld, ld,
                      a.dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0, BQ,
                      a.S, hd);
        fbt_load_vec(lse_s + buf * BQ, a.lse + lrow, q0, BQ, a.S);
        fbt_load_vec(dl_s + buf * BQ, a.delta + lrow, q0, BQ, a.S);
    };

    // this thread's keys: rows gr and gr + 8 of the warp's 16
    int key[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) key[i] = k0 + warp * 16 + gr + 8 * i;

    // A operands of s^T = k q^T and dp^T = v do^T: this warp's keys
    const float* ka_p = Ks + (warp * 16 + gr) * ld + tq;
    const float* va_p = Vs + (warp * 16 + gr) * ld + tq;
    // B operands: query gr of each n-tile (column tq (+ 4)) ...
    const int nb_off = gr * ld + tq;
    // ... and queries 2 tq, 2 tq + 1, columns 2 gr of dv = p^T do and
    // dk = ds^T q
    const int pb_off = 2 * tq * ld + 2 * gr;
    float* dkg = a.dk + b * a.dk_sb + kvh * a.dk_sh;
    float* dvg = a.dv + b * a.dv_sb + kvh * a.dv_sh;

    for (int c0 = 0; c0 < hd; c0 += NC) {
        float dk[NC / 8][4], dv[NC / 8][4];
#pragma unroll
        for (int n = 0; n < NC / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

        __syncthreads();  // the previous pass is done with buffer 0
        if (items > 0) load_item(0, 0);
        fbt_cp_commit();
        for (int it = 0; it < items; ++it) {
            const int buf = it & 1;
            fbt_cp_wait_all();
            __syncthreads();  // item it landed; every warp is done with it-1
            if (it + 1 < items) load_item(it + 1, buf ^ 1);
            fbt_cp_commit();
            const int q0 = (t_lo + it % n_t) * BQ;
            const float* Qt = Qs + buf * BQ * ld;
            const float* dOt = dOs + buf * BQ * ld;
            const float* lt = lse_s + buf * BQ;
            const float* dlt = dl_s + buf * BQ;

            // s^T = k q^T and dp^T = v do^T: rows are this warp's keys,
            // columns the tile's queries; small and large terms apart
            float st[BQ / 8][4], sts[BQ / 8][4], dpt[BQ / 8][4],
                dpts[BQ / 8][4];
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    st[n][e] = sts[n][e] = dpt[n][e] = dpts[n][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < HDB / 8; ++kk) {
                if (kk * 8 < hd) {
                    uint32_t kh[4], kl[4], vh[4], vl[4];
                    fbt_rows_as_a(ka_p + kk * 8, ld, kh, kl);
                    fbt_rows_as_a(va_p + kk * 8, ld, vh, vl);
                    uint32_t qh[BQ / 8][2], ql[BQ / 8][2];
                    uint32_t oh[BQ / 8][2], ol[BQ / 8][2];
#pragma unroll
                    for (int n = 0; n < BQ / 8; ++n) {
                        const int off = n * 8 * ld + nb_off + kk * 8;
                        fbt_split(Qt[off], qh[n][0], ql[n][0]);
                        fbt_split(Qt[off + 4], qh[n][1], ql[n][1]);
                        fbt_split(dOt[off], oh[n][0], ol[n][0]);
                        fbt_split(dOt[off + 4], oh[n][1], ol[n][1]);
                    }
#pragma unroll
                    for (int n = 0; n < BQ / 8; ++n) {
                        fbt_mma(sts[n], kh, ql[n][0], ql[n][1]);
                        fbt_mma(dpts[n], vh, ol[n][0], ol[n][1]);
                    }
#pragma unroll
                    for (int n = 0; n < BQ / 8; ++n) {
                        fbt_mma(sts[n], kl, qh[n][0], qh[n][1]);
                        fbt_mma(dpts[n], vl, oh[n][0], oh[n][1]);
                    }
#pragma unroll
                    for (int n = 0; n < BQ / 8; ++n) {
                        fbt_mma(st[n], kh, qh[n][0], qh[n][1]);
                        fbt_mma(dpt[n], vh, oh[n][0], oh[n][1]);
                    }
                }
            }
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    st[n][e] += sts[n][e];
                    dpt[n][e] += dpts[n][e];
                }

            if (fbt_keeps_all(a, q0, q0 + BQ - 1, k0, k0 + FBT_ROWS - 1))
                fbt_dkdv_p_ds<BQ / 8, false>(st, dpt, a, key, q0, tq, lt,
                                             dlt);
            else
                fbt_dkdv_p_ds<BQ / 8, true>(st, dpt, a, key, q0, tq, lt,
                                            dlt);

            // dv += p^T do and dk += ds^T q over columns c0 .. c0 + NC - 1:
            // k step kk is n-tile kk (queries 8 kk + 2 tq, + 1); the item's
            // sums go into fresh accumulators, one 16-column group at a
            // time, and are added to dk and dv once
            uint32_t ph[BQ / 8][4], pl[BQ / 8][4], sh[BQ / 8][4],
                sl[BQ / 8][4];
#pragma unroll
            for (int kk = 0; kk < BQ / 8; ++kk) {
                fbt_c_as_a(st[kk], ph[kk], pl[kk]);
                fbt_c_as_a(dpt[kk], sh[kk], sl[kk]);
            }
#pragma unroll
            for (int j = 0; j < NC / 16; ++j) {
                if (c0 + j * 16 < hd) {
                    float vb[2][4], vs[2][4], kb[2][4], ks[2][4];
#pragma unroll
                    for (int x = 0; x < 2; ++x)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            vb[x][e] = vs[x][e] = kb[x][e] = ks[x][e] = 0.f;
#pragma unroll
                    for (int kk = 0; kk < BQ / 8; ++kk) {
                        const int off = kk * 8 * ld + pb_off + c0 + j * 16;
                        uint32_t obh[2][2], obl[2][2], qbh[2][2], qbl[2][2];
                        fbt_pairs_as_b(dOt + off, ld, obh, obl);
                        fbt_pairs_as_b(Qt + off, ld, qbh, qbl);
#pragma unroll
                        for (int x = 0; x < 2; ++x) {
                            fbt_mma3(vb[x], vs[x], ph[kk], pl[kk], obh[x],
                                     obl[x]);
                            fbt_mma3(kb[x], ks[x], sh[kk], sl[kk], qbh[x],
                                     qbl[x]);
                        }
                    }
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                        fbt_fold(dv[2 * j + x], vb[x], vs[x]);
                        fbt_fold(dk[2 * j + x], kb[x], ks[x]);
                    }
                }
            }
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            if (key[i] >= a.Sk) continue;
            float* dkr = dkg + (long long)key[i] * a.dk_ss + c0 + tq * 4;
            float* dvr = dvg + (long long)key[i] * a.dv_ss + c0 + tq * 4;
#pragma unroll
            for (int j = 0; j < NC / 16; ++j)
                if (c0 + j * 16 < hd) {
                    *reinterpret_cast<float4*>(dkr + j * 16) =
                        fbt_row4(dk[2 * j], dk[2 * j + 1], i);
                    *reinterpret_cast<float4*>(dvr + j * 16) =
                        fbt_row4(dv[2 * j], dv[2 * j + 1], i);
                }
        }
    }
}

// ---- launch and C interface ------------------------------------------------
// tiles per instantiation; kernels/flash_attention.py's bwd_tiles (for
// float32) mirrors them
__host__ inline int fbt_hd_bound(int hd) {
    return hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 128 ? 128 : 256;
}
__host__ inline int fbt_dq_bk(int hd) {
    return fbt_hd_bound(hd) <= 128 ? 32 : 16;
}
__host__ inline int fbt_dkdv_bq(int hd) {
    return fbt_hd_bound(hd) == 64 ? 32 : 16;
}

__host__ inline int fbt_smem_bytes(int kernel, int hd) {
    const int ld = hd + 4;
    if (kernel == 0)  // Q, dO; K, V double-buffered
        return (2 * FBT_ROWS + 4 * fbt_dq_bk(hd)) * ld * 4;
    const int bq = fbt_dkdv_bq(hd);  // K, V; Q, dO, lse, delta double
    return (2 * FBT_ROWS + 4 * bq) * ld * 4 + 4 * bq * 4;
}

template <typename Kern>
static cudaError_t fbt_launch(Kern kern, dim3 grid, int smem,
                              const FbtArgs& a, cudaStream_t st) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, FBT_THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

static cudaError_t fbt_run(int kernel, const FbtArgs& a, int batch,
                           cudaStream_t st) {
    const int smem = fbt_smem_bytes(kernel, a.hd);
    const int hdb = fbt_hd_bound(a.hd);
    if (kernel == 0) {
        dim3 grid((a.S + FBT_ROWS - 1) / FBT_ROWS, batch * a.H);
        if (hdb == 64)
            return fbt_launch(fbt_dq_kernel<64, 32>, grid, smem, a, st);
        if (hdb == 80)
            return fbt_launch(fbt_dq_kernel<80, 32>, grid, smem, a, st);
        if (hdb == 128)
            return fbt_launch(fbt_dq_kernel<128, 32>, grid, smem, a, st);
        return fbt_launch(fbt_dq_kernel<256, 16>, grid, smem, a, st);
    }
    dim3 grid((a.Sk + FBT_ROWS - 1) / FBT_ROWS, batch * a.KV);
    if (hdb == 64)
        return fbt_launch(fbt_dkdv_kernel<64, 64, 32>, grid, smem, a, st);
    if (hdb == 80)
        return fbt_launch(fbt_dkdv_kernel<80, 80, 16>, grid, smem, a, st);
    if (hdb == 128)
        return fbt_launch(fbt_dkdv_kernel<128, 128, 16>, grid, smem, a, st);
    return fbt_launch(fbt_dkdv_kernel<256, 128, 16>, grid, smem, a, st);
}

extern "C" {

// kernel: 0 = dQ, 1 = dK/dV.  dtype: 0 float32, the only one taken (the
// codes, and the arguments, are flash_attention_bwd_mma.cu's
// flash_bwd_mma's).  Every tensor is float32; lse and delta are (B*H, S).
// strides: 21 element strides, in the order (batch, seq, head) for q, k,
// v, do, dq, dk and dv; each last dim is dense, and each pointer and
// stride (of a dim longer than 1) keeps rows 16-byte aligned.  window
// <= 0: none.
int flash_bwd_tf32(int kernel, int dtype, const void* q, const void* k,
                   const void* v, const void* dout, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv,
                   int batch, int S, int Sk, int H, int KV, int hd,
                   const long long* strides, int causal, int window,
                   float scale, void* stream) {
    if (kernel != 0 && kernel != 1) return FBT_ERR_KERNEL;
    if (dtype != 0) return FBT_ERR_DTYPE;
    if (hd < 16 || hd > FBT_MAX_HD || hd % 16) return FBT_ERR_HEAD_DIM;
    if (KV < 1 || H % KV) return FBT_ERR_GROUPS;
    if (batch < 1 || S < 1 || Sk < 1) return FBT_ERR_SHAPE;
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    for (int t = 0; t < 7; ++t) {
        if ((uintptr_t)ptrs[t] % 16) return FBT_ERR_ALIGN;
        const int rows = t == 1 || t == 2 || t == 5 || t == 6 ? Sk : S;
        const int heads = t == 1 || t == 2 || t == 5 || t == 6 ? KV : H;
        const int dims[3] = {batch, rows, heads};
        for (int d = 0; d < 3; ++d)
            if (dims[d] > 1 && strides[3 * t + d] % 4) return FBT_ERR_ALIGN;
    }
    FbtArgs a;
    a.q = (const float*)q;
    a.k = (const float*)k;
    a.v = (const float*)v;
    a.dout = (const float*)dout;
    a.lse = lse;
    a.delta = delta;
    a.dq = (float*)dq;
    a.dk = (float*)dk;
    a.dv = (float*)dv;
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
    a.scale_log2 = scale * FBT_LOG2E;
    return (int)fbt_run(kernel, a, batch, (cudaStream_t)stream);
}

int flash_bwd_tf32_smem_bytes(int kernel, int hd) {
    return fbt_smem_bytes(kernel, hd);
}

const char* flash_bwd_tf32_error_string(int err) {
    switch (err) {
        case FBT_ERR_HEAD_DIM:
            return "head_dim must be a multiple of 16 in [16, 256]";
        case FBT_ERR_GROUPS:
            return "kv_heads must divide heads";
        case FBT_ERR_DTYPE:
            return "these kernels take float32 only (dtype code 0)";
        case FBT_ERR_SHAPE:
            return "batch, S and Sk must be >= 1";
        case FBT_ERR_KERNEL:
            return "kernel must be 0 (dQ) or 1 (dK/dV)";
        case FBT_ERR_ALIGN:
            return "every tensor's rows must be 16-byte aligned (pointers "
                   "and strides in multiples of 4 elements)";
        default:
            return cudaGetErrorString((cudaError_t)err);
    }
}

}  // extern "C"
