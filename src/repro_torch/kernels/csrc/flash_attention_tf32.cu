// Flash attention, forward, float32, on Hopper's tensor cores (sm_90a):
// the online softmax of flash_attention_mma.cu (the bfloat16 route), with
// both products an mma.sync of TF32 operands into float32 accumulators,
// three of them a product (3xTF32) so that the result keeps float32's
// accuracy.
//
// Replaces the reference's Pallas TPU kernels
//   src/repro/kernels/flash_attention.py::_kernel          (lse off)
//   src/repro/kernels/flash_attention.py::_fwd_kernel_lse  (lse on)
// for float32 q, k and v.  Their grid (B*H, q-chunks, kv-chunks) carries
// (acc, m, l) in VMEM scratch along its sequential kv axis; here that axis
// is a loop inside the CTA and the running state lives in registers:
//
//   * one CTA of 128 threads (four warps) per (batch*head, 64-query tile),
//     the last query tiles first (they keep the most keys under a causal
//     mask); a warp owns 16 query rows, the m of mma.sync.m16n8k8;
//   * the CTA loops over the key tiles some row of its tile keeps
//     (kernels/flash_attention.py's fwd_key_tile_range): BK keys a tile,
//     64 up to hd 80, 32 above (the float32 tiles take twice the bf16
//     kernel's shared memory, and the split operands and accumulators the
//     registers).  At hd 80, 32-key tiles would hold a CTA to 160
//     registers, three CTAs an SM against two, and ran faster, but their
//     other rounding took zamba2-2.7b's float32 whole path (which
//     amplifies any difference) past its limit against the chunked path
//     (PERF.md);
//   * s = q k^T: Q's and K's fragments are 32-bit shared loads (ldmatrix
//     moves 16-bit elements only), split into TF32 hi/lo in registers at
//     each load;
//   * softmax in registers, as in flash_attention_mma.cu: two rows (gr and
//     gr + 8 of the warp's 16) against BK/4 keys a thread, the row max
//     reduced across the four lanes of a quad, l reduced once at the end,
//     p = 2^(s * scale * log2 e - m) by ex2.approx with m in log2 units;
//   * p v: m16n8k8's accumulator holds (row gr, columns 2 tq, 2 tq + 1)
//     and its A operand wants (row gr, columns tq, tq + 4), so the C->A
//     identity of the bf16 kernel does not hold.  The sum over keys does
//     not care about their order, though: k step kk takes A column tq as
//     key 2 tq and column tq + 4 as key 2 tq + 1 of score n-tile kk, which
//     makes the accumulators the A operand as they stand (no shuffle, no
//     trip through shared memory), and V's B fragment reads the same two
//     keys.  Output columns are interleaved too: the two n-tiles of a
//     16-column group take the group's even and odd columns, so a thread
//     reads V as 64-bit pairs and writes its four consecutive output
//     columns as one 16-byte store.
// K and V tiles are float32 at a row stride of hd + 4 floats (hd is a
// multiple of 16): the 32-bit row fragments (8 rows x 4 columns a load)
// and the 64-bit column fragments of V (rows 2 tq, columns 2 gr) each hit
// 32 different banks.  Both are double-buffered by cp.async with one
// barrier per tile; rows past S and Sk are zero-filled, so no stale bits
// reach an mma.
//
// Masks are the reference's, applied as flash_attention_mma.cu applies
// them: causal keeps key <= qpos, a window keeps key > qpos - window; a
// masked score is the finite -1e30, and keys past Sk are -inf.  Key tiles
// wholly masked for the CTA are skipped, unless some row of the tile keeps
// no key at all (possible only when S >= Sk + window): such a tile runs
// over every key tile, and its fully masked rows average all keys, with
// the lse -1e30 + log l, as the reference's.  A warp whose 16 rows keep
// every key of the tile skips the per-pair mask test.
//
// Precision: 3xTF32.  One TF32 operand keeps 10 of float32's 23 mantissa
// bits (about 1e-3 relative), which misses the port's float32 limits (out
// 2e-5, lse 1e-4).  Each operand x is split at load into hi = tf32_rna(x)
// and lo = tf32_rna(x - hi) (cvt.rna.tf32.f32: round to nearest, ties
// away from zero), and each product is hi_a lo_b + lo_a hi_b + hi_a hi_b:
// about 2^-21 relative, the lo_a lo_b term (2^-22) dropped.  The
// accumulators matter as much as the split.  An mma rounds its sum at the
// accumulator's magnitude and toward zero, not to nearest, so a running
// sum drifts toward zero by about an ulp each mma: with all three terms
// of every k step in one accumulator, and p v summed over thousands of
// keys that way, out read 8.6e-6 off the plain version at h2o-danube's
// layer (B4 S8192 H32 KV8 hd 80, window 4096; an NVIDIA H100), ten times
// the float32-FMA kernel's 8.8e-7, and the f32 whole training path missed
// its gradient limit.  So the small terms go into accumulators of their
// own and the large one into another, added at the end of s; and each key
// tile's p v is summed in fresh accumulators and added to the running
// acc * corr with a float32 fma, rounded to nearest: one rounding a tile
// and column, not three an mma.  l sums the float32 p.  The output is
// acc / max(l, 1e-30), written through the strides.  No atomics and a
// fixed order of sums: a launch repeats bit for bit.
//
// What bounds it on this card: 4*hd flops per kept (query, key) pair (the
// two products) against q, k, v read once and o written once: the
// operations, at the tensor cores' dense TF32 rate (495 TFLOP/s).  3xTF32
// issues 12*hd per computed pair, plus the pairs at the tile edges, and
// each operand is split (two cvt and a subtract) at every load, by each of
// the four warps for K and V; the splits and the 32-bit shared loads
// compete with the mma for issue slots.  wgmma (which takes TF32 operands
// only K-major, which p v is not), TMA and split tiles shared by the warps
// are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FFT_THREADS 128  // four warps
#define FFT_BQ 64        // the query tile: 16 rows a warp
#define FFT_MAX_HD 256
#define FFT_NEG_INF (-1e30f)  // the reference's masked score
#define FFT_LOG2E 1.4426950408889634f
#define FFT_LN2 0.6931471805599453f

// error codes beyond cudaError_t's range (flash_attention_mma.cu's)
#define FFT_ERR_HEAD_DIM 10001
#define FFT_ERR_GROUPS 10002
#define FFT_ERR_DTYPE 10003
#define FFT_ERR_SHAPE 10004
#define FFT_ERR_ALIGN 10005

struct FftArgs {
    const float* q;
    const float* k;
    const float* v;
    float* o;
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
__device__ __forceinline__ uint32_t fft_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void fft_cp16(void* dst, const void* src,
                                         bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     fft_smem_addr(dst)),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void fft_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fft_cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits, the low 13 bits of the word zero),
// to nearest with ties away from zero
__device__ __forceinline__ uint32_t fft_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo + (x's bits below lo's), hi and lo TF32
__device__ __forceinline__ void fft_split(float x, uint32_t& hi,
                                          uint32_t& lo) {
    hi = fft_tf32(x);
    lo = fft_tf32(x - __uint_as_float(hi));
}

// the A operand (hi, lo) of rows gr and gr + 8 from a row-major tile at
// p = &tile[row gr][k step's column tq], row stride ld
__device__ __forceinline__ void fft_rows_as_a(const float* p, int ld,
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
    fft_split(p[0], hi[0], lo[0]);
    fft_split(p[8 * ld], hi[1], lo[1]);
    fft_split(p[4], hi[2], lo[2]);
    fft_split(p[8 * ld + 4], hi[3], lo[3]);
}

// the A operand (hi, lo) of a k step from the accumulator tile c: column
// tq is c's column 2 tq, column tq + 4 its column 2 tq + 1
__device__ __forceinline__ void fft_c_as_a(const float (&c)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
    fft_split(c[0], hi[0], lo[0]);
    fft_split(c[2], hi[1], lo[1]);
    fft_split(c[1], hi[2], lo[2]);
    fft_split(c[3], hi[3], lo[3]);
}

// the B operands (hi, lo) of the even- and odd-column n-tiles of a
// 16-column group from a row-major tile at p = &tile[row 2 tq][column
// 2 gr of the group]: rows 2 tq and 2 tq + 1 for k tq and tq + 4
__device__ __forceinline__ void fft_pairs_as_b(const float* p, int ld,
                                               uint32_t (&hi)[2][2],
                                               uint32_t (&lo)[2][2]) {
    const float2 r0 = *reinterpret_cast<const float2*>(p);
    const float2 r1 = *reinterpret_cast<const float2*>(p + ld);
    fft_split(r0.x, hi[0][0], lo[0][0]);
    fft_split(r1.x, hi[0][1], lo[0][1]);
    fft_split(r0.y, hi[1][0], lo[1][0]);
    fft_split(r1.y, hi[1][1], lo[1][1]);
}

// d += a b: a 16x8 (row), b 8x8 (col), TF32; d 16x8 float32.  Fragments
// (gr = lane / 4, tq = lane % 4): a = (gr, tq), (gr + 8, tq), (gr, tq + 4),
// (gr + 8, tq + 4); b = (k tq, n gr), (k tq + 4, n gr); d = (gr, 2 tq),
// (gr, 2 tq + 1), (gr + 8, 2 tq), (gr + 8, 2 tq + 1)
__device__ __forceinline__ void fft_mma(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, to 2 ulp (flushes results below 2^-126 to zero)
__device__ __forceinline__ float fft_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// ---- kernel ----------------------------------------------------------------
// rows row0 .. row0+nrows-1 of a (rows, hd) float32 slab into shared
// memory at row stride ld, by 16-byte cp.async; rows at or past `limit`
// are zero
__device__ __forceinline__ void fft_load_rows(float* dst, int ld,
                                              const float* src,
                                              long long row_stride, int row0,
                                              int nrows, int limit, int hd) {
    const int chunks = hd >> 2;
    for (int i = threadIdx.x; i < nrows * chunks; i += FFT_THREADS) {
        const int r = i / chunks, c = (i - r * chunks) << 2;
        const bool in = row0 + r < limit;
        fft_cp16(dst + r * ld + c,
                 in ? src + (long long)(row0 + r) * row_stride + c : src, in);
    }
}

// whether the mask keeps the pair (qpos, key), key < Sk
__device__ __forceinline__ bool fft_keep(const FftArgs& a, int qpos,
                                         int key) {
    return !(a.causal && key > qpos)
           && !(a.window > 0 && key <= qpos - a.window);
}

// whether the mask keeps every pair of queries q0 .. q1 x keys k0 .. k1
__device__ __forceinline__ bool fft_keeps_all(const FftArgs& a, int q0,
                                              int q1, int k0, int k1) {
    return q1 < a.S && k1 < a.Sk && !(a.causal && k1 > q0)
           && !(a.window > 0 && k0 <= q1 - a.window);
}

// the online-softmax step of one key tile for a thread's two rows
// (flash_attention_mma.cu's): s (the scores of NT n-tiles; element e of
// n-tile n is row i = e / 2, query qpos[i], key kb + 8 n + e % 2) becomes
// p against the new running max; m, l and the accumulator scale `corr`
// are updated.  MASK: check each pair (a tile the warp's rows keep whole
// skips it).
template <int NT, bool MASK>
__device__ __forceinline__ void fft_softmax(float (&s)[NT][4],
                                            const FftArgs& a,
                                            const int (&qpos)[2], int kb,
                                            float (&m)[2], float (&l)[2],
                                            float (&corr)[2]) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = kb + n * 8 + (e & 1);
            if (!MASK || (key < a.Sk && fft_keep(a, qpos[e >> 1], key)))
                mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // m >= -1e30 always, so a row with no kept key here keeps its m
        m_new[i] = fmaxf(m[i], mx[i] * a.scale_log2);
        corr[i] = fft_exp2(m[i] - m_new[i]);
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
                p = fft_exp2(fmaf(s[n][e], a.scale_log2, -m_new[i]));
            } else {
                const int key = kb + n * 8 + (e & 1);
                if (key >= a.Sk)
                    p = 0.f;  // -inf: the key does not exist
                else if (fft_keep(a, qpos[i], key))
                    p = fft_exp2(fmaf(s[n][e], a.scale_log2, -m_new[i]));
                else  // the finite sentinel: 1 until the row keeps a key
                    p = fft_exp2(FFT_NEG_INF - m_new[i]);
            }
            sum[i] += p;
            s[n][e] = p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

template <int HDB, int BK, bool LSE>
__global__ void __launch_bounds__(FFT_THREADS) fft_kernel(FftArgs a) {
    extern __shared__ __align__(16) float fft_smem[];
    const int hd = a.hd, ld = hd + 4;
    float* Qs = fft_smem;
    float* Ks = Qs + FFT_BQ * ld;  // [2][BK][ld]
    float* Vs = Ks + 2 * BK * ld;  // [2][BK][ld]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tq = lane & 3;
    // the last query tiles carry the most causal work: start them first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FFT_BQ;
    const int bh = blockIdx.y;
    const int b = bh / a.H, h = bh % a.H;
    const int kvh = h / (a.H / a.KV);  // GQA: kv row b*KV + h // G

    const float* qg = a.q + b * a.q_sb + h * a.q_sh;
    const float* kg = a.k + b * a.k_sb + kvh * a.k_sh;
    const float* vg = a.v + b * a.v_sb + kvh * a.v_sh;

    // the key tiles this query tile needs; a tile with a row that keeps no
    // key runs over all of them
    const int q_last = min(q0 + FFT_BQ, a.S) - 1;
    const bool windowed = a.window > 0;
    int k_lo = 0, k_hi = a.Sk;
    if (!(windowed && q_last >= a.Sk + a.window - 1)) {
        if (windowed) k_lo = max(0, q0 - a.window + 1);
        if (a.causal) k_hi = min(a.Sk, q_last + 1);
    }
    const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

    fft_load_rows(Qs, ld, qg, a.q_ss, q0, FFT_BQ, a.S, hd);
    fft_load_rows(Ks, ld, kg, a.k_ss, t_lo * BK, BK, a.Sk, hd);
    fft_load_rows(Vs, ld, vg, a.v_ss, t_lo * BK, BK, a.Sk, hd);
    fft_cp_commit();

    // this thread's rows of the accumulator tiles: gr and gr + 8 of the
    // warp's 16
    const int qw = q0 + warp * 16;
    const int qpos[2] = {qw + gr, qw + gr + 8};
    float m[2] = {FFT_NEG_INF, FFT_NEG_INF}, l[2] = {0.f, 0.f};
    float acc[HDB / 8][4];
#pragma unroll
    for (int n = 0; n < HDB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // A operands of s = q k^T: this warp's rows gr (+ 8), column tq (+ 4)
    const float* qa_p = Qs + (warp * 16 + gr) * ld + tq;
    // B operands of s: key gr of each n-tile, column tq (+ 4)
    const int kb_off = gr * ld + tq;
    // B operands of o = p v: keys 2 tq and 2 tq + 1 of each k step,
    // columns 2 gr and 2 gr + 1 of each 16-column group
    const int vb_off = 2 * tq * ld + 2 * gr;

    for (int t = t_lo; t < t_hi; ++t) {
        const int buf = (t - t_lo) & 1;
        fft_cp_wait_all();
        __syncthreads();  // tile t landed; every warp is done with t - 1
        if (t + 1 < t_hi) {
            fft_load_rows(Ks + (buf ^ 1) * BK * ld, ld, kg, a.k_ss,
                          (t + 1) * BK, BK, a.Sk, hd);
            fft_load_rows(Vs + (buf ^ 1) * BK * ld, ld, vg, a.v_ss,
                          (t + 1) * BK, BK, a.Sk, hd);
        }
        fft_cp_commit();
        const float* Kt = Ks + buf * BK * ld;
        const float* Vt = Vs + buf * BK * ld;
        const int k0 = t * BK;

        // s = q k^T, 3xTF32 over k steps of 8 columns: the small terms
        // (hi lo, lo hi) and the large one (hi hi) in accumulators of
        // their own, added once at the end
        float s[BK / 8][4], ss[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = ss[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HDB / 8; ++kk) {
            if (kk * 8 < hd) {
                uint32_t ah[4], al[4];
                fft_rows_as_a(qa_p + kk * 8, ld, ah, al);
                uint32_t bh[BK / 8][2], bl[BK / 8][2];
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    const float* kp = Kt + n * 8 * ld + kb_off + kk * 8;
                    fft_split(kp[0], bh[n][0], bl[n][0]);
                    fft_split(kp[4], bh[n][1], bl[n][1]);
                }
#pragma unroll
                for (int n = 0; n < BK / 8; ++n)
                    fft_mma(ss[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
                for (int n = 0; n < BK / 8; ++n)
                    fft_mma(ss[n], al, bh[n][0], bh[n][1]);
#pragma unroll
                for (int n = 0; n < BK / 8; ++n)
                    fft_mma(s[n], ah, bh[n][0], bh[n][1]);
            }
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += ss[n][e];

        float corr[2];
        if (fft_keeps_all(a, qw, qw + 15, k0, k0 + BK - 1))
            fft_softmax<BK / 8, false>(s, a, qpos, k0 + tq * 2, m, l, corr);
        else
            fft_softmax<BK / 8, true>(s, a, qpos, k0 + tq * 2, m, l, corr);

        // p as the A operand of k step kk: score n-tile kk with column tq
        // as key 2 tq and column tq + 4 as key 2 tq + 1, split once
        uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) fft_c_as_a(s[kk], ph[kk], pl[kk]);

        // acc = acc * corr + p v: the tile's sum over its keys goes into
        // fresh accumulators (small and large terms apart) and is added to
        // the running sum once, in float32 with rounding to nearest; DG
        // 16-column groups at a time (n-tiles 2 j and 2 j + 1: the group's
        // even and odd columns)
        constexpr int DG = HDB <= 128 ? 2 : 1;
#pragma unroll
        for (int d0 = 0; d0 < HDB / 16; d0 += DG) {
            float tb[DG][2][4], ts[DG][2][4];
#pragma unroll
            for (int g = 0; g < DG; ++g)
#pragma unroll
                for (int x = 0; x < 2; ++x)
#pragma unroll
                    for (int e = 0; e < 4; ++e) tb[g][x][e] = ts[g][x][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk) {
                const float* vp = Vt + kk * 8 * ld + vb_off;
                // [group][n-tile: even, odd columns][b0: key 2 tq, b1: + 1]
                uint32_t bh[DG][2][2], bl[DG][2][2];
#pragma unroll
                for (int g = 0; g < DG; ++g)
                    if (d0 + g < HDB / 16 && (d0 + g) * 16 < hd)
                        fft_pairs_as_b(vp + (d0 + g) * 16, ld, bh[g], bl[g]);
#pragma unroll
                for (int g = 0; g < DG; ++g)
                    if (d0 + g < HDB / 16 && (d0 + g) * 16 < hd)
#pragma unroll
                        for (int x = 0; x < 2; ++x) {
                            fft_mma(ts[g][x], ph[kk], bl[g][x][0],
                                    bl[g][x][1]);
                            fft_mma(tb[g][x], ph[kk], bh[g][x][0],
                                    bh[g][x][1]);
                        }
#pragma unroll
                for (int g = 0; g < DG; ++g)
                    if (d0 + g < HDB / 16 && (d0 + g) * 16 < hd)
#pragma unroll
                        for (int x = 0; x < 2; ++x)
                            fft_mma(ts[g][x], pl[kk], bh[g][x][0],
                                    bh[g][x][1]);
            }
#pragma unroll
            for (int g = 0; g < DG; ++g)
                if (d0 + g < HDB / 16 && (d0 + g) * 16 < hd)
#pragma unroll
                    for (int x = 0; x < 2; ++x)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            float& r = acc[2 * (d0 + g) + x][e];
                            r = fmaf(r, corr[e >> 1],
                                     tb[g][x][e] + ts[g][x][e]);
                        }
        }
    }

    float* og = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        // each lane of the quad summed its own keys
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if (qpos[i] >= a.S) continue;
        const float li = fmaxf(l[i], 1e-30f);
        // columns 16 j + 4 tq .. + 3: even n-tile's two, odd n-tile's two
        float* row = og + (long long)qpos[i] * a.o_ss + tq * 4;
#pragma unroll
        for (int j = 0; j < HDB / 16; ++j)
            if (j * 16 < hd)
                *reinterpret_cast<float4*>(row + j * 16) = make_float4(
                    acc[2 * j][2 * i] / li, acc[2 * j + 1][2 * i] / li,
                    acc[2 * j][2 * i + 1] / li,
                    acc[2 * j + 1][2 * i + 1] / li);
        if (LSE && tq == 0)  // natural-log units; a row with no kept key
            a.lse[(long long)bh * a.S + qpos[i]] =  // keeps the sentinel
                (m[i] == FFT_NEG_INF ? FFT_NEG_INF : m[i] * FFT_LN2)
                + logf(li);
    }
}

// ---- launch and C interface ------------------------------------------------
// tiles per instantiation; kernels/flash_attention.py's fwd_tiles (for
// float32) mirrors them
__host__ inline int fft_hd_bound(int hd) {
    return hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 128 ? 128 : 256;
}
__host__ inline int fft_bk(int hd) { return fft_hd_bound(hd) <= 80 ? 64 : 32; }

// Q; K and V double-buffered; rows of hd + 4 floats
__host__ inline int fft_smem_bytes(int hd) {
    return (FFT_BQ + 4 * fft_bk(hd)) * (hd + 4) * 4;
}

template <int HDB, int BK, bool LSE>
static cudaError_t fft_launch(const FftArgs& a, int batch, cudaStream_t st) {
    const int smem = fft_smem_bytes(a.hd);
    auto kern = fft_kernel<HDB, BK, LSE>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.S + FFT_BQ - 1) / FFT_BQ, batch * a.H);
    kern<<<grid, FFT_THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

template <bool LSE>
static cudaError_t fft_run(const FftArgs& a, int batch, cudaStream_t st) {
    switch (fft_hd_bound(a.hd)) {
        case 64:
            return fft_launch<64, 64, LSE>(a, batch, st);
        case 80:
            return fft_launch<80, 64, LSE>(a, batch, st);
        case 128:
            return fft_launch<128, 32, LSE>(a, batch, st);
        default:
            return fft_launch<256, 32, LSE>(a, batch, st);
    }
}

extern "C" {

// The arguments, and the codes, are flash_attention_mma.cu's
// flash_fwd_mma's.  dtype: 0 float32, the only one taken.  strides: 12
// element strides, in the order (batch, seq, head) for q, k, v and o; each
// last dim is dense, and each pointer and stride (of a dim longer than 1)
// keeps rows 16-byte aligned.  lse: (B*H, S) float32 when with_lse, else
// ignored.  window <= 0: none.
int flash_fwd_tf32(int dtype, int with_lse, const void* q, const void* k,
                   const void* v, void* o, float* lse, int batch, int S,
                   int Sk, int H, int KV, int hd, const long long* strides,
                   int causal, int window, float scale, void* stream) {
    if (dtype != 0) return FFT_ERR_DTYPE;
    if (hd < 16 || hd > FFT_MAX_HD || hd % 16) return FFT_ERR_HEAD_DIM;
    if (KV < 1 || H % KV) return FFT_ERR_GROUPS;
    if (batch < 1 || S < 1 || Sk < 1) return FFT_ERR_SHAPE;
    const void* ptrs[4] = {q, k, v, o};
    for (int t = 0; t < 4; ++t) {
        if ((uintptr_t)ptrs[t] % 16) return FFT_ERR_ALIGN;
        const int kv_side = t == 1 || t == 2;
        const int dims[3] = {batch, kv_side ? Sk : S, kv_side ? KV : H};
        for (int d = 0; d < 3; ++d)
            if (dims[d] > 1 && strides[3 * t + d] % 4) return FFT_ERR_ALIGN;
    }
    FftArgs a;
    a.q = (const float*)q;
    a.k = (const float*)k;
    a.v = (const float*)v;
    a.o = (float*)o;
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
    a.scale_log2 = scale * FFT_LOG2E;
    cudaStream_t st = (cudaStream_t)stream;
    return (int)(with_lse ? fft_run<true>(a, batch, st)
                          : fft_run<false>(a, batch, st));
}

int flash_fwd_tf32_smem_bytes(int hd) { return fft_smem_bytes(hd); }

const char* flash_fwd_tf32_error_string(int err) {
    switch (err) {
        case FFT_ERR_HEAD_DIM:
            return "head_dim must be a multiple of 16 in [16, 256]";
        case FFT_ERR_GROUPS:
            return "kv_heads must divide heads";
        case FFT_ERR_DTYPE:
            return "this kernel takes float32 only (dtype code 0)";
        case FFT_ERR_SHAPE:
            return "batch, S and Sk must be >= 1";
        case FFT_ERR_ALIGN:
            return "every tensor's rows must be 16-byte aligned (pointers "
                   "and strides in multiples of 4 elements)";
        default:
            return cudaGetErrorString((cudaError_t)err);
    }
}

}  // extern "C"
