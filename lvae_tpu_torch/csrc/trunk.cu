// Portable-trunk kernels for Hopper (sm_90a): every float between the rANS
// stream's integer junctions (lambda embedding, ConvNeXt-AdaLN blocks, priors
// and scale indexes, fuses, 1x1 convs, pixel finish; for QRes-VAE the plain
// ConvNeXt blocks, the pre-activated 1x1 and K x K convs of the VDBlock
// prior, the z-projection junction, and the lossless pixel head's grid
// rounding and exact reconstruction).
//
// What they must guarantee: a stream decodes bit-exactly in any process, so
// each kernel's output bits depend only on its inputs and the weights' shapes.
// No split-K, no atomics, no library call: each output element's sum over K
// runs in one fixed order that depends only on K (in the matrix products one
// fused multiply-add chain k = 0..K-1; in the small matrix-vector products of
// the embedding and the AdaLN modulation a lane-strided chain per lane, then
// a fixed shuffle tree), and every row or pixel is computed on its own, so
// neither the batch size nor the row count changes a result (they only move
// the ragged-edge mask). Outside the sums the
// arithmetic mirrors the plain PyTorch versions of lvae_tpu_torch/ops/trunk.py
// op by op: the library is built with -fmad=false, so `a + b * c` rounds twice
// as it does there, and without --use_fast_math, so expf, logf, cosf, sinf,
// sqrtf and division are the accurate versions (the scale index is compared
// against a table).
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// lvae_tpu_torch/ops/build.py like csrc/rans.cu: raw device pointers, int
// sizes, the device ordinal and a cudaStream_t; each entry point launches on
// that stream without synchronising and returns cudaGetLastError(). Scratch
// buffers are allocated by the Python wrappers.
//
// The matrix products run on two exact-float32 SIMT cores, no tensor cores
// (TF32 keeps ~3 digits, and 3xTF32 or FP64 DMMA would change the bits):
// - gemm_kernel, one 64x64 shared-memory tile with a single buffer: on no
//   main path, only the oracle of the other core (the _oldcore entry
//   points of dense_act, prior_head, fuse_zproj, res_dense_act and
//   zadd_dense);
// - tiled_kernel, built for the H100: tile shapes chosen by (M, N) so that
//   the grid fills the SMs and no column is wasted, a 3-stage cp.async ring,
//   an implicit-conv loader without per-element division, a GELU or the
//   integer junction's conversion applied to the staged A tile in shared
//   memory, prior_head's scale table staged in shared memory for its index
//   epilogue, and the residual joins' feature tile read into shared memory
//   while the product runs: dense, conv_kxk_act, mlp_res's two products,
//   dense_act, prior_head, fuse_zproj, res_dense_act, zadd_dense and
//   zadd_conv_kxk (the 1x1 and K x K z_proj_0 with the integer junction
//   converted on their staged tiles), and the 1x1 convs that end the
//   synthesis tail (upsample_finish: the pixel finish and the float16 image
//   written in pixel-shuffle order) and the lossless head (upsample_head:
//   both shuffled tensors in one product).
// Both run each output's sum as the same chain k = 0..K-1 in 16-deep steps
// (padded steps add fmaf(0, 0, acc), or are skipped where that returns acc
// bit for bit), so they give the same bits; tiling only moves which thread
// runs a chain, which may follow M (so the batch size) because no chain
// depends on it.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// shared math: lvae_tpu/ops/pallas/trunk.py:77-102, the same formulas
// ---------------------------------------------------------------------------

__device__ __forceinline__ float erf_as(float x) {
    // Abramowitz-Stegun 7.1.26, Horner order as in the reference
    const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
    const float ax = fabsf(x);
    const float t = 1.0f / (1.0f + 0.3275911f * ax);
    const float poly = t * (0.254829592f + t * (-0.284496736f + t * (
        1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
    return s * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_as(float x) {
    return 0.5f * x * (1.0f + erf_as(x * 0.7071067811865476f));
}

__device__ __forceinline__ float softplus_ref(float x) {
    return fmaxf(x, 0.0f) + logf(1.0f + expf(-fabsf(x)));
}

// Sum over a warp by a fixed xor-shuffle tree: every lane ends with the same
// bits (each step adds a pair in the same order on both of its lanes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// One output of a small matrix-vector product, by a whole warp: lane l sums
// k = l, l + 32, ... in order (coalesced reads of the weight row), then the
// shuffle tree; a fixed order that depends only on K.
__device__ __forceinline__ float warp_dot(const float* __restrict__ x,
                                          const float* __restrict__ wrow,
                                          int K, int lane) {
    float acc = 0.f;
    for (int k = lane; k < K; k += 32) acc = fmaf(x[k], __ldg(wrow + k), acc);
    return warp_sum(acc);
}

// ---------------------------------------------------------------------------
// the f32 matrix-product core: out[m, n] = epilogue(sum_k A(m, k) * W[n, k])
// A through a prologue functor, W in (N, K) layout (torch's (out, in)).
//
// Bound on this card: operations where K and N are both wide (dense_act's
// 384-channel convs), against 67 TFLOP/s of non-tensor f32; bytes where K
// or N is a latent width Z or the 48 pixel channels (prior_head,
// fuse_zproj, zadd_dense, res_dense_act), against 3.35 TB/s. This SIMT
// tile reaches a fraction of the first: it runs 2 shared-memory loads
// (float4) per 16 FMAs and stages both operands once per 16-deep K step.
// For the second it reads each A row once per 64 output columns, so a
// narrow N reads A once.
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);  // 256

template <class Load, class Store>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(int M, int N, int K, Load load, const float* __restrict__ w,
            Store store) {
    __shared__ __align__(16) float As[BK][BM + 4];
    __shared__ __align__(16) float Ws[BK][BN + 4];
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN), ty = tid / (BN / TN);
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        // k is the fastest index: a row's 16 K values are one 64-byte read
#pragma unroll
        for (int i = 0; i < BM * BK / GEMM_THREADS; ++i) {
            const int e = tid + i * GEMM_THREADS;
            const int k = e % BK, m = e / BK;
            const int gm = m0 + m, gk = k0 + k;
            As[k][m] = (gm < M && gk < K) ? load(gm, gk) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < BN * BK / GEMM_THREADS; ++i) {
            const int e = tid + i * GEMM_THREADS;
            const int k = e % BK, n = e / BK;
            const int gn = n0 + n, gk = k0 + k;
            Ws[k][n] = (gn < N && gk < K) ? __ldg(w + (long long)gn * K + gk)
                                          : 0.f;
        }
        __syncthreads();
        // padded k adds fma(0, 0, acc) == acc: the chain is k = 0..K-1
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
            const float4 b4 = *reinterpret_cast<const float4*>(&Ws[kk][tx * TN]);
            const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
            const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty * TM + i;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gn = n0 + tx * TN + j;
            if (gn < N) store(gm, gn, acc[i][j]);
        }
    }
}

// prologues: the A operand
struct LoadRows {            // x[m, k]
    const float* x; int K;
    __device__ float operator()(int m, int k) const {
        return __ldg(x + (long long)m * K + k);
    }
};
struct LoadGeluRows {        // gelu(x[m, k]): res_dense_act, the oracles
    const float* x; int K;
    __device__ float operator()(int m, int k) const {
        return gelu_as(__ldg(x + (long long)m * K + k));
    }
};
struct LoadSymsPlusPm {      // float(syms[m, k]) + pm[m, k]: the oracles
    const int* s; const float* pm; int K;
    __device__ float operator()(int m, int k) const {
        const long long e = (long long)m * K + k;
        return (float)__ldg(s + e) + __ldg(pm + e);
    }
};

// epilogues: acc -> outputs
struct StoreBias {           // dense: acc + b
    float* out; const float* b; int N;
    __device__ void operator()(int m, int n, float acc) const {
        out[(long long)m * N + n] = acc + b[n];
    }
};
struct StoreBiasGelu {       // mlp fc1: gelu(acc + b)
    float* out; const float* b; int N;
    __device__ void operator()(int m, int n, float acc) const {
        out[(long long)m * N + n] = gelu_as(acc + b[n]);
    }
};
struct StoreLayerScaleRes {  // mlp fc2: shortcut + (acc + b) * gamma
    float* out; const float* b; const float* g; const float* s; int N;
    __device__ void operator()(int m, int n, float acc) const {
        const long long e = (long long)m * N + n;
        out[e] = s[e] + (acc + b[n]) * g[n];
    }
};
struct StoreResidual {       // fuse: feature + (acc + b)
    float* out; const float* b; const float* f; int N;
    __device__ void operator()(int m, int n, float acc) const {
        const long long e = (long long)m * N + n;
        out[e] = f[e] + (acc + b[n]);
    }
};
struct StoreResidualBias {   // res_dense_act: (feature + acc) + b, the
    float* out; const float* b;  // JAX kernel's order (not StoreResidual's)
    const float* f; int N;
    __device__ void operator()(int m, int n, float acc) const {
        const long long e = (long long)m * N + n;
        out[e] = (f[e] + acc) + b[n];
    }
};
struct StorePrior {          // columns [0, Z): pm; [Z, 2Z): scale index
    float* pm; int* idx; const float* b; const float* table; int S; int Z;
    __device__ void operator()(int m, int n, float acc) const {
        const float v = acc + b[n];
        if (n < Z) {
            pm[(long long)m * Z + n] = v;
            return;
        }
        float pv = expf(softplus_ref(v + 2.3f) - 2.3f);
        pv = fmaxf(pv, __ldg(table));
        int count = 0;                     // #(table < scale), capped
        for (int i = 0; i < S; ++i) count += __ldg(table + i) < pv ? 1 : 0;
        idx[(long long)m * Z + (n - Z)] = min(count, S - 1);
    }
};

template <class Load, class Store>
cudaError_t launch_gemm(int M, int N, int K, Load load, const float* w,
                        Store store, cudaStream_t stream) {
    if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > 65535u) return cudaErrorInvalidValue;
    gemm_kernel<<<grid, GEMM_THREADS, 0, stream>>>(M, N, K, load, w, store);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The pipelined, shape-tiled product core: out[m, n] = store(sum_k A(m, k) *
// W[n, k]), each sum the chain of gemm_kernel (k = 0..K-1 from +0 in PK =
// BK = 16-deep steps, the steps past K adding fmaf(0, 0, acc)), so every
// output has gemm_kernel's bits. What differs is the schedule:
// - Tiles by shape. BM x BN outputs a block, TM x TN a thread, with the
//   thread's rows ty + i*TY and columns tx + j*TX (strided: a warp stores
//   consecutive columns, and its shared-memory reads of 16-byte k-quads hit
//   distinct banks). dispatch_tiled picks BN from N's divisors (64, 48,
//   24: no wasted column at the trunk's widths) and BM from the outputs an
//   SM holds, so that small products still fill the SMs.
// - Copies in flight. A STAGES ring of A and W tiles, both k-contiguous
//   rows of PLD floats, filled by cp.async (16-byte copies where the row
//   stride and the pointers allow, else 4-byte ones; src-size 0 zero-fills
//   the taps off the image and the ragged M, N and K edges). Step s + 2's
//   copies are issued before step s's FMAs, one barrier a step.
// - Operand sources. DenseSrc reads rows of x; GeluRowSrc too, and each
//   thread then rewrites the A elements it copied itself as gelu_as of
//   them, once its own copies of the step have landed and before the
//   step's barrier (gelu_as(+0) == +0: the zero-filled edges stay +0, as
//   gemm_kernel's); SymsPmSrc copies syms and pm into the A slab and an
//   extra slab and converts them in the same slot; ConvSrc is the implicit
//   K x K conv: each tile row's pixel (b, h, w) is decoded once before the
//   K loop and each thread walks its depth k = (di*K + dj)*Ci + ci as a
//   (tap, channel) cursor advanced by adds, no per-element division;
//   ConvSymsPmSrc is ConvSrc over syms and pm with SymsPmSrc's conversion.
// - Epilogue hooks. A store functor with a prepare(tid, threads) member
//   (StorePriorStaged) gets the ring's shared memory once the last copy has
//   landed and every thread is past the K loop, and stages what its stores
//   read there; one with PREFETCH (StoreResidualStaged) copies a tile of
//   its own input into shared memory beyond the ring while the K loop runs,
//   and writes the outputs from there; one with STAGED alone
//   (StoreShuffleStaged) finishes the tile into shared memory beyond the
//   ring and writes it out in an order of its own (the pixel shuffle).
// ---------------------------------------------------------------------------

constexpr int PK = BK;          // K step: gemm_kernel's, so the same padding
constexpr int PLD = PK + 4;     // row stride in floats: 80 bytes, 16-aligned;
                                // 8 consecutive rows cover the 32 banks once
constexpr int STAGES = 3;       // K steps in the ring

template <int V>                // V floats: 4 (cp.async.cg, 16 B) or 1
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int n = valid ? 4 * V : 0;          // 0: fill the copy with +0
    if constexpr (V == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(src), "r"(n) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A operand sources of tiled_kernel. Each names where a thread's copy of
// A(m, k) comes from (src); EXTRA more A-shaped slabs a stage that it copies
// beside A (extra: the same m and k); and, where REWRITE, how each thread
// turns its own landed copies into A's values in shared memory (rewrite(a,
// x): a the copy in the A slab, x the same element's copy in the extra slab)
// once they have landed and before the step's barrier.

// rows of x (M, K); ACT: gelu_as of them
template <bool ACT>
struct RowSrc {
    static constexpr bool REWRITE = ACT;
    static constexpr int EXTRA = 0;
    const float* x; int M, K;
    struct Row { int m; };
    struct Cursor { int k; };
    __device__ Row row(int m) const { return {m}; }
    __device__ Cursor cursor(int k) const { return {k}; }
    __device__ const float* src(const Row& r, const Cursor& c,
                                bool& ok) const {
        ok = r.m < M && c.k < K;
        return ok ? x + (long long)r.m * K + c.k : x;
    }
    __device__ void advance(Cursor& c) const { c.k += PK; }
    __device__ void rewrite(float* a, const float*) const {
        *a = gelu_as(*a);
    }
};
using DenseSrc = RowSrc<false>;
using GeluRowSrc = RowSrc<true>;

// the integer junction (fuse_zproj, zadd_dense): A(m, k) = (float)syms[m,
// k] + pm[m, k], LoadSymsPlusPm's expression. cp.async copies bytes and
// cannot convert, so the int32 words of syms land raw in the A slab and pm
// in the extra slab; the rewrite converts them (round to nearest) and
// adds, one f32 addition. A zero-filled copy is int 0 and +0.f: (float)0 +
// 0.f == +0, the old core's padding.
struct SymsPmSrc {
    static constexpr bool REWRITE = true;
    static constexpr int EXTRA = 1;
    const int* s; const float* pm; int M, K;
    struct Row { int m; };
    struct Cursor { int k; };
    __device__ Row row(int m) const { return {m}; }
    __device__ Cursor cursor(int k) const { return {k}; }
    __device__ const float* src(const Row& r, const Cursor& c,
                                bool& ok) const {
        ok = r.m < M && c.k < K;
        return reinterpret_cast<const float*>(
            s + (ok ? (long long)r.m * K + c.k : 0));
    }
    __device__ const float* extra(const Row& r, const Cursor& c,
                                  bool& ok) const {
        ok = r.m < M && c.k < K;
        return ok ? pm + (long long)r.m * K + c.k : pm;
    }
    __device__ void advance(Cursor& c) const { c.k += PK; }
    __device__ void rewrite(float* a, const float* x) const {
        *a = (float)__float_as_int(*a) + *x;
    }
};

// A operand of conv_kxk_act: x[b, h+di-p, w+dj-p, ci] (0 off the image) at
// k = (di*K + dj)*Ci + ci, from the NHWC feature x (B, H, W, Ci)
struct ConvSrc {
    static constexpr bool REWRITE = false;
    static constexpr int EXTRA = 0;
    const float* x; int M, H, W, Ci, K, Ktot;
    struct Row { int m, h, w; };       // h out of range for m >= M
    struct Cursor { int k, ci, di, dj; };
    __device__ Row row(int m) const {  // the tile row's divisions, once
        if (m >= M) return {0, -(1 << 24), 0};
        const int t = m / W;
        return {m, t % H, m - t * W};
    }
    __device__ Cursor cursor(int k) const {
        const int tap = k / Ci, di = tap / K;
        return {k, k - tap * Ci, di, tap - di * K};
    }
    __device__ const float* src(const Row& r, const Cursor& c,
                                bool& ok) const {
        const int p = (K - 1) / 2;
        const int dh = c.di - p, dw = c.dj - p;
        ok = c.k < Ktot && (unsigned)(r.h + dh) < (unsigned)H
             && (unsigned)(r.w + dw) < (unsigned)W;
        return ok ? x + (long long)(r.m + dh * W + dw) * Ci + c.ci : x;
    }
    __device__ void advance(Cursor& c) const {
        c.k += PK;
        c.ci += PK;
        while (c.ci >= Ci) {           // at most PK / Ci + 1 taps a step
            c.ci -= Ci;
            if (++c.dj == K) { c.dj = 0; ++c.di; }
        }
    }
};

// z_proj_0's A operand with the integer junction folded in (zadd_conv_kxk):
// A(m, k) = (float)syms[b, h+di-p, w+dj-p, ci] + pm[the same], 0 off the
// image. ConvSrc's cursor and padding walk the int32 syms words (its x),
// which land raw in the A slab; pm's copy of the same element lands in the
// extra slab; the rewrite is zadd_kernel's expression. A zero-filled copy
// (off the image, the ragged edges) is int 0 and +0.f: (float)0 + 0.f ==
// +0, ConvSrc's padding, so the conv's outputs are bitwise those of zadd
// then conv_kxk_act(act=False).
struct ConvSymsPmSrc {
    static constexpr bool REWRITE = true;
    static constexpr int EXTRA = 1;
    ConvSrc conv; const float* pm;
    using Row = ConvSrc::Row;
    using Cursor = ConvSrc::Cursor;
    __device__ Row row(int m) const { return conv.row(m); }
    __device__ Cursor cursor(int k) const { return conv.cursor(k); }
    __device__ const float* src(const Row& r, const Cursor& c,
                                bool& ok) const {
        return conv.src(r, c, ok);
    }
    __device__ const float* extra(const Row& r, const Cursor& c,
                                  bool& ok) const {
        const float* s = conv.src(r, c, ok);
        return pm + (s - conv.x);      // conv.x itself where not ok
    }
    __device__ void advance(Cursor& c) const { conv.advance(c); }
    __device__ void rewrite(float* a, const float* x) const {
        *a = (float)__float_as_int(*a) + *x;
    }
};

// The block's dynamic shared memory (tiled_kernel's ring), for the epilogue
__device__ __forceinline__ float* dyn_smem() {
    extern __shared__ __align__(16) float smem[];
    return smem;
}

// #(tb[i] < pv) over a table of S entries, in four independent integer
// counts (an integer count is the same in any order: the table need not be
// sorted); S_ > 0 unrolls a compile-time size
template <int S_>
__device__ __forceinline__ int count_below(const float* tb, int S, float pv) {
    const int n = S_ > 0 ? S_ : S;
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0, i = 0;
#pragma unroll
    for (; i + 4 <= n; i += 4) {
        c0 += tb[i] < pv;
        c1 += tb[i + 1] < pv;
        c2 += tb[i + 2] < pv;
        c3 += tb[i + 3] < pv;
    }
    for (; i < n; ++i) c0 += tb[i] < pv;
    return (c0 + c1) + (c2 + c3);
}

// prior_head's epilogue on the tiled core: StorePrior's outputs, bit for
// bit (the same float operations under -fmad=false, the same count), with
// the table staged once a block into the ring's shared memory (a
// broadcast read for every lane) where it holds at most PRIOR_TABLE_SMEM
// entries, else counted from global memory; the codecs' 64-entry table
// (default_gaussian_scale_table) counts fully unrolled.
constexpr int PRIOR_TABLE_SMEM = 2048;  // <= the smallest tile's ring (2,400)
constexpr int CODEC_TABLE = 64;
struct StorePriorStaged {
    float* pm; int* idx; const float* b; const float* table; int S; int Z;
    static constexpr int SMEM_FLOATS = PRIOR_TABLE_SMEM;
    __device__ void prepare(int tid, int threads) const {
        if (S > PRIOR_TABLE_SMEM) return;
        float* tb = dyn_smem();
        for (int i = tid; i < S; i += threads) tb[i] = __ldg(table + i);
    }
    __device__ void operator()(int m, int n, float acc) const {
        const float v = acc + b[n];
        if (n < Z) {
            pm[(long long)m * Z + n] = v;
            return;
        }
        const float pv = expf(softplus_ref(v + 2.3f) - 2.3f);
        const float* tb = dyn_smem();
        int count;
        if (S == CODEC_TABLE) {
            const float p = fmaxf(pv, tb[0]);
            count = count_below<CODEC_TABLE>(tb, S, p);
        } else if (S <= PRIOR_TABLE_SMEM) {
            const float p = fmaxf(pv, tb[0]);
            count = count_below<0>(tb, S, p);
        } else {
            const float p = fmaxf(pv, __ldg(table));
            count = count_below<0>(table, S, p);
        }
        idx[(long long)m * Z + (n - Z)] = min(count, S - 1);
    }
};

// whether a store functor has an epilogue prepare(tid, threads) step
template <class S, class = void>
struct HasPrepare { static constexpr bool value = false; };
template <class S>
struct HasPrepare<S, decltype(void(&S::prepare))> {
    static constexpr bool value = true;
};

// the staged tile's row stride, floats: a 16-byte multiple for BN % 4 == 0
__host__ __device__ constexpr int staged_ld(int bn) { return bn + 4; }

// The residual joins on the tiled core: StoreResidual's f + (acc + b)
// (fuse_zproj) or, BIAS_LAST, StoreResidualBias's (f + acc) + b
// (res_dense_act), bit for bit. The block's BM x BN tile of the feature is
// copied into shared memory beyond the ring (prefetch, its own cp.async
// group issued after the ring's first copies, so that it lands while the
// product runs); each thread then turns its outputs' feature values into
// the outputs in place, and the block writes the tile out as 16-byte row
// segments (write). vec: 16-byte copies and stores (N % 4 == 0, f and out
// 16-byte aligned), else 4-byte ones. Rows past M and columns past N are
// zero-filled and never written.
template <bool BIAS_LAST>
struct StoreResidualStaged {
    static constexpr bool STAGED = true, PREFETCH = true;
    float* out; const float* b; const float* f; int M, N; bool vec;
    template <int BM, int BN>
    __host__ __device__ static constexpr int staged_floats() {
        return BM * staged_ld(BN);
    }
    __device__ float operator()(float fv, float acc, int n) const {
        return BIAS_LAST ? (fv + acc) + b[n] : fv + (acc + b[n]);
    }
    template <int BM, int BN>
    __device__ void prefetch(float* tile, int m0, int n0, int tid,
                             int threads) const {
        if (vec) {
            constexpr int Q = BN / 4;
            for (int e = tid; e < BM * Q; e += threads) {
                const int r = e / Q, c = (e - r * Q) * 4;
                const bool ok = m0 + r < M && n0 + c < N;
                cp_async<4>(tile + r * staged_ld(BN) + c,
                            ok ? f + (long long)(m0 + r) * N + n0 + c : f, ok);
            }
        } else {
            for (int e = tid; e < BM * BN; e += threads) {
                const int r = e / BN, c = e - r * BN;
                const bool ok = m0 + r < M && n0 + c < N;
                cp_async<1>(tile + r * staged_ld(BN) + c,
                            ok ? f + (long long)(m0 + r) * N + n0 + c : f, ok);
            }
        }
    }
    template <int BM, int BN>
    __device__ void write(const float* tile, int m0, int n0, int tid,
                          int threads) const {
        if (vec) {
            constexpr int Q = BN / 4;
            for (int e = tid; e < BM * Q; e += threads) {
                const int r = e / Q, c = (e - r * Q) * 4;
                if (m0 + r < M && n0 + c < N)
                    *reinterpret_cast<float4*>(
                        out + (long long)(m0 + r) * N + n0 + c) =
                        *reinterpret_cast<const float4*>(
                            tile + r * staged_ld(BN) + c);
            }
        } else {
            for (int e = tid; e < BM * BN; e += threads) {
                const int r = e / BN, c = e - r * BN;
                if (m0 + r < M && n0 + c < N)
                    out[(long long)(m0 + r) * N + n0 + c] =
                        tile[r * staged_ld(BN) + c];
            }
        }
    }
};

// whether a store functor finishes its tile in shared memory beyond the
// ring and writes it out from there (STAGED: value(acc, n) or, PREFETCH,
// value(input, acc, n) into the tile, then write), and whether it copies a
// tile of its own input there first (PREFETCH: prefetch)
template <class S, class = void>
struct HasStaged { static constexpr bool value = false; };
template <class S>
struct HasStaged<S, decltype(void(S::STAGED))> {
    static constexpr bool value = S::STAGED;
};
template <class S, class = void>
struct HasPrefetch { static constexpr bool value = false; };
template <class S>
struct HasPrefetch<S, decltype(void(S::PREFETCH))> {
    static constexpr bool value = S::PREFETCH;
};

// clip(v, -1, 1) * 0.5 + 0.5: finish_kernel's expression (-fmad=false: the
// product and the sum round apart, as there)
__device__ __forceinline__ float finish_value(float v) {
    return fminf(fmaxf(v, -1.0f), 1.0f) * 0.5f + 0.5f;
}

// The 1x1 convs that end in a pixel shuffle, on the tiled core: column n =
// g*G + c*r*r + i*r + j of row m = (b*H + h)*W + w goes to out_g[b, h*r + i,
// w*r + j, c], G = 3*r*r columns a tensor (pixel_shuffle_nhwc's order:
// torch.nn.PixelShuffle's). FINISH: upsample_finish, one tensor (N = G) of
// float16 finish_value(acc + b[n]), each rounded once (__float2half_rn,
// torch's .to(float16)); else upsample_head, out_0 the mean's columns and
// out_1 the scale's (N = 2G), float32 acc + b[n] (StoreBias's value). The
// block finishes its BM x BN tile into shared memory beyond the ring (no
// prefetch: nothing is read but the bias), then writes it in output order:
// where the tile holds whole tensors' columns (BN % G == 0), for each of
// them and each i the tile's rows' 3r contiguous elements at w*r*3 of
// output row (b*H + h)*r + i, consecutive threads on consecutive
// addresses, so that the consecutive pixels of a grid row in the tile
// write one run; else element by element. Any B, H and W: a tile may
// straddle grid rows and images, since each row's output offset is taken
// from its own m (row_base, computed once a tile row).
template <bool FINISH>
struct StoreShuffleStaged {
    static constexpr bool STAGED = true;
    using T = typename std::conditional<FINISH, __half, float>::type;
    T* out0; T* out1; const float* b; int M, N, W, r;
    template <int BM, int BN>   // the tile, then BM row bases
    __host__ __device__ static constexpr int staged_floats() {
        return BM * staged_ld(BN) + 2 * BM;
    }
    __device__ float operator()(float acc, int n) const {
        const float v = acc + b[n];
        return FINISH ? finish_value(v) : v;
    }
    __device__ static T convert(float v) {
        if constexpr (FINISH) return __float2half_rn(v);
        else return v;
    }
    template <int BM, int BN>
    __device__ void write(const float* tile, int m0, int n0, int tid,
                          int threads) const {
        static_assert((BM * staged_ld(BN)) % 2 == 0, "8-byte row bases");
        long long* row_base = reinterpret_cast<long long*>(
            const_cast<float*>(tile) + BM * staged_ld(BN));
        const int G = 3 * r * r, L = 3 * r;
        const long long stride = (long long)L * W;    // an output row
        for (int rl = tid; rl < BM; rl += threads) {
            const int m = m0 + rl, t = m / W;         // t = b*H + h
            row_base[rl] = (long long)t * r * stride + (long long)(m - t * W)
                                                       * L;
        }
        __syncthreads();
        if (BN % G == 0) {                   // whole tensors: output order
            for (int gl = 0; gl < BN / G; ++gl) {
                const int g = n0 / G + gl;
                if (g * G >= N) break;
                T* out = g == 0 ? out0 : out1;
                const float* col = tile + gl * G;
                for (int i = 0; i < r; ++i) {
                    for (int e = tid; e < BM * L; e += threads) {
                        const int rl = e / L, q = e - rl * L;
                        if (m0 + rl >= M) break;     // rows past M: the end
                        const int j = q / 3, c = q - j * 3;
                        out[row_base[rl] + i * stride + q] = convert(
                            col[rl * staged_ld(BN) + c * r * r + i * r + j]);
                    }
                }
            }
        } else {                             // element by element
            for (int e = tid; e < BM * BN; e += threads) {
                const int rl = e / BN, cl = e - rl * BN, n = n0 + cl;
                if (m0 + rl >= M) break;
                if (n >= N) continue;
                const int g = n / G, nn = n - g * G, c = nn / (r * r),
                          ij = nn - c * r * r, i = ij / r, j = ij - i * r;
                (g == 0 ? out0 : out1)[row_base[rl] + i * stride + j * 3 + c] =
                    convert(tile[rl * staged_ld(BN) + cl]);
            }
        }
    }
};

// A tile shape: BM x BN outputs a block, TM x TN a thread; MINB blocks an
// SM asked of the register allocator; STREAM_B loads one column's k-quad at
// a time (a smaller live set) instead of all TN; TAIL runs only the k-quads
// of the last K step that hold a k < K. A skipped quad would add fmaf(0, 0,
// acc) four times, which returns acc bit for bit: a chain from +0 is never
// -0 (an exact zero rounds to +0), inf stays inf, and a NaN acc is already
// the canonical NaN the card's arithmetic returns.
template <int BM_, int BN_, int TM_, int TN_, int MINB_ = 1,
          bool STREAM_B_ = false, bool TAIL_ = false>
struct Tile {
    static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
    static constexpr int MINB = MINB_;
    static constexpr bool STREAM_B = STREAM_B_, TAIL = TAIL_;
    static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
    // floats a ring stage holds: A, W, then the source's extra slabs
    template <class ASrc>
    __host__ __device__ static constexpr int stage() {
        return ((1 + ASrc::EXTRA) * BM + BN) * PLD;
    }
    // dynamic shared memory, bytes: the ring, then a staged store's tile
    template <class ASrc, class Store>
    __host__ __device__ static constexpr int smem() {
        int floats = STAGES * stage<ASrc>();
        if constexpr (HasStaged<Store>::value)
            floats += Store::template staged_floats<BM, BN>();
        return floats * (int)sizeof(float);
    }
};

template <class T, int V, class ASrc, class Store>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
tiled_kernel(int M, int N, int K, ASrc asrc, const float* __restrict__ w,
             Store store) {
    constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN;
    constexpr int TX = T::TX, TY = T::TY, THREADS = T::THREADS;
    constexpr int CPR = PK / V;                  // copies a row and step
    constexpr int RPP = THREADS / CPR;           // rows a pass
    constexpr int A_PASSES = (BM + RPP - 1) / RPP;
    constexpr int W_PASSES = (BN + RPP - 1) / RPP;
    constexpr int STAGE = T::template stage<ASrc>();   // floats
    static_assert(THREADS % CPR == 0 && TM * TY == BM && TN * TX == BN, "");
    extern __shared__ __align__(16) float smem[];

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    // this thread's copies: rows r0 + i * RPP, k offset kc within a step
    const int r0 = tid / CPR, kc = (tid % CPR) * V;
    typename ASrc::Row arow[A_PASSES];
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) arow[i] = asrc.row(m0 + r0 + i * RPP);
    typename ASrc::Cursor cur = asrc.cursor(kc);
    int kw = kc;

    auto load = [&](int slot) {        // the cursor's step into slot
        float* As = smem + slot * STAGE;
        float* Ws = As + BM * PLD;
#pragma unroll
        for (int i = 0; i < A_PASSES; ++i) {
            const int r = r0 + i * RPP;
            if (BM % RPP == 0 || r < BM) {
                bool ok;
                const float* s = asrc.src(arow[i], cur, ok);
                cp_async<V>(As + r * PLD + kc, s, ok);
                if constexpr (ASrc::EXTRA > 0) {   // the extra slab, after W
                    s = asrc.extra(arow[i], cur, ok);
                    cp_async<V>(Ws + (BN + r) * PLD + kc, s, ok);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < W_PASSES; ++i) {
            const int r = r0 + i * RPP;
            if (BN % RPP == 0 || r < BN) {
                const bool ok = n0 + r < N && kw < K;
                cp_async<V>(Ws + r * PLD + kc,
                            ok ? w + (long long)(n0 + r) * K + kw : w, ok);
            }
        }
        asrc.advance(cur);
        kw += PK;
    };

    const int nk = (K + PK - 1) / PK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load(s);
        cp_async_commit();
    }
    // a staged store's input tile: one more group, in flight beside the
    // ring's, waited for after the K loop
    constexpr bool PREFETCH = HasPrefetch<Store>::value;
    if constexpr (PREFETCH) {
        store.template prefetch<BM, BN>(smem + STAGES * STAGE, m0, n0, tid,
                                        THREADS);
        cp_async_commit();
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
        // step kt's copies have landed (the groups committed after step
        // kt's: the later ring steps, and the staged tile's while kt <
        // STAGES - 1)
        if constexpr (PREFETCH) {
            if (kt < STAGES - 1) cp_async_wait<STAGES - 1>();
            else cp_async_wait<STAGES - 2>();
        } else {
            cp_async_wait<STAGES - 2>();
        }
        if constexpr (ASrc::REWRITE) { // this thread's own A copies of it
            float* As = smem + (kt % STAGES) * STAGE;
            const float* Xs = As + (BM + BN) * PLD;
#pragma unroll
            for (int i = 0; i < A_PASSES; ++i) {
                const int r = r0 + i * RPP;
                if (BM % RPP == 0 || r < BM) {
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        asrc.rewrite(As + r * PLD + kc + v,
                                     Xs + r * PLD + kc + v);
                }
            }
        }
        __syncthreads();               // ... for every thread, and step
                                       // kt - 1's slot is free
        if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES);
        cp_async_commit();
        const float* As = smem + (kt % STAGES) * STAGE;
        const float* Ws = As + BM * PLD;
#pragma unroll
        for (int kq = 0; kq < PK; kq += 4) {
            if constexpr (T::TAIL) {
                if (kq >= K - kt * PK) break;
            }
            // k = kq, kq + 1, kq + 2, kq + 3 in turn: each chain in order
            float4 a[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                a[i] = *reinterpret_cast<const float4*>(
                    As + (ty + i * TY) * PLD + kq);
            if constexpr (T::STREAM_B) {
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    const float4 b = *reinterpret_cast<const float4*>(
                        Ws + (tx + j * TX) * PLD + kq);
#pragma unroll
                    for (int i = 0; i < TM; ++i)
                        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
#pragma unroll
                    for (int i = 0; i < TM; ++i)
                        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
#pragma unroll
                    for (int i = 0; i < TM; ++i)
                        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
#pragma unroll
                    for (int i = 0; i < TM; ++i)
                        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
                }
            } else {
                float4 b[TN];
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    b[j] = *reinterpret_cast<const float4*>(
                        Ws + (tx + j * TX) * PLD + kq);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
            }
        }
    }
    cp_async_wait<0>();                // no copy outlives the block
    if constexpr (HasStaged<Store>::value) {
        float* staged = smem + STAGES * STAGE;
        // every thread's tile copies landed (without a prefetch, the tile
        // lies beyond the ring, which no thread reads any more from here)
        if constexpr (PREFETCH) __syncthreads();
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int r = ty + i * TY;
            if (m0 + r >= M) continue;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = tx + j * TX;
                float* p = staged + r * staged_ld(BN) + c;
                if (n0 + c < N) {
                    if constexpr (PREFETCH) *p = store(*p, acc[i][j], n0 + c);
                    else *p = store(acc[i][j], n0 + c);
                }
            }
        }
        __syncthreads();
        store.template write<BM, BN>(staged, m0, n0, tid, THREADS);
    } else {
        if constexpr (HasPrepare<Store>::value) {
            static_assert(STAGES * STAGE >= Store::SMEM_FLOATS, "");
            __syncthreads();           // every thread is past the ring
            store.prepare(tid, THREADS);
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int gm = m0 + ty + i * TY;
            if (gm >= M) continue;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int gn = n0 + tx + j * TX;
                if (gn < N) store(gm, gn, acc[i][j]);
            }
        }
    }
}

template <class T, int V, class ASrc, class Store>
cudaError_t launch_tiled(int M, int N, int K, ASrc a, const float* w,
                         Store store, cudaStream_t stream) {
    constexpr int SMEM = T::template smem<ASrc, Store>();
    if (SMEM > 48 * 1024) {            // opt in above 48 KB, once a device
        static bool opted[64];
        int dev;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev >= 64) return cudaErrorInvalidDevice;
        if (!opted[dev]) {
            err = cudaFuncSetAttribute(
                tiled_kernel<T, V, ASrc, Store>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
            if (err != cudaSuccess) return err;
            opted[dev] = true;
        }
    }
    const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
    if (grid.y > 65535u) return cudaErrorInvalidValue;
    tiled_kernel<T, V, ASrc, Store><<<grid, T::THREADS, SMEM, stream>>>(
        M, N, K, a, w, store);
    return cudaGetLastError();
}

// the current device's SM count, which the dispatchers pick tiles by
cudaError_t sm_count(int* sms) {
    int dev;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Tile shape from (M, N), fitted to the trunk's shapes on the H100 (the
// per-shape times in PERF.md). BN divides N where the trunk's widths
// allow (64 for the wide 1x1 convs, 48 or 24 for the 96-, 48- and
// 24-channel convs; else 32 with a ragged last tile). The outputs an SM
// holds (M*N / SMs) set the block's size: below ~6k small blocks fill the
// card, above ~16k the largest tiles, whose 6x8 threads read shared memory
// least per FMA; 96x128 only where its 256-thread blocks make two whole
// waves. Where 32x64 tiles would leave more than half the SMs idle, 16x32
// tiles of 2x2 a thread. 4-byte copies (V = 1, unaligned rows) take the
// small tiles.
template <int V, class ASrc, class Store>
cudaError_t dispatch_tiled(int M, int N, int K, ASrc a, const float* w,
                           Store st, cudaStream_t s) {
    if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
    int sms;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const double per_sm = (double)M * N / sms;
#define TILE(...) \
    return launch_tiled<Tile<__VA_ARGS__>, V>(M, N, K, a, w, st, s)
    if (N % 64 == 0) {
        if constexpr (V == 4) {
            // a narrow product with a deep chain (mlp_res's fc2 at 96 rows)
            if (2LL * ((M + 31) / 32) * (N / 64) < sms) TILE(16, 32, 2, 2);
        }
        if (per_sm <= 6000 || V == 1) {
            if (V == 4 && N % 48 == 0 && per_sm >= 3000) TILE(32, 48, 4, 6);
            TILE(32, 64, 4, 4);
        }
        if constexpr (V == 4) {
            if (per_sm <= 16000) TILE(64, 64, 4, 8);
            const long long b128 = (long long)((M + 95) / 96) * (N / 128);
            if (N % 128 == 0 && b128 <= 2 * sms && 4 * b128 >= 7 * sms)
                TILE(96, 128, 6, 8, 2, true);
            TILE(96, 64, 6, 8);
        }
    }
    if (N % 24 == 0) {
        if (per_sm <= 2000) TILE(16, 24, 2, 6);
        if (N % 48 == 0) {
            if (per_sm <= 8000 || V == 1) TILE(32, 48, 4, 6);
            if constexpr (V == 4) TILE(64, 48, 4, 6);
        }
        if constexpr (V == 4) TILE(64, 24, 4, 6);
        TILE(16, 24, 2, 6);
    }
    TILE(32, 32, 4, 4);
#undef TILE
}

// prior_head's tiles, fitted on the card at its main-path shapes (PERF.md
// PR 13): 2x2 or 2x3 outputs a thread, so that the index epilogue (~200
// operations an index output, expf, logf and the 64-entry count) spreads
// over 128-256 threads a block; 16x32 while the outputs an SM holds stay
// under ~3k, then 32x48 where N divides (qarv_base's 1536 x 384 -> 384
// head: 6 index outputs a thread where dispatch_tiled's 32x48 tile gave 24)
// and 32x32.
template <int V, class ASrc>
cudaError_t dispatch_prior(int M, int N, int K, ASrc a, const float* w,
                           StorePriorStaged st, cudaStream_t s) {
    if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
    int sms;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const double per_sm = (double)M * N / sms;
    if (per_sm <= 3000)
        return launch_tiled<Tile<16, 32, 2, 2>, V>(M, N, K, a, w, st, s);
    if (N % 48 == 0)
        return launch_tiled<Tile<32, 48, 2, 3>, V>(M, N, K, a, w, st, s);
    return launch_tiled<Tile<32, 32, 2, 2>, V>(M, N, K, a, w, st, s);
}

// The residual joins' tiles (StoreResidualStaged: fuse_zproj,
// res_dense_act), fitted on the card at their main-path shapes (PERF.md,
// the residual joins). K is a latent width or z_proj_0's (8-96: 1-6 K
// steps) and the feature is read and written once, so the number of
// blocks and the bytes each has in flight decide, not the FMAs an operand
// load feeds. By the outputs an SM
// holds: 16x32 tiles of 2x2 a thread up to ~1.6k (96-384 rows: 72-96
// blocks), 32x64 of 4x4 up to ~10k (1536 rows), else 64x64 of 4x4 with 256
// threads a block; a deeper ring (4 or 6 steps) was no faster. The tiles
// run the last K step's k-quads only up to K (TAIL: K = 8 and 24 on the
// main path left half or a third of their FMAs to padding). 4-byte copies
// take one tile.
template <int V, class ASrc, class Store>
cudaError_t dispatch_junction(int M, int N, int K, ASrc a, const float* w,
                              Store st, cudaStream_t s) {
    if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
    int sms;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const double per_sm = (double)M * N / sms;
#define TILE(...) \
    return launch_tiled<Tile<__VA_ARGS__>, V>(M, N, K, a, w, st, s)
    if constexpr (V == 4) {
        if (per_sm <= 1600) TILE(16, 32, 2, 2, 1, false, true);
        if (per_sm <= 10000) TILE(32, 64, 4, 4, 1, false, true);
        TILE(64, 64, 4, 4, 1, false, true);
    }
    TILE(32, 32, 2, 2, 1, false, true);
#undef TILE
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// x (M, K) rows through Src (DenseSrc or GeluRowSrc) @ wt (N, K) on the
// tiled core: 16-byte copies where K and both pointers allow, else 4-byte
template <class Src, class Store>
cudaError_t dispatch_rows(const float* x, int M, int N, int K,
                          const float* wt, Store st, cudaStream_t s) {
    const Src src{x, M, K};
    const bool v4 = K % 4 == 0 && aligned16(x) && aligned16(wt);
    if constexpr (HasPrefetch<Store>::value)
        return v4 ? dispatch_junction<4>(M, N, K, src, wt, st, s)
                  : dispatch_junction<1>(M, N, K, src, wt, st, s);
    else if constexpr (HasPrepare<Store>::value)
        return v4 ? dispatch_prior<4>(M, N, K, src, wt, st, s)
                  : dispatch_prior<1>(M, N, K, src, wt, st, s);
    else
        return v4 ? dispatch_tiled<4>(M, N, K, src, wt, st, s)
                  : dispatch_tiled<1>(M, N, K, src, wt, st, s);
}

// The shuffled stores' tiles (upsample_finish, upsample_head), at N % 48
// == 0 (the tail's and the head's widths, N = 48 and 96 at rate 4) 48
// columns wide, so that a tile holds whole tensors' columns and writes in
// output order: by the outputs an SM holds, 96x48 tiles of 6x6 a thread
// above ~16k (the head at photo1's 24,576 rows: 35 us, against 42 on
// 64x48 tiles; the B = 6 tails), 64x48 of 4x6 above ~8k (the tails: 17 us
// at qarv_base's, no other tile tried faster by more than 2 %), else
// 32x48 (scripts/probe-upsample-tiles.py; PERF.md PR 17). 16x24 at any other N
// (rates 1 and 2: G = 3 and 12 divide 24; any other rate element by
// element). Instantiated for these stores alone: six tiles each.
template <int V, class Store>
cudaError_t dispatch_shuffle(int M, int N, int K, DenseSrc a, const float* w,
                             Store st, cudaStream_t s) {
    if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
    int sms;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const double per_sm = (double)M * N / sms;
#define TILE(...) \
    return launch_tiled<Tile<__VA_ARGS__>, V>(M, N, K, a, w, st, s)
    if (N % 48 == 0) {
        if constexpr (V == 4) {
            if (per_sm > 16000) TILE(96, 48, 6, 6);
            if (per_sm > 8000) TILE(64, 48, 4, 6);
        }
        TILE(32, 48, 4, 6);
    }
    TILE(16, 24, 2, 6);
#undef TILE
}

template <class Store>
cudaError_t dispatch_shuffle_rows(const float* x, int M, int N, int K,
                                  const float* wt, Store st, cudaStream_t s) {
    const DenseSrc src{x, M, K};
    return K % 4 == 0 && aligned16(x) && aligned16(wt)
               ? dispatch_shuffle<4>(M, N, K, src, wt, st, s)
               : dispatch_shuffle<1>(M, N, K, src, wt, st, s);
}

// gelu_as once per element: conv_kxk_act's pre-pass (bitwise the value its
// loader used to compute per tap; gelu_as(+0) == +0 equals an off-image tap)
// (16-byte accesses, n4 = n / 4 quads; the caller checks the alignment)
__global__ void gelu_kernel(const float4* __restrict__ x, long long n4,
                            float4* __restrict__ out) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < n4; e += (long long)gridDim.x * blockDim.x) {
        const float4 v = x[e];
        out[e] = make_float4(gelu_as(v.x), gelu_as(v.y), gelu_as(v.z),
                             gelu_as(v.w));
    }
}
__global__ void gelu1_kernel(const float* __restrict__ x, long long n,
                             float* __restrict__ out) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += (long long)gridDim.x * blockDim.x)
        out[e] = gelu_as(x[e]);
}

// ---------------------------------------------------------------------------
// emb_mlp. Replaces lvae_tpu/ops/pallas/trunk.py:122 emb_mlp: log-lambda
// sinusoid -> Linear -> GELU -> Linear, then gelu(emb), each output of the
// two products one warp_dot. Bound: bytes (two 256x256 weight reads, 0.5
// MB: 0.16 us on the card), but a function that runs once an image is
// latency: what counts is how many dependent trips to device memory it
// makes, on how many SMs.
// Two kernels compute it with the same arithmetic, so the same bits:
// - emb_mlp_cluster_kernel, the one the wrapper launches: one thread-block
//   cluster (EMB_CLUSTER = 16 CTAs, the largest, non-portable size) for the
//   whole batch, 16 warps a CTA. CTA r owns outputs
//   [r*E/CL, (r+1)*E/CL) of both products and copies its rows of both
//   weights into shared memory at entry (cp.async, two groups), so both
//   products' weight traffic is in flight at once on CL SMs, while every
//   CTA computes the sinusoid of all rows itself. Each warp runs its
//   outputs' chains for up to EMB_ROWS batch rows at once, each weight
//   read once from shared memory for all of them. The first product's
//   slices go to every CTA's shared memory through distributed shared
//   memory (lane p stores into CTA p), a cluster barrier, the second
//   product, and a second barrier before the next chunk of rows (or the
//   exit). A split cluster barrier (arrive at entry, wait before the first
//   product) keeps every store into a peer from coming before that peer
//   has started. Where a CTA's weight rows do not fit in shared memory beside
//   one row of x and h, they are read from device memory instead; where
//   the batch's x and h do not fit beside the weights, the rows run in
//   chunks. On an H100 (PERF.md row 5; chip_smoke.py's emb_zadd line) a
//   launch at qarv_base's widths takes 7.8 us at B = 1 and 10.8 at B = 6
//   with 16 CTAs, 10.2 / 13.8 with 8. The time is a chain of latencies:
//   the cluster launch, the weight copies, in each product one output's
//   chain of dependent shared loads, shuffle tree and GELU a warp, and
//   the two cluster barriers.
// - emb_mlp_kernel, one 512-thread block per batch row reading the weight
//   rows from device memory, one dependent trip an output (0.066 ms a
//   qarv_base image on an H100, PERF.md): the cluster kernel's bitwise
//   oracle (trunk_emb_mlp_oneblock), off the main path.
// ---------------------------------------------------------------------------

constexpr int EMB_THREADS = 512;
constexpr int EMB_CLUSTER_THREADS = 512;
constexpr int EMB_ROWS = 8;      // batch rows a warp's chains run at once
// CTAs of the cluster: 16 ran ~25 % faster than the portable 8 on an H100
// (PERF.md row 5; trunk_emb_mlp_cluster8 is the 8-CTA yardstick)
constexpr int EMB_CLUSTER = 16;

// first output of CTA r's slice of E outputs, in a cluster of CL
__host__ __device__ __forceinline__ int emb_slice(int r, int E, int CL) {
    return (int)((long long)r * E / CL);
}

// warp_dot of up to R rows of x (row stride ldx, nr of them) with one
// weight row: lane l runs each row's chain k = l, l + 32, ... in order, the
// weight element read once for every row, then warp_sum; each sum has
// warp_dot's bits
template <int R>
__device__ __forceinline__ void rows_dot(const float* x, int ldx, int nr,
                                         const float* w, int K, int lane,
                                         float (&acc)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int k = lane; k < K; k += 32) {
        const float wk = w[k];
#pragma unroll
        for (int i = 0; i < R; ++i)
            if (i < nr) acc[i] = fmaf(x[i * ldx + k], wk, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = warp_sum(acc[i]);
}

// n floats from src into shared dst by cp.async, V floats a copy
template <int V>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int n, int tid, int threads) {
    for (int e = tid * V; e < n; e += threads * V)
        cp_async<V>(dst + e, src + e, true);
}

__global__ void __launch_bounds__(EMB_CLUSTER_THREADS)
emb_mlp_cluster_kernel(const float* __restrict__ lmb, int B,
                       const float* __restrict__ freqs,
                       const float* __restrict__ w0t,
                       const float* __restrict__ b0,
                       const float* __restrict__ w1t,
                       const float* __restrict__ b1, int E0, int E,
                       float scale, int chunk, int staged, int vec,
                       float* __restrict__ emb, float* __restrict__ gemb) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int CL = (int)cluster.num_blocks();
    const int lo = emb_slice((int)cluster.block_rank(), E, CL);
    const int rows = emb_slice((int)cluster.block_rank() + 1, E, CL) - lo;
    const int rows_max = (E + CL - 1) / CL;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int nwarps = blockDim.x / 32, half = E0 / 2;
    // shared: [w0 rows_max x E0][w1 rows_max x E] where staged, then the
    // chunk's x (chunk x E0) and h (chunk x E)
    extern __shared__ __align__(16) float sm[];
    float* x = sm + (staged ? (long long)rows_max * (E0 + E) : 0);
    float* h = x + (long long)chunk * E0;
    const float* w0 = w0t + (long long)lo * E0;   // this CTA's rows
    const float* w1 = w1t + (long long)lo * E;
    if (staged) {
        float* w1s = sm + (long long)rows_max * E0;
        if (vec) copy_rows<4>(sm, w0, rows * E0, tid, blockDim.x);
        else copy_rows<1>(sm, w0, rows * E0, tid, blockDim.x);
        cp_async_commit();
        if (vec) copy_rows<4>(w1s, w1, rows * E, tid, blockDim.x);
        else copy_rows<1>(w1s, w1, rows * E, tid, blockDim.x);
        cp_async_commit();
        w0 = sm;
        w1 = w1s;
    }
    // no CTA stores into a peer's shared memory before every CTA of the
    // cluster has started: arrive here, wait before the first product
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    for (int c0 = 0; c0 < B; c0 += chunk) {
        const int nb = min(chunk, B - c0);
        // the sinusoid of the chunk's rows: emb_mlp_kernel's expressions
        for (int e = tid; e < nb * half; e += blockDim.x) {
            const int b = e / half, j = e - b * half;
            const float scaled = logf(lmb[c0 + b]) * scale;
            const float arg = scaled * freqs[j];
            x[b * E0 + j] = cosf(arg);
            x[b * E0 + half + j] = sinf(arg);
        }
        if (staged && c0 == 0) cp_async_wait<1>();     // w0's rows
        __syncthreads();
        if (c0 == 0)                 // every CTA of the cluster has started
            asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
        // h = gelu(x @ w0 + b0) on this CTA's outputs, into every CTA
        for (int n = warp; n < rows; n += nwarps) {
            const float bias = b0[lo + n];
            for (int g = 0; g < nb; g += EMB_ROWS) {
                float acc[EMB_ROWS];
                rows_dot<EMB_ROWS>(x + g * E0, E0, nb - g, w0 + n * E0, E0,
                                   lane, acc);
#pragma unroll
                for (int i = 0; i < EMB_ROWS; ++i) {
                    if (g + i >= nb) break;
                    const float v = gelu_as(acc[i] + bias);
                    if (lane < CL)
                        cluster.map_shared_rank(h, lane)[(g + i) * E + lo + n]
                            = v;
                }
            }
        }
        if (staged && c0 == 0) {
            cp_async_wait<0>();                         // w1's rows
            __syncthreads();
        }
        cluster.sync();              // every slice of h is in every CTA
        for (int n = warp; n < rows; n += nwarps) {
            const float bias = b1[lo + n];
            for (int g = 0; g < nb; g += EMB_ROWS) {
                float acc[EMB_ROWS];
                rows_dot<EMB_ROWS>(h + g * E, E, nb - g, w1 + n * E, E, lane,
                                   acc);
                if (lane == 0) {
#pragma unroll
                    for (int i = 0; i < EMB_ROWS; ++i) {
                        if (g + i >= nb) break;
                        const float e = acc[i] + bias;
                        const long long o = (long long)(c0 + g + i) * E + lo + n;
                        emb[o] = e;
                        gemb[o] = gelu_as(e);
                    }
                }
            }
        }
        // no CTA rewrites a peer's h (next chunk) or exits while a peer
        // may still read its own
        cluster.sync();
    }
}

__global__ void __launch_bounds__(EMB_THREADS)
emb_mlp_kernel(const float* __restrict__ lmb, const float* __restrict__ freqs,
               const float* __restrict__ w0t, const float* __restrict__ b0,
               const float* __restrict__ w1t, const float* __restrict__ b1,
               int E0, int E, float scale, float* __restrict__ emb,
               float* __restrict__ gemb) {
    extern __shared__ float sm[];
    float* x = sm;           // E0
    float* h = sm + E0;      // E
    const int b = blockIdx.x;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int nwarps = blockDim.x / 32;
    const int half = E0 / 2;
    const float scaled = logf(lmb[b]) * scale;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const float arg = scaled * freqs[j];
        x[j] = cosf(arg);
        x[half + j] = sinf(arg);
    }
    __syncthreads();
    for (int n = warp; n < E; n += nwarps) {
        const float acc = warp_dot(x, w0t + (long long)n * E0, E0, lane);
        if (lane == 0) h[n] = gelu_as(acc + b0[n]);
    }
    __syncthreads();
    for (int n = warp; n < E; n += nwarps) {
        const float acc = warp_dot(h, w1t + (long long)n * E, E, lane);
        if (lane == 0) {
            const float e = acc + b1[n];
            emb[(long long)b * E + n] = e;
            gemb[(long long)b * E + n] = gelu_as(e);
        }
    }
}

// ---------------------------------------------------------------------------
// dw_ln_mod and dw_ln_affine. Replace lvae_tpu/ops/pallas/trunk.py:166
// dw_ln_mod and :462 dw_ln_affine (the plain ConvNeXt block's LayerNorm,
// whose affine scale and bias take the place of the AdaLN modulation).
// Phase 1 (dw_ln_mod only; small kernel, once per launch): the AdaLN
// modulation gemb @ ew + eb for each batch row, a warp per output
// (warp_dot), and the depthwise weights turned tap-major (K*K, C) so that
// phase 2 reads them coalesced (dw_ln_affine's caller passes them so).
// Phase 2: the K x K stencil with the 'same' zero padding done by skipping
// out-of-image taps (no padded copy, no window stack): each output starts
// from its bias and adds its taps in (di, dj) row-major order, a multiply
// and an add each; then LayerNorm over C with a fixed reduction order (lane
// l sums channels l, l+32, ... in order, then a xor-shuffle tree, which
// leaves every lane with the same bits), then y * (1 + scale) + shift
// (dw_ln_mod) or y * scale + bias (dw_ln_affine: no phase-1 modulation).
// Two kernels compute phase 2 with the same arithmetic, so the same bits:
// - dw_tile_kernel, the one the wrappers launch (below);
// - dw_ln_kernel, one warp per pixel reading its K*K neighbours straight
//   from global memory, which re-reads each input K*K times from L1/L2; it
//   is kept as the tile kernel's bitwise oracle (the _warp entry points).
// Bound: bytes at K <= 5 (one read of x, one write), operations at K = 7
// (2*49 flops per element).
// ---------------------------------------------------------------------------

__global__ void dw_prep_kernel(const float* __restrict__ gemb,
                               const float* __restrict__ ewt,
                               const float* __restrict__ eb, int B, int C,
                               int E, const float* __restrict__ dwk, int KK,
                               float* __restrict__ mod,
                               float* __restrict__ dwk_t) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < (long long)KK * C) {               // t = tap * C + c
        const int tap = (int)(t / C), c = (int)(t % C);
        dwk_t[t] = dwk[(long long)c * KK + tap];
    }
    const long long o = t / 32;                // one warp per output (b, j)
    if (o < (long long)B * 2 * C) {
        const int b = (int)(o / (2 * C)), j = (int)(o % (2 * C));
        const float acc = warp_dot(gemb + (long long)b * E,
                                   ewt + (long long)j * E, E, threadIdx.x % 32);
        if (threadIdx.x % 32 == 0) mod[o] = acc + eb[j];
    }
}

// what follows the LayerNorm: the AdaLN modulation of the batch row
// (dw_ln_mod), or the LayerNorm's own affine (dw_ln_affine); params(b, c)
// reads a channel's two numbers, so that a kernel can load them early
struct NormAdaLN {
    const float* mod; int C;     // (B, 2C): shift, then scale
    __device__ float2 params(int b, int c) const {
        const float* shift = mod + (long long)b * 2 * C;
        return make_float2(shift[C + c], shift[c]);
    }
    __device__ float apply(float y, float2 p) const {
        return y * (1.0f + p.x) + p.y;
    }
    __device__ float operator()(int b, int c, float y) const {
        return apply(y, params(b, c));
    }
};
struct NormAffine {
    const float* scale; const float* bias;
    __device__ float2 params(int, int c) const {
        return make_float2(__ldg(scale + c), __ldg(bias + c));
    }
    __device__ float apply(float y, float2 p) const { return y * p.x + p.y; }
    __device__ float operator()(int b, int c, float y) const {
        return apply(y, params(b, c));
    }
};

template <int CPL, class Norm>
__global__ void __launch_bounds__(256)
dw_ln_kernel(const float* __restrict__ x, int B, int H, int W, int C, int K,
             const float* __restrict__ dwk_t, const float* __restrict__ dwb,
             Norm norm, float* __restrict__ out) {
    const long long pix = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (pix >= (long long)B * H * W) return;     // whole warps exit together
    const int b = (int)(pix / ((long long)H * W));
    const int hw = (int)(pix % ((long long)H * W));
    const int h = hw / W, w = hw % W;
    const int p = (K - 1) / 2;
    float y[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        y[i] = c < C ? __ldg(dwb + c) : 0.f;
    }
    for (int di = 0; di < K; ++di) {
        const int hh = h + di - p;
        if (hh < 0 || hh >= H) continue;
        for (int dj = 0; dj < K; ++dj) {
            const int ww = w + dj - p;
            if (ww < 0 || ww >= W) continue;
            const float* xr = x + (((long long)b * H + hh) * W + ww) * C;
            const float* kr = dwk_t + (long long)(di * K + dj) * C;
#pragma unroll
            for (int i = 0; i < CPL; ++i) {
                const int c = lane + 32 * i;
                if (c < C) y[i] = y[i] + __ldg(xr + c) * __ldg(kr + c);
            }
        }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
        if (lane + 32 * i < C) s += y[i];
    const float mu = warp_sum(s) / (float)C;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        if (lane + 32 * i < C) {
            const float d = y[i] - mu;
            v += d * d;
        }
    }
    const float var = warp_sum(v) / (float)C;
    const float rstd = 1.0f / sqrtf(var + 1e-6f);
    float* o = out + pix * C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < C) o[c] = norm(b, c, (y[i] - mu) * rstd);
    }
}

template <int CPL, class Norm>
cudaError_t launch_dw(const float* x, int B, int H, int W, int C, int K,
                      const float* dwk_t, const float* dwb, Norm norm,
                      float* out, cudaStream_t stream) {
    const long long threads = (long long)B * H * W * 32;
    const long long blocks = (threads + 255) / 256;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    dw_ln_kernel<CPL, Norm><<<(unsigned)blocks, 256, 0, stream>>>(
        x, B, H, W, C, K, dwk_t, dwb, norm, out);
    return cudaGetLastError();
}

// one warp per pixel holds C <= 512 channels, CPL = ceil(C / 32) a lane
template <class Norm>
cudaError_t dispatch_dw_warp(const float* x, int B, int H, int W, int C,
                             int K, const float* dwk_t, const float* dwb,
                             Norm norm, float* out, cudaStream_t st) {
    switch ((C + 31) / 32) {
#define DW_CASE(n) \
        case n: return launch_dw<n>(x, B, H, W, C, K, dwk_t, dwb, norm, out, st);
        DW_CASE(1) DW_CASE(2) DW_CASE(3) DW_CASE(4) DW_CASE(5) DW_CASE(6)
        DW_CASE(7) DW_CASE(8) DW_CASE(9) DW_CASE(10) DW_CASE(11) DW_CASE(12)
        DW_CASE(13) DW_CASE(14) DW_CASE(15) DW_CASE(16)
#undef DW_CASE
        default: return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// The halo-tile stencil kernel. A block owns a TH x TW tile of output pixels
// of one image, all C channels, and walks the channels in 32-wide slabs,
// G slabs a stage. For each stage it stages into shared memory, through a
// two-stage cp.async ring (the next stage's copies fly while this one
// computes), the (TH+K-1) x (TW+K-1) halo of those slabs, 32 floats a
// pixel (lane l reads channel l: 32 consecutive words, no bank conflict),
// and their K*K x 32 tap-major weights; taps off the image are zero-filled
// and never added. So each input float is fetched from global memory about
// (TH+K-1)(TW+K-1) / (TH*TW) times (2.4x at 8x16, K = 7), not K*K times.
// A warp computes one 8-pixel strip along W of one slab, lane l channel l:
// per halo row di it loads the strip's 8+K-1 inputs and the row's K weights
// into registers, then each output adds its taps in its own (di, dj) order.
// The finished y goes to a (TH*TW, C) tile in shared memory; then one warp
// a pixel loads its y[l + 32 i] into registers and runs dw_ln_kernel's
// LayerNorm on them, and writes the output coalesced. y in shared memory
// rather than registers keeps the slab loop a runtime loop (no
// C-dependent instantiations) and costs one store and one load an output,
// beside K*K multiplies and adds and ~2.5 K shared loads. The block has 16
// warps: at K >= 5 the kernel needs too many registers for two such blocks
// an SM, and 16 warps hide more latency than 8 (smaller blocks under a
// register cap were slower). What holds it back at K = 7: the separate
// multiply and add of every tap (no FMA, for the bits), one block an SM,
// and at the small tiles the halo's traffic from L2.
// pick_dw_tile chooses the tile by (B, H, W, C, K): down to one 8-pixel
// strip for the small grids, where G grows so that all of C is in flight
// at once.
// ---------------------------------------------------------------------------

constexpr int DW_THREADS = 512;
constexpr int DW_WARPS = DW_THREADS / 32;
constexpr int DW_R = 8;                 // outputs a lane computes along W
constexpr int DW_CPL = 16;              // channels a lane holds: C <= 512

struct DwTile {
    int TH, TW;        // output pixels of a block (TW a multiple of DW_R)
    int G;             // 32-channel slabs a stage holds
    int stages;        // 1 (all of C in one stage) or 2 (the ring)
    int KB;            // tap rows a stage holds: K, or (a run-time K whose
                       // halo does not fit) a band of them, y kept in the
                       // tile between bands
};

// floats of shared memory: the ring's stages first (each a multiple of 32
// floats, so 16-byte aligned for the copies), then the (TH*TW, C) y tile
long long dw_smem_floats(const DwTile& t, int C, int K) {
    const long long halo = (long long)(t.TH + t.KB - 1) * (t.TW + K - 1);
    return (long long)t.stages * t.G * (halo + t.KB * K + 1) * 32
           + (long long)t.TH * t.TW * C;
}

// KT: the kernel size as a template parameter (1, 3, 5, 7: the tap loops
// unroll), or 0 for any other odd K, read from K at run time.
template <int KT, class Norm>
__global__ void __launch_bounds__(DW_THREADS)
dw_tile_kernel(const float* __restrict__ x, int H, int W, int C, int K,
               DwTile t, int tiles_w, int tiles_h, int vec,
               const float* __restrict__ dwk_t, const float* __restrict__ dwb,
               Norm norm, float* __restrict__ out) {
    extern __shared__ __align__(16) float dw_smem[];
    if constexpr (KT > 0) K = KT;
    const int KB = KT > 0 ? KT : t.KB, nbands = (K + KB - 1) / KB;
    const int p = (K - 1) / 2, KBK = KB * K;   // a band's taps, then bias
    const int HR = t.TH + KB - 1, HC = t.TW + K - 1;
    const int stage_floats = t.G * (HR * HC + KBK + 1) * 32;
    float* ysh = dw_smem + t.stages * stage_floats;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tpi = tiles_w * tiles_h;
    const int b = blockIdx.x / tpi, tile = blockIdx.x % tpi;
    const int h0 = tile / tiles_w * t.TH, w0 = tile % tiles_w * t.TW;
    const int nslab = (C + 31) / 32;
    const int nsteps = (nslab + t.G - 1) / t.G * nbands;
    const float* xb = x + (long long)b * H * W * C;

    // stage the halo and weights of slabs [s0, s0 + G), tap rows [d0, d0 +
    // KB), into `st` (step: slabs outer, bands inner): qp copies a pixel's
    // 32-float slab row, ppc pixels a pass of the block; a thread walks
    // (slab, row, col) by adds, no division a copy
    const int V = vec ? 4 : 1, qp = 32 / V, ppc = DW_THREADS / qp;
    const int q = tid % qp, pix0 = tid / qp, npix = HR * HC;
    auto issue = [&](int step, float* st) {
        const int s0 = step / nbands * t.G, d0 = step % nbands * KB;
        int g = pix0 / npix, row = pix0 % npix / HC, col = pix0 % HC;
        for (int e = pix0; e < t.G * npix; e += ppc) {
            const int c = 32 * (s0 + g) + q * V;
            const int hh = h0 - p + d0 + row, ww = w0 - p + col;
            const bool ok = s0 + g < nslab && c < C
                            && (unsigned)hh < (unsigned)H
                            && (unsigned)ww < (unsigned)W;
            const float* src =
                ok ? xb + ((long long)hh * W + ww) * C + c : x;
            if (vec) cp_async<4>(st + e * 32 + q * V, src, ok);
            else cp_async<1>(st + e * 32 + q * V, src, ok);
            for (col += ppc; col >= HC; col -= HC)
                if (++row == HR) row = 0, ++g;
        }
        // the slabs' tap rows of the band and their bias row
        float* wst = st + t.G * npix * 32;
        int wg = pix0 / (KBK + 1), tap = pix0 % (KBK + 1);
        for (int e = pix0; e < t.G * (KBK + 1); e += ppc) {
            const int c = 32 * (s0 + wg) + q * V, gt = d0 * K + tap;
            const bool ok = s0 + wg < nslab && c < C
                            && (tap == KBK || gt < K * K);
            const float* src = !ok ? dwb
                               : tap < KBK ? dwk_t + (long long)gt * C + c
                                           : dwb + c;
            if (vec) cp_async<4>(wst + e * 32 + q * V, src, ok);
            else cp_async<1>(wst + e * 32 + q * V, src, ok);
            for (tap += ppc; tap > KBK; tap -= KBK + 1) ++wg;
        }
    };

    // one stage's outputs into ysh: unit u = (slab g of the stage, strip)
    auto compute = [&](int step, const float* st) {
        const int s0 = step / nbands * t.G, d0 = step % nbands * KB;
        const int spr = t.TW / DW_R, nstrips = t.TH * spr;
        const int units = min(t.G, nslab - s0) * nstrips;
        const float* wst = st + t.G * HR * HC * 32;
        for (int u = warp; u < units; u += DW_WARPS) {
            const int g = u / nstrips, strip = u % nstrips;
            const int tr = strip / spr, tc = strip % spr * DW_R;
            const int h = h0 + tr, wl = w0 + tc - p;  // column of tap 0
            const int c = 32 * (s0 + g) + lane;
            if (h >= H || w0 + tc >= W || c >= C) continue;
            // from the bias, or from where the previous band left y
            float y[DW_R];
            float* yo = ysh + (tr * t.TW + tc) * C + c;
            const float bias = wst[(g * (KBK + 1) + KBK) * 32 + lane];
#pragma unroll
            for (int r = 0; r < DW_R; ++r)
                y[r] = d0 == 0 ? bias : yo[r * C];
            // dj outer, r inner: eight independent adds in flight, while
            // each output still adds its taps in (di, dj) order
            const bool inside = wl >= 0 && wl + DW_R + K - 1 <= W;
#pragma unroll 1
            for (int dd = 0; dd < (KT > 0 ? KT : min(KB, K - d0)); ++dd) {
                const int hh = h + d0 + dd - p;
                if (hh < 0 || hh >= H) continue;
                const float* hrow = st + ((g * HR + tr + dd) * HC + tc) * 32
                                    + lane;
                const float* wrow =
                    wst + (g * (KBK + 1) + dd * K) * 32 + lane;
                if constexpr (KT > 0) {
                    float xin[DW_R + KT - 1], wk[KT];
#pragma unroll
                    for (int j = 0; j < DW_R + KT - 1; ++j)
                        xin[j] = hrow[j * 32];
#pragma unroll
                    for (int dj = 0; dj < KT; ++dj) wk[dj] = wrow[dj * 32];
                    if (inside) {
#pragma unroll
                        for (int dj = 0; dj < KT; ++dj)
#pragma unroll
                            for (int r = 0; r < DW_R; ++r)
                                y[r] = y[r] + xin[r + dj] * wk[dj];
                    } else {
#pragma unroll
                        for (int dj = 0; dj < KT; ++dj)
#pragma unroll
                            for (int r = 0; r < DW_R; ++r)
                                if ((unsigned)(wl + r + dj) < (unsigned)W)
                                    y[r] = y[r] + xin[r + dj] * wk[dj];
                    }
                } else {
                    for (int dj = 0; dj < K; ++dj) {
                        const float wv = wrow[dj * 32];
#pragma unroll
                        for (int r = 0; r < DW_R; ++r)
                            if ((unsigned)(wl + r + dj) < (unsigned)W)
                                y[r] = y[r] + hrow[(r + dj) * 32] * wv;
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < DW_R; ++r)
                if (w0 + tc + r < W) yo[r * C] = y[r];
        }
    };

    issue(0, dw_smem);
    cp_async_commit();
    for (int step = 0; step < nsteps; ++step) {
        float* st = dw_smem + (t.stages == 2 ? step % 2 : 0) * stage_floats;
        if (t.stages == 2) {
            if (step + 1 < nsteps)
                issue(step + 1, dw_smem + (step + 1) % 2 * stage_floats);
            cp_async_commit();
            cp_async_wait<1>();                // this step's copies landed
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        compute(step, st);
        __syncthreads();                       // the stage may be refilled
        if (t.stages == 1 && step + 1 < nsteps) {
            issue(step + 1, dw_smem);
            cp_async_commit();
        }
    }
    cp_async_wait<0>();

    // LayerNorm and the Norm step, one warp a pixel: its y[l + 32 i] loaded
    // from the tile into registers at once, then dw_ln_kernel's arithmetic
    for (int px = warp; px < t.TH * t.TW; px += DW_WARPS) {
        const int h = h0 + px / t.TW, w = w0 + px % t.TW;
        if (h >= H || w >= W) continue;        // whole warps skip together
        const float* yr = ysh + px * C;
        float y[DW_CPL];
        float2 np[DW_CPL];                    // loads in flight meanwhile
#pragma unroll
        for (int i = 0; i < DW_CPL; ++i) {
            const int c = lane + 32 * i;
            if (c < C) np[i] = norm.params(b, c);
            y[i] = c < C ? yr[c] : 0.f;
        }
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DW_CPL; ++i)
            if (lane + 32 * i < C) s += y[i];
        const float mu = warp_sum(s) / (float)C;
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < DW_CPL; ++i) {
            if (lane + 32 * i < C) {
                const float d = y[i] - mu;
                v += d * d;
            }
        }
        const float var = warp_sum(v) / (float)C;
        const float rstd = 1.0f / sqrtf(var + 1e-6f);
        float* o = out + (((long long)b * H + h) * W + w) * C;
#pragma unroll
        for (int i = 0; i < DW_CPL; ++i) {
            const int c = lane + 32 * i;
            if (c < C) o[c] = norm.apply((y[i] - mu) * rstd, np[i]);
        }
    }
}

template <int KT, class Norm>
cudaError_t launch_dw_tile(const float* x, int B, int H, int W, int C, int K,
                           const DwTile& t, int vec, const float* dwk_t,
                           const float* dwb, Norm norm, float* out,
                           int smem_optin, cudaStream_t stream) {
    static bool opted[64];             // opt in to the device's limit, once
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!opted[dev]) {
        err = cudaFuncSetAttribute(dw_tile_kernel<KT, Norm>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_optin);
        if (err != cudaSuccess) return err;
        opted[dev] = true;
    }
    const int tiles_w = (W + t.TW - 1) / t.TW;
    const int tiles_h = (H + t.TH - 1) / t.TH;
    const long long blocks = (long long)B * tiles_w * tiles_h;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t smem = (size_t)dw_smem_floats(t, C, K) * sizeof(float);
    dw_tile_kernel<KT, Norm><<<(unsigned)blocks, DW_THREADS, smem, stream>>>(
        x, H, W, C, K, t, tiles_w, tiles_h, vec, dwk_t, dwb, norm, out);
    return cudaGetLastError();
}

// The tile for (B, H, W, C, K): of DW_TILES, the one with the least
// waves * (TH*TW*(K*K + 10) + 16*(TH+K-1)*(TW+K-1)), the block's stencil
// and halo work times the waves of blocks over the SMs (the kernel holds
// one 512-thread block an SM at K >= 5): a model fitted to every tile's
// time at the main path's shapes on the H100 (B = 1, 2 and 6). G slabs a
// stage so that a stage holds a unit for every warp, spread evenly over
// the steps; a two-stage ring unless one stage holds all of C; where that
// exceeds the device's shared memory, a smaller G, and for a run-time K
// (not an instantiated one) bands of KB < K tap rows, one slab a stage.
// -> false if not even one tap row of the smallest tile fits.
constexpr int DW_TILES[][2] = {{8, 16}, {4, 32}, {4, 16}, {4, 8}, {2, 16},
                               {2, 8}, {1, 16}, {1, 8}};

bool dw_templated_k(int K) { return K == 1 || K == 3 || K == 5 || K == 7; }

bool pick_dw_tile(int B, int H, int W, int C, int K, int sms, int smem_optin,
                  DwTile* out) {
    const int nslab = (C + 31) / 32;
    auto fits = [&](const DwTile& t) {
        return dw_smem_floats(t, C, K) * 4 <= smem_optin;
    };
    long long best = -1;
    for (const auto& tile : DW_TILES) {
        const int TH = tile[0], TW = tile[1];
        // a tile mostly off the image (the smallest always qualifies)
        if ((TH > H || TW - DW_R >= W) && !(TH == 1 && TW == DW_R)) continue;
        const long long blocks = (long long)B * ((H + TH - 1) / TH)
                                 * ((W + TW - 1) / TW);
        const long long cost =
            (blocks + sms - 1) / sms
            * ((long long)TH * TW * (K * K + 10)
               + 16LL * (TH + K - 1) * (TW + K - 1));
        if (best >= 0 && cost >= best) continue;
        const int nstrips = TH * TW / DW_R;
        const int g0 = (DW_WARPS + nstrips - 1) / nstrips;
        DwTile found{0, 0, 0, 0, 0};
        for (int G = g0 < nslab ? g0 : nslab; G >= 1 && !found.TH; --G) {
            const int steps = (nslab + G - 1) / G;
            const DwTile t{TH, TW, (nslab + steps - 1) / steps,
                           steps > 1 ? 2 : 1, K};
            if (fits(t)) found = t;
        }
        for (int KB = K - 1; KB >= 1 && !found.TH && !dw_templated_k(K);
             --KB) {
            const DwTile t{TH, TW, 1, 2, KB};
            if (fits(t)) found = t;
        }
        if (found.TH) {
            *out = found;
            best = cost;
        }
    }
    return best >= 0;
}

// the halo-tile kernel for C <= 512 and any odd K whose one tap row of a
// 1 x 8 tile fits (K up to ~400 at C = 512)
template <class Norm>
cudaError_t dispatch_dw(const float* x, int B, int H, int W, int C, int K,
                        const float* dwk_t, const float* dwb, Norm norm,
                        float* out, cudaStream_t st) {
    if (C > 32 * 16 || K % 2 != 1) return cudaErrorInvalidValue;
    int dev, sms, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    DwTile t;
    if (!pick_dw_tile(B, H, W, C, K, sms, optin, &t))
        return cudaErrorInvalidValue;
    const int vec = C % 4 == 0 && aligned16(x) && aligned16(dwk_t)
                    && aligned16(dwb);
#define DW_TILE(KT) \
    return launch_dw_tile<KT>(x, B, H, W, C, K, t, vec, dwk_t, dwb, norm, \
                              out, optin, st)
    switch (K) {
        case 1: DW_TILE(1);
        case 3: DW_TILE(3);
        case 5: DW_TILE(5);
        case 7: DW_TILE(7);
        default: DW_TILE(0);
    }
#undef DW_TILE
}

// ---------------------------------------------------------------------------
// finish_image. Replaces lvae_tpu/ops/pallas/trunk.py:382 finish_image:
// clip(x, -1, 1) * 0.5 + 0.5, one elementwise pass. Bound: bytes (read and
// write 4 bytes an element); a grid-stride loop of coalesced accesses.
// ---------------------------------------------------------------------------

__global__ void finish_kernel(const float* __restrict__ x, long long n,
                              float* __restrict__ out) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += (long long)gridDim.x * blockDim.x)
        out[e] = fminf(fmaxf(x[e], -1.0f), 1.0f) * 0.5f + 0.5f;
}

// ---------------------------------------------------------------------------
// zadd. Replaces lvae_tpu/ops/pallas/trunk.py:636 zadd: float(syms) + pm,
// the decoded integers re-entering the QRes trunk before its 3x3 z_proj_0.
// Bound: bytes (4 + 4 read, 4 written an element); a grid-stride loop of
// coalesced accesses. Off the main path: qres_fuse runs z_proj_0 as
// trunk_zadd_conv_kxk, which converts the staged tile itself; this kernel
// followed by trunk_conv_kxk_act is that entry's bitwise oracle.
// ---------------------------------------------------------------------------

__global__ void zadd_kernel(const int* __restrict__ s,
                            const float* __restrict__ pm, long long n,
                            float* __restrict__ out) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += (long long)gridDim.x * blockDim.x)
        out[e] = (float)s[e] + pm[e];
}

// ---------------------------------------------------------------------------
// The lossless pixel head: the two chains that decide on which grid value a
// pixel lands. One thread per element, grid-stride, outputs in the inputs'
// (B, H, W, 3) layout; the Pallas (B, R, 128) row blocking was for the TPU.
// Every step is one IEEE float32 operation in the plain version's order
// (lvae_tpu_torch/ops/trunk.py): -fmad=false keeps each a * b + c at two
// roundings, the two divisions are true divisions (nvcc's default -prec-div;
// no multiplication by a reciprocal), rintf rounds half to even as
// jnp.round and torch.round do (roundf would round x.5 away from zero), and
// expf / logf are the accurate versions.
// ---------------------------------------------------------------------------

// nll_head's two element chains, shared by its two designs: the predicted
// mean rounded to the 255-level pixel grid and expressed in bin units, and
// the scale exp(logscale - log bin), logscale floored by softplus(r + 16) -
// 16, clamped below by the table's first entry (which also drops a NaN).
__device__ __forceinline__ float nll_mean(float m, float bin_size) {
    const float grid = rintf(m * 127.5f + 127.5f);
    return (grid / 127.5f - 1.0f) / bin_size;
}

__device__ __forceinline__ float nll_scale(float r, float log_bin, float t0) {
    const float ls = softplus_ref(r + 16.0f) - 16.0f;
    return fmaxf(expf(ls - log_bin), t0);
}

// nll_head. Replaces lvae_tpu/ops/pallas/trunk.py:767 nll_head: pm and the
// scale index #(table < scale) capped at S - 1, for a non-decreasing table
// (the entry point's contract). Bound: bytes (4 + 4 read, 4 + 4 written an
// element; ~log2(S) compares). On a non-decreasing table the entries below the
// scale are a prefix, so the capped count is the length of that prefix within
// the first S - 1 entries: a branchless lower-bound search, one probe a power
// of two from the largest <= S - 1 down (7 at the head's S = 128, where the
// replaced loop compared all 128; the same count for every scale, ties and
// +inf included), over the table in shared memory. V = 4: a thread takes four
// elements through 16-byte loads and stores, four searches in flight (n % 4 ==
// 0 and every pointer 16-byte aligned); V = 1 the rest. On an H100 at photo1's
// 1.18 M elements: ~12.3 us a launch against the loop's 26.5 and a bare copy's
// 5.2; without the element math 8.4-8.8, without the search 5.7
// (scripts/probe-nll-zadd-designs.py; PERF.md). Neither part alone exceeds the
// copy by much; together they do, at 27 registers and full occupancy: the
// instructions an element issues. Padding the table against bank conflicts,
// unrolling the steps, loading every probe unpredicated, a grid-stride loop on
// fewer blocks with the next elements prefetched, 128-thread blocks and two
// elements a thread were each no faster (within 5 %, or slower).

template <int V>
__global__ void nll_head_kernel(const float* __restrict__ m,
                                const float* __restrict__ r, long long nv,
                                const float* __restrict__ table, int S,
                                float bin_size, float log_bin,
                                float* __restrict__ pm, int* __restrict__ idx) {
    extern __shared__ float tb[];
    for (int i = threadIdx.x; i < S; i += blockDim.x) tb[i] = table[i];
    __syncthreads();
    const int cap = S - 1;
    const int top = cap ? 1 << (31 - __clz(cap)) : 0;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < nv; e += (long long)gridDim.x * blockDim.x) {
        float mv[V], rv[V], out[V], pv[V];
        int pos[V];
        if constexpr (V == 4) {
            const float4 a = reinterpret_cast<const float4*>(m)[e];
            const float4 c = reinterpret_cast<const float4*>(r)[e];
            mv[0] = a.x; mv[1] = a.y; mv[2] = a.z; mv[3] = a.w;
            rv[0] = c.x; rv[1] = c.y; rv[2] = c.z; rv[3] = c.w;
        } else {
            mv[0] = m[e];
            rv[0] = r[e];
        }
#pragma unroll
        for (int q = 0; q < V; ++q) {
            out[q] = nll_mean(mv[q], bin_size);
            pv[q] = nll_scale(rv[q], log_bin, tb[0]);
            pos[q] = 0;
        }
        for (int step = top; step > 0; step >>= 1) {
#pragma unroll
            for (int q = 0; q < V; ++q) {
                const int j = pos[q] + step;
                pos[q] = j <= cap && tb[j - 1] < pv[q] ? j : pos[q];
            }
        }
        if constexpr (V == 4) {
            reinterpret_cast<float4*>(pm)[e] =
                make_float4(out[0], out[1], out[2], out[3]);
            reinterpret_cast<int4*>(idx)[e] =
                make_int4(pos[0], pos[1], pos[2], pos[3]);
        } else {
            pm[e] = out[0];
            idx[e] = pos[0];
        }
    }
}

// nll_head's replaced design, its bitwise oracle: every thread compares
// the scale against all S entries in a fixed loop (broadcast reads of the
// table in shared memory), one element a thread. Any table order.
__global__ void nll_head_linear_kernel(const float* __restrict__ m,
                                       const float* __restrict__ r,
                                       long long n,
                                       const float* __restrict__ table, int S,
                                       float bin_size, float log_bin,
                                       float* __restrict__ pm,
                                       int* __restrict__ idx) {
    extern __shared__ float tb[];
    for (int i = threadIdx.x; i < S; i += blockDim.x) tb[i] = table[i];
    __syncthreads();
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += (long long)gridDim.x * blockDim.x) {
        pm[e] = nll_mean(m[e], bin_size);
        const float pv = nll_scale(r[e], log_bin, tb[0]);
        int count = 0;
#pragma unroll 8
        for (int i = 0; i < S; ++i) count += tb[i] < pv ? 1 : 0;
        idx[e] = min(count, S - 1);
    }
}

// nll_recon. Replaces lvae_tpu/ops/pallas/trunk.py:807 nll_recon: the exact
// pixel round(255 * (clip((float(s) + pm) * bin, -1, 1) * 0.5 + 0.5)), an
// integer-valued float (the uint8 cast stays outside). Bound: bytes (4 + 4
// read, 4 written an element).
__global__ void nll_recon_kernel(const int* __restrict__ s,
                                 const float* __restrict__ pm, long long n,
                                 float bin_size, float* __restrict__ out) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += (long long)gridDim.x * blockDim.x) {
        const float x = ((float)s[e] + pm[e]) * bin_size;
        out[e] = rintf((fminf(fmaxf(x, -1.0f), 1.0f) * 0.5f + 0.5f) * 255.0f);
    }
}

// Grid of the elementwise kernels: 256 threads a block, at most 4096 blocks
// (grid-stride beyond).
unsigned elementwise_blocks(long long n) {
    const long long blocks = (n + 255) / 256;
    return (unsigned)(blocks < 4096 ? blocks : 4096);
}

cudaError_t set_device(int device) { return cudaSetDevice(device); }

const float* x_f(const void* p) { return (const float*)p; }

}  // namespace

#define TRY(expr)                                    \
    do {                                             \
        const cudaError_t err_ = (expr);             \
        if (err_ != cudaSuccess) return (int)err_;   \
    } while (0)

// emb_mlp on one thread-block cluster of `cluster` CTAs (at most 16; above
// 8 the non-portable sizes). w0t (E, E0), w1t (E, E).
static int emb_mlp_cluster(const void* lmb, int B, const void* freqs,
                           const void* w0t, const void* b0, const void* w1t,
                           const void* b1, int E0, int E, float scale,
                           int cluster, void* emb, void* gemb, int device,
                           void* stream) {
    if (B < 1 || E0 < 2 || E0 % 2 || E < 1) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    int dev;
    TRY(cudaGetDevice(&dev));
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    static int limit[64];            // opt-in shared memory, once a device
    if (!limit[dev]) {
        int l;
        TRY(cudaDeviceGetAttribute(
            &l, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
        TRY(cudaFuncSetAttribute(emb_mlp_cluster_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 l));
        TRY(cudaFuncSetAttribute(
            emb_mlp_cluster_kernel,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
        limit[dev] = l;
    }
    // the weights' rows where they fit beside one row of x and h, then as
    // many rows of x and h as fit
    const long long row_bytes = (long long)(E0 + E) * sizeof(float);
    const long long w_bytes = (long long)((E + cluster - 1) / cluster)
                              * row_bytes;
    const int staged = w_bytes + row_bytes <= limit[dev];
    const long long room = limit[dev] - (staged ? w_bytes : 0);
    long long chunk = room / row_bytes;
    if (chunk < 1) return (int)cudaErrorInvalidValue;
    if (chunk > B) chunk = B;
    const int vec = E0 % 4 == 0 && E % 4 == 0 && aligned16(w0t)
                    && aligned16(w1t);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(EMB_CLUSTER_THREADS);
    cfg.dynamicSmemBytes = (size_t)((staged ? w_bytes : 0) + chunk * row_bytes);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    TRY(cudaLaunchKernelEx(&cfg, emb_mlp_cluster_kernel, x_f(lmb), B,
                           x_f(freqs), x_f(w0t), x_f(b0), x_f(w1t), x_f(b1),
                           E0, E, scale, (int)chunk, staged, vec,
                           (float*)emb, (float*)gemb));
    return (int)cudaGetLastError();
}

// Replaces lvae_tpu/ops/pallas/trunk.py:122 emb_mlp: one cluster of
// EMB_CLUSTER CTAs.
extern "C" int trunk_emb_mlp(const void* lmb, int B, const void* freqs,
                             const void* w0t, const void* b0, const void* w1t,
                             const void* b1, int E0, int E, float scale,
                             void* emb, void* gemb, int device, void* stream) {
    return emb_mlp_cluster(lmb, B, freqs, w0t, b0, w1t, b1, E0, E, scale,
                           EMB_CLUSTER, emb, gemb, device, stream);
}

// The same kernel on the portable cluster of 8 CTAs: the yardstick of
// EMB_CLUSTER and a second partition for the bitwise checks (chip_smoke.py,
// tests/test_torch_cuda.py), not on the main path.
extern "C" int trunk_emb_mlp_cluster8(const void* lmb, int B,
                                      const void* freqs, const void* w0t,
                                      const void* b0, const void* w1t,
                                      const void* b1, int E0, int E,
                                      float scale, void* emb, void* gemb,
                                      int device, void* stream) {
    return emb_mlp_cluster(lmb, B, freqs, w0t, b0, w1t, b1, E0, E, scale, 8,
                           emb, gemb, device, stream);
}

// emb_mlp on the one-block-a-row kernel: the cluster kernel's bitwise
// oracle (chip_smoke.py, tests/test_torch_cuda.py), not on the main path.
extern "C" int trunk_emb_mlp_oneblock(const void* lmb, int B,
                                      const void* freqs, const void* w0t,
                                      const void* b0, const void* w1t,
                                      const void* b1, int E0, int E,
                                      float scale, void* emb, void* gemb,
                                      int device, void* stream) {
    if (B < 1 || E0 < 2 || E0 % 2 || E < 1) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    emb_mlp_kernel<<<B, EMB_THREADS, (E0 + E) * sizeof(float),
                     (cudaStream_t)stream>>>(
        (const float*)lmb, (const float*)freqs, (const float*)w0t,
        (const float*)b0, (const float*)w1t, (const float*)b1, E0, E, scale,
        (float*)emb, (float*)gemb);
    return (int)cudaGetLastError();
}

// dw_ln_mod's phase 1 into `scratch`: (B, 2C) modulation, then the (K*K, C)
// tap-major weights; -> the launch's error
static cudaError_t dw_ln_mod_prep(int B, int C, int K, const void* dwk,
                                  const void* ewt, const void* eb,
                                  const void* gemb, int E, void* scratch,
                                  cudaStream_t st) {
    const long long nmod = (long long)B * 2 * C * 32;
    const long long ntap = (long long)K * K * C;
    const long long prep = nmod > ntap ? nmod : ntap;
    float* mod = (float*)scratch;
    dw_prep_kernel<<<(unsigned)((prep + 255) / 256), 256, 0, st>>>(
        x_f(gemb), x_f(ewt), x_f(eb), B, C, E, x_f(dwk), K * K, mod,
        mod + (long long)B * 2 * C);
    return cudaGetLastError();
}

static bool dw_ln_shape_ok(int B, int H, int W, int C, int K) {
    return B >= 1 && H >= 1 && W >= 1 && C >= 1 && C <= 32 * 16 && K >= 1
           && K % 2 == 1;
}

// Replaces lvae_tpu/ops/pallas/trunk.py:166 dw_ln_mod, on the halo-tile
// kernel. x/out (B, H, W, C); dwk (C, K, K); ewt (2C, E); scratch holds
// B*2C + K*K*C floats.
extern "C" int trunk_dw_ln_mod(const void* x, int B, int H, int W, int C,
                               int K, const void* dwk, const void* dwb,
                               const void* ewt, const void* eb,
                               const void* gemb, int E, void* scratch,
                               void* out, int device, void* stream) {
    if (!dw_ln_shape_ok(B, H, W, C, K) || E < 1)
        return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const cudaStream_t st = (cudaStream_t)stream;
    TRY(dw_ln_mod_prep(B, C, K, dwk, ewt, eb, gemb, E, scratch, st));
    const float* mod = x_f(scratch);
    return (int)dispatch_dw(x_f(x), B, H, W, C, K, mod + (long long)B * 2 * C,
                            x_f(dwb), NormAdaLN{mod, C}, (float*)out, st);
}

// dw_ln_mod on the warp-per-pixel kernel: the halo-tile kernel's bitwise
// oracle (chip_smoke.py, tests/test_torch_cuda.py), not on the main path.
extern "C" int trunk_dw_ln_mod_warp(const void* x, int B, int H, int W,
                                    int C, int K, const void* dwk,
                                    const void* dwb, const void* ewt,
                                    const void* eb, const void* gemb, int E,
                                    void* scratch, void* out, int device,
                                    void* stream) {
    if (!dw_ln_shape_ok(B, H, W, C, K) || E < 1)
        return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const cudaStream_t st = (cudaStream_t)stream;
    TRY(dw_ln_mod_prep(B, C, K, dwk, ewt, eb, gemb, E, scratch, st));
    const float* mod = x_f(scratch);
    return (int)dispatch_dw_warp(x_f(x), B, H, W, C, K,
                                 mod + (long long)B * 2 * C, x_f(dwb),
                                 NormAdaLN{mod, C}, (float*)out, st);
}

// Replaces lvae_tpu/ops/pallas/trunk.py:223 mlp_res, on the tiled core: two
// launches through the (M, HID) scratch `hidden`, fc1 with the GELU
// epilogue, fc2 with the layer-scale residual one. w1t (HID, C), w2t (CO,
// HID). Bound: operations (4*M*C*HID flops); the scratch round trip adds
// 8*M*HID bytes, small beside them at every main-path shape. At 96 rows fc2
// is a narrow product with a deep chain (96 x 2048 -> 512: each output 2048
// dependent FMAs, ~4.4 us alone), where the old 64x64 tile ran 16 blocks;
// dispatch_tiled gives it 16x32 tiles (96 blocks), and the 128 K steps'
// copies and barriers, not the FMAs, are then what its time is made of.
extern "C" int trunk_mlp_res(const void* t, int M, int C, int HID, int CO,
                             const void* w1t, const void* b1, const void* w2t,
                             const void* b2, const void* gamma,
                             const void* shortcut, void* hidden, void* out,
                             int device, void* stream) {
    TRY(set_device(device));
    const cudaStream_t st = (cudaStream_t)stream;
    TRY(dispatch_rows<DenseSrc>(x_f(t), M, HID, C, x_f(w1t),
                                StoreBiasGelu{(float*)hidden, x_f(b1), HID},
                                st));
    return (int)dispatch_rows<DenseSrc>(
        (const float*)hidden, M, CO, HID, x_f(w2t),
        StoreLayerScaleRes{(float*)out, x_f(b2), x_f(gamma), x_f(shortcut),
                           CO},
        st);
}

// Replaces lvae_tpu/ops/pallas/trunk.py:257 dense, on the tiled core. wt
// (CO, C). Bound: operations at the wide shapes (C 256-512 into 512-2048
// outputs: 2*M*C*CO flops against 67 TFLOP/s), bytes for the 48-channel
// pixel conv (C 128-192 into N = 48). The old 64x64 tile ran 64 blocks at
// M = 96; the tiled core takes 32x64 tiles there (96 blocks), 32x48 at M =
// 384, 64x64 at 1536 rows and 6x8-a-thread tiles at 6144, and a 48-wide
// tile for N = 48. What holds it back is the SIMT core itself: about half
// the FMA rate at the large shapes, as torch.addmm's own SIMT kernels.
extern "C" int trunk_dense(const void* x, int M, int C, int CO,
                           const void* wt, const void* b, void* out,
                           int device, void* stream) {
    TRY(set_device(device));
    return (int)dispatch_rows<DenseSrc>(x_f(x), M, CO, C, x_f(wt),
                                        StoreBias{(float*)out, x_f(b), CO},
                                        (cudaStream_t)stream);
}

// Replaces lvae_tpu/ops/pallas/trunk.py:302 prior_head, on the tiled core.
// wt (2Z, C); table (S,) scales (the count needs no order); act != 0
// applies GELU to x first, on the staged A tile (GeluRowSrc). Bound:
// operations on qarv_base (C = 256-512 into 2Z = 32-384: the product's
// flops lead, with log2(S) compares an index), bytes on qres34m (C = 48 or
// 96 into 2Z <= 64). The old core ran a serial loop of 64 dependent table
// loads through the read-only cache per index output (~20 us a launch,
// whatever M); StorePriorStaged stages the table in shared memory once a
// block and counts unrolled in four independent counts, and dispatch_prior
// gives a thread at most 4 index outputs (6 at 1536 x 384 -> 384). On an
// H100 the epilogue then costs 1.6-3.7 us over the product alone at
// qarv_base's shapes, ~7 us at qres34m's 24576 rows (PERF.md PR 13).
extern "C" int trunk_prior_head(const void* x, int M, int C, int Z,
                                const void* wt, const void* b,
                                const void* table, int S, int act, void* pm,
                                void* idx, int device, void* stream) {
    if (S < 1 || Z < 1) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const StorePriorStaged store{(float*)pm, (int*)idx, x_f(b), x_f(table),
                                 S, Z};
    const cudaStream_t st = (cudaStream_t)stream;
    if (act)
        return (int)dispatch_rows<GeluRowSrc>(x_f(x), M, 2 * Z, C, x_f(wt),
                                              store, st);
    return (int)dispatch_rows<DenseSrc>(x_f(x), M, 2 * Z, C, x_f(wt), store,
                                        st);
}

// prior_head on the old core (gemm_kernel, StorePrior: the table through
// the read-only cache, GELU in the A-tile load): the tiled core's bitwise
// oracle (chip_smoke.py, tests/test_torch_cuda.py), not on the main path.
extern "C" int trunk_prior_head_oldcore(const void* x, int M, int C, int Z,
                                        const void* wt, const void* b,
                                        const void* table, int S, int act,
                                        void* pm, void* idx, int device,
                                        void* stream) {
    if (S < 1 || Z < 1) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const StorePrior store{(float*)pm, (int*)idx, (const float*)b,
                           (const float*)table, S, Z};
    if (act)
        return (int)launch_gemm(M, 2 * Z, C, LoadGeluRows{(const float*)x, C},
                                (const float*)wt, store, (cudaStream_t)stream);
    return (int)launch_gemm(M, 2 * Z, C, LoadRows{(const float*)x, C},
                            (const float*)wt, store, (cudaStream_t)stream);
}

// the residual joins' epilogue for an (M, N) output: 16-byte copies and
// stores where N and both pointers allow
template <bool BIAS_LAST>
static StoreResidualStaged<BIAS_LAST> staged_residual(void* out, const void* b,
                                               const void* feature, int M,
                                               int N) {
    return {(float*)out, x_f(b), x_f(feature), M, N,
            N % 4 == 0 && aligned16(out) && aligned16(feature)};
}

// Replaces lvae_tpu/ops/pallas/trunk.py:343 fuse_zproj, on the tiled core:
// feature + ((float)syms + pm) @ w + b. syms int32 (M, Z); wt (C, Z).
// Bound: bytes (K = Z = 8-96; the feature is read and written once).
// SymsPmSrc copies the int32 words and pm raw into the ring and converts
// them in shared memory; StoreResidualStaged reads the feature tile while
// the product runs and writes the outputs as 16-byte row segments;
// dispatch_junction's tiles fill the SMs at 96-384 rows. The old core
// (trunk_fuse_zproj_oldcore) loaded each step element by element with no
// copy in flight, read the feature only after the product, stored scalars
// 4 columns apart and ran 12-48 blocks at 96-384 rows. On an H100: 3.5-4.1
// us a launch at 96-384 rows, 10.5 at 1536 x 96 -> 384, 7.0 at 6144 x 8 ->
// 256, against the old core's 5.7-6.1 / 13.1 / 12.5 (PERF.md, the residual
// joins). What holds it back is the tiled core itself: a block runs its
// copies, K steps and epilogue in turn, and issues about as many
// instructions as its bytes take.
extern "C" int trunk_fuse_zproj(const void* feature, const void* syms,
                                const void* pm, int M, int Z, int C,
                                const void* wt, const void* b, void* out,
                                int device, void* stream) {
    TRY(set_device(device));
    const SymsPmSrc src{(const int*)syms, x_f(pm), M, Z};
    const auto store = staged_residual<false>(out, b, feature, M, C);
    const cudaStream_t st = (cudaStream_t)stream;
    if (Z % 4 == 0 && aligned16(syms) && aligned16(pm) && aligned16(wt))
        return (int)dispatch_junction<4>(M, C, Z, src, x_f(wt), store, st);
    return (int)dispatch_junction<1>(M, C, Z, src, x_f(wt), store, st);
}

// fuse_zproj on the old core (gemm_kernel, LoadSymsPlusPm, StoreResidual):
// the tiled kernel's bitwise oracle (chip_smoke.py, tests/test_torch_cuda.py),
// not on the main path.
extern "C" int trunk_fuse_zproj_oldcore(const void* feature, const void* syms,
                                        const void* pm, int M, int Z, int C,
                                        const void* wt, const void* b,
                                        void* out, int device, void* stream) {
    TRY(set_device(device));
    return (int)launch_gemm(
        M, C, Z, LoadSymsPlusPm{(const int*)syms, (const float*)pm, Z},
        (const float*)wt,
        StoreResidual{(float*)out, (const float*)b, (const float*)feature, C},
        (cudaStream_t)stream);
}

// Replaces lvae_tpu/ops/pallas/trunk.py:382 finish_image (the float16 cast
// stays outside, as there).
extern "C" int trunk_finish_image(const void* x, long long n, void* out,
                                  int device, void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    finish_kernel<<<elementwise_blocks(n), 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, n, (float*)out);
    return (int)cudaGetLastError();
}

// The tail's last 1x1 conv, pixel shuffle and finish in one launch:
// x (M, C) rows of the (B, H, W, C) feature (M = B*H*W), wt (3*r*r, C), b
// (3*r*r,) -> out (B, r*H, r*W, 3) float16 = finish_value(x @ wt^T + b),
// shuffled (StoreShuffleStaged<true>). Replaces the chain trunk_dense ->
// pixel_shuffle_nhwc(...).contiguous() -> trunk_finish_image -> .to(float16)
// (lvae_tpu/ops/pallas/trunk.py:257 and :382), bit for bit: each output is
// the same chain plus bias, finished and rounded as there. Bound:
// operations at qarv_base's C = 128, about even with the bytes at qres34m's
// 192 (the feature read once, 2 bytes a pixel channel written).
extern "C" int trunk_upsample_finish(const void* x, int M, int W, int C,
                                     int rate, const void* wt, const void* b,
                                     void* out, int device, void* stream) {
    if (M < 1 || W < 1 || M % W != 0 || rate < 1) return
        (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const StoreShuffleStaged<true> st{(__half*)out, nullptr, x_f(b), M,
                                      3 * rate * rate, W, rate};
    return (int)dispatch_shuffle_rows(x_f(x), M, st.N, C, x_f(wt), st,
                                      (cudaStream_t)stream);
}

// The lossless head's two 1x1 convs on one feature in one product: wt (2G,
// C) the mean's then the scale's rows, b (2G,), G = 3*r*r -> out_mean and
// out_scale, each (B, r*H, r*W, 3) float32, shuffled
// (StoreShuffleStaged<false>). Replaces two trunk_dense launches and two
// pixel_shuffle_nhwc copies (lvae_tpu/ops/pallas/trunk.py:257, twice), bit
// for bit. Bound: operations (K = 192 on qres34m_lossless).
extern "C" int trunk_upsample_head(const void* x, int M, int W, int C,
                                   int rate, const void* wt, const void* b,
                                   void* out_mean, void* out_scale,
                                   int device, void* stream) {
    if (M < 1 || W < 1 || M % W != 0 || rate < 1) return
        (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const StoreShuffleStaged<false> st{(float*)out_mean, (float*)out_scale,
                                       x_f(b), M, 6 * rate * rate, W, rate};
    return (int)dispatch_shuffle_rows(x_f(x), M, st.N, C, x_f(wt), st,
                                      (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// QRes-VAE trunk (lvae_tpu/ops/pallas/trunk.py:446-748). The products run on
// the two cores above with new prologues and epilogues; every output's sum
// over K is still one chain k = 0..K-1.
// ---------------------------------------------------------------------------

// Replaces lvae_tpu/ops/pallas/trunk.py:462 dw_ln_affine, on the halo-tile
// kernel. x/out (B, H, W, C); dwk_t (K, K, C), tap-major, prepared once
// per module by the caller (no phase 1); scale, bias (C,). Bound: as
// dw_ln_mod's stencil (bytes at K <= 5, operations at K = 7).
extern "C" int trunk_dw_ln_affine(const void* x, int B, int H, int W, int C,
                                  int K, const void* dwk_t, const void* dwb,
                                  const void* scale, const void* bias,
                                  void* out, int device, void* stream) {
    if (!dw_ln_shape_ok(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    return (int)dispatch_dw(x_f(x), B, H, W, C, K, x_f(dwk_t), x_f(dwb),
                            NormAffine{x_f(scale), x_f(bias)}, (float*)out,
                            (cudaStream_t)stream);
}

// dw_ln_affine on the warp-per-pixel kernel: the halo-tile kernel's bitwise
// oracle, not on the main path.
extern "C" int trunk_dw_ln_affine_warp(const void* x, int B, int H, int W,
                                       int C, int K, const void* dwk_t,
                                       const void* dwb, const void* scale,
                                       const void* bias, void* out,
                                       int device, void* stream) {
    if (!dw_ln_shape_ok(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    return (int)dispatch_dw_warp(x_f(x), B, H, W, C, K, x_f(dwk_t),
                                 x_f(dwb), NormAffine{x_f(scale), x_f(bias)},
                                 (float*)out, (cudaStream_t)stream);
}

// gelu_as of n floats of `in` into `scratch`, one launch (16-byte accesses
// where n and both pointers allow): the pre-pass of conv_kxk_act and
// dense_act
static cudaError_t gelu_prepass(const float* in, long long n, void* scratch,
                                cudaStream_t st) {
    if (n % 4 == 0 && aligned16(in) && aligned16(scratch))
        gelu_kernel<<<elementwise_blocks(n / 4), 256, 0, st>>>(
            (const float4*)in, n / 4, (float4*)scratch);
    else
        gelu1_kernel<<<elementwise_blocks(n), 256, 0, st>>>(in, n,
                                                            (float*)scratch);
    return cudaGetLastError();
}

// Replaces lvae_tpu/ops/pallas/trunk.py:520 dense_act, on the tiled core:
// (gelu(x) or x) @ w + b, the VDBlock 1x1 convs. wt (CO, C). Bound:
// operations at C = 384 (M x 384 x 96), bytes at the 96- and 48-channel
// convs. The old core ran one 16-deep K step a barrier pair with no copy in
// flight on 2-48 blocks (~2 us a step: 45-48 us at C = 384 for any M up to
// 1536); the tiled core keeps two steps' copies in flight on tiles that
// fill the SMs. act with a `scratch` of M*C floats: gelu_prepass, then the
// product, two device launches (the main path); act without one: gelu_as
// on the staged A tile (GeluRowSrc, one launch; prior_head's product, the
// yardstick of the pre-pass). On an H100 the staged GELU sits between
// each K step's wait and barrier, on the step's critical path: ~0.5 us a
// step at C = 384 (24-26 us a launch against the pre-pass's 11-14 at M <=
// 1536); it is ahead only at 24576 x 192 -> 48, 27 us against 32, where
// the pre-pass moves 38 MB more (PERF.md PR 13). What holds the pre-pass
// back is the tiled core itself: ~0.4 us a K step at 6-96 blocks.
extern "C" int trunk_dense_act(const void* x, int M, int C, int CO,
                               const void* wt, const void* b, int act,
                               void* scratch, void* out, int device,
                               void* stream) {
    TRY(set_device(device));
    const StoreBias store{(float*)out, x_f(b), CO};
    const cudaStream_t st = (cudaStream_t)stream;
    if (act && !scratch)
        return (int)dispatch_rows<GeluRowSrc>(x_f(x), M, CO, C, x_f(wt),
                                              store, st);
    const float* in = x_f(x);
    if (act) {
        if (M < 1 || C < 1) return (int)cudaErrorInvalidValue;
        TRY(gelu_prepass(in, (long long)M * C, scratch, st));
        in = x_f(scratch);
    }
    return (int)dispatch_rows<DenseSrc>(in, M, CO, C, x_f(wt), store, st);
}

// dense_act on the old core (gemm_kernel, the GELU in the A-tile load): the
// bitwise oracle of every product on the tiled core (chip_smoke.py
// core_oracle, tests/test_torch_cuda.py), not on the main path.
extern "C" int trunk_dense_act_oldcore(const void* x, int M, int C, int CO,
                                       const void* wt, const void* b, int act,
                                       void* out, int device, void* stream) {
    TRY(set_device(device));
    const StoreBias store{(float*)out, x_f(b), CO};
    if (act)
        return (int)launch_gemm(M, CO, C, LoadGeluRows{x_f(x), C}, x_f(wt),
                                store, (cudaStream_t)stream);
    return (int)launch_gemm(M, CO, C, LoadRows{x_f(x), C}, x_f(wt), store,
                            (cudaStream_t)stream);
}

// Replaces lvae_tpu/ops/pallas/trunk.py:563 conv_kxk_act, on the tiled
// core: a 'same' K x K conv as an implicit product, M = B*H*W output
// pixels, N = Co, depth K*K*Ci in tap-major order (k = (di*K + dj)*Ci +
// ci), read straight from the NHWC feature (ConvSrc: no padded copy, no
// stack of K*K shifted windows; a tap off the image is a zero-filled copy).
// act runs gelu_kernel once per input element into `scratch` (B, H, W, Ci)
// first, two device launches in all: the old loader ran the GELU K*K times
// per element and N tile. x (B, H, W, Ci), wt (Co, K*K*Ci), out (B, H, W,
// Co). The bias is added after the chain (the JAX kernel adds it before the
// taps: within float tolerance, and the same on both sides of a stream).
// Bound: operations (2*M*Co*K*K*Ci) at the 96- and 48-channel convs, where
// 48- and 24-wide tiles waste no column and the grid fills the SMs (16x24
// tiles at 32x48, 384 blocks; 32x48 at 64x96; 64x48 at 128x192); bytes for
// z_proj_0 (Ci = Z <= 16). At 16x24 (M = 384, K*K*Ci = 864) neither: each
// output is one chain of 864 dependent FMAs (~4 cycles each, ~1.7 us) and
// the 16x24 tiles give 96 blocks of one warp, so the 54 K steps' latency
// (copy, barrier, shared reads) is what the time is made of.
extern "C" int trunk_conv_kxk_act(const void* x, int B, int H, int W, int Ci,
                                  int K, int Co, const void* wt,
                                  const void* b, int act, void* scratch,
                                  void* out, int device, void* stream) {
    if (B < 1 || H < 1 || W < 1 || Ci < 1 || K < 1 || K % 2 != 1 || Co < 1
        || (act && !scratch))
        return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const cudaStream_t st = (cudaStream_t)stream;
    const int M = B * H * W;
    const float* in = x_f(x);
    if (act) {
        TRY(gelu_prepass(in, (long long)M * Ci, scratch, st));
        in = (const float*)scratch;
    }
    const ConvSrc src{in, M, H, W, Ci, K, K * K * Ci};
    const StoreBias store{(float*)out, x_f(b), Co};
    if (Ci % 4 == 0 && aligned16(in) && aligned16(wt))
        return (int)dispatch_tiled<4>(M, Co, K * K * Ci, src, x_f(wt), store,
                                      st);
    return (int)dispatch_tiled<1>(M, Co, K * K * Ci, src, x_f(wt), store, st);
}

// Replaces lvae_tpu/ops/pallas/trunk.py:636 zadd together with the
// :563 conv_kxk_act(act=False) that reads its output: z_proj_0 of a QRes
// latent block at kernel size >= 3, a 'same' K x K conv of float(syms) +
// pm. syms int32 and pm (B, H, W, Z); wt (Co, K*K*Z) tap-major as
// trunk_conv_kxk_act's; out (B, H, W, Co). z is never written: the
// conversion runs on the staged A tile (ConvSymsPmSrc), so one launch
// replaces zadd's elementwise pass, its write and the conv's read of z.
// The same tiles (dispatch_tiled) and bias-after-chain order as
// trunk_conv_kxk_act, so bitwise its outputs on zadd's z; the staged A
// bytes double (the extra slab), which at Z <= 16 into 24-48 channels
// (qres34m) sit beside a chain of K*K*Z FMAs an output.
extern "C" int trunk_zadd_conv_kxk(const void* syms, const void* pm, int B,
                                   int H, int W, int Z, int K, int Co,
                                   const void* wt, const void* b, void* out,
                                   int device, void* stream) {
    if (B < 1 || H < 1 || W < 1 || Z < 1 || K < 1 || K % 2 != 1 || Co < 1)
        return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const cudaStream_t st = (cudaStream_t)stream;
    const int M = B * H * W;
    const ConvSymsPmSrc src{ConvSrc{(const float*)syms, M, H, W, Z, K,
                                    K * K * Z}, x_f(pm)};
    const StoreBias store{(float*)out, x_f(b), Co};
    if (Z % 4 == 0 && aligned16(syms) && aligned16(pm) && aligned16(wt))
        return (int)dispatch_tiled<4>(M, Co, K * K * Z, src, x_f(wt), store,
                                      st);
    return (int)dispatch_tiled<1>(M, Co, K * K * Z, src, x_f(wt), store, st);
}

// Replaces lvae_tpu/ops/pallas/trunk.py:609 zadd_dense, on the tiled core:
// (syms + pm) @ w + b, the 1x1 z_proj_0 of a kernel-size-1 block (qres34m's
// first latent block: M = 96 rows an image, Z = 16, CO = 48). syms int32 (M,
// Z); wt (CO, Z). Bound: bytes (K = Z). fuse_zproj's A operand (SymsPmSrc: the
// int32 words and pm copied raw, converted in shared memory) with the bias
// after the chain (StoreBias), so each output is the old core's fmaf chain
// from +0 and its bits. dispatch_junction's 16x32 tiles of 2x2 (64 threads a
// block) over dispatch_tiled's 16x24 of 2x6 (32 threads, 12 outputs a thread):
// on an H100 2.8-3.3 us a launch against 3.2-3.7 at M = 96, 192 and 384, the
// old core 3.7-4.4, which loaded its one K step element by element with no
// copy in flight (scripts/probe-nll-zadd-designs.py). The launch is latency:
// one 16-deep K step, 34 KB of bytes at M = 96.
extern "C" int trunk_zadd_dense(const void* syms, const void* pm, int M,
                                int Z, int CO, const void* wt, const void* b,
                                void* out, int device, void* stream) {
    TRY(set_device(device));
    const SymsPmSrc src{(const int*)syms, x_f(pm), M, Z};
    const StoreBias store{(float*)out, x_f(b), CO};
    const cudaStream_t st = (cudaStream_t)stream;
    if (Z % 4 == 0 && aligned16(syms) && aligned16(pm) && aligned16(wt))
        return (int)dispatch_junction<4>(M, CO, Z, src, x_f(wt), store, st);
    return (int)dispatch_junction<1>(M, CO, Z, src, x_f(wt), store, st);
}

// zadd_dense on the old core (gemm_kernel, LoadSymsPlusPm): the tiled
// kernel's bitwise oracle, not on the main path.
extern "C" int trunk_zadd_dense_oldcore(const void* syms, const void* pm,
                                        int M, int Z, int CO, const void* wt,
                                        const void* b, void* out, int device,
                                        void* stream) {
    TRY(set_device(device));
    return (int)launch_gemm(M, CO, Z,
                            LoadSymsPlusPm{(const int*)syms, x_f(pm), Z},
                            x_f(wt), StoreBias{(float*)out, x_f(b), CO},
                            (cudaStream_t)stream);
}

// Replaces lvae_tpu/ops/pallas/trunk.py:636 zadd (the oracle of
// trunk_zadd_conv_kxk's conversion; not on the main path).
extern "C" int trunk_zadd(const void* syms, const void* pm, long long n,
                          void* out, int device, void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    zadd_kernel<<<elementwise_blocks(n), 256, 0, (cudaStream_t)stream>>>(
        (const int*)syms, x_f(pm), n, (float*)out);
    return (int)cudaGetLastError();
}

// Replaces lvae_tpu/ops/pallas/trunk.py:663 res_dense_act, on the tiled
// core: feature + gelu(t) @ w + b, added in the JAX kernel's order
// ((feature + acc) + b), the z_proj_1 residual join. t (M, Ci); wt (C, Ci).
// Bound: bytes (K = Ci = 48 or 24; the feature is read and written once).
// Without a `scratch`: gelu_as on the staged A tile (GeluRowSrc), one
// launch; each block applies it once to each element of its A tile, so an
// element N / BN times in all, as the old core's A-tile load did. With a
// scratch of M*Ci floats: gelu_prepass, once an element, then the product
// (DenseSrc), two launches and a round trip of the scratch. Both with
// StoreResidualStaged and dispatch_junction's tiles, as fuse_zproj. The
// main path takes the staged GELU (ops/trunk.py res_dense_act): on
// an H100 it was ahead at every main-path shape but 6144 x 48 -> 384
// (within 1 %), 4.1-22.4 us a launch against the old core's 9.2-41.2
// (PERF.md, the residual joins).
extern "C" int trunk_res_dense_act(const void* feature, const void* t, int M,
                                   int Ci, int C, const void* wt,
                                   const void* b, void* scratch, void* out,
                                   int device, void* stream) {
    TRY(set_device(device));
    const auto store = staged_residual<true>(out, b, feature, M, C);
    const cudaStream_t st = (cudaStream_t)stream;
    if (!scratch)
        return (int)dispatch_rows<GeluRowSrc>(x_f(t), M, C, Ci, x_f(wt),
                                              store, st);
    if (M < 1 || Ci < 1) return (int)cudaErrorInvalidValue;
    TRY(gelu_prepass(x_f(t), (long long)M * Ci, scratch, st));
    return (int)dispatch_rows<DenseSrc>(x_f(scratch), M, C, Ci, x_f(wt),
                                        store, st);
}

// res_dense_act on the old core (gemm_kernel, LoadGeluRows,
// StoreResidualBias): the tiled kernel's bitwise oracle, not on the main
// path.
extern "C" int trunk_res_dense_act_oldcore(const void* feature, const void* t,
                                           int M, int Ci, int C,
                                           const void* wt, const void* b,
                                           void* out, int device,
                                           void* stream) {
    TRY(set_device(device));
    return (int)launch_gemm(
        M, C, Ci, LoadGeluRows{x_f(t), Ci}, x_f(wt),
        StoreResidualBias{(float*)out, x_f(b), x_f(feature), C},
        (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// The lossless pixel head (lvae_tpu/ops/pallas/trunk.py:740-822).
// ---------------------------------------------------------------------------

// Replaces lvae_tpu/ops/pallas/trunk.py:767 nll_head. p_mean, p_scale_raw,
// pm (float32) and idx (int32) hold n elements each; table (S,), S <= 1024,
// MUST be non-decreasing (the search's contract; not checked here, which
// would synchronise: the caller checks the table once where it is made).
// bin_size and log_bin are float32(1/127.5) and float32(log(1/127.5)),
// rounded once from double as JAX's weakly typed Python floats are.
extern "C" int trunk_nll_head(const void* p_mean, const void* p_scale_raw,
                              long long n, const void* table, int S,
                              float bin_size, float log_bin, void* pm,
                              void* idx, int device, void* stream) {
    if (n < 1 || S < 1 || S > 1024) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    const size_t smem = S * sizeof(float);
    const cudaStream_t st = (cudaStream_t)stream;
    if (n % 4 == 0 && aligned16(p_mean) && aligned16(p_scale_raw)
        && aligned16(pm) && aligned16(idx))
        nll_head_kernel<4><<<elementwise_blocks(n / 4), 256, smem, st>>>(
            x_f(p_mean), x_f(p_scale_raw), n / 4, x_f(table), S, bin_size,
            log_bin, (float*)pm, (int*)idx);
    else
        nll_head_kernel<1><<<elementwise_blocks(n), 256, smem, st>>>(
            x_f(p_mean), x_f(p_scale_raw), n, x_f(table), S, bin_size,
            log_bin, (float*)pm, (int*)idx);
    return (int)cudaGetLastError();
}

// nll_head on the replaced design (nll_head_linear_kernel, any table
// order): the bitwise oracle of trunk_nll_head (chip_smoke.py,
// tests/test_torch_cuda.py), not on the main path.
extern "C" int trunk_nll_head_linear(const void* p_mean,
                                     const void* p_scale_raw, long long n,
                                     const void* table, int S, float bin_size,
                                     float log_bin, void* pm, void* idx,
                                     int device, void* stream) {
    if (n < 1 || S < 1 || S > 1024) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    nll_head_linear_kernel<<<elementwise_blocks(n), 256, S * sizeof(float),
                             (cudaStream_t)stream>>>(
        x_f(p_mean), x_f(p_scale_raw), n, x_f(table), S, bin_size, log_bin,
        (float*)pm, (int*)idx);
    return (int)cudaGetLastError();
}

// Replaces lvae_tpu/ops/pallas/trunk.py:807 nll_recon. syms int32, pm and
// out float32, n elements each.
extern "C" int trunk_nll_recon(const void* syms, const void* pm, long long n,
                               float bin_size, void* out, int device,
                               void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    TRY(set_device(device));
    nll_recon_kernel<<<elementwise_blocks(n), 256, 0, (cudaStream_t)stream>>>(
        (const int*)syms, x_f(pm), n, bin_size, (float*)out);
    return (int)cudaGetLastError();
}
