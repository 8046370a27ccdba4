// N-lane interleaved rANS encode and decode kernels for Hopper (sm_90a).
//
// Stream format (lvae_tpu/ops/rans_interleaved.py): 16-bit CDFs, 32-bit lane
// states in [2^16, 2^32), 16-bit word renormalisation, symbol i of a latent
// block on lane i % N, rows of N symbols, words in row-major order with lanes
// ascending inside a row. Both kernels are bit-exact twins of the plain
// PyTorch versions in lvae_tpu_torch/ops/rans_{encode,decode}.py.
//
// The library has a plain C interface (no PyTorch headers) and is loaded with
// ctypes by lvae_tpu_torch/ops/build.py. Every entry point takes raw device
// pointers, int sizes, the device ordinal and a cudaStream_t, launches on that
// stream without synchronising, and returns cudaGetLastError(). The library
// links its own (static) CUDA runtime, so it selects the caller's device
// itself; PyTorch's pointers and streams belong to the same primary context.
//
// Decode (rans_decode_block_kernel) is a chain: each row's lane states and
// word pointer feed the next row, so a block's time is T rows times the
// latency of one row, and the bytes (~5 MB per qarv_base 512x768 image, ~1.5
// us at 3.35 TB/s) do not bound it. The kernel keeps global memory off that
// chain: the CDF table and offsets sit in shared memory (staged once per
// launch, rows re-padded to 256 entries, or a larger power of 4, so the search
// is a fixed number of 4-ary shared-memory rounds), the stream words and the
// scale indexes arrive through shared-memory rings filled rows ahead with
// cp.async, and up to 64 lanes one warp runs an image (two lanes a thread
// above 32), so that a row needs no block barrier. A row is then a
// shared-memory search and a ballot per 32 lanes, and above 64 lanes one block
// barrier. Encode (rans_encode_all_kernel) is the simple design: one thread
// block of N threads per image, CDF rows read through the L1 cache, one block
// barrier a row. The multi-image entry points launch the same kernels with one
// block per image (grid = B), so that B images' chains run side by side on B
// SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 128;
constexpr int kWarp = 32;
constexpr int kMaxWarps = kMaxLanes / kWarp;

// The decode kernel's shared memory: a ring of kRingChunks chunks of
// kRingChunk stream words; a ring of kIndexSlots rows of scale indexes; the
// CDF table (S rows of P entries, P + 1 words apart); the S
// offsets. A row reads at most N <= kMaxLanes words at the word pointer, so
// the two chunks at and after the pointer hold every word of the next row,
// and a chunk is asked for when the pointer enters the chunk seven before
// it: at least 13 rows before a row needs it. Each lane asks for its own
// index kIndexAhead rows before its row.
constexpr int kSentinel = 1 << 17;   // a padded CDF entry: above every slot
constexpr int kRingChunk = 256;
constexpr int kRingChunks = 8;
constexpr int kRingWords = kRingChunk * kRingChunks;
constexpr int kIndexSlots = 8;
constexpr int kIndexAhead = kIndexSlots - 1;
static_assert(2 * kMaxLanes <= kRingChunk, "a row's words span two chunks");
static_assert((kRingChunks & (kRingChunks - 1)) == 0, "");
static_assert((kRingChunks - 1) * kRingChunk - kMaxLanes
              >= kIndexAhead * kMaxLanes, "a chunk lands before it is read");

// 4-byte cp.async into shared memory; src-size 0 (valid false) writes 0
__device__ __forceinline__ void cp_async4(int* dst, const int* src,
                                          bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Largest s with table[row + s] <= slot for each of a thread's LPT lanes,
// over non-decreasing rows of P entries (a power of 4, at least 256) with
// table[row] <= slot, `table` in shared memory: a 4-ary search, each round
// reading its three pivots at once, its LPT searches advancing together so
// that their loads overlap. Rows wider than 256 entries take their extra
// rounds first; 256-entry rows (every table of the repository) take the four
// unrolled rounds alone.
template <int LPT>
__device__ __forceinline__ void search_rows(const int* table,
                                            const int (&row)[LPT],
                                            const uint32_t (&slot)[LPT],
                                            int P, int (&s)[LPT]) {
    auto step = [&](int q) {
#pragma unroll
        for (int j = 0; j < LPT; ++j)
            s[j] += ((uint32_t)table[s[j] + q] <= slot[j] ? q : 0)
                    + ((uint32_t)table[s[j] + 2 * q] <= slot[j] ? q : 0)
                    + ((uint32_t)table[s[j] + 3 * q] <= slot[j] ? q : 0);
    };
#pragma unroll
    for (int j = 0; j < LPT; ++j) s[j] = row[j];
    for (int q = P >> 2; q >= 256; q >>= 2) step(q);
#pragma unroll
    for (int q = 64; q >= 1; q >>= 2) step(q);
#pragma unroll
    for (int j = 0; j < LPT; ++j) s[j] -= row[j];
}

// Replaces lvae_tpu/ops/pallas/rans_decode.py:160 rans_decode_block (the
// Pallas _decode_kernel) and, launched with one block per image,
// rans_decode.py:359 rans_decode_block_multi (_decode_kernel_multi, which
// stacks B images' states on the TPU's sublanes). Decodes one latent block of
// T rows; block b decodes image b: its (T, N) indexes and values at b*T*N, its
// states at b*N, its word pointer at b, its stream at row b of a (B, W) array
// (words past W read as 0). The TPU kernels' byte-split one-hot matmuls and
// 2048-word windows exist only for the MXU. Lanes at t*N + lane >= nsym keep
// their state and write 0.
//
// Bound: the bytes (each input read once, each output written once) take ~1.7
// us for a qarv_base image at 3.35 TB/s; the chain of T dependent rows takes T
// times a row's latency, measured by chip_smoke.py on an H100 (700 W) at
// 325-335 ns a row for N = 16, 475-490 for 64 and 515-590 for 128 (4,824 rows,
// 2.5-2.8 ms, for an image at N = 128), so the chain is the bound. Up to 64
// lanes one warp runs them (ONE_WARP; LPT = 1 or 2 lanes a thread, thread l
// running lanes l and l + 32); above, ceil(N / 32) warps of a lane a thread.
// One row of a lane: its scale index from the index ring; the search of its
// CDF row in shared memory (search_rows: the largest s with row[s] <= slot,
// which for the sentinel-padded rows is the TPU kernel's
// "#(row <= slot) - 1"); the state update; a ballot; with more than one
// warp the warps' counts through shared memory and one block barrier; and
// the renormalising lane's word from the stream ring at ptr + (flagged
// lanes before it). No global load is on the chain: every copy is a
// cp.async issued rows ahead, one commit group a row (the indexes
// kIndexAhead rows on and any ring refill), and a row waits for the group
// of kIndexAhead - 1 rows before, which holds the next row's indexes (read
// into registers a row ahead) and every chunk this row can read. The stream
// ring is refilled after a row's barrier (one warp: after its reads), when
// no lane still reads a chunk below the pointer.
template <int LPT, bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? kWarp : kMaxLanes)
rans_decode_block_kernel(const int* __restrict__ indexes, int T, int N,
                         const int* __restrict__ states_in,
                         int* __restrict__ states_out,
                         const int* __restrict__ ptr_in,
                         int* __restrict__ ptr_out,
                         const int* __restrict__ stream, long long W,
                         const int* __restrict__ cdfs, int S, int L, int P,
                         const int* __restrict__ offsets, long long nsym,
                         int* __restrict__ values) {
    static_assert(ONE_WARP || LPT == 1, "");
    extern __shared__ __align__(16) int smem[];
    __shared__ int warp_count[2][kMaxWarps];
    const int logP = __ffs(P) - 1;
    int* const ring = smem;
    int* const index_ring = ring + kRingWords;
    int* const table = index_ring + kIndexSlots * kMaxLanes;
    int* const offs = table + S * (P + 1);
    const int img = blockIdx.x;
    const long long rows = (long long)T * N;
    indexes += img * rows;
    values += img * rows;
    states_in += (long long)img * N;
    states_out += (long long)img * N;
    stream += img * W;
    const int tid = threadIdx.x, nthreads = ONE_WARP ? kWarp : blockDim.x;
    const int warps = nthreads / kWarp, warp = tid / kWarp, wl = tid % kWarp;
    const unsigned below = (1u << wl) - 1u;
    int lane[LPT];
    bool lane_ok[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        lane[j] = j * kWarp + tid;
        lane_ok[j] = lane[j] < N;
    }

    // the table, its rows re-padded to P entries, and the offsets. Rows lie
    // P + 1 words apart, so that lanes at the same search step in different
    // rows read different banks
    for (int e = tid; e < S * P; e += nthreads) {
        const int r = e >> logP, j = e & (P - 1);
        int* dst = table + r * (P + 1) + j;
        if (j < L) cp_async4(dst, cdfs + (long long)r * L + j, true);
        else *dst = kSentinel;
    }
    for (int e = tid; e < S; e += nthreads)
        cp_async4(offs + e, offsets + e, true);
    // stream chunk c (words c*kRingChunk ...) goes to ring slot c %
    // kRingChunks; the first kRingChunks from the pointer's
    long long ptr = ptr_in[img];
    long long issued = ptr / kRingChunk;
    auto issue_chunk = [&]() {
        int* dst = ring + (issued & (kRingChunks - 1)) * kRingChunk;
        const long long p0 = issued * kRingChunk;
        for (int e = tid; e < kRingChunk; e += nthreads) {
            const bool ok = p0 + e < W;
            cp_async4(dst + e, ok ? stream + p0 + e : stream, ok);
        }
        ++issued;
    };
    const long long first = issued;
    while (issued < first + kRingChunks) issue_chunk();
    // row t's indexes go to slot t % kIndexSlots; a lane reads only its own
    auto fetch_indexes = [&](int t) {
#pragma unroll
        for (int j = 0; j < LPT; ++j)
            if (lane_ok[j] && t < T)
                cp_async4(index_ring + (t % kIndexSlots) * kMaxLanes + lane[j],
                          indexes + (long long)t * N + lane[j], true);
    };
    for (int t = 0; t < kIndexAhead; ++t) fetch_indexes(t);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t x[LPT];
    int index[LPT];                          // this row's, read a row ahead
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        x[j] = lane_ok[j] ? (uint32_t)states_in[lane[j]] : 0u;
        index[j] = index_ring[lane[j]];
    }

    for (int t = 0; t < T; ++t) {
        // the groups of the last kIndexAhead - 2 rows may be in flight; the
        // older ones hold row t + 1's indexes and the chunks this row can
        // read (seen by every lane after the barrier below, or this sync)
        cp_async_wait<kIndexAhead - 2>();
        if constexpr (ONE_WARP) __syncwarp();
        int id[LPT], row[LPT], s[LPT], next[LPT];
        bool active[LPT];
        uint32_t slot[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            active[j] = lane_ok[j] && (long long)t * N + lane[j] < nsym;
            id[j] = active[j] ? min(max(index[j], 0), S - 1) : 0;
            row[j] = id[j] * (P + 1);
            slot[j] = x[j] & 0xFFFFu;
            // read now, used next row: off this row's chain
            next[j] = index_ring[((t + 1) % kIndexSlots) * kMaxLanes
                                 + lane[j]];
        }
        fetch_indexes(t + kIndexAhead);      // into row t - 1's slot
        search_rows<LPT>(table, row, slot, P, s);
        // renorm reads: flagged lanes take consecutive words in ascending
        // lane order (exclusive prefix count of the flags)
        int total = 0;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const uint32_t start = (uint32_t)table[row[j] + s[j]];
            const uint32_t freq = (uint32_t)table[row[j] + s[j] + 1] - start;
            uint32_t nx = freq * (x[j] >> 16) + slot[j] - start;
            const bool flag = active[j] && (nx >> 16) == 0u;
            const unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag);
            int before = total + __popc(ballot & below);
            if constexpr (ONE_WARP) {
                total += __popc(ballot);
            } else {
                if (wl == 0) warp_count[t & 1][warp] = __popc(ballot);
                __syncthreads();
                for (int w = 0; w < warps; ++w) {
                    const int c = warp_count[t & 1][w];
                    if (w < warp) before += c;
                    total += c;
                }
            }
            if (flag) {
                const uint32_t word = (uint32_t)ring[
                    (ptr + before) & (kRingWords - 1)] & 0xFFFFu;
                nx = (nx << 16) | word;
            }
            if (active[j]) x[j] = nx;
            if (lane_ok[j])
                values[(long long)t * N + lane[j]] =
                    active[j] ? s[j] + offs[id[j]] : 0;
        }
        // every lane is past the rows before this one (and, one warp, past
        // this row's reads), and this row reads at ptr or after it: the
        // chunks below ptr's are free
        const long long free_to = ptr / kRingChunk + kRingChunks;
        if (issued < free_to) {
            if constexpr (ONE_WARP) __syncwarp();
            while (issued < free_to) issue_chunk();
        }
        cp_async_commit();
        ptr += total;
#pragma unroll
        for (int j = 0; j < LPT; ++j) index[j] = next[j];
    }
    cp_async_wait<0>();                // no copy outlives the block
#pragma unroll
    for (int j = 0; j < LPT; ++j)
        if (lane_ok[j]) states_out[lane[j]] = (int)x[j];
    if (tid == 0) ptr_out[img] = (int)ptr;
}

// Replaces lvae_tpu/ops/pallas/rans_encode.py:217 rans_encode_all (the
// Pallas _encode_kernel) and, launched with one block per image,
// rans_encode.py:419 rans_encode_all_multi (_encode_kernel_multi). Encodes
// all rows of an image in reverse row order from states 2^16; block b
// encodes image b: its (T, N) symbols and indexes at b*T*N, its pairs at
// b*pair_cap (int32 elements), its word count at b and states at b*N; the
// row lengths are shared. Words go out in push order (lane-descending inside
// each reversed row) into the u16 view of a zero-filled pair buffer; words
// past w_cap are counted but not written, so the caller detects the overflow
// from n_words. Native u32 division replaces the TPU's f32 long division.
__global__ void __launch_bounds__(kMaxLanes)
rans_encode_all_kernel(const int* __restrict__ syms,
                       const int* __restrict__ indexes,
                       const int* __restrict__ row_n, int T, int N,
                       const int* __restrict__ cdfs, int S, int L,
                       uint16_t* __restrict__ words, long long pair_cap,
                       long long w_cap, int* __restrict__ n_words,
                       int* __restrict__ states_out) {
    __shared__ int warp_count[2][kMaxWarps];
    const int img = blockIdx.x;
    const long long rows = (long long)T * N;
    syms += img * rows;
    indexes += img * rows;
    words += 2 * img * pair_cap;
    states_out += (long long)img * N;
    const int lane = threadIdx.x;
    const int warp = lane / kWarp, wl = lane % kWarp;
    const int nwarps = blockDim.x / kWarp;
    const bool lane_ok = lane < N;
    const unsigned above = wl == kWarp - 1 ? 0u : (0xFFFFFFFFu << (wl + 1));
    uint32_t x = 1u << 16;
    long long end = 0;

    for (int t = T - 1; t >= 0; --t) {
        const bool active = lane_ok && lane < row_n[t];
        uint32_t start = 0u, freq = 1u;
        if (active) {
            const long long pos = (long long)t * N + lane;
            const int id = min(max(indexes[pos], 0), S - 1);
            const int s = min(max(syms[pos], 0), L - 2);
            const int* row = cdfs + (long long)id * L;
            start = (uint32_t)__ldg(row + s);
            freq = (uint32_t)__ldg(row + s + 1) - start;
        }
        const bool flag = active && (x >> 16) >= freq;
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag);
        if (wl == 0) warp_count[t & 1][warp] = __popc(ballot);
        __syncthreads();
        int after = 0, total = 0;
        for (int w = 0; w < nwarps; ++w) {
            const int c = warp_count[t & 1][w];
            total += c;
            if (w > warp) after += c;
        }
        if (flag) {
            const long long p = end + after + __popc(ballot & above);
            if (p < w_cap) words[p] = (uint16_t)(x & 0xFFFFu);
            x >>= 16;
        }
        if (active) x = ((x / freq) << 16) + x % freq + start;
        end += total;
    }
    if (lane_ok) states_out[lane] = (int)x;
    if (lane == 0) n_words[img] = (int)end;
}

int threads_for(int N) { return ((N + kWarp - 1) / kWarp) * kWarp; }

int check_args(int B, int T, int N, int S, int L, int device) {
    if (B < 1 || N < 1 || N > kMaxLanes || T < 1 || S < 1 || L < 2)
        return (int)cudaErrorInvalidValue;
    return (int)cudaSetDevice(device);
}

// The decode kernel's launch: `threads` a block, the padded row length P (the
// least power of 4 >= L, at least 256), the shared memory (the two rings, the
// table, the offsets) and the opt-in to the device's limit, once per device
// and kernel. A table that does not fit the device's opt-in limit is refused
// (cudaErrorInvalidValue): the kernel has no path that reads the table from
// global memory.
template <int LPT, bool ONE_WARP>
int launch_decode(int threads, const void* indexes, int B, int T, int N,
                  const void* states_in, void* states_out,
                  const void* ptrs_in, void* ptrs_out, const void* streams,
                  long long W, const void* cdfs, int S, int L,
                  const void* offsets, long long nsym, void* values,
                  int device, cudaStream_t stream) {
    long long P = 256;
    while (P < L) P <<= 2;
    const long long smem =
        4LL * (kRingWords + kIndexSlots * kMaxLanes + S * (P + 1) + S);
    static int optin[64];
    if (device >= 64) return (int)cudaErrorInvalidDevice;
    if (optin[device] == 0) {
        int limit;
        cudaError_t err = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                rans_decode_block_kernel<LPT, ONE_WARP>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                limit - (int)sizeof(int) * 2 * kMaxWarps);
        if (err != cudaSuccess) return (int)err;
        optin[device] = limit - (int)sizeof(int) * 2 * kMaxWarps;
    }
    if (smem > optin[device]) return (int)cudaErrorInvalidValue;
    rans_decode_block_kernel<LPT, ONE_WARP><<<B, threads, (size_t)smem,
                                              stream>>>(
        (const int*)indexes, T, N, (const int*)states_in, (int*)states_out,
        (const int*)ptrs_in, (int*)ptrs_out, (const int*)streams, W,
        (const int*)cdfs, S, L, (int)P, (const int*)offsets, nsym,
        (int*)values);
    return (int)cudaGetLastError();
}

}  // namespace

// B images' decode of one latent block (B = 1: rans_decode_block's
// (1, N) states and 0-dim pointer). Shapes as documented at the kernel.
extern "C" int rans_decode_block_multi(
        const void* indexes, int B, int T, int N, const void* states_in,
        void* states_out, const void* ptrs_in, void* ptrs_out,
        const void* streams, long long W, const void* cdfs, int S, int L,
        const void* offsets, long long nsym, void* values, int device,
        void* cuda_stream) {
    const int err = check_args(B, T, N, S, L, device);
    if (err != 0) return err;
    // one warp of a lane a thread up to 32 lanes, of two up to 64; above, a
    // warp per 32 lanes
    auto launch = N <= kWarp ? launch_decode<1, true>
                : N <= 2 * kWarp ? launch_decode<2, true>
                : launch_decode<1, false>;
    return launch(N <= 2 * kWarp ? kWarp : threads_for(N), indexes, B, T, N,
                  states_in, states_out, ptrs_in, ptrs_out, streams, W, cdfs,
                  S, L, offsets, nsym, values, device,
                  (cudaStream_t)cuda_stream);
}

extern "C" int rans_decode_block(const void* indexes, int T, int N,
                                 const void* states_in, void* states_out,
                                 const void* ptr_in, void* ptr_out,
                                 const void* stream, long long W,
                                 const void* cdfs, int S, int L,
                                 const void* offsets, long long nsym,
                                 void* values, int device,
                                 void* cuda_stream) {
    return rans_decode_block_multi(indexes, 1, T, N, states_in, states_out,
                                   ptr_in, ptr_out, stream, W, cdfs, S, L,
                                   offsets, nsym, values, device,
                                   cuda_stream);
}

// B images' encode (B = 1: rans_encode_all); `pairs` holds B regions of
// pair_cap int32 elements, zero-filled by the caller.
extern "C" int rans_encode_all_multi(
        const void* syms, const void* indexes, const void* row_n, int B,
        int T, int N, const void* cdfs, int S, int L, void* pairs,
        long long pair_cap, long long w_cap, void* n_words, void* states_out,
        int device, void* cuda_stream) {
    const int err = check_args(B, T, N, S, L, device);
    if (err != 0) return err;
    if (2 * pair_cap < w_cap) return (int)cudaErrorInvalidValue;
    rans_encode_all_kernel<<<B, threads_for(N), 0,
                             (cudaStream_t)cuda_stream>>>(
        (const int*)syms, (const int*)indexes, (const int*)row_n, T, N,
        (const int*)cdfs, S, L, (uint16_t*)pairs, pair_cap, w_cap,
        (int*)n_words, (int*)states_out);
    return (int)cudaGetLastError();
}

extern "C" int rans_encode_all(const void* syms, const void* indexes,
                               const void* row_n, int T, int N,
                               const void* cdfs, int S, int L, void* pairs,
                               long long pair_cap, long long w_cap,
                               void* n_words, void* states_out, int device,
                               void* cuda_stream) {
    return rans_encode_all_multi(syms, indexes, row_n, 1, T, N, cdfs, S, L,
                                 pairs, pair_cap, w_cap, n_words,
                                 states_out, device, cuda_stream);
}
