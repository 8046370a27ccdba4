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
// barrier. Encode is a chain too, but only of each lane's own state: a
// row's (start, freq) depends on its (index, symbol) alone, and a word's
// position on the other lanes' flags alone. So the encode runs as four
// launches: a parallel lookup of every row's (start, freq); the chains, one
// thread a lane and no barrier, each fetching its rows kChainAhead ahead;
// a scan of the rows' word counts; and a parallel placement of the words.
// The first encode kernel (rans_encode_rowsync_kernel: one block of N
// threads an image, CDF rows read on the chain, one block barrier a row)
// stays as the oracle the card checks hold the new one against. The
// multi-image entry points launch the same kernels over B images, so that B
// images' chains run side by side on other SMs.

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

// The first encode kernel, kept as the oracle of the four-phase encode
// below (entry points rans_encode_all_rowsync and
// rans_encode_all_multi_rowsync; off the main path). Encodes all rows of an
// image in reverse row order from states 2^16; block b encodes image b: its
// (T, N) symbols and indexes at b*T*N, its pairs at b*pair_cap (int32
// elements), its word count at b and states at b*N; the row lengths are
// shared. Words go out in push order (lane-descending inside each reversed
// row) into the u16 view of a zero-filled pair buffer; words past w_cap are
// counted but not written, so the caller detects the overflow from n_words.
// Native u32 division replaces the TPU's f32 long division. Each row loads
// its index and symbol, then the CDF row they pick, and waits at a block
// barrier for the warps' counts: ~610-880 ns a row on an H100.
__global__ void __launch_bounds__(kMaxLanes)
rans_encode_rowsync_kernel(const int* __restrict__ syms,
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

// ---- the encode: lookup, chains, scan, placement ---------------------------
//
// Replaces lvae_tpu/ops/pallas/rans_encode.py:217 rans_encode_all (the
// Pallas _encode_kernel) and rans_encode.py:419 rans_encode_all_multi
// (_encode_kernel_multi); byte for byte equal to rans_encode_rowsync_kernel
// (pairs, n_words, states) on every input. Bound: the bytes take ~1.6 us an
// image at 3.35 TB/s, the chain of a lane's T dependent rows takes T times
// one row's arithmetic (the flag, then the state update): the chain is the
// bound. The TPU kernel's byte-split one-hot gathers and f32 long division
// exist only for the MXU and the VPU. Four launches over B images, in
// stream order:
// 1. rans_encode_lookup_kernel, parallel over (b, t, lane): each symbol's
//    coding parameters (coding_params) from its clamped index and symbol,
//    into a (B, T, N) scratch;
// 2. rans_encode_chain_kernel, a block of one warp per 32 lanes of an
//    image: each lane's chain in reverse row order from 2^16, with no
//    block barrier and nothing shared between warps. Each lane copies its
//    own parameters into a shared-memory ring with cp.async kChainAhead - 1
//    rows before the row that codes them, and reads them into registers a
//    row before that row; so the state update waits on no load. A flagged
//    lane writes its word into a dense (B, T, N) u16 scratch, the warp its
//    ballot into a (B, T, ceil(N/32)) scratch; at the end each lane writes
//    its state;
// 3. rans_encode_scan_kernel, one block an image: each row's word count
//    (the popcounts of its ballots), scanned in push order (row T-1 first)
//    into the rows' first positions; the total is n_words;
// 4. rans_encode_place_kernel, parallel over (b, t, lane): a flagged lane's
//    word goes to its row's first position + the flagged lanes above it in
//    the row (push order is lane-descending), if that is below w_cap.
constexpr int kChainAhead = 32;     // the chain's ring: rows in flight + 1
constexpr int kGridThreads = 256;   // blocks of the lookup and placement
constexpr int kGridBlocks = 1024;   // their blocks an image, at most
constexpr int kScanThreads = 1024;
constexpr int kScanRows = 8;        // rows a scan thread holds per tile
static_assert((kChainAhead & (kChainAhead - 1)) == 0, "");
static_assert(kGridThreads >= 2 * kMaxLanes, "two rows a block at least");
static_assert(kScanThreads / kWarp == kWarp, "one warp scans the warps");

// 16-byte cp.async into shared memory, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// A symbol's coding parameters for the chain: start, freq, and for the
// division of a state xs by freq, rcp = floor((2^32 - 1) / freq) and k =
// 2^16 - freq (mod 2^32). q0 = umulhi(xs, rcp) is floor(xs / freq) or one
// less, so q = q0 + (xs - q0 * freq >= freq), and the state update
// ((xs / freq) << 16) + xs % freq + start is q * k + xs + start (mod 2^32).
// freq 0 (a table past its rows) takes the native division's result,
// xs / 0 = 2^32 - 1 and xs % 0 = xs: rcp 0 and k = 2^32 - 2^16 give that.
// An inactive lane is (0, 2^32 - 1, 0, 0): no flag, the state unchanged.
__device__ __forceinline__ uint4 coding_params(uint32_t start,
                                               uint32_t freq) {
    return freq == 0u ? make_uint4(start, 0u, 0u, 0xFFFF0000u)
                      : make_uint4(start, freq, 0xFFFFFFFFu / freq,
                                   (1u << 16) - freq);
}

// The lookup and the placement run on a (B, blocks) grid: blockIdx.x is
// the image, a block covers kGridThreads / N rows of it, a thread a lane.
__global__ void __launch_bounds__(kGridThreads)
rans_encode_lookup_kernel(const int* __restrict__ syms,
                          const int* __restrict__ indexes,
                          const int* __restrict__ row_n, int T, int N,
                          const int* __restrict__ cdfs, int S, int L,
                          uint4* __restrict__ params) {
    const int rpb = kGridThreads / N;
    const int lane = (int)threadIdx.x % N;
    if ((int)threadIdx.x >= rpb * N) return;
    for (int t = blockIdx.y * rpb + (int)threadIdx.x / N; t < T;
         t += gridDim.y * rpb) {
        const long long e = ((long long)blockIdx.x * T + t) * N + lane;
        uint4 v = make_uint4(0u, 0xFFFFFFFFu, 0u, 0u);
        if (lane < __ldg(row_n + t)) {
            const int id = min(max(__ldg(indexes + e), 0), S - 1);
            const int s = min(max(__ldg(syms + e), 0), L - 2);
            const int* row = cdfs + (long long)id * L;
            const uint32_t start = (uint32_t)__ldg(row + s);
            v = coding_params(start, (uint32_t)__ldg(row + s + 1) - start);
        }
        params[e] = v;
    }
}

// REGISTERS_ONLY (the chain's bound, timed by the card checks): every row
// codes the top row's parameters, held in registers, and nothing is stored
// but the states: the rows' arithmetic alone. `params` has kChainAhead rows
// of N before image 0's rows, so that a chain may fetch past its row 0
// (values never used).
template <bool REGISTERS_ONLY>
__global__ void __launch_bounds__(kWarp)
rans_encode_chain_kernel(const uint4* __restrict__ params, int T, int N,
                         int nw, uint16_t* __restrict__ dense,
                         unsigned* __restrict__ ballots,
                         int* __restrict__ states_out) {
    __shared__ uint4 ring[kChainAhead][kWarp];
    const int img = blockIdx.x / nw, warp = blockIdx.x % nw;
    const int wl = threadIdx.x, lane = warp * kWarp + wl;
    const bool lane_ok = lane < N;
    const long long rows = (long long)T * N;
    // row T-1's parameters, then a row back a row (lanes past N read lane
    // 0's and never flag); row t's word and ballot, also a row back a row
    const uint4* next = params + img * rows + (long long)(T - 1) * N
                        + (lane_ok ? lane : 0);
    uint16_t* word = dense + img * rows + (long long)(T - 1) * N + lane;
    unsigned* ballot_out = ballots + ((long long)img * T + T - 1) * nw + warp;
    auto slot = [&](int t) -> uint4& { return ring[t & (kChainAhead - 1)][wl]; };
    auto fetch = [&](int t) {            // row t's copy, one commit group
        cp_async16(&slot(t), next);
        next -= N;
        cp_async_commit();
    };
    uint32_t x = 1u << 16;
    auto code = [&](uint4 v) {
        const bool flag = lane_ok && (x >> 16) >= v.y;
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag);
        if constexpr (!REGISTERS_ONLY) {
            if (flag) *word = (uint16_t)(x & 0xFFFFu);
            *ballot_out = ballot;          // every lane: one address, value
            word -= N;
            ballot_out -= nw;
        }
        const uint32_t xs = flag ? x >> 16 : x;
        const uint32_t q0 = __umulhi(xs, v.z);
        x = (q0 + (xs - q0 * v.y >= v.y ? 1u : 0u)) * v.w + (xs + v.x);
    };
    uint4 v;                                 // the row being coded
    if constexpr (REGISTERS_ONLY) {
        v = __ldg(next);
        for (int t = T - 1; t >= 0; --t) code(v);
    } else {
        for (int t = T - 1; t > T - kChainAhead; --t) fetch(t);
        cp_async_wait<kChainAhead - 2>();    // row T-1's group
        v = slot(T - 1);
#pragma unroll 4
        for (int t = T - 1; t >= 0; --t) {
            // into row t + 1's slot, read a row ago
            fetch(t - kChainAhead + 1);
            // row t - 1's group (then kChainAhead - 2 newer ones)
            cp_async_wait<kChainAhead - 2>();
            const uint4 v_next = slot(t - 1);
            code(v);
            v = v_next;
        }
        cp_async_wait<0>();                  // no copy outlives the block
    }
    if (lane_ok) states_out[(long long)img * N + lane] = (int)x;
}

// Row r's first word position, r in push order, per tile of kScanThreads *
// kScanRows rows: each thread sums its kScanRows rows' counts, a warp scan
// and a scan of the warps' totals give its exclusive prefix.
__global__ void __launch_bounds__(kScanThreads)
rans_encode_scan_kernel(const unsigned* __restrict__ ballots, int T, int nw,
                        long long* __restrict__ base,
                        int* __restrict__ n_words) {
    __shared__ int warp_incl[kWarp];
    const int img = blockIdx.x, tid = threadIdx.x;
    const int warp = tid / kWarp, wl = tid % kWarp;
    ballots += (long long)img * T * nw;
    base += (long long)img * T;
    auto warp_scan = [&](int v) {         // inclusive
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
            const int up = __shfl_up_sync(0xFFFFFFFFu, v, d);
            if (wl >= d) v += up;
        }
        return v;
    };
    long long carry = 0;
    for (long long p0 = 0; p0 < T; p0 += kScanThreads * kScanRows) {
        int count[kScanRows], sum = 0;
#pragma unroll
        for (int k = 0; k < kScanRows; ++k) {
            const long long p = p0 + (long long)tid * kScanRows + k;
            count[k] = 0;
            if (p < T) {
                const unsigned* b = ballots + (T - 1 - p) * nw;
                for (int w = 0; w < nw; ++w) count[k] += __popc(__ldg(b + w));
            }
            sum += count[k];
        }
        const int incl = warp_scan(sum);
        if (wl == kWarp - 1) warp_incl[warp] = incl;
        __syncthreads();
        if (warp == 0) warp_incl[wl] = warp_scan(warp_incl[wl]);
        __syncthreads();
        long long pos = carry + (warp > 0 ? warp_incl[warp - 1] : 0)
                        + incl - sum;
#pragma unroll
        for (int k = 0; k < kScanRows; ++k) {
            const long long p = p0 + (long long)tid * kScanRows + k;
            if (p < T) base[T - 1 - p] = pos;
            pos += count[k];
        }
        carry += warp_incl[kWarp - 1];
        __syncthreads();                 // warp_incl is rewritten next tile
    }
    if (tid == 0) n_words[img] = (int)carry;
}

__global__ void __launch_bounds__(kGridThreads)
rans_encode_place_kernel(const uint16_t* __restrict__ dense,
                         const unsigned* __restrict__ ballots,
                         const long long* __restrict__ base, int T, int N,
                         int nw, uint16_t* __restrict__ words,
                         long long pair_cap, long long w_cap) {
    const int rpb = kGridThreads / N;
    const int lane = (int)threadIdx.x % N;
    const int w = lane / kWarp, bit = lane % kWarp;
    if ((int)threadIdx.x >= rpb * N) return;
    words += 2 * (long long)blockIdx.x * pair_cap;
    for (int t = blockIdx.y * rpb + (int)threadIdx.x / N; t < T;
         t += gridDim.y * rpb) {
        const long long r = (long long)blockIdx.x * T + t;
        const unsigned* b = ballots + r * nw;
        const unsigned mine = __ldg(b + w);
        if (!((mine >> bit) & 1u)) continue;
        long long p = __ldg(base + r) + __popc(
            bit == kWarp - 1 ? 0u : mine & (0xFFFFFFFFu << (bit + 1)));
        for (int u = w + 1; u < nw; ++u) p += __popc(__ldg(b + u));
        if (p < w_cap) words[p] = __ldg(dense + r * N + lane);
    }
}

// The encode's scratch, carved from one buffer the caller allocates: every
// symbol's coding parameters (after kChainAhead rows of padding), the rows'
// first positions, the ballots, the words.
struct EncodeScratch {
    uint4* params;
    long long* base;
    unsigned* ballots;
    uint16_t* dense;
    int nw;

    static long long bytes(int B, int T, int N) {
        const long long syms = (long long)B * T * N, rows = (long long)B * T;
        return 16LL * kChainAhead * N + 18 * syms
               + rows * (8 + 4LL * ((N + kWarp - 1) / kWarp));
    }
    EncodeScratch(void* p, int B, int T, int N)
        : nw((N + kWarp - 1) / kWarp) {
        const long long syms = (long long)B * T * N, rows = (long long)B * T;
        char* c = (char*)p + 16LL * kChainAhead * N;
        params = (uint4*)c;
        base = (long long*)(c += 16 * syms);
        ballots = (unsigned*)(c += 8 * rows);
        dense = (uint16_t*)(c + 4 * rows * nw);
    }
};

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

// The bytes of the scratch the encode entry points take for B images of
// (T, N) rows.
extern "C" long long rans_encode_scratch_bytes(int B, int T, int N) {
    return EncodeScratch::bytes(B, T, N);
}

// B images' encode (B = 1: rans_encode_all); `pairs` holds B regions of
// pair_cap int32 elements, zero-filled by the caller; `scratch` holds at
// least rans_encode_scratch_bytes(B, T, N) bytes. The four launches of the
// encode, each checked as it is made.
extern "C" int rans_encode_all_multi(
        const void* syms, const void* indexes, const void* row_n, int B,
        int T, int N, const void* cdfs, int S, int L, void* pairs,
        long long pair_cap, long long w_cap, void* n_words, void* states_out,
        void* scratch, long long scratch_bytes, int device,
        void* cuda_stream) {
    int err = check_args(B, T, N, S, L, device);
    if (err != 0) return err;
    if (2 * pair_cap < w_cap
            || scratch_bytes < EncodeScratch::bytes(B, T, N))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t stream = (cudaStream_t)cuda_stream;
    const EncodeScratch sc(scratch, B, T, N);
    const int rpb = kGridThreads / N;
    const int blocks = (T + rpb - 1) / rpb;
    const dim3 grid(B, blocks < kGridBlocks ? blocks : kGridBlocks);
    rans_encode_lookup_kernel<<<grid, kGridThreads, 0, stream>>>(
        (const int*)syms, (const int*)indexes, (const int*)row_n, T, N,
        (const int*)cdfs, S, L, sc.params);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    rans_encode_chain_kernel<false><<<B * sc.nw, kWarp, 0, stream>>>(
        sc.params, T, N, sc.nw, sc.dense, sc.ballots, (int*)states_out);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    rans_encode_scan_kernel<<<B, kScanThreads, 0, stream>>>(
        sc.ballots, T, sc.nw, sc.base, (int*)n_words);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    rans_encode_place_kernel<<<grid, kGridThreads, 0, stream>>>(
        sc.dense, sc.ballots, sc.base, T, N, sc.nw, (uint16_t*)pairs,
        pair_cap, w_cap);
    return (int)cudaGetLastError();
}

extern "C" int rans_encode_all(const void* syms, const void* indexes,
                               const void* row_n, int T, int N,
                               const void* cdfs, int S, int L, void* pairs,
                               long long pair_cap, long long w_cap,
                               void* n_words, void* states_out, void* scratch,
                               long long scratch_bytes, int device,
                               void* cuda_stream) {
    return rans_encode_all_multi(syms, indexes, row_n, 1, T, N, cdfs, S, L,
                                 pairs, pair_cap, w_cap, n_words, states_out,
                                 scratch, scratch_bytes, device, cuda_stream);
}

// The encode's chain phase alone, on a scratch that rans_encode_all_multi
// filled for the same (B, T, N): rewrites the same words, ballots and
// states. registers_only: the chain's bound (rans_encode_chain_kernel). For
// the card checks' timings only.
extern "C" int rans_encode_chain_multi(int B, int T, int N, void* scratch,
                                       long long scratch_bytes,
                                       void* states_out, int registers_only,
                                       int device, void* cuda_stream) {
    const int err = check_args(B, T, N, 1, 2, device);    // no table here
    if (err != 0) return err;
    if (scratch_bytes < EncodeScratch::bytes(B, T, N))
        return (int)cudaErrorInvalidValue;
    const EncodeScratch sc(scratch, B, T, N);
    auto kernel = registers_only ? rans_encode_chain_kernel<true>
                                 : rans_encode_chain_kernel<false>;
    kernel<<<B * sc.nw, kWarp, 0, (cudaStream_t)cuda_stream>>>(
        sc.params, T, N, sc.nw, sc.dense, sc.ballots, (int*)states_out);
    return (int)cudaGetLastError();
}

// The row-sync oracle: B images' encode, one block an image; the
// arguments of rans_encode_all_multi without the scratch.
extern "C" int rans_encode_all_multi_rowsync(
        const void* syms, const void* indexes, const void* row_n, int B,
        int T, int N, const void* cdfs, int S, int L, void* pairs,
        long long pair_cap, long long w_cap, void* n_words, void* states_out,
        int device, void* cuda_stream) {
    const int err = check_args(B, T, N, S, L, device);
    if (err != 0) return err;
    if (2 * pair_cap < w_cap) return (int)cudaErrorInvalidValue;
    rans_encode_rowsync_kernel<<<B, threads_for(N), 0,
                                 (cudaStream_t)cuda_stream>>>(
        (const int*)syms, (const int*)indexes, (const int*)row_n, T, N,
        (const int*)cdfs, S, L, (uint16_t*)pairs, pair_cap, w_cap,
        (int*)n_words, (int*)states_out);
    return (int)cudaGetLastError();
}

extern "C" int rans_encode_all_rowsync(
        const void* syms, const void* indexes, const void* row_n, int T,
        int N, const void* cdfs, int S, int L, void* pairs,
        long long pair_cap, long long w_cap, void* n_words, void* states_out,
        int device, void* cuda_stream) {
    return rans_encode_all_multi_rowsync(syms, indexes, row_n, 1, T, N, cdfs,
                                         S, L, pairs, pair_cap, w_cap,
                                         n_words, states_out, device,
                                         cuda_stream);
}
