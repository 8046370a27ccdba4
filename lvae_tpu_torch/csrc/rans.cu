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
// Simple by design: one thread block of N threads per image (one lane per
// thread, N in {16, 32, 64, 128}), a loop over the rows, CDF rows read straight
// from device memory through the L1 cache. Each row depends on the previous
// one through the lane states and the word pointer, so the serial chain of T
// rows, each a few dependent loads plus one block barrier, bounds both kernels
// on this card; the bytes they move (~5 MB per qarv_base 512x768 image) take
// ~1.5 us at 3.35 TB/s and do not. The multi-image entry points launch the
// same kernels with one block per image (grid = B), so that B images' chains
// run side by side on B SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 128;
constexpr int kWarp = 32;
constexpr int kMaxWarps = kMaxLanes / kWarp;

// Largest s with row[s] <= slot. row[0] == 0 <= slot, and the row is strictly
// increasing up to its length and sentinel-padded (1 << 17) after it, so this
// equals the TPU kernel's "#(row <= slot) - 1".
__device__ __forceinline__ int search_row(const int* __restrict__ row, int L,
                                          uint32_t slot) {
    int lo = 0, hi = L;  // row[lo] <= slot < row[hi], with row[L] = +inf
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if ((uint32_t)__ldg(row + mid) <= slot) lo = mid; else hi = mid;
    }
    return lo;
}

// Replaces lvae_tpu/ops/pallas/rans_decode.py:160 rans_decode_block (the
// Pallas _decode_kernel) and, launched with one block per image,
// rans_decode.py:359 rans_decode_block_multi (_decode_kernel_multi, which
// stacks B images' states on the TPU's sublanes). Decodes one latent block of
// T rows; block b decodes image b: its (T, N) indexes and values at b*T*N,
// its states at b*N, its word pointer at b, its stream at row b of a (B, W)
// array (words past W read as 0). The TPU kernels' byte-split one-hot
// matmuls and 2048-word windows exist only for the MXU; here a thread does a
// binary search over its CDF row and reads its word directly. Lanes at
// t*N + lane >= nsym keep their state and write 0.
__global__ void __launch_bounds__(kMaxLanes)
rans_decode_block_kernel(const int* __restrict__ indexes, int T, int N,
                         const int* __restrict__ states_in,
                         int* __restrict__ states_out,
                         const int* __restrict__ ptr_in,
                         int* __restrict__ ptr_out,
                         const int* __restrict__ stream, long long W,
                         const int* __restrict__ cdfs, int S, int L,
                         const int* __restrict__ offsets, long long nsym,
                         int* __restrict__ values) {
    __shared__ int warp_count[2][kMaxWarps];
    const int img = blockIdx.x;
    const long long rows = (long long)T * N;
    indexes += img * rows;
    values += img * rows;
    states_in += (long long)img * N;
    states_out += (long long)img * N;
    stream += img * W;
    const int lane = threadIdx.x;
    const int warp = lane / kWarp, wl = lane % kWarp;
    const int nwarps = blockDim.x / kWarp;
    const bool lane_ok = lane < N;
    const unsigned below = (1u << wl) - 1u;
    uint32_t x = lane_ok ? (uint32_t)states_in[lane] : 0u;
    long long ptr = ptr_in[img];

    for (int t = 0; t < T; ++t) {
        const long long pos = (long long)t * N + lane;
        const bool active = lane_ok && pos < nsym;
        uint32_t nx = 0u;
        int value = 0;
        if (active) {
            const int id = min(max(indexes[pos], 0), S - 1);
            const int* row = cdfs + (long long)id * L;
            const uint32_t slot = x & 0xFFFFu;
            const int s = search_row(row, L, slot);
            const uint32_t start = (uint32_t)__ldg(row + s);
            const uint32_t freq = (uint32_t)__ldg(row + min(s + 1, L - 1)) - start;
            nx = freq * (x >> 16) + slot - start;
            value = s + __ldg(offsets + id);
        }
        // renorm reads: flagged lanes take consecutive words in ascending
        // lane order (exclusive prefix count of the flags)
        const bool flag = active && (nx >> 16) == 0u;
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag);
        if (wl == 0) warp_count[t & 1][warp] = __popc(ballot);
        __syncthreads();
        int before = 0, total = 0;
        for (int w = 0; w < nwarps; ++w) {
            const int c = warp_count[t & 1][w];
            total += c;
            if (w < warp) before += c;
        }
        if (flag) {
            const long long p = ptr + before + __popc(ballot & below);
            const uint32_t word = p < W ? ((uint32_t)stream[p] & 0xFFFFu) : 0u;
            nx = (nx << 16) | word;
        }
        if (active) x = nx;
        if (lane_ok) values[pos] = active ? value : 0;
        ptr += total;
    }
    if (lane_ok) states_out[lane] = (int)x;
    if (lane == 0) ptr_out[img] = (int)ptr;
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
    rans_decode_block_kernel<<<B, threads_for(N), 0,
                               (cudaStream_t)cuda_stream>>>(
        (const int*)indexes, T, N, (const int*)states_in, (int*)states_out,
        (const int*)ptrs_in, (int*)ptrs_out, (const int*)streams, W,
        (const int*)cdfs, S, L, (const int*)offsets, nsym, (int*)values);
    return (int)cudaGetLastError();
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
