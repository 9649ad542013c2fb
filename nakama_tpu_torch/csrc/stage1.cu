// Stage-1 prefilter of the two-stage matchmaker scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nakama_tpu/matchmaker/device2.py:302
// (`_stage1_call`, body `_stage1_kernel` at :175). The Hopper kernels
// (csrc/stage1_wgmma.cu, csrc/stage1_select.cu) take every shape that fits
// their shared memory; this one keeps the rest (device2.stage1_route):
// embeddings wider than 128, and m above what stage1_select.cu's kept lists
// fit (209 under rev with E = 128 to 369 without flags; k = 256 on a
// one-block pool gives m = 512).
//
// What it computes, for every active row i and pool column j:
//   eligible  = uq_i . vv_j > F - 0.5   (and uv_i . vq_j > F - 0.5 under rev)
//   prio      = 4096 - ((row_mix_i ^ col_mix_j) & 255)
//               [+ trunc(clip(ue_i . ve_j * emb_scale, +-4095)), clipped to
//                [0, 8191], when embeddings score]
//   word      = eligible && col_gidx_j != row_slot_i
//               ? (prio << 18) | col_gidx_j : INT32_MIN
// and, for each row and each `bn`-column block (the selection block is part
// of the result: winners are per 1024-column block), the block's top-m
// words in descending order, written to out[i, b*m .. b*m+m).
//
// Bound: the eligibility product is 2*A*N*D operations on 0/1 bf16 operands
// (D = 520 at the default widths); at the north-star shape that is ~1.6e13,
// ~16 ms at the H100's dense bf16 tensor-core peak, while the bytes it must
// move (~0.4 GB) take ~0.1 ms. So it is bound by operations.
//
// Design (a first, simple kernel): one thread block of 8 warps owns 32 rows
// and one whole `bn`-column block. It walks the column block in chunks of
// 128 columns; each warp computes a 16x32 piece of the chunk's 32x128
// product with WMMA bf16 fragments (fp32 accumulation, exact for 0/1
// operands: the counts are <= 41), loading both operands straight from
// global memory (L1/L2 serve the reuse). The fused epilogue turns the chunk
// into packed words in shared memory ([32][bn] int32), so the score matrix
// never reaches device memory; after the last chunk one warp per row picks
// the block's top-m words by iterated warp-wide max (words are unique per
// column, so removing the equal word removes exactly the previous winner).
// Blocks are ordered so that ~8192 consecutive rows share each column block
// in flight: their operands stay in L2 and device memory is read about once
// per row group. wgmma/TMA and int8/fp8 tensor cores are later work.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 32;          // rows per block
constexpr int CH = 128;         // columns per chunk
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int SLD = CH + 4;     // fp32 staging row stride (floats)
constexpr int COL_BITS = 18;
constexpr int PRIO_MAX = 8191;
constexpr int GROUP_ROWS = 8192;

struct Args {
    const __nv_bfloat16* uq;
    const __nv_bfloat16* vv;
    const __nv_bfloat16* uv;
    const __nv_bfloat16* vq;
    const __nv_bfloat16* ue;
    const __nv_bfloat16* ve;
    const int32_t* col_mix;
    const int32_t* col_gidx;
    const int32_t* row_mix;
    const int32_t* row_slot;
    int32_t* out;
    int dp;           // padded operand width (multiple of 16)
    int de;           // padded embedding width (multiple of 16)
    int bn;           // selection block width (multiple of CH, <= 1024)
    int m;            // winners per block
    int n_blocks;     // n / bn
    int row_blocks;   // a_pad / BM
    int group_blocks; // row blocks per L2 group
    float thr;        // F - 0.5
    float emb_scale;
    int rev;
    int with_emb;
};

// The chunk's 32 x 128 product A[row0:+32] . B[col0:+128]^T into S (fp32,
// row stride SLD). Warp w computes rows (w / 4) * 16 and columns
// (w % 4) * 32 of the chunk. A and B are row-major with row stride ld.
__device__ __forceinline__ void chunk_product(
    const __nv_bfloat16* A, const __nv_bfloat16* B, int ld, int k_tiles,
    int row0, int col0, float* S, int warp) {
    const int wr = (warp / 4) * 16;
    const int wc = (warp % 4) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
    wmma::fill_fragment(c0, 0.0f);
    wmma::fill_fragment(c1, 0.0f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0, b1;
    const __nv_bfloat16* pa = A + (size_t)(row0 + wr) * ld;
    const __nv_bfloat16* pb0 = B + (size_t)(col0 + wc) * ld;
    const __nv_bfloat16* pb1 = pb0 + (size_t)16 * ld;
    for (int kt = 0; kt < k_tiles; ++kt) {
        wmma::load_matrix_sync(a, pa + kt * 16, ld);
        wmma::load_matrix_sync(b0, pb0 + kt * 16, ld);
        wmma::load_matrix_sync(b1, pb1 + kt * 16, ld);
        wmma::mma_sync(c0, a, b0, c0);
        wmma::mma_sync(c1, a, b1, c1);
    }
    wmma::store_matrix_sync(S + wr * SLD + wc, c0, SLD, wmma::mem_row_major);
    wmma::store_matrix_sync(S + wr * SLD + wc + 16, c1, SLD, wmma::mem_row_major);
}

__global__ void __launch_bounds__(NT, 1) stage1_kernel(Args p) {
    extern __shared__ __align__(128) unsigned char smem[];
    int32_t* W = reinterpret_cast<int32_t*>(smem);         // [BM][bn]
    float* S = reinterpret_cast<float*>(W + BM * p.bn);    // [BM][SLD]
    float* S2 = S + BM * SLD;                              // rev product
    float* SE = S2 + (p.rev ? BM * SLD : 0);               // embedding product

    // Grouped order: consecutive blocks walk the row blocks of one group
    // for a fixed column block, so blocks in flight share that column
    // block's operands and the group's rows stay L2-resident.
    const int per_group = p.group_blocks * p.n_blocks;
    const int pid = blockIdx.x;
    const int first_rb = (pid / per_group) * p.group_blocks;
    const int gsize = min(p.group_blocks, p.row_blocks - first_rb);
    const int within = pid - first_rb * p.n_blocks;
    const int rb = first_rb + within % gsize;
    const int j = within / gsize;

    const int row0 = rb * BM;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int k_tiles = p.dp / 16;
    const int k_tiles_e = p.de / 16;

    for (int c = 0; c < p.bn / CH; ++c) {
        const int col0 = j * p.bn + c * CH;
        chunk_product(p.uq, p.vv, p.dp, k_tiles, row0, col0, S, warp);
        if (p.rev) chunk_product(p.uv, p.vq, p.dp, k_tiles, row0, col0, S2, warp);
        if (p.with_emb) chunk_product(p.ue, p.ve, p.de, k_tiles_e, row0, col0, SE, warp);
        __syncthreads();
        for (int e = threadIdx.x; e < BM * CH; e += NT) {
            const int r = e / CH;
            const int cc = e % CH;
            const int gr = row0 + r;
            const int gc = col0 + cc;
            bool elig = S[r * SLD + cc] > p.thr;
            if (p.rev) elig = elig && S2[r * SLD + cc] > p.thr;
            const int col = p.col_gidx[gc];
            int word = INT_MIN;
            if (elig && col != p.row_slot[gr]) {
                int prio = 4096 - ((p.row_mix[gr] ^ p.col_mix[gc]) & 255);
                if (p.with_emb) {
                    float v = SE[r * SLD + cc] * p.emb_scale;
                    v = fminf(fmaxf(v, -4095.0f), 4095.0f);
                    prio = min(max(prio + (int)v, 0), PRIO_MAX);  // (int): toward zero
                }
                word = (prio << COL_BITS) | col;
            }
            W[r * p.bn + c * CH + cc] = word;
        }
        __syncthreads();
    }

    // Top-m per row of this column block: lane l holds columns l, l+32, ...
    const int per_lane = p.bn / 32;
    const int out_w = p.n_blocks * p.m;
    for (int r = warp; r < BM; r += NWARPS) {
        int v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i)
            v[i] = i < per_lane ? W[r * p.bn + i * 32 + lane] : INT_MIN;
        int32_t* orow = p.out + (size_t)(row0 + r) * out_w + (size_t)j * p.m;
        for (int t = 0; t < p.m; ++t) {
            int best = INT_MIN;
#pragma unroll
            for (int i = 0; i < 32; ++i) best = max(best, v[i]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                best = max(best, __shfl_xor_sync(0xffffffffu, best, o));
            if (lane == 0) orow[t] = best;
            if (best == INT_MIN) {  // warp-uniform: the rest stay empty
                for (int u = t + 1 + lane; u < p.m; u += 32) orow[u] = INT_MIN;
                break;
            }
#pragma unroll
            for (int i = 0; i < 32; ++i)
                if (v[i] == best) v[i] = INT_MIN;
        }
    }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Shapes: uq/uv [a_pad, dp], vv/vq [n, dp], ue [a_pad, de], ve [n, de]
// (bf16, row-major, rows 32-byte aligned); col_mix/col_gidx [n],
// row_mix/row_slot [a_pad] (int32); out [a_pad, (n / bn) * m] int32.
// Requires a_pad % 32 == 0, bn % 128 == 0, bn <= 1024, n % bn == 0,
// dp % 16 == 0, de % 16 == 0.
extern "C" int stage1_launch(
    const void* uq, const void* vv, const void* uv, const void* vq,
    const void* ue, const void* ve, const void* col_mix,
    const void* col_gidx, const void* row_mix, const void* row_slot,
    void* out, int a_pad, int n, int dp, int de, int bn, int m, float thr,
    float emb_scale, int rev, int with_emb, void* stream) {
    Args p;
    p.uq = static_cast<const __nv_bfloat16*>(uq);
    p.vv = static_cast<const __nv_bfloat16*>(vv);
    p.uv = static_cast<const __nv_bfloat16*>(uv);
    p.vq = static_cast<const __nv_bfloat16*>(vq);
    p.ue = static_cast<const __nv_bfloat16*>(ue);
    p.ve = static_cast<const __nv_bfloat16*>(ve);
    p.col_mix = static_cast<const int32_t*>(col_mix);
    p.col_gidx = static_cast<const int32_t*>(col_gidx);
    p.row_mix = static_cast<const int32_t*>(row_mix);
    p.row_slot = static_cast<const int32_t*>(row_slot);
    p.out = static_cast<int32_t*>(out);
    p.dp = dp;
    p.de = de;
    p.bn = bn;
    p.m = m;
    p.n_blocks = n / bn;
    p.row_blocks = a_pad / BM;
    p.group_blocks = GROUP_ROWS / BM;
    p.thr = thr;
    p.emb_scale = emb_scale;
    p.rev = rev;
    p.with_emb = with_emb;
    const int n_stage = 1 + (rev ? 1 : 0) + (with_emb ? 1 : 0);
    const size_t smem = (size_t)BM * bn * 4 + (size_t)n_stage * BM * SLD * 4;
    cudaError_t err = cudaFuncSetAttribute(
        stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)p.row_blocks * p.n_blocks;
    stage1_kernel<<<(unsigned)blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}
