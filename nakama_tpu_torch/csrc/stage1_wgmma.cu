// Stage-1 prefilter of the two-stage matchmaker scan, redesigned for Hopper
// (sm_90a): int8 wgmma from TMA-staged shared memory, epilogue in registers.
//
// Replaces the Pallas TPU kernel nakama_tpu/matchmaker/device2.py:302
// (`_stage1_call`, body `_stage1_kernel` at :175), as csrc/stage1.cu does;
// this kernel takes the calls with m <= 8 winners per selection block,
// D <= 1024 and E <= 64 (every call of the main path, and the wide
// configurations: k = 128 at 32 blocks, 48 numeric and 31 string fields,
// 64-wide skill embeddings); csrc/stage1_select.cu takes every other shape
// it has a shared-memory plan for, with the same mainloop
// (stage1_hopper.cuh), and csrc/stage1.cu the shapes with none.
//
// What it computes, for every row i < a and pool column j (the same
// function as csrc/stage1.cu and device2.stage1_plain):
//   eligible  = uq_i . vv_j >= F   (and uv_i . vq_j >= F under rev)
//   prio      = 4096 - ((row_mix_i ^ col_mix_j) & 255)
//               [+ trunc(clip(ue_i . ve_j * emb_scale, +-4095)), clipped to
//                [0, 8191], when embeddings score]
//   word      = eligible && col_gidx_j != row_slot_i
//               ? (prio << 18) | col_gidx_j : INT32_MIN
// and, per row and per `bn`-column selection block, the block's top-m words
// in descending order, written to out[i, b*m .. b*m+m).
//
// Bound: the eligibility product is 2*A*N*D operations. The operands hold
// only 0 and 1 and the counts are <= F (41 at the default widths), so int8
// operands with int32 accumulation are exact, at the card's int8 rate
// (1,979 TOP/s): ~7.9 ms at the north-star shape, against ~0.1 ms for the
// bytes. So it is bound by operations. The epilogue adds ~8 integer
// operations per (row, column) pair, 1.5e10 pairs at that shape, which is
// comparable work on the integer pipes.
//
// Design:
// - Operands are int8 [rows, dp] (dp = D rounded up to 16), K-major. TMA
//   loads them in 128-byte K chunks with the 128-byte swizzle that the
//   wgmma descriptors name; D = 520 takes 5 chunks (D = 1024 takes 8), and
//   the last chunk runs only the k32 steps that hold data (544 of 640
//   columns of work at D = 520). TMA fills the part of a box past the
//   tensor's edge with zeros, so rows and columns need no padding.
// - One block per SM (a persistent grid) of two consumer warpgroups and a
//   producer warpgroup whose one thread issues every TMA load; setmaxnreg
//   moves the producer's registers to the consumers (232 each), which
//   keeps the 128 accumulator registers and the epilogue from spilling. A
//   work item is one row tile (BM rows) and a range of selection blocks.
//   The row operand of the tile stays in shared memory for the whole item
//   (160 KB at D = 520), and the column operand streams through a ring of
//   4 stages (3 under rev with embeddings) with full/empty mbarriers. The
//   host takes the 256-row tile (128 under rev) where it fits beside the
//   ring; where it does not (D > 640, or a wide embedding) it takes the
//   half tile: 128 rows in one slab per warpgroup, or under rev 64 rows
//   and one consumer warpgroup (no setmaxnreg: 256 threads have 255
//   registers each). Each column chunk is read once
//   per 256-row tile (128 under rev): 512 operations per byte of column
//   operand, against 32 for the first kernel. Items are dealt round-robin,
//   so the blocks in flight walk the same column block at the same time
//   and it stays in L2.
// - Each consumer warpgroup owns 64 rows per slab (two slabs without rev)
//   and issues m64nTNk32 s8 wgmmas; the embedding product is E/16 bf16
//   m64nTNk16 wgmmas into an fp32 accumulator (E padded to 16; each k16
//   slice is its own 32-byte-swizzled [rows][16] tile), a commit group
//   of its own before the first chunk's. The next chunk's wgmmas are in
//   flight while the previous stage is released (wait_group 1).
// - Epilogue in registers, no word buffer: each thread turns its counts
//   into packed words (word = 2^30 + col - (r8 ^ c8) without embeddings)
//   and folds them into a running top-M per row it holds (M a template
//   parameter: 1, 2, 4 or 8, the power of two >= m). At the end of a
//   selection block the four threads that share a row merge by shuffles
//   and one writes the first m words: the top m of a descending top-M is
//   its prefix, so m = 3 or 5-7 need no instantiation of their own.
// - The epilogue does not overlap the products: on the card, the time of
//   the whole kernel is the sum of its products-only and epilogue-only
//   builds (profile_stage1.py), and neither double-buffered accumulators
//   nor ping-ponged consumer warpgroups changed that (PERF.md).
// - Register budget: the accumulators take at most 128 registers a thread
//   (TN = 128 without flags at M <= 4; 64 with rev, embeddings or M = 8,
//   whose running top-8 of 4 rows takes 32 more; rev halves the row tile
//   because both row operands stay resident).

#include "stage1_hopper.cuh"

namespace {

// WIDE is the half row tile (see the design note).
template <int M, bool REV, bool EMB, bool WIDE>
struct Shape {
    static constexpr int NCW = (REV && WIDE) ? 1 : 2;       // consumer warpgroups
    static constexpr int NT = (NCW + 1) * 128;              // + a producer warpgroup
    static constexpr int SLABS = (REV || WIDE) ? 1 : 2;     // 64-row slabs per warpgroup
    static constexpr int BM = NCW * 64 * SLABS;             // rows per tile
    static constexpr int TN = (REV || EMB || M > 4) ? 64 : 128;  // columns per product tile
    static constexpr int NACC = TN / 2;                     // accumulators per slab
    static constexpr int STAGES = (REV && EMB) ? 3 : 4;     // ring stages
};

struct Layout {
    int uv, ue, stages, stage_bytes, ve, bars, total;
};

// Shared memory, from a 1024-byte aligned base: the resident row operands
// (uq, then uv under rev: kch chunks of [BM][128] each; then ue, ek
// chunks of [BM][16] bf16), the ring's stages (vv chunk [TN][128], vq
// chunk, ve as ek chunks of [TN][16] bf16), then the mbarriers.
template <int M, bool REV, bool EMB, bool WIDE>
__host__ __device__ Layout layout(int kch, int ek) {
    using S = Shape<M, REV, EMB, WIDE>;
    Layout L{};
    const int a_op = kch * S::BM * KC;
    L.uv = a_op;
    L.ue = a_op * (REV ? 2 : 1);
    L.stages = round_up(L.ue + (EMB ? ek * S::BM * EC * 2 : 0), 1024);
    L.ve = S::TN * KC * (REV ? 2 : 1);
    L.stage_bytes = round_up(L.ve + (EMB ? ek * S::TN * EC * 2 : 0), 1024);
    L.bars = L.stages + S::STAGES * L.stage_bytes;
    L.total = L.bars + (2 * S::STAGES + 2) * 8 + 1024;  // + slack to align the base
    return L;
}

// Descending running top-M: insert w, drop the smallest.
template <int M>
__device__ __forceinline__ void insert(int (&b)[M], int w) {
#pragma unroll
    for (int t = 0; t < M; ++t) {
        const int hi = max(b[t], w);
        w = min(b[t], w);
        b[t] = hi;
    }
}

// ----------------------------------------------------------------- kernel

template <int M, bool REV, bool EMB, bool WIDE>
__global__ void __launch_bounds__((Shape<M, REV, EMB, WIDE>::NT), 1)
stage1_wgmma_kernel(const __grid_constant__ Params p) {
    using S = Shape<M, REV, EMB, WIDE>;
    constexpr int NCW = S::NCW, SLABS = S::SLABS, BM = S::BM, TN = S::TN;
    constexpr int NACC = S::NACC, STAGES = S::STAGES;
    extern __shared__ uint8_t smem_raw[];
    const Layout L = layout<M, REV, EMB, WIDE>(p.kch, p.ek);
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t full0 = base + L.bars;             // full[s]  at full0 + 8 s
    const uint32_t empty0 = full0 + 8 * STAGES;       // empty[s] at empty0 + 8 s
    const uint32_t a_full = empty0 + 8 * STAGES;
    const uint32_t a_empty = a_full + 8;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, NCW * 4);
        }
        mbar_init(a_full, 1);
        mbar_init(a_empty, NCW * 4);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int a_chunk = BM * KC;
    const int col_tiles = p.bn / TN;

    if (warp >= NCW * 4) {
        // ------------------------------------------- producer warpgroup
        // Registers go to the consumers; one thread issues every load.
        if constexpr (NCW == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (warp != NCW * 4 || lane != 0) return;
        const uint32_t a_tx = (REV ? 2 : 1) * p.kch * a_chunk + (EMB ? p.ek * BM * EC * 2 : 0);
        const uint32_t b_tx = TN * KC * (REV ? 2 : 1);
        const uint32_t b_tx0 = b_tx + (EMB ? p.ek * TN * EC * 2 : 0);
        int stage = 0, phase = 0, n_a = 0;
        for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
            const int rt = item % p.rt_count;
            const int sp = item / p.rt_count;
            const int j0 = sp * p.n_blocks / p.splits;
            const int j1 = (sp + 1) * p.n_blocks / p.splits;
            if (n_a > 0) mbar_wait(a_empty, (n_a - 1) & 1);
            ++n_a;
            mbar_expect_tx(a_full, a_tx);
            for (int kc = 0; kc < p.kch; ++kc) {
                tma_load_2d(base + kc * a_chunk, &p.tm_uq, a_full, kc * KC, rt * BM);
                if (REV) tma_load_2d(base + L.uv + kc * a_chunk, &p.tm_uv, a_full, kc * KC, rt * BM);
            }
            if (EMB)
                for (int c = 0; c < p.ek; ++c)
                    tma_load_2d(base + L.ue + c * BM * EC * 2, &p.tm_ue, a_full, c * EC, rt * BM);
            for (int j = j0; j < j1; ++j) {
                for (int c = 0; c < col_tiles; ++c) {
                    const int col0 = j * p.bn + c * TN;
                    for (int kc = 0; kc < p.kch; ++kc) {
                        const uint32_t st = base + L.stages + stage * L.stage_bytes;
                        const uint32_t full = full0 + 8 * stage;
                        mbar_wait(empty0 + 8 * stage, phase ^ 1);
                        mbar_expect_tx(full, kc == 0 ? b_tx0 : b_tx);
                        tma_load_2d(st, &p.tm_vv, full, kc * KC, col0);
                        if (REV) tma_load_2d(st + TN * KC, &p.tm_vq, full, kc * KC, col0);
                        if (EMB && kc == 0)
                            for (int c = 0; c < p.ek; ++c)
                                tma_load_2d(st + L.ve + c * TN * EC * 2, &p.tm_ve, full, c * EC, col0);
                        if (++stage == STAGES) { stage = 0; phase ^= 1; }
                    }
                }
            }
        }
        return;
    }

    // ------------------------------------------- consumer warpgroups
    if constexpr (NCW == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int q = lane % 4;
    // Row (within the tile) of this thread's first accumulator row, slab 0.
    const int rbase = wg * 64 * SLABS + (warp % 4) * 16 + lane / 4;
    const int mw = M <= 2 ? M : p.m;  // words written a block: m == M below 3
    const int out_w = p.n_blocks * mw;

    int acc[SLABS][NACC];
    int accr[REV ? SLABS : 1][REV ? NACC : 1];
    float acce[EMB ? SLABS : 1][EMB ? NACC : 1];
#pragma unroll
    for (int s = 0; s < SLABS; ++s)
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[s][i] = 0;
    if constexpr (REV) {
#pragma unroll
        for (int s = 0; s < SLABS; ++s)
#pragma unroll
            for (int i = 0; i < NACC; ++i) accr[s][i] = 0;
    }
    if constexpr (EMB) {
#pragma unroll
        for (int s = 0; s < SLABS; ++s)
#pragma unroll
            for (int i = 0; i < NACC; ++i) acce[s][i] = 0.0f;
    }

    int stage = 0, phase = 0, a_phase = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int rt = item % p.rt_count;
        const int sp = item / p.rt_count;
        const int j0 = sp * p.n_blocks / p.splits;
        const int j1 = (sp + 1) * p.n_blocks / p.splits;
        const int row0 = rt * BM;

        // Per-row constants. Without embeddings the word is built in the
        // shifted domain: rkey = (row_mix & 255) << 18, rslot = slot + 2^30.
        int rkey[SLABS][2], rslot[SLABS][2];
#pragma unroll
        for (int s = 0; s < SLABS; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = row0 + rbase + s * 64 + 8 * h;
                const int rm = row < p.a ? p.row_mix[row] : 0;
                const int sl = row < p.a ? p.row_slot[row] : 0;
                rkey[s][h] = EMB ? (rm & 255) : (rm & 255) << COL_BITS;
                rslot[s][h] = EMB ? sl : (int)((uint32_t)sl + (1u << 30));
            }

        mbar_wait(a_full, a_phase);
        a_phase ^= 1;

        for (int j = j0; j < j1; ++j) {
            int best[SLABS][2][M];
#pragma unroll
            for (int s = 0; s < SLABS; ++s)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int t = 0; t < M; ++t) best[s][h][t] = INT_MIN;

            for (int c = 0; c < col_tiles; ++c) {
                const int col0 = j * p.bn + c * TN;
                int prev = 0;
                for (int kc = 0; kc < p.kch; ++kc) {
                    const uint32_t st = base + L.stages + stage * L.stage_bytes;
                    mbar_wait(full0 + 8 * stage, phase);
                    const int nks = kc + 1 < p.kch ? KC / 32 : p.last_ks;
                    const ChunkAddr ad{base + kc * a_chunk + wg * SLABS * 64 * KC, (uint32_t)L.uv,
                                       st, (uint32_t)(TN * KC), kc};
                    if constexpr (EMB)
                        if (kc == 0)
                            issue_emb_n(p.ek, base + L.ue + wg * SLABS * 64 * EC * 2, BM * EC * 2,
                                        st + L.ve, TN * EC * 2, acce);
                    issue_n<REV>(nks, ad, acc, accr);
                    if (kc > 0) {
                        // The previous chunk's wgmmas (and the embedding
                        // product, issued before chunk 0) are done.
                        wg_wait<1>();
                        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
                    }
                    prev = stage;
                    if (++stage == STAGES) { stage = 0; phase ^= 1; }
                }
                wg_wait<0>();
                if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
                for (int s = 0; s < SLABS; ++s) {
                    fence_regs(acc[s]);
                    if constexpr (REV) fence_regs(accr[s]);
                    if constexpr (EMB) fence_regs(acce[s]);
                }

                // Epilogue: accumulator i of a slab is row r + 8 * ((i / 2) % 2),
                // column 8 * (i / 4) + 2 * q + i % 2.
#pragma unroll
                for (int j8 = 0; j8 < (STAGE1_EXP == 1 ? 0 : TN / 8); ++j8) {
                    const int gc = col0 + 8 * j8 + 2 * q;
                    int cg[2], ck[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int g = __ldg(p.col_gidx + gc + e);
                        const int k = __ldg(p.col_mix + gc + e) & 255;
                        cg[e] = EMB ? g : g + (1 << 30);
                        ck[e] = EMB ? k : k << COL_BITS;
                    }
#pragma unroll
                    for (int s = 0; s < SLABS; ++s)
#pragma unroll
                        for (int h = 0; h < 2; ++h)
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int i = 4 * j8 + 2 * h + e;
                                bool ok = acc[s][i] >= p.f_int && cg[e] != rslot[s][h];
                                if constexpr (REV) ok = ok && accr[s][i] >= p.f_int;
                                int w;
                                if constexpr (EMB) {
                                    float v = acce[s][i] * p.emb_scale;
                                    v = fminf(fmaxf(v, -4095.0f), 4095.0f);
                                    int prio = 4096 - (rkey[s][h] ^ ck[e]) + (int)v;  // toward zero
                                    prio = min(max(prio, 0), PRIO_MAX);
                                    w = (prio << COL_BITS) | cg[e];
                                } else {
                                    // (4096 - x) << 18 | col == 2^30 + col - (x << 18)
                                    w = cg[e] - (rkey[s][h] ^ ck[e]);
                                }
                                insert<M>(best[s][h], ok ? w : INT_MIN);
                            }
                }
            }

            // The four threads of a row hold disjoint columns: merge, write.
#pragma unroll
            for (int s = 0; s < SLABS; ++s)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
#pragma unroll
                    for (int o = 1; o <= 2; o <<= 1) {
                        int other[M];
#pragma unroll
                        for (int t = 0; t < M; ++t)
                            other[t] = __shfl_xor_sync(0xffffffffu, best[s][h][t], o);
#pragma unroll
                        for (int t = 0; t < M; ++t) insert<M>(best[s][h], other[t]);
                    }
                    const int row = row0 + rbase + s * 64 + 8 * h;
                    if (q == 0 && row < p.a) {
                        int32_t* dst = p.out + (size_t)row * out_w + (size_t)j * mw;
#pragma unroll
                        for (int t = 0; t < M; ++t)
                            if (t < mw) dst[t] = best[s][h][t];
                    }
                }
        }
        // This warp is done reading the item's row operands.
        if (lane == 0) mbar_arrive(a_empty);
    }
}

// ------------------------------------------------------------------- host

template <int M, bool REV, bool EMB, bool WIDE>
int launch(Params& p, const Operands& o, cudaStream_t stream) {
    using S = Shape<M, REV, EMB, WIDE>;
    const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
    const CUtensorMapSwizzle sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
    bool ok = make_map(&p.tm_uq, o.uq, u8, 1, o.dp, o.a, o.dp, KC, S::BM, sw128) &&
              make_map(&p.tm_vv, o.vv, u8, 1, o.dp, o.n, o.dp, KC, S::TN, sw128);
    if (REV)
        ok = ok && make_map(&p.tm_uv, o.uv, u8, 1, o.dp, o.a, o.dp, KC, S::BM, sw128) &&
             make_map(&p.tm_vq, o.vq, u8, 1, o.dp, o.n, o.dp, KC, S::TN, sw128);
    if (EMB)
        ok = ok && make_map(&p.tm_ue, o.ue, bf, 2, o.ep, o.a, o.ep, EC, S::BM, sw32) &&
             make_map(&p.tm_ve, o.ve, bf, 2, o.ep, o.n, o.ep, EC, S::TN, sw32);
    if (!ok) return ERR_TENSOR_MAP;
    if (p.bn % S::TN != 0) return ERR_SHAPE;
    const Layout L = layout<M, REV, EMB, WIDE>(p.kch, p.ek);
    if (L.total > SMEM_MAX) return ERR_SHAPE;

    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    p.rt_count = (p.a + S::BM - 1) / S::BM;
    // Fewer row tiles than SMs: split each tile's selection blocks.
    p.splits = p.rt_count >= sms ? 1 : max(1, min(p.n_blocks, sms / p.rt_count));
    p.items = p.rt_count * p.splits;
    const int grid = min(sms, p.items);

    auto kernel = stage1_wgmma_kernel<M, REV, EMB, WIDE>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, S::NT, L.total, stream>>>(p);
    return (int)cudaGetLastError();
}

// The full row tile where it fits beside the ring, else the half tile
// (D > 640, or a wide embedding).
template <int M, bool REV, bool EMB>
int launch_tile(Params& p, const Operands& o, cudaStream_t stream) {
    if (layout<M, REV, EMB, false>(p.kch, p.ek).total <= SMEM_MAX)
        return launch<M, REV, EMB, false>(p, o, stream);
    return launch<M, REV, EMB, true>(p, o, stream);
}

// The instantiation keeps the top M >= m (a power of two) and writes m.
template <bool REV, bool EMB>
int launch_m(Params& p, const Operands& o, cudaStream_t stream) {
    if (p.m == 1) return launch_tile<1, REV, EMB>(p, o, stream);
    if (p.m == 2) return launch_tile<2, REV, EMB>(p, o, stream);
    if (p.m <= 4) return launch_tile<4, REV, EMB>(p, o, stream);
    if (p.m <= 8) return launch_tile<8, REV, EMB>(p, o, stream);
    return ERR_SHAPE;
}

}  // namespace

// Launch on `stream`; returns 0, a CUDA error code, or ERR_* above.
// Shapes: uq8/uv8 [a, dp], vv8/vq8 [n, dp] int8 holding 0/1, zero past
// column d (dp = d rounded up to 16, d <= 1024); ue [a, ep], ve [n, ep]
// bf16 (ep = E rounded up to 16, ep <= 64); col_mix/col_gidx [n],
// row_mix/row_slot [a] int32, col_gidx in [0, 2^18); out
// [a, (n / bn) * m] int32. Requires 1 <= m <= 8, n % bn == 0,
// bn % 128 == 0; base pointers 16-byte aligned.
extern "C" int stage1_wgmma_launch(
    const void* uq8, const void* vv8, const void* uv8, const void* vq8,
    const void* ue, const void* ve, const void* col_mix, const void* col_gidx,
    const void* row_mix, const void* row_slot, void* out, int a, int n, int dp,
    int d, int ep, int bn, int m, int f_int, float emb_scale, int rev, int with_emb,
    void* stream) {
    if (a <= 0 || n <= 0 || d <= 0 || d > KCH_MAX * KC || dp % 16 != 0 || dp < d ||
        bn <= 0 || bn % 128 != 0 || n % bn != 0 || m < 1 || m > 8 ||
        (with_emb && (ep <= 0 || ep % EC != 0 || ep > EK_MAX * EC)))
        return ERR_SHAPE;
    Params p;
    p.col_mix = static_cast<const int32_t*>(col_mix);
    p.col_gidx = static_cast<const int32_t*>(col_gidx);
    p.row_mix = static_cast<const int32_t*>(row_mix);
    p.row_slot = static_cast<const int32_t*>(row_slot);
    p.out = static_cast<int32_t*>(out);
    p.a = a;
    p.n_blocks = n / bn;
    p.bn = bn;
    p.m = m;
    p.kch = (d + KC - 1) / KC;
    p.last_ks = (d - (p.kch - 1) * KC + 31) / 32;
    p.ek = with_emb ? ep / EC : 0;
    p.f_int = f_int;
    p.emb_scale = emb_scale;
    const Operands o{uq8, vv8, uv8, vq8, ue, ve, a, n, dp, ep};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rev && with_emb) return launch_m<true, true>(p, o, s);
    if (rev) return launch_m<true, false>(p, o, s);
    if (with_emb) return launch_m<false, true>(p, o, s);
    return launch_m<false, false>(p, o, s);
}