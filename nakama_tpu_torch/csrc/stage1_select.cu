// Stage-1 prefilter on Hopper (sm_90a) for every shape that csrc/
// stage1_wgmma.cu does not take (m > 8, D > 1024 or E > 64) and for which a
// shared-memory plan exists: the mainloop of csrc/stage1_wgmma.cu with a
// threshold-and-queue selection as its epilogue.
//
// Replaces the Pallas TPU kernel nakama_tpu/matchmaker/device2.py:302
// (`_stage1_call`, body `_stage1_kernel` at :175), as csrc/stage1_wgmma.cu
// does for m <= 8, D <= 1024 and E <= 64. It takes k = 256 on a pool of 32
// to 63 selection blocks (m = 16 to 9), a lowered big_pool_threshold, the
// device self-check's four 256-column blocks at k = 64 (m = 32), and wide
// layouts (48 numeric and 32 string fields: D = 1032; embeddings up to 128
// wide). csrc/stage1.cu keeps the shapes with no plan: E > 128, or m above
// what fits beside the operands (kernels.select_plan). What it computes is
// csrc/stage1_wgmma.cu's function (its note; device2.stage1_plain): per
// row and per `bn`-column selection block, the block's top m packed words,
// descending, INT32_MIN-filled.
//
// Bound: as for csrc/stage1_wgmma.cu, the 0/1 product's 2*A*N*D int8
// operations (0.56 ms at 32,768 x 32,768, D = 520; 1.12 ms at D = 1032);
// the output grows with m (67 MB at that shape and m = 16, 0.02 ms of
// bytes).
//
// Design:
// - The mainloop is stage1_wgmma.cu's, from stage1_hopper.cuh: a persistent
//   grid, a producer warpgroup whose one thread issues every TMA load, the
//   column operand through a ring of full/empty mbarriers, int8 m64n64k32
//   wgmmas and bf16 m64n64k16 ones for the embedding product (up to 8 k16
//   steps: E <= 128). Each consumer warpgroup owns one 64-row slab.
// - The host (kernels.select_plan) picks a plan per (m, D, E, rev) and
//   passes it in; the launch checks that it fits and returns ERR_SHAPE
//   otherwise, so a shape is never sent here to fail. A plan is the number
//   of consumer warpgroups (two, a 128-row tile, only without rev; else
//   one), the ring's depth (up to 8: with one 64-row slab a chunk's wgmmas
//   are short, and a ring of 4 left the consumers waiting on TMA; 2 only
//   where 3 do not fit, as 2 left them waiting longer still), the queues'
//   length, and where the row operand lives. The first choice keeps it
//   resident in shared memory for a whole work item, loaded once, as
//   stage1_wgmma.cu does. Where that does not fit beside 3 ring stages
//   (past D = 2944 without flags, 1920 at E = 128; under rev past
//   D = 1280, 768 at E = 128), the row operand streams: each ring stage carries the row tile's K chunk (and uv's under
//   rev) beside the column chunk, so that the layout no longer depends on
//   D. Only the embedding rows stay resident. A row chunk is then read
//   from L2 once per 64-column tile instead of once per item.
// - The epilogue. The m <= 8 kernel keeps a running top-M in registers:
//   M registers a row and 2M min/max a word, which cannot scale to m = 64.
//   Here it is WarpSelect's shape (Johnson, Douze and Jegou, "Billion-scale
//   similarity search with GPUs", 2017, section 4), a row's four threads
//   standing in for the warp. Each row keeps in shared memory its best
//   words so far (the kept list, descending; its length kc <= m and its
//   threshold, the m-th word or INT_MIN while kc < m, in registers of its
//   four threads). A thread compares every word it forms with the
//   threshold and appends those that beat it to its own queue for the row
//   by a predicated store (no branch). Every half tile (8 words a thread
//   and row), if any of the warp's queues could overflow in the next half
//   tile, and after a selection block's last tile, the warp merges each
//   row's queues into its kept list, 64 queued words at a time: the row's
//   four threads hold 16 each in registers and sort the 64 with a bitonic
//   network (compare-exchanges in registers and, across the four threads,
//   by shuffles), then place each sorted word below the kept words at or
//   above it (a binary search) and each kept word below the sorted words
//   above it (a count over the four threads' registers), writing the
//   first m into the row's other kept buffer (the two alternate, so
//   nothing is read after it is overwritten). The whole warp runs every
//   round any of its rows needs, so that the shuffles see a converged
//   warp. A word beats the threshold with probability about m / (columns
//   seen), so queues of 32 words fill slowly: at the north star's density
//   (3% of pairs eligible) a block of 1,024 columns merges once, in one
//   round. The cost a pair stays a compare and a predicated store, where
//   the top-8 took 16 min/max. At the end of a selection block the kept
//   list is the row's answer; its four threads write it out (INT_MIN past
//   kc) and the row starts empty. The merge is a call, not inlined code:
//   the loop's appends ran slower with the network inlined in it. Where
//   the time goes: PERF.md (profile_stage1.py stage1_select).
// - Shared memory: a row takes 2m words of kept buffers and four queues,
//   each one word longer than its length (32, 16 or 8 words: the longest
//   that fits), so that a row's four lie in distinct banks; the row stride
//   is odd, so that the eight rows a warp merges at once do too: 83 KB for
//   128 rows at m = 16 with 32-word queues. The kept lists bound m: with
//   the row operand streamed, any D fits m up to 209 (rev with E = 128)
//   to 369 (no flags).
// - The wrapper's int8 conversion of the 0/1 operands runs here, one small
//   kernel an operand in the same C call, so the call costs one host round
//   trip. The converted rows are 16-byte aligned (dp = D rounded up to 16
//   columns) but not zero-padded: the tensor maps end at column D, and TMA
//   fills what lies past it with zeros.

#include <cuda_bf16.h>

#include "stage1_hopper.cuh"

namespace {

constexpr int MAX_STAGES = 8;       // ring stages, where shared memory allows
constexpr int SEL_EK_MAX = 8;       // E <= 128
// Bounds that keep the layout's arithmetic inside int; shared memory ends
// both far sooner (kernels.select_plan holds the same).
constexpr int SEL_M_MAX = 1024;
constexpr int SEL_KCH_MAX = 4096;
constexpr int TN = 64;              // columns per product tile
constexpr int NACC = TN / 2;        // accumulators per slab
constexpr int QSTEP = TN / 8;       // words a thread forms per row between
                                    // two checks of its queues (half a tile)

template <bool REV, bool EMB, int NCW>
struct Sel {
    static constexpr int NT = (NCW + 1) * 128;  // + a producer warpgroup
    static constexpr int BM = NCW * 64;         // rows per tile
};

struct SelLayout {
    int uv, ue, stages, stage_bytes, sa, ve, queues, bars, total;
};

// Words a row takes: two kept buffers of m, then a queue of qcap words
// for each of the row's four threads, qcap + 1 apart (so that a row's four
// queues lie in distinct banks); odd, so that rows do too.
__host__ __device__ constexpr int queue_stride(int m, int qcap) {
    return (2 * m + 4 * (qcap + 1)) | 1;
}

// Shared memory, from a 1024-byte aligned base: the resident row operands
// (uq, then uv under rev: kch chunks of [BM][128] each, unless STREAM;
// then ue, ek chunks of [BM][16] bf16), the ring's stages (the vv chunk
// [TN][128], the vq chunk, under STREAM the uq and uv chunks [BM][128] at
// `sa`, then ve as ek chunks of [TN][16] bf16), then the rows' kept lists
// and queues ([BM][queue_stride] int32), then the mbarriers.
// kernels.select_layout_bytes repeats this arithmetic.
template <bool REV, bool EMB, int NCW, bool STREAM>
__host__ __device__ SelLayout sel_layout(int kch, int ek, int n_stages, int m, int qcap) {
    using S = Sel<REV, EMB, NCW>;
    SelLayout L{};
    const int a_chunk = S::BM * KC;
    const int a_ops = REV ? 2 : 1;
    L.uv = kch * a_chunk;
    L.ue = STREAM ? 0 : kch * a_chunk * a_ops;
    L.stages = round_up(L.ue + (EMB ? ek * S::BM * EC * 2 : 0), 1024);
    L.sa = TN * KC * a_ops;
    L.ve = L.sa + (STREAM ? a_chunk * a_ops : 0);
    L.stage_bytes = round_up(L.ve + (EMB ? ek * TN * EC * 2 : 0), 1024);
    L.queues = L.stages + n_stages * L.stage_bytes;
    L.bars = round_up(L.queues + S::BM * queue_stride(m, qcap) * 4, 8);
    L.total = L.bars + (2 * n_stages + 2) * 8 + 1024;  // + slack to align the base
    return L;
}

// A store to shared memory if p. No "memory" clobber, so that the
// epilogue's loads of column data are not held behind it; the merge fences
// the compiler before it reads the queues.
__device__ __forceinline__ void st_shared_if(uint32_t addr, int v, bool p) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %2, 0;\n"
        "@p st.shared.b32 [%0], %1;\n}\n"
        :: "r"(addr), "r"(v), "r"((int)p));
}

// #{i < kc : kept[i] >= x} over a descending kept list.
__device__ __forceinline__ int count_ge(const int32_t* kept, int kc, int x) {
    int lo = 0, hi = kc;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kept[mid] >= x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

constexpr int RT = 16;      // queued words a thread holds in a merge round
constexpr int ROUND = 4 * RT;

// Sort the ROUND words held by a row's four threads (word e = RT q + t in
// thread q's x[t]) into descending order: a bitonic network,
// compare-exchanges within a thread in registers and across the row's
// threads by shuffles. The whole warp runs it (its eight rows at once).
__device__ __forceinline__ void sort_round_desc(int (&x)[RT], int q) {
#pragma unroll
    for (int k = 2; k <= ROUND; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            if (j >= RT) {
#pragma unroll
                for (int t = 0; t < RT; ++t) {
                    const int e = RT * q + t;
                    const int y = __shfl_xor_sync(0xffffffffu, x[t], j / RT);
                    const bool keep_max = ((e & k) == 0) == ((e & j) == 0);
                    x[t] = keep_max ? max(x[t], y) : min(x[t], y);
                }
            } else {
#pragma unroll
                for (int t = 0; t < RT; ++t) {
                    if ((t & j) != 0) continue;
                    const int a = x[t], b = x[t | j];
                    const bool desc = ((RT * q + t) & k) == 0;
                    x[t] = desc ? max(a, b) : min(a, b);
                    x[t | j] = desc ? min(a, b) : max(a, b);
                }
            }
        }
    }
}

// Merge one row's four queues (the four threads' counts `cnt`) into its
// kept list, by the row's four threads (q). ROUND queued words at a time
// (in queue order) are sorted in registers (sort_round_desc) and merged
// with the kept list, which alternates between the row's two buffers (row
// and row + m; `par` names the one that holds it, kc its length; the
// queues follow at row + 2m, qs words apart): each sorted word goes below
// the kept words at or above it (a binary search), each kept word below
// the sorted words above it (a count over the four threads' registers),
// the first m into the other buffer. Ties: kept words first. The whole
// warp runs every round and step that any of its eight rows needs, so
// that it stays converged for the shuffles. Returns the merged list's
// length, or -1 when the row queued nothing. Not inlined: its unrolled
// network inside the consumer loop slowed the loop's appends by more
// than a call costs (profile_stage1.py stage1_select, PERF.md).
__device__ __noinline__ int merge_row(int32_t* row, int& par, int qs, int kc,
                                         int m, int q, int cnt) {
    const int lane = threadIdx.x % 32;
    int c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = __shfl_sync(0xffffffffu, cnt, (lane & ~3) + k);
    const int p1 = c[0], p2 = p1 + c[1], p3 = p2 + c[2], total = p3 + c[3];
    const int most = __reduce_max_sync(0xffffffffu, total);
    const int32_t* queue = row + 2 * m;
    for (int base = 0; base < most; base += ROUND) {
        int x[RT];
#pragma unroll
        for (int t = 0; t < RT; ++t) {
            const int j = base + RT * q + t;  // flat index: queue k, slot j - start
            const int k = (j >= p1) + (j >= p2) + (j >= p3);
            const int start = k == 0 ? 0 : k == 1 ? p1 : k == 2 ? p2 : p3;
            x[t] = j < total ? queue[k * qs + j - start] : INT_MIN;
        }
        sort_round_desc(x, q);
        const int n = max(0, min(ROUND, total - base));  // words e < n are queued ones
        const int32_t* src = row + par * m;
        int32_t* dst = row + (par ^ 1) * m;
#pragma unroll
        for (int t = 0; t < RT; ++t) {
            const int e = RT * q + t;
            if (e < n) {
                const int pos = e + count_ge(src, kc, x[t]);
                if (pos < m) dst[pos] = x[t];
            }
        }
        const int kmax = __reduce_max_sync(0xffffffffu, n > 0 ? kc : 0);
        for (int i = 0; i < kmax; ++i) {
            const int v = i < kc ? src[i] : INT_MAX;
            int above = 0;
#pragma unroll
            for (int t = 0; t < RT; ++t) above += x[t] > v;
            above += __shfl_xor_sync(0xffffffffu, above, 1);
            above += __shfl_xor_sync(0xffffffffu, above, 2);
            if (n > 0 && i < kc && (i & 3) == q && i + above < m) dst[i + above] = v;
        }
        if (n > 0) {
            kc = min(kc + n, m);
            par ^= 1;
        }
        __syncwarp();  // the next round reads what this one wrote
    }
    return total > 0 ? kc : -1;
}

// ----------------------------------------------------------------- kernel

// STREAM: the row operand comes through the ring (the design note); the
// a_full/a_empty pair then guards the resident embedding rows alone, and
// is not used without embeddings.
template <bool REV, bool EMB, int NCW, bool STREAM>
__global__ void __launch_bounds__((Sel<REV, EMB, NCW>::NT), 1)
stage1_select_kernel(const __grid_constant__ Params p, const int n_stages, const int qcap) {
    constexpr int BM = Sel<REV, EMB, NCW>::BM;
    constexpr bool HOLD = !STREAM || EMB;  // anything resident an item
    extern __shared__ uint8_t smem_raw[];
    const SelLayout L = sel_layout<REV, EMB, NCW, STREAM>(p.kch, p.ek, n_stages, p.m, qcap);
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t full0 = base + L.bars;             // full[s]  at full0 + 8 s
    const uint32_t empty0 = full0 + 8 * n_stages;     // empty[s] at empty0 + 8 s
    const uint32_t a_full = empty0 + 8 * n_stages;
    const uint32_t a_empty = a_full + 8;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < n_stages; ++s) {
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
        if constexpr (NCW == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (warp != NCW * 4 || lane != 0) return;
        const uint32_t a_tx = (STREAM ? 0 : (REV ? 2 : 1) * p.kch * a_chunk) +
                              (EMB ? p.ek * BM * EC * 2 : 0);
        const uint32_t b_tx = (TN * KC + (STREAM ? a_chunk : 0)) * (REV ? 2 : 1);
        const uint32_t b_tx0 = b_tx + (EMB ? p.ek * TN * EC * 2 : 0);
        int stage = 0, phase = 0, n_a = 0;
        for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
            const int rt = item % p.rt_count;
            const int sp = item / p.rt_count;
            const int j0 = sp * p.n_blocks / p.splits;
            const int j1 = (sp + 1) * p.n_blocks / p.splits;
            if (HOLD) {
                if (n_a > 0) mbar_wait(a_empty, (n_a - 1) & 1);
                ++n_a;
                mbar_expect_tx(a_full, a_tx);
            }
            if (!STREAM)
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
                        if (STREAM) {
                            tma_load_2d(st + L.sa, &p.tm_uq, full, kc * KC, rt * BM);
                            if (REV) tma_load_2d(st + L.sa + a_chunk, &p.tm_uv, full, kc * KC, rt * BM);
                        }
                        if (EMB && kc == 0)
                            for (int c = 0; c < p.ek; ++c)
                                tma_load_2d(st + L.ve + c * TN * EC * 2, &p.tm_ve, full, c * EC, col0);
                        if (++stage == n_stages) { stage = 0; phase ^= 1; }
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
    // Row (within the tile) of this thread's first accumulator row.
    const int rbase = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int m = p.m;
    const int out_w = p.n_blocks * m;
    int32_t* const rows =
        reinterpret_cast<int32_t*>(smem_raw + (base - smem_u32(smem_raw)) + L.queues);
    // Each of this thread's two rows: its kept buffers (row[h], row[h] + m),
    // the row's queues (row[h] + 2m), this thread's queue's address.
    const int qs = qcap + 1;
    int32_t* row[2];
    uint32_t qaddr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        row[h] = rows + (rbase + 8 * h) * queue_stride(m, qcap);
        qaddr[h] = smem_u32(row[h] + 2 * m + q * qs);
    }

    int acc[1][NACC];
    int accr[1][REV ? NACC : 1];
    float acce[1][EMB ? NACC : 1];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[0][i] = 0;
    if constexpr (REV) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) accr[0][i] = 0;
    }
    if constexpr (EMB) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) acce[0][i] = 0.0f;
    }

    int par[2] = {0, 0};  // which kept buffer holds each row's list
    int stage = 0, phase = 0, a_phase = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int rt = item % p.rt_count;
        const int sp = item / p.rt_count;
        const int j0 = sp * p.n_blocks / p.splits;
        const int j1 = (sp + 1) * p.n_blocks / p.splits;
        const int row0 = rt * BM;

        // Per-row constants, as in stage1_wgmma.cu (the shifted domain
        // without embeddings).
        int rkey[2], rslot[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + rbase + 8 * h;
            const int rm = r < p.a ? p.row_mix[r] : 0;
            const int sl = r < p.a ? p.row_slot[r] : 0;
            rkey[h] = EMB ? (rm & 255) : (rm & 255) << COL_BITS;
            rslot[h] = EMB ? sl : (int)((uint32_t)sl + (1u << 30));
        }

        if (HOLD) {
            mbar_wait(a_full, a_phase);
            a_phase ^= 1;
        }

        for (int j = j0; j < j1; ++j) {
            int kc[2] = {0, 0};                 // each row's kept list length,
            int thr[2] = {INT_MIN, INT_MIN};    // threshold,
            int cnt[2] = {0, 0};                // and this thread's queued words
            for (int c = 0; c < col_tiles; ++c) {
                const int col0 = j * p.bn + c * TN;
                int prev = 0;
                for (int kk = 0; kk < p.kch; ++kk) {
                    const uint32_t st = base + L.stages + stage * L.stage_bytes;
                    mbar_wait(full0 + 8 * stage, phase);
                    const int nks = kk + 1 < p.kch ? KC / 32 : p.last_ks;
                    // The row chunk: resident, or in the stage beside the
                    // column chunk; uv's lies uv_off past uq's.
                    const ChunkAddr ad{
                        (STREAM ? st + L.sa : base + kk * a_chunk) + wg * 64 * KC,
                        (uint32_t)(STREAM ? a_chunk : L.uv), st, (uint32_t)(TN * KC), kk};
                    if constexpr (EMB)
                        if (kk == 0)
                            issue_emb_n<SEL_EK_MAX>(p.ek, base + L.ue + wg * 64 * EC * 2,
                                                    BM * EC * 2, st + L.ve, TN * EC * 2, acce);
                    issue_n<REV>(nks, ad, acc, accr);
                    if (kk > 0) {
                        // The previous chunk's wgmmas (and the embedding
                        // product, issued before chunk 0) are done.
                        wg_wait<1>();
                        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
                    }
                    prev = stage;
                    if (++stage == n_stages) { stage = 0; phase ^= 1; }
                }
                wg_wait<0>();
                if (lane == 0) mbar_arrive(empty0 + 8 * prev);
                fence_regs(acc[0]);
                if constexpr (REV) fence_regs(accr[0]);
                if constexpr (EMB) fence_regs(acce[0]);

                // Words that beat the row's threshold go to this thread's
                // queue. Accumulator i is row r + 8 * ((i / 2) % 2), column
                // 8 * (i / 4) + 2 * q + i % 2.
#pragma unroll
                for (int half = 0; half < 2; ++half) {
#pragma unroll
                    for (int jj = 0; jj < (STAGE1_EXP == 1 ? 0 : TN / 16); ++jj) {
                        const int j8 = 4 * half + jj;
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
                        for (int h = 0; h < 2; ++h)
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int i = 4 * j8 + 2 * h + e;
                                bool ok = acc[0][i] >= p.f_int && cg[e] != rslot[h];
                                if constexpr (REV) ok = ok && accr[0][i] >= p.f_int;
                                int w;
                                if constexpr (EMB) {
                                    float v = acce[0][i] * p.emb_scale;
                                    v = fminf(fmaxf(v, -4095.0f), 4095.0f);
                                    int prio = 4096 - (rkey[h] ^ ck[e]) + (int)v;  // toward zero
                                    prio = min(max(prio, 0), PRIO_MAX);
                                    w = (prio << COL_BITS) | cg[e];
                                } else {
                                    // (4096 - x) << 18 | col == 2^30 + col - (x << 18)
                                    w = cg[e] - (rkey[h] ^ ck[e]);
                                }
                                const bool take = ok && w > thr[h];
                                st_shared_if(qaddr[h] + 4 * cnt[h], w, take);
                                cnt[h] += take;
                            }
                    }
                    // Merge before a queue could overflow in the next half
                    // tile, and after the block's last tile.
                    const int most = max(cnt[0], cnt[1]);
                    const bool end = half == 1 && c + 1 == col_tiles;
                    if (!__any_sync(0xffffffffu, most > qcap - QSTEP || (end && most > 0)))
                        continue;
                    if (STAGE1_EXP == 3) {
                        cnt[0] = cnt[1] = 0;
                        continue;
                    }
                    asm volatile("" ::: "memory");
                    __syncwarp();  // the queues are visible to the row's threads
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int n = merge_row(row[h], par[h], qs, kc[h], m, q, cnt[h]);
                        if (n >= 0) kc[h] = n;
                        cnt[h] = 0;
                    }
                    __syncwarp();  // the merged lists are complete
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        thr[h] = kc[h] == m ? row[h][par[h] * m + m - 1] : INT_MIN;
                }
            }

            // The kept lists are the block's answer.
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = row0 + rbase + 8 * h;
                if (r < p.a) {
                    const int32_t* list = row[h] + par[h] * m;
                    int32_t* dst = p.out + (size_t)r * out_w + (size_t)j * m;
                    for (int i = q; i < m; i += 4) dst[i] = i < kc[h] ? list[i] : INT_MIN;
                }
            }
            __syncwarp();  // read before the next block's merges write
        }
        // This warp is done reading the item's resident rows.
        if (HOLD && lane == 0) mbar_arrive(a_empty);
    }
}

// The wrapper's conversion of a 0/1 operand: bf16 [rows, d] to int8 rows
// dp apart (the columns past d are left as they are). A block a row.
__global__ void to_int8_kernel(const __nv_bfloat16* __restrict__ src, int8_t* __restrict__ dst,
                               int d, int dp) {
    const __nv_bfloat16* s = src + (size_t)blockIdx.x * d;
    int8_t* o = dst + (size_t)blockIdx.x * dp;
    for (int c = threadIdx.x; c < d; c += blockDim.x) o[c] = (int8_t)__bfloat162float(s[c]);
}

// ------------------------------------------------------------------- host

// The SM count of a device, asked of the driver once.
int sm_count(int dev) {
    static int known[64] = {};
    if (dev >= 0 && dev < 64 && known[dev] > 0) return known[dev];
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return -1;
    if (dev >= 0 && dev < 64) known[dev] = sms;
    return sms;
}

// The 0/1 operands' maps end at column d (TMA zero-fills past it); their
// rows are dp apart. The plan has been checked (plan_fits).
template <bool REV, bool EMB, int NCW, bool STREAM>
int launch(Params& p, const Operands& o, int d, int n_stages, int qcap, cudaStream_t stream) {
    constexpr int BM = Sel<REV, EMB, NCW>::BM;
    const SelLayout L = sel_layout<REV, EMB, NCW, STREAM>(p.kch, p.ek, n_stages, p.m, qcap);
    const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
    const CUtensorMapSwizzle sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
    bool ok = make_map(&p.tm_uq, o.uq, u8, 1, d, o.a, o.dp, KC, BM, sw128) &&
              make_map(&p.tm_vv, o.vv, u8, 1, d, o.n, o.dp, KC, TN, sw128);
    if (REV)
        ok = ok && make_map(&p.tm_uv, o.uv, u8, 1, d, o.a, o.dp, KC, BM, sw128) &&
             make_map(&p.tm_vq, o.vq, u8, 1, d, o.n, o.dp, KC, TN, sw128);
    if (EMB)
        ok = ok && make_map(&p.tm_ue, o.ue, bf, 2, o.ep, o.a, o.ep, EC, BM, sw32) &&
             make_map(&p.tm_ve, o.ve, bf, 2, o.ep, o.n, o.ep, EC, TN, sw32);
    if (!ok) return ERR_TENSOR_MAP;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const int sms = sm_count(dev);
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    p.rt_count = (p.a + BM - 1) / BM;
    // Fewer row tiles than SMs: split each tile's selection blocks.
    p.splits = p.rt_count >= sms ? 1 : max(1, min(p.n_blocks, sms / p.rt_count));
    p.items = p.rt_count * p.splits;
    const int grid = min(sms, p.items);

    auto kernel = stage1_select_kernel<REV, EMB, NCW, STREAM>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, Sel<REV, EMB, NCW>::NT, L.total, stream>>>(p, n_stages, qcap);
    return (int)cudaGetLastError();
}

// The plan's instantiation: two consumer warpgroups only without rev.
template <bool REV, bool EMB>
int launch_plan(Params& p, const Operands& o, int d, int ncw, int n_stages, int qcap,
                bool streamed, cudaStream_t stream) {
    if (ncw == 1)
        return streamed ? launch<REV, EMB, 1, true>(p, o, d, n_stages, qcap, stream)
                        : launch<REV, EMB, 1, false>(p, o, d, n_stages, qcap, stream);
    if constexpr (!REV)
        if (ncw == 2)
            return streamed ? launch<REV, EMB, 2, true>(p, o, d, n_stages, qcap, stream)
                            : launch<REV, EMB, 2, false>(p, o, d, n_stages, qcap, stream);
    return ERR_SHAPE;
}

template <bool REV, bool EMB>
int layout_total(int ncw, bool streamed, int kch, int ek, int n_stages, int m, int qcap) {
    if (ncw == 1)
        return streamed ? sel_layout<REV, EMB, 1, true>(kch, ek, n_stages, m, qcap).total
                        : sel_layout<REV, EMB, 1, false>(kch, ek, n_stages, m, qcap).total;
    return streamed ? sel_layout<REV, EMB, 2, true>(kch, ek, n_stages, m, qcap).total
                    : sel_layout<REV, EMB, 2, false>(kch, ek, n_stages, m, qcap).total;
}

}  // namespace

// Shared memory, in bytes, that a plan takes (sel_layout's total; -1 for
// a warpgroup count the kernel has no instantiation of), for holding
// kernels.select_layout_bytes to it.
extern "C" int stage1_select_layout_bytes(int rev, int with_emb, int ncw, int streamed,
                                          int kch, int ek, int n_stages, int m, int qcap) {
    if (ncw != 1 && (ncw != 2 || rev)) return -1;
    if (rev && with_emb) return layout_total<true, true>(ncw, streamed, kch, ek, n_stages, m, qcap);
    if (rev) return layout_total<true, false>(ncw, streamed, kch, ek, n_stages, m, qcap);
    if (with_emb) return layout_total<false, true>(ncw, streamed, kch, ek, n_stages, m, qcap);
    return layout_total<false, false>(ncw, streamed, kch, ek, n_stages, m, qcap);
}

namespace {

// A plan fits: an instantiation exists, the ring has 2 to MAX_STAGES
// stages (one deadlocks: a stage is freed only after the next chunk's
// wgmmas issue), the queues are 8, 16 or 32 words, and the layout fits in
// shared memory.
bool plan_fits(int rev, int with_emb, int ncw, int streamed, int kch, int ek, int n_stages,
               int m, int qcap) {
    if (n_stages < 2 || n_stages > MAX_STAGES || (qcap != 8 && qcap != 16 && qcap != 32))
        return false;
    const int total =
        stage1_select_layout_bytes(rev, with_emb, ncw, streamed, kch, ek, n_stages, m, qcap);
    return total > 0 && total <= SMEM_MAX;
}

}  // namespace

// Launch on `stream` with the plan (ncw consumer warpgroups, n_stages ring
// stages, queues of qcap words, the row operand streamed or resident) that
// kernels.select_plan chose; returns 0, a CUDA error code, or ERR_* of
// stage1_hopper.cuh (ERR_SHAPE where the plan does not fit). uq/uv [a, d],
// vv/vq [n, d] bf16 holding 0/1, are converted into uq8/uv8 [a, dp],
// vv8/vq8 [n, dp] int8 (scratch the caller allocates; dp = d rounded up to
// 16); the other arguments are stage1_wgmma_launch's. Requires m >= 1,
// E <= 128, n % bn == 0, bn % 128 == 0; base pointers 16-byte aligned.
extern "C" int stage1_select_launch(
    const void* uq, const void* vv, const void* uv, const void* vq,
    void* uq8, void* vv8, void* uv8, void* vq8,
    const void* ue, const void* ve, const void* col_mix, const void* col_gidx,
    const void* row_mix, const void* row_slot, void* out, int a, int n, int dp,
    int d, int ep, int bn, int m, int f_int, float emb_scale, int rev, int with_emb,
    int ncw, int n_stages, int qcap, int streamed, void* stream) {
    if (a <= 0 || n <= 0 || d <= 0 || d > SEL_KCH_MAX * KC || dp % 16 != 0 || dp < d ||
        bn <= 0 || bn % 128 != 0 || n % bn != 0 || m < 1 || m > SEL_M_MAX ||
        (with_emb && (ep <= 0 || ep % EC != 0 || ep > SEL_EK_MAX * EC)))
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
    if (!plan_fits(rev, with_emb, ncw, streamed, p.kch, p.ek, n_stages, m, qcap))
        return ERR_SHAPE;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const void* src[4] = {uq, vv, uv, vq};
    void* dst[4] = {uq8, vv8, uv8, vq8};
    const int rows[4] = {a, n, a, n};
    for (int t = 0; t < (rev ? 4 : 2); ++t) {
        to_int8_kernel<<<rows[t], 128, 0, s>>>(static_cast<const __nv_bfloat16*>(src[t]),
                                               static_cast<int8_t*>(dst[t]), d, dp);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const Operands o{uq8, vv8, uv8, vq8, ue, ve, a, n, dp, ep};
    if (rev && with_emb) return launch_plan<true, true>(p, o, d, ncw, n_stages, qcap, streamed, s);
    if (rev) return launch_plan<true, false>(p, o, d, ncw, n_stages, qcap, streamed, s);
    if (with_emb) return launch_plan<false, true>(p, o, d, ncw, n_stages, qcap, streamed, s);
    return launch_plan<false, false>(p, o, d, ncw, n_stages, qcap, streamed, s);
}
