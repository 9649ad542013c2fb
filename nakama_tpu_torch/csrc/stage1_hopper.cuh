// The parts that the Hopper stage-1 kernels share (csrc/stage1_wgmma.cu,
// m <= 8 winners per block at D <= 1024 and E <= 64; csrc/stage1_select.cu,
// every other shape for which a shared-memory plan exists): the constants
// of the operand layout, the kernels' parameters, the mbarrier, TMA and
// wgmma primitives, one chunk's products as one commit group, and the
// host's tensor maps. Both kernels stream the column operand through the
// same TMA ring into the same int8 wgmmas; they differ in their tiles and
// their epilogues.

#pragma once

#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

// Measurement builds only (profile_stage1.py): 1 leaves out the epilogue,
// 2 leaves out the products, 3 (stage1_select.cu) leaves out the merges;
// 0, the default, is the kernel.
#ifndef STAGE1_EXP
#define STAGE1_EXP 0
#endif

namespace {


constexpr int KC = 128;                // K chunk: 128 int8 = one 128-byte swizzle span
constexpr int KCH_MAX = 8;             // stage1_wgmma.cu: D <= 1024
constexpr int EC = 16;                 // embedding chunk: one bf16 k16 step, 32 bytes a row
constexpr int EK_MAX = 4;              // stage1_wgmma.cu: E <= 64
constexpr int COL_BITS = 18;
constexpr int PRIO_MAX = 8191;
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block may use

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

struct Params {
    CUtensorMap tm_uq, tm_vv, tm_uv, tm_vq, tm_ue, tm_ve;
    const int32_t* col_mix;
    const int32_t* col_gidx;
    const int32_t* row_mix;
    const int32_t* row_slot;
    int32_t* out;
    int a;          // rows
    int n_blocks;   // selection blocks (n / bn)
    int bn;         // selection block width
    int m;          // words written per row and block (<= M)
    int kch;        // K chunks
    int last_ks;    // k32 steps in the last chunk
    int ek;         // embedding k16 chunks (0 without embeddings)
    int f_int;      // F: a pair is eligible when its count is >= F
    int rt_count;   // row tiles
    int splits;     // selection-block ranges per row tile
    int items;      // rt_count * splits
    float emb_scale;
};

// ------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, int parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done;
}

// Returns once the barrier's phase of parity `parity` has completed. A
// wait of more than ~2^34 cycles (several seconds) can only be a broken
// pipeline: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity))
        if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int x, int y) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
        : "memory");
}

// wgmma shared-memory descriptors, K-major. 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart. 32-byte swizzle: rows of 32 bytes,
// 8-row groups 256 bytes apart. The leading offset is unused for swizzled
// K-major operands. A k32 step inside a 128-byte row adds 32 bytes (2 in
// the address field).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma from shared memory into registers: s8 x s8 -> s32 (m64n128k32,
// m64n64k32) and bf16 x bf16 -> f32 (m64n64k16). scale_d = 0 overwrites
// the accumulators, 1 adds to them. Overloaded on the accumulator size.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// Shared-memory addresses of one chunk's products for one warpgroup: its
// first row slab in the resident operands, the stage.
struct ChunkAddr {
    uint32_t a, uv_off, st, vq_off;
    int kc;
};

// NKS k32 steps of a chunk as straight-line code, so that the chunk is a
// single commit group: a branch between wgmmas makes the compiler close
// the group and fence (C7519).
template <int NKS, bool REV, int S, int N, int RS, int RN>
__device__ __forceinline__ void issue_chunk(const ChunkAddr& ad, int (&acc)[S][N],
                                            int (&accr)[RS][RN]) {
    wg_fence();
    if (STAGE1_EXP != 2) {
#pragma unroll
        for (int ks = 0; ks < NKS; ++ks) {
            const int scale = (ad.kc | ks) != 0;
            const uint64_t db = desc_sw128(ad.st + ks * 32);
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const uint32_t a_addr = ad.a + s * 64 * KC + ks * 32;
                wgmma_s8(acc[s], desc_sw128(a_addr), db, scale);
                if constexpr (REV)
                    wgmma_s8(accr[s], desc_sw128(a_addr + ad.uv_off),
                             desc_sw128(ad.st + ad.vq_off + ks * 32), scale);
            }
        }
    }
    wg_commit();
}

template <bool REV, int S, int N, int RS, int RN>
__device__ __forceinline__ void issue_n(int nks, const ChunkAddr& ad, int (&acc)[S][N],
                                        int (&accr)[RS][RN]) {
    switch (nks) {
        case 4: issue_chunk<4, REV>(ad, acc, accr); break;
        case 3: issue_chunk<3, REV>(ad, acc, accr); break;
        case 2: issue_chunk<2, REV>(ad, acc, accr); break;
        default: issue_chunk<1, REV>(ad, acc, accr); break;
    }
}

// The embedding product of one column tile, EK k16 steps into fp32, as one
// commit group. `ue` is this warpgroup's first slab in the first k16 chunk
// of the resident rows, `ve` the stage's first chunk; chunks lie `ue_step`
// and `ve_step` bytes apart.
template <int EK, int S, int N>
__device__ __forceinline__ void issue_emb(uint32_t ue, uint32_t ue_step, uint32_t ve,
                                          uint32_t ve_step, float (&acce)[S][N]) {
    wg_fence();
    if (STAGE1_EXP != 2) {
#pragma unroll
        for (int c = 0; c < EK; ++c)
#pragma unroll
            for (int s = 0; s < S; ++s)
                wgmma_bf16(acce[s], desc_sw32(ue + c * ue_step + s * 64 * EC * 2),
                           desc_sw32(ve + c * ve_step), c > 0);
    }
    wg_commit();
}

// The embedding product at `ek` k16 steps, 1 <= ek <= EKN: one
// instantiation a step count, since a commit group is straight-line code.
// Any other `ek` traps (the launch fails): the host checks it, so only a
// fault reaches it, and it must not score part of the embedding.
template <int EKN = EK_MAX, int S, int N>
__device__ __forceinline__ void issue_emb_n(int ek, uint32_t ue, uint32_t ue_step, uint32_t ve,
                                            uint32_t ve_step, float (&acce)[S][N]) {
    if constexpr (EKN >= 1) {
        if (ek == EKN) {
            issue_emb<EKN>(ue, ue_step, ve, ve_step, acce);
            return;
        }
        issue_emb_n<EKN - 1>(ek, ue, ue_step, ve, ve_step, acce);
    } else {
        __trap();
    }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult status;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                    &status) == cudaSuccess &&
            status == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
    return fn;
}

// A 2-D tensor map over a row-major [rows, inner] array (row stride
// `stride` elements), loading boxes of [box_rows][box_inner].
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dtype, int elem,
              int inner, int rows, int stride, int box_inner, int box_rows,
              CUtensorMapSwizzle swizzle) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
    cuuint64_t strides[1] = {(cuuint64_t)stride * elem};
    cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
    cuuint32_t estr[2] = {1, 1};
    return encode(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ERR_TENSOR_MAP = 100001;
constexpr int ERR_SHAPE = 100002;

struct Operands {
    const void *uq, *vv, *uv, *vq, *ue, *ve;
    int a, n, dp, ep;
};

}  // namespace
