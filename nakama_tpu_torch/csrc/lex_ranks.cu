// Batched lexicographic lower bound over a board's sorted key rows, for
// the leaderboard rank engine: for each query key q[i] (three int32
// columns: adjusted score, adjusted subscore, seq), the number of rows
// of `sorted` [C, 3] that compare below it. The port of B8's
// `lex_ranks` (nakama_tpu/leaderboard/tpu.py:67), the same function as
// its plain PyTorch version (leaderboard/cuda.py::lex_ranks_plain, a
// masked binary search): bisect_left over the three columns, compared
// in turn, never packed.
//
// Bound: latency, not bytes. A query's answer is a chain of dependent
// loads from a table far larger than L2 (201 MB at 16,777,216 slots);
// its bytes (one 12-byte row a step) take ~0.1 us for 1,024 queries, so
// the time is the chain's length times one load's latency.
//
// Design: a warp per query and a 33-ary search. Each step, lane j loads
// the pivot row lo + (j+1) n / (W+1) of the open interval [lo, lo + n)
// (or lo + j when n <= W), compares it with the query, and the warp's
// ballot counts the pivots below the query: they are a prefix, since the
// rows are sorted, and the count picks the sub-interval between two
// neighbouring pivots. The 32 loads of a step are independent, so a step
// costs about one load's latency, and a search takes ceil(log33(C + 1))
// steps: 5 at 16,777,216 slots, where a binary search takes 25. Four
// warps a block, so 1,024 queries are 256 blocks over the card's 132
// SMs. `n_iters` caps the steps (a depth that suffices for a binary
// search suffices here); a warp stops once its interval is empty.

#include <cuda_runtime.h>

namespace {

constexpr int W = 32;      // lanes, one pivot each
constexpr int WARPS = 4;   // queries a block

__device__ __forceinline__ bool less3(int a0, int a1, int a2, int b0, int b1,
                                      int b2) {
  return a0 < b0 || (a0 == b0 && (a1 < b1 || (a1 == b1 && a2 < b2)));
}

// Pivot j of the open interval [lo, lo + n): lo + (j+1) n / (W+1) when
// n > W, else lo + j (the same formula with W = n). The divisor is a
// constant, so the division is a multiply; 32 bits hold (j+1) n below
// 2^27 rows.
__device__ __forceinline__ int pivot(int lo, int n, int j) {
  if (n <= W) return lo + j;
  if (n < (1 << 27)) return lo + (int)((unsigned)(j + 1) * (unsigned)n / (W + 1u));
  return lo + (int)((unsigned long long)(j + 1) * (unsigned)n / (W + 1ull));
}

__global__ void __launch_bounds__(WARPS * W)
lex_ranks_kernel(const int* __restrict__ sorted, int c, const int* __restrict__ q,
                 int n_q, int n_iters, int* __restrict__ out) {
  const int i = blockIdx.x * WARPS + threadIdx.x / W;  // this warp's query
  const int lane = threadIdx.x % W;
  if (i >= n_q) return;  // the whole warp
  const int q0 = __ldg(q + 3 * i), q1 = __ldg(q + 3 * i + 1), q2 = __ldg(q + 3 * i + 2);
  int lo = 0, hi = c;
  for (int step = 0; step < n_iters && lo < hi; ++step) {
    const int n = hi - lo;
    const int np = min(n, W);
    bool below = false;
    if (lane < np) {
      const int* row = sorted + 3ll * pivot(lo, n, lane);
      below = less3(__ldg(row), __ldg(row + 1), __ldg(row + 2), q0, q1, q2);
    }
    const int k = __popc(__ballot_sync(0xffffffffu, below));
    // Rows up to pivot k-1 are below the query, rows from pivot k are not.
    const int new_lo = k > 0 ? pivot(lo, n, k - 1) + 1 : lo;
    hi = k < np ? pivot(lo, n, k) : hi;
    lo = new_lo;
  }
  if (lane == 0) out[i] = lo;
}

}  // namespace

extern "C" int lex_ranks_launch(const void* sorted, int c, const void* q,
                                int n_q, int n_iters, void* out,
                                void* stream) {
  if (n_q <= 0) return 0;
  const int blocks = (n_q + WARPS - 1) / WARPS;
  lex_ranks_kernel<<<blocks, WARPS * W, 0, (cudaStream_t)stream>>>(
      (const int*)sorted, c, (const int*)q, n_q, n_iters, (int*)out);
  return (int)cudaGetLastError();
}
