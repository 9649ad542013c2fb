// Batched lexicographic lower bound over a board's sorted key rows, for
// the leaderboard rank engine: for each query key q[i] (three int32
// columns: adjusted score, adjusted subscore, seq), the number of rows
// of `sorted` [C, 3] that compare below it. The port of B8's
// `lex_ranks` (nakama_tpu/leaderboard/tpu.py:67), and the same search as
// its plain PyTorch version (leaderboard/cuda.py::lex_ranks_plain): a
// binary search of at most `n_iters` steps. Here one thread walks one
// query, so a batch is one launch instead of ~20 small kernels a step.
// A thread stops once its interval is empty, where the plain version
// keeps stepping with the row masked: the result is the same.

#include <cuda_runtime.h>

__device__ __forceinline__ bool less3(int a0, int a1, int a2, int b0, int b1,
                                      int b2) {
  return a0 < b0 || (a0 == b0 && (a1 < b1 || (a1 == b1 && a2 < b2)));
}

__global__ void lex_ranks_kernel(const int* __restrict__ sorted, int c,
                                 const int* __restrict__ q, int n_q,
                                 int n_iters, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const int q0 = q[3 * i], q1 = q[3 * i + 1], q2 = q[3 * i + 2];
  int lo = 0, hi = c;
  for (int step = 0; step < n_iters && lo < hi; ++step) {
    const int mid = (lo + hi) >> 1;
    const int* row = sorted + 3ll * mid;
    if (less3(__ldg(row), __ldg(row + 1), __ldg(row + 2), q0, q1, q2)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = lo;
}

extern "C" int lex_ranks_launch(const void* sorted, int c, const void* q,
                                int n_q, int n_iters, void* out,
                                void* stream) {
  if (n_q <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_q + threads - 1) / threads;
  lex_ranks_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)sorted, c, (const int*)q, n_q, n_iters, (int*)out);
  return (int)cudaGetLastError();
}
