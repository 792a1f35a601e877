// K2 for Hopper: the context drafter's n-gram match/hash sweep.
//
// Replaces the TPU kernel repro/kernels/ngram_match.py:ngram_match_call
// (body _kernel).  For every batch row b and position i < L of the token
// buffer:
//
//   match[b,i] = all(buf[b, i:i+q] == query[b]) and i + q + w <= cur_len[b]
//   hash[b,i]  = hash of buf[b, i+q : i+q+w]
//
// where h_0 = 0, h_{j+1} = (h_j ^ (tok_j * mult)) * mix + 1 in uint32 (the
// constants come from the caller: repro_torch/kernels/hashing.py holds the
// one definition).  Positions past L read as -1, so no padded copy of the
// buffer is needed; the hash is written as int64 holding the uint32 value.
//
// Bound on the H100: bytes -- about (q + w) integer ops per position
// against 4 bytes read and 12 written.  Design for that bound: one thread
// per (b, position); neighbouring threads read neighbouring tokens, so the
// q + w overlapping window loads of a warp hit the same cache lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ngram_match_kernel(const int* __restrict__ buf, long long buf_sb,
                       const int* __restrict__ query, long long query_sb,
                       const int* __restrict__ cur_len,
                       int* __restrict__ match, long long* __restrict__ hash,
                       int L, int q, int w, uint32_t mult, uint32_t mix) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= L) return;
  const int* row = buf + b * buf_sb;
  const int* qr = query + b * query_sb;
  bool m = true;
  for (int j = 0; j < q; ++j) {
    const int p = i + j;
    m = m && ((p < L ? row[p] : -1) == qr[j]);
  }
  m = m && ((long long)i + q + w <= (long long)cur_len[b]);
  uint32_t h = 0u;
  for (int j = 0; j < w; ++j) {
    const int p = i + q + j;
    const uint32_t tok = (uint32_t)(p < L ? row[p] : -1);
    h = (h ^ (tok * mult)) * mix + 1u;
  }
  match[(long long)b * L + i] = m ? 1 : 0;
  hash[(long long)b * L + i] = (long long)h;
}

}  // namespace

// Returns cudaGetLastError() of the launch.
extern "C" int ngram_match_launch(const int* buf, long long buf_sb,
                                  const int* query, long long query_sb,
                                  const int* cur_len, int* match,
                                  long long* hash, int B, int L, int q, int w,
                                  unsigned int mult, unsigned int mix,
                                  void* stream) {
  const dim3 grid((L + kThreads - 1) / kThreads, B);
  ngram_match_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, buf_sb, query, query_sb, cur_len, match, hash, L, q, w, mult, mix);
  return (int)cudaGetLastError();
}
