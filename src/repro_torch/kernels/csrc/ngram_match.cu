// K2 for Hopper: one step's context-strategy drafts in one launch.
//
// Replaces the TPU kernel repro/kernels/ngram_match.py:ngram_match_call
// (body _kernel, the match/hash sweep) together with what the reference
// leaves to XLA around it: the query slice, the (count, recency) scoring and
// top-k of repro/core/drafters.py:_score_topk_row, and, for the mixed
// strategy, mixed_draft's compaction, dedup and bigram fill.  One block per
// batch row b, with cur = buf_len[b]:
//
//   query    = buf[b, s : s+q], s = clamp(cur - q, 0, L - q)
//   match[i] = buf[b, i:i+q] == query and i + q + w <= cur and cur >= q + 1
//   hash[i]  = h_w over buf[b, i+q : i+q+w], h_0 = 0,
//              h_{j+1} = (h_j ^ (tok_j * mult)) * mix + 1   (uint32)
//
// An unmatched position hashes as the SENTINEL 0xFFFFFFFF.  A matched
// position's count is the number of positions of the row holding its hash,
// so a matched position whose hash is itself 0xFFFFFFFF also counts every
// unmatched one (L - M of them, M the matches).  The latest matched position
// of each hash represents it; the first min(k, #representatives) rows are
// the representatives by (count, position), largest first, each the w
// tokens after its query match.  Positions at or past L read as -1.
//
//   context: drafts[b, r] = that row for r < n_ctx, else zeros;
//            valid[b, r]  = r < n_ctx.
//   mixed:   rows r >= n_ctx take the extended bigram rows of last[b]
//            (topk[last, j], chain[topk[last, j], :w-1]), those that do not
//            repeat a context row first, each group in index order;
//            valid all true.
//   n_ctx[b] = min(k, #representatives).
//
// Bound on the H100: bytes (the row read once, ~11 KB at the main path's
// shape) -- far below one launch, so the design is about doing the whole
// function in one launch, and about work that scales with the matches M
// rather than with L: the sweep counts the matches, hashes only the matched
// positions and compacts them as 64-bit (hash << 32 | position) keys
// (warp ballot, one shared counter a warp); a bitonic sort of the M keys
// (position in the low half makes it total, so equal hashes stay in
// position order); each run of equal hashes is one bucket, whose last key
// is its representative and whose length its count, rewritten in place as
// (count << 32 | position); k rounds of a block max take the top k.  Up to
// 64 keys one warp does all of that with no block barrier.  Keys live in
// shared memory up to smem_keys, else in the caller's global scratch (M can
// reach L: a row of one repeated token matches everywhere).  One block a
// row: at L = 32768 and B = 2 two of the 132 SMs work (PERF.md section 7).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kPad = ~0ull;                // sorts after every real key
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kWarpOnly = 64;              // keys one warp sorts alone

struct Args {
  const int* buf;
  long long buf_sb;
  const int* buf_len;
  const int* last;                         // mixed only, else nullptr
  const int* big_topk;
  long long topk_sb;
  const int* big_chain;
  long long chain_sb;
  int* drafts;                             // (B, k, w)
  unsigned char* valid;                    // (B, k)
  int* n_ctx;                              // (B,)
  u64* scratch;                            // (B, scratch_sb) or nullptr
  long long scratch_sb;
  int L, q, k, w, smem_keys;
  uint32_t mult, mix;
};

__device__ __forceinline__ int tok(const int* row, int L, long long p) {
  return p < L ? row[p] : -1;
}

__device__ __forceinline__ void group_sync(bool warp_only) {
  if (warp_only) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Sum over the block; every thread gets it.
__device__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// Max over warp 0 (warp_only) or the block; every thread of it gets it.
__device__ u64 group_max(u64 v, bool warp_only, u64* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 u = __shfl_xor_sync(~0u, v, o);
    v = u > v ? u : v;
  }
  if (warp_only) return v;
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) {
    const u64 u = __shfl_xor_sync(~0u, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// Ascending bitonic sort of P (a power of two) keys by threads t0 + i*nt.
__device__ void bitonic_sort(u64* keys, int P, int t0, int nt,
                             bool warp_only) {
  for (int kk = 2; kk <= P; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int t = t0; t < (P >> 1); t += nt) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i | j;
        const u64 a = keys[i], c = keys[l];
        if ((a > c) == ((i & kk) == 0)) {
          keys[i] = c;
          keys[l] = a;
        }
      }
      group_sync(warp_only);
    }
  }
}

// Sorted (hash, position) keys -> (count << 32 | position) at the last key
// of each equal-hash run (its latest position), 0 elsewhere.  Each thread
// walks a contiguous chunk; a run that enters the chunk from the left gets
// its start by a binary search made before any key is rewritten.
__device__ void reps_in_place(u64* keys, int M, int L, int t0, int nt,
                              bool warp_only) {
  const int C = (M + nt - 1) / nt;
  const int s0 = min(M, t0 * C), s1 = min(M, s0 + C);
  u64 after = kPad;
  int start = s0;
  uint32_t prev = 0;
  if (s0 < s1) {
    if (s1 < M) after = keys[s1];
    prev = (uint32_t)(keys[s0] >> 32);
    int lo = 0, hi = s0;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((uint32_t)(keys[mid] >> 32) < prev) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    start = lo;
  }
  group_sync(warp_only);
  for (int s = s0; s < s1; ++s) {
    const u64 cur = keys[s];
    const uint32_t h = (uint32_t)(cur >> 32);
    if (h != prev) start = s;
    prev = h;
    const u64 nxt = s + 1 < s1 ? keys[s + 1] : after;
    u64 rk = 0;
    if (s + 1 == M || (uint32_t)(nxt >> 32) != h) {
      const long long cnt =
          (long long)(s - start + 1) + (h == kSentinel ? L - M : 0);
      rk = ((u64)cnt << 32) | (cur & 0xFFFFFFFFull);
    }
    keys[s] = rk;
  }
  group_sync(warp_only);
}

__global__ void __launch_bounds__(1024) ngram_draft_kernel(Args a) {
  extern __shared__ u64 smem[];
  __shared__ int red[32];
  __shared__ u64 red64[32];
  __shared__ int s_count, s_n;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int L = a.L, q = a.q, k = a.k, w = a.w;
  u64* top = smem + a.smem_keys;                       // (k,)
  int* ctx = reinterpret_cast<int*>(top + k);          // (k, w)
  int* dup = ctx + k * w;                              // (k,)
  int* seq = dup + k;                                  // (k,)
  int* query = seq + k;                                // (q,)
  const int* row = a.buf + b * a.buf_sb;
  const int cur = a.buf_len[b];

  for (int j = tid; j < q; j += blockDim.x) {
    query[j] = row[max(0, min(cur - q, L - q)) + j];
  }
  if (tid == 0) s_count = 0;
  __syncthreads();
  // positions whose window ends inside the committed context
  const int n_pos = cur >= q + 1 ? max(0, min(L, cur - q - w + 1)) : 0;
  auto matches = [&](int i) {
    bool m = true;
    for (int j = 0; j < q; ++j) m = m && tok(row, L, i + j) == query[j];
    return m;
  };
  int c = 0;
  for (int i = tid; i < n_pos; i += blockDim.x) c += matches(i);
  const int M = block_sum(c, red);
  int P = 1;
  while (P < M) P <<= 1;
  u64* keys = P <= a.smem_keys ? smem : a.scratch + b * a.scratch_sb;
  for (int i0 = 0; i0 < n_pos; i0 += blockDim.x) {
    const int i = i0 + tid;
    const bool m = i < n_pos && matches(i);
    const unsigned bal = __ballot_sync(~0u, m);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&s_count, __popc(bal));
    base = __shfl_sync(~0u, base, 0);
    if (m) {
      uint32_t h = 0u;
      for (int j = 0; j < w; ++j) {
        const uint32_t t = (uint32_t)tok(row, L, (long long)i + q + j);
        h = (h ^ (t * a.mult)) * a.mix + 1u;
      }
      keys[base + __popc(bal & ((1u << lane) - 1u))] =
          ((u64)h << 32) | (u64)i;
    }
  }
  for (int s = M + tid; s < P; s += blockDim.x) keys[s] = kPad;
  __syncthreads();

  if (M == 0) {
    if (tid == 0) s_n = 0;
  } else {
    const bool warp_only = P <= kWarpOnly;
    if (!warp_only || tid < 32) {
      const int nt = warp_only ? 32 : blockDim.x;
      bitonic_sort(keys, P, tid, nt, warp_only);
      reps_in_place(keys, M, L, tid, nt, warp_only);
      u64 prev = kPad;
      int n = 0;
      for (; n < k; ++n) {
        u64 best = 0;
        for (int s = tid; s < M; s += nt) {
          const u64 v = keys[s];
          if (v < prev && v > best) best = v;
        }
        best = group_max(best, warp_only, red64);
        if (best == 0) break;
        if (tid == 0) top[n] = best;
        prev = best;
      }
      if (tid == 0) s_n = n;
    }
  }
  __syncthreads();

  const int n = s_n;
  for (int e = tid; e < n * w; e += blockDim.x) {
    const long long pos = (long long)(top[e / w] & 0xFFFFFFFFull);
    ctx[e] = tok(row, L, pos + q + e % w);
  }
  __syncthreads();
  int* out = a.drafts + (long long)b * k * w;
  unsigned char* vout = a.valid + (long long)b * k;
  if (a.last == nullptr) {
    for (int e = tid; e < k * w; e += blockDim.x) {
      out[e] = e / w < n ? ctx[e] : 0;
    }
    for (int r = tid; r < k; r += blockDim.x) vout[r] = r < n;
  } else {
    const int* cand = a.big_topk + (long long)a.last[b] * a.topk_sb;
    // bigram candidate j is a duplicate when it equals a context row in use
    for (int j = tid; j < k; j += blockDim.x) {
      const int f = cand[j];
      const int* chain = a.big_chain + (long long)f * a.chain_sb;
      bool d = false;
      for (int r = 0; r < n && !d; ++r) {
        bool same = ctx[r * w] == f;
        for (int t = 1; t < w && same; ++t) {
          same = ctx[r * w + t] == chain[t - 1];
        }
        d = same;
      }
      dup[j] = d;
    }
    __syncthreads();
    // stable order: the non-duplicates, then the duplicates
    for (int j = tid; j < k; j += blockDim.x) {
      int n_keep = 0, before = 0;
      for (int i = 0; i < k; ++i) {
        n_keep += !dup[i];
        before += i < j && dup[i] == dup[j];
      }
      seq[dup[j] ? n_keep + before : before] = j;
    }
    __syncthreads();
    for (int e = tid; e < k * w; e += blockDim.x) {
      const int r = e / w, t = e % w;
      int v;
      if (r < n) {
        v = ctx[e];
      } else {
        const int f = cand[seq[r - n]];
        v = t == 0 ? f : a.big_chain[(long long)f * a.chain_sb + t - 1];
      }
      out[e] = v;
    }
    for (int r = tid; r < k; r += blockDim.x) vout[r] = 1;
  }
  if (tid == 0) a.n_ctx[b] = n;
}

}  // namespace

// Returns cudaGetLastError() of the launch (or the error of raising the
// block's shared-memory limit to what smem_keys keys and the rows need).
extern "C" int ngram_draft_launch(
    const int* buf, long long buf_sb, const int* buf_len, const int* last,
    const int* big_topk, long long topk_sb, const int* big_chain,
    long long chain_sb, int* drafts, unsigned char* valid, int* n_ctx,
    unsigned long long* scratch, long long scratch_sb, int B, int L, int q,
    int k, int w, int smem_keys, int threads, unsigned int mult,
    unsigned int mix, void* stream) {
  static long long smem_limit = 48 * 1024;
  const long long smem =
      8LL * (smem_keys + k) + 4LL * ((long long)k * w + 2LL * k + q);
  if (smem > smem_limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        ngram_draft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_limit = smem;
  }
  Args a{buf,    buf_sb, buf_len, last,    big_topk,   topk_sb,
         big_chain, chain_sb, drafts, valid, n_ctx, scratch, scratch_sb,
         L,      q,      k,       w,       smem_keys,  mult,    mix};
  ngram_draft_kernel<<<B, threads, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
