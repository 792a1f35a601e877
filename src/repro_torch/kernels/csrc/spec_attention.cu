// K1, K3 and K4 for Hopper: bifurcated speculative-verification attention
// over a linear (K1) or a paged (K3) KV cache, and its tree variant (K4) over
// either.
//
// K1 replaces the TPU kernel repro/kernels/spec_attention.py:
// spec_attention_call (body _kernel), K3 replaces paged_spec_attention_call
// (body _paged_kernel).  For every batch row b and query row i = (draft r, offset t)
// of the (K*W1) verify block, per head h:
//
//   out[b,i,h] = softmax( q.k / sqrt(hd) over  cache slots s < cur_len[b]
//                                          and tail keys j with j/W1 == i/W1,
//                                                          j%W1 <= i%W1 ) . v
//
// K4 replaces the reference's tree tail_mask operand of both kernels
// (_pad_mask and the mask select in _kernel): the tail keys of row i are
// instead the entries of row i of an ancestor table anc (K*W1, anc_w) int32,
// [n_i, a_0 < a_1 < .. < a_{n_i-1}, -1 ..] -- the tree inputs that are
// ancestors-or-self of input i.  The row walks its <= depth+1 ancestors in
// ascending order, the order in which a masked scan over all K*W1 inputs
// would meet them, so the tail costs what a linear row's does.  A null anc
// selects the linear tail at run time (uniform across the grid), so K4 adds
// no template instance to the build.
//
// GQA maps head h to KV head h / G.  Accumulation is f32; out has q's dtype.
//
// Layout: the engine's own, read through strides.  q/out (B, K*W1, H, hd);
// caches (B, S, KV, hd) -- a layer's view of the (R, B, S, KV, hd) state;
// tails (B, K*W1, KV, hd).  The last dim of every operand is contiguous.
// K3 reads a pool (NP, ps, KV, hd) -- a layer's view of the engine's
// (R, NP, ps, KV, hd) pool -- through the (B, PPS) page table: cache slot s
// of row b is pool row (page_table[b, s / ps], s % ps), a -1 page reads
// page 0 (every slot it covers is >= cur_len[b], so the mask hides it).
// Both kernels are one template: only the address of a cache row differs,
// so the keys, their order and the arithmetic are the same, and K3 over a
// pool equals K1 over the gathered linear view bit for bit.  A block loads
// the page-table entries its cur_len needs into shared memory once; a 64-key
// tile may span pages (ps < 64) or lie inside one (ps >= 64), any ps >= 1.
//
// Bound on the H100: bytes.  A verify call reads each committed cache row of
// its (b, kv head) once and does about 4*hd flops per (query row, key); at
// the main path's k*(w+1) = 110 rows and hd 64 that is far below the card's
// ~295 bf16 flops per byte.  Design for that bound: one block per
// (b, kv head, tile of 32 query rows) holds the G query heads of its KV
// head, so a cache tile staged in shared memory serves every head that
// reads it; the loop stops at cur_len[b], read by the block itself from
// device memory (no host sync, no per-call padding of the cache).  Within a
// tile, lanes own keys for the q.k products and head dims for p.v; the
// online-softmax state (m, l, acc) of a warp's 4 rows lives in registers.
// The speculative tail is the last step of the same loop: each row folds in
// only the <= W1 tail keys of its own draft, read straight from global
// memory.  Rows whose cache is empty (cur_len 0) get the tail-only softmax.
// This first version uses no tensor cores, TMA or wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;   // 32 query rows
constexpr int kTile = 64;                              // cache keys per tile
constexpr int kKeysPerLane = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const void* kt;
  const void* vt;
  const int* cur_len;
  const int* anc;               // K4 only: (KW1, anc_w) ancestor table
  void* out;
  int KW1, W1, H, KV, hd, S, anc_w;
  long long q_sb, q_si, q_sh;   // q and out (B, KW1, H, hd)
  long long c_sb, c_ss, c_sh;   // caches (B, S, KV, hd); paged: the pool
                                // (NP, ps, KV, hd), c_sb its page stride
  long long t_sb, t_si, t_sh;   // tails (B, KW1, KV, hd)
  float scale;
  const int* page_table;        // paged only: (B, pps) int32, contiguous
  int ps, pps;                  // paged only: page size, pages per slot
};

size_t smem_bytes(int hd, int pps) {
  return sizeof(float) *
             (size_t(kTile) * (hd + 1) + size_t(kTile) * hd +
              size_t(kRowsPerBlock) * hd) +
         sizeof(int) * size_t(pps);
}

// Offset of cache slot s of batch row b (before the head and dim offsets).
template <bool kPaged>
__device__ __forceinline__ long long cache_row(const Args& a, int b, int s,
                                               const int* pt_s) {
  if (kPaged)
    return (long long)pt_s[s / a.ps] * a.c_sb + (long long)(s % a.ps) * a.c_ss;
  return b * a.c_sb + (long long)s * a.c_ss;
}

// DPL = head dims per lane (ceil(hd / 32)): lane owns dims lane + 32*c.
template <typename T, int DPL, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    spec_attention_kernel(const Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd;
  const int hdp = hd + 1;                      // padded: conflict-free q.k
  float* Ks = smem;                            // kTile x (hd + 1)
  float* Vs = Ks + kTile * hdp;                // kTile x hd
  float* Qs = Vs + kTile * hd;                 // kRowsPerBlock x hd
  int* pt_s = reinterpret_cast<int*>(Qs + kRowsPerBlock * hd);  // pps (K3)

  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.kc);
  const T* vc = static_cast<const T*>(a.vc);
  const T* kt = static_cast<const T*>(a.kt);
  const T* vt = static_cast<const T*>(a.vt);
  T* out = static_cast<T*>(a.out);

  const int G = a.H / a.KV;
  const int n_rows = G * a.KW1;                // (g, i) rows of this KV head
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_keys = max(0, min(a.cur_len[b], a.S));

  // stage the block's query rows: row -> (head kvh*G + row/KW1, i = row%KW1)
  for (int idx = threadIdx.x; idx < kRowsPerBlock * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, row = row0 + r;
    float v = 0.f;
    if (row < n_rows) {
      const int g = row / a.KW1, i = row - g * a.KW1;
      v = to_f(q[b * a.q_sb + i * a.q_si + (kvh * G + g) * a.q_sh + d]);
    }
    Qs[idx] = v;
  }
  if (kPaged) {  // the row's pages, clamped: -1 (unallocated) reads page 0
    const int n_pg = (n_keys + a.ps - 1) / a.ps;
    for (int i = threadIdx.x; i < n_pg; i += kThreads)
      pt_s[i] = max(a.page_table[(long long)b * a.pps + i], 0);
  }
  __syncthreads();

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[rr][c] = 0.f;
  }

  // ---- shared cache: online softmax over tiles of committed slots ----
  for (int s0 = 0; s0 < n_keys; s0 += kTile) {
    const int n_tile = min(kTile, n_keys - s0);
    for (int idx = threadIdx.x; idx < kTile * hd; idx += kThreads) {
      const int s = idx / hd, d = idx - s * hd;
      float kv = 0.f, vv = 0.f;
      if (s < n_tile) {
        const long long off =
            cache_row<kPaged>(a, b, s0 + s, pt_s) + kvh * a.c_sh + d;
        kv = to_f(kc[off]);
        vv = to_f(vc[off]);
      }
      Ks[s * hdp + d] = kv;
      Vs[s * hd + d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;   // warp-uniform
      if (row0 + r < n_rows) {
        const float* qr = Qs + r * hd;
        float p[kKeysPerLane];
        float tmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          const int j = lane + 32 * c;
          float s = -INFINITY;
          if (j < n_tile) {
            const float* kr = Ks + j * hdp;
            float dot = 0.f;
            for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
            s = dot * a.scale;
          }
          p[c] = s;
          tmax = fmaxf(tmax, s);
        }
        const float m_new = fmaxf(m[rr], warp_max(tmax));
        const float alpha = expf(m[rr] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          p[c] = (lane + 32 * c < n_tile) ? expf(p[c] - m_new) : 0.f;
          psum += p[c];
        }
        l[rr] = l[rr] * alpha + warp_sum(psum);
        m[rr] = m_new;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[rr][c] *= alpha;
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          const int nj = min(32, n_tile - 32 * c);
          for (int jj = 0; jj < nj; ++jj) {
            const float pj = __shfl_sync(kFull, p[c], jj);
            const float* vr = Vs + (32 * c + jj) * hd;
#pragma unroll
            for (int dd = 0; dd < DPL; ++dd) {
              const int d = lane + 32 * dd;
              if (d < hd) acc[rr][dd] = fmaf(pj, vr[d], acc[rr][dd]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- speculative tail: each row's own draft (causal) or, K4, its
  // ancestors-or-self in the tree; then write ----
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int row = row0 + r;
    if (row < n_rows) {
      const int g = row / a.KW1, i = row - g * a.KW1;
      // tail key t of this row: first + t (linear), arow[t] (K4)
      const int first = (i / a.W1) * a.W1;
      const int* arow = a.anc ? a.anc + (long long)i * a.anc_w + 1 : nullptr;
      const int n_vis = arow ? min(max(arow[-1], 0), a.anc_w - 1)
                             : i - first + 1;
      const float* qr = Qs + r * hd;
      for (int t0 = 0; t0 < n_vis; t0 += 32) {
        const int t = t0 + lane;
        float s = -INFINITY;
        if (t < n_vis) {
          const int j = arow ? arow[t] : first + t;
          const T* kr = kt + b * a.t_sb + (long long)j * a.t_si +
                        kvh * a.t_sh;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], to_f(kr[d]), dot);
          s = dot * a.scale;
        }
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float alpha = expf(m[rr] - m_new);
        const float p = (t < n_vis) ? expf(s - m_new) : 0.f;
        l[rr] = l[rr] * alpha + warp_sum(p);
        m[rr] = m_new;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[rr][c] *= alpha;
        const int nt = min(32, n_vis - t0);
        for (int jj = 0; jj < nt; ++jj) {
          const float pj = __shfl_sync(kFull, p, jj);
          const int j = arow ? arow[t0 + jj] : first + t0 + jj;
          const T* vr = vt + b * a.t_sb + (long long)j * a.t_si +
                        kvh * a.t_sh;
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) {
            const int d = lane + 32 * dd;
            if (d < hd) acc[rr][dd] = fmaf(pj, to_f(vr[d]), acc[rr][dd]);
          }
        }
      }
      T* orow = out + b * a.q_sb + i * a.q_si + (kvh * G + g) * a.q_sh;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) orow[d] = from_f<T>(acc[rr][dd] / l[rr]);
      }
    }
  }
}

template <typename T, int DPL, bool kPaged>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.hd, kPaged ? a.pps : 0);
  cudaError_t err = cudaFuncSetAttribute(
      spec_attention_kernel<T, DPL, kPaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_rows = (a.H / a.KV) * a.KW1;
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock, a.KV, B);
  spec_attention_kernel<T, DPL, kPaged><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kPaged>
cudaError_t launch_hd(const Args& a, int B, cudaStream_t stream) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch<T, 1, kPaged>(a, B, stream);
    case 2: return launch<T, 2, kPaged>(a, B, stream);
    case 3: return launch<T, 3, kPaged>(a, B, stream);
    case 4: return launch<T, 4, kPaged>(a, B, stream);
    case 5: return launch<T, 5, kPaged>(a, B, stream);
    case 6: return launch<T, 6, kPaged>(a, B, stream);
    case 7: return launch<T, 7, kPaged>(a, B, stream);
    case 8: return launch<T, 8, kPaged>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPaged>
int launch_dtype(int dtype, const Args& a, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_hd<float, kPaged>(a, B, st);
  if (dtype == 1) return (int)launch_hd<__nv_bfloat16, kPaged>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  anc: null (K1) or K4's ancestor table
// (KW1, anc_w) int32.  Returns cudaGetLastError() of the launch.
extern "C" int spec_attention_launch(
    int dtype, const void* q, const void* k_cache, const void* v_cache,
    const void* k_tail, const void* v_tail, const int* cur_len,
    const int* anc, void* out, int B, int KW1, int W1, int H, int KV, int hd,
    int S, int anc_w, long long q_sb, long long q_si, long long q_sh,
    long long c_sb, long long c_ss, long long c_sh, long long t_sb,
    long long t_si, long long t_sh, float scale, void* stream) {
  Args a{q,    k_cache, v_cache, k_tail, v_tail, cur_len, anc,    out,
         KW1,  W1,      H,       KV,     hd,     S,       anc_w,  q_sb,
         q_si, q_sh,    c_sb,    c_ss,   c_sh,   t_sb,    t_si,   t_sh,
         scale, nullptr, 1,      0};
  return launch_dtype<false>(dtype, a, B, stream);
}

// K3 (K4 over the pool when anc is given): the pool (NP, ps, KV, hd) has
// page stride p_sp, in-page stride p_ss and head stride p_sh; page_table
// (B, pps) int32 contiguous.
extern "C" int paged_spec_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const void* k_tail, const void* v_tail,
    const int* cur_len, const int* anc, void* out, int B, int KW1, int W1,
    int H, int KV, int hd, int ps, int pps, int anc_w, long long q_sb,
    long long q_si, long long q_sh, long long p_sp, long long p_ss,
    long long p_sh, long long t_sb, long long t_si, long long t_sh,
    float scale, void* stream) {
  Args a{q,    k_pool, v_pool, k_tail, v_tail, cur_len,  anc,   out,
         KW1,  W1,     H,      KV,     hd,     ps * pps, anc_w, q_sb,
         q_si, q_sh,   p_sp,   p_ss,   p_sh,   t_sb,     t_si,  t_sh,
         scale, page_table, ps, pps};
  return launch_dtype<true>(dtype, a, B, stream);
}
