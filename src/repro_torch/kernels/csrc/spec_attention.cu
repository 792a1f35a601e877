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
// ancestors-or-self of input i.  A null anc selects the linear tail at run
// time (uniform across the grid), so K4 adds no template instance.
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
// Both kernels are one template: only the address of a cache row differs
// (cache_row), so the keys, their tiles (multiples of the key tile from slot
// 0), their order and the arithmetic are the same, and K3 over a pool equals
// K1 over the gathered linear view bit for bit.  A block loads the
// page-table entries its cur_len needs into shared memory once; a tile may
// span pages or lie inside one, any ps >= 1.
//
// What bounds it on the H100.  A (b, kv head) serves G*K*W1 packed query
// rows (g, i) from each cache key it reads, ~4*hd flops per (row, key).  At
// StableLM's main path (G=1, 110 rows, hd 64) that is ~440 flops per key
// of 256 bytes: below the card's ~295 bf16 flops per byte, bytes bound it.
// At the hybrid's GQA shape (G=8, 880 rows, hd 128) it is ~880 flops per
// byte: the tensor-core rate bounds it.  Measured on the card (PERF.md),
// the bf16 kernel below sits above both: at these small grids a tile's
// time goes to the SIMT work around the mma (the online softmax, the copy
// issue) and to latency at 8 warps per SM.
//
// The design, per dtype (the dtype selects; nothing else does):
// * bf16 (spec_attention_mma_kernel): tensor cores.  One block of 4 warps
//   per (b, kv head, 64 or 128 packed rows); each warp owns 16 rows, one
//   m16 A fragment of mma.sync.m16n8k16 (bf16 in, f32 accumulate), or two
//   fragments (32 rows) where a (b, kv head) has more than 64 rows (verify;
//   decode keeps one): each K/V fragment read from shared memory then
//   feeds two mma, and the cache is read by half as many blocks.  Q.K^T
//   reads K tiles stored [key][dim] (the col B operand) with ldmatrix, P.V
//   reads V tiles with ldmatrix.trans; P goes from the f32 accumulator to
//   two bf16 A fragments in registers, a head bf16(p) and the remainder
//   bf16(p - head), each through its own mma into the same f32 sum, so P
//   enters P.V with ~16 bits as the reference's f32 P does (one bf16
//   fragment lost a bit of the output at |out| >= 2 and shifted which
//   drafts bf16 accepts).  The online-softmax state (m, l) and O
//   live in the accumulator layout: a row's max and sum reduce across the
//   4 lanes of a quad; the running max moves only when a tile raises it
//   by more than 2^8 in p, so O is rarely rescaled.  K/V tiles of kN keys
//   (64 for one fragment at hd <= 64, else 32, which keeps the score
//   accumulators small) are copied into bf16 shared memory by cp.async,
//   double-buffered (tile t+1 in flight while tile t is computed), rows
//   padded by 16 bytes so that ldmatrix is free of bank conflicts; hd is
//   zero-padded to the instance's capacity (64, 128, 256), so the mma
//   loops have no run-time branch and ptxas can pipeline ldmatrix against
//   mma.  Copies are 16-byte cp.async where every row start is 16-byte
//   aligned, else plain 2-byte loads, as the wrapper finds (vec).  Q
//   fragments stay in registers where they fit
//   (16 x hd x fragments <= 16 x 128) and are read from shared memory per
//   k step otherwise.  The speculative tail is the last tiles of the same
//   loop: the block stages the K*W1 tail keys of its (b, kv head) once for
//   all G heads, the mask per (row, key) is the causal draft range
//   [i - i%W1, i] (linear) or the row's bit in a per-block bit mask
//   expanded from anc (K4), built once per row and tile as a 64-bit set
//   (a per-score test costs more than the rest of the softmax), and a
//   warp skips the tail tiles none of its rows sees.  Only tail tiles and
//   a partial last cache tile are masked.
// * f32 (spec_attention_simt_f32_kernel): exact f32 on the CUDA cores
//   (TF32 would break the lossless checks): lanes own keys for q.k and head
//   dims for p.v, 4 rows per warp, f32 shared-memory tiles, the tail read
//   per row from global memory.
// Both read cur_len from device memory in the block (no host sync, no
// padding) and stop at it; rows whose cache is empty get the tail-only
// softmax.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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
  int vec;                      // bf16: elements per copy (8 or 1)
};

// Offset of cache slot s of batch row b (before the head and dim offsets).
template <bool kPaged>
__device__ __forceinline__ long long cache_row(const Args& a, int b, int s,
                                               const int* pt_s) {
  if (kPaged)
    return (long long)pt_s[s / a.ps] * a.c_sb + (long long)(s % a.ps) * a.c_ss;
  return b * a.c_sb + (long long)s * a.c_ss;
}

// The block's page-table entries, clamped: -1 (unallocated) reads page 0.
__device__ __forceinline__ void load_pages(const Args& a, int b, int n_keys,
                                           int* pt_s) {
  const int n_pg = (n_keys + a.ps - 1) / a.ps;
  for (int i = threadIdx.x; i < n_pg; i += blockDim.x)
    pt_s[i] = max(a.page_table[(long long)b * a.pps + i], 0);
}

// ===========================================================================
// f32: exact arithmetic on the CUDA cores
// ===========================================================================
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;   // 32 query rows
constexpr int kTile = 64;                              // cache keys per tile
constexpr int kKeysPerLane = kTile / 32;

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

size_t simt_smem_bytes(int hd, int pps) {
  return sizeof(float) *
             (size_t(kTile) * (hd + 1) + size_t(kTile) * hd +
              size_t(kRowsPerBlock) * hd) +
         sizeof(int) * size_t(pps);
}

// DPL = head dims per lane (ceil(hd / 32)): lane owns dims lane + 32*c.
template <int DPL, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    spec_attention_simt_f32_kernel(const Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd;
  const int hdp = hd + 1;                      // padded: conflict-free q.k
  float* Ks = smem;                            // kTile x (hd + 1)
  float* Vs = Ks + kTile * hdp;                // kTile x hd
  float* Qs = Vs + kTile * hd;                 // kRowsPerBlock x hd
  int* pt_s = reinterpret_cast<int*>(Qs + kRowsPerBlock * hd);  // pps (K3)

  const float* q = static_cast<const float*>(a.q);
  const float* kc = static_cast<const float*>(a.kc);
  const float* vc = static_cast<const float*>(a.vc);
  const float* kt = static_cast<const float*>(a.kt);
  const float* vt = static_cast<const float*>(a.vt);
  float* out = static_cast<float*>(a.out);

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
      v = q[b * a.q_sb + i * a.q_si + (kvh * G + g) * a.q_sh + d];
    }
    Qs[idx] = v;
  }
  if (kPaged) load_pages(a, b, n_keys, pt_s);
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
        kv = kc[off];
        vv = vc[off];
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
          const float* kr = kt + b * a.t_sb + (long long)j * a.t_si +
                            kvh * a.t_sh;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
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
          const float* vr = vt + b * a.t_sb + (long long)j * a.t_si +
                            kvh * a.t_sh;
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) {
            const int d = lane + 32 * dd;
            if (d < hd) acc[rr][dd] = fmaf(pj, vr[d], acc[rr][dd]);
          }
        }
      }
      float* orow = out + b * a.q_sb + i * a.q_si + (kvh * G + g) * a.q_sh;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) orow[d] = acc[rr][dd] / l[rr];
      }
    }
  }
}

template <int DPL, bool kPaged>
cudaError_t launch_simt(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(a.hd, kPaged ? a.pps : 0);
  cudaError_t err = cudaFuncSetAttribute(
      spec_attention_simt_f32_kernel<DPL, kPaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_rows = (a.H / a.KV) * a.KW1;
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock, a.KV, B);
  spec_attention_simt_f32_kernel<DPL, kPaged>
      <<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kPaged>
cudaError_t launch_simt_hd(const Args& a, int B, cudaStream_t stream) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch_simt<1, kPaged>(a, B, stream);
    case 2: return launch_simt<2, kPaged>(a, B, stream);
    case 3: return launch_simt<3, kPaged>(a, B, stream);
    case 4: return launch_simt<4, kPaged>(a, B, stream);
    case 5: return launch_simt<5, kPaged>(a, B, stream);
    case 6: return launch_simt<6, kPaged>(a, B, stream);
    case 7: return launch_simt<7, kPaged>(a, B, stream);
    case 8: return launch_simt<8, kPaged>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ===========================================================================
// bf16: mma.sync tensor cores over cp.async tiles
// ===========================================================================
typedef __nv_bfloat16 bf16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
// A (b, kv head) with more packed rows than one block of single-fragment
// warps holds gives each warp two m16 fragments.
constexpr int kTwoFragmentRows = 64;

// HDC: the instance's head-dim capacity (64, 128 or 256); MF: the m16
// fragments (16 packed rows each) a warp owns.
template <int HDC, int MF> struct MmaCfg {
  static constexpr int kRows = kMmaWarps * 16 * MF;    // packed rows a block
  static constexpr int kN = HDC * MF <= 64 ? 64 : 32;  // keys per tile
  static constexpr int kStride = HDC + 8;              // smem row, elements
  static constexpr int kTileElems = kN * kStride;
  static constexpr int kChunks = HDC / 8;              // 16-byte row chunks
  static constexpr bool kQRegs = HDC * MF <= 128;      // Q fragments in regs
};

template <int HDC, int MF>
size_t mma_smem_bytes(int pps, int mask_words) {
  using C = MmaCfg<HDC, MF>;
  return sizeof(bf16) * (size_t(4) * C::kTileElems +
                         size_t(C::kRows) * C::kStride) +
         sizeof(int) * (size_t(pps) + size_t(mask_words));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One 16-byte shared chunk from `n` (0..8) bf16 at src, zero-filling the
// rest: one 16-byte cp.async where every row start is 16-byte aligned (vec
// 8), else plain 2-byte loads (vec 1); src is a readable address even when
// n is 0.
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, int n,
                                           int vec) {
  if (vec == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(2 * n));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = e < n ? src[e] : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) as a bf16 pair (hi) and the bf16 pair of what hi leaves out (lo)
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HDC, int MF, bool kPaged>
__global__ void __launch_bounds__(kMmaThreads)
    spec_attention_mma_kernel(const Args a) {
  using C = MmaCfg<HDC, MF>;
  constexpr int kN = C::kN, kStride = C::kStride, kRows = C::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);        // [2][kN][kStride]
  bf16* Vs = Ks + 2 * C::kTileElems;                   // [2][kN][kStride]
  bf16* Qs = Vs + 2 * C::kTileElems;                   // [kRows][kStride]
  int* pt_s = reinterpret_cast<int*>(Qs + kRows * kStride);  // pps (K3)
  unsigned* bits = reinterpret_cast<unsigned*>(pt_s + (kPaged ? a.pps : 0));

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kc = static_cast<const bf16*>(a.kc);
  const bf16* vc = static_cast<const bf16*>(a.vc);
  const bf16* kt = static_cast<const bf16*>(a.kt);
  const bf16* vt = static_cast<const bf16*>(a.vt);
  bf16* out = static_cast<bf16*>(a.out);

  const int hd = a.hd, KW1 = a.KW1, vec = a.vec;
  const int G = a.H / a.KV;
  const int n_rows = G * KW1;                  // (g, i) rows of this KV head
  const int row0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;     // accumulator row, column pair
  const int n_keys = max(0, min(a.cur_len[b], a.S));
  const int nw = (KW1 + 31) / 32;              // K4: mask words per row

  if (kPaged) load_pages(a, b, n_keys, pt_s);
  if (a.anc) {  // K4: row i's visible tail inputs as bits, one thread a row
    for (int i = tid; i < KW1; i += kMmaThreads) {
      unsigned* w = bits + i * nw;
      for (int k = 0; k < nw; ++k) w[k] = 0u;
      const int* arow = a.anc + (long long)i * a.anc_w;
      const int n = min(max(arow[0], 0), a.anc_w - 1);
      for (int k = 0; k < n; ++k) {
        const int j = arow[1 + k];
        if (j >= 0 && j < KW1) w[j >> 5] |= 1u << (j & 31);
      }
    }
  }
  __syncthreads();

  // The 2*MF accumulator rows of this thread and the tail keys they see:
  // [lo, hi] (linear: the row's draft up to itself; K4: its first and last
  // ancestor-or-self, the bits deciding in between).
  const int wrow0 = row0 + warp * 16 * MF;     // the warp's first row
  int lo[MF][2], hi[MF][2], irow[MF][2];       // irow: K4's bit-mask row
  int lo_w = KW1, hi_w = -1;
#pragma unroll
  for (int f = 0; f < MF; ++f) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow0 + f * 16 + gq + 8 * h;
      lo[f][h] = KW1;
      hi[f][h] = -1;
      irow[f][h] = 0;
      if (row < n_rows) {
        const int i = row % KW1;
        if (a.anc) {
          const int* arow = a.anc + (long long)i * a.anc_w;
          const int n = min(max(arow[0], 0), a.anc_w - 1);
          if (n > 0) {
            lo[f][h] = arow[1];
            hi[f][h] = arow[n];
          }
          irow[f][h] = i * nw;
        } else {
          lo[f][h] = (i / a.W1) * a.W1;
          hi[f][h] = i;
        }
      }
      lo_w = min(lo_w, lo[f][h]);
      hi_w = max(hi_w, hi[f][h]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo_w = min(lo_w, __shfl_xor_sync(kFull, lo_w, o));
    hi_w = max(hi_w, __shfl_xor_sync(kFull, hi_w, o));
  }
  const bool warp_live = wrow0 < n_rows;

  const int n_ct = (n_keys + kN - 1) / kN;     // cache tiles
  const int n_tiles = n_ct + (KW1 + kN - 1) / kN;

  // ---- staging: Q once, then K/V tile t into buffer st (cp.async);
  // dims past hd and keys past the tile's last are zero-filled ----
  for (int idx = tid; idx < kRows * C::kChunks; idx += kMmaThreads) {
    const int r = idx / C::kChunks, c = idx - r * C::kChunks;
    const int row = row0 + r;
    int n = 0;
    const bf16* src = q;
    if (row < n_rows) {
      const int g = row / KW1, i = row - g * KW1;
      n = min(max(hd - 8 * c, 0), 8);
      if (n) src = q + b * a.q_sb + i * a.q_si + (kvh * G + g) * a.q_sh + 8 * c;
    }
    copy_chunk(Qs + r * kStride + 8 * c, src, n, vec);
  }
  // Thread tid copies 16-byte column chunk lc of key rows lr, lr + kRowStep,
  // .. of every tile: its column, the column's valid elements and the
  // head's offset are fixed for the whole loop.
  constexpr int kRowStep = kMmaThreads / C::kChunks;
  const int lc = tid % C::kChunks, lr = tid / C::kChunks;
  const int n_c = min(max(hd - 8 * lc, 0), 8);
  const long long c_col = kvh * a.c_sh + 8 * lc;
  const long long t_col = b * a.t_sb + kvh * a.t_sh + 8 * lc;
  auto load_tile = [&](int t, int st) {
    const bool tail = t >= n_ct;
    const int base = (tail ? t - n_ct : t) * kN + lr;
    const int lim = tail ? KW1 : n_keys;
    bf16* kd = Ks + st * C::kTileElems + lr * kStride + 8 * lc;
    const bf16* ksrc = tail ? kt : kc;
    const bf16* vsrc = tail ? vt : vc;
#pragma unroll
    for (int p = 0; p < kN / kRowStep; ++p) {
      const int key = base + p * kRowStep;
      const int n = key < lim ? n_c : 0;
      long long off = 0;
      if (n > 0)
        off = tail ? t_col + (long long)key * a.t_si
                   : c_col + cache_row<kPaged>(a, b, key, pt_s);
      bf16* dk = kd + p * kRowStep * kStride;
      copy_chunk(dk, ksrc + off, n, vec);      // off 0 (the base) when n 0
      copy_chunk(dk + 2 * C::kTileElems, vsrc + off, n, vec);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  const float sl2 = a.scale * 1.4426950408889634f;     // scores -> log2
  float o[MF][HDC / 8][4];
  float m[MF][2], l[MF][2];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
#pragma unroll
    for (int d = 0; d < HDC / 8; ++d)
      o[f][d][0] = o[f][d][1] = o[f][d][2] = o[f][d][3] = 0.f;
    m[f][0] = m[f][1] = -INFINITY;
    l[f][0] = l[f][1] = 0.f;
  }
  unsigned qf[C::kQRegs ? MF : 1][C::kQRegs ? HDC / 16 : 1][4];
  // ldmatrix.x4 lane addressing: matrix mi = lane / 8, its row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  const bf16* q_lane = Qs + (warp * 16 * MF + (mi & 1) * 8 + mr) * kStride +
                       (mi >> 1) * 8;
  const bf16* k_lane = Ks + ((mi >> 1) * 8 + mr) * kStride + (mi & 1) * 8;
  const bf16* v_lane = Vs + ((mi & 1) * 8 + mr) * kStride + (mi >> 1) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();                         // tile t (and Q) landed
    __syncthreads();
    if constexpr (C::kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int f = 0; f < MF; ++f)
#pragma unroll
          for (int ks = 0; ks < HDC / 16; ++ks)
            ldsm_x4(smem_u32(q_lane + f * 16 * kStride + ks * 16), qf[f][ks]);
      }
    }
    const bool tail = t >= n_ct;
    const int base = (tail ? t - n_ct : t) * kN;     // first key of the tile
    const int n_valid = tail ? kN : min(kN, n_keys - base);
    // a warp computes the cache tiles and the tail tiles its rows can see
    if (warp_live && (!tail || (base <= hi_w && base + kN > lo_w))) {
      const unsigned kb = smem_u32(k_lane + (t & 1) * C::kTileElems);
      const unsigned vb = smem_u32(v_lane + (t & 1) * C::kTileElems);

      // ---- S = Q K^T ----
      float s[MF][kN / 8][4];
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int nb = 0; nb < kN / 8; ++nb)
          s[f][nb][0] = s[f][nb][1] = s[f][nb][2] = s[f][nb][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HDC / 16; ++ks) {
        unsigned af[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          if constexpr (C::kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) af[f][e] = qf[f][ks][e];
          } else {
            ldsm_x4(smem_u32(q_lane + f * 16 * kStride + ks * 16), af[f]);
          }
        }
#pragma unroll
        for (int k16 = 0; k16 < kN / 16; ++k16) {
          unsigned bk[4];
          ldsm_x4(kb + 2 * (16 * k16 * kStride + ks * 16), bk);
#pragma unroll
          for (int f = 0; f < MF; ++f) {
            mma16816(s[f][2 * k16], af[f], bk[0], bk[1]);
            mma16816(s[f][2 * k16 + 1], af[f], bk[2], bk[3]);
          }
        }
      }

      // ---- mask: keys past cur_len, tail keys outside the row's draft
      // (linear) or not its ancestors (K4).  Each accumulator row's
      // visible keys are one bit set over the tile (bit c: key base + c);
      // this lane holds keys 2*tq + 8*nb + {0, 1} ----
      if (tail || n_valid < kN) {
#pragma unroll
        for (int f = 0; f < MF; ++f) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            unsigned long long vis;
            if (!tail) {
              vis = n_valid >= 64 ? ~0ull : (1ull << n_valid) - 1;
            } else {
              const int c0 = max(lo[f][h] - base, 0);
              const int c1 = min(hi[f][h] - base, kN - 1);
              vis = c0 > c1 ? 0ull : (~0ull >> (63 - c1)) & (~0ull << c0);
              if (a.anc) {
                const unsigned* w = bits + irow[f][h] + base / 32;
                unsigned long long set = w[0];
                if (kN > 32 && base / 32 + 1 < nw)
                  set |= (unsigned long long)w[1] << 32;
                vis &= set;
              }
            }
            vis >>= 2 * tq;
#pragma unroll
            for (int nb = 0; nb < kN / 8; ++nb) {
              if (!((vis >> (8 * nb)) & 1ull)) s[f][nb][2 * h] = -INFINITY;
              if (!((vis >> (8 * nb + 1)) & 1ull))
                s[f][nb][2 * h + 1] = -INFINITY;
            }
          }
        }
      }

      // ---- online softmax in the accumulator layout (a row's 4 lanes).
      // The running max moves only when a tile's max exceeds it by more
      // than 8 in log2 units: until then p <= 2^8, exact in f32 and far
      // inside bf16's range, and O needs no rescale (a warp rescales when
      // any of its rows moved) ----
      float alpha[MF][2];
      bool moved = false;
#pragma unroll
      for (int f = 0; f < MF; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int nb = 0; nb < kN / 8; ++nb)
            mx = fmaxf(mx, fmaxf(s[f][nb][2 * h], s[f][nb][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          const bool move = mx * sl2 > m[f][h] * sl2 + 8.f;
          alpha[f][h] = move ? ex2((m[f][h] - mx) * sl2) : 1.f;
          if (move) m[f][h] = mx;
          moved |= move;
          const float mc = (m[f][h] == -INFINITY ? 0.f : m[f][h]) * sl2;
          float sum = 0.f;
#pragma unroll
          for (int nb = 0; nb < kN / 8; ++nb) {
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              s[f][nb][e] = ex2(fmaf(s[f][nb][e], sl2, -mc));
              sum += s[f][nb][e];
            }
          }
          l[f][h] = l[f][h] * alpha[f][h] + sum;
        }
      }
      if (__any_sync(kFull, moved)) {
#pragma unroll
        for (int f = 0; f < MF; ++f)
#pragma unroll
          for (int d = 0; d < HDC / 8; ++d) {
            o[f][d][0] *= alpha[f][0];
            o[f][d][1] *= alpha[f][0];
            o[f][d][2] *= alpha[f][1];
            o[f][d][3] *= alpha[f][1];
          }
      }

      // ---- O += P V (P as a bf16 head and remainder, each an A fragment
      // through its own mma; V through ldmatrix.trans) ----
#pragma unroll
      for (int k16 = 0; k16 < kN / 16; ++k16) {
        unsigned pa[MF][4], pr[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_bf16(s[f][2 * k16 + e / 2][2 * (e % 2)],
                       s[f][2 * k16 + e / 2][2 * (e % 2) + 1], pa[f][e],
                       pr[f][e]);
        }
#pragma unroll
        for (int d16 = 0; d16 < HDC / 16; ++d16) {
          unsigned bv[4];
          ldsm_x4_t(vb + 2 * (16 * k16 * kStride + d16 * 16), bv);
#pragma unroll
          for (int f = 0; f < MF; ++f) {
            mma16816(o[f][2 * d16], pa[f], bv[0], bv[1]);
            mma16816(o[f][2 * d16], pr[f], bv[0], bv[1]);
            mma16816(o[f][2 * d16 + 1], pa[f], bv[2], bv[3]);
            mma16816(o[f][2 * d16 + 1], pr[f], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();                           // buffer t&1 free for t+2
  }

  // ---- normalise and write this thread's rows ----
#pragma unroll
  for (int f = 0; f < MF; ++f) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[f][h];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const int row = wrow0 + f * 16 + gq + 8 * h;
      if (row >= n_rows) continue;
      const int g = row / KW1, i = row - g * KW1;
      bf16* orow = out + b * a.q_sb + i * a.q_si + (kvh * G + g) * a.q_sh;
      const float inv = 1.f / sum;
#pragma unroll
      for (int d8 = 0; d8 < HDC / 8; ++d8) {
        const int d = d8 * 8 + 2 * tq;
        if (d < hd) orow[d] = __float2bfloat16(o[f][d8][2 * h] * inv);
        if (d + 1 < hd)
          orow[d + 1] = __float2bfloat16(o[f][d8][2 * h + 1] * inv);
      }
    }
  }
}

template <int HDC, int MF, bool kPaged>
cudaError_t launch_mma(const Args& a, int B, cudaStream_t stream) {
  using C = MmaCfg<HDC, MF>;
  const int mask_words = a.anc ? a.KW1 * ((a.KW1 + 31) / 32) : 0;
  const size_t smem = mma_smem_bytes<HDC, MF>(kPaged ? a.pps : 0, mask_words);
  cudaError_t err = cudaFuncSetAttribute(
      spec_attention_mma_kernel<HDC, MF, kPaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_rows = (a.H / a.KV) * a.KW1;
  const dim3 grid((n_rows + C::kRows - 1) / C::kRows, a.KV, B);
  spec_attention_mma_kernel<HDC, MF, kPaged>
      <<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instance: head-dim capacity from hd, two fragments a warp where a
// (b, kv head) has more than kTwoFragmentRows packed rows (hd <= 128).
template <bool kPaged>
cudaError_t launch_mma_hd(const Args& a, int B, cudaStream_t stream) {
  if (!(a.vec == 8 || a.vec == 1))
    return cudaErrorInvalidValue;
  const bool two = (a.H / a.KV) * a.KW1 > kTwoFragmentRows;
  if (a.hd <= 64)
    return two ? launch_mma<64, 2, kPaged>(a, B, stream)
               : launch_mma<64, 1, kPaged>(a, B, stream);
  if (a.hd <= 128)
    return two ? launch_mma<128, 2, kPaged>(a, B, stream)
               : launch_mma<128, 1, kPaged>(a, B, stream);
  if (a.hd <= 256) return launch_mma<256, 1, kPaged>(a, B, stream);
  return cudaErrorInvalidValue;
}

template <bool kPaged>
int launch_dtype(int dtype, const Args& a, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_simt_hd<kPaged>(a, B, st);
  if (dtype == 1) return (int)launch_mma_hd<kPaged>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  anc: null (K1) or K4's ancestor table
// (KW1, anc_w) int32.  vec: bf16 elements per copy, 8 (16-byte cp.async)
// where every row start of q, caches and tails is 16-byte aligned, else 1
// (plain loads).  Returns cudaGetLastError() of the launch.
extern "C" int spec_attention_launch(
    int dtype, const void* q, const void* k_cache, const void* v_cache,
    const void* k_tail, const void* v_tail, const int* cur_len,
    const int* anc, void* out, int B, int KW1, int W1, int H, int KV, int hd,
    int S, int anc_w, int vec, long long q_sb, long long q_si, long long q_sh,
    long long c_sb, long long c_ss, long long c_sh, long long t_sb,
    long long t_si, long long t_sh, float scale, void* stream) {
  Args a{q,    k_cache, v_cache, k_tail, v_tail, cur_len, anc,    out,
         KW1,  W1,      H,       KV,     hd,     S,       anc_w,  q_sb,
         q_si, q_sh,    c_sb,    c_ss,   c_sh,   t_sb,    t_si,   t_sh,
         scale, nullptr, 1,      0,      vec};
  return launch_dtype<false>(dtype, a, B, stream);
}

// K3 (K4 over the pool when anc is given): the pool (NP, ps, KV, hd) has
// page stride p_sp, in-page stride p_ss and head stride p_sh; page_table
// (B, pps) int32 contiguous.
extern "C" int paged_spec_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const void* k_tail, const void* v_tail,
    const int* cur_len, const int* anc, void* out, int B, int KW1, int W1,
    int H, int KV, int hd, int ps, int pps, int anc_w, int vec,
    long long q_sb, long long q_si, long long q_sh, long long p_sp,
    long long p_ss, long long p_sh, long long t_sb, long long t_si,
    long long t_sh, float scale, void* stream) {
  Args a{q,    k_pool, v_pool, k_tail, v_tail, cur_len,  anc,   out,
         KW1,  W1,     H,      KV,     hd,     ps * pps, anc_w, q_sb,
         q_si, q_sh,   p_sp,   p_ss,   p_sh,   t_sb,     t_si,  t_sh,
         scale, page_table, ps, pps, vec};
  return launch_dtype<true>(dtype, a, B, stream);
}
