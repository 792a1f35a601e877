// K5 for Hopper: the Mamba selective scan.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py:mamba_scan_call (body
// _kernel).  For every batch row b, channel d < di and step t < T, with the
// (ds,) state h of (b, d) starting at h0[b / h0_rep, d, :]:
//
//   h        = exp(dt[b,t,d] * A[d,:]) * h + (dt[b,t,d] * u[b,t,d]) * B[b,t,:]
//   y[b,t,d] = h . C[b,t,:] + u[b,t,d] * D[d]
//
// hT[b,d,:] is h after the last step (skipped when hT is null), or, given
// n_commit, h after min(n_commit[b], T) steps (h0's row where that is 0):
// the speculative replay's commit, which keeps the state after the
// accepted tokens (the state after every step is never written).  u is
// f32 or bf16 (the layer's compute dtype, upcast in registers as the
// reference kernel does); everything else is f32.  h0_rep > 1 lets Bt =
// rows * h0_rep verify rows start from their slot's state (row b reads h0
// row b / h0_rep) without a repeated copy of h0.
//
// Bound on the H100, at the prefill shape (Bt, T, di, ds) = (8, 256, 16384,
// 16): 537 M exps on the special-function units (16 per clock per SM, 132
// SMs) take ~0.13 ms, and u, dt, y and the states, ~0.35-0.42 GB moved once
// (bf16 or f32 u), ~0.10-0.125 ms: the exps bound it.  At the verify shape
// (80, 11, ...) both limits are near; the replay and decode are bound by
// bytes.
//
// Design for that bound.  The TPU kernel carries the state in VMEM across a
// sequential grid axis of T-chunks and runs an associative scan inside each
// chunk, because a TPU core is one wide sequential machine.  Here the
// parallelism is across (b, d), and each channel's recurrence walks t in
// order with its state in registers, so the state never goes to device
// memory between steps and every step sums in the same order whatever T
// the caller chose: prefill, verify, decode and replay compute a token's
// state, and its y, with the same arithmetic, bit for bit.
// * A channel's DS states are split over G = DS / 4 neighbouring lanes, 4
//   each (one 16-byte slice): few registers a thread, many blocks (4096 of
//   128 threads at prefill), and h0 / hT move as one 16-byte access a
//   lane, 512 contiguous bytes a warp instruction.  Each lane writes its
//   part of h . C to shared memory; at the chunk's end the block sums the
//   G parts of each (step, channel) in a fixed order, adds u * D and
//   stores y coalesced.
// * Loads overlap the recurrence: a block stages kChunk steps of its u / dt
//   tile (kChunk x channels) and of B / C (rows of the x_proj output, any
//   row stride) in shared memory by 16-byte cp.async, double-buffered, so
//   chunk i+1 is in flight while chunk i computes; every staging loop has
//   a compile-time trip count.  Where a row start is not 16-byte aligned the block stages with plain loads
//   instead (vec_tile, found by the launcher).  Rows past T are
//   zero-filled; the steps walk in unrolled groups of kGroup, and in a
//   chunk's last group the steps past its end keep h and store nothing.
// * A verify block walks the h0_rep draft rows of one slot one after the
//   other through the same pipeline: the rows share one read of h0, A and
//   D, and a row's loads overlap the previous row's steps.
// * exp(dt * A) is one FMUL and one ex2.approx.ftz with A * log2(e) kept in
//   registers.
// ds is a template capacity (4, 8 or 16) with a run-time guard; ds > 16 is
// refused.  Whether the final state is the last one or the one after
// n_commit steps selects the instance (kSelect).  No tensor cores: the
// scan has no matrix product.
// * Training's instance (kCkpt) also writes the state before every kChunk-th
//   step, (Bt, n_chunks, di, ds), for K5's backward (mamba_scan_bwd.cu),
//   which rebuilds each chunk's states from it instead of walking the
//   scan again: one 16-byte store a lane a chunk, y's and hT's arithmetic
//   unchanged.  The serving instances (kCkpt false) compile as before.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // lanes a block
constexpr int kChunk = 16;      // steps a shared-memory stage
constexpr int kGroup = 4;       // steps an unrolled group
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* u;       // (Bt, T, di) contiguous, f32 or bf16
  const float* dt;     // (Bt, T, di) contiguous
  const float* A;      // (di, ds) contiguous
  const float* Bm;     // (Bt, T, ds), strides (b_sb, b_st, 1)
  const float* Cm;     // (Bt, T, ds), strides (c_sb, c_st, 1)
  const float* D;      // (di,)
  const float* h0;     // (Bt / h0_rep, di, ds) contiguous
  const int* n_commit; // (Bt,) or null
  float* y;            // (Bt, T, di)
  float* hT;           // (Bt, di, ds) or null
  float* ckpt;         // (Bt, n_chunks, di, ds), kCkpt only
  long long b_sb, b_st, c_sb, c_st;
  int T, di, ds, h0_rep;
  int vec_tile;        // u, dt, B and C rows 16-byte aligned: cp.async
  int vec_state;       // h0 / hT slices of 4 states 16-byte aligned
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A lane's 4 states s0..s0+3 of one (row, channel) state vector at p.
__device__ __forceinline__ void load4(float (&h)[4], const float* p, int s0,
                                      int ds, bool vec) {
  if (vec) {
    if (s0 < ds) {
      const float4 v = *reinterpret_cast<const float4*>(p + s0);
      h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (s0 + k < ds) h[k] = p[s0 + k];
}
__device__ __forceinline__ void store4(float* p, const float* h, int s0,
                                       int ds, bool vec) {
  if (vec) {
    if (s0 < ds)
      *reinterpret_cast<float4*>(p + s0) = make_float4(h[0], h[1], h[2], h[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (s0 + k < ds) p[s0 + k] = h[k];
}

template <int DS, typename TU>
struct Stage {
  static constexpr int kG = DS / 4;               // lanes a channel
  static constexpr int kCh = kThreads / kG;       // channels a block
  TU u[2][kChunk][kCh];
  float dt[2][kChunk][kCh];
  float B[2][kChunk][DS];
  float C[2][kChunk][DS];
  float y[kChunk][kCh][kG];   // each lane's part of h . C, per step
};

// Stage steps t0 .. t0+kChunk-1 of row b for the block's channels c0.. into
// buffer buf: zeros past T, past di and past ds.
template <int DS, typename TU>
__device__ __forceinline__ void stage(Stage<DS, TU>& sm, const Args& a,
                                      int buf, int b, int c0, int t0) {
  using S = Stage<DS, TU>;
  const int n = min(kChunk, a.T - t0), cn = a.di - c0;  // rows, channels
  const long long row0 = (long long)b * a.T + t0;
  const TU* u = static_cast<const TU*>(a.u) + row0 * a.di + c0;
  const float* dt = a.dt + row0 * a.di + c0;
  const float* Bb = a.Bm + (long long)b * a.b_sb + (long long)t0 * a.b_st;
  const float* Cb = a.Cm + (long long)b * a.c_sb + (long long)t0 * a.c_st;
  if (a.vec_tile) {  // di, ds multiples of 16 bytes' elements: all or none
    constexpr int kUp = 16 / sizeof(TU);            // u elements a piece
    constexpr int kUr = S::kCh / kUp, kDr = S::kCh / 4, kBr = DS / 4;
    // piece i of a tile of N; the trip counts are compile-time
#pragma unroll
    for (int p = 0; p < (kChunk * kUr + kThreads - 1) / kThreads; ++p) {
      const int i = p * kThreads + threadIdx.x;
      const int tt = i / kUr, c = (i % kUr) * kUp;
      const bool ok = tt < n && c < cn;
      if (i < kChunk * kUr)
        cp_async16(&sm.u[buf][tt][c], u + (ok ? tt * a.di + c : 0), ok);
    }
#pragma unroll
    for (int p = 0; p < kChunk * kDr / kThreads; ++p) {
      const int i = p * kThreads + threadIdx.x;
      const int tt = i / kDr, c = (i % kDr) * 4;
      const bool ok = tt < n && c < cn;
      cp_async16(&sm.dt[buf][tt][c], dt + (ok ? tt * a.di + c : 0), ok);
    }
#pragma unroll
    for (int p = 0; p < (2 * kChunk * kBr + kThreads - 1) / kThreads; ++p) {
      const int i = p * kThreads + threadIdx.x;
      if (i >= 2 * kChunk * kBr) break;
      const int m = i / (kChunk * kBr), k = i % (kChunk * kBr);
      const int tt = k / kBr, s = (k % kBr) * 4;
      const bool ok = tt < n && s < a.ds;
      const float* src = m ? Cb + tt * a.c_st + s : Bb + tt * a.b_st + s;
      cp_async16(m ? &sm.C[buf][tt][s] : &sm.B[buf][tt][s],
                 ok ? src : a.Bm, ok);
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < kChunk * S::kCh / kThreads; ++p) {
    const int i = p * kThreads + threadIdx.x;
    const int tt = i / S::kCh, c = i % S::kCh;
    const bool ok = tt < n && c < cn;
    sm.u[buf][tt][c] = ok ? u[tt * a.di + c] : TU(0.f);
    sm.dt[buf][tt][c] = ok ? dt[tt * a.di + c] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < (kChunk * DS + kThreads - 1) / kThreads; ++p) {
    const int i = p * kThreads + threadIdx.x;
    if (i >= kChunk * DS) break;
    const int tt = i / DS, s = i % DS;
    const bool ok = tt < n && s < a.ds;
    sm.B[buf][tt][s] = ok ? Bb[tt * a.b_st + s] : 0.f;
    sm.C[buf][tt][s] = ok ? Cb[tt * a.c_st + s] : 0.f;
  }
}

// One block: kCh channels of the h0_rep rows that start from h0 row
// blockIdx.y, walked row after row; the (row, chunk) items form one
// double-buffered pipeline, so a verify block's rows overlap their loads
// like a long prefill, and the rows share one read of h0, A and D.
// kSelect: hT is the state after n_commit[b] steps, not the last one.
// kCkpt: write the state before each chunk to ckpt (h0_rep 1).
template <int DS, typename TU, bool kSelect, bool kCkpt>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(const Args a) {
  using S = Stage<DS, TU>;
  constexpr int kG = S::kG;
  __shared__ __align__(16) S sm;
  const int c0 = blockIdx.x * S::kCh;
  const int cl = threadIdx.x / kG;          // channel in the block
  const int s0 = 4 * (threadIdx.x % kG);    // this lane's first state
  const int d = c0 + cl;
  const bool live = d < a.di;
  const int ds = a.ds, T = a.T, rows = a.h0_rep;
  const int b0 = blockIdx.y * rows;
  const bool vs = a.vec_state;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int n_items = rows * n_chunks;
  stage<DS, TU>(sm, a, 0, b0, c0, 0);
  cp_async_commit();

  float h0[4] = {0.f, 0.f, 0.f, 0.f}, A2[4] = {0.f, 0.f, 0.f, 0.f};
  // the channel whose y this thread finishes (kThreads is a multiple of kCh)
  const int cy = threadIdx.x % S::kCh;
  const float Dy = c0 + cy < a.di ? a.D[c0 + cy] : 0.f;
  if (live) {
    load4(h0, a.h0 + ((long long)blockIdx.y * a.di + d) * ds, s0, ds, vs);
    float Ad[4] = {0.f, 0.f, 0.f, 0.f};
    load4(Ad, a.A + (long long)d * ds, s0, ds, false);
#pragma unroll
    for (int k = 0; k < 4; ++k) A2[k] = Ad[k] * kLog2e;
  }
  float h[4], hk[4];  // the state; the one kept (kSelect)
  int keep = 0;       // kSelect: the steps whose state is kept
  // item it is chunk ci of row b; the next one, chunk cn of row bn
  for (int it = 0, b = b0, ci = 0; it < n_items; ++it) {
    const int buf = it & 1, t0 = ci * kChunk;
    const bool last = ci == n_chunks - 1;
    const int bn = last ? b + 1 : b, cn = last ? 0 : ci + 1;
    if (it + 1 < n_items) {
      stage<DS, TU>(sm, a, buf ^ 1, bn, c0, cn * kChunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // item it is staged
    if (ci == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = hk[k] = h0[k];
      if (kSelect) keep = max(0, min(a.n_commit[b], T));
    }
    if (kCkpt && live)
      store4(a.ckpt + (((long long)b * n_chunks + ci) * a.di + d) * ds, h,
             s0, ds, vs);
    const long long row_t0 = (long long)b * T + t0;  // (b, t0) in y
    const int n = min(kChunk, T - t0);
    // steps j0 .. j0+kGroup-1, of which the first m are real: the others
    // (a chunk's last group only) leave h as it is
    auto group = [&](const int j0, const int m) {
      float dtv[kGroup], uv[kGroup];
      float4 Bv[kGroup], Cv[kGroup];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {  // operands first, so that the
        dtv[jj] = sm.dt[buf][j0 + jj][cl];   // group's exps issue together
        uv[jj] = to_f32(sm.u[buf][j0 + jj][cl]);
        Bv[jj] = *reinterpret_cast<const float4*>(&sm.B[buf][j0 + jj][s0]);
        Cv[jj] = *reinterpret_cast<const float4*>(&sm.C[buf][j0 + jj][s0]);
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const bool real = jj < m;
        const float dtu = dtv[jj] * uv[jj];
        const float Bs[4] = {Bv[jj].x, Bv[jj].y, Bv[jj].z, Bv[jj].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float hn = fmaf(ex2(dtv[jj] * A2[k]), h[k], dtu * Bs[k]);
          h[k] = real ? hn : h[k];
        }
        float acc = h[0] * Cv[jj].x;
        acc = fmaf(h[1], Cv[jj].y, acc);
        acc = fmaf(h[2], Cv[jj].z, acc);
        acc = fmaf(h[3], Cv[jj].w, acc);
        sm.y[j0 + jj][cl][threadIdx.x % kG] = acc;
        if (kSelect && t0 + j0 + jj + 1 == keep) {
#pragma unroll
          for (int k = 0; k < 4; ++k) hk[k] = h[k];
        }
      }
    };
    int j0 = 0;
    for (; j0 + kGroup <= n; j0 += kGroup) group(j0, kGroup);
    if (j0 < n) group(j0, n - j0);
    __syncthreads();  // the chunk's parts of y are in shared memory
    // y = the lanes' parts summed in a fixed order, + u * D, stored
    // coalesced: 128 threads write 128 / kCh steps of kCh channels each
    if (c0 + cy < a.di) {
      constexpr int kJs = kThreads / S::kCh;  // steps apart
      const int j1 = threadIdx.x / S::kCh;
      float* yp = a.y + (row_t0 + j1) * a.di + c0 + cy;
#pragma unroll
      for (int q = 0; q < kChunk / kJs; ++q, yp += kJs * a.di) {
        const int j = j1 + q * kJs;
        if (j >= n) break;
        float sum;
        if (kG == 4) {
          const float4 p = *reinterpret_cast<const float4*>(sm.y[j][cy]);
          sum = (p.x + p.y) + (p.z + p.w);
        } else if (kG == 2) {
          const float2 p = *reinterpret_cast<const float2*>(sm.y[j][cy]);
          sum = p.x + p.y;
        } else {
          sum = sm.y[j][cy][0];
        }
        *yp = fmaf(to_f32(sm.u[buf][j][cy]), Dy, sum);
      }
    }
    if (last && live && a.hT != nullptr)
      store4(a.hT + ((long long)b * a.di + d) * ds, kSelect ? hk : h, s0, ds,
             vs);
    __syncthreads();  // every lane is done with buffer buf
    b = bn, ci = cn;
  }
}

template <int DS, typename TU>
cudaError_t launch_out(const Args& a, int Bt, cudaStream_t st) {
  constexpr int kCh = Stage<DS, TU>::kCh;
  const dim3 grid((a.di + kCh - 1) / kCh, Bt / a.h0_rep);
  if (a.ckpt != nullptr)
    mamba_scan_kernel<DS, TU, false, true><<<grid, kThreads, 0, st>>>(a);
  else if (a.n_commit != nullptr)
    mamba_scan_kernel<DS, TU, true, false><<<grid, kThreads, 0, st>>>(a);
  else
    mamba_scan_kernel<DS, TU, false, false><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TU>
cudaError_t launch_ds(const Args& a, int Bt, cudaStream_t st) {
  if (a.ds >= 1 && a.ds <= 4) return launch_out<4, TU>(a, Bt, st);
  if (a.ds > 4 && a.ds <= 8) return launch_out<8, TU>(a, Bt, st);
  if (a.ds > 8 && a.ds <= 16) return launch_out<16, TU>(a, Bt, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Returns cudaGetLastError() of the launch (cudaErrorInvalidValue for a ds
// outside 1..16, or for ckpt with n_commit or h0_rep > 1, which launches
// nothing).  u_bf16: u is bf16, else f32.  n_commit (device, int32 (Bt,))
// or null; hT may be null; ckpt (Bt, ceil(T / 16), di, ds) or null.
extern "C" int mamba_scan_launch(const void* u, int u_bf16, const float* dt,
                                 const float* A, const float* Bm,
                                 long long b_sb, long long b_st,
                                 const float* Cm, long long c_sb,
                                 long long c_st, const float* D,
                                 const float* h0, int h0_rep,
                                 const int* n_commit, float* y, float* hT,
                                 float* ckpt, int Bt, int T, int di, int ds,
                                 void* stream) {
  if (ckpt != nullptr && (n_commit != nullptr || h0_rep != 1))
    return (int)cudaErrorInvalidValue;
  const int u_size = u_bf16 ? 2 : 4;
  const bool tile = aligned16(u) && aligned16(dt) && aligned16(Bm) &&
                    aligned16(Cm) && (di * u_size) % 16 == 0 && di % 4 == 0 &&
                    ds % 4 == 0 && b_sb % 4 == 0 && b_st % 4 == 0 &&
                    c_sb % 4 == 0 && c_st % 4 == 0;
  const bool state = ds % 4 == 0 && aligned16(h0) &&
                     (hT == nullptr || aligned16(hT)) &&
                     (ckpt == nullptr || aligned16(ckpt));
  Args a{u,    dt,   A,    Bm, Cm, D,      h0,   n_commit, y,    hT, ckpt,
         b_sb, b_st, c_sb, c_st, T, di, ds, h0_rep, tile,     state};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(u_bf16 ? launch_ds<__nv_bfloat16>(a, Bt, st)
                      : launch_ds<float>(a, Bt, st));
}
