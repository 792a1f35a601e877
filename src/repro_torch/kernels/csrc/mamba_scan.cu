// K5 for Hopper: the Mamba selective scan.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py:mamba_scan_call (body
// _kernel).  For every batch row b, channel d < di and step t < T, with the
// (ds,) state h of (b, d) starting at h0[b / h0_rep, d, :]:
//
//   h        = exp(dt[b,t,d] * A[d,:]) * h + (dt[b,t,d] * u[b,t,d]) * B[b,t,:]
//   y[b,t,d] = h . C[b,t,:] + u[b,t,d] * D[d]
//
// hT[b,d,:] is h after the last step (skipped when hT is null); when hs is
// given, hs[b,t,d,:] is h after step t -- the per-step states from which the
// speculative replay selects the state after the accepted tokens.  All f32.
// h0_rep > 1 lets Bt = rows * h0_rep verify rows start from their slot's
// state (row b reads h0 row b / h0_rep) without a repeated copy of h0.
//
// Bound on the H100, at the prefill shape (Bt, T, di, ds) = (8, 256, 16384,
// 16): 537 M exps on the special-function units (16 per clock per SM, 132
// SMs) take ~0.13 ms, and u, dt, y and the states, ~0.42 GB moved once, take
// ~0.125 ms: both limits are near, and the f32 FMAs are well below them.
//
// Design for that bound.  The TPU kernel carries the state in VMEM across a
// sequential grid axis of T-chunks and runs an associative scan inside each
// chunk, because a TPU core is one wide sequential machine.  Here the
// parallelism is across (b, d): one thread owns one channel and keeps its
// ds-entry state in registers, walking t in order (the CUDA "hardware-aware
// scan"), so the state never goes to device memory between steps, and every
// step sums in the same order whatever T the caller chose: prefill, verify,
// decode and replay compute a token's state with the same arithmetic.  A
// block is 128 channels of one batch row: its threads read u and dt and
// write y at neighbouring d (coalesced) and share B[b,t,:] and C[b,t,:],
// staged in shared memory for a chunk of kChunk steps; each thread loads its
// u and dt for the whole chunk before the chunk's steps, so one memory
// latency covers kChunk steps.  ds is a template capacity (4, 8 or 16)
// with a run-time guard; ds > 16 is refused.  No tensor cores: the scan has
// no matrix product.  exp is __expf (ex2.approx; a few ulp).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kChunk = 16;      // steps per shared-memory stage of B and C

struct Args {
  const float* u;      // (Bt, T, di) contiguous
  const float* dt;     // (Bt, T, di) contiguous
  const float* A;      // (di, ds) contiguous
  const float* Bm;     // (Bt, T, ds), strides (b_sb, b_st, 1)
  const float* Cm;     // (Bt, T, ds), strides (c_sb, c_st, 1)
  const float* D;      // (di,)
  const float* h0;     // (Bt / h0_rep, di, ds) contiguous
  float* y;            // (Bt, T, di)
  float* hT;           // (Bt, di, ds) or null
  float* hs;           // (Bt, T, di, ds) or null
  long long b_sb, b_st, c_sb, c_st;
  int T, di, ds, h0_rep;
};

template <int DS>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(Args a) {
  __shared__ float sB[kChunk][DS];
  __shared__ float sC[kChunk][DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < a.di;
  const int ds = a.ds;
  float h[DS], A[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = 0.f;
    A[s] = 0.f;
  }
  float Dd = 0.f;
  if (live) {
    const float* h0r = a.h0 + ((long long)(b / a.h0_rep) * a.di + d) * ds;
    const float* Ar = a.A + (long long)d * ds;
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      if (s < ds) {
        h[s] = h0r[s];
        A[s] = Ar[s];
      }
    }
    Dd = a.D[d];
  }
  const float* Bb = a.Bm + (long long)b * a.b_sb;
  const float* Cb = a.Cm + (long long)b * a.c_sb;
  for (int t0 = 0; t0 < a.T; t0 += kChunk) {
    const int n = min(kChunk, a.T - t0);
    __syncthreads();  // every thread is done with the previous chunk's B, C
    for (int i = threadIdx.x; i < n * ds; i += kThreads) {
      const int tt = i / ds, s = i - tt * ds;
      sB[tt][s] = Bb[(long long)(t0 + tt) * a.b_st + s];
      sC[tt][s] = Cb[(long long)(t0 + tt) * a.c_st + s];
    }
    const long long base = ((long long)b * a.T + t0) * a.di + d;
    float ur[kChunk], dr[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      ur[j] = 0.f;
      dr[j] = 0.f;
      if (live && j < n) {
        ur[j] = a.u[base + (long long)j * a.di];
        dr[j] = a.dt[base + (long long)j * a.di];
      }
    }
    __syncthreads();  // this chunk's B, C are staged
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < n) {
        const float dtu = dr[j] * ur[j];
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          if (s < ds) {
            h[s] = __expf(dr[j] * A[s]) * h[s] + dtu * sB[j][s];
            acc = fmaf(h[s], sC[j][s], acc);
          }
        }
        const long long o = base + (long long)j * a.di;
        a.y[o] = acc + ur[j] * Dd;
        if (a.hs != nullptr) {
          float* hr = a.hs + o * ds;
#pragma unroll
          for (int s = 0; s < DS; ++s) {
            if (s < ds) hr[s] = h[s];
          }
        }
      }
    }
  }
  if (live && a.hT != nullptr) {
    float* hr = a.hT + ((long long)b * a.di + d) * ds;
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      if (s < ds) hr[s] = h[s];
    }
  }
}

template <int DS>
cudaError_t launch(const Args& a, int Bt, cudaStream_t stream) {
  const dim3 grid((a.di + kThreads - 1) / kThreads, Bt);
  mamba_scan_kernel<DS><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch (cudaErrorInvalidValue for a ds
// outside 1..16, which launches nothing).
extern "C" int mamba_scan_launch(const float* u, const float* dt,
                                 const float* A, const float* Bm,
                                 long long b_sb, long long b_st,
                                 const float* Cm, long long c_sb,
                                 long long c_st, const float* D,
                                 const float* h0, int h0_rep, float* y,
                                 float* hT, float* hs, int Bt, int T, int di,
                                 int ds, void* stream) {
  Args a{u, dt, A, Bm, Cm, D, h0, y, hT, hs, b_sb, b_st, c_sb, c_st,
         T, di, ds, h0_rep};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ds >= 1 && ds <= 4) return (int)launch<4>(a, Bt, st);
  if (ds > 4 && ds <= 8) return (int)launch<8>(a, Bt, st);
  if (ds > 8 && ds <= 16) return (int)launch<16>(a, Bt, st);
  return (int)cudaErrorInvalidValue;
}
