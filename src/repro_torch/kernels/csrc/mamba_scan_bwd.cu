// K5's backward for Hopper: the gradients of the Mamba selective scan.
//
// The reference has no Pallas backward: its training differentiates the XLA
// scan of repro/models/mamba.py:selective_scan, and in the port that scan is
// K5 (mamba_scan.cu), so K5 needs a gradient.  For every batch row b and
// channel d < di, with the forward (the (ds,) state h of (b, d), h_{-1} = h0)
//
//   a_t = exp(dt_t * A[d,:]),  h_t = a_t * h_{t-1} + (dt_t * u_t) * B_t,
//   y_t = h_t . C_t + u_t * D[d],
//
// and the incoming gradients dy (Bt, T, di) and dhT (Bt, di, ds) or none, the
// gradient of the state g_t = dL/dh_t runs in reverse:
//
//   g_t   = dy_t * C_t + a_{t+1} * g_{t+1}     (g_{T-1}: + dhT)
//   du_t  = dy_t * D + dt_t * (g_t . B_t)
//   ddt_t = u_t * (g_t . B_t) + sum_s g_t * A * a_t * h_{t-1}
//   dA   += g_t * dt_t * a_t * h_{t-1}          (summed over rows and steps)
//   dD   += dy_t * u_t
//   dB_t += g_t * dt_t * u_t,  dC_t += dy_t * h_t   (summed over channels)
//   dh0   = a_0 * g_0
//
// What bounds it on the H100, at the hybrid's training shape (Bt, T, di, ds) =
// (8, 128, 16384, 16): the bytes of u, dt, dy, du and ddt (~0.29 GB with bf16
// u, ~0.09 ms) above the 268 M exps of the a_t (~0.06 ms on the special-
// function units).  This first kernel is simple and right, not fast: it
// computes every exp three times and moves a checkpoint of the states.
//
// Design.  The forward's thread layout: each (row, channel) carries its DS
// states split over G = DS / 4 neighbouring lanes, 4 states a lane, so a
// state recomputed here has the forward's arithmetic bit for bit (one FMUL
// and one ex2.approx for the exp, one FMA for the update).
// * Recompute, not store: pass 1 walks the steps forward from h0 and writes
//   the state before every kChunk-th step to a scratch checkpoint (Bt,
//   n_chunks, di, ds); pass 2 walks the chunks in reverse, rebuilds each
//   chunk's states from its checkpoint into shared memory (each lane its own
//   slots, so no barrier) and then walks the chunk's steps in reverse.
// * No float atomics: the sums over channels (dB, dC) go through warp
//   shuffles and a fixed-order sum over the block's warps to one partial a
//   channel block (nbx, Bt, T, ds); the sums over rows (dA, dD) to one
//   partial a row (Bt, di, ds) and (Bt, di).  A second kernel adds the
//   partials up in a fixed order, so two runs give the same bits.
// * The dot products over a channel's states (g . B and the dt term) are
//   shuffles across its G lanes; the channel's first lane writes du and ddt.
// ds is a template capacity (4, 8 or 16) with a run-time guard, as in the
// forward.  u is f32 or bf16; every gradient is written in f32 (the wrapper
// casts du to u's dtype).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // lanes a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;      // steps a checkpoint; states kept in smem
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* u;       // (Bt, T, di) contiguous, f32 or bf16
  const float* dt;     // (Bt, T, di)
  const float* A;      // (di, ds)
  const float* Bm;     // (Bt, T, ds) contiguous
  const float* Cm;     // (Bt, T, ds) contiguous
  const float* D;      // (di,)
  const float* h0;     // (Bt, di, ds)
  const float* dy;     // (Bt, T, di)
  const float* dhT;    // (Bt, di, ds) or null
  float* ckpt;         // (Bt, n_chunks, di, ds) scratch
  float* du;           // (Bt, T, di)
  float* ddt;          // (Bt, T, di)
  float* dh0;          // (Bt, di, ds)
  float* pB;           // (nbx, Bt, T, ds) partials over channel blocks
  float* pC;           // (nbx, Bt, T, ds)
  float* pA;           // (Bt, di, ds) partials over rows
  float* pD;           // (Bt, di)
  int Bt, T, di, ds, n_chunks;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4 states s0..s0+3 of a state vector at p (zeros past ds)
__device__ __forceinline__ void load4(float (&h)[4], const float* p, int s0,
                                      int ds) {
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = s0 + k < ds ? p[s0 + k] : 0.f;
}
__device__ __forceinline__ void store4(float* p, const float (&h)[4], int s0,
                                       int ds) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (s0 + k < ds) p[s0 + k] = h[k];
}

// The sum of v over the G lanes of a channel (every lane gets it).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// The sum of v over the warp's channels, lane by lane of a channel's group
// (lanes i and i + G hold the same state slot).
template <int G>
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int o = G; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DS>
struct Smem {
  static constexpr int kG = DS / 4;
  float hist[kChunk][kThreads][4];        // h_{t-1} of each step of a chunk
  float red[2][kChunk][kWarps][DS];       // warp sums of dB, dC a step
};

// One block: kCh channels of batch row blockIdx.y.
template <int DS, typename TU>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_bwd_kernel(const Args a) {
  using S = Smem<DS>;
  constexpr int kG = S::kG;
  constexpr int kCh = kThreads / kG;
  __shared__ __align__(16) S sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * kCh;
  const int d = c0 + tid / kG;
  const int s0 = 4 * (tid % kG);
  const bool live = d < a.di;
  const int b = blockIdx.y, T = a.T, di = a.di, ds = a.ds;
  const TU* u = static_cast<const TU*>(a.u);
  const long long row = (long long)b * T;   // (b, 0) in (Bt, T, .)

  float Ad[4] = {0.f, 0.f, 0.f, 0.f}, A2[4], h[4] = {0.f, 0.f, 0.f, 0.f};
  float Dd = 0.f;
  if (live) {
    load4(Ad, a.A + (long long)d * ds, s0, ds);
    load4(h, a.h0 + ((long long)b * di + d) * ds, s0, ds);
    Dd = a.D[d];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) A2[k] = Ad[k] * kLog2e;

  // step t's operands (zeros for a dead channel)
  auto operands = [&](int t, float& dtv, float& uv, float (&Bs)[4]) {
    const long long i = (row + t) * di + d;
    dtv = live ? a.dt[i] : 0.f;
    uv = live ? to_f32(u[i]) : 0.f;
    load4(Bs, a.Bm + (row + t) * ds, s0, ds);
  };

  // pass 1: the state before every kChunk-th step
  float* ck = a.ckpt + ((long long)b * a.n_chunks * di + d) * ds;
  const long long ck_stride = (long long)di * ds;   // one chunk
  for (int t = 0; t < T; ++t) {
    if (t % kChunk == 0 && live)
      store4(ck + (t / kChunk) * ck_stride, h, s0, ds);
    float dtv, uv, Bs[4];
    operands(t, dtv, uv, Bs);
    const float dtu = dtv * uv;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = fmaf(ex2(dtv * A2[k]), h[k], dtu * Bs[k]);
  }

  // pass 2: the chunks in reverse
  float g[4] = {0.f, 0.f, 0.f, 0.f};   // a_{t+1} * g_{t+1}: the carry
  if (a.dhT != nullptr && live)
    load4(g, a.dhT + ((long long)b * di + d) * ds, s0, ds);
  float accA[4] = {0.f, 0.f, 0.f, 0.f}, accD = 0.f;
  for (int c = a.n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    float hp[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) load4(hp, ck + c * ck_stride, s0, ds);
    for (int j = 0; j < n; ++j) {     // rebuild the chunk's states
#pragma unroll
      for (int k = 0; k < 4; ++k) sm.hist[j][tid][k] = hp[k];
      float dtv, uv, Bs[4];
      operands(t0 + j, dtv, uv, Bs);
      const float dtu = dtv * uv;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hp[k] = fmaf(ex2(dtv * A2[k]), hp[k], dtu * Bs[k]);
    }
    for (int j = n - 1; j >= 0; --j) {
      const int t = t0 + j;
      float dtv, uv, Bs[4], Cs[4], prev[4], ex[4], ht[4];
      operands(t, dtv, uv, Bs);
      load4(Cs, a.Cm + (row + t) * ds, s0, ds);
      const float dyv = live ? a.dy[(row + t) * di + d] : 0.f;
      const float dtu = dtv * uv;
      float gB = 0.f, gA = 0.f, cB[4], cC[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        prev[k] = sm.hist[j][tid][k];
        ex[k] = ex2(dtv * A2[k]);
        ht[k] = fmaf(ex[k], prev[k], dtu * Bs[k]);
        g[k] = fmaf(dyv, Cs[k], g[k]);               // g_t
        gB = fmaf(g[k], Bs[k], gB);
        const float gha = g[k] * ex[k] * prev[k];
        gA = fmaf(gha, Ad[k], gA);
        accA[k] = fmaf(gha, dtv, accA[k]);
        cB[k] = g[k] * dtu;
        cC[k] = dyv * ht[k];
        g[k] *= ex[k];                               // the carry to t-1
      }
      gB = group_sum<kG>(gB);
      gA = group_sum<kG>(gA);
      if (live && tid % kG == 0) {
        const long long i = (row + t) * di + d;
        a.du[i] = fmaf(dyv, Dd, dtv * gB);
        a.ddt[i] = fmaf(uv, gB, gA);
        accD = fmaf(dyv, uv, accD);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cB[k] = channel_sum<kG>(cB[k]);
        cC[k] = channel_sum<kG>(cC[k]);
      }
      if (lane < kG) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sm.red[0][j][warp][s0 + k] = cB[k];
          sm.red[1][j][warp][s0 + k] = cC[k];
        }
      }
    }
    __syncthreads();   // the chunk's warp sums are in shared memory
    for (int i = tid; i < 2 * n * DS; i += kThreads) {
      const int m = i / (n * DS), r = i % (n * DS), j = r / DS, s = r % DS;
      if (s >= ds) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sm.red[m][j][w][s];
      float* p = m ? a.pC : a.pB;
      p[(((long long)blockIdx.x * a.Bt + b) * T + t0 + j) * ds + s] = sum;
    }
    __syncthreads();   // red is free for the next chunk
  }
  if (live) {
    store4(a.dh0 + ((long long)b * di + d) * ds, g, s0, ds);
    store4(a.pA + ((long long)b * di + d) * ds, accA, s0, ds);
    if (tid % kG == 0) a.pD[(long long)b * di + d] = accD;
  }
}

// The partials added up in a fixed order: dB, dC over the nbx channel
// blocks; dA, dD over the Bt rows.
__global__ void mamba_scan_bwd_reduce(const float* pB, const float* pC,
                                      const float* pA, const float* pD,
                                      float* dB, float* dC, float* dA,
                                      float* dD, int nbx, int Bt,
                                      long long n_bc, long long n_a,
                                      long long n_d) {
  const long long total = 2 * n_bc + n_a + n_d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    if (i < 2 * n_bc) {
      const bool isC = i >= n_bc;
      const long long k = isC ? i - n_bc : i;
      const float* p = isC ? pC : pB;
      for (int x = 0; x < nbx; ++x) sum += p[x * n_bc + k];
      (isC ? dC : dB)[k] = sum;
    } else if (i < 2 * n_bc + n_a) {
      const long long k = i - 2 * n_bc;
      for (int r = 0; r < Bt; ++r) sum += pA[r * n_a + k];
      dA[k] = sum;
    } else {
      const long long k = i - 2 * n_bc - n_a;
      for (int r = 0; r < Bt; ++r) sum += pD[r * n_d + k];
      dD[k] = sum;
    }
  }
}

template <int DS, typename TU>
cudaError_t launch_out(const Args& a, cudaStream_t st) {
  constexpr int kCh = kThreads / (DS / 4);
  const dim3 grid((a.di + kCh - 1) / kCh, a.Bt);
  mamba_scan_bwd_kernel<DS, TU><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TU>
cudaError_t launch_ds(const Args& a, cudaStream_t st) {
  if (a.ds >= 1 && a.ds <= 4) return launch_out<4, TU>(a, st);
  if (a.ds > 4 && a.ds <= 8) return launch_out<8, TU>(a, st);
  if (a.ds > 8 && a.ds <= 16) return launch_out<16, TU>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The channel blocks of the main kernel for ds (the partials' leading dim
// nbx, which the caller allocates), or 0 for a ds outside 1..16.
extern "C" int mamba_scan_bwd_blocks(int di, int ds) {
  const int g = ds <= 4 ? 1 : ds <= 8 ? 2 : ds <= 16 ? 4 : 0;
  if (ds < 1 || g == 0) return 0;
  const int ch = kThreads / g;
  return (di + ch - 1) / ch;
}

// The checkpoint interval (the scratch's n_chunks = ceil(T / it)).
extern "C" int mamba_scan_bwd_chunk() { return kChunk; }

// Launches the main kernel, then the reduction; returns cudaGetLastError()
// of the first launch that failed (cudaErrorInvalidValue for a ds outside
// 1..16, which launches nothing).  dhT may be null.
extern "C" int mamba_scan_bwd_launch(
    const void* u, int u_bf16, const float* dt, const float* A,
    const float* Bm, const float* Cm, const float* D, const float* h0,
    const float* dy, const float* dhT, float* ckpt, float* du, float* ddt,
    float* dh0, float* pB, float* pC, float* pA, float* pD, float* dB,
    float* dC, float* dA, float* dD, int Bt, int T, int di, int ds,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (T + kChunk - 1) / kChunk;
  Args a{u,  dt, A,   Bm, Cm, D,  h0, dy, dhT, ckpt, du,      ddt,
         dh0, pB, pC, pA, pD, Bt, T,  di, ds,  n_chunks};
  cudaError_t e = u_bf16 ? launch_ds<__nv_bfloat16>(a, st)
                         : launch_ds<float>(a, st);
  if (e != cudaSuccess) return (int)e;
  const int nbx = mamba_scan_bwd_blocks(di, ds);
  const long long n_bc = (long long)Bt * T * ds, n_a = (long long)di * ds;
  const long long total = 2 * n_bc + n_a + di;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  mamba_scan_bwd_reduce<<<blocks, threads, 0, st>>>(
      pB, pC, pA, pD, dB, dC, dA, dD, nbx, Bt, n_bc, n_a, di);
  return (int)cudaGetLastError();
}
