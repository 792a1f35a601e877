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
// (8, 128, 16384, 16): not the bytes of u, dt, dy, du and ddt (~0.29 GB with
// bf16 u, ~0.086 ms) but the SMs.  Each (b, t, d, s) takes two exps on the
// special-function units (16 a clock an SM: ~0.13 ms for 537 M) and ~23
// instructions in all (~13 of them FP32), ~0.21 ms at one warp instruction
// a clock a scheduler.  The kept states need ~250 registers a lane, so an
// SM holds 8 warps, and the latency those cannot hide is the rest (PERF.md
// has the measured split: the channel sums' shared-memory round trip is
// the largest single part).
//
// Design.  Each (row, channel) carries its DS states split over G = DS / E
// neighbouring lanes, E = 8 states a lane (4 at ds 4): a lane's per-step
// work (its operands, the sums over its channel, du and ddt) is spread
// over 8 states.  128 lanes a block, two blocks an SM.  A state rebuilt here
// has the forward's arithmetic bit for bit (one FMUL and one ex2.approx.ftz
// for the exp, one FMA for the update).
// * Checkpoints, not a second walk: K5's training instance (mamba_scan.cu,
//   kCkpt) wrote the state before every kChunk-th step, ckpt (Bt, n_chunks,
//   di, ds).  The chunks go in reverse; each chunk's states are rebuilt from
//   its checkpoint with every h_{t-1} kept in registers (kChunk x E), then
//   walked in reverse, a_t taken again: two exps a (b, t, d, s), and no
//   state goes through memory.
// * Operands staged: the chunk's u, dt and dy tiles (kChunk x channels), its
//   B and C rows and each lane's checkpoint by 16-byte cp.async,
//   double-buffered, so that chunk c-1 is in flight while chunk c computes
//   (plain loads where a row is not 16-byte aligned); one barrier a chunk.
// * Sums over a channel's states (g . B, and the A term of ddt) go over its
//   G lanes as one reduce-scatter of two values: one shuffle a step.
// * Sums over channels (dB, dC) off the shuffle path: each lane stores its
//   terms of a step to shared memory (16-byte stores, each channel's row
//   swizzled so that a quarter warp's stores hit every bank once); every
//   kSub steps the warp adds its channels in a fixed order, and at the next
//   chunk the block adds its warps in a fixed order into one partial a block
//   (nbx, Bt, T, ds).  The sums over rows (dA, dD) go to one partial a row
//   (Bt, di, ds) and (Bt, di).  No float atomics: a second kernel, launched
//   to wait on this one (programmatic dependent launch), adds the partials
//   in a fixed order, so two runs give the same bits.
// ds is a template capacity (4, 8 or 16) with a run-time guard, as in the
// forward.  u is f32 or bf16; every gradient is written in f32 (the wrapper
// casts du to u's dtype).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // lanes a block (two blocks an SM)
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;      // steps a checkpoint: mamba_scan.cu's kChunk
constexpr int kSub = 4;         // steps between the warps' channel sums
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* u;       // (Bt, T, di) contiguous, f32 or bf16
  const float* dt;     // (Bt, T, di)
  const float* A;      // (di, ds)
  const float* Bm;     // (Bt, T, ds), strides (b_sb, b_st, 1)
  const float* Cm;     // (Bt, T, ds), strides (c_sb, c_st, 1)
  const float* D;      // (di,)
  const float* dy;     // (Bt, T, di)
  const float* dhT;    // (Bt, di, ds) or null
  const float* ckpt;   // (Bt, n_chunks, di, ds): the state before each chunk
  float* du;           // (Bt, T, di)
  float* ddt;          // (Bt, T, di)
  float* dh0;          // (Bt, di, ds)
  float* pB;           // (nbx, Bt, T, ds) partials over channel blocks
  float* pC;           // (nbx, Bt, T, ds)
  float* pA;           // (Bt, di, ds) partials over rows
  float* pD;           // (Bt, di)
  long long b_sb, b_st, c_sb, c_st;
  int Bt, T, di, ds, n_chunks;
  int vec_tile;        // u, dt, dy, B and C rows 16-byte aligned: cp.async
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// *p = v where ok, as one predicated store (no branch)
__device__ __forceinline__ void st_if(float* p, float v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.f32 [%0], "
      "%1;\n}" ::"l"(p),
      "f"(v), "r"((int)ok)
      : "memory");
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// N states s0..s0+N-1 of a state vector at p (zeros past ds), and back
template <int N>
__device__ __forceinline__ void loadn(float (&h)[N], const float* p, int s0,
                                      int ds) {
#pragma unroll
  for (int k = 0; k < N; ++k) h[k] = s0 + k < ds ? p[s0 + k] : 0.f;
}
template <int N>
__device__ __forceinline__ void storen(float* p, const float (&h)[N], int s0,
                                       int ds) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (s0 + k < ds) p[s0 + k] = h[k];
}

template <int DS, typename TU>
struct Smem {
  static constexpr int kE = DS < 8 ? DS : 8;  // states a lane
  static constexpr int kG = DS / kE;          // lanes a channel
  static constexpr int kCh = kThreads / kG;   // channels a block
  static constexpr int kW = 32 / kG;          // channels a warp
  static constexpr int kOut = 2 * DS;         // dB and dC terms a step
  TU u[2][kChunk][kCh];
  float dt[2][kChunk][kCh];
  float dy[2][kChunk][kCh];
  float B[2][kChunk][DS];
  float C[2][kChunk][DS];
  float ck[2][kThreads][kE];          // each lane's states before the chunk
  // kSub steps' terms of each warp: kW rows (channels) of kOut
  float red[kWarps][kSub][kW * kOut];
  float red2[2][kChunk][kWarps][kOut];   // each warp's channel sums a step
  // the 16-byte group of a row's terms that a channel w of the warp keeps
  // at group o / 4: o ^ swz(w), so that the kG lanes of 8 / kG channels
  // (a quarter warp) store to 8 different groups of 4 banks
  static __device__ __forceinline__ int swz(int w) {
    return DS == 16 ? 4 * ((w & 1) | ((w & 2) << 1))
           : DS == 8 ? 4 * ((w >> 1) & 3)
                     : 4 * ((w >> 2) & 1);
  }
};

// Stage chunk c (steps t0 = c * kChunk ..) of row b for the block's
// channels c0.. into buffer buf, with each lane's states of the checkpoint
// before it: zeros past T, past di and past ds.
template <int DS, typename TU>
__device__ __forceinline__ void stage(Smem<DS, TU>& sm, const Args& a,
                                      int buf, int b, int c0, int c) {
  using S = Smem<DS, TU>;
  constexpr int kCh = S::kCh, kG = S::kG, kE = S::kE;
  const int t0 = c * kChunk, n = min(kChunk, a.T - t0), cn = a.di - c0;
  const int di = a.di, ds = a.ds, tid = threadIdx.x;
  const long long e0 = ((long long)b * a.T + t0) * di + c0;  // (b, t0, c0)
  const TU* const u = static_cast<const TU*>(a.u) + e0;
  const float* const dt = a.dt + e0;
  const float* const dy = a.dy + e0;
  const float* const Bb =
      a.Bm + (long long)b * a.b_sb + (long long)t0 * a.b_st;
  const float* const Cb =
      a.Cm + (long long)b * a.c_sb + (long long)t0 * a.c_st;
  const int b_st = (int)a.b_st, c_st = (int)a.c_st;
  // the checkpoint (b, c, c0, 0), and the lane's channel and first state
  const float* const ck =
      a.ckpt + (((long long)b * a.n_chunks + c) * di + c0) * ds;
  const int cl = tid / kG, s0 = kE * (tid % kG);
  if (a.vec_tile) {  // di, ds multiples of 16 bytes' elements: all or none
    constexpr int kUp = 16 / sizeof(TU);            // u elements a piece
    constexpr int kUr = kCh / kUp, kFr = kCh / 4, kBr = DS / 4;
#pragma unroll
    for (int k = 0; k < kE; k += 4) {
      const bool ok = cl < cn && s0 + k < ds;
      cp_async16(&sm.ck[buf][tid][k], ok ? ck + cl * ds + s0 + k : a.ckpt,
                 ok);
    }
#pragma unroll
    for (int p = 0; p < (kChunk * kUr + kThreads - 1) / kThreads; ++p) {
      const int i = p * kThreads + tid;
      const int tt = i / kUr, cc = (i % kUr) * kUp;
      const bool ok = tt < n && cc < cn;
      if (i < kChunk * kUr)
        cp_async16(&sm.u[buf][tt][cc], u + (ok ? tt * di + cc : 0), ok);
    }
#pragma unroll
    for (int p = 0; p < (kChunk * kFr + kThreads - 1) / kThreads; ++p) {
      const int i = p * kThreads + tid;
      const int tt = i / kFr, cc = (i % kFr) * 4;
      const bool ok = tt < n && cc < cn;
      const int off = ok ? tt * di + cc : 0;
      if (i < kChunk * kFr) {
        cp_async16(&sm.dt[buf][tt][cc], dt + off, ok);
        cp_async16(&sm.dy[buf][tt][cc], dy + off, ok);
      }
    }
#pragma unroll
    for (int p = 0; p < (2 * kChunk * kBr + kThreads - 1) / kThreads; ++p) {
      const int i = p * kThreads + tid;
      const int m = i / (kChunk * kBr), k = i % (kChunk * kBr);
      const int tt = k / kBr, ss = (k % kBr) * 4;
      const bool ok = tt < n && ss < ds;
      const float* src = m ? Cb + (ok ? tt * c_st + ss : 0)
                           : Bb + (ok ? tt * b_st + ss : 0);
      if (i < 2 * kChunk * kBr)
        cp_async16(m ? &sm.C[buf][tt][ss] : &sm.B[buf][tt][ss], src, ok);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kE; ++k)
    sm.ck[buf][tid][k] =
        cl < cn && s0 + k < ds ? ck[cl * ds + s0 + k] : 0.f;
#pragma unroll
  for (int p = 0; p < (kChunk * kCh + kThreads - 1) / kThreads; ++p) {
    const int i = p * kThreads + tid;
    const int tt = i / kCh, cc = i % kCh;
    const bool ok = tt < n && cc < cn;
    if (i < kChunk * kCh) {
      sm.u[buf][tt][cc] = ok ? u[tt * di + cc] : TU(0.f);
      sm.dt[buf][tt][cc] = ok ? dt[tt * di + cc] : 0.f;
      sm.dy[buf][tt][cc] = ok ? dy[tt * di + cc] : 0.f;
    }
  }
#pragma unroll
  for (int p = 0; p < (kChunk * DS + kThreads - 1) / kThreads; ++p) {
    const int i = p * kThreads + tid;
    const int tt = i / DS, ss = i % DS;
    const bool ok = tt < n && ss < ds;
    if (i < kChunk * DS) {
      sm.B[buf][tt][ss] = ok ? Bb[tt * b_st + ss] : 0.f;
      sm.C[buf][tt][ss] = ok ? Cb[tt * c_st + ss] : 0.f;
    }
  }
}

// One block: kCh channels of batch row blockIdx.y, every chunk in reverse.
// Steps past T (a last chunk's, zero-filled: dt = 0, so a = 1 and nothing
// is added) leave every state and sum as they are, and store nothing.
template <int DS, typename TU>
__global__ void __launch_bounds__(kThreads, 2)
    mamba_scan_bwd_kernel(const Args a) {
  using S = Smem<DS, TU>;
  constexpr int kE = S::kE, kG = S::kG, kCh = S::kCh, kW = S::kW;
  constexpr int kOut = S::kOut;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * kCh, cl = tid / kG, q = tid % kG, s0 = kE * q;
  const int d = c0 + cl;
  const bool live = d < a.di;
  const int b = blockIdx.y, T = a.T, di = a.di, ds = a.ds, nc = a.n_chunks;

  stage<DS, TU>(sm, a, (nc - 1) & 1, b, c0, nc - 1);
  cp_async_commit();
  // the reduction's blocks may launch (they wait for this grid to finish)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float A2[kE], g[kE], accA[kE], accD = 0.f, Dd = 0.f;
#pragma unroll
  for (int k = 0; k < kE; ++k) A2[k] = g[k] = accA[k] = 0.f;
  if (live) {
    loadn(A2, a.A + (long long)d * ds, s0, ds);
#pragma unroll
    for (int k = 0; k < kE; ++k) A2[k] *= kLog2e;
    Dd = a.D[d];
    if (a.dhT != nullptr)
      loadn(g, a.dhT + ((long long)b * di + d) * ds, s0, ds);
  }
  // this lane's du (q == 0) or ddt (q == 1; with kG == 1 the one lane
  // writes both) at step t: col[t * di]
  float* const col = (q == 0 ? a.du : a.ddt) + (long long)b * T * di + d;
  // this lane's row of a step's terms: g_t * dt_t * u_t at s0.., dy_t * h_t
  // at DS + s0..
  const int w = lane / kG;
  float* const rw = sm.red[warp][0] + w * kOut;
  const int sw = S::swz(w);
  // the warp's sums: lane < kOut adds terms o0..o0+3 of step jw of kSub
  const int jw = lane / (kOut / 4), o0 = 4 * (lane % (kOut / 4));
  const float* const rs = sm.red[warp][jw];

  // the block's sums over its warps of chunk cc's steps, in order
  auto block_sum = [&](const int cc) {
    const int tc = cc * kChunk, nn = min(kChunk, T - tc);
    float* const pBt =
        a.pB + (((long long)blockIdx.x * a.Bt + b) * T + tc) * ds;
    float* const pCt =
        a.pC + (((long long)blockIdx.x * a.Bt + b) * T + tc) * ds;
#pragma unroll
    for (int i0 = 0; i0 < kChunk * kOut; i0 += kThreads) {
      const int i = i0 + tid, j = i / kOut, o = i % kOut, s = o % DS;
      if (i < kChunk * kOut && j < nn && s < ds) {
        float sum = sm.red2[cc & 1][j][0][o];
#pragma unroll
        for (int ww = 1; ww < kWarps; ++ww) sum += sm.red2[cc & 1][j][ww][o];
        (o < DS ? pBt : pCt)[j * ds + s] = sum;
      }
    }
  };

  for (int c = nc - 1; c >= 0; --c) {
    const int buf = c & 1, t0 = c * kChunk, n = min(kChunk, T - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk c is staged; chunk c + 1 is done
    if (c > 0) {
      stage<DS, TU>(sm, a, buf ^ 1, b, c0, c - 1);
      cp_async_commit();
    }
    if (c + 1 < nc) block_sum(c + 1);
    const float* const dtp = &sm.dt[buf][0][cl];
    const TU* const up = &sm.u[buf][0][cl];
    const float* const dyp = &sm.dy[buf][0][cl];
    const float* const Bp = &sm.B[buf][0][s0];
    const float* const Cp = &sm.C[buf][0][s0];

    // the chunk's states, rebuilt from its checkpoint: h_{t-1} of each step
    float hp[kChunk][kE], h[kE];
#pragma unroll
    for (int k = 0; k < kE; ++k) h[k] = sm.ck[buf][tid][k];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float dtv = dtp[j * kCh];
      const float dtu = dtv * to_f32(up[j * kCh]);
#pragma unroll
      for (int k4 = 0; k4 < kE; k4 += 4) {
        const float4 Bv = lds4(Bp + j * DS + k4);
        const float Bs[4] = {Bv.x, Bv.y, Bv.z, Bv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          hp[j][k4 + k] = h[k4 + k];
          h[k4 + k] = fmaf(ex2(dtv * A2[k4 + k]), h[k4 + k], dtu * Bs[k]);
        }
      }
    }

    // the reverse walk; the warp sums its channels' terms every kSub steps
#pragma unroll
    for (int j0 = kChunk - kSub; j0 >= 0; j0 -= kSub) {
      if (j0 >= n) continue;   // the same for the whole block
      float* const cs = col + (long long)(t0 + j0) * di;   // step j0's row
#pragma unroll
      for (int jj = kSub - 1; jj >= 0; --jj) {
        const int j = j0 + jj;
        const float dtv = dtp[j * kCh], uv = to_f32(up[j * kCh]);
        const float dyv = dyp[j * kCh];
        const float dtu = dtv * uv;
        float v1 = 0.f, gA = 0.f, cB[kE], cC[kE];
#pragma unroll
        for (int k4 = 0; k4 < kE; k4 += 4) {
          const float4 Bv = lds4(Bp + j * DS + k4);
          const float4 Cv = lds4(Cp + j * DS + k4);
          const float Bs[4] = {Bv.x, Bv.y, Bv.z, Bv.w};
          const float Cs[4] = {Cv.x, Cv.y, Cv.z, Cv.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = k4 + kk;
            const float ht =                             // h_t
                j == kChunk - 1 ? h[k] : hp[j + 1 < kChunk ? j + 1 : j][k];
            const float ea = ex2(dtv * A2[k]);           // a_t, again
            g[k] = fmaf(dyv, Cs[kk], g[k]);              // g_t
            v1 = fmaf(g[k], Bs[kk], v1);
            const float ga = g[k] * ea;                  // the carry to t-1
            const float gha = ga * hp[j][k];
            gA = fmaf(gha, A2[k], gA);
            accA[k] = fmaf(gha, dtv, accA[k]);
            cB[k] = g[k] * dtu;
            cC[k] = dyv * ht;
            g[k] = ga;
          }
        }
        float* const r = rw + jj * (kW * kOut);
#pragma unroll
        for (int k4 = 0; k4 < kE; k4 += 4) {
          sts4(r + ((s0 + k4) ^ sw), cB + k4);
          sts4(r + ((DS + s0 + k4) ^ sw), cC + k4);
        }
        accD = fmaf(dyv, uv, accD);   // 0 past T
        // the channel's sums over its kG lanes: lane 0 gets g . B, lane 1
        // u * (g . B) + the A term (= ddt)
        float v2 = fmaf(uv, v1, gA * kLn2);
        if (kG == 2) {
          const bool hi = q == 1;
          float keep = hi ? v2 : v1;
          keep += __shfl_xor_sync(0xffffffffu, hi ? v1 : v2, 1);
          v1 = v2 = keep;
        }
        const float duv = fmaf(dyv, Dd, dtv * v1);
        st_if(cs + jj * di, q == 0 ? duv : v2, live && j < n);
        if constexpr (kG == 1)   // the one lane writes ddt too
          st_if(a.ddt + (cs - a.du) + jj * di, v2, live && j < n);
      }
      __syncwarp();
      // the warp's sums over its kW channels, in order, 4 terms a lane
      if (lane < kOut) {
        float4 acc = lds4(rs + (o0 ^ S::swz(0)));
#pragma unroll
        for (int ww = 1; ww < kW; ++ww) {
          const float4 v = lds4(rs + ww * kOut + (o0 ^ S::swz(ww)));
          acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
        }
        const float vs[4] = {acc.x, acc.y, acc.z, acc.w};
        sts4(&sm.red2[buf][j0 + jw][warp][o0], vs);
      }
      __syncwarp();   // red is free for the next kSub steps
    }
  }
  __syncthreads();
  block_sum(0);
  if (live) {
    storen(a.dh0 + ((long long)b * di + d) * ds, g, s0, ds);
    storen(a.pA + ((long long)b * di + d) * ds, accA, s0, ds);
    if (q == 0) a.pD[(long long)b * di + d] = accD;
  }
}

// The partials added up in a fixed order: dB, dC over the nbx channel
// blocks (a block of kRed x 32 lanes: lane x of output k adds partials x,
// x + kRed, ... in order, then one lane adds the kRed sums in order); dA,
// dD over the Bt rows (a lane an output).  Launched to overlap the main
// kernel's tail, it waits for that grid's writes first.
constexpr int kRed = 16;
__global__ void __launch_bounds__(kRed * 32)
    mamba_scan_bwd_reduce(const float* pB, const float* pC, const float* pA,
                          const float* pD, float* dB, float* dC, float* dA,
                          float* dD, int nbx, int Bt, long long n_bc,
                          long long n_a, long long n_d, int bc_blocks) {
  __shared__ float part[kRed][32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int kk = threadIdx.x % 32, xs = threadIdx.x / 32;
  if (blockIdx.x < bc_blocks) {
    const long long k = blockIdx.x * 32LL + kk;
    const bool ok = k < 2 * n_bc, isC = k >= n_bc;
    const long long m = isC ? k - n_bc : k;
    const float* p = isC ? pC : pB;
    float sum = 0.f;
    if (ok)
      for (int x = xs; x < nbx; x += kRed) sum += p[x * n_bc + m];
    part[xs][kk] = sum;
    __syncthreads();
    if (xs == 0 && ok) {
      sum = part[0][kk];
#pragma unroll
      for (int r = 1; r < kRed; ++r) sum += part[r][kk];
      (isC ? dC : dB)[m] = sum;
    }
    return;
  }
  for (long long i = (blockIdx.x - bc_blocks) * (long long)blockDim.x +
                     threadIdx.x;
       i < n_a + n_d; i += (long long)(gridDim.x - bc_blocks) * blockDim.x) {
    float sum = 0.f;
    if (i < n_a) {
      for (int r = 0; r < Bt; ++r) sum += pA[r * n_a + i];
      dA[i] = sum;
    } else {
      const long long k = i - n_a;
      for (int r = 0; r < Bt; ++r) sum += pD[r * n_d + k];
      dD[k] = sum;
    }
  }
}

template <int DS, typename TU>
cudaError_t launch_out(const Args& a, cudaStream_t st) {
  using S = Smem<DS, TU>;
  const int bytes = static_cast<int>(sizeof(S));   // past 48 KB: opt in
  const cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<DS, TU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.di + S::kCh - 1) / S::kCh, a.Bt);
  mamba_scan_bwd_kernel<DS, TU><<<grid, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename TU>
cudaError_t launch_ds(const Args& a, cudaStream_t st) {
  if (a.ds >= 1 && a.ds <= 4) return launch_out<4, TU>(a, st);
  if (a.ds > 4 && a.ds <= 8) return launch_out<8, TU>(a, st);
  if (a.ds > 8 && a.ds <= 16) return launch_out<16, TU>(a, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The channel blocks of the main kernel for ds (the partials' leading dim
// nbx, which the caller allocates), or 0 for a ds outside 1..16.
extern "C" int mamba_scan_bwd_blocks(int di, int ds) {
  const int g = ds <= 8 ? 1 : ds <= 16 ? 2 : 0;   // lanes a channel
  if (ds < 1 || g == 0) return 0;
  const int ch = kThreads / g;
  return (di + ch - 1) / ch;
}

// The checkpoint interval (ckpt's n_chunks = ceil(T / it)).
extern "C" int mamba_scan_bwd_chunk() { return kChunk; }

// Launches the main kernel, then the reduction; returns the CUDA error of
// the first launch that failed (cudaErrorInvalidValue for a ds outside
// 1..16, which launches nothing).  dhT may be null; ckpt is K5's training
// instance's (mamba_scan_launch with ckpt).
extern "C" int mamba_scan_bwd_launch(
    const void* u, int u_bf16, const float* dt, const float* A,
    const float* Bm, long long b_sb, long long b_st, const float* Cm,
    long long c_sb, long long c_st, const float* D, const float* dy,
    const float* dhT, const float* ckpt, float* du, float* ddt, float* dh0,
    float* pB, float* pC, float* pA, float* pD, float* dB, float* dC,
    float* dA, float* dD, int Bt, int T, int di, int ds, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int u_size = u_bf16 ? 2 : 4;
  const bool tile = aligned16(u) && aligned16(dt) && aligned16(dy) &&
                    aligned16(Bm) && aligned16(Cm) && aligned16(ckpt) &&
                    (di * u_size) % 16 == 0 && di % 4 == 0 && ds % 4 == 0 &&
                    b_sb % 4 == 0 && b_st % 4 == 0 && c_sb % 4 == 0 &&
                    c_st % 4 == 0;
  Args a{u,    dt,   A,    Bm,   Cm, D,  dy, dhT, ckpt, du, ddt,      dh0,
         pB,   pC,   pA,   pD,   b_sb, b_st, c_sb, c_st, Bt, T,  di,
         ds,   n_chunks, tile};
  cudaError_t e = u_bf16 ? launch_ds<__nv_bfloat16>(a, st)
                         : launch_ds<float>(a, st);
  if (e != cudaSuccess) return (int)e;
  const int nbx = mamba_scan_bwd_blocks(di, ds);
  const long long n_bc = (long long)Bt * T * ds, n_a = (long long)di * ds;
  const int bc_blocks = (int)((2 * n_bc + 31) / 32);
  const long long want = (n_a + di + kRed * 32 - 1) / (kRed * 32);
  // launched while the main kernel runs (programmatic dependent launch):
  // its blocks wait in griddepcontrol.wait for the partials
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bc_blocks + (int)(want < 1024 ? want : 1024));
  cfg.blockDim = dim3(kRed * 32);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, mamba_scan_bwd_reduce, (const float*)pB, (const float*)pC,
      (const float*)pA, (const float*)pD, dB, dC, dA, dD, nbx, Bt, n_bc, n_a,
      (long long)di, bc_blocks);
}
