// The celerite GP log-likelihood and its adjoint past 32 terms, for Hopper
// (sm_90a): the wide forms of K1, K2, K0, K3 and K4.
//
// For 32 < J <= 128 these replace the same TPU kernels as the
// warp-per-chain kernels do for J <= 32 (csrc/celerite_fwd.cu,
// csrc/celerite_tables.cu, csrc/celerite_adjoint.cu): in
// pioran_tpu/ops/pallas_celerite.py `_fused_kernel` (K1 with one time grid
// for the chains, K2 with per-chain ragged grids) and `_kernel` (K0, the
// likelihood from the U, V, phi tables of `build_tables`); in
// pioran_tpu/ops/pallas_celerite_vjp.py `_fwd_aug_kernel` (K3) and
// `_bwd_kernel` (K4). They compute what those compute, per chain, in the
// statements of csrc/celerite_adjoint.cu's header (R = 2J, rows in the
// block layout [J cos-type; J sin-type]):
//
//   T_m  = S_{m-1} + D_{m-1} W_{m-1} W_{m-1}^T        S_m = (ec ec^T) o T_m
//   q_m  = S_m U_m      D_m = sum(a) + s2_m - U_m . q_m      W_m = (V_m - q_m) / D_m
//   f_m  = ec o (f_{m-1} + W_{m-1} zp_{m-1})      zp_m = y_m - U_m . f_m
//   ll   = -1/2 (sum log|D_m| + sum zp_m^2 / D_m + N log 2 pi)
//
// with the inert first step, Kahan-compensated sums, -inf when any D <= 0
// or ll is not finite, n_valid masking on per-chain grids, and in K4 the
// reverse of every statement (a zero gradient on chains whose cotangent g
// is 0, which the wrapper sets where ll = -inf).
//
// Why a block a chain: the warp-per-chain kernels keep row i of each J x J
// block in lane i's registers; two rows a lane would need more than 255
// registers. Here one thread block carries one chain, in one of two
// designs, by J and dtype (ops/cuda_celerite_vjp.py `wide_shape`, which
// passes the entries `cpt`):
//
// - The register design (cpt = 40 or 64; J <= cpt): two
//   threads a row of the 2J x 2J state. Thread 2 r + hl holds columns
//   [hl J, hl J + J) of row r in registers, cpt values, zeros past J; rows
//   of per-step values sit in shared memory padded the same way, so a
//   thread reads its columns as 16-byte vectors and the padding adds
//   zeros. The forward kernels (K1, K2, K0, K3, one template) keep S there:
//   a step is the column loop (T = S + (W_r D) W, in K3 every kc steps
//   the checkpoint, S = (ec_r ec) o T, q_r = S_r . U, the halves added by
//   a shuffle), the warps' partial sums of U . q and U . f and the rows
//   V - q into shared memory, one barrier, after which every thread has D
//   and zp and forms W = (V - q) / D of its own columns. U, V and ec come
//   from tables of 8 steps built a block ahead from values loaded a block
//   before; the logs and Kahan sums of 8 steps run on warp 0 at once. K4
//   keeps G (below) there. A chunk of kc steps is swept in sub-chunks of
//   ks steps from last to first: phase 1 replays each thread's own T row
//   segments from the chunk's checkpoint into ks slots in shared memory
//   (no thread reads another's, so phase 1 has no barrier); phase 2, a step: G's row times
//   W (halves by a shuffle), V-bar of the row and the warps' partial sums
//   of D-bar, zp-bar and sum W-bar W, one barrier, then the column loop
//   (G, the U and ec cotangents) from the V-bar rows. The coefficient
//   chain rule and the t-bar and dt-bar sums of a sub-chunk's steps run at
//   its end, from rows kept per step; the residual rows, sincos and exp of
//   up to 8 steps (a window of the chunk) are read once for its sub-chunks.
// - One thread a row (J > 64, where a row segment no longer fits the
//   registers of a block of 4 J threads):
//   thread r owns row r of the state, stored by columns (entry (r, c) at
//   c * ld + r) in dynamic shared memory where it fits the 232,448 bytes
//   a block may use, else in a device-memory scratch the wrapper
//   allocates. The forward kernels keep the whole symmetric S, S10
//   included; K4 keeps G and the T chunk (three J x (J | 1) blocks a step,
//   sub-chunks of ks <= 8 steps) in shared memory or the scratch.
//
// K4 carries the cotangent of T_{m+1} as the symmetric parts P00 = M00 +
// M00^T and P11 = M11 + M11^T and both off-diagonal blocks M01 and M10 =
// M01^T, an R x R matrix G; every quantity the sweep reads of M00 and M11
// depends only on their symmetric parts, since T00 and T11 are symmetric
// (as in csrc/celerite_adjoint.cu).
//
// What bounds them on this card: the N dependent steps of a chain, each
// O(J^2) work; bytes are negligible (K0's tables aside). One thread a
// row with S and G in shared memory spent three quarters of a step on the
// column loop's shared-memory loads and stores, 3 warps a chain, five
// barriers a step in K4 (tools/wide_probe.py, PERF.md). The register design
// keeps the state out of memory, reads its column values as 16-byte
// vectors, and has one barrier a step, so a step is bound by the issue of
// its per-entry arithmetic (about 6 instructions an entry forward, 11 in
// K4 and 4 a replayed step), with two to four chains an SM in float32 at
// J = 40. Rounding follows the plain loops' statements, with two partial
// sums per thread and the halves added last (no reassociation of the step).
// chip_smoke.py holds each entry against its plain PyTorch version.
//
// Numerics as in the narrow kernels: Kahan updates with __fadd_rn /
// __fsub_rn (__dadd_rn / __dsub_rn), never contracted into FMAs; built
// without --use_fast_math, so sincos, exp, log and the divisions by D are
// IEEE-accurate (CUDA's expf and exp in place of the TPU's exp_neg).
//
// Carry entries (compile-time flag Carry; shared grid only), as in the
// narrow kernels' headers: K1 and K3 start a chain from the state `cin`
// (B, 3 J^2 + 4 J + 2: S00, S01, S11 row-major, W and f [cos-type;
// sin-type], D, zp; zeros start a series), take dt as the (N,) spacing of
// every step with the boundary's first, and write the state after their
// last step to `cout` and the block's partials (Kahan sums of log|D| and
// zp^2 / D, min D) to `parts` (B, 3). K4 seeds G and cpre from `ain`
// (B, 3 J^2 + 2 J: P00, M01, P11 row-major, cpre) and writes them at its
// first step to `aout`, wherever the launch keeps G.
//
// C interface (bound with ctypes): celerite_wide_fwd_{f32,f64} (K1),
// celerite_wide_fwd_multi_{f32,f64} (K2), celerite_wide_tables_{f32,f64}
// (K0), celerite_wide_fwd_aug[_multi]_{f32,f64} (K3),
// celerite_wide_bwd[_multi]_{f32,f64} (K4), and the carry entries
// celerite_wide_fwd_carry_{f32,f64} (K1), celerite_wide_fwd_aug_carry_{f32,
// f64} (K3; cin, cout, parts after Tcp) and celerite_wide_bwd_carry_{f32,f64}
// (K4; ain, aout after dtb). The per-lane entries take the
// int32 n_valid after s2 (K2, K3) or g (K4). Every entry takes `cpt` last
// of its ints (0: one thread a row), K4 its sub-chunk ks before it. A null
// `state` (forward) or `carry` / `chunk` (K4) puts that part in shared
// memory (or registers), else it is a device scratch of the wrapper's:
// `state` (B, R, R), `carry` (B, R, R) and `chunk` (B, ks, 3, J, J | 1) one
// thread a row; the register design takes none of them. They launch on the given stream,
// never synchronise, allocate nothing, and return cudaGetLastError() (or
// cudaErrorInvalidValue for what they do not take) as an int.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kMaxTerms = 128;
constexpr int kMaxThreads = 2 * kMaxTerms;  // a thread a row of the 2J x 2J state
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSub = 8;                  // K4: steps of a chunk's T held at once
constexpr int kGroup = 4;                   // columns a thread loads before it stores
constexpr int kSmemBytes = 232448;          // shared memory one block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;
constexpr double kLog2Pi = 1.8378770664093453;

enum Grid { kShared = 0, kPerLane = 1, kTables = 2 };

template <typename T> struct Ops;

template <> struct Ops<float> {
  static __device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }
  static __device__ __forceinline__ float exp_(float x) { return expf(x); }
  static __device__ __forceinline__ float log_(float x) { return logf(x); }
  static __device__ __forceinline__ float abs_(float x) { return fabsf(x); }
  static __device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
};

template <> struct Ops<double> {
  static __device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }
  static __device__ __forceinline__ double exp_(double x) { return exp(x); }
  static __device__ __forceinline__ double log_(double x) { return log(x); }
  static __device__ __forceinline__ double abs_(double x) { return fabs(x); }
  static __device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
};

// sum += x with Kahan compensation in comp
template <typename T>
__device__ __forceinline__ void kahan_add(T& sum, T& comp, T x) {
  const T xc = Ops<T>::sub_rn(x, comp);
  const T tt = Ops<T>::add_rn(sum, xc);
  comp = Ops<T>::sub_rn(Ops<T>::sub_rn(tt, sum), xc);
  sum = tt;
}

// Sums K values over the block; every thread gets the totals, added in
// the same order. Ends with the block's reads of `red` pending: the
// caller passes a __syncthreads() before `red` is written again.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&v)[K], T* red) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s = T(0);
    for (int w = 0; w < nw; ++w) s += red[w * K + k];
    v[k] = s;
  }
}

__host__ __device__ constexpr int threads_of(int J) { return (2 * J + 31) / 32 * 32; }

// K4's leading dimension of a J x J block of the T chunk: odd, so that a
// thread reading its column (stride ld) is free of bank conflicts
__host__ __device__ constexpr int odd_ld(int J) { return J | 1; }

// The forward kernels' shared memory, in values: the rows U, ec and W [R]
// each, the reduction buffer, then S [R][R] unless it lives in the scratch.
__host__ __device__ constexpr long long fwd_smem_len(int J, bool state_in_smem) {
  return 3LL * 2 * J + 2 * kMaxWarps + (state_in_smem ? 4LL * J * J : 0);
}

// K4's T chunk for ks steps, in values: three J x odd_ld(J) blocks a step.
__host__ __device__ constexpr long long chunk_len(int J, int ks) {
  return 3LL * ks * J * odd_ld(J);
}

// K4's shared memory, in values: the rows W, U, qbar and ec [R] each, the
// exchange rows [3 R], the reduction buffer, then G [R][R] and the T chunk
// where they live in shared memory.
__host__ __device__ constexpr long long bwd_smem_len(int J, int ks, bool carry_in_smem,
                                                     bool chunk_in_smem) {
  return 7LL * 2 * J + 3 * kMaxWarps + (carry_in_smem ? 4LL * J * J : 0) +
         (chunk_in_smem ? chunk_len(J, ks) : 0);
}

// ---------------------------------------------------------------------------
// K1, K2, K0 and K3: the forward sweep
// ---------------------------------------------------------------------------

template <typename T>
struct FwdArgs {
  const T *a, *b, *c, *d, *t, *dt;  // coefficients (B, J); t (N,) or (B, N); dt or null
  const T *U, *V, *phi, *suma;      // K0: tables (N, R, B) and sum(a) (B,)
  const T *y, *s2;                  // (B, N)
  const int* n_valid;               // per-lane grids (B,)
  T* out;                           // (B,)
  T *W0t, *W1t, *P0t, *P1t, *Dt, *ZPt, *Tcp;  // K3's residual tables
  T* state;                         // (B, R, R) scratch, or null: shared memory
  const T* cin;                     // carry entries: the state in, out, the partials
  T *cout, *parts;
  int B, J, N, kc;
};

// G: kShared (K1, K3), kPerLane (K2, per-lane K3), kTables (K0).
// Aug: K3, the value plus the residual tables; every step runs and the
// per-lane sums are masked past n_valid. Without it the per-lane loop ends
// at n_valid, since nothing after a chain's last live step feeds its value.
// Carry: a block of a split series (header; G == kShared).
template <typename T, int G, bool Aug, bool Carry>
__global__ void __launch_bounds__(kMaxThreads)
wide_fwd_kernel(const FwdArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chain = blockIdx.x;
  const int r = threadIdx.x;
  const int J = p.J, R = 2 * J, N = p.N;
  const bool act = r < R;
  const int h = (act && r >= J) ? 1 : 0;  // the sin-type half
  const int i = act ? r - h * J : 0;      // this row's term
  T* Urow = reinterpret_cast<T*>(smem_raw);
  T* Erow = Urow + R;
  T* Wrow = Erow + R;
  T* red = Wrow + R;
  T* S = p.state ? p.state + static_cast<long long>(chain) * R * R : red + 2 * kMaxWarps;

  const T* t = p.t;
  const T* dt = p.dt;
  int nv = N, nsteps = N;
  if (G == kPerLane) {
    t += static_cast<long long>(chain) * N;
    if (dt) dt += static_cast<long long>(chain) * (N - 1);
    nv = p.n_valid[chain];
    if (!Aug) nsteps = min(max(nv, 0), N);
  }
  const long long cj = static_cast<long long>(chain) * J + i;
  T ai = T(0), bi = T(0), ci = T(0), di = T(0), suma;
  if (G == kTables) {
    suma = p.suma[chain];
  } else {
    if (act) {
      ai = p.a[cj];
      bi = p.b[cj];
      ci = p.c[cj];
      di = p.d[cj];
    }
    T v[1] = {h == 0 ? ai : T(0)};
    block_sum<T, 1>(v, red);
    suma = v[0];
  }
  const long long JJ = static_cast<long long>(J) * J;
  const long long C = 3 * JJ + 4 * J + 2;  // carry values a chain
  const T* cin = Carry ? p.cin + chain * C : nullptr;
  // S by columns, (rr, cc) at cc R + rr; a carry holds S00, S01 and S11
  // row-major (S10 = S01^T)
  for (long long e = r; e < static_cast<long long>(R) * R; e += blockDim.x) {
    T v = T(0);
    if (Carry) {
      const int rr = static_cast<int>(e % R), cc = static_cast<int>(e / R);
      const int hr = rr >= J, hc = cc >= J;
      const int ir = rr - hr * J, ic = cc - hc * J;
      v = (hr && !hc) ? cin[JJ + static_cast<long long>(ic) * J + ir]
                      : cin[(hr + hc) * JJ + static_cast<long long>(ir) * J + ic];
    }
    S[e] = v;
  }

  T Wr = T(0), f = T(0);   // W_{n-1}, f_{n-1} of row r
  T Dp = T(0), zpp = T(0);  // D_{n-1}, zp_{n-1}
  if (Carry) {
    if (act) {
      Wr = cin[3 * JJ + r];
      f = cin[3 * JJ + R + r];
    }
    Dp = cin[3 * JJ + 2 * R];
    zpp = cin[3 * JJ + 2 * R + 1];
  }
  if (act) Wrow[r] = Wr;
  T logdet = T(0), clog = T(0), quad = T(0), cquad = T(0);
  T minD = T(INFINITY);
  const long long cN = static_cast<long long>(chain) * N;
  const int nck = Aug ? (N + p.kc - 1) / p.kc : 0;

  for (int n = 0; n < nsteps; ++n) {
    T Ur = T(0), Vr = T(0), Er = T(0);
    if (act) {
      if (G == kTables) {
        const long long o = (static_cast<long long>(n) * R + r) * p.B + chain;
        Ur = p.U[o];
        Vr = p.V[o];
        Er = p.phi[o];
      } else {
        const T tn = t[n];
        const T dtn = Carry ? dt[n] : (n == 0 ? T(0) : (dt ? dt[n - 1] : tn - t[n - 1]));
        T si, co;
        Ops<T>::sincos_(di * tn, &si, &co);
        Ur = h ? ai * si - bi * co : ai * co + bi * si;
        Vr = h ? si : co;
        Er = Ops<T>::exp_(-(ci * dtn));
      }
      Urow[r] = Ur;
      Erow[r] = Er;
    }
    __syncthreads();  // this step's U and ec rows, and the last step's W row

    T sums[2] = {T(0), T(0)};
    T q = T(0), pre = T(0);
    if (act) {
      const T wd = Wr * Dp;
      // K3: every kc steps this step's T rows go to the checkpoint, T00
      // and T01 from rows r < J, T11 from rows r >= J (T10 = T01^T is not kept)
      T* tile = (Aug && n % p.kc == 0)
                    ? p.Tcp + (static_cast<long long>(chain) * nck + n / p.kc) * 3 * JJ
                    : nullptr;
      // columns in groups of kGroup: every load of a group before its
      // stores, which the compiler may not reorder past (the rows and S
      // may alias as far as it knows)
      auto column = [&](int cc, T s, T w, T e, T u) {
        const T Tv = s + wd * w;
        if (Aug && tile != nullptr) {
          const int hc = cc >= J;
          if (h <= hc) tile[(h + hc) * JJ + static_cast<long long>(i) * J + (cc - hc * J)] = Tv;
        }
        const T Sv = (Er * e) * Tv;
        q += Sv * u;
        return Sv;
      };
      int cc = 0;
      for (; cc + kGroup <= R; cc += kGroup) {
        T s[kGroup], w[kGroup], e[kGroup], u[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          s[k] = S[(cc + k) * R + r];
          w[k] = Wrow[cc + k];
          e[k] = Erow[cc + k];
          u[k] = Urow[cc + k];
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) s[k] = column(cc + k, s[k], w[k], e[k], u[k]);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) S[(cc + k) * R + r] = s[k];
      }
      for (; cc < R; ++cc)
        S[cc * R + r] = column(cc, S[cc * R + r], Wrow[cc], Erow[cc], Urow[cc]);
      pre = f + Wr * zpp;
      f = Er * pre;
      sums[0] = Ur * q;
      sums[1] = Ur * f;
    }
    block_sum<T, 2>(sums, red);
    const T Dn = (suma + p.s2[cN + n]) - sums[0];
    const T zpn = p.y[cN + n] - sums[1];
    Wr = act ? (Vr - q) / Dn : T(0);
    if (act) Wrow[r] = Wr;  // every thread's column reads of W were before block_sum's barrier
    if (Aug) {
      if (act) {
        const long long o = (cN + n) * J + i;
        (h ? p.W1t : p.W0t)[o] = Wr;
        (h ? p.P1t : p.P0t)[o] = pre;
      }
      if (r == 0) {
        p.Dt[cN + n] = Dn;
        p.ZPt[cN + n] = zpn;
      }
    }
    if (r == 0) {
      const bool live = G != kPerLane || n < nv;
      kahan_add(logdet, clog, live ? Ops<T>::log_(Ops<T>::abs_(Dn)) : T(0));
      kahan_add(quad, cquad, live ? zpn * zpn / Dn : T(0));
      minD = (live && Dn < minD) ? Dn : minD;
    }
    Dp = Dn;
    zpp = zpn;
  }
  if (Carry) {  // the state after the last step (S row r is this thread's own), the partials
    T* co = p.cout + chain * C;
    if (act) {
      for (int cc = h * J; cc < R; ++cc) {
        const int hc = cc >= J;
        co[(h + hc) * JJ + static_cast<long long>(i) * J + (cc - hc * J)] = S[cc * R + r];
      }
      co[3 * JJ + r] = Wr;
      co[3 * JJ + R + r] = f;
    }
    if (r == 0) {
      co[3 * JJ + 2 * R] = Dp;
      co[3 * JJ + 2 * R + 1] = zpp;
      p.parts[3LL * chain] = logdet;
      p.parts[3LL * chain + 1] = quad;
      p.parts[3LL * chain + 2] = minD;
    }
    return;
  }
  if (r == 0) {
    const T ll = T(-0.5) * (logdet + quad + static_cast<T>(nv) * T(kLog2Pi));
    const bool ok = (minD > T(0)) && isfinite(ll);
    p.out[chain] = ok ? ll : T(-INFINITY);
  }
}

// ---------------------------------------------------------------------------
// K4: the reverse sweep
// ---------------------------------------------------------------------------

template <typename T>
struct BwdArgs {
  const T *a, *b, *c, *d, *t, *dt, *g;
  const int* n_valid;
  const T *W0t, *W1t, *P0t, *P1t, *Dt, *ZPt, *Tcp;
  T *abar, *bbar, *cbar, *dbar, *ybar, *s2bar, *tb, *dtb;
  T* carry;  // (B, R, R) scratch, or null: shared memory
  T* chunk;  // (B, chunk_len(J, ks)) scratch, or null: shared memory
  const T* ain;  // carry entries: the adjoint carry in and out
  T* aout;
  int B, J, N, kc, ks;
};

template <typename T, bool PerLaneT, bool Carry>
__global__ void __launch_bounds__(kMaxThreads)
wide_bwd_kernel(const BwdArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chain = blockIdx.x;
  const int r = threadIdx.x;
  const int J = p.J, R = 2 * J, N = p.N, kc = p.kc, ks = p.ks;
  const bool act = r < R;
  const int h = (act && r >= J) ? 1 : 0;
  const int i = act ? r - h * J : 0;
  const long long cj = static_cast<long long>(chain) * J + i;
  const long long cN = static_cast<long long>(chain) * N;
  const T gl = p.g[chain];
  const long long CA = 3LL * J * J + 2 * J;  // adjoint carry values a chain
  if (gl == T(0)) {  // no seed (a -inf chain): exact zeros, whatever the tables hold
    if (act && h == 0) p.abar[cj] = p.bbar[cj] = p.cbar[cj] = p.dbar[cj] = T(0);
    for (int n = r; n < N; n += blockDim.x)
      p.ybar[cN + n] = p.s2bar[cN + n] = p.tb[cN + n] = p.dtb[cN + n] = T(0);
    if (Carry) {
      for (long long e = r; e < CA; e += blockDim.x) p.aout[chain * CA + e] = T(0);
    }
    return;
  }
  const T* t = p.t;
  const T* dt = p.dt;
  int nv = N;
  if (PerLaneT) {
    t += static_cast<long long>(chain) * N;
    if (dt) dt += static_cast<long long>(chain) * (N - 1);
    nv = p.n_valid[chain];
  }
  T ai = T(0), bi = T(0), ci = T(0), di = T(0);
  if (act) {
    ai = p.a[cj];
    bi = p.b[cj];
    ci = p.c[cj];
    di = p.d[cj];
  }
  auto step_dt = [&](int m) -> T {
    if (Carry) return dt[m];
    if (m == 0) return T(0);
    return dt ? dt[m - 1] : t[m] - t[m - 1];
  };

  T* Wrow = reinterpret_cast<T*>(smem_raw);
  T* Urow = Wrow + R;
  T* Qrow = Urow + R;  // qbar
  T* Erow = Qrow + R;  // ec
  T* X = Erow + R;     // exchange: Ubar [R], Vbar [R], the ec cotangent's parts [R]
  T* red = X + 3 * R;
  T* tail = red + 3 * kMaxWarps;
  const bool carry_in_smem = p.carry == nullptr;
  T* G = carry_in_smem ? tail : p.carry + static_cast<long long>(chain) * R * R;
  T* Tb = p.chunk == nullptr ? tail + (carry_in_smem ? 4LL * J * J : 0)
                             : p.chunk + static_cast<long long>(chain) * chunk_len(J, ks);
  const int ld = odd_ld(J);
  const int blk = J * ld;  // a J x J block of the chunk (offsets within a chain fit an int)
  const long long JJ = static_cast<long long>(J) * J;

  // T(r, c) of a chunk step: the first half of the columns (c < J) is row
  // i of T00 for r < J and column i of T01 for r >= J; the second half is
  // row i of T01 (r < J) or of T11 (r >= J)
  const int lo_base = h ? blk + i * ld : i;
  const int lo_stride = h ? 1 : ld;
  const int hi_base = (h + 1) * blk + i;

  // G by columns, (rr, cc) at cc R + rr; an adjoint carry holds P00, M01
  // and P11 row-major (M10 = M01^T)
  const T* ain = Carry ? p.ain + chain * CA : nullptr;
  for (long long e = r; e < static_cast<long long>(R) * R; e += blockDim.x) {
    T v = T(0);
    if (Carry) {
      const int rr = static_cast<int>(e % R), cc = static_cast<int>(e / R);
      const int hr = rr >= J, hc = cc >= J;
      const int ir = rr - hr * J, ic = cc - hc * J;
      v = (hr && !hc) ? ain[JJ + static_cast<long long>(ic) * J + ir]
                      : ain[(hr + hc) * JJ + static_cast<long long>(ir) * J + ic];
    }
    G[e] = v;
  }
  T cp = (Carry && act) ? ain[3 * JJ + r] : T(0);  // deferred cotangent of pre_{m+1}, row r
  T ab = T(0), bb = T(0), cb = T(0), db = T(0), sumabar = T(0);
  const int nck = (N + kc - 1) / kc;

  for (int ch = nck - 1; ch >= 0; --ch) {
    const int base = ch * kc;
    const int len = min(kc, N - base);
    const T* ck = p.Tcp + (static_cast<long long>(chain) * nck + ch) * 3 * JJ;
    for (int sc = (len + ks - 1) / ks - 1; sc >= 0; --sc) {
      const int s0 = base + sc * ks;
      const int s1 = min(s0 + ks, base + len);
      __syncthreads();  // the last sweep's reads of the chunk and the rows are done

      // ---- phase 1: T_m for m in [s0, s1) from the checkpoint; the steps
      // before s0 are replayed in place in slot 0. Each thread owns its rows
      // of T00 and T01 (r < J) or T11 (r >= J), so only the column rows
      // need barriers.
      if (act) {
        for (int cc = h * J; cc < R; ++cc) {
          const int hc = cc >= J;
          const int j = cc - hc * J;
          Tb[(h + hc) * blk + j * ld + i] =
              ck[(h + hc) * JJ + static_cast<long long>(i) * J + j];
        }
      }
      for (int m = base; m < s1 - 1; ++m) {
        // T_{m+1} = (ec_m ec_m^T) o T_m + D_m W_m W_m^T
        T Er = T(0), Wr = T(0);
        if (act) {
          Er = Ops<T>::exp_(-(ci * step_dt(m)));
          Wr = (h ? p.W1t : p.W0t)[(cN + m) * J + i];
          Erow[r] = Er;
          Wrow[r] = Wr;
        }
        __syncthreads();
        const T wd = Wr * p.Dt[cN + m];
        T* src = Tb + (m >= s0 ? (m - s0) : 0) * 3 * blk;
        T* dst = Tb + (m + 1 >= s0 ? (m + 1 - s0) : 0) * 3 * blk;
        if (act) {
          // this thread's own rows, in groups as in the forward sweep
          auto at = [&](int cc) {
            const int hc = cc >= J;
            return (h + hc) * blk + (cc - hc * J) * ld + i;
          };
          int cc = h * J;
          for (; cc + kGroup <= R; cc += kGroup) {
            T v[kGroup], e[kGroup], w[kGroup];
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
              v[k] = src[at(cc + k)];
              e[k] = Erow[cc + k];
              w[k] = Wrow[cc + k];
            }
#pragma unroll
            for (int k = 0; k < kGroup; ++k) dst[at(cc + k)] = (Er * e[k]) * v[k] + wd * w[k];
          }
          for (; cc < R; ++cc) dst[at(cc)] = (Er * Erow[cc]) * src[at(cc)] + wd * Wrow[cc];
        }
        __syncthreads();
      }

      // ---- phase 2: the reverse sweep over the sub-chunk's steps
      for (int m = s1 - 1; m >= s0; --m) {
        const T tn = t[m];
        const T dtn = step_dt(m);
        const T Dm = p.Dt[cN + m];
        const T zpm = p.ZPt[cN + m];
        const T rD = T(1) / Dm;
        T co = T(0), si = T(0), Ur = T(0), Vr = T(0), Er = T(0), Wr = T(0), pre = T(0);
        if (act) {
          Ops<T>::sincos_(di * tn, &si, &co);
          Ur = h ? ai * si - bi * co : ai * co + bi * si;
          Vr = h ? si : co;
          Er = Ops<T>::exp_(-(ci * dtn));
          const long long o = (cN + m) * J + i;
          Wr = (h ? p.W1t : p.W0t)[o];
          pre = (h ? p.P1t : p.P0t)[o];
          Wrow[r] = Wr;
        }
        const T qr = Vr - Wr * Dm;
        __syncthreads();  // (1) the W row

        // consume G: T_{m+1} = S_m + D_m W_m W_m^T. diag is row r of P00 (or
        // P11) times W0 (W1), off row r of M01 (M10) times W1 (W0)
        T lo = T(0), hi = T(0);
        if (act) {
          for (int cc = 0; cc < J; ++cc) lo += G[cc * R + r] * Wrow[cc];
          for (int cc = J; cc < R; ++cc) hi += G[cc * R + r] * Wrow[cc];
        }
        const T diag = h ? hi : lo;
        const T off = h ? lo : hi;
        const T Wbar = (diag + off) * Dm + cp * zpm;
        T sums[3] = {h ? T(0.5) * Wr * diag : Wr * (T(0.5) * diag + off),  // Dbar
                     cp * Wr,                                               // zpbar (pre_{m+1})
                     Wbar * Wr};                                            // sum(Wbar o W)
        block_sum<T, 3>(sums, red);  // (2)
        T Dbar = sums[0], zpbar = sums[1];
        const T Wsum = sums[2];
        T fbar = cp;

        // loss seeds, scaled by the chain's cotangent, on the live steps
        if (!PerLaneT || m < nv) {
          Dbar -= T(0.5) * gl * (rD - zpm * zpm * (rD * rD));
          zpbar -= gl * zpm * rD;
        }
        // zp = y - U . f, f = ec o pre
        T Ubar = -zpbar * (Er * pre);
        fbar -= zpbar * Ur;
        T ecpart = fbar * pre;
        cp = Er * fbar;
        // W = (V - q) / D
        const T Vbar = Wbar * rD;
        T qbar = -Vbar;
        Dbar -= Wsum * rD;
        // D = suma + s2 - U . q
        sumabar += Dbar;
        Ubar -= Dbar * qr;
        qbar -= Dbar * Ur;
        if (r == 0) {
          p.ybar[cN + m] = zpbar;
          p.s2bar[cN + m] = Dbar;
        }
        if (act) {
          Urow[r] = Ur;
          Qrow[r] = qbar;
          Erow[r] = Er;
        }
        __syncthreads();  // (3) the U, qbar and ec rows

        // q = S U with S = (ec ec^T) o T: the U and ec cotangents, and the
        // new G = (ec ec^T) o Q, Q = G + qbar U^T + U qbar^T (row r)
        if (act) {
          const T* Tm = Tb + (m - s0) * 3 * blk;
          T uacc = T(0), eacc = T(0);
          auto column = [&](T tv, T gv, T ecc, T Uc, T qc) {
            const T ee = Er * ecc;
            const T Q = gv + qbar * Uc + Ur * qc;
            uacc += ee * tv * qc;
            eacc += Q * tv * ecc;
            return ee * Q;
          };
          for (int half = 0; half < 2; ++half) {
            const T* tp = Tm + (half ? hi_base : lo_base);
            const int stride = half ? ld : lo_stride;
            T* gh = G + half * J * R + r;
            const T* eh = Erow + half * J;
            const T* uh = Urow + half * J;
            const T* qh = Qrow + half * J;
            int j = 0;
            for (; j + kGroup <= J; j += kGroup) {  // loads of a group before its stores
              T tv[kGroup], gv[kGroup], ev[kGroup], uv[kGroup], qv[kGroup];
#pragma unroll
              for (int k = 0; k < kGroup; ++k) {
                tv[k] = tp[(j + k) * stride];
                gv[k] = gh[(j + k) * R];
                ev[k] = eh[j + k];
                uv[k] = uh[j + k];
                qv[k] = qh[j + k];
              }
#pragma unroll
              for (int k = 0; k < kGroup; ++k) gv[k] = column(tv[k], gv[k], ev[k], uv[k], qv[k]);
#pragma unroll
              for (int k = 0; k < kGroup; ++k) gh[(j + k) * R] = gv[k];
            }
            for (; j < J; ++j)
              gh[j * R] = column(tp[j * stride], gh[j * R], eh[j], uh[j], qh[j]);
          }
          Ubar += uacc;
          ecpart += eacc;
          X[r] = Ubar;
          X[R + r] = Vbar;
          X[2 * R + r] = ecpart;
        }
        __syncthreads();  // (4) the exchange rows

        // the coefficient chain rule, term by term (threads r < J): U0 = a co
        // + b si, U1 = a si - b co, V = (co, si), co = cos(d t), si =
        // sin(d t), ec = exp(-c dt)
        T tsum[2] = {T(0), T(0)};
        if (act && h == 0) {
          const T U0bar = X[i], U1bar = X[J + i];
          T cobar = X[R + i], sibar = X[R + J + i];
          const T ecbar = X[2 * R + i] + X[2 * R + J + i];
          ab += U0bar * co + U1bar * si;
          bb += U0bar * si - U1bar * co;
          cobar += U0bar * ai - U1bar * bi;
          sibar += U0bar * bi + U1bar * ai;
          const T dchain = -cobar * si + sibar * co;
          db += tn * dchain;
          cb -= dtn * ecbar * Er;
          tsum[0] = di * dchain;
          tsum[1] = -(ci * ecbar * Er);
        }
        block_sum<T, 2>(tsum, red);  // (5)
        if (r == 0) {
          p.tb[cN + m] = tsum[0];
          p.dtb[cN + m] = tsum[1];
        }
      }
    }
  }
  if (act && h == 0) {
    p.abar[cj] = ab + sumabar;  // sum(a) feeds D at every step
    p.bbar[cj] = bb;
    p.cbar[cj] = cb;
    p.dbar[cj] = db;
  }
  if (Carry && act) {  // G's row r (this thread's own) and cpre at the block's first step
    T* ao = p.aout + chain * CA;
    for (int cc = h * J; cc < R; ++cc) {
      const int hc = cc >= J;
      ao[(h + hc) * JJ + static_cast<long long>(i) * J + (cc - hc * J)] = G[cc * R + r];
    }
    ao[3 * JJ + r] = cp;
  }
}

// ---------------------------------------------------------------------------
// The register design: a row split over two threads, its state in registers
// ---------------------------------------------------------------------------
//
// Thread 2 r + hl holds columns [hl J, hl J + J) of row r of the 2J x 2J
// state (S forward, G in K4) in registers, CPT >= J values, the columns
// past J zero. Rows of per-step values live in shared memory padded the
// same way (index h CPT + i for row h J + i), so a thread reads its
// columns as 16-byte vectors and the padding adds zeros.

constexpr int kTab = 8;                    // steps a table holds
constexpr int kSplitMaxThreads = 256;      // 4 * 64: two threads a row of 128
constexpr int kSplitMaxWarps = kSplitMaxThreads / 32;

// Blocks an SM the compiler sizes a kernel's registers for (65,536 / (4
// CPT threads x this)): float32 at CPT = 40 four forward chains (one wave
// of 512 chains on 132 SMs), float64 two. K4 one: the compiler issues a
// step's column loads at once (about 250 registers at CPT = 40), and
// bounded for two chains it spilled a kilobyte a thread and ran 1.7x
// slower than one chain with 8 slots (tools/wide_times.py --ks).
template <typename T, int CPT, bool Bwd>
__host__ __device__ constexpr int split_min_blocks() {
  if (Bwd) return 1;
  if (sizeof(T) == 4) return CPT == 40 ? 4 : 2;
  return CPT == 40 ? 2 : 1;
}

#ifdef PIORAN_WIDE_PROBE
// tools/wide_probe.py defines this (and the arrays) to time a step's parts
#define PROBE_DECL(A)             \
  long long A##_[8] = {0};        \
  long long A##q_ = clock64();    \
  const long long A##0_ = A##q_;
#define PROBE(A, k)                    \
  {                                    \
    const long long c_ = clock64();    \
    A##_[k] += c_ - A##q_;             \
    A##q_ = c_;                        \
  }
#define PROBE_OUT(A, arr, slots, cond)                                   \
  if (cond) {                                                            \
    long long* pr_ = arr + static_cast<long long>(slots) * blockIdx.x;  \
    for (int k_ = 0; k_ < 8; ++k_) pr_[k_] = A##_[k_];                   \
    pr_[slots - 1] = clock64() - A##0_;                                  \
  }
#else
#define PROBE_DECL(A)
#define PROBE(A, k)
#define PROBE_OUT(A, arr, slots, cond)
#endif

template <typename T> struct Vec { static constexpr int n = 16 / static_cast<int>(sizeof(T)); };

template <typename T>
__device__ __forceinline__ void vload(const T* p, T* o) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
}

// two values (8 or 16 bytes)
template <typename T>
__device__ __forceinline__ void vload2(const T* p, T* o) {
  if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void vstore(T* p, const T* o) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
  }
}

__host__ __device__ constexpr int split_threads(int J) { return (4 * J + 31) / 32 * 32; }

// The forward kernels' shared memory, in values: the U, V and ec tables
// [2][kTab][2 CPT], the rows V - q [2][2 CPT], y and s2 [2][kTab], the
// reduction buffer [2][warps][2], the D, zp ring [kTab][2], and in K3 with
// kc >= 2 the checkpoint's staging, three J x (J + 1) blocks (stJ = J).
__host__ __device__ constexpr long long split_fwd_len(int cpt, int stJ) {
  return 2LL * kTab * 3 * 2 * cpt + 4LL * cpt + 4LL * kTab + 4LL * kSplitMaxWarps + 2LL * kTab +
         3LL * stJ * (stJ + 1);
}

// cp.async of one value (4 or 8 bytes) from device to shared memory
template <typename T>
__device__ __forceinline__ void cp_async_val(T* smem_dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  }
}

// cp.async of 16 bytes (a vector of the register design's layout)
template <typename T>
__device__ __forceinline__ void cp_async_vec(T* smem_dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K4's shared memory but the chunk, in values: the window's rows W, U and
// pre [kTab][2 CPT], ec, cos and sin [kTab][CPT], D, zp, t and dt
// [kTab]; the V-bar rows [2][2 CPT]; the deferred chain-rule rows
// (U-bar, V-bar, the ec part) [ks][3][2 CPT] and terms [ks][2][CPT]; the
// reduction buffer [2][warps][4].
__host__ __device__ constexpr long long split_bwd_len(int cpt, int ks) {
  return kTab * (9LL * cpt + 4) + 4LL * cpt + ks * 8LL * cpt + 8LL * kSplitMaxWarps;
}

// A chunk slot: the T row segments of one step, CPT values a thread,
// interleaved by 16-byte vectors so that a warp's vector accesses are
// consecutive.
__host__ __device__ constexpr long long split_slot_len(int J, int cpt) {
  return static_cast<long long>(split_threads(J)) * cpt;
}

// K1, K2, K0 and K3 (one template, as wide_fwd_kernel): one block a chain.
// A step: the column loop T = S + (W_r D) W, S = (ec_r ec) o T, q_r =
// S U (both halves, a shuffle), then one barrier, after which every
// thread has D and zp from the warps' partial sums and the rows V - q
// (written before it), and so W of its columns. Tables of U, V and ec
// for kTab steps are built a block ahead from values loaded a block
// before that; the Kahan sums of a block's logs run on warp 0 at its end.
template <typename T, int CPT, int G, bool Aug, bool Carry>
__global__ void __launch_bounds__(4 * CPT, (split_min_blocks<T, CPT, false>()))
split_fwd_kernel(const FwdArgs<T> p) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chain = blockIdx.x, tid = threadIdx.x;
  const int J = p.J, R = 2 * J, N = p.N;
  const int r = tid >> 1, hl = tid & 1;
  const bool act = r < R;
  const int h = (act && r >= J) ? 1 : 0;
  const int i = act ? r - h * J : 0;
  const int own = h * CPT + i;  // this row in the tables
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const bool pt = tid < 4 * J;  // builds table entries: term ti, steps q0 and q0 + 4
  const int ti = pt ? tid % J : 0, q0 = pt ? tid / J : 0;
  T* Ut = reinterpret_cast<T*>(smem_raw);   // [2][kTab][2 CPT]
  T* Vt = Ut + 2 * kTab * 2 * CPT;
  T* Et = Vt + 2 * kTab * 2 * CPT;
  T* dq = Et + 2 * kTab * 2 * CPT;           // [2][2 CPT]: V - q of a step's rows
  T* Yt = dq + 4 * CPT;                      // [2][kTab]
  T* S2t = Yt + 2 * kTab;
  T* red = S2t + 2 * kTab;                   // [2][warps][2]
  T* ring = red + 4 * kSplitMaxWarps;        // [kTab][2]: D, zp
  T* Tst = ring + 2 * kTab;                  // K3's checkpoint staging [3][J][J + 1]
  const bool staged = Aug && p.kc >= 2;      // (kc 1: a step's rows straight to the table)
  for (int e = tid; e < 2 * kTab * 6 * CPT + 4 * CPT; e += blockDim.x) Ut[e] = T(0);
  __syncthreads();  // the padding is zero before any row is written

  const T* t = p.t;
  const T* dt = p.dt;
  int nv = N, nsteps = N;
  if (G == kPerLane) {
    t += static_cast<long long>(chain) * N;
    if (dt) dt += static_cast<long long>(chain) * (N - 1);
    nv = p.n_valid[chain];
    if (!Aug) nsteps = min(max(nv, 0), N);
  }
  const long long cN = static_cast<long long>(chain) * N;
  const long long JJ = static_cast<long long>(J) * J;
  const long long C = 3 * JJ + 4 * J + 2;  // carry values a chain
  T ta = T(0), tb = T(0), tc = T(0), td = T(0);
  if (G != kTables && pt) {
    const long long o = static_cast<long long>(chain) * J + ti;
    ta = p.a[o];
    tb = p.b[o];
    tc = p.c[o];
    td = p.d[o];
  }

  // raw table values of the pairs (q0, ti) and (q0 + 4, ti) of a block,
  // loaded a block before they are used: t and its spacing (or the
  // previous t), or K0's U, V, phi of both halves; y and s2 (ti == 0)
  T x[2][8];
  auto load_raw = [&](int blk) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int m = blk * kTab + q0 + 4 * q;
      if (pt && m < N) {
        if (G == kTables) {
          const long long o0 = (static_cast<long long>(m) * R + ti) * p.B + chain;
          const long long o1 = (static_cast<long long>(m) * R + J + ti) * p.B + chain;
          x[q][0] = p.U[o0];
          x[q][1] = p.U[o1];
          x[q][2] = p.V[o0];
          x[q][3] = p.V[o1];
          x[q][4] = p.phi[o0];
          x[q][5] = p.phi[o1];
        } else {
          x[q][0] = t[m];
          x[q][1] = Carry ? dt[m] : (m == 0 ? T(0) : (dt ? dt[m - 1] : t[m - 1]));
        }
        if (ti == 0) {
          x[q][6] = p.y[cN + m];
          x[q][7] = p.s2[cN + m];
        }
      }
    }
  };
  auto write_table = [&](int blk) {
    const int b = (blk & 1) * kTab;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int s = q0 + 4 * q, m = blk * kTab + s;
      if (pt && m < N) {
        T* u = Ut + (b + s) * 2 * CPT;
        T* v = Vt + (b + s) * 2 * CPT;
        T* e = Et + (b + s) * 2 * CPT;
        if (G == kTables) {
          u[ti] = x[q][0];
          u[CPT + ti] = x[q][1];
          v[ti] = x[q][2];
          v[CPT + ti] = x[q][3];
          e[ti] = x[q][4];
          e[CPT + ti] = x[q][5];
        } else {
          const T dtm = (Carry || dt != nullptr || m == 0) ? x[q][1] : x[q][0] - x[q][1];
          T si, co;
          Ops<T>::sincos_(td * x[q][0], &si, &co);
          u[ti] = ta * co + tb * si;
          u[CPT + ti] = ta * si - tb * co;
          v[ti] = co;
          v[CPT + ti] = si;
          e[ti] = e[CPT + ti] = Ops<T>::exp_(-(tc * dtm));
        }
        if (ti == 0) {
          Yt[b + s] = x[q][6];
          S2t[b + s] = x[q][7];
        }
      }
    }
  };

  // the Kahan sums, min D, over steps [lo, lo + cnt) (cnt <= kTab) of the
  // ring, on warp 0: lanes take the logs at once, then add in step order
  T logdet = T(0), clog = T(0), quad = T(0), cquad = T(0), minD = T(INFINITY);
  auto flush = [&](int lo, int cnt) {
    __syncwarp();
    T lg = T(0), qq = T(0), md = T(INFINITY);
    if (lane < cnt) {
      const int m = lo + lane;
      const T Dv = ring[(m % kTab) * 2], zv = ring[(m % kTab) * 2 + 1];
      if (G != kPerLane || m < nv) {
        lg = Ops<T>::log_(Ops<T>::abs_(Dv));
        qq = zv * zv / Dv;
        md = Dv < md ? Dv : md;
      }
    }
    for (int s = 0; s < cnt; ++s) {
      kahan_add(logdet, clog, __shfl_sync(kFull, lg, s));
      kahan_add(quad, cquad, __shfl_sync(kFull, qq, s));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(kFull, md, off);
      md = o < md ? o : md;
    }
    minD = md < minD ? md : minD;
  };

  T suma;
  if (G == kTables) {
    suma = p.suma[chain];
  } else {
    if (warp == 0) {
      T v = T(0);
      for (int e = lane; e < J; e += 32) v += p.a[static_cast<long long>(chain) * J + e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if (lane == 0) ring[0] = v;
    }
  }

  // the state: S (own columns), the previous step's W, f, D and zp; a
  // carry holds S00, S01 and S11 row-major (S10 = S01^T)
  const T* cin = Carry ? p.cin + chain * C : nullptr;
  T S[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    T v = T(0);
    if (Carry && act && k < J) {
      v = (h == 1 && hl == 0) ? cin[JJ + static_cast<long long>(k) * J + i]
                              : cin[(h + hl) * JJ + static_cast<long long>(i) * J + k];
    }
    S[k] = v;
  }
  T f = (Carry && act) ? cin[3 * JJ + R + r] : T(0);
  T Dp = Carry ? cin[3 * JJ + 2 * R] : T(0);
  T zpp = Carry ? cin[3 * JJ + 2 * R + 1] : T(0);
  T rDp = T(1);  // W of step n - 1 is its V - q times rDp: a carry's W as it is
  if (act && hl == 0) dq[2 * CPT + own] = Carry ? cin[3 * JJ + r] : T(0);
  load_raw(0);
  write_table(0);
  load_raw(1);
  __syncthreads();
  if (G != kTables) suma = ring[0];
  __syncthreads();  // ring[0] is read before the first step writes it

  const int nck = Aug ? (N + p.kc - 1) / p.kc : 0;
  // K3's staged checkpoint goes out coalesced, in slices over the kc - 1
  // steps after it (after their barriers; the staging is next written at
  // the next checkpoint, after the barrier of the step before it), so that
  // the chains, which reach a checkpoint together, do not all store at once
  auto copy_rows = [&](int n) {
    const int sc = n % p.kc, nsl = max(p.kc - 1, 1);
    if (sc >= nsl) return;
    T* g = p.Tcp + (static_cast<long long>(chain) * nck + n / p.kc) * 3 * JJ;
    for (int row = 3 * J * sc / nsl + warp; row < 3 * J * (sc + 1) / nsl; row += nw) {
      for (int col = lane; col < J; col += 32) g[row * J + col] = Tst[row * (J + 1) + col];
    }
  };
  T Wl = T(0);  // this row's W of the last step
  PROBE_DECL(pf)
  for (int n = 0; n < nsteps; ++n) {
    const int blk = n / kTab, s = n - blk * kTab, sb = (blk & 1) * kTab + s;
    if (s == 1) {  // the next block's table (its buffer was last read before the last barrier)
      write_table(blk + 1);
      load_raw(blk + 2);
    }
    PROBE(pf, 0)
    const T* Un = Ut + sb * 2 * CPT;
    const T* En = Et + sb * 2 * CPT;
    const T* dqp = dq + ((n + 1) & 1) * 2 * CPT;
    T q = T(0), Ur = T(0), Vr = T(0), Er = T(0), Wr = T(0);
    if (act) {
      Ur = Un[own];
      Vr = Vt[sb * 2 * CPT + own];
      Er = En[own];
      Wr = dqp[own] * rDp;
      const T wd = Wr * Dp;
      const T* dqc = dqp + hl * CPT;
      const T* uc = Un + hl * CPT;
      const T* ec = En + hl * CPT;
      // K3: every kc steps this step's T row segments go to the checkpoint
      // (T00 and T01 from rows r < J, T11 from rows r >= J; T10 = T01^T is
      // not kept), through the staging, which the block copies out whole
      // after the barrier
      T* tile = nullptr;
      if (Aug && n % p.kc == 0 && h <= hl)
        tile = staged ? Tst + ((h + hl) * J + i) * (J + 1)
                      : p.Tcp + (static_cast<long long>(chain) * nck + n / p.kc) * 3 * JJ +
                            (h + hl) * JJ + static_cast<long long>(i) * J;
      T q0s = T(0), q1s = T(0);
      auto cols = [&](auto ckpt) {
#pragma unroll
        for (int k = 0; k < CPT; k += V) {
          T dv[V], uv[V], ev[V];
          vload(dqc + k, dv);
          vload(uc + k, uv);
          vload(ec + k, ev);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const T Tv = S[k + e] + wd * (dv[e] * rDp);
            if (decltype(ckpt)::value) {
              if (k + e < J) tile[k + e] = Tv;
            }
            S[k + e] = (Er * ev[e]) * Tv;
            if ((k / V) & 1) {
              q1s += S[k + e] * uv[e];
            } else {
              q0s += S[k + e] * uv[e];
            }
          }
        }
      };
      if (tile != nullptr) {
        cols(std::true_type{});
      } else {
        cols(std::false_type{});
      }
      q = q0s + q1s;
    }
    PROBE(pf, 1)
    const T qo = q + __shfl_xor_sync(kFull, q, 1);
    T pre = T(0), dqn = T(0), s0v = T(0), s1v = T(0);
    if (act) {
      pre = f + Wr * zpp;
      f = Er * pre;
      dqn = Vr - qo;
      if (hl == 0) {
        dq[(n & 1) * 2 * CPT + own] = dqn;
        s0v = Ur * qo;
        s1v = Ur * f;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0v += __shfl_xor_sync(kFull, s0v, off);
      s1v += __shfl_xor_sync(kFull, s1v, off);
    }
    T* rb = red + (n & 1) * 2 * kSplitMaxWarps;
    if (lane == 0) {
      rb[2 * warp] = s0v;
      rb[2 * warp + 1] = s1v;
    }
    PROBE(pf, 2)
    __syncthreads();  // the rows V - q and the warps' sums of U.q and U.f
    PROBE(pf, 3)
    T tot0 = T(0), tot1 = T(0);
    for (int w = 0; w < nw; ++w) {
      T v[2];
      vload2(rb + 2 * w, v);
      tot0 += v[0];
      tot1 += v[1];
    }
    const T Dn = (suma + S2t[sb]) - tot0;
    const T zpn = Yt[sb] - tot1;
    const T rD = T(1) / Dn;
    Wl = dqn * rD;
    PROBE(pf, 4)
    if (staged) copy_rows(n);
    PROBE(pf, 5)
    if (Aug) {
      if (act && hl == 0) {
        const long long o = (cN + n) * J + i;
        (h ? p.W1t : p.W0t)[o] = Wl;
        (h ? p.P1t : p.P0t)[o] = pre;
      }
      if (tid == 0) {
        p.Dt[cN + n] = Dn;
        p.ZPt[cN + n] = zpn;
      }
    }
    if (tid == 0) {
      ring[s * 2] = Dn;
      ring[s * 2 + 1] = zpn;
    }
    PROBE(pf, 6)
    if (warp == 0 && s == kTab - 1) flush(n - s, kTab);
    Dp = Dn;
    zpp = zpn;
    rDp = rD;
  }
  const int tail = nsteps % kTab;
  if (warp == 0 && tail) flush(nsteps - tail, tail);
  if (staged) {  // the last checkpoint's slices past the last step
    for (int n = nsteps; n < (nsteps - 1) / p.kc * p.kc + p.kc - 1; ++n) copy_rows(n);
  }
  PROBE_OUT(pf, wide_probe_fwd, 8, Aug && G == kShared && tid == 0)
  if (Carry) {  // the state after the last step (own columns), the partials
    T* co = p.cout + chain * C;
    if (act && h <= hl) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        if (k < J) co[(h + hl) * JJ + static_cast<long long>(i) * J + k] = S[k];
      }
    }
    if (act && hl == 0) {
      co[3 * JJ + r] = Wl;
      co[3 * JJ + R + r] = f;
    }
    if (tid == 0) {
      co[3 * JJ + 2 * R] = Dp;
      co[3 * JJ + 2 * R + 1] = zpp;
      p.parts[3LL * chain] = logdet;
      p.parts[3LL * chain + 1] = quad;
      p.parts[3LL * chain + 2] = minD;
    }
    return;
  }
  if (tid == 0) {
    const T ll = T(-0.5) * (logdet + quad + static_cast<T>(nv) * T(kLog2Pi));
    const bool ok = (minD > T(0)) && isfinite(ll);
    p.out[chain] = ok ? ll : T(-INFINITY);
  }
}

// K4: one block a chain, G in registers. A chunk of kc steps is swept in
// sub-chunks of ks steps from last to first. Phase 1: every thread
// replays its own row segments of T from the chunk's checkpoint (T_{m+1}
// = (ec_m ec_m^T) o T_m + D_m W_m W_m^T, entry by entry, so no thread
// reads another's) into the sub-chunk's slots, in shared memory or in the
// device scratch. Phase 2, a step: G's row times W (both halves, a
// shuffle), V-bar of the row and the warps' partial sums of D-bar,
// zp-bar and sum W-bar W, one barrier, then the column loop (G, the U and
// ec cotangents of the row) from the V-bar rows. The coefficient chain
// rule of a sub-chunk's steps runs at its end, from rows kept per step.
// The residual rows of up to kTab steps (a window of the chunk) are
// loaded, and sincos and exp taken, once for all the sub-chunks.
template <typename T, int CPT, bool PerLaneT, bool Carry>
__global__ void __launch_bounds__(4 * CPT, (split_min_blocks<T, CPT, true>()))
split_bwd_kernel(const BwdArgs<T> p) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chain = blockIdx.x, tid = threadIdx.x, nts = blockDim.x;
  const int J = p.J, R = 2 * J, N = p.N, kc = p.kc, ks = p.ks;
  const int r = tid >> 1, hl = tid & 1;
  const bool act = r < R;
  const int h = (act && r >= J) ? 1 : 0;
  const int i = act ? r - h * J : 0;
  const int own = h * CPT + i;
  const int lane = tid & 31, warp = tid >> 5, nw = nts >> 5;
  const bool pt = tid < 4 * J;  // a term's thread: term ti of steps q0, q0 + 4, ...
  const int ti = pt ? tid % J : 0, q0 = pt ? tid / J : 0;
  const long long cN = static_cast<long long>(chain) * N;
  const long long JJ = static_cast<long long>(J) * J;
  const long long CA = 3 * JJ + 2 * J;  // adjoint carry values a chain
  const T gl = p.g[chain];
  if (gl == T(0)) {  // no seed (a -inf chain): exact zeros, whatever the tables hold
    for (int e = tid; e < J; e += nts) {
      const long long o = static_cast<long long>(chain) * J + e;
      p.abar[o] = p.bbar[o] = p.cbar[o] = p.dbar[o] = T(0);
    }
    for (int n = tid; n < N; n += nts)
      p.ybar[cN + n] = p.s2bar[cN + n] = p.tb[cN + n] = p.dtb[cN + n] = T(0);
    if (Carry) {
      for (long long e = tid; e < CA; e += nts) p.aout[chain * CA + e] = T(0);
    }
    return;
  }
  const T* t = p.t;
  const T* dt = p.dt;
  int nv = N;
  if (PerLaneT) {
    t += static_cast<long long>(chain) * N;
    if (dt) dt += static_cast<long long>(chain) * (N - 1);
    nv = p.n_valid[chain];
  }
  auto step_dt = [&](int m) -> T {
    if (Carry) return dt[m];
    if (m == 0) return T(0);
    return dt ? dt[m - 1] : t[m] - t[m - 1];
  };
  T ta = T(0), tb = T(0), tc = T(0), td = T(0);
  if (pt) {
    const long long o = static_cast<long long>(chain) * J + ti;
    ta = p.a[o];
    tb = p.b[o];
    tc = p.c[o];
    td = p.d[o];
  }

  T* Ww = reinterpret_cast<T*>(smem_raw);  // the window: [kTab][2 CPT] rows
  T* Uw = Ww + kTab * 2 * CPT;
  T* Pw = Uw + kTab * 2 * CPT;
  T* Ew = Pw + kTab * 2 * CPT;              // [kTab][CPT] by term
  T* Cw = Ew + kTab * CPT;
  T* Sw = Cw + kTab * CPT;
  T* Vb = Sw + kTab * CPT;                  // [2][2 CPT]: V-bar of a step's rows
  T* X = Vb + 4 * CPT;                      // [ks][3][2 CPT]: U-bar, V-bar, ec part
  T* TT = X + ks * 6 * CPT;                 // [ks][2][CPT]: t-bar, dt-bar terms
  T* red = TT + ks * 2 * CPT;               // [2][warps][4]
  T* Dw = red + 8 * kSplitMaxWarps;         // [kTab] each: D, zp, t, dt
  T* Zw = Dw + kTab;
  T* Tw = Zw + kTab;
  T* DTw = Tw + kTab;
  const long long slot_len = static_cast<long long>(nts) * CPT;
  T* chunk = DTw + kTab;                    // [ks] slots of slot_len
  for (int e = tid; e < kTab * 9 * CPT + 4 * CPT; e += nts) Ww[e] = T(0);

  // G: own columns of row r; an adjoint carry holds P00, M01 and P11
  // row-major (M10 = M01^T)
  const T* ain = Carry ? p.ain + chain * CA : nullptr;
  T G[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    T v = T(0);
    if (Carry && act && k < J) {
      v = (h == 1 && hl == 0) ? ain[JJ + static_cast<long long>(k) * J + i]
                              : ain[(h + hl) * JJ + static_cast<long long>(i) * J + k];
    }
    G[k] = v;
  }
  T cp = (Carry && act) ? ain[3 * JJ + r] : T(0);  // deferred cotangent of pre_{m+1}, row r
  T ab = T(0), bb = T(0), cb = T(0), db = T(0), sumabar = T(0);
  // this thread's T row segment in the checkpoint, where it holds one:
  // T00, T01 or T11 rows, or a T01 column for T10
  const long long ck_off = (h == 1 && hl == 0) ? JJ + i : (h + hl) * JJ + static_cast<long long>(i) * J;
  const int ck_str = (h == 1 && hl == 0) ? J : 1;
  const int nck = (N + kc - 1) / kc;
  int win = -1;  // the window's first step
  // this thread's checkpoint row segment (k < J; zeros past J) into a slot
  // by cp.async (16 bytes a copy where the segment is a row and J is a
  // whole number of vectors, so that a vector is all past J or all before it)
  const bool ck_vec = ck_str == 1 && J % V == 0;
  auto stage_ck = [&](const T* src, T* slot) {
    if (!act) return;
#pragma unroll
    for (int k = 0; k < CPT; k += V) {
      T* d = slot + (static_cast<long long>(k / V) * nts + tid) * V;
      if (ck_vec && k < J) {
        cp_async_vec(d, src + k);
        continue;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (k + e >= J) {
          d[e] = T(0);
        } else {
          cp_async_val(d + e, src + static_cast<long long>(k + e) * ck_str);
        }
      }
    }
  };

  // the residual rows, sincos and exp of steps [lo, lo + cnt) of the window
  auto build_window = [&](int lo, int cnt) {
    __syncthreads();  // every read of the last window is done
    if (pt) {
      for (int s = q0; s < cnt; s += 4) {
        const int m = lo + s;
        const T tm = t[m], dtm = step_dt(m);
        T si, co;
        Ops<T>::sincos_(td * tm, &si, &co);
        Ew[s * CPT + ti] = Ops<T>::exp_(-(tc * dtm));
        Cw[s * CPT + ti] = co;
        Sw[s * CPT + ti] = si;
        Uw[s * 2 * CPT + ti] = ta * co + tb * si;
        Uw[s * 2 * CPT + CPT + ti] = ta * si - tb * co;
        const long long o = (cN + m) * J + ti;
        Ww[s * 2 * CPT + ti] = p.W0t[o];
        Ww[s * 2 * CPT + CPT + ti] = p.W1t[o];
        Pw[s * 2 * CPT + ti] = p.P0t[o];
        Pw[s * 2 * CPT + CPT + ti] = p.P1t[o];
        if (ti == 0) {
          Dw[s] = p.Dt[cN + m];
          Zw[s] = p.ZPt[cN + m];
          Tw[s] = tm;
          DTw[s] = dtm;
        }
      }
    }
    __syncthreads();
    win = lo;
  };
  PROBE_DECL(pb)
  // the last chunk's checkpoint, for the first sub-chunk
  stage_ck(p.Tcp + (static_cast<long long>(chain) * nck + nck - 1) * 3 * JJ + ck_off, chunk);

  for (int ch = nck - 1; ch >= 0; --ch) {
    const int base = ch * kc;
    const int len = min(kc, N - base);
    const T* ck = p.Tcp + (static_cast<long long>(chain) * nck + ch) * 3 * JJ + ck_off;
    // windows of kTab steps from the chunk's first; a sub-chunk lies in one
    // (ks divides kTab where the chunk is longer than a window)
    auto need = [&](int m) {
      const int lo = base + (m - base) / kTab * kTab;
      if (lo != win) build_window(lo, min(kTab, base + len - lo));
    };
    for (int sc = (len + ks - 1) / ks - 1; sc >= 0; --sc) {
      const int s0 = base + sc * ks;
      const int s1 = min(s0 + ks, base + len);
      PROBE(pb, 7)

      // ---- phase 1: T_m for m in [s0, s1) from the checkpoint, this
      // thread's segments only; the steps before s0 replay in place in slot 0.
      // The checkpoint is in slot 0 by cp.async, issued at the end of the
      // last sub-chunk (or the kernel's start), while the window's rows load.
      need(base);
      cp_async_wait_all();
      for (int m = base; m < s1 - 1; ++m) {
        need(m);
        PROBE(pb, 0)
        const int w = m - win;
        T* src = chunk + (m >= s0 ? m - s0 : 0) * slot_len;
        T* dst = chunk + (m + 1 >= s0 ? m + 1 - s0 : 0) * slot_len;
        if (act) {
          const T Er = Ew[w * CPT + i];
          const T wd = Ww[w * 2 * CPT + own] * Dw[w];
          const T* ec = Ew + w * CPT;
          const T* wc = Ww + w * 2 * CPT + hl * CPT;
          // vector by vector: src and dst may be one slot
#pragma unroll
          for (int k = 0; k < CPT; k += V) {
            const long long o = (static_cast<long long>(k / V) * nts + tid) * V;
            T v[V], e4[V], w4[V];
            vload(src + o, v);
            vload(ec + k, e4);
            vload(wc + k, w4);
#pragma unroll
            for (int e = 0; e < V; ++e) v[e] = (Er * e4[e]) * v[e] + wd * w4[e];
            vstore(dst + o, v);
          }
        }
        PROBE(pb, 1)
      }
      need(s0);
      PROBE(pb, 0)

      // ---- phase 2: the reverse sweep over the sub-chunk's steps
      for (int m = s1 - 1; m >= s0; --m) {
        const int w = m - win, sl = m - s0;
        const T Dm = Dw[w], zpm = Zw[w];
        const T rD = T(1) / Dm;
        T Wr = T(0), pre = T(0), Ur = T(0), Er = T(0), Vr = T(0);
        T part = T(0);
        if (act) {
          Wr = Ww[w * 2 * CPT + own];
          pre = Pw[w * 2 * CPT + own];
          Ur = Uw[w * 2 * CPT + own];
          Er = Ew[w * CPT + i];
          Vr = h ? Sw[w * CPT + i] : Cw[w * CPT + i];
          // G's row times W_m: this half's columns
          const T* wc = Ww + w * 2 * CPT + hl * CPT;
          T p0 = T(0), p1 = T(0);
#pragma unroll
          for (int k = 0; k < CPT; k += V) {
            T w4[V];
            vload(wc + k, w4);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              if ((k / V) & 1) {
                p1 += G[k + e] * w4[e];
              } else {
                p0 += G[k + e] * w4[e];
              }
            }
          }
          part = p0 + p1;
        }
        const T qr = Vr - Wr * Dm;
        const T oth = __shfl_xor_sync(kFull, part, 1);
        PROBE(pb, 2)
        // consume G: T_{m+1} = S_m + D_m W_m W_m^T. diag is row r of P00 (or
        // P11) times W0 (W1), off row r of M01 (M10) times W1 (W0)
        const T lo = hl ? oth : part, hi = hl ? part : oth;
        const T diag = h ? hi : lo;
        const T off = h ? lo : hi;
        const T Wbar = (diag + off) * Dm + cp * zpm;
        const T Vbar = Wbar * rD;
        T sums[3] = {T(0), T(0), T(0)};
        T* rb = red + (m & 1) * 4 * kSplitMaxWarps;
        if (act && hl == 0) {
          Vb[(m & 1) * 2 * CPT + own] = Vbar;
          sums[0] = h ? T(0.5) * Wr * diag : Wr * (T(0.5) * diag + off);  // Dbar
          sums[1] = cp * Wr;                                                 // zpbar (pre_{m+1})
          sums[2] = Wbar * Wr;                                               // sum(Wbar o W)
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sums[k] += __shfl_xor_sync(kFull, sums[k], o);
        }
        if (lane == 0) {
          rb[4 * warp] = sums[0];
          rb[4 * warp + 1] = sums[1];
          rb[4 * warp + 2] = sums[2];
        }
        PROBE(pb, 3)
        __syncthreads();  // the V-bar rows and the warps' sums
        PROBE(pb, 4)
        T Dbar = T(0), zpbar = T(0), Wsum = T(0);
        for (int k = 0; k < nw; ++k) {
          T v[4];
          vload2(rb + 4 * k, v);
          vload2(rb + 4 * k + 2, v + 2);
          Dbar += v[0];
          zpbar += v[1];
          Wsum += v[2];
        }
        T fbar = cp;
        // loss seeds, scaled by the chain's cotangent, on the live steps
        if (!PerLaneT || m < nv) {
          Dbar -= T(0.5) * gl * (rD - zpm * zpm * (rD * rD));
          zpbar -= gl * zpm * rD;
        }
        // zp = y - U . f, f = ec o pre
        T Ubar = -zpbar * (Er * pre);
        fbar -= zpbar * Ur;
        T ecpart = fbar * pre;
        cp = Er * fbar;
        // W = (V - q) / D
        T qbar = -Vbar;
        Dbar -= Wsum * rD;
        // D = suma + s2 - U . q
        sumabar += Dbar;
        Ubar -= Dbar * qr;
        qbar -= Dbar * Ur;
        if (tid == 0) {
          p.ybar[cN + m] = zpbar;
          p.s2bar[cN + m] = Dbar;
        }
        PROBE(pb, 5)

        // q = S U with S = (ec ec^T) o T: the U and ec cotangents, and the
        // new G = (ec ec^T) o Q, Q = G + qbar U^T + U qbar^T (row r)
        T uacc = T(0), eacc = T(0);
        if (act) {
          const T* Tm = chunk + sl * slot_len;
          const T* vbc = Vb + (m & 1) * 2 * CPT + hl * CPT;
          const T* uc = Uw + w * 2 * CPT + hl * CPT;
          const T* ec = Ew + w * CPT;
#pragma unroll
          for (int k = 0; k < CPT; k += V) {
            T tv[V], vb[V], u4[V], e4[V];
            vload(Tm + (static_cast<long long>(k / V) * nts + tid) * V, tv);
            vload(vbc + k, vb);
            vload(uc + k, u4);
            vload(ec + k, e4);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const T qc = -vb[e] - Dbar * u4[e];
              const T ee = Er * e4[e];
              const T Q = G[k + e] + qbar * u4[e] + Ur * qc;
              uacc += ee * tv[e] * qc;
              eacc += Q * tv[e] * e4[e];
              G[k + e] = ee * Q;
            }
          }
        }
        uacc += __shfl_xor_sync(kFull, uacc, 1);
        eacc += __shfl_xor_sync(kFull, eacc, 1);
        if (act && hl == 0) {
          T* xs = X + sl * 6 * CPT;
          xs[own] = Ubar + uacc;
          xs[2 * CPT + own] = Vbar;
          xs[4 * CPT + own] = ecpart + eacc;
        }
        PROBE(pb, 6)
      }

      // the slots are free: the next sub-chunk's checkpoint into slot 0,
      // under the chain rule
      if (sc > 0 || ch > 0) stage_ck(sc > 0 ? ck : ck - 3 * JJ, chunk);

      // the coefficient chain rule of the sub-chunk's steps, term by term:
      // U0 = a co + b si, U1 = a si - b co, V = (co, si), co = cos(d t),
      // si = sin(d t), ec = exp(-c dt)
      __syncthreads();  // the rows of every step
      const int nsub = s1 - s0;
      if (pt) {
        for (int s = q0; s < nsub; s += 4) {
          const int w = s0 + s - win;
          const T* xs = X + s * 6 * CPT;
          const T U0bar = xs[ti], U1bar = xs[CPT + ti];
          T cobar = xs[2 * CPT + ti], sibar = xs[3 * CPT + ti];
          const T ecbar = xs[4 * CPT + ti] + xs[5 * CPT + ti];
          const T co = Cw[w * CPT + ti], si = Sw[w * CPT + ti], Er = Ew[w * CPT + ti];
          ab += U0bar * co + U1bar * si;
          bb += U0bar * si - U1bar * co;
          cobar += U0bar * ta - U1bar * tb;
          sibar += U0bar * tb + U1bar * ta;
          const T dchain = -cobar * si + sibar * co;
          db += Tw[w] * dchain;
          cb -= DTw[w] * ecbar * Er;
          TT[s * 2 * CPT + ti] = td * dchain;
          TT[s * 2 * CPT + CPT + ti] = -(tc * ecbar * Er);
        }
      }
      __syncthreads();  // the terms
      for (int s = warp; s < nsub; s += nw) {
        T v0 = T(0), v1 = T(0);
        for (int e = lane; e < J; e += 32) {
          v0 += TT[s * 2 * CPT + e];
          v1 += TT[s * 2 * CPT + CPT + e];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v0 += __shfl_xor_sync(kFull, v0, o);
          v1 += __shfl_xor_sync(kFull, v1, o);
        }
        if (lane == 0) {
          p.tb[cN + s0 + s] = v0;
          p.dtb[cN + s0 + s] = v1;
        }
      }
      PROBE(pb, 7)
    }
  }
  PROBE_OUT(pb, wide_probe_bwd, 16, tid == 0)
  // a term's sums from its four threads, in order
  __syncthreads();  // every read of the window is done
  if (pt) {
    Ww[(q0 * 4) * J + ti] = ab;
    Ww[(q0 * 4 + 1) * J + ti] = bb;
    Ww[(q0 * 4 + 2) * J + ti] = cb;
    Ww[(q0 * 4 + 3) * J + ti] = db;
  }
  __syncthreads();
  for (int e = tid; e < J; e += nts) {
    T s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = ((Ww[k * J + e] + Ww[(4 + k) * J + e]) + Ww[(8 + k) * J + e]) + Ww[(12 + k) * J + e];
    const long long o = static_cast<long long>(chain) * J + e;
    p.abar[o] = s[0] + sumabar;  // sum(a) feeds D at every step
    p.bbar[o] = s[1];
    p.cbar[o] = s[2];
    p.dbar[o] = s[3];
  }
  if (Carry && act) {  // G's row segments and cpre at the block's first step
    T* ao = p.aout + chain * CA;
    if (h <= hl) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        if (k < J) ao[(h + hl) * JJ + static_cast<long long>(i) * J + k] = G[k];
      }
    }
    if (hl == 0) ao[3 * JJ + r] = cp;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The register design's instantiations: CPT, the columns a thread holds,
// for J <= CPT. Past 64 a row segment and its loads no longer fit the
// registers of a block of 4 J threads (at CPT = 100 float32 spilled 2 KB
// a thread, and its K4 ran slower than one thread a row).
constexpr bool split_has(int cpt) { return cpt == 40 || cpt == 64; }

template <typename T, int CPT, int G, bool Aug, bool Carry>
int launch_split_fwd(const FwdArgs<T>& p, cudaStream_t stream) {
  const long long smem = split_fwd_len(CPT, Aug && p.kc >= 2 ? p.J : 0) *
                         static_cast<long long>(sizeof(T));
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = split_fwd_kernel<T, CPT, G, Aug, Carry>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<p.B, split_threads(p.J), static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cpt 0: one thread a row, the state in shared memory or p.state;
// otherwise the register design at that CPT (p.state null)
template <typename T, int G, bool Aug, bool Carry = false>
int launch_fwd(const FwdArgs<T>& p, int cpt, cudaStream_t stream) {
  if (p.J < 1 || p.J > kMaxTerms || (G == kPerLane && p.n_valid == nullptr) ||
      (Aug && p.kc < 1) ||
      (Carry && (p.dt == nullptr || p.cin == nullptr || p.cout == nullptr || p.parts == nullptr)) ||
      (cpt != 0 && (!split_has(cpt) || p.J > cpt || p.state != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B <= 0 || p.N <= 0) return static_cast<int>(cudaSuccess);
  if (cpt == 40) return launch_split_fwd<T, 40, G, Aug, Carry>(p, stream);
  if (cpt == 64) return launch_split_fwd<T, 64, G, Aug, Carry>(p, stream);
  const long long smem = fwd_smem_len(p.J, p.state == nullptr) * static_cast<long long>(sizeof(T));
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wide_fwd_kernel<T, G, Aug, Carry>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<p.B, threads_of(p.J), static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPT, bool PerLaneT, bool Carry>
int launch_split_bwd(const BwdArgs<T>& p, cudaStream_t stream) {
  const long long smem =
      (split_bwd_len(CPT, p.ks) + p.ks * split_slot_len(p.J, CPT)) *
      static_cast<long long>(sizeof(T));
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = split_bwd_kernel<T, CPT, PerLaneT, Carry>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<p.B, split_threads(p.J), static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cpt 0: one thread a row, G and the T chunk in shared memory or in
// p.carry / p.chunk, ks <= 8; otherwise the register design at that CPT
// (p.carry and p.chunk null: G in registers, the chunk's slots in shared
// memory), ks <= min(kc, kTab), and ks divides kTab where kc > kTab
template <typename T, bool PerLaneT, bool Carry = false>
int launch_bwd(const BwdArgs<T>& p, int cpt, cudaStream_t stream) {
  if (p.J < 1 || p.J > kMaxTerms || p.kc < 1 || p.ks < 1 || p.ks > p.kc || p.ks > kMaxSub ||
      (PerLaneT && p.n_valid == nullptr) ||
      (Carry && (p.dt == nullptr || p.ain == nullptr || p.aout == nullptr)) ||
      (cpt != 0 && (!split_has(cpt) || p.J > cpt || p.carry != nullptr || p.chunk != nullptr ||
                    (p.kc > kTab && kTab % p.ks != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B <= 0 || p.N <= 0) return static_cast<int>(cudaSuccess);
  if (cpt == 40) return launch_split_bwd<T, 40, PerLaneT, Carry>(p, stream);
  if (cpt == 64) return launch_split_bwd<T, 64, PerLaneT, Carry>(p, stream);
  const long long smem = bwd_smem_len(p.J, p.ks, p.carry == nullptr, p.chunk == nullptr) *
                         static_cast<long long>(sizeof(T));
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wide_bwd_kernel<T, PerLaneT, Carry>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<p.B, threads_of(p.J), static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
FwdArgs<T> fwd_args(const void* a, const void* b, const void* c, const void* d, const void* t,
                    const void* dt, const void* y, const void* s2, const void* n_valid,
                    void* out, void* state, int B, int J, int N) {
  FwdArgs<T> p{};
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.c = static_cast<const T*>(c);
  p.d = static_cast<const T*>(d);
  p.t = static_cast<const T*>(t);
  p.dt = static_cast<const T*>(dt);
  p.y = static_cast<const T*>(y);
  p.s2 = static_cast<const T*>(s2);
  p.n_valid = static_cast<const int*>(n_valid);
  p.out = static_cast<T*>(out);
  p.state = static_cast<T*>(state);
  p.B = B;
  p.J = J;
  p.N = N;
  p.kc = 1;
  return p;
}

template <typename T>
void set_residuals(FwdArgs<T>& p, void* W0t, void* W1t, void* P0t, void* P1t, void* Dt,
                   void* ZPt, void* Tcp, int kc) {
  p.W0t = static_cast<T*>(W0t);
  p.W1t = static_cast<T*>(W1t);
  p.P0t = static_cast<T*>(P0t);
  p.P1t = static_cast<T*>(P1t);
  p.Dt = static_cast<T*>(Dt);
  p.ZPt = static_cast<T*>(ZPt);
  p.Tcp = static_cast<T*>(Tcp);
  p.kc = kc;
}

template <typename T, bool PerLaneT, bool Carry = false>
int bwd_entry(const void* a, const void* b, const void* c, const void* d, const void* t,
              const void* dt, const void* g, const void* n_valid, const void* W0t,
              const void* W1t, const void* P0t, const void* P1t, const void* Dt,
              const void* ZPt, const void* Tcp, void* abar, void* bbar, void* cbar,
              void* dbar, void* ybar, void* s2bar, void* tb, void* dtb, void* carry,
              void* chunk, int B, int J, int N, int kc, int ks, int cpt, void* stream,
              const void* ain = nullptr, void* aout = nullptr) {
  BwdArgs<T> p{};
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.c = static_cast<const T*>(c);
  p.d = static_cast<const T*>(d);
  p.t = static_cast<const T*>(t);
  p.dt = static_cast<const T*>(dt);
  p.g = static_cast<const T*>(g);
  p.n_valid = static_cast<const int*>(n_valid);
  p.W0t = static_cast<const T*>(W0t);
  p.W1t = static_cast<const T*>(W1t);
  p.P0t = static_cast<const T*>(P0t);
  p.P1t = static_cast<const T*>(P1t);
  p.Dt = static_cast<const T*>(Dt);
  p.ZPt = static_cast<const T*>(ZPt);
  p.Tcp = static_cast<const T*>(Tcp);
  p.abar = static_cast<T*>(abar);
  p.bbar = static_cast<T*>(bbar);
  p.cbar = static_cast<T*>(cbar);
  p.dbar = static_cast<T*>(dbar);
  p.ybar = static_cast<T*>(ybar);
  p.s2bar = static_cast<T*>(s2bar);
  p.tb = static_cast<T*>(tb);
  p.dtb = static_cast<T*>(dtb);
  p.carry = static_cast<T*>(carry);
  p.chunk = static_cast<T*>(chunk);
  p.ain = static_cast<const T*>(ain);
  p.aout = static_cast<T*>(aout);
  p.B = B;
  p.J = J;
  p.N = N;
  p.kc = kc;
  p.ks = ks;
  return launch_bwd<T, PerLaneT, Carry>(p, cpt, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

#define PIORAN_WIDE_FWD(NAME, T)                                                          \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, void* out, void* state, int B, \
           int J, int N, int cpt, void* stream) {                                        \
    const FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, nullptr, out, state, B, J, N); \
    return launch_fwd<T, kShared, false>(p, cpt, static_cast<cudaStream_t>(stream));      \
  }

#define PIORAN_WIDE_FWD_MULTI(NAME, T)                                                    \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, const void* n_valid, void* out, \
           void* state, int B, int J, int N, int cpt, void* stream) {                    \
    const FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, n_valid, out, state, B, J, N); \
    return launch_fwd<T, kPerLane, false>(p, cpt, static_cast<cudaStream_t>(stream));     \
  }

#define PIORAN_WIDE_TABLES(NAME, T)                                                       \
  int NAME(const void* U, const void* V, const void* phi, const void* y, const void* s2, \
           const void* suma, void* out, void* state, int B, int J, int N, int cpt,       \
           void* stream) {                                                               \
    FwdArgs<T> p = fwd_args<T>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, y,  \
                               s2, nullptr, out, state, B, J, N);                        \
    p.U = static_cast<const T*>(U);                                                       \
    p.V = static_cast<const T*>(V);                                                       \
    p.phi = static_cast<const T*>(phi);                                                   \
    p.suma = static_cast<const T*>(suma);                                                 \
    return launch_fwd<T, kTables, false>(p, cpt, static_cast<cudaStream_t>(stream));      \
  }

#define PIORAN_WIDE_FWD_AUG(NAME, T)                                                      \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, void* out, void* W0t,          \
           void* W1t, void* P0t, void* P1t, void* Dt, void* ZPt, void* Tcp, void* state, \
           int B, int J, int N, int kc, int cpt, void* stream) {                         \
    FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, nullptr, out, state, B, J, N);  \
    set_residuals<T>(p, W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, kc);                            \
    return launch_fwd<T, kShared, true>(p, cpt, static_cast<cudaStream_t>(stream));       \
  }

#define PIORAN_WIDE_FWD_AUG_MULTI(NAME, T)                                                \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, const void* n_valid, void* out, \
           void* W0t, void* W1t, void* P0t, void* P1t, void* Dt, void* ZPt, void* Tcp,   \
           void* state, int B, int J, int N, int kc, int cpt, void* stream) {            \
    FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, n_valid, out, state, B, J, N);  \
    set_residuals<T>(p, W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, kc);                            \
    return launch_fwd<T, kPerLane, true>(p, cpt, static_cast<cudaStream_t>(stream));      \
  }

#define PIORAN_WIDE_BWD(NAME, T)                                                          \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* g, const void* W0t, const void* W1t,              \
           const void* P0t, const void* P1t, const void* Dt, const void* ZPt,            \
           const void* Tcp, void* abar, void* bbar, void* cbar, void* dbar, void* ybar,  \
           void* s2bar, void* tb, void* dtb, void* carry, void* chunk, int B, int J,     \
           int N, int kc, int ks, int cpt, void* stream) {                               \
    return bwd_entry<T, false>(a, b, c, d, t, dt, g, nullptr, W0t, W1t, P0t, P1t, Dt,     \
                               ZPt, Tcp, abar, bbar, cbar, dbar, ybar, s2bar, tb, dtb,   \
                               carry, chunk, B, J, N, kc, ks, cpt, stream);              \
  }

#define PIORAN_WIDE_BWD_MULTI(NAME, T)                                                    \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* g, const void* n_valid, const void* W0t,          \
           const void* W1t, const void* P0t, const void* P1t, const void* Dt,            \
           const void* ZPt, const void* Tcp, void* abar, void* bbar, void* cbar,         \
           void* dbar, void* ybar, void* s2bar, void* tb, void* dtb, void* carry,        \
           void* chunk, int B, int J, int N, int kc, int ks, int cpt, void* stream) {    \
    return bwd_entry<T, true>(a, b, c, d, t, dt, g, n_valid, W0t, W1t, P0t, P1t, Dt, ZPt, \
                              Tcp, abar, bbar, cbar, dbar, ybar, s2bar, tb, dtb, carry,  \
                              chunk, B, J, N, kc, ks, cpt, stream);                      \
  }

#define PIORAN_WIDE_FWD_CARRY(NAME, T)                                                    \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, const void* cin, void* cout,   \
           void* parts, void* state, int B, int J, int N, int cpt, void* stream) {       \
    FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, nullptr, nullptr, state, B, J, N); \
    p.cin = static_cast<const T*>(cin);                                                   \
    p.cout = static_cast<T*>(cout);                                                       \
    p.parts = static_cast<T*>(parts);                                                     \
    return launch_fwd<T, kShared, false, true>(p, cpt, static_cast<cudaStream_t>(stream)); \
  }

#define PIORAN_WIDE_FWD_AUG_CARRY(NAME, T)                                                \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, void* W0t, void* W1t,          \
           void* P0t, void* P1t, void* Dt, void* ZPt, void* Tcp, const void* cin,        \
           void* cout, void* parts, void* state, int B, int J, int N, int kc, int cpt,   \
           void* stream) {                                                               \
    FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, nullptr, nullptr, state, B, J, N); \
    set_residuals<T>(p, W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, kc);                            \
    p.cin = static_cast<const T*>(cin);                                                   \
    p.cout = static_cast<T*>(cout);                                                       \
    p.parts = static_cast<T*>(parts);                                                     \
    return launch_fwd<T, kShared, true, true>(p, cpt, static_cast<cudaStream_t>(stream)); \
  }

#define PIORAN_WIDE_BWD_CARRY(NAME, T)                                                    \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* g, const void* W0t, const void* W1t,              \
           const void* P0t, const void* P1t, const void* Dt, const void* ZPt,            \
           const void* Tcp, void* abar, void* bbar, void* cbar, void* dbar, void* ybar,  \
           void* s2bar, void* tb, void* dtb, const void* ain, void* aout, void* carry,   \
           void* chunk, int B, int J, int N, int kc, int ks, int cpt, void* stream) {    \
    return bwd_entry<T, false, true>(a, b, c, d, t, dt, g, nullptr, W0t, W1t, P0t, P1t,   \
                                     Dt, ZPt, Tcp, abar, bbar, cbar, dbar, ybar, s2bar,  \
                                     tb, dtb, carry, chunk, B, J, N, kc, ks, cpt, stream, \
                                     ain, aout);                                         \
  }

PIORAN_WIDE_FWD(celerite_wide_fwd_f32, float)
PIORAN_WIDE_FWD(celerite_wide_fwd_f64, double)
PIORAN_WIDE_FWD_MULTI(celerite_wide_fwd_multi_f32, float)
PIORAN_WIDE_FWD_MULTI(celerite_wide_fwd_multi_f64, double)
PIORAN_WIDE_TABLES(celerite_wide_tables_f32, float)
PIORAN_WIDE_TABLES(celerite_wide_tables_f64, double)
PIORAN_WIDE_FWD_AUG(celerite_wide_fwd_aug_f32, float)
PIORAN_WIDE_FWD_AUG(celerite_wide_fwd_aug_f64, double)
PIORAN_WIDE_FWD_AUG_MULTI(celerite_wide_fwd_aug_multi_f32, float)
PIORAN_WIDE_FWD_AUG_MULTI(celerite_wide_fwd_aug_multi_f64, double)
PIORAN_WIDE_BWD(celerite_wide_bwd_f32, float)
PIORAN_WIDE_BWD(celerite_wide_bwd_f64, double)
PIORAN_WIDE_BWD_MULTI(celerite_wide_bwd_multi_f32, float)
PIORAN_WIDE_BWD_MULTI(celerite_wide_bwd_multi_f64, double)
PIORAN_WIDE_FWD_CARRY(celerite_wide_fwd_carry_f32, float)
PIORAN_WIDE_FWD_CARRY(celerite_wide_fwd_carry_f64, double)
PIORAN_WIDE_FWD_AUG_CARRY(celerite_wide_fwd_aug_carry_f32, float)
PIORAN_WIDE_FWD_AUG_CARRY(celerite_wide_fwd_aug_carry_f64, double)
PIORAN_WIDE_BWD_CARRY(celerite_wide_bwd_carry_f32, float)
PIORAN_WIDE_BWD_CARRY(celerite_wide_bwd_carry_f64, double)

const char* celerite_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
