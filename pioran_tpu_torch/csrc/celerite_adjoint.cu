// The celerite log-likelihood's adjoint pair for Hopper (sm_90a):
// K3, the augmented forward, and K4, the reverse sweep.
//
// K3 replaces the TPU kernel `_fwd_aug_kernel` (launched by `_fwd_aug_call`
// / `fwd_aug_pallas`) and K4 the TPU kernel `_bwd_kernel` (launched by
// `_bwd_call` / `bwd_pallas`), both in pioran_tpu/ops/pallas_celerite_vjp.py,
// for a time grid shared by the chains. Per chain, with T made explicit
// (J x J blocks e, h in {0, 1}; S10 = S01^T):
//
//   T^{eh}_m = S^{eh}_{m-1} + D_{m-1} W^e_{m-1} (W^h_{m-1})^T
//   S^{eh}_m = (ec_m ec_m^T) o T^{eh}_m
//   q^e_m    = sum_h S^{eh}_m U^h_m
//   D_m      = sum(a) + s2_m - sum_e U^e_m . q^e_m
//   W^e_m    = (V^e_m - q^e_m) / D_m
//   pre^e_m  = f^e_{m-1} + W^e_{m-1} zp_{m-1};  f^e_m = ec_m o pre^e_m
//   zp_m     = y_m - sum_e U^e_m . f^e_m
//   ll       = -1/2 (sum log D_m + sum zp_m^2 / D_m + N log 2 pi)
//
// K3 is K1 (celerite_fwd.cu) plus stores: per step W0, W1, pre0, pre1
// (chain-major (B, N, J) tables, lane j writing entry j, so a warp's stores
// are contiguous), D and zp ((B, N)), and every kc steps a checkpoint of
// T00, T01, T11 ((B, N/kc, 3, J, J), row-major blocks).
//
// K4 walks the kc-step chunks in reverse. Phase 1 recomputes T for the
// chunk's steps from its checkpoint into a per-chain scratch buffer that
// the wrapper allocates ((B, kc, 4, J, J), about 26 MB for 512 chains at
// J = 20, kc = 8 in float32, so it stays in the 50 MB L2). Phase 2 applies
// the exact reverse of every forward statement, step by step. The
// cotangents that refer to step m-1 are deferred, as in the TPU kernel: a
// carry Mbar (cotangent of T_{m+1}) and cpre (cotangent of pre_{m+1}),
// both consumed at step m. The first step is inert (D_{-1} = 0,
// W_{-1} = 0, dt_0 = 0), and padded rows j >= J carry exact zeros.
//
// What bounds them on this card: as for K1, the strict sequential
// dependence over N. A step is O(J^2) work on a 2J x 2J state with three
// warp reductions, and the next step needs its result. K3 writes (4J + 2)
// values a step and 3 J^2 every kc steps; K4 reads them back and streams
// the recomputed T blocks through the L2-resident scratch. The design
// keeps the state in registers, one warp per chain, lane i owning row i:
//
// - K4 needs both M W and M^T W for the three cotangent blocks, which are
//   not symmetric. It carries the symmetric parts P00 = M00 + M00^T and
//   P11 = M11 + M11^T, and M01 together with M10 = M01^T. Every quantity
//   the reverse sweep reads of M00 and M11 depends only on their symmetric
//   parts, because T00 and T11 are symmetric; so K4 needs no column
//   reduction, and each lane holds 4 J values of carry, as K1 does of S.
// - The T rows a lane needs at a step (rows of T00, T01, T10, T11) live in
//   the scratch, laid out [j][i] so a warp's 32 lanes touch neighbouring
//   addresses. A lane only reads what it wrote itself: no barrier.
// - Column values (ec_j, W_j, U_j, qbar_j) are broadcast with __shfl_sync,
//   the scalar reductions are warp butterflies.
//
// The deviation from the TPU kernel's arithmetic: S00^T q and S11^T q are
// taken as S00 q and S11 q (T00 and T11 are symmetric up to the rounding
// of their outer products), and A^T ec likewise. The difference is of the
// order of the rounding; chip_smoke.py holds K4 against its plain version,
// which follows the TPU kernel statement by statement.
//
// A chain whose cotangent g is 0 (the wrapper zeroes it where ll = -inf)
// writes exact zeros and does no work, so a non-positive-definite chain,
// whose tables may hold inf or NaN, yields a zero gradient.
//
// Numerics as in K1: Kahan sums with __fadd_rn/__fsub_rn (__dadd_rn/
// __dsub_rn), no --use_fast_math, and CUDA's expf/exp for exp(-c dt) in
// place of the TPU's exp_neg.
//
// C interface (bound with ctypes): celerite_fwd_aug_{f32,f64} and
// celerite_bwd_{f32,f64} launch on the given stream, never synchronise,
// and return cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kLog2Pi = 1.8378770664093453;

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ void warp_sum2(T& u, T& v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    u += __shfl_xor_sync(kFull, u, off);
    v += __shfl_xor_sync(kFull, v, off);
  }
}

// spacing of step n: 0 for the inert first step, else dt[n-1] (host f64
// spacings cast to T) or t[n] - t[n-1]
template <typename T>
__device__ __forceinline__ T step_dt(const T* t, const T* dt, int n) {
  if (n == 0) return T(0);
  return dt ? dt[n - 1] : t[n] - t[n - 1];
}

// ---------------------------------------------------------------------------
// K3: augmented forward
// ---------------------------------------------------------------------------

// JP: compile-time row capacity (>= J, <= 32); columns j >= J are zero.
template <typename T, int JP>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fwd_aug_kernel(const T* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ c, const T* __restrict__ d,
               const T* __restrict__ t, const T* __restrict__ dt,
               const T* __restrict__ y, const T* __restrict__ s2,
               T* __restrict__ out, T* __restrict__ W0t, T* __restrict__ W1t,
               T* __restrict__ P0t, T* __restrict__ P1t, T* __restrict__ Dt,
               T* __restrict__ ZPt, T* __restrict__ Tcp,
               int B, int J, int N, int kc) {
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chain >= B) return;  // the ragged batch edge: whole warps leave

  const bool row = lane < J;
  const long long cj = static_cast<long long>(chain) * J + lane;
  const T ai = row ? a[cj] : T(0);
  const T bi = row ? b[cj] : T(0);
  const T ci = row ? c[cj] : T(0);
  const T di = row ? d[cj] : T(0);
  const T suma = warp_sum(ai);

  T S00[JP], S01[JP], S10[JP], S11[JP];
#pragma unroll
  for (int j = 0; j < JP; ++j) S00[j] = S01[j] = S10[j] = S11[j] = T(0);
  T f0 = T(0), f1 = T(0), W0 = T(0), W1 = T(0);  // this lane's entries
  T Dp = T(0), zpp = T(0);                        // previous D and zp
  T logdet = T(0), clog = T(0), quad = T(0), cquad = T(0);
  T minD = T(INFINITY);

  const long long cN = static_cast<long long>(chain) * N;
  const long long JJ = static_cast<long long>(J) * J;
  const int nck = (N + kc - 1) / kc;

  for (int base = 0; base < N; base += 32) {
    const int nk = min(32, N - base);
    T y_k = T(0), s_k = T(1), t_k = T(0), dt_k = T(0);
    if (lane < nk) {
      const int n = base + lane;
      y_k = y[cN + n];
      s_k = s2[cN + n];
      t_k = t[n];
      dt_k = step_dt(t, dt, n);
    }
    T D_k = T(0), zp_k = T(0);  // D and zp of step base + lane, stored after the block
    for (int k = 0; k < nk; ++k) {
      const int n = base + k;
      const T yn = __shfl_sync(kFull, y_k, k);
      const T sn = __shfl_sync(kFull, s_k, k);
      const T tn = __shfl_sync(kFull, t_k, k);
      const T dtn = __shfl_sync(kFull, dt_k, k);

      T si, co;
      Ops<T>::sincos_(di * tn, &si, &co);
      const T V0 = row ? co : T(0);
      const T V1 = row ? si : T(0);
      const T U0 = ai * co + bi * si;  // zero on lanes >= J (a = b = 0)
      const T U1 = ai * si - bi * co;
      const T ec = row ? Ops<T>::exp_(-(ci * dtn)) : T(0);

      // row `lane` of this step's checkpoint blocks, when it is one
      T* tc = (row && n % kc == 0)
                  ? Tcp + (static_cast<long long>(chain) * nck + n / kc) * 3 * JJ + lane * J
                  : nullptr;
      const T Wd0 = W0 * Dp, Wd1 = W1 * Dp;
      T su00 = T(0), su01 = T(0), su10 = T(0), su11 = T(0);
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const T ecj = __shfl_sync(kFull, ec, j);
        const T W0j = __shfl_sync(kFull, W0, j);
        const T W1j = __shfl_sync(kFull, W1, j);
        const T U0j = __shfl_sync(kFull, U0, j);
        const T U1j = __shfl_sync(kFull, U1, j);
        const T ee = ec * ecj;
        // T10[i][j] = T01[j][i], formed exactly as lane j forms it
        const T Wd0j = W0j * Dp;
        const T t00 = S00[j] + Wd0 * W0j;
        const T t01 = S01[j] + Wd0 * W1j;
        const T t10 = S10[j] + Wd0j * W1;
        const T t11 = S11[j] + Wd1 * W1j;
        if (tc != nullptr && j < J) {
          tc[j] = t00;
          tc[JJ + j] = t01;
          tc[2 * JJ + j] = t11;
        }
        S00[j] = ee * t00;
        S01[j] = ee * t01;
        S10[j] = ee * t10;
        S11[j] = ee * t11;
        su00 += S00[j] * U0j;
        su01 += S01[j] * U1j;
        su10 += S10[j] * U0j;
        su11 += S11[j] * U1j;
      }
      const T SU0 = su00 + su01;
      const T SU1 = su10 + su11;

      const T pre0 = f0 + W0 * zpp;
      const T pre1 = f1 + W1 * zpp;
      const T f0n = ec * pre0;
      const T f1n = ec * pre1;
      T uSu = U0 * SU0 + U1 * SU1;
      T uf = U0 * f0n + U1 * f1n;
      warp_sum2(uSu, uf);
      const T Dn = suma + sn - uSu;
      const T zpn = yn - uf;

      W0 = row ? (V0 - SU0) / Dn : T(0);
      W1 = row ? (V1 - SU1) / Dn : T(0);
      if (row) {
        const long long o = (cN + n) * J + lane;
        W0t[o] = W0;
        W1t[o] = W1;
        P0t[o] = pre0;
        P1t[o] = pre1;
      }
      if (lane == k) {
        D_k = Dn;
        zp_k = zpn;
      }
      f0 = f0n;
      f1 = f1n;
      Dp = Dn;
      zpp = zpn;
      kahan_add(logdet, clog, Ops<T>::log_(Ops<T>::abs_(Dn)));
      kahan_add(quad, cquad, zpn * zpn / Dn);
      minD = Dn < minD ? Dn : minD;
    }
    if (lane < nk) {
      Dt[cN + base + lane] = D_k;
      ZPt[cN + base + lane] = zp_k;
    }
  }

  if (lane == 0) {
    const T ll = T(-0.5) * (logdet + quad + static_cast<T>(N) * T(kLog2Pi));
    const bool ok = (minD > T(0)) && isfinite(ll);
    out[chain] = ok ? ll : T(-INFINITY);
  }
}

// ---------------------------------------------------------------------------
// K4: reverse sweep
// ---------------------------------------------------------------------------

template <typename T, int JP>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
           const T* __restrict__ c, const T* __restrict__ d,
           const T* __restrict__ t, const T* __restrict__ dt,
           const T* __restrict__ g,
           const T* __restrict__ W0t, const T* __restrict__ W1t,
           const T* __restrict__ P0t, const T* __restrict__ P1t,
           const T* __restrict__ Dt, const T* __restrict__ ZPt,
           const T* __restrict__ Tcp, T* scratch,
           T* __restrict__ abar, T* __restrict__ bbar, T* __restrict__ cbar,
           T* __restrict__ dbar, T* __restrict__ ybar, T* __restrict__ s2bar,
           T* __restrict__ tb, T* __restrict__ dtb,
           int B, int J, int N, int kc) {
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chain >= B) return;

  const bool row = lane < J;
  const long long cj = static_cast<long long>(chain) * J + lane;
  const long long cN = static_cast<long long>(chain) * N;
  const T gl = g[chain];
  if (gl == T(0)) {  // no seed (a -inf chain): exact zeros, whatever the tables hold
    if (row) abar[cj] = bbar[cj] = cbar[cj] = dbar[cj] = T(0);
    for (int n = lane; n < N; n += 32) {
      ybar[cN + n] = s2bar[cN + n] = tb[cN + n] = dtb[cN + n] = T(0);
    }
    return;
  }
  const T ai = row ? a[cj] : T(0);
  const T bi = row ? b[cj] : T(0);
  const T ci = row ? c[cj] : T(0);
  const T di = row ? d[cj] : T(0);

  // deferred cotangent of T_{m+1}, row `lane`: symmetric parts of the
  // diagonal blocks, both off-diagonal blocks
  T P00[JP], M01[JP], M10[JP], P11[JP];
#pragma unroll
  for (int j = 0; j < JP; ++j) P00[j] = M01[j] = M10[j] = P11[j] = T(0);
  T cp0 = T(0), cp1 = T(0);  // deferred cotangent of pre_{m+1}
  T ab = T(0), bb = T(0), cb = T(0), db = T(0), sumabar = T(0);

  const long long JJ = static_cast<long long>(J) * J;
  const int nck = (N + kc - 1) / kc;
  // this chain's scratch: kc slots of 4 blocks (T00, T01, T10, T11), each
  // stored [j][i] = T[i][j]; lane i touches only column i of each
  T* scr = scratch + static_cast<long long>(chain) * kc * 4 * JJ + lane;

  for (int chunk = nck - 1; chunk >= 0; --chunk) {
    const int base = chunk * kc;
    const int nsteps = min(kc, N - base);

    // ---- phase 1: T_m, m in [base, base + nsteps), from the checkpoint
    const T* cp = Tcp + (static_cast<long long>(chain) * nck + chunk) * 3 * JJ;
    for (int k = 0; k < nsteps; ++k) {
      T* sk = scr + k * 4 * JJ;
      if (k == 0) {
        if (row) {
          for (int j = 0; j < J; ++j) {
            sk[j * J] = cp[lane * J + j];
            sk[JJ + j * J] = cp[JJ + lane * J + j];
            sk[2 * JJ + j * J] = cp[JJ + j * J + lane];  // T10 = T01^T
            sk[3 * JJ + j * J] = cp[2 * JJ + lane * J + j];
          }
        }
        continue;
      }
      const int m = base + k - 1;
      const T ec = row ? Ops<T>::exp_(-(ci * step_dt(t, dt, m))) : T(0);
      const long long o = (cN + m) * J + lane;
      const T W0 = row ? W0t[o] : T(0);
      const T W1 = row ? W1t[o] : T(0);
      const T Dm = Dt[cN + m];
      const T Wd0 = W0 * Dm, Wd1 = W1 * Dm;
      const T* sp = sk - 4 * JJ;
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const T ecj = __shfl_sync(kFull, ec, j);
        const T W0j = __shfl_sync(kFull, W0, j);
        const T W1j = __shfl_sync(kFull, W1, j);
        if (row && j < J) {
          const T ee = ec * ecj;
          const T Wd0j = W0j * Dm;
          const int q = j * J;
          sk[q] = ee * sp[q] + Wd0 * W0j;
          sk[JJ + q] = ee * sp[JJ + q] + Wd0 * W1j;
          sk[2 * JJ + q] = ee * sp[2 * JJ + q] + Wd0j * W1;
          sk[3 * JJ + q] = ee * sp[3 * JJ + q] + Wd1 * W1j;
        }
      }
    }

    // ---- phase 2: the reverse sweep over the chunk's steps
    for (int k = nsteps - 1; k >= 0; --k) {
      const int m = base + k;
      const T tn = t[m];
      const T dtn = step_dt(t, dt, m);
      T si, co;
      Ops<T>::sincos_(di * tn, &si, &co);
      const T V0 = row ? co : T(0);
      const T V1 = row ? si : T(0);
      const T U0 = ai * co + bi * si;
      const T U1 = ai * si - bi * co;
      const T ec = row ? Ops<T>::exp_(-(ci * dtn)) : T(0);
      const long long o = (cN + m) * J + lane;
      const T W0 = row ? W0t[o] : T(0);
      const T W1 = row ? W1t[o] : T(0);
      const T pre0 = row ? P0t[o] : T(0);
      const T pre1 = row ? P1t[o] : T(0);
      const T Dm = Dt[cN + m];
      const T zpm = ZPt[cN + m];
      const T q0 = V0 - W0 * Dm;
      const T q1 = V1 - W1 * Dm;

      // consume Mbar: T_{m+1} = S_m + D_m W_m W_m^T
      T pw0 = T(0), m01w1 = T(0), m10w0 = T(0), pw1 = T(0);
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const T W0j = __shfl_sync(kFull, W0, j);
        const T W1j = __shfl_sync(kFull, W1, j);
        pw0 += P00[j] * W0j;
        m01w1 += M01[j] * W1j;
        m10w0 += M10[j] * W0j;
        pw1 += P11[j] * W1j;
      }
      T Dbar = W0 * (T(0.5) * pw0 + m01w1) + T(0.5) * W1 * pw1;
      T W0bar = (pw0 + m01w1) * Dm + cp0 * zpm;
      T W1bar = (pw1 + m10w0) * Dm + cp1 * zpm;
      // consume cpre: pre_{m+1} = f_m + W_m zp_m
      T f0bar = cp0, f1bar = cp1;
      T zpbar = cp0 * W0 + cp1 * W1;
      warp_sum2(Dbar, zpbar);

      // loss seeds, scaled by the chain's cotangent
      Dbar -= T(0.5) * gl * (T(1) / Dm - zpm * zpm / (Dm * Dm));
      zpbar -= gl * zpm / Dm;

      // zp = y - U0.f0 - U1.f1, f = ec o pre
      T U0bar = -zpbar * (ec * pre0);
      T U1bar = -zpbar * (ec * pre1);
      f0bar -= zpbar * U0;
      f1bar -= zpbar * U1;
      T ecbar = f0bar * pre0 + f1bar * pre1;
      cp0 = ec * f0bar;
      cp1 = ec * f1bar;

      // W = (V - q) / D
      T cobar = W0bar / Dm;
      T sibar = W1bar / Dm;
      T q0bar = -W0bar / Dm;
      T q1bar = -W1bar / Dm;
      Dbar -= warp_sum(W0bar * W0 + W1bar * W1) / Dm;

      // D = suma + s2 - U0.q0 - U1.q1
      sumabar += Dbar;
      U0bar -= Dbar * q0;
      U1bar -= Dbar * q1;
      q0bar -= Dbar * U0;
      q1bar -= Dbar * U1;

      // q = S U with S = ee o T: U and ec cotangents, and the new Mbar
      const T* sk = scr + k * 4 * JJ;
      T u0acc = T(0), u1acc = T(0), ecacc = T(0);
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const T ecj = __shfl_sync(kFull, ec, j);
        const T U0j = __shfl_sync(kFull, U0, j);
        const T U1j = __shfl_sync(kFull, U1, j);
        const T q0j = __shfl_sync(kFull, q0bar, j);
        const T q1j = __shfl_sync(kFull, q1bar, j);
        T t00 = T(0), t01 = T(0), t10 = T(0), t11 = T(0);
        if (row && j < J) {
          const int q = j * J;
          t00 = sk[q];
          t01 = sk[JJ + q];
          t10 = sk[2 * JJ + q];
          t11 = sk[3 * JJ + q];
        }
        const T ee = ec * ecj;
        u0acc += ee * (t00 * q0j + t01 * q1j);
        u1acc += ee * (t10 * q0j + t11 * q1j);
        const T Q00 = P00[j] + q0bar * U0j + U0 * q0j;
        const T Q01 = M01[j] + q0bar * U1j + U0 * q1j;
        const T Q10 = M10[j] + U1 * q0j + q1bar * U0j;
        const T Q11 = P11[j] + q1bar * U1j + U1 * q1j;
        ecacc += (Q00 * t00 + Q01 * t01 + Q10 * t10 + Q11 * t11) * ecj;
        P00[j] = ee * Q00;
        M01[j] = ee * Q01;
        M10[j] = ee * Q10;
        P11[j] = ee * Q11;
      }
      U0bar += u0acc;
      U1bar += u1acc;
      ecbar += ecacc;

      // coefficient chain rule: U0 = a co + b si, U1 = a si - b co,
      // V = (co, si), co = cos(d t), si = sin(d t), ec = exp(-c dt)
      ab += U0bar * co + U1bar * si;
      bb += U0bar * si - U1bar * co;
      cobar += U0bar * ai - U1bar * bi;
      sibar += U0bar * bi + U1bar * ai;
      const T dchain = -cobar * si + sibar * co;
      db += tn * dchain;
      cb -= dtn * ecbar * ec;
      T tsum = di * dchain;
      T dtsum = -(ci * ecbar * ec);
      warp_sum2(tsum, dtsum);
      if (lane == 0) {
        ybar[cN + m] = zpbar;
        s2bar[cN + m] = Dbar;
        tb[cN + m] = tsum;
        dtb[cN + m] = dtsum;
      }
    }
  }
  if (row) {
    abar[cj] = ab + sumabar;  // sum(a) feeds D at every step
    bbar[cj] = bb;
    cbar[cj] = cb;
    dbar[cj] = db;
  }
}

template <typename T>
int launch_fwd_aug(const T* a, const T* b, const T* c, const T* d, const T* t,
                   const T* dt, const T* y, const T* s2, T* out, T* W0t, T* W1t,
                   T* P0t, T* P1t, T* Dt, T* ZPt, T* Tcp, int B, int J, int N,
                   int kc, cudaStream_t stream) {
  if (J < 1 || J > 32 || kc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
#define PIORAN_FWD_AUG(JP)                                                     \
  fwd_aug_kernel<T, JP><<<grid, block, 0, stream>>>(                          \
      a, b, c, d, t, dt, y, s2, out, W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, B, J, N, kc)
  if (J <= 8) {
    PIORAN_FWD_AUG(8);
  } else if (J <= 16) {
    PIORAN_FWD_AUG(16);
  } else if (J <= 24) {
    PIORAN_FWD_AUG(24);
  } else {
    PIORAN_FWD_AUG(32);
  }
#undef PIORAN_FWD_AUG
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* a, const T* b, const T* c, const T* d, const T* t,
               const T* dt, const T* g, const T* W0t, const T* W1t, const T* P0t,
               const T* P1t, const T* Dt, const T* ZPt, const T* Tcp, T* scratch,
               T* abar, T* bbar, T* cbar, T* dbar, T* ybar, T* s2bar, T* tb,
               T* dtb, int B, int J, int N, int kc, cudaStream_t stream) {
  if (J < 1 || J > 32 || kc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
#define PIORAN_BWD(JP)                                                         \
  bwd_kernel<T, JP><<<grid, block, 0, stream>>>(                              \
      a, b, c, d, t, dt, g, W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, scratch, abar,   \
      bbar, cbar, dbar, ybar, s2bar, tb, dtb, B, J, N, kc)
  if (J <= 8) {
    PIORAN_BWD(8);
  } else if (J <= 16) {
    PIORAN_BWD(16);
  } else if (J <= 24) {
    PIORAN_BWD(24);
  } else {
    PIORAN_BWD(32);
  }
#undef PIORAN_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define PIORAN_FWD_AUG_ENTRY(NAME, T)                                            \
  int NAME(const void* a, const void* b, const void* c, const void* d,          \
           const void* t, const void* dt, const void* y, const void* s2,        \
           void* out, void* W0t, void* W1t, void* P0t, void* P1t, void* Dt,     \
           void* ZPt, void* Tcp, int B, int J, int N, int kc, void* stream) {   \
    return launch_fwd_aug<T>(                                                    \
        static_cast<const T*>(a), static_cast<const T*>(b),                      \
        static_cast<const T*>(c), static_cast<const T*>(d),                      \
        static_cast<const T*>(t), static_cast<const T*>(dt),                     \
        static_cast<const T*>(y), static_cast<const T*>(s2),                     \
        static_cast<T*>(out), static_cast<T*>(W0t), static_cast<T*>(W1t),        \
        static_cast<T*>(P0t), static_cast<T*>(P1t), static_cast<T*>(Dt),         \
        static_cast<T*>(ZPt), static_cast<T*>(Tcp), B, J, N, kc,                 \
        static_cast<cudaStream_t>(stream));                                      \
  }

PIORAN_FWD_AUG_ENTRY(celerite_fwd_aug_f32, float)
PIORAN_FWD_AUG_ENTRY(celerite_fwd_aug_f64, double)

#define PIORAN_BWD_ENTRY(NAME, T)                                                \
  int NAME(const void* a, const void* b, const void* c, const void* d,          \
           const void* t, const void* dt, const void* g, const void* W0t,       \
           const void* W1t, const void* P0t, const void* P1t, const void* Dt,   \
           const void* ZPt, const void* Tcp, void* scratch, void* abar,         \
           void* bbar, void* cbar, void* dbar, void* ybar, void* s2bar,         \
           void* tb, void* dtb, int B, int J, int N, int kc, void* stream) {    \
    return launch_bwd<T>(                                                        \
        static_cast<const T*>(a), static_cast<const T*>(b),                      \
        static_cast<const T*>(c), static_cast<const T*>(d),                      \
        static_cast<const T*>(t), static_cast<const T*>(dt),                     \
        static_cast<const T*>(g), static_cast<const T*>(W0t),                    \
        static_cast<const T*>(W1t), static_cast<const T*>(P0t),                  \
        static_cast<const T*>(P1t), static_cast<const T*>(Dt),                   \
        static_cast<const T*>(ZPt), static_cast<const T*>(Tcp),                  \
        static_cast<T*>(scratch), static_cast<T*>(abar), static_cast<T*>(bbar),  \
        static_cast<T*>(cbar), static_cast<T*>(dbar), static_cast<T*>(ybar),     \
        static_cast<T*>(s2bar), static_cast<T*>(tb), static_cast<T*>(dtb), B, J, \
        N, kc, static_cast<cudaStream_t>(stream));                               \
  }

PIORAN_BWD_ENTRY(celerite_bwd_f32, float)
PIORAN_BWD_ENTRY(celerite_bwd_f64, double)

const char* celerite_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
