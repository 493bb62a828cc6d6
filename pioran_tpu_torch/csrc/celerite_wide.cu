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
// Why a new layout: the warp-per-chain kernels keep row i of each J x J
// block in lane i's registers; two rows a lane would need more than 255
// registers. Here one thread block carries one chain, and thread r owns row
// r of the 2J x 2J state. The state lives in dynamic shared memory where
// it fits the 232,448 bytes a block may use, else in a device-memory
// scratch the wrapper allocates (one pointer either way: the code is the
// same). Every matrix is stored by columns (entry (r, c) at c * ld + r),
// so the threads of a warp touch consecutive words of a column.
//
// - The forward kernels (K1, K2, K0 and K3, one template) keep the whole
//   symmetric S, its S10 block included, R x R: thread r updates row r,
//   T_rc = S_rc + (W_r D) W_c, S_rc = (ec_r ec_c) T_rc, and sums
//   q_r = sum_c S_rc U_c in the same pass. Column values (U, ec, W) are
//   broadcast from per-block rows in shared memory; U . q and U . f are
//   one block reduction a step. K3 also writes W, pre, D and zp each
//   step and every kc steps the T blocks T00, T01, T11 (row-major, the
//   narrow kernels' layout).
// - K4 carries the cotangent of T_{m+1} as the symmetric parts
//   P00 = M00 + M00^T and P11 = M11 + M11^T and both off-diagonal blocks
//   M01 and M10 = M01^T, an R x R matrix G that thread r updates row by
//   row; every quantity the sweep reads of M00 and M11 depends only on
//   their symmetric parts, since T00 and T11 are symmetric (as in
//   csrc/celerite_adjoint.cu). Each chunk of kc steps is swept in
//   sub-chunks of ks <= 8 steps from last to first: the T blocks of the
//   sub-chunk's steps are recomputed from the chunk's checkpoint (the
//   steps before it replayed in place), then the reverse sweep reads
//   T(r, .) by rows: T00 and T01 rows for r < J, the T01 column and the
//   T11 row for r >= J, so the chunk holds three J x J blocks a step
//   (leading dimension J rounded up to odd, so a column read is free of
//   bank conflicts too). G, and the chunk, live in shared memory or in
//   the scratch, as the wrapper chooses.
//
// What bounds them on this card: the N dependent steps of a chain, each
// O(J^2) work and a few block-wide barriers and reductions; bytes are
// negligible (K0's tables aside). This is the simple design: one thread a
// row, no reassociation of the step (so the rounding follows the plain
// loops'), K4's T chunk in the scratch where shared memory is short.
// chip_smoke.py holds each entry against its plain PyTorch version.
//
// Numerics as in the narrow kernels: Kahan updates with __fadd_rn /
// __fsub_rn (__dadd_rn / __dsub_rn), never contracted into FMAs; built
// without --use_fast_math, so sincos, exp, log and the divisions by D are
// IEEE-accurate (CUDA's expf and exp in place of the TPU's exp_neg).
//
// C interface (bound with ctypes): celerite_wide_fwd_{f32,f64} (K1),
// celerite_wide_fwd_multi_{f32,f64} (K2), celerite_wide_tables_{f32,f64}
// (K0), celerite_wide_fwd_aug[_multi]_{f32,f64} (K3),
// celerite_wide_bwd[_multi]_{f32,f64} (K4). The per-lane entries take the
// int32 n_valid after s2 (K2, K3) or g (K4). A null `state` (forward) or
// `carry` / `chunk` (K4) puts that part in shared memory, else it is a
// device scratch of the wrapper's: `state` (B, R, R), `carry` (B, R, R),
// `chunk` (B, ks, 3, J, J | 1). They launch on the given stream, never
// synchronise, allocate nothing, and return cudaGetLastError() (or
// cudaErrorInvalidValue for what they do not take) as an int.

#include <cuda_runtime.h>
#include <math.h>

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
  int B, J, N, kc;
};

// G: kShared (K1, K3), kPerLane (K2, per-lane K3), kTables (K0).
// Aug: K3, the value plus the residual tables; every step runs and the
// per-lane sums are masked past n_valid. Without it the per-lane loop ends
// at n_valid, since nothing after a chain's last live step feeds its value.
template <typename T, int G, bool Aug>
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
  for (long long e = r; e < static_cast<long long>(R) * R; e += blockDim.x) S[e] = T(0);
  if (act) Wrow[r] = T(0);

  T Wr = T(0), f = T(0);   // W_{n-1}, f_{n-1} of row r
  T Dp = T(0), zpp = T(0);  // D_{n-1}, zp_{n-1}
  T logdet = T(0), clog = T(0), quad = T(0), cquad = T(0);
  T minD = T(INFINITY);
  const long long cN = static_cast<long long>(chain) * N;
  const long long JJ = static_cast<long long>(J) * J;
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
        const T dtn = n == 0 ? T(0) : (dt ? dt[n - 1] : tn - t[n - 1]);
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
  int B, J, N, kc, ks;
};

template <typename T, bool PerLaneT>
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
  if (gl == T(0)) {  // no seed (a -inf chain): exact zeros, whatever the tables hold
    if (act && h == 0) p.abar[cj] = p.bbar[cj] = p.cbar[cj] = p.dbar[cj] = T(0);
    for (int n = r; n < N; n += blockDim.x)
      p.ybar[cN + n] = p.s2bar[cN + n] = p.tb[cN + n] = p.dtb[cN + n] = T(0);
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

  for (long long e = r; e < static_cast<long long>(R) * R; e += blockDim.x) G[e] = T(0);
  T cp = T(0);  // deferred cotangent of pre_{m+1}, row r
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
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int G, bool Aug>
int launch_fwd(const FwdArgs<T>& p, cudaStream_t stream) {
  if (p.J < 1 || p.J > kMaxTerms || (G == kPerLane && p.n_valid == nullptr) ||
      (Aug && p.kc < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B <= 0 || p.N <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = fwd_smem_len(p.J, p.state == nullptr) * static_cast<long long>(sizeof(T));
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wide_fwd_kernel<T, G, Aug>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<p.B, threads_of(p.J), static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PerLaneT>
int launch_bwd(const BwdArgs<T>& p, cudaStream_t stream) {
  if (p.J < 1 || p.J > kMaxTerms || p.kc < 1 || p.ks < 1 || p.ks > p.kc || p.ks > kMaxSub ||
      (PerLaneT && p.n_valid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B <= 0 || p.N <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = bwd_smem_len(p.J, p.ks, p.carry == nullptr, p.chunk == nullptr) *
                         static_cast<long long>(sizeof(T));
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wide_bwd_kernel<T, PerLaneT>;
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

template <typename T, bool PerLaneT>
int bwd_entry(const void* a, const void* b, const void* c, const void* d, const void* t,
              const void* dt, const void* g, const void* n_valid, const void* W0t,
              const void* W1t, const void* P0t, const void* P1t, const void* Dt,
              const void* ZPt, const void* Tcp, void* abar, void* bbar, void* cbar,
              void* dbar, void* ybar, void* s2bar, void* tb, void* dtb, void* carry,
              void* chunk, int B, int J, int N, int kc, int ks, void* stream) {
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
  p.B = B;
  p.J = J;
  p.N = N;
  p.kc = kc;
  p.ks = ks;
  return launch_bwd<T, PerLaneT>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

#define PIORAN_WIDE_FWD(NAME, T)                                                          \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, void* out, void* state, int B, \
           int J, int N, void* stream) {                                                 \
    const FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, nullptr, out, state, B, J, N); \
    return launch_fwd<T, kShared, false>(p, static_cast<cudaStream_t>(stream));           \
  }

#define PIORAN_WIDE_FWD_MULTI(NAME, T)                                                    \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, const void* n_valid, void* out, \
           void* state, int B, int J, int N, void* stream) {                             \
    const FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, n_valid, out, state, B, J, N); \
    return launch_fwd<T, kPerLane, false>(p, static_cast<cudaStream_t>(stream));          \
  }

#define PIORAN_WIDE_TABLES(NAME, T)                                                       \
  int NAME(const void* U, const void* V, const void* phi, const void* y, const void* s2, \
           const void* suma, void* out, void* state, int B, int J, int N, void* stream) { \
    FwdArgs<T> p = fwd_args<T>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, y,  \
                               s2, nullptr, out, state, B, J, N);                        \
    p.U = static_cast<const T*>(U);                                                       \
    p.V = static_cast<const T*>(V);                                                       \
    p.phi = static_cast<const T*>(phi);                                                   \
    p.suma = static_cast<const T*>(suma);                                                 \
    return launch_fwd<T, kTables, false>(p, static_cast<cudaStream_t>(stream));           \
  }

#define PIORAN_WIDE_FWD_AUG(NAME, T)                                                      \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, void* out, void* W0t,          \
           void* W1t, void* P0t, void* P1t, void* Dt, void* ZPt, void* Tcp, void* state, \
           int B, int J, int N, int kc, void* stream) {                                  \
    FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, nullptr, out, state, B, J, N);  \
    set_residuals<T>(p, W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, kc);                            \
    return launch_fwd<T, kShared, true>(p, static_cast<cudaStream_t>(stream));            \
  }

#define PIORAN_WIDE_FWD_AUG_MULTI(NAME, T)                                                \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* y, const void* s2, const void* n_valid, void* out, \
           void* W0t, void* W1t, void* P0t, void* P1t, void* Dt, void* ZPt, void* Tcp,   \
           void* state, int B, int J, int N, int kc, void* stream) {                     \
    FwdArgs<T> p = fwd_args<T>(a, b, c, d, t, dt, y, s2, n_valid, out, state, B, J, N);  \
    set_residuals<T>(p, W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, kc);                            \
    return launch_fwd<T, kPerLane, true>(p, static_cast<cudaStream_t>(stream));           \
  }

#define PIORAN_WIDE_BWD(NAME, T)                                                          \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* g, const void* W0t, const void* W1t,              \
           const void* P0t, const void* P1t, const void* Dt, const void* ZPt,            \
           const void* Tcp, void* abar, void* bbar, void* cbar, void* dbar, void* ybar,  \
           void* s2bar, void* tb, void* dtb, void* carry, void* chunk, int B, int J,     \
           int N, int kc, int ks, void* stream) {                                        \
    return bwd_entry<T, false>(a, b, c, d, t, dt, g, nullptr, W0t, W1t, P0t, P1t, Dt,     \
                               ZPt, Tcp, abar, bbar, cbar, dbar, ybar, s2bar, tb, dtb,   \
                               carry, chunk, B, J, N, kc, ks, stream);                   \
  }

#define PIORAN_WIDE_BWD_MULTI(NAME, T)                                                    \
  int NAME(const void* a, const void* b, const void* c, const void* d, const void* t,    \
           const void* dt, const void* g, const void* n_valid, const void* W0t,          \
           const void* W1t, const void* P0t, const void* P1t, const void* Dt,            \
           const void* ZPt, const void* Tcp, void* abar, void* bbar, void* cbar,         \
           void* dbar, void* ybar, void* s2bar, void* tb, void* dtb, void* carry,        \
           void* chunk, int B, int J, int N, int kc, int ks, void* stream) {             \
    return bwd_entry<T, true>(a, b, c, d, t, dt, g, n_valid, W0t, W1t, P0t, P1t, Dt, ZPt, \
                              Tcp, abar, bbar, cbar, dbar, ybar, s2bar, tb, dtb, carry,  \
                              chunk, B, J, N, kc, ks, stream);                           \
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

const char* celerite_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
