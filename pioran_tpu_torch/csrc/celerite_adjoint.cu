// The celerite log-likelihood's adjoint pair for Hopper (sm_90a):
// K3, the augmented forward, and K4, the reverse sweep.
//
// K3 replaces the TPU kernel `_fwd_aug_kernel` (launched by `_fwd_aug_call`
// / `fwd_aug_pallas`) and K4 the TPU kernel `_bwd_kernel` (launched by
// `_bwd_call` / `bwd_pallas`), both in pioran_tpu/ops/pallas_celerite_vjp.py,
// in both of their forms: a time grid shared by the chains, and per-chain
// ragged grids (`per_lane_t=True`, the adjoint of the multi-dataset K2).
// Per chain, with T made explicit (J x J blocks e, h in {0, 1};
// S10 = S01^T):
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
// (chain-major (B, N, J) tables), D and zp ((B, N)), and every kc steps a
// checkpoint of T00, T01, T11 ((B, N/kc, 3, J, J), row-major blocks).
// K4 walks the kc-step chunks in reverse: it recomputes T for the chunk's
// steps from its checkpoint (phase 1), then applies the exact reverse of
// every forward statement, step by step (phase 2). The cotangents that
// refer to step m-1 are deferred, as in the TPU kernel: a carry Mbar
// (cotangent of T_{m+1}) and cpre (cotangent of pre_{m+1}), both consumed
// at step m. The first step is inert (D_{-1} = 0, W_{-1} = 0, dt_0 = 0),
// and padded rows j >= J carry exact zeros.
//
// What bounds them on this card: neither bytes nor operations, but the
// latency of a strictly sequential recursion over N. A step is O(J^2)
// work on a 2J x 2J state with a few warp reductions, and the next step
// needs its result; one warp carries one chain, lane i owning row i of
// each J x J block in registers, and at the ChEES batch (B = 512) that is
// about one warp per SM sub-partition, with nothing to hide latency
// behind. So every instruction a step issues through the memory pipe
// counts: the design keeps the step's data in shared memory and registers
// and moves device memory off the step's critical path.
//
// - K4's recomputed T chunk lives in shared memory (the TPU kernel keeps
//   it in VMEM): three blocks a step, T00, T01 and T11, rows padded to a
//   stride RS with RS / (16 bytes) odd, so that a lane's own row read as
//   16-byte vectors and the transposed read of T10[i][j] = T01[j][i] are
//   both free of bank conflicts. The wrapper chooses the chains a block
//   holds and a sub-chunk length ks <= kc from the 227 KB a block may
//   use; where ks < kc, K4 walks a chunk's sub-chunks from last to first
//   and replays the T recursion from the checkpoint up to each.
// - K4 prefetches with cp.async: while a warp sweeps one sub-chunk, the
//   copies of the next one's residual rows (W0, W1, pre0, pre1, D, zp, t,
//   dt) and, at a chunk's edge, its checkpoint land in a second buffer
//   (4- or 8-byte copies, so any J and alignment work alike). Every
//   per-step value of the reverse sweep then comes from shared memory or
//   registers, and the checkpoint is read as whole rows (coalesced).
// - Column values (ec_j, W_j, U_j, qbar_j) are written once a step to a
//   per-warp row in shared memory and read back as 16-byte broadcasts:
//   four floats (two doubles) a load where __shfl_sync moves one.
// - K4 carries the symmetric parts P00 = M00 + M00^T and P11 = M11 + M11^T
//   of Mbar, and M01 with M10 = M01^T. Every quantity the reverse sweep
//   reads of M00 and M11 depends only on their symmetric parts, because
//   T00 and T11 are symmetric; so each lane holds 4 J values of carry.
// - K3 writes each checkpoint from a shared-memory tile as whole rows,
//   outside the hot column loop (a templated step: the other steps carry
//   no store predicate), and stages W0, W1, pre0, pre1 for 32 steps in
//   shared memory before writing them out as 16-byte stores.
//
// Tensor cores are not used: each step is a per-chain mat-vec or rank-1
// update on a 2J x 2J state that the next step depends on, and no operand
// is shared across chains, so a wgmma tile of 64 rows has nothing to reuse.
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
// Per-lane grids (compile-time flag PerLaneT): t, dt are read from the
// chain's own rows (t + chain N, dt + chain (N - 1)) and a step m counts
// only when m < n_valid[chain] ("live"). K3 masks its Kahan sums and min D
// by live and uses n_valid log 2 pi; K4 seeds the loss only on live steps.
// The padded steps past n_valid still run (dt = 0 and sigma2 = 1 there, so
// D > 0); in K4 their cotangents are exact zeros, because nothing after
// them seeds the carry. K4 writes the t and dt partials per chain either
// way; the wrapper folds them per chain (per-lane) or over the chains
// (shared). With the flag off, live is the constant true and the kernels'
// instruction streams are those of the shared-grid kernels.
//
// Numerics as in K1: Kahan sums with __fadd_rn/__fsub_rn (__dadd_rn/
// __dsub_rn), no --use_fast_math, and CUDA's expf/exp for exp(-c dt) in
// place of the TPU's exp_neg.
//
// Carry entries (compile-time flag Carry; shared grid only): one block of
// a series split along time, as the TPU kernels do with the carry refs of
// their segmented launches (K3 `sin_ref, fwin_ref, accin_ref` in and
// `sout_ref, fwout_ref, accout_ref` out; K4 `mbin_ref, cpin_ref` in and
// `mbout_ref, cpout_ref` out) and as the time-sharded scan
// (pioran_tpu_torch/parallel/seq_scan.py) hands state between ranks.
// dt is then the (N,) spacing of every step, dt[0] the one to the previous
// block's last point (0 for the first block), so the first step is not
// inert. K3 starts from `cin` (B, 3 J^2 + 4 J + 2: S00, S01, S11
// row-major, W and f [cos-type; sin-type], D, zp; zeros start a series),
// so its first checkpoint is T = S_in + D_in W_in W_in^T; it writes the
// state after its last step to `cout` and the block's partials (Kahan sums
// of log|D| and zp^2 / D, min D) to `parts` (B, 3). K4 starts its reverse
// sweep from `ain` (B, 3 J^2 + 2 J: P00 = M00 + M00^T, M01, P11 = M11 +
// M11^T row-major, then cpre), the cotangents of T and pre at the next
// block's first step (zeros for the last block), and writes those at its
// own first step to `aout`; its abar .. dbar are the block's partials, c̄
// with the first step's boundary decay.
//
// C interface (bound with ctypes): celerite_fwd_aug_{f32,f64},
// celerite_bwd_{f32,f64} and their per-lane forms
// celerite_fwd_aug_multi_{f32,f64} and celerite_bwd_multi_{f32,f64} (one
// more argument, the int32 n_valid), and the carry entries
// celerite_fwd_aug_carry_{f32,f64} (cin, cout, parts after Tcp) and
// celerite_bwd_carry_{f32,f64} (ain, aout after dtb) launch on the given
// stream, never synchronise, and return cudaGetLastError() as an int. The
// K4 entries take the sub-chunk length ks and the chains per block after kc.
// The carry entries are built from this file into a library of their own,
// celerite_adjoint_carry.cu, which defines PIORAN_CARRY_ENTRIES: nvcc
// then compiles their 24 instantiations beside this library's 48, at once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kFwdWarps = 4;        // K3: chains (warps) per block, at most
constexpr int kBwdChains = 4;       // K4: chains (warps) per block, at most
constexpr int kSmemBytes = 232448;  // shared memory one block may use on sm_90
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
// spacings cast to T) or t[n] - t[n-1]; with a carry, dt[n]
template <bool Carry, typename T>
__device__ __forceinline__ T step_dt(const T* t, const T* dt, int n) {
  if (Carry) return dt[n];
  if (n == 0) return T(0);
  return dt ? dt[n - 1] : t[n] - t[n - 1];
}

// 16-byte vectors of shared memory: four floats or two doubles
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<double> { static constexpr int n = 2; };

__device__ __forceinline__ void ld_vec(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void ld_vec(const double* p, double (&v)[2]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x; v[1] = x.y;
}
__device__ __forceinline__ void st_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_vec(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Copy 4 or 8 bytes from device memory to shared memory asynchronously
// (cp.async): the copy needs no register and does not stall the thread;
// cp_async_wait<n> waits until at most n of this thread's groups are in
// flight, and a __syncwarp() then shows every lane's copies to the warp.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem_dst, const T* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem_src),
               "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One warp writes n values from 16-byte-aligned shared memory to device
// memory, 16 bytes a lane where dst is aligned, else value by value.
template <typename T>
__device__ __forceinline__ void warp_store(T* __restrict__ dst, const T* __restrict__ src,
                                           int n, int lane) {
  constexpr int V = Vec<T>::n;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    done = n / V * V;
    for (int e = lane * V; e < done; e += 32 * V) {
      T v[V];
      ld_vec(src + e, v);
      st_vec(dst + e, v);
    }
  }
  for (int e = done + lane; e < n; e += 32) dst[e] = src[e];
}

// Row stride of a block of JP columns (JP a multiple of 4) in shared
// memory: an odd number of 16-byte vectors, so that a lane's row read as
// vectors and a column read lane by lane are both free of bank conflicts.
__host__ __device__ constexpr int row_stride(int JP, int V) {
  return (JP / V) % 2 == 1 ? JP : JP + V;
}

// K4's capacity: J rounded up to a multiple of 4.
__host__ __device__ constexpr int jp4_of(int J) { return (J + 3) / 4 * 4; }

// K3's shared memory per warp, in values: two column rows of 5 x 32
// (ec, W0, W1, U0, U1), the staged rows of 32 steps (4 x 32 J) and the
// checkpoint tile (3 J^2, rounded up to a whole vector).
__host__ __device__ constexpr int fwd_warp_len(int J) {
  return 2 * 5 * 32 + 4 * 32 * J + (3 * J * J + 3) / 4 * 4;
}

// K4's residual buffer for ks steps: W0, W1, pre0, pre1 rows padded to JP,
// then D, zp, dt (ks each) and t (ks + 1: the step before the sub-chunk).
__host__ __device__ constexpr int bwd_rw_len(int JP, int ks) { return 4 * ks * JP + 4 * ks + 4; }

// K4's shared memory per warp, in values: the T chunk (ks x 3 blocks of
// JP rows of RS), two checkpoint buffers (3 J rows of RS), two residual
// buffers, the ec rows of the sub-chunk (ks x 32) and two column rows of
// 4 x 32 (U0, U1, q0bar, q1bar).
__host__ __device__ constexpr int bwd_warp_len(int J, int ks, int V) {
  return ks * 3 * jp4_of(J) * row_stride(jp4_of(J), V) + 6 * J * row_stride(jp4_of(J), V) +
         2 * bwd_rw_len(jp4_of(J), ks) + 32 * ks + 256;
}

// ---------------------------------------------------------------------------
// K3: augmented forward
// ---------------------------------------------------------------------------

// JP: compile-time row capacity (>= J, <= 32); columns j >= J are zero.
// PerLaneT: per-chain t (B, N), dt (B, N - 1) and n_valid (B,).
// Carry: a block of a split series (header).
template <typename T, int JP, bool PerLaneT, bool Carry>
__global__ void __launch_bounds__(32 * kFwdWarps)
fwd_aug_kernel(const T* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ c, const T* __restrict__ d,
               const T* __restrict__ t, const T* __restrict__ dt,
               const T* __restrict__ y, const T* __restrict__ s2,
               const int* __restrict__ n_valid,
               T* __restrict__ out, T* __restrict__ W0t, T* __restrict__ W1t,
               T* __restrict__ P0t, T* __restrict__ P1t, T* __restrict__ Dt,
               T* __restrict__ ZPt, T* __restrict__ Tcp,
               const T* __restrict__ cin, T* __restrict__ cout, T* __restrict__ parts,
               int B, int J, int N, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Vec<T>::n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= B) return;  // the ragged batch edge: whole warps leave
  int nv = N;  // steps that count
  if (PerLaneT) {  // this chain's own rows of t and dt
    t += static_cast<long long>(chain) * N;
    if (dt) dt += static_cast<long long>(chain) * (N - 1);
    nv = n_valid[chain];
  }
  // this warp's shared memory: column rows [2][5][32], staged rows
  // [4][32 J] (W0, W1, pre0, pre1 of step k at k J), checkpoint tile [3][J][J]
  T* col = reinterpret_cast<T*>(smem_raw) + warp * fwd_warp_len(J);
  T* stage = col + 2 * 5 * 32;
  T* tile = stage + 4 * 32 * J;

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
  const int JJ = J * J;
  const int nck = (N + kc - 1) / kc;
  const int C = 3 * JJ + 4 * J + 2;  // carry values a chain
  if constexpr (Carry) {  // the previous block's state, row `lane`
    const T* ci_ = cin + static_cast<long long>(chain) * C;
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const bool in = row && j < J;
      S00[j] = in ? ci_[lane * J + j] : T(0);
      S01[j] = in ? ci_[JJ + lane * J + j] : T(0);
      S10[j] = in ? ci_[JJ + j * J + lane] : T(0);  // S10 = S01^T
      S11[j] = in ? ci_[2 * JJ + lane * J + j] : T(0);
    }
    W0 = row ? ci_[3 * JJ + lane] : T(0);
    W1 = row ? ci_[3 * JJ + J + lane] : T(0);
    f0 = row ? ci_[3 * JJ + 2 * J + lane] : T(0);
    f1 = row ? ci_[3 * JJ + 3 * J + lane] : T(0);
    Dp = ci_[3 * JJ + 4 * J];
    zpp = ci_[3 * JJ + 4 * J + 1];
  }

  for (int base = 0; base < N; base += 32) {
    const int nk = min(32, N - base);
    T y_k = T(0), s_k = T(1), t_k = T(0), dt_k = T(0);
    if (lane < nk) {
      const int n = base + lane;
      y_k = y[cN + n];
      s_k = s2[cN + n];
      t_k = t[n];
      dt_k = step_dt<Carry>(t, dt, n);
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

      // the step's column values, read back as 16-byte broadcasts; two
      // rows alternate, so one __syncwarp a step orders reads and writes
      T* cl = col + (k & 1) * 5 * 32;
      cl[lane] = ec;
      cl[32 + lane] = W0;
      cl[64 + lane] = W1;
      cl[96 + lane] = U0;
      cl[128 + lane] = U1;
      __syncwarp();

      const T Wd0 = W0 * Dp, Wd1 = W1 * Dp;
      T su00 = T(0), su01 = T(0), su10 = T(0), su11 = T(0);
      // Ckpt: this step's T rows also go to the checkpoint tile
      auto columns = [&](auto ckpt) {
        constexpr bool kCkpt = decltype(ckpt)::value;
#pragma unroll
        for (int g = 0; g < JP / V; ++g) {
          if (g * V >= J) continue;  // warp-uniform: whole vectors of zeros
          T ev[V], w0v[V], w1v[V], u0v[V], u1v[V];
          ld_vec(cl + g * V, ev);
          ld_vec(cl + 32 + g * V, w0v);
          ld_vec(cl + 64 + g * V, w1v);
          ld_vec(cl + 96 + g * V, u0v);
          ld_vec(cl + 128 + g * V, u1v);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int j = g * V + v;
            const T ee = ec * ev[v];
            // T10[i][j] = T01[j][i], formed exactly as lane j forms it
            const T Wd0j = w0v[v] * Dp;
            const T t00 = S00[j] + Wd0 * w0v[v];
            const T t01 = S01[j] + Wd0 * w1v[v];
            const T t10 = S10[j] + Wd0j * W1;
            const T t11 = S11[j] + Wd1 * w1v[v];
            if constexpr (kCkpt) {
              if (row && j < J) {
                tile[lane * J + j] = t00;
                tile[JJ + lane * J + j] = t01;
                tile[2 * JJ + lane * J + j] = t11;
              }
            }
            S00[j] = ee * t00;
            S01[j] = ee * t01;
            S10[j] = ee * t10;
            S11[j] = ee * t11;
            su00 += S00[j] * u0v[v];
            su01 += S01[j] * u1v[v];
            su10 += S10[j] * u0v[v];
            su11 += S11[j] * u1v[v];
          }
        }
      };
      const bool ckpt = n % kc == 0;
      if (ckpt) {
        columns(std::true_type{});
        __syncwarp();  // the tile is whole: write it out as rows
        warp_store(Tcp + (static_cast<long long>(chain) * nck + n / kc) * 3 * JJ, tile,
                   3 * JJ, lane);
      } else {
        columns(std::false_type{});
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
      if (row) {  // staged; written out after the 32 steps
        T* st = stage + k * J + lane;
        st[0] = W0;
        st[32 * J] = W1;
        st[64 * J] = pre0;
        st[96 * J] = pre1;
      }
      if (lane == k) {
        D_k = Dn;
        zp_k = zpn;
      }
      f0 = f0n;
      f1 = f1n;
      Dp = Dn;
      zpp = zpn;
      const bool live = !PerLaneT || n < nv;
      kahan_add(logdet, clog, live ? Ops<T>::log_(Ops<T>::abs_(Dn)) : T(0));
      kahan_add(quad, cquad, live ? zpn * zpn / Dn : T(0));
      minD = (live && Dn < minD) ? Dn : minD;
    }
    __syncwarp();  // every lane's staged rows are in
    const long long o = (cN + base) * J;
    warp_store(W0t + o, stage, nk * J, lane);
    warp_store(W1t + o, stage + 32 * J, nk * J, lane);
    warp_store(P0t + o, stage + 64 * J, nk * J, lane);
    warp_store(P1t + o, stage + 96 * J, nk * J, lane);
    if (lane < nk) {
      Dt[cN + base + lane] = D_k;
      ZPt[cN + base + lane] = zp_k;
    }
    __syncwarp();  // the stage is read out before the next steps refill it
  }

  if constexpr (Carry) {  // the state after the last step, and the partials
    T* co_ = cout + static_cast<long long>(chain) * C;
    if (row) {
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        if (j < J) {
          co_[lane * J + j] = S00[j];
          co_[JJ + lane * J + j] = S01[j];
          co_[2 * JJ + lane * J + j] = S11[j];
        }
      }
      co_[3 * JJ + lane] = W0;
      co_[3 * JJ + J + lane] = W1;
      co_[3 * JJ + 2 * J + lane] = f0;
      co_[3 * JJ + 3 * J + lane] = f1;
    }
    if (lane == 0) {
      co_[3 * JJ + 4 * J] = Dp;
      co_[3 * JJ + 4 * J + 1] = zpp;
      parts[3LL * chain] = logdet;
      parts[3LL * chain + 1] = quad;
      parts[3LL * chain + 2] = minD;
    }
    return;
  }
  if (lane == 0) {
    const T ll = T(-0.5) * (logdet + quad + static_cast<T>(nv) * T(kLog2Pi));
    const bool ok = (minD > T(0)) && isfinite(ll);
    out[chain] = ok ? ll : T(-INFINITY);
  }
}

// ---------------------------------------------------------------------------
// K4: reverse sweep
// ---------------------------------------------------------------------------

// JP: J rounded up to a multiple of 4, so every column loop runs whole
// 16-byte vectors with no test of J (columns J .. JP - 1 hold zeros).
// Carry: a block of a split series (header).
template <typename T, int JP, bool PerLaneT, bool Carry>
__global__ void __launch_bounds__(32 * kBwdChains)
bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
           const T* __restrict__ c, const T* __restrict__ d,
           const T* __restrict__ t, const T* __restrict__ dt,
           const T* __restrict__ g, const int* __restrict__ n_valid,
           const T* __restrict__ W0t, const T* __restrict__ W1t,
           const T* __restrict__ P0t, const T* __restrict__ P1t,
           const T* __restrict__ Dt, const T* __restrict__ ZPt,
           const T* __restrict__ Tcp,
           T* __restrict__ abar, T* __restrict__ bbar, T* __restrict__ cbar,
           T* __restrict__ dbar, T* __restrict__ ybar, T* __restrict__ s2bar,
           T* __restrict__ tb, T* __restrict__ dtb,
           const T* __restrict__ ain, T* __restrict__ aout,
           int B, int J, int N, int kc, int ks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Vec<T>::n;
  constexpr int RS = row_stride(JP, V);
  // T blocks that phase 1 carries in registers at once: all three where
  // they fit beside the carry (float32, J <= 24), else one at a time
  constexpr int NB = (sizeof(T) == 4 && JP <= 24) ? 3 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= B) return;

  const bool row = lane < J;
  const bool rowp = lane < JP;  // rows of the T chunk (zero from J on)
  const long long cj = static_cast<long long>(chain) * J + lane;
  const long long cN = static_cast<long long>(chain) * N;
  const T gl = g[chain];
  const int CA = 3 * J * J + 2 * J;  // adjoint carry values a chain
  if (gl == T(0)) {  // no seed (a -inf chain): exact zeros, whatever the tables hold
    if (row) abar[cj] = bbar[cj] = cbar[cj] = dbar[cj] = T(0);
    for (int n = lane; n < N; n += 32) {
      ybar[cN + n] = s2bar[cN + n] = tb[cN + n] = dtb[cN + n] = T(0);
    }
    if constexpr (Carry) {
      for (int e = lane; e < CA; e += 32) aout[static_cast<long long>(chain) * CA + e] = T(0);
    }
    return;
  }
  int nv = N;  // steps that count
  if (PerLaneT) {  // this chain's own rows of t and dt
    t += static_cast<long long>(chain) * N;
    if (dt) dt += static_cast<long long>(chain) * (N - 1);
    nv = n_valid[chain];
  }
  const T ai = row ? a[cj] : T(0);
  const T bi = row ? b[cj] : T(0);
  const T ci = row ? c[cj] : T(0);
  const T di = row ? d[cj] : T(0);

  // this warp's shared memory (bwd_warp_len): the T chunk [ks][3][JP][RS],
  // two checkpoints [2][3 J][RS], two residual buffers [2][RWN], the ec
  // rows [ks][32] and two column rows [2][4][32]
  const int RWN = bwd_rw_len(JP, ks);
  T* Tb = reinterpret_cast<T*>(smem_raw) + warp * bwd_warp_len(J, ks, V);
  T* ckb0 = Tb + ks * 3 * JP * RS;
  T* rw0 = ckb0 + 6 * J * RS;
  T* ecb = rw0 + 2 * RWN;
  T* col = ecb + 32 * ks;
  for (int e = lane; e < 2 * RWN; e += 32) rw0[e] = T(0);  // padded columns stay 0
  __syncwarp();

  // deferred cotangent of T_{m+1}, row `lane`: symmetric parts of the
  // diagonal blocks, both off-diagonal blocks
  T P00[JP], M01[JP], M10[JP], P11[JP];
#pragma unroll
  for (int j = 0; j < JP; ++j) P00[j] = M01[j] = M10[j] = P11[j] = T(0);
  T cp0 = T(0), cp1 = T(0);  // deferred cotangent of pre_{m+1}
  T ab = T(0), bb = T(0), cb = T(0), db = T(0), sumabar = T(0);
  if constexpr (Carry) {  // the next block's cotangents of T and pre, row `lane`
    const T* ai_ = ain + static_cast<long long>(chain) * CA;
    const int jj = J * J;
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const bool in = row && j < J;
      P00[j] = in ? ai_[lane * J + j] : T(0);
      M01[j] = in ? ai_[jj + lane * J + j] : T(0);
      M10[j] = in ? ai_[jj + j * J + lane] : T(0);  // M10 = M01^T
      P11[j] = in ? ai_[2 * jj + lane * J + j] : T(0);
    }
    cp0 = row ? ai_[3 * jj + lane] : T(0);
    cp1 = row ? ai_[3 * jj + J + lane] : T(0);
  }

  const long long JJ = static_cast<long long>(J) * J;
  const int nck = (N + kc - 1) / kc;
  auto chunk_len = [&](int ch) { return min(kc, N - ch * kc); };
  auto nsub = [&](int ch) { return (chunk_len(ch) + ks - 1) / ks; };

  // issue the copies of sub-chunk sc of chunk ch into residual buffer
  // `buf` (and the chunk's checkpoint into its buffer), as one group
  auto fetch = [&](int ch, int sc, int buf, bool with_ck) {
    const int s0 = ch * kc + sc * ks;
    const int ns = min(ks, chunk_len(ch) - sc * ks);
    T* rw = rw0 + buf * RWN;
    if (row) {
      for (int k = 0; k < ns; ++k) {
        const long long o = (cN + s0 + k) * J + lane;
        cp_async(rw + k * JP + lane, W0t + o);
        cp_async(rw + (ks + k) * JP + lane, W1t + o);
        cp_async(rw + (2 * ks + k) * JP + lane, P0t + o);
        cp_async(rw + (3 * ks + k) * JP + lane, P1t + o);
      }
    }
    T* sc_rows = rw + 4 * ks * JP;  // D, zp, dt [ks] each, t [ks + 1]
    if (lane < ns) {
      cp_async(sc_rows + lane, Dt + cN + s0 + lane);
      cp_async(sc_rows + ks + lane, ZPt + cN + s0 + lane);
      if (dt) {  // step m's spacing is dt[m - 1], or with a carry dt[m]
        constexpr int d0 = Carry ? 0 : 1;
        if (s0 + lane >= d0)
          cp_async(sc_rows + 2 * ks + lane, dt + s0 + lane - d0);
        else
          sc_rows[2 * ks + lane] = T(0);
      }
    }
    for (int k = lane; k <= ns; k += 32) {  // t of steps s0 - 1 .. s0 + ns - 1
      if (s0 - 1 + k >= 0)
        cp_async(sc_rows + 3 * ks + k, t + s0 - 1 + k);
      else
        sc_rows[3 * ks + k] = T(0);
    }
    if (with_ck && row) {  // 3 J rows of J, each copied whole (coalesced)
      const T* src = Tcp + (static_cast<long long>(chain) * nck + ch) * 3 * JJ;
      T* dst = ckb0 + (ch & 1) * 3 * J * RS;
      for (int r = 0; r < 3 * J; ++r) cp_async(dst + r * RS + lane, src + r * J + lane);
    }
    cp_async_commit();
  };

  int ch = nck - 1, sc = nsub(ch) - 1, buf = 0;
  fetch(ch, sc, 0, true);
  for (;;) {
    // the sub-chunk after this one in the sweep: its copies fly meanwhile
    int ch2 = ch, sc2 = sc - 1;
    if (sc2 < 0) {
      ch2 = ch - 1;
      sc2 = ch2 >= 0 ? nsub(ch2) - 1 : 0;
    }
    if (ch2 >= 0) {
      fetch(ch2, sc2, buf ^ 1, ch2 != ch);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    const int base = ch * kc;
    const int s0 = base + sc * ks;
    const int ns = min(ks, chunk_len(ch) - sc * ks);
    const int s1 = s0 + ns;
    const T* rw = rw0 + buf * RWN;
    const T* W0r = rw;
    const T* W1r = rw + ks * JP;
    const T* P0r = rw + 2 * ks * JP;
    const T* P1r = rw + 3 * ks * JP;
    const T* Dr = rw + 4 * ks * JP;
    const T* ZPr = Dr + ks;
    const T* DTr = Dr + 2 * ks;
    const T* TTr = Dr + 3 * ks;  // TTr[k + 1] = t[s0 + k]
    const T* ckb = ckb0 + (ch & 1) * 3 * J * RS;
    auto seg_dt = [&](int k) -> T {
      if (!Carry && s0 + k == 0) return T(0);
      return dt ? DTr[k] : TTr[k + 1] - TTr[k];
    };

    // ec of the sub-chunk's steps, one row of 32 a step (0 on lanes >= J)
    for (int k = 0; k < ns; ++k)
      ecb[k * 32 + lane] = row ? Ops<T>::exp_(-(ci * seg_dt(k))) : T(0);
    __syncwarp();

    // ---- phase 1: T_m for m in [s0, s1) from the chunk's checkpoint
    // (replaying steps [base, s0) without storing them), blocks blk0 ..
    // blk0 + NB - 1 of T00, T01, T11, rows in registers
    auto recompute = [&](int blk0) {
      T r[NB][JP];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const T* src = ckb + ((blk0 + nb) * J + lane) * RS;
#pragma unroll
        for (int gg = 0; gg < JP / V; ++gg) {
          T v4[V];
#pragma unroll
          for (int v = 0; v < V; ++v) v4[v] = T(0);
          if (row) ld_vec(src + gg * V, v4);
#pragma unroll
          for (int v = 0; v < V; ++v) r[nb][gg * V + v] = (gg * V + v < J) ? v4[v] : T(0);
        }
      }
      for (int m = base; m < s1; ++m) {
        if (m >= s0 && rowp) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            T* dst = Tb + (((m - s0) * 3 + blk0 + nb) * JP + lane) * RS;
#pragma unroll
            for (int gg = 0; gg < JP / V; ++gg) {
              T v4[V];
#pragma unroll
              for (int v = 0; v < V; ++v) v4[v] = r[nb][gg * V + v];
              st_vec(dst + gg * V, v4);
            }
          }
        }
        if (m == s1 - 1) break;
        // T_{m+1} = ee_m o T_m + D_m W_m W_m^T
        const T *ecr, *w0r, *w1r;
        T ec, W0, W1, Dm;
        if (m >= s0) {
          const int k = m - s0;
          ecr = ecb + k * 32;
          w0r = W0r + k * JP;
          w1r = W1r + k * JP;
          ec = ecr[lane];
          W0 = row ? w0r[lane] : T(0);
          W1 = row ? w1r[lane] : T(0);
          Dm = Dr[k];
        } else {  // a step before the sub-chunk: from device memory
          __syncwarp();  // the last replayed step's reads are done
          const long long o = (cN + m) * J + lane;
          ec = row ? Ops<T>::exp_(-(ci * step_dt<Carry>(t, dt, m))) : T(0);
          W0 = row ? W0t[o] : T(0);
          W1 = row ? W1t[o] : T(0);
          Dm = Dt[cN + m];
          col[lane] = ec;
          col[32 + lane] = W0;
          col[64 + lane] = W1;
          __syncwarp();
          ecr = col;
          w0r = col + 32;
          w1r = col + 64;
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int blk = blk0 + nb;
          const T wd = (blk == 2 ? W1 : W0) * Dm;
          const T* wr = blk == 0 ? w0r : w1r;
#pragma unroll
          for (int gg = 0; gg < JP / V; ++gg) {
            T ev[V], wv[V];
            ld_vec(ecr + gg * V, ev);
            ld_vec(wr + gg * V, wv);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const int j = gg * V + v;
              r[nb][j] = (ec * ev[v]) * r[nb][j] + wd * wv[v];
            }
          }
        }
      }
    };
    if constexpr (NB == 3) {
      recompute(0);
    } else {
      recompute(0);
      recompute(1);
      recompute(2);
    }
    __syncwarp();  // lanes read each other's T01 rows below

    // ---- phase 2: the reverse sweep over the sub-chunk's steps
    T yb = T(0), s2b = T(0), tbk = T(0), dtbk = T(0);  // step s0 + lane's outputs
    T tsum = T(0), dtsum = T(0);  // the t and dt partials of step kp, not yet summed
    int kp = -1;
    for (int k = ns - 1; k >= 0; --k) {
      const int m = s0 + k;
      const T tn = TTr[k + 1];
      const T dtn = seg_dt(k);
      T si, co;
      Ops<T>::sincos_(di * tn, &si, &co);
      const T V0 = row ? co : T(0);
      const T V1 = row ? si : T(0);
      const T U0 = ai * co + bi * si;
      const T U1 = ai * si - bi * co;
      const T ec = ecb[k * 32 + lane];
      const T* w0r = W0r + k * JP;
      const T* w1r = W1r + k * JP;
      const T W0 = row ? w0r[lane] : T(0);
      const T W1 = row ? w1r[lane] : T(0);
      const T pre0 = row ? P0r[k * JP + lane] : T(0);
      const T pre1 = row ? P1r[k * JP + lane] : T(0);
      const T Dm = Dr[k];
      const T zpm = ZPr[k];
      const T q0 = V0 - W0 * Dm;
      const T q1 = V1 - W1 * Dm;
      const T rD = T(1) / Dm;

      // the previous step's butterfly, off that step's critical path: it
      // overlaps this step's Mbar loop; lane kp keeps the sums
      warp_sum2(tsum, dtsum);
      if (lane == kp) {
        tbk = tsum;
        dtbk = dtsum;
      }

      // consume Mbar: T_{m+1} = S_m + D_m W_m W_m^T
      T pw0 = T(0), m01w1 = T(0), m10w0 = T(0), pw1 = T(0);
#pragma unroll
      for (int gg = 0; gg < JP / V; ++gg) {
        T w0v[V], w1v[V];
        ld_vec(w0r + gg * V, w0v);
        ld_vec(w1r + gg * V, w1v);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int j = gg * V + v;
          pw0 += P00[j] * w0v[v];
          m01w1 += M01[j] * w1v[v];
          m10w0 += M10[j] * w0v[v];
          pw1 += P11[j] * w1v[v];
        }
      }
      T Dbar = W0 * (T(0.5) * pw0 + m01w1) + T(0.5) * W1 * pw1;
      const T W0bar = (pw0 + m01w1) * Dm + cp0 * zpm;
      const T W1bar = (pw1 + m10w0) * Dm + cp1 * zpm;
      // consume cpre: pre_{m+1} = f_m + W_m zp_m; sum(W-bar o W) for
      // W = (V - q) / D below goes through the same butterfly
      T f0bar = cp0, f1bar = cp1;
      T zpbar = cp0 * W0 + cp1 * W1;
      T Wsum = W0bar * W0 + W1bar * W1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        Dbar += __shfl_xor_sync(kFull, Dbar, off);
        zpbar += __shfl_xor_sync(kFull, zpbar, off);
        Wsum += __shfl_xor_sync(kFull, Wsum, off);
      }

      // loss seeds, scaled by the chain's cotangent, on the live steps
      if (!PerLaneT || m < nv) {
        Dbar -= T(0.5) * gl * (rD - zpm * zpm * (rD * rD));
        zpbar -= gl * zpm * rD;
      }

      // zp = y - U0.f0 - U1.f1, f = ec o pre
      T U0bar = -zpbar * (ec * pre0);
      T U1bar = -zpbar * (ec * pre1);
      f0bar -= zpbar * U0;
      f1bar -= zpbar * U1;
      T ecbar = f0bar * pre0 + f1bar * pre1;
      cp0 = ec * f0bar;
      cp1 = ec * f1bar;

      // W = (V - q) / D
      T cobar = W0bar * rD;
      T sibar = W1bar * rD;
      T q0bar = -cobar;
      T q1bar = -sibar;
      Dbar -= Wsum * rD;

      // D = suma + s2 - U0.q0 - U1.q1
      sumabar += Dbar;
      U0bar -= Dbar * q0;
      U1bar -= Dbar * q1;
      q0bar -= Dbar * U0;
      q1bar -= Dbar * U1;

      // q = S U with S = ee o T: U and ec cotangents, and the new Mbar.
      // Column values through two alternating rows (one __syncwarp a step)
      T* cl = col + (k & 1) * 128;
      cl[lane] = U0;
      cl[32 + lane] = U1;
      cl[64 + lane] = q0bar;
      cl[96 + lane] = q1bar;
      __syncwarp();
      const T* t00r = Tb + ((k * 3) * JP + lane) * RS;   // row `lane` of T00
      const T* t01r = t00r + JP * RS;                     // ... of T01
      const T* t11r = t00r + 2 * JP * RS;                 // ... of T11
      const T* t01c = Tb + (k * 3 + 1) * JP * RS + lane;  // column `lane` of T01
      T u0acc = T(0), u1acc = T(0), ecacc = T(0);
#pragma unroll
      for (int gg = 0; gg < JP / V; ++gg) {
        T ev[V], u0v[V], u1v[V], q0v[V], q1v[V];
        ld_vec(ecb + k * 32 + gg * V, ev);
        ld_vec(cl + gg * V, u0v);
        ld_vec(cl + 32 + gg * V, u1v);
        ld_vec(cl + 64 + gg * V, q0v);
        ld_vec(cl + 96 + gg * V, q1v);
        T a00[V], a01[V], a10[V], a11[V];
#pragma unroll
        for (int v = 0; v < V; ++v) a00[v] = a01[v] = a10[v] = a11[v] = T(0);
        if (rowp) {
          ld_vec(t00r + gg * V, a00);
          ld_vec(t01r + gg * V, a01);
          ld_vec(t11r + gg * V, a11);
#pragma unroll
          for (int v = 0; v < V; ++v) a10[v] = t01c[(gg * V + v) * RS];  // T10[i][j] = T01[j][i]
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int j = gg * V + v;
          const T ecj = ev[v];
          const T U0j = u0v[v], U1j = u1v[v], q0j = q0v[v], q1j = q1v[v];
          const T t00 = a00[v], t01 = a01[v], t10 = a10[v], t11 = a11[v];
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
      tsum = di * dchain;
      dtsum = -(ci * ecbar * ec);
      kp = k;
      if (lane == k) {  // every lane holds the step's sums; lane k keeps them
        yb = zpbar;
        s2b = Dbar;
      }
    }
    warp_sum2(tsum, dtsum);  // the sub-chunk's first step
    if (lane == kp) {
      tbk = tsum;
      dtbk = dtsum;
    }
    if (lane < ns) {  // the sub-chunk's per-step cotangents, one store each
      ybar[cN + s0 + lane] = yb;
      s2bar[cN + s0 + lane] = s2b;
      tb[cN + s0 + lane] = tbk;
      dtb[cN + s0 + lane] = dtbk;
    }
    __syncwarp();  // this sub-chunk's buffers are free for the next copies
    if (ch2 < 0) break;
    ch = ch2;
    sc = sc2;
    buf ^= 1;
  }
  if (row) {
    abar[cj] = ab + sumabar;  // sum(a) feeds D at every step
    bbar[cj] = bb;
    cbar[cj] = cb;
    dbar[cj] = db;
  }
  if constexpr (Carry) {  // the cotangents of T and pre at the block's first step
    if (row) {
      T* ao = aout + static_cast<long long>(chain) * CA;
      const int jj = J * J;
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        if (j < J) {
          ao[lane * J + j] = P00[j];
          ao[jj + lane * J + j] = M01[j];
          ao[2 * jj + lane * J + j] = P11[j];
        }
      }
      ao[3 * jj + lane] = cp0;
      ao[3 * jj + J + lane] = cp1;
    }
  }
}

template <typename T, bool PerLaneT, bool Carry = false>
int launch_fwd_aug(const T* a, const T* b, const T* c, const T* d, const T* t,
                   const T* dt, const T* y, const T* s2, const int* n_valid,
                   T* out, T* W0t, T* W1t, T* P0t, T* P1t, T* Dt, T* ZPt, T* Tcp,
                   int B, int J, int N, int kc, cudaStream_t stream,
                   const T* cin = nullptr, T* cout = nullptr, T* parts = nullptr) {
  if (J < 1 || J > 32 || kc < 1 || (PerLaneT && n_valid == nullptr) ||
      (Carry && (dt == nullptr || cin == nullptr || cout == nullptr || parts == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const int warp_bytes = fwd_warp_len(J) * static_cast<int>(sizeof(T));
  const int warps = min(kFwdWarps, kSmemBytes / warp_bytes);
  const size_t smem = static_cast<size_t>(warps) * warp_bytes;
  const dim3 block(32 * warps);
  const dim3 grid((B + warps - 1) / warps);
#define PIORAN_FWD_AUG(JP)                                                       \
  do {                                                                           \
    auto kern = fwd_aug_kernel<T, JP, PerLaneT, Carry>;                          \
    const cudaError_t e = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);          \
    if (e != cudaSuccess) return static_cast<int>(e);                            \
    kern<<<grid, block, smem, stream>>>(a, b, c, d, t, dt, y, s2, n_valid, out,  \
                                        W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, cin,   \
                                        cout, parts, B, J, N, kc);               \
  } while (0)
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

// ks: sub-chunk length (1 <= ks <= min(kc, 32)); cpb: chains (warps) per
// block (1 .. kBwdChains). The wrapper chooses both so the block's shared
// memory fits; a choice that does not is refused.
template <typename T, bool PerLaneT, bool Carry = false>
int launch_bwd(const T* a, const T* b, const T* c, const T* d, const T* t,
               const T* dt, const T* g, const int* n_valid, const T* W0t,
               const T* W1t, const T* P0t, const T* P1t, const T* Dt,
               const T* ZPt, const T* Tcp, T* abar, T* bbar, T* cbar, T* dbar,
               T* ybar, T* s2bar, T* tb, T* dtb, int B, int J, int N, int kc,
               int ks, int cpb, cudaStream_t stream, const T* ain = nullptr,
               T* aout = nullptr) {
  if (J < 1 || J > 32 || kc < 1 || ks < 1 || ks > kc || ks > 32 || cpb < 1 ||
      cpb > kBwdChains || (PerLaneT && n_valid == nullptr) ||
      (Carry && (dt == nullptr || ain == nullptr || aout == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = static_cast<long long>(cpb) *
                         bwd_warp_len(J, ks, Vec<T>::n) * static_cast<int>(sizeof(T));
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * cpb);
  const dim3 grid((B + cpb - 1) / cpb);
#define PIORAN_BWD(JP)                                                           \
  do {                                                                           \
    auto kern = bwd_kernel<T, JP, PerLaneT, Carry>;                              \
    const cudaError_t e = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);          \
    if (e != cudaSuccess) return static_cast<int>(e);                            \
    kern<<<grid, block, static_cast<size_t>(smem), stream>>>(                    \
        a, b, c, d, t, dt, g, n_valid, W0t, W1t, P0t, P1t, Dt, ZPt, Tcp, abar,   \
        bbar, cbar, dbar, ybar, s2bar, tb, dtb, ain, aout, B, J, N, kc, ks);     \
  } while (0)
  switch (jp4_of(J)) {
    case 4: PIORAN_BWD(4); break;
    case 8: PIORAN_BWD(8); break;
    case 12: PIORAN_BWD(12); break;
    case 16: PIORAN_BWD(16); break;
    case 20: PIORAN_BWD(20); break;
    case 24: PIORAN_BWD(24); break;
    case 28: PIORAN_BWD(28); break;
    default: PIORAN_BWD(32); break;
  }
#undef PIORAN_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the shared-grid entries pass no n_valid; the per-lane ones take it
// after s2 (K3) or g (K4)
#define PIORAN_FWD_AUG_BODY(T, PER_LANE, NV)                                     \
    return launch_fwd_aug<T, PER_LANE>(                                          \
        static_cast<const T*>(a), static_cast<const T*>(b),                      \
        static_cast<const T*>(c), static_cast<const T*>(d),                      \
        static_cast<const T*>(t), static_cast<const T*>(dt),                     \
        static_cast<const T*>(y), static_cast<const T*>(s2), NV,                 \
        static_cast<T*>(out), static_cast<T*>(W0t), static_cast<T*>(W1t),        \
        static_cast<T*>(P0t), static_cast<T*>(P1t), static_cast<T*>(Dt),         \
        static_cast<T*>(ZPt), static_cast<T*>(Tcp), B, J, N, kc,                 \
        static_cast<cudaStream_t>(stream));

#define PIORAN_FWD_AUG_ENTRY(NAME, T)                                            \
  int NAME(const void* a, const void* b, const void* c, const void* d,          \
           const void* t, const void* dt, const void* y, const void* s2,        \
           void* out, void* W0t, void* W1t, void* P0t, void* P1t, void* Dt,     \
           void* ZPt, void* Tcp, int B, int J, int N, int kc, void* stream) {   \
    PIORAN_FWD_AUG_BODY(T, false, nullptr)                                       \
  }

#define PIORAN_FWD_AUG_MULTI_ENTRY(NAME, T)                                      \
  int NAME(const void* a, const void* b, const void* c, const void* d,          \
           const void* t, const void* dt, const void* y, const void* s2,        \
           const void* n_valid, void* out, void* W0t, void* W1t, void* P0t,     \
           void* P1t, void* Dt, void* ZPt, void* Tcp, int B, int J, int N,      \
           int kc, void* stream) {                                              \
    PIORAN_FWD_AUG_BODY(T, true, static_cast<const int*>(n_valid))               \
  }

#define PIORAN_FWD_AUG_CARRY_ENTRY(NAME, T)                                      \
  int NAME(const void* a, const void* b, const void* c, const void* d,          \
           const void* t, const void* dt, const void* y, const void* s2,        \
           void* W0t, void* W1t, void* P0t, void* P1t, void* Dt, void* ZPt,     \
           void* Tcp, const void* cin, void* cout, void* parts, int B, int J,   \
           int N, int kc, void* stream) {                                       \
    return launch_fwd_aug<T, false, true>(                                       \
        static_cast<const T*>(a), static_cast<const T*>(b),                      \
        static_cast<const T*>(c), static_cast<const T*>(d),                      \
        static_cast<const T*>(t), static_cast<const T*>(dt),                     \
        static_cast<const T*>(y), static_cast<const T*>(s2), nullptr, nullptr,   \
        static_cast<T*>(W0t), static_cast<T*>(W1t), static_cast<T*>(P0t),        \
        static_cast<T*>(P1t), static_cast<T*>(Dt), static_cast<T*>(ZPt),         \
        static_cast<T*>(Tcp), B, J, N, kc, static_cast<cudaStream_t>(stream),    \
        static_cast<const T*>(cin), static_cast<T*>(cout), static_cast<T*>(parts)); \
  }

#ifndef PIORAN_CARRY_ENTRIES
PIORAN_FWD_AUG_ENTRY(celerite_fwd_aug_f32, float)
PIORAN_FWD_AUG_ENTRY(celerite_fwd_aug_f64, double)
PIORAN_FWD_AUG_MULTI_ENTRY(celerite_fwd_aug_multi_f32, float)
PIORAN_FWD_AUG_MULTI_ENTRY(celerite_fwd_aug_multi_f64, double)
#else
PIORAN_FWD_AUG_CARRY_ENTRY(celerite_fwd_aug_carry_f32, float)
PIORAN_FWD_AUG_CARRY_ENTRY(celerite_fwd_aug_carry_f64, double)
#endif

#define PIORAN_BWD_BODY(T, PER_LANE, NV)                                         \
    return launch_bwd<T, PER_LANE>(                                              \
        static_cast<const T*>(a), static_cast<const T*>(b),                      \
        static_cast<const T*>(c), static_cast<const T*>(d),                      \
        static_cast<const T*>(t), static_cast<const T*>(dt),                     \
        static_cast<const T*>(g), NV, static_cast<const T*>(W0t),                \
        static_cast<const T*>(W1t), static_cast<const T*>(P0t),                  \
        static_cast<const T*>(P1t), static_cast<const T*>(Dt),                   \
        static_cast<const T*>(ZPt), static_cast<const T*>(Tcp),                  \
        static_cast<T*>(abar), static_cast<T*>(bbar), static_cast<T*>(cbar),     \
        static_cast<T*>(dbar), static_cast<T*>(ybar), static_cast<T*>(s2bar),    \
        static_cast<T*>(tb), static_cast<T*>(dtb), B, J, N, kc, ks, cpb,         \
        static_cast<cudaStream_t>(stream));

#define PIORAN_BWD_ENTRY(NAME, T)                                                \
  int NAME(const void* a, const void* b, const void* c, const void* d,          \
           const void* t, const void* dt, const void* g, const void* W0t,       \
           const void* W1t, const void* P0t, const void* P1t, const void* Dt,   \
           const void* ZPt, const void* Tcp, void* abar, void* bbar,            \
           void* cbar, void* dbar, void* ybar, void* s2bar, void* tb,           \
           void* dtb, int B, int J, int N, int kc, int ks, int cpb,             \
           void* stream) {                                                      \
    PIORAN_BWD_BODY(T, false, nullptr)                                           \
  }

#define PIORAN_BWD_MULTI_ENTRY(NAME, T)                                          \
  int NAME(const void* a, const void* b, const void* c, const void* d,          \
           const void* t, const void* dt, const void* g, const void* n_valid,   \
           const void* W0t, const void* W1t, const void* P0t, const void* P1t,  \
           const void* Dt, const void* ZPt, const void* Tcp, void* abar,        \
           void* bbar, void* cbar, void* dbar, void* ybar, void* s2bar,         \
           void* tb, void* dtb, int B, int J, int N, int kc, int ks, int cpb,   \
           void* stream) {                                                      \
    PIORAN_BWD_BODY(T, true, static_cast<const int*>(n_valid))                   \
  }

#define PIORAN_BWD_CARRY_ENTRY(NAME, T)                                          \
  int NAME(const void* a, const void* b, const void* c, const void* d,          \
           const void* t, const void* dt, const void* g, const void* W0t,       \
           const void* W1t, const void* P0t, const void* P1t, const void* Dt,   \
           const void* ZPt, const void* Tcp, void* abar, void* bbar,            \
           void* cbar, void* dbar, void* ybar, void* s2bar, void* tb,           \
           void* dtb, const void* ain, void* aout, int B, int J, int N, int kc, \
           int ks, int cpb, void* stream) {                                     \
    return launch_bwd<T, false, true>(                                           \
        static_cast<const T*>(a), static_cast<const T*>(b),                      \
        static_cast<const T*>(c), static_cast<const T*>(d),                      \
        static_cast<const T*>(t), static_cast<const T*>(dt),                     \
        static_cast<const T*>(g), nullptr, static_cast<const T*>(W0t),           \
        static_cast<const T*>(W1t), static_cast<const T*>(P0t),                  \
        static_cast<const T*>(P1t), static_cast<const T*>(Dt),                   \
        static_cast<const T*>(ZPt), static_cast<const T*>(Tcp),                  \
        static_cast<T*>(abar), static_cast<T*>(bbar), static_cast<T*>(cbar),     \
        static_cast<T*>(dbar), static_cast<T*>(ybar), static_cast<T*>(s2bar),    \
        static_cast<T*>(tb), static_cast<T*>(dtb), B, J, N, kc, ks, cpb,         \
        static_cast<cudaStream_t>(stream), static_cast<const T*>(ain),           \
        static_cast<T*>(aout));                                                  \
  }

#ifndef PIORAN_CARRY_ENTRIES
PIORAN_BWD_ENTRY(celerite_bwd_f32, float)
PIORAN_BWD_ENTRY(celerite_bwd_f64, double)
PIORAN_BWD_MULTI_ENTRY(celerite_bwd_multi_f32, float)
PIORAN_BWD_MULTI_ENTRY(celerite_bwd_multi_f64, double)
#else
PIORAN_BWD_CARRY_ENTRY(celerite_bwd_carry_f32, float)
PIORAN_BWD_CARRY_ENTRY(celerite_bwd_carry_f64, double)
#endif

const char* celerite_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
