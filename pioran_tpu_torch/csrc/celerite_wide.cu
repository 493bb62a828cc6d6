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
// registers. Here one thread block carries one chain: two threads a row of
// the 2J x 2J state (ops/cuda_celerite_vjp.py `wide_shape` passes the
// entries `cpt`):
//
// - The register design (cpt = 40 or 64; J <= cpt). Thread 2 r + hl holds
//   columns [hl J, hl J + J) of row r in registers, cpt values, zeros past
//   J; rows of per-step values sit in shared memory padded the same way,
//   so a thread reads its columns as 16-byte vectors and the padding adds
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
// - Past the registers (64 < J <= 128, Tail; cpt = cw, J rounded up to 4):
//   the same kernels and layout with rows of 2 cw, 4 J threads (up to
//   512), a thread's first tail_rc columns in registers (64 forward and 32
//   in K4 in float32, 32 and 16 in float64) and the rest of its segment,
//   the tail, in shared memory as 16-byte vectors interleaved over the
//   threads (vector k of thread t at (k nts + t) V: a warp's accesses are
//   consecutive), read and written once a step. Where the tail does not
//   fit (float64 past J = 88 forward; K4's G in float32 past J = 116, in
//   float64 past J = 72; K4's slots of ks = 8 steps at every J past 64)
//   it is in a device scratch of the wrapper's, in the same layout, and K3
//   writes its checkpoint rows straight to the table where the staging
//   does not fit. The state S stays a thread's own (S10 beside S01, as in
//   the register design), so no step needs a second barrier. K4 replays a
//   chunk's T vector by vector through its steps in registers, so its
//   slots are written once and read once a step.
//
// K4 carries the cotangent of T_{m+1} as the symmetric parts P00 = M00 +
// M00^T and P11 = M11 + M11^T and both off-diagonal blocks M01 and M10 =
// M01^T, an R x R matrix G; every quantity the sweep reads of M00 and M11
// depends only on their symmetric parts, since T00 and T11 are symmetric
// (as in csrc/celerite_adjoint.cu).
//
// What bounds them on this card: the N dependent steps of a chain, each
// O(J^2) work; bytes are negligible (K0's tables aside). An earlier design
// (one thread a row, S and G in shared memory) spent three quarters of a
// step on the column loop's shared-memory loads and stores, 3 warps a
// chain, five barriers a step in K4 (tools/wide_probe.py, PERF.md). The
// register design keeps the state out of memory, reads its column values
// as 16-byte vectors, and has one barrier a step, so a step is bound by
// the issue of its per-entry arithmetic (about 6 instructions an entry
// forward, 11 in K4 and 4 a replayed step), with two to four chains an SM
// in float32 at J = 40; past the registers a step adds one 16-byte load
// and store of the tail per 4 (float32) entries, with 8 to 16 warps a chain.
// Rounding follows the plain loops' statements, with two partial
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
// of its ints (40 or 64: the register design; past 64 terms cw), K4 its
// sub-chunk ks before it. Past 64 terms a null `state` (forward) or
// `carry` / `chunk` (K4) puts the forward tail, G's tail or the slots in
// shared memory, else that part is a device scratch of the wrapper's:
// `state` and `carry` (B, 4 J rounded up to 32, cw - tail_rc) and `chunk`
// (B, ks, 4 J rounded up to 32, cw); the register design takes none of
// them. They launch on the given stream,
// never synchronise, allocate nothing, and return cudaGetLastError() (or
// cudaErrorInvalidValue for what they do not take) as an int.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kMaxTerms = 128;
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

// The kernels' arguments (the C entries below fill them)

template <typename T>
struct FwdArgs {
  const T *a, *b, *c, *d, *t, *dt;  // coefficients (B, J); t (N,) or (B, N); dt or null
  const T *U, *V, *phi, *suma;      // K0: tables (N, R, B) and sum(a) (B,)
  const T *y, *s2;                  // (B, N)
  const int* n_valid;               // per-lane grids (B,)
  T* out;                           // (B,)
  T *W0t, *W1t, *P0t, *P1t, *Dt, *ZPt, *Tcp;  // K3's residual tables
  T* state;                         // past the registers: the tail scratch, or null
  const T* cin;                     // carry entries: the state in, out, the partials
  T *cout, *parts;
  int B, J, N, kc;
  int cw;                           // past the registers: a row half's width
  bool stage;                       // past the registers: K3 stages its checkpoints
};

template <typename T>
struct BwdArgs {
  const T *a, *b, *c, *d, *t, *dt, *g;
  const int* n_valid;
  const T *W0t, *W1t, *P0t, *P1t, *Dt, *ZPt, *Tcp;
  T *abar, *bbar, *cbar, *dbar, *ybar, *s2bar, *tb, *dtb;
  T* carry;  // past the registers: G's tail scratch, or null: shared memory
  T* chunk;  // past the registers: the slots' scratch, or null: shared memory
  const T* ain;  // carry entries: the adjoint carry in and out
  T* aout;
  int B, J, N, kc, ks;
  int cw;    // past the registers: a row half's width
};

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
constexpr int kTailMaxThreads = 4 * kMaxTerms;  // past the registers: 4 J up to 512
constexpr int kTailMaxWarps = kTailMaxThreads / 32;

// Past 64 terms (Tail): a thread holds the first RC columns of its row
// segment in registers and columns [RC, cw) in shared memory, or in a
// device scratch where they do not fit. RC by dtype and kernel: the forward
// state takes half a thread's 128 registers (512 threads an SM at J = 128),
// K4 less, its column loads need the rest.
template <typename T, bool Bwd>
__host__ __device__ constexpr int tail_rc() {
  return sizeof(T) == 4 ? (Bwd ? 32 : 64) : (Bwd ? 16 : 32);
}

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

// Past the registers: the forward kernels' shared memory up to the tail,
// in values (the split_fwd_len layout with rows of 2 cw and 16 warps),
// rounded to a whole number of vectors.
__host__ __device__ constexpr long long tail_fwd_off(int cw, int stJ) {
  return (2LL * kTab * 3 * 2 * cw + 4LL * cw + 4LL * kTab + 4LL * kTailMaxWarps + 2LL * kTab +
          3LL * stJ * (stJ + 1) + 3) / 4 * 4;
}

// Past the registers: K4's shared memory but the slots and G's tail.
__host__ __device__ constexpr long long tail_bwd_len(int cw, int ks) {
  return kTab * (9LL * cw + 4) + 4LL * cw + ks * 8LL * cw + 8LL * kTailMaxWarps;
}

// K1, K2, K0 and K3 (one template): one block a chain.
// A step: the column loop T = S + (W_r D) W, S = (ec_r ec) o T, q_r =
// S U (both halves, a shuffle), then one barrier, after which every
// thread has D and zp from the warps' partial sums and the rows V - q
// (written before it), and so W of its columns. Tables of U, V and ec
// for kTab steps are built a block ahead from values loaded a block
// before that; the Kahan sums of a block's logs run on warp 0 at its end.
template <typename T, int CPT, int G, bool Aug, bool Carry, bool Tail = false>
__global__ void __launch_bounds__(Tail ? kTailMaxThreads : 4 * CPT,
                                  (Tail ? 1 : split_min_blocks<T, CPT, false>()))
split_fwd_kernel(const FwdArgs<T> p) {
  constexpr int V = Vec<T>::n;
  constexpr int MW = Tail ? kTailMaxWarps : kSplitMaxWarps;
  // a row half of the per-step rows: CPT, or past the registers p.cw
  const int RW = Tail ? p.cw : CPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chain = blockIdx.x, tid = threadIdx.x;
  const int J = p.J, R = 2 * J, N = p.N;
  const int r = tid >> 1, hl = tid & 1;
  const bool act = r < R;
  const int h = (act && r >= J) ? 1 : 0;
  const int i = act ? r - h * J : 0;
  const int own = h * RW + i;  // this row in the tables
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const bool pt = tid < 4 * J;  // builds table entries: term ti, steps q0 and q0 + 4
  const int ti = pt ? tid % J : 0, q0 = pt ? tid / J : 0;
  T* Ut = reinterpret_cast<T*>(smem_raw);   // [2][kTab][2 RW]
  T* Vt = Ut + 2 * kTab * 2 * RW;
  T* Et = Vt + 2 * kTab * 2 * RW;
  T* dq = Et + 2 * kTab * 2 * RW;            // [2][2 RW]: V - q of a step's rows
  T* Yt = dq + 4 * RW;                       // [2][kTab]
  T* S2t = Yt + 2 * kTab;
  T* red = S2t + 2 * kTab;                   // [2][warps][2]
  T* ring = red + 4 * MW;                    // [kTab][2]: D, zp
  T* Tst = ring + 2 * kTab;                  // K3's checkpoint staging [3][J][J + 1]
  // (kc 1, or past the registers where it does not fit: a step's rows
  // straight to the table)
  const bool staged = Aug && p.kc >= 2 && (!Tail || p.stage);
  // past the registers, columns [CPT, RW) of each thread's row segment:
  // vector k at ((k - CPT) / V * nts + tid) V, in shared memory after the
  // staging or in the device scratch p.state
  const int nts = blockDim.x;
  const long long tail_len = static_cast<long long>(nts) * (RW - CPT);
  T* St = nullptr;
  if (Tail) {
    St = p.state ? p.state + chain * tail_len
                 : Ut + tail_fwd_off(RW, staged ? J : 0);
  }
  for (int e = tid; e < 2 * kTab * 6 * RW + 4 * RW; e += blockDim.x) Ut[e] = T(0);
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
        T* u = Ut + (b + s) * 2 * RW;
        T* v = Vt + (b + s) * 2 * RW;
        T* e = Et + (b + s) * 2 * RW;
        if (G == kTables) {
          u[ti] = x[q][0];
          u[RW + ti] = x[q][1];
          v[ti] = x[q][2];
          v[RW + ti] = x[q][3];
          e[ti] = x[q][4];
          e[RW + ti] = x[q][5];
        } else {
          const T dtm = (Carry || dt != nullptr || m == 0) ? x[q][1] : x[q][0] - x[q][1];
          T si, co;
          Ops<T>::sincos_(td * x[q][0], &si, &co);
          u[ti] = ta * co + tb * si;
          u[RW + ti] = ta * si - tb * co;
          v[ti] = co;
          v[RW + ti] = si;
          e[ti] = e[RW + ti] = Ops<T>::exp_(-(tc * dtm));
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
  if (Tail) {
    for (int k = CPT; k < RW; k += V) {
      T v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = k + e;
        v[e] = T(0);
        if (Carry && act && c < J) {
          v[e] = (h == 1 && hl == 0) ? cin[JJ + static_cast<long long>(c) * J + i]
                                     : cin[(h + hl) * JJ + static_cast<long long>(i) * J + c];
        }
      }
      vstore(St + ((k - CPT) / V * nts + tid) * V, v);
    }
  }
  T f = (Carry && act) ? cin[3 * JJ + R + r] : T(0);
  T Dp = Carry ? cin[3 * JJ + 2 * R] : T(0);
  T zpp = Carry ? cin[3 * JJ + 2 * R + 1] : T(0);
  T rDp = T(1);  // W of step n - 1 is its V - q times rDp: a carry's W as it is
  if (act && hl == 0) dq[2 * RW + own] = Carry ? cin[3 * JJ + r] : T(0);
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
    const T* Un = Ut + sb * 2 * RW;
    const T* En = Et + sb * 2 * RW;
    const T* dqp = dq + ((n + 1) & 1) * 2 * RW;
    T q = T(0), Ur = T(0), Vr = T(0), Er = T(0), Wr = T(0);
    if (act) {
      Ur = Un[own];
      Vr = Vt[sb * 2 * RW + own];
      Er = En[own];
      Wr = dqp[own] * rDp;
      const T wd = Wr * Dp;
      const T* dqc = dqp + hl * RW;
      const T* uc = Un + hl * RW;
      const T* ec = En + hl * RW;
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
        if (Tail) {  // the columns past the registers, a vector at a time
          for (int k = CPT; k < RW; k += V) {
            T* sp = St + ((k - CPT) / V * nts + tid) * V;
            T sv[V], dv[V], uv[V], ev[V];
            vload(sp, sv);
            vload(dqc + k, dv);
            vload(uc + k, uv);
            vload(ec + k, ev);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const T Tv = sv[e] + wd * (dv[e] * rDp);
              if (decltype(ckpt)::value) {
                if (k + e < J) tile[k + e] = Tv;
              }
              sv[e] = (Er * ev[e]) * Tv;
              if ((k / V) & 1) {
                q1s += sv[e] * uv[e];
              } else {
                q0s += sv[e] * uv[e];
              }
            }
            vstore(sp, sv);
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
        dq[(n & 1) * 2 * RW + own] = dqn;
        s0v = Ur * qo;
        s1v = Ur * f;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0v += __shfl_xor_sync(kFull, s0v, off);
      s1v += __shfl_xor_sync(kFull, s1v, off);
    }
    T* rb = red + (n & 1) * 2 * MW;
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
      if (Tail) {
        for (int k = CPT; k < J; ++k)
          co[(h + hl) * JJ + static_cast<long long>(i) * J + k] =
              St[((k - CPT) / V * nts + tid) * V + (k - CPT) % V];
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
template <typename T, int CPT, bool PerLaneT, bool Carry, bool Tail = false>
__global__ void __launch_bounds__(Tail ? kTailMaxThreads : 4 * CPT,
                                  (Tail ? 1 : split_min_blocks<T, CPT, true>()))
split_bwd_kernel(const BwdArgs<T> p) {
  constexpr int MW = Tail ? kTailMaxWarps : kSplitMaxWarps;
  // a row half of the per-step rows, and a thread's columns in a slot: CPT,
  // or past the registers p.cw
  const int RW = Tail ? p.cw : CPT;
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chain = blockIdx.x, tid = threadIdx.x, nts = blockDim.x;
  const int J = p.J, R = 2 * J, N = p.N, kc = p.kc, ks = p.ks;
  const int r = tid >> 1, hl = tid & 1;
  const bool act = r < R;
  const int h = (act && r >= J) ? 1 : 0;
  const int i = act ? r - h * J : 0;
  const int own = h * RW + i;
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

  T* Ww = reinterpret_cast<T*>(smem_raw);  // the window: [kTab][2 RW] rows
  T* Uw = Ww + kTab * 2 * RW;
  T* Pw = Uw + kTab * 2 * RW;
  T* Ew = Pw + kTab * 2 * RW;              // [kTab][RW] by term
  T* Cw = Ew + kTab * RW;
  T* Sw = Cw + kTab * RW;
  T* Vb = Sw + kTab * RW;                  // [2][2 RW]: V-bar of a step's rows
  T* X = Vb + 4 * RW;                      // [ks][3][2 RW]: U-bar, V-bar, ec part
  T* TT = X + ks * 6 * RW;                 // [ks][2][RW]: t-bar, dt-bar terms
  T* red = TT + ks * 2 * RW;               // [2][warps][4]
  T* Dw = red + 8 * MW;         // [kTab] each: D, zp, t, dt
  T* Zw = Dw + kTab;
  T* Tw = Zw + kTab;
  T* DTw = Tw + kTab;
  const long long slot_len = static_cast<long long>(nts) * RW;
  // [ks] slots of slot_len, in shared memory or (past the registers where
  // they do not fit) the device scratch p.chunk
  const bool slots_smem = !Tail || p.chunk == nullptr;
  T* chunk = slots_smem ? DTw + kTab : p.chunk + chain * ks * slot_len;
  // past the registers, columns [CPT, RW) of each thread's row of G: vector
  // k at ((k - CPT) / V * nts + tid) V, in shared memory after the slots or
  // in the device scratch p.carry
  const long long tail_len = static_cast<long long>(nts) * (RW - CPT);
  T* Gt = nullptr;
  if (Tail) {
    Gt = p.carry ? p.carry + chain * tail_len
                 : DTw + kTab + (slots_smem ? ks * slot_len : 0);
  }
  for (int e = tid; e < kTab * 9 * RW + 4 * RW; e += nts) Ww[e] = T(0);

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
  if (Tail) {
    for (int k = CPT; k < RW; k += V) {
      T v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = k + e;
        v[e] = T(0);
        if (Carry && act && c < J) {
          v[e] = (h == 1 && hl == 0) ? ain[JJ + static_cast<long long>(c) * J + i]
                                     : ain[(h + hl) * JJ + static_cast<long long>(i) * J + c];
        }
      }
      vstore(Gt + ((k - CPT) / V * nts + tid) * V, v);
    }
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
    for (int k = 0; k < RW; k += V) {
      T* d = slot + (static_cast<long long>(k / V) * nts + tid) * V;
      if (!slots_smem) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          d[e] = k + e < J ? src[static_cast<long long>(k + e) * ck_str] : T(0);
        continue;
      }
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
        Ew[s * RW + ti] = Ops<T>::exp_(-(tc * dtm));
        Cw[s * RW + ti] = co;
        Sw[s * RW + ti] = si;
        Uw[s * 2 * RW + ti] = ta * co + tb * si;
        Uw[s * 2 * RW + RW + ti] = ta * si - tb * co;
        const long long o = (cN + m) * J + ti;
        Ww[s * 2 * RW + ti] = p.W0t[o];
        Ww[s * 2 * RW + RW + ti] = p.W1t[o];
        Pw[s * 2 * RW + ti] = p.P0t[o];
        Pw[s * 2 * RW + RW + ti] = p.P1t[o];
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
      // Past the registers, a chunk inside one window: each vector of a
      // thread's row segment is read once from slot 0 and carried through
      // the chunk's steps in registers, each slot written once (the same
      // statement a step as below), so the slots' traffic is one read and
      // ks - 1 writes a chunk instead of a read and a write a step
      const bool fused = Tail && len <= kTab;
      if (fused && act) {
        for (int k = 0; k < RW; k += V) {
          const long long o = (static_cast<long long>(k / V) * nts + tid) * V;
          T v[V];
          vload(chunk + o, v);
          for (int m = base; m < s1 - 1; ++m) {
            const int w = m - win;
            const T Er = Ew[w * RW + i];
            const T wd = Ww[w * 2 * RW + own] * Dw[w];
            T e4[V], w4[V];
            vload(Ew + w * RW + k, e4);
            vload(Ww + w * 2 * RW + hl * RW + k, w4);
#pragma unroll
            for (int e = 0; e < V; ++e) v[e] = (Er * e4[e]) * v[e] + wd * w4[e];
            if (m + 1 >= s0) vstore(chunk + (m + 1 - s0) * slot_len + o, v);
          }
        }
      }
      for (int m = base; m < (fused ? base : s1 - 1); ++m) {
        need(m);
        PROBE(pb, 0)
        const int w = m - win;
        T* src = chunk + (m >= s0 ? m - s0 : 0) * slot_len;
        T* dst = chunk + (m + 1 >= s0 ? m + 1 - s0 : 0) * slot_len;
        if (act) {
          const T Er = Ew[w * RW + i];
          const T wd = Ww[w * 2 * RW + own] * Dw[w];
          const T* ec = Ew + w * RW;
          const T* wc = Ww + w * 2 * RW + hl * RW;
          // vector by vector: src and dst may be one slot
#pragma unroll
          for (int k = 0; k < RW; k += V) {
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
          Wr = Ww[w * 2 * RW + own];
          pre = Pw[w * 2 * RW + own];
          Ur = Uw[w * 2 * RW + own];
          Er = Ew[w * RW + i];
          Vr = h ? Sw[w * RW + i] : Cw[w * RW + i];
          // G's row times W_m: this half's columns
          const T* wc = Ww + w * 2 * RW + hl * RW;
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
          if (Tail) {
            for (int k = CPT; k < RW; k += V) {
              T w4[V], g4[V];
              vload(wc + k, w4);
              vload(Gt + ((k - CPT) / V * nts + tid) * V, g4);
#pragma unroll
              for (int e = 0; e < V; ++e) {
                if ((k / V) & 1) {
                  p1 += g4[e] * w4[e];
                } else {
                  p0 += g4[e] * w4[e];
                }
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
        T* rb = red + (m & 1) * 4 * MW;
        if (act && hl == 0) {
          Vb[(m & 1) * 2 * RW + own] = Vbar;
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
          const T* vbc = Vb + (m & 1) * 2 * RW + hl * RW;
          const T* uc = Uw + w * 2 * RW + hl * RW;
          const T* ec = Ew + w * RW;
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
          if (Tail) {  // two partial sums a cotangent by vector parity, as q's
            T u0 = T(0), u1 = T(0), e0 = T(0), e1 = T(0);
            for (int k = CPT; k < RW; k += V) {
              T* gp = Gt + ((k - CPT) / V * nts + tid) * V;
              T tv[V], vb[V], u4[V], e4[V], g4[V];
              vload(Tm + (static_cast<long long>(k / V) * nts + tid) * V, tv);
              vload(vbc + k, vb);
              vload(uc + k, u4);
              vload(ec + k, e4);
              vload(gp, g4);
              T uk = T(0), ek = T(0);
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const T qc = -vb[e] - Dbar * u4[e];
                const T ee = Er * e4[e];
                const T Q = g4[e] + qbar * u4[e] + Ur * qc;
                uk += ee * tv[e] * qc;
                ek += Q * tv[e] * e4[e];
                g4[e] = ee * Q;
              }
              if ((k / V) & 1) {
                u1 += uk;
                e1 += ek;
              } else {
                u0 += uk;
                e0 += ek;
              }
              vstore(gp, g4);
            }
            uacc += u0 + u1;
            eacc += e0 + e1;
          }
        }
        uacc += __shfl_xor_sync(kFull, uacc, 1);
        eacc += __shfl_xor_sync(kFull, eacc, 1);
        if (act && hl == 0) {
          T* xs = X + sl * 6 * RW;
          xs[own] = Ubar + uacc;
          xs[2 * RW + own] = Vbar;
          xs[4 * RW + own] = ecpart + eacc;
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
          const T* xs = X + s * 6 * RW;
          const T U0bar = xs[ti], U1bar = xs[RW + ti];
          T cobar = xs[2 * RW + ti], sibar = xs[3 * RW + ti];
          const T ecbar = xs[4 * RW + ti] + xs[5 * RW + ti];
          const T co = Cw[w * RW + ti], si = Sw[w * RW + ti], Er = Ew[w * RW + ti];
          ab += U0bar * co + U1bar * si;
          bb += U0bar * si - U1bar * co;
          cobar += U0bar * ta - U1bar * tb;
          sibar += U0bar * tb + U1bar * ta;
          const T dchain = -cobar * si + sibar * co;
          db += Tw[w] * dchain;
          cb -= DTw[w] * ecbar * Er;
          TT[s * 2 * RW + ti] = td * dchain;
          TT[s * 2 * RW + RW + ti] = -(tc * ecbar * Er);
        }
      }
      __syncthreads();  // the terms
      for (int s = warp; s < nsub; s += nw) {
        T v0 = T(0), v1 = T(0);
        for (int e = lane; e < J; e += 32) {
          v0 += TT[s * 2 * RW + e];
          v1 += TT[s * 2 * RW + RW + e];
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
      if (Tail) {
        for (int k = CPT; k < J; ++k)
          ao[(h + hl) * JJ + static_cast<long long>(i) * J + k] =
              Gt[((k - CPT) / V * nts + tid) * V + (k - CPT) % V];
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
// a thread): there `cpt` is the row half's width cw (J rounded up to 4),
// the first tail_rc columns of a thread's segment in registers, the rest
// in shared memory or the scratch (Tail).
constexpr bool split_has(int cpt) { return cpt == 40 || cpt == 64; }
constexpr bool tail_has(int J, int cpt) {
  return J > 64 && J <= cpt && cpt <= kMaxTerms && cpt % 4 == 0;
}

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

// Past the registers: the tail in shared memory unless p.state holds it;
// K3 stages its checkpoints where the staging fits beside the rest.
template <typename T, int G, bool Aug, bool Carry>
int launch_tail_fwd(FwdArgs<T> p, cudaStream_t stream) {
  constexpr int RC = tail_rc<T, false>();
  const long long item = sizeof(T);
  const long long tail =
      p.state ? 0 : static_cast<long long>(split_threads(p.J)) * (p.cw - RC);
  p.stage = Aug && p.kc >= 2 && (tail_fwd_off(p.cw, p.J) + tail) * item <= kSmemBytes;
  const long long smem = (tail_fwd_off(p.cw, p.stage ? p.J : 0) + tail) * item;
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = split_fwd_kernel<T, RC, G, Aug, Carry, true>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<p.B, split_threads(p.J), static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cpt 40 or 64: the register design (p.state null); past 64 terms cpt is
// the row half's width cw (Tail)
template <typename T, int G, bool Aug, bool Carry = false>
int launch_fwd(FwdArgs<T> p, int cpt, cudaStream_t stream) {
  if (p.J < 1 || p.J > kMaxTerms || (G == kPerLane && p.n_valid == nullptr) ||
      (Aug && p.kc < 1) ||
      (Carry && (p.dt == nullptr || p.cin == nullptr || p.cout == nullptr || p.parts == nullptr)) ||
      !((split_has(cpt) && p.J <= cpt && p.state == nullptr) || tail_has(p.J, cpt)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B <= 0 || p.N <= 0) return static_cast<int>(cudaSuccess);
  if (cpt == 40) return launch_split_fwd<T, 40, G, Aug, Carry>(p, stream);
  if (cpt == 64) return launch_split_fwd<T, 64, G, Aug, Carry>(p, stream);
  p.cw = cpt;
  return launch_tail_fwd<T, G, Aug, Carry>(p, stream);
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

// Past the registers: the ks slots in shared memory unless p.chunk holds
// them, then G's tail unless p.carry holds it.
template <typename T, bool PerLaneT, bool Carry>
int launch_tail_bwd(const BwdArgs<T>& p, cudaStream_t stream) {
  constexpr int RC = tail_rc<T, true>();
  const long long nts = split_threads(p.J);
  const long long smem = (tail_bwd_len(p.cw, p.ks) + (p.chunk ? 0 : p.ks * nts * p.cw) +
                          (p.carry ? 0 : nts * (p.cw - RC))) *
                         static_cast<long long>(sizeof(T));
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = split_bwd_kernel<T, RC, PerLaneT, Carry, true>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<p.B, static_cast<int>(nts), static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cpt 40 or 64: the register design (p.carry and p.chunk null: G in
// registers, the chunk's slots in shared memory); past 64 terms cpt is the
// row half's width cw (Tail). ks <= min(kc, kTab), and ks divides kTab
// where kc > kTab.
template <typename T, bool PerLaneT, bool Carry = false>
int launch_bwd(BwdArgs<T> p, int cpt, cudaStream_t stream) {
  if (p.J < 1 || p.J > kMaxTerms || p.kc < 1 || p.ks < 1 || p.ks > p.kc || p.ks > kTab ||
      (p.kc > kTab && kTab % p.ks != 0) || (PerLaneT && p.n_valid == nullptr) ||
      (Carry && (p.dt == nullptr || p.ain == nullptr || p.aout == nullptr)) ||
      !((split_has(cpt) && p.J <= cpt && p.carry == nullptr && p.chunk == nullptr) ||
        tail_has(p.J, cpt)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B <= 0 || p.N <= 0) return static_cast<int>(cudaSuccess);
  if (cpt == 40) return launch_split_bwd<T, 40, PerLaneT, Carry>(p, stream);
  if (cpt == 64) return launch_split_bwd<T, 64, PerLaneT, Carry>(p, stream);
  p.cw = cpt;
  return launch_tail_bwd<T, PerLaneT, Carry>(p, stream);
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
