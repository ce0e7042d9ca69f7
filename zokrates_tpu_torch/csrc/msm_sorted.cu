// Sorted-MSM bucket walk and suffix kernels for Hopper (sm_90a).
//
// walk_kernel replaces the JAX package's Pallas walk
// (zokrates_tpu/kernels/msm_sorted.py: walk_kernel_factory / _walk_call,
// modes "mixed" and "general"); suffix_kernel replaces its suffix walk
// (suffix_kernel_factory / _suffix_call, fold=False); suffix_fold_kernel
// replaces the same kernel's fold=True epilogue (the multiplier ladder and
// the per-window lane tree), launched after suffix_kernel.
//
// What bounds them on an H100: 32-bit integer multiplies. A mixed add is
// 11 Montgomery products (also 11 when it doubles: 4 before the branch, 7
// in it), a complete add 16 (15 when it doubles), an Fq2 product three Fq
// products, and one 8-limb CIOS product 136 32x32->64 products (264
// 32-bit multiply results, low and high halves). The inputs are read once
// and each walk position's snapshot written once, a few hundred bytes per
// point op against tens of thousands of multiply instructions: far on
// the operations side of the roofline.
//
// Design: one thread per lane; the TPU grid's sequential position axis is
// the thread's loop over its K positions, with the accumulator in
// registers. All windows' lanes (and all point sets sharing a plan) go in
// one launch, so the grid has tens of thousands of threads instead of the
// TPU kernel's one window of 1024 lanes per call. Lanes never interact, so
// results do not depend on the launch layout. The doubling inside the
// adds is a branch (taken almost never) instead of the Pallas kernel's
// compute-and-select, and skipped positions (flag bit 1) skip the add
// entirely: the sorted order puts them in whole runs, so warps rarely
// diverge on it. Memory access is lane-minor ([position][row][lane]), so
// a warp's loads and stores are contiguous.
//
// The fold epilogue is bound by operations too: per lane a ladder of up to
// log2((lw-1)*L) complete adds and doublings, then lw-1 complete adds per
// window in the tree, against 2*3*ER words read per lane. Where the TPU
// kernel ran a rotate-accumulate tree across its (S, 128) tile, one block
// here holds one window: the ladder runs in registers, one thread per lane
// (several lanes per thread above 128), and the tree in shared memory
// (lw * 96 B for Fq, lw * 192 B for Fq2: 12 KB / 24 KB at lw = 128). It
// follows the plain version's ladder and its pairwise halving tree
// a[:s] + a[s:2s] exactly, so its window sums equal the plain version's
// limb for limb; the TPU's rotation tree adds in another order and agrees
// with both as a group element.
//
// Layout (int32 rows of 16-bit Montgomery limbs, as the reference):
//   walk:   q     (K, IN_ROWS, L)  affine [x|y] (mixed) or Jacobian [X|Y|Z]
//           flags (K, L)           bit0 flush-after, bit1 skip
//           out   (K, 3*ER, L)     accumulator snapshot after each position
//           coll  (L,)             1 where the fast mixed add hit P1 == Q
//   suffix: a, b  (Lb, 3*ER, M)    2-slot dense bucket table, descending
//           out   (6*ER, M)        [acc | tot]: running sum and sum of sums
//   fold:   in    (6*ER, G*lw)     the suffix output, lanes of window w at
//                                  [w*lw, (w+1)*lw)
//           out   (3, G, ER)       int64 words of 16-bit limbs: X, Y, Z
// ER = 16 rows per Fq coordinate, 32 per Fq2 coordinate ([c0 | c1]).
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kThreads = 128;

template <class E, bool MIXED, bool SAFE>
__global__ void __launch_bounds__(kThreads) walk_kernel(const int32_t* __restrict__ q,
                                                         const int32_t* __restrict__ flags,
                                                         int32_t* __restrict__ out,
                                                         int32_t* __restrict__ coll, int K, int L,
                                                         FieldParams P) {
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  constexpr int ER = Rows<E>::value;
  constexpr int IN_ROWS = MIXED ? 2 * ER : 3 * ER;
  const size_t Ls = (size_t)L;
  Jac<E> acc;
  set_zero(acc.X);
  set_zero(acc.Y);
  set_zero(acc.Z);
  int32_t hit = 0;
  for (int k = 0; k < K; ++k) {
    const int32_t fl = flags[(size_t)k * Ls + lane];
    const int32_t* qk = q + (size_t)k * IN_ROWS * Ls;
    if (!(fl & 2)) {
      if (MIXED) {
        E Qx, Qy;
        load(Qx, qk, 0, Ls, lane);
        load(Qy, qk, ER, Ls, lane);
        bool is_dbl;
        acc = ec_mixed_add<E, SAFE>(acc, Qx, Qy, is_dbl, P);
        if (!SAFE && is_dbl) hit = 1;
      } else {
        Jac<E> Qp;
        load_jac(Qp, qk, 0, Ls, lane);
        acc = ec_add(acc, Qp, P);
      }
    }
    store_jac(out + (size_t)k * 3 * ER * Ls, 0, Ls, lane, acc);
    if (fl & 1) set_zero(acc.Z);
  }
  coll[lane] = hit;
}

template <class E>
__global__ void __launch_bounds__(kThreads) suffix_kernel(const int32_t* __restrict__ a,
                                                           const int32_t* __restrict__ b,
                                                           int32_t* __restrict__ out, int Lb, int M,
                                                           FieldParams P) {
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)M) return;
  constexpr int ER = Rows<E>::value;
  const size_t Ms = (size_t)M;
  Jac<E> acc, tot;
  set_zero(acc.X);
  set_zero(acc.Y);
  set_zero(acc.Z);
  tot = acc;
  for (int t = 0; t < Lb; ++t) {
    Jac<E> A, B;
    load_jac(A, a + (size_t)t * 3 * ER * Ms, 0, Ms, lane);
    load_jac(B, b + (size_t)t * 3 * ER * Ms, 0, Ms, lane);
    acc = ec_add(acc, ec_add(A, B, P), P);
    tot = ec_add(tot, acc, P);
  }
  store_jac(out, 0, Ms, lane, acc);
  store_jac(out, 3 * ER, Ms, lane, tot);
}

// The epilogue's point ops, out of line: the kernel calls the add from three
// places, and inlining the Fq2 add at each multiplies the code that ptxas
// allocates registers over (and its compile time) for an epilogue that runs
// once per MSM.
template <class E>
__device__ __noinline__ Jac<E> fold_add(const Jac<E>& a, const Jac<E>& b, const FieldParams& P) {
  return ec_add(a, b, P);
}

template <class E>
__device__ __noinline__ Jac<E> fold_double(const Jac<E>& a, const FieldParams& P) {
  return ec_double(a, P);
}

// The suffix epilogue (the reference's fold=True branch): one block per
// window, lane i of the window at thread i (mod blockDim). Each lane
// computes tot + base*acc with base = (lw-1-i)*L by the plain version's
// ladder (bit k set: res += tmp; then tmp doubles), in registers; the lw
// lane sums go to shared memory and a pairwise halving tree adds lane
// i + s into lane i for s = lw/2, ..., 1. Window w's Jacobian sum is
// written as int64 16-bit limbs to out[c][w] for c = X, Y, Z.
template <class E>
__global__ void __launch_bounds__(kThreads) suffix_fold_kernel(const int32_t* __restrict__ in,
                                                                int64_t* __restrict__ out, int G,
                                                                int lw, int L, FieldParams P) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  Jac<E>* lanes = reinterpret_cast<Jac<E>*>(fold_smem);
  constexpr int ER = Rows<E>::value;
  const size_t M = (size_t)G * lw;
  const int w = blockIdx.x;
  for (int i = threadIdx.x; i < lw; i += blockDim.x) {
    const size_t lane = (size_t)w * lw + i;
    Jac<E> acc, tot, res;
    load_jac(acc, in, 0, M, lane);
    load_jac(tot, in, 3 * ER, M, lane);
    set_one(res.X, P);
    set_one(res.Y, P);
    set_zero(res.Z);
    const int base = (lw - 1 - i) * L;
    // doublings past base's top bit are never added: they are skipped
    for (int k = 0; (base >> k) != 0; ++k) {
      if ((base >> k) & 1) res = fold_add(res, acc, P);
      if ((base >> (k + 1)) != 0) acc = fold_double(acc, P);
    }
    lanes[i] = fold_add(tot, res, P);
  }
  for (int s = lw >> 1; s >= 1; s >>= 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < s; i += blockDim.x) lanes[i] = fold_add(lanes[i], lanes[i + s], P);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const Jac<E> S = lanes[0];
    store_wide(out + ((size_t)0 * G + w) * ER, S.X);
    store_wide(out + ((size_t)1 * G + w) * ER, S.Y);
    store_wide(out + ((size_t)2 * G + w) * ER, S.Z);
  }
}

template <class E>
int launch_suffix_fold(const int32_t* in, int64_t* out, int G, int lw, int L, const FieldParams& P,
                       cudaStream_t s) {
  const size_t smem = (size_t)lw * sizeof(Jac<E>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(suffix_fold_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = lw < kThreads ? lw : kThreads;
  suffix_fold_kernel<E><<<G, threads, smem, s>>>(in, out, G, lw, L, P);
  return (int)cudaGetLastError();
}

template <class E>
void launch_walk(const int32_t* q, const int32_t* flags, int32_t* out, int32_t* coll, int K, int L,
                 int mixed, int safe, const FieldParams& P, cudaStream_t s) {
  dim3 grid((L + kThreads - 1) / kThreads);
  if (mixed && safe)
    walk_kernel<E, true, true><<<grid, kThreads, 0, s>>>(q, flags, out, coll, K, L, P);
  else if (mixed)
    walk_kernel<E, true, false><<<grid, kThreads, 0, s>>>(q, flags, out, coll, K, L, P);
  else
    walk_kernel<E, false, true><<<grid, kThreads, 0, s>>>(q, flags, out, coll, K, L, P);
}

}  // namespace

extern "C" {

// Field constants: p and one as NL little-endian 32-bit limbs, n0 =
// -p^-1 mod 2^32, beta_abs = |u^2| for Fq2 (ext != 0). mixed=0 requires
// safe != 0 (the record-merge walk always uses complete adds).
int zkt_msm_walk(const int32_t* q, const int32_t* flags, int32_t* out, int32_t* coll, int K, int L,
                 int ext, int mixed, int safe, const uint32_t* p, const uint32_t* one, uint32_t n0,
                 int beta_abs, void* stream) {
  FieldParams P = make_params(p, one, n0, beta_abs);
  cudaStream_t s = (cudaStream_t)stream;
  if (ext)
    launch_walk<Fq2>(q, flags, out, coll, K, L, mixed, safe, P, s);
  else
    launch_walk<Fq>(q, flags, out, coll, K, L, mixed, safe, P, s);
  return (int)cudaGetLastError();
}

int zkt_msm_suffix(const int32_t* a, const int32_t* b, int32_t* out, int Lb, int M, int ext,
                   const uint32_t* p, const uint32_t* one, uint32_t n0, int beta_abs, void* stream) {
  FieldParams P = make_params(p, one, n0, beta_abs);
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((M + kThreads - 1) / kThreads);
  if (ext)
    suffix_kernel<Fq2><<<grid, kThreads, 0, s>>>(a, b, out, Lb, M, P);
  else
    suffix_kernel<Fq><<<grid, kThreads, 0, s>>>(a, b, out, Lb, M, P);
  return (int)cudaGetLastError();
}

// in: the suffix kernel's (6*ER, G*lw) [acc | tot] rows; out: (3, G, ER)
// int64 window sums. lw is a power of two <= 1024.
int zkt_msm_suffix_fold(const int32_t* in, int64_t* out, int G, int lw, int L, int ext,
                        const uint32_t* p, const uint32_t* one, uint32_t n0, int beta_abs,
                        void* stream) {
  FieldParams P = make_params(p, one, n0, beta_abs);
  cudaStream_t s = (cudaStream_t)stream;
  if (ext) return launch_suffix_fold<Fq2>(in, out, G, lw, L, P, s);
  return launch_suffix_fold<Fq>(in, out, G, lw, L, P, s);
}

const char* zkt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
