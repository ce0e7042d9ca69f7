// The sorted-MSM kernels of msm_sorted.cu and msm_sorted_wide.cu (see
// msm_sorted.cu for what they replace, their design and their layouts):
// walk_kernel, suffix_kernel, suffix_split_kernel, fold_ladder_kernel and
// fold_tree_kernel, templates over the point's field E, with their launch
// helpers (walk_at, suffix_at, suffix_fold_at: one width N each). Each
// source instantiates its own widths, so nvcc compiles the two in
// parallel: the 24-limb kernels alone take about as long as the 8- and
// 12-limb ones together.

#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kThreads = 128;
constexpr int kSplitThreads = 128;  // zkt_msm_suffix_block
constexpr int kLadderThreads = 32;
constexpr int kTreeThreads = 256;

// walk thread states
constexpr int kSeek = 0;  // before its first start: looks for one in [lo, hi)
constexpr int kWalk = 1;  // walking, writing a snapshot at every position
constexpr int kDone = 2;

template <class E>
__device__ __forceinline__ bool z_is_zero(const int32_t* qk, size_t L, size_t lane) {
  constexpr int ER = Rows<E>::value;
  int32_t acc = 0;
#pragma unroll
  for (int r = 0; r < ER; ++r) acc |= qk[(size_t)(2 * ER + r) * L + lane];
  return acc == 0;
}

template <class E, bool MIXED, bool SAFE>
__global__ void __launch_bounds__(kThreads) walk_kernel(const int32_t* __restrict__ q,
                                                         const int32_t* __restrict__ flags,
                                                         int32_t* __restrict__ out,
                                                         int32_t* __restrict__ coll, int K, int L,
                                                         int S, FieldParams<E::kN> P) {
  constexpr int ER = Rows<E>::value;
  constexpr int IN_ROWS = MIXED ? 2 * ER : 3 * ER;
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t Ls = (size_t)L;
  const int lo = blockIdx.y * S;
  const int hi = min(lo + S, K);
  // reset: the accumulator's Z is 0 by the flags alone (a flush after the
  // last effective position, or no effective position yet)
  bool reset = true;
  int state = lane >= Ls ? kDone : (lo == 0 ? kWalk : kSeek);
  if (state == kSeek) {
    for (int j = lo - 1; j >= 0; --j) {
      const int32_t fl = flags[(size_t)j * Ls + lane];
      if (fl & 1) break;
      if (!(fl & 2) && (MIXED || !z_is_zero<E>(q + (size_t)j * IN_ROWS * Ls, Ls, lane))) {
        reset = false;
        break;
      }
    }
  }
  Jac<E> acc;
  set_zero(acc.X);
  set_zero(acc.Y);
  set_zero(acc.Z);
  bool hit = false;
  // every thread of the warp stays in the loop until all are done
  for (int k = lo; __any_sync(0xffffffffu, state != kDone); ++k) {
    if (state == kDone) continue;
    if (k >= K) {
      state = kDone;
      continue;
    }
    const int32_t fl = flags[(size_t)k * Ls + lane];
    const int32_t* qk = q + (size_t)k * IN_ROWS * Ls;
    const bool skip = (fl & 2) != 0;
    // whether k is effective matters only while reset: the point's Z is
    // read once a segment
    const bool start = !skip && reset && (MIXED || !z_is_zero<E>(qk, Ls, lane));
    if (k >= hi && (state == kSeek || start)) {
      state = kDone;
      continue;
    }
    if (start) state = kWalk;
    reset = (fl & 1) ? true : (start ? false : reset);
    if (state != kWalk) continue;
    if (!skip) {  // the complete add returns acc for Q at infinity, as a skip
      if (MIXED) {
        E Qx, Qy;
        load(Qx, qk, 0, Ls, lane);
        load(Qy, qk, ER, Ls, lane);
        bool is_dbl;
        acc = ec_mixed_add<E, SAFE>(acc, Qx, Qy, is_dbl, P);
        if (!SAFE && is_dbl) hit = true;
      } else {
        Jac<E> Qp;
        load_jac(Qp, qk, 0, Ls, lane);
        acc = ec_add(acc, Qp, P);
      }
    }
    store_jac(out + (size_t)k * 3 * ER * Ls, 0, Ls, lane, acc);
    if (fl & 1) set_zero(acc.Z);
  }
  if (hit) coll[lane] = 1;
}

template <class E>
__global__ void __launch_bounds__(kThreads) suffix_kernel(const int32_t* __restrict__ a,
                                                           const int32_t* __restrict__ b,
                                                           int32_t* __restrict__ out, int Lb, int M,
                                                           FieldParams<E::kN> P) {
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

// The split suffix's and the epilogue's point ops, out of line: each
// kernel calls the add from several places, and inlining the Fq2 add at
// each multiplies the code that ptxas allocates registers over (and its
// compile time).
template <class E>
__device__ __noinline__ Jac<E> point_add(const Jac<E>& a, const Jac<E>& b, const FieldParams<E::kN>& P) {
  return ec_add(a, b, P);
}

template <class E>
__device__ __noinline__ Jac<E> point_double(const Jac<E>& a, const FieldParams<E::kN>& P) {
  return ec_double(a, P);
}

// A point in shared memory, limb-major: word i of the point at s[i*stride]
// (s: the thread's column).
template <int N>
__device__ __forceinline__ void sm_put(uint32_t* s, int stride, const Fq<N>& a) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i * stride] = a.v[i];
}

template <int N>
__device__ __forceinline__ void sm_put(uint32_t* s, int stride, const Fq2<N>& a) {
  sm_put(s, stride, a.c0);
  sm_put(s + N * stride, stride, a.c1);
}

template <int N>
__device__ __forceinline__ void sm_get(Fq<N>& a, const uint32_t* s, int stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) a.v[i] = s[i * stride];
}

template <int N>
__device__ __forceinline__ void sm_get(Fq2<N>& a, const uint32_t* s, int stride) {
  sm_get(a.c0, s, stride);
  sm_get(a.c1, s + N * stride, stride);
}

template <class E>
__device__ __forceinline__ void sm_put_jac(uint32_t* s, const Jac<E>& p) {
  constexpr int W = Rows<E>::value / 2;  // 32-bit words a coordinate
  sm_put(s, kSplitThreads, p.X);
  sm_put(s + W * kSplitThreads, kSplitThreads, p.Y);
  sm_put(s + 2 * W * kSplitThreads, kSplitThreads, p.Z);
}

template <class E>
__device__ __forceinline__ void sm_get_jac(Jac<E>& p, const uint32_t* s) {
  constexpr int W = Rows<E>::value / 2;
  sm_get(p.X, s, kSplitThreads);
  sm_get(p.Y, s + W * kSplitThreads, kSplitThreads);
  sm_get(p.Z, s + 2 * W * kSplitThreads, kSplitThreads);
}

// The suffix walk cut into k sub-chunks a lane (k a power of two, 2 <= k
// <= kSplitThreads, k | Lb): thread tid = l + j*lpb of a block holds
// sub-chunk j of lane blockIdx.x*lpb + l, lpb = kSplitThreads/k lanes a
// block. Threads past M hold zero triples (every add of them returns at
// once) and take part in the barriers.
template <class E>
__global__ void __launch_bounds__(kSplitThreads) suffix_split_kernel(const int32_t* __restrict__ a,
                                                                      const int32_t* __restrict__ b,
                                                                      int32_t* __restrict__ out, int Lb, int M,
                                                                      int k, FieldParams<E::kN> P) {
  extern __shared__ __align__(16) unsigned char split_smem[];
  constexpr int ER = Rows<E>::value;
  uint32_t* scan = reinterpret_cast<uint32_t*>(split_smem) + threadIdx.x;  // S_j
  uint32_t* part = scan + (3 * ER / 2) * kSplitThreads;                    // u_j, then w_j
  const int lpb = kSplitThreads / k;
  const int j = threadIdx.x / lpb;
  const size_t lane = (size_t)blockIdx.x * lpb + threadIdx.x % lpb;
  const bool live = lane < (size_t)M;
  const size_t Ms = (size_t)M;
  const int c = Lb / k;
  Jac<E> acc, tot;
  set_zero(acc.X);
  set_zero(acc.Y);
  set_zero(acc.Z);
  tot = acc;
  if (live) {
    for (int t = j * c; t < (j + 1) * c; ++t) {
      Jac<E> A, B;
      load_jac(A, a + (size_t)t * 3 * ER * Ms, 0, Ms, lane);
      load_jac(B, b + (size_t)t * 3 * ER * Ms, 0, Ms, lane);
      acc = point_add(acc, point_add(A, B, P), P);
      tot = point_add(tot, acc, P);
    }
  }
  sm_put_jac(part, tot);
  sm_put_jac(scan, acc);
  __syncthreads();
  // inclusive scan: acc becomes S_j
  for (int d = 1; d < k; d <<= 1) {
    Jac<E> prev;
    if (j >= d) sm_get_jac(prev, scan - d * lpb);
    __syncthreads();
    if (j >= d) {
      acc = point_add(prev, acc, P);
      sm_put_jac(scan, acc);
    }
    __syncthreads();
  }
  if (live && j == k - 1) store_jac(out, 0, Ms, lane, acc);
  // w_j = u_j + c*S_{j-1}; the ladder as fold_ladder_kernel's (bit set:
  // res += tmp; then tmp doubles, never past c's top bit)
  Jac<E> w;
  if (j > 0) {
    Jac<E> tmp, res;
    sm_get_jac(tmp, scan - lpb);
    set_one(res.X, P);
    set_one(res.Y, P);
    set_zero(res.Z);
    for (int i = 0; (c >> i) != 0; ++i) {
      if ((c >> i) & 1) res = point_add(res, tmp, P);
      if ((c >> (i + 1)) != 0) tmp = point_double(tmp, P);
    }
    sm_get_jac(w, part);
    w = point_add(w, res, P);
    sm_put_jac(part, w);  // only this thread reads its own u_j
  } else {
    sm_get_jac(w, part);
  }
  // tot = sum_j w_j by the pairwise halving tree
  for (int s = k >> 1; s >= 1; s >>= 1) {
    __syncthreads();
    if (j < s) {
      Jac<E> o;
      sm_get_jac(o, part + s * lpb);
      w = point_add(w, o, P);
      sm_put_jac(part, w);
    }
  }
  if (live && j == 0) store_jac(out, 3 * ER, Ms, lane, w);
}

// The suffix epilogue's first pass (the reference's fold=True branch):
// one thread per lane of all G*lw lanes. Lane m = w*lw + i computes
// tot + base*acc with base = (lw-1-i)*L by the plain version's ladder
// (bit k set: res += tmp; then tmp doubles), in registers, and writes it
// to sums (lane-minor rows, as the input).
template <class E>
__global__ void __launch_bounds__(kLadderThreads) fold_ladder_kernel(const int32_t* __restrict__ in,
                                                                      int32_t* __restrict__ sums,
                                                                      int M, int lw, int L,
                                                                      FieldParams<E::kN> P) {
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)M) return;
  constexpr int ER = Rows<E>::value;
  const size_t Ms = (size_t)M;
  Jac<E> acc, tot, res;
  load_jac(acc, in, 0, Ms, lane);
  load_jac(tot, in, 3 * ER, Ms, lane);
  set_one(res.X, P);
  set_one(res.Y, P);
  set_zero(res.Z);
  const int base = (lw - 1 - (int)(lane % lw)) * L;
  // doublings past base's top bit are never added: they are skipped
  for (int k = 0; (base >> k) != 0; ++k) {
    if ((base >> k) & 1) res = point_add(res, acc, P);
    if ((base >> (k + 1)) != 0) acc = point_double(acc, P);
  }
  store_jac(sums, 0, Ms, lane, point_add(tot, res, P));
}

// The second pass: one block per window. The top level adds lane i + s
// into lane i (s = lw/2) straight from the lane sums into shared memory,
// then the levels s = lw/4, ..., 1 in shared memory; one thread per add
// (up to blockDim). Window w's Jacobian sum is written as int64 16-bit
// limbs to out[c][w] for c = X, Y, Z.
template <class E>
__global__ void __launch_bounds__(kTreeThreads) fold_tree_kernel(const int32_t* __restrict__ sums,
                                                                  int64_t* __restrict__ out, int G,
                                                                  int lw, FieldParams<E::kN> P) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  Jac<E>* lanes = reinterpret_cast<Jac<E>*>(fold_smem);
  const size_t M = (size_t)G * lw;
  const int w = blockIdx.x;
  const size_t first = (size_t)w * lw;
  int s = lw >> 1;
  if (s == 0) {
    if (threadIdx.x == 0) load_jac(lanes[0], sums, 0, M, first);
  } else {
    for (int i = threadIdx.x; i < s; i += blockDim.x) {
      Jac<E> a, b;
      load_jac(a, sums, 0, M, first + i);
      load_jac(b, sums, 0, M, first + i + s);
      lanes[i] = point_add(a, b, P);
    }
  }
  for (s >>= 1; s >= 1; s >>= 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < s; i += blockDim.x) lanes[i] = point_add(lanes[i], lanes[i + s], P);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const Jac<E> S = lanes[0];
    store_wide(out + ((size_t)0 * G + w) * Rows<E>::value, S.X);
    store_wide(out + ((size_t)1 * G + w) * Rows<E>::value, S.Y);
    store_wide(out + ((size_t)2 * G + w) * Rows<E>::value, S.Z);
  }
}

template <class E>
int launch_suffix_fold(const int32_t* in, int32_t* sums, int64_t* out, int G, int lw, int L,
                       const FieldParams<E::kN>& P, cudaStream_t s) {
  const int M = G * lw;
  fold_ladder_kernel<E><<<(M + kLadderThreads - 1) / kLadderThreads, kLadderThreads, 0, s>>>(
      in, sums, M, lw, L, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int half = lw > 1 ? lw / 2 : 1;
  const size_t smem = (size_t)half * sizeof(Jac<E>);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fold_tree_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = half < kTreeThreads ? half : kTreeThreads;
  fold_tree_kernel<E><<<G, threads, smem, s>>>(sums, out, G, lw, P);
  return (int)cudaGetLastError();
}

template <class E>
void launch_walk(const int32_t* q, const int32_t* flags, int32_t* out, int32_t* coll, int K, int L,
                 int S, int mixed, int safe, const FieldParams<E::kN>& P, cudaStream_t s) {
  dim3 grid((L + kThreads - 1) / kThreads, (K + S - 1) / S);
  if (mixed && safe)
    walk_kernel<E, true, true><<<grid, kThreads, 0, s>>>(q, flags, out, coll, K, L, S, P);
  else if (mixed)
    walk_kernel<E, true, false><<<grid, kThreads, 0, s>>>(q, flags, out, coll, K, L, S, P);
  else
    walk_kernel<E, false, true><<<grid, kThreads, 0, s>>>(q, flags, out, coll, K, L, S, P);
}

// EXT: whether the width has the Fq2 instantiations (not at N = 24)
template <int N, bool EXT = true>
int walk_at(const int32_t* q, const int32_t* flags, int32_t* out, int32_t* coll, int K, int L, int S,
            int ext, int mixed, int safe, const uint32_t* p, const uint32_t* one, uint32_t n0,
            int beta_abs, cudaStream_t s) {
  const FieldParams<N> P = make_params<N>(p, one, n0, beta_abs);
  if (ext) {
    if constexpr (!EXT) return (int)cudaErrorInvalidValue;
    else launch_walk<Fq2<N>>(q, flags, out, coll, K, L, S, mixed, safe, P, s);
  } else {
    launch_walk<Fq<N>>(q, flags, out, coll, K, L, S, mixed, safe, P, s);
  }
  return (int)cudaGetLastError();
}

template <class E>
int launch_suffix(const int32_t* a, const int32_t* b, int32_t* out, int Lb, int M, int k,
                  const FieldParams<E::kN>& P, cudaStream_t s) {
  // k = 1: suffix_kernel, whose adds are inlined. suffix_split_kernel at
  // k = 1 (the same walk through the out-of-line point_add, the combine
  // empty) is slower at the prove's Lb = 1 shapes on an H100:
  // port_tools/suffix_k1_ab.py times the two.
  if (k == 1) {
    suffix_kernel<E><<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(a, b, out, Lb, M, P);
    return (int)cudaGetLastError();
  }
  const int lpb = kSplitThreads / k;
  const size_t smem = 2 * sizeof(Jac<E>) * kSplitThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(suffix_split_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  suffix_split_kernel<E><<<(M + lpb - 1) / lpb, kSplitThreads, smem, s>>>(a, b, out, Lb, M, k, P);
  return (int)cudaGetLastError();
}

template <int N, bool EXT = true>
int suffix_at(const int32_t* a, const int32_t* b, int32_t* out, int Lb, int M, int k, int ext,
              const uint32_t* p, const uint32_t* one, uint32_t n0, int beta_abs, cudaStream_t s) {
  const FieldParams<N> P = make_params<N>(p, one, n0, beta_abs);
  if (ext) {
    if constexpr (!EXT) return (int)cudaErrorInvalidValue;
    else return launch_suffix<Fq2<N>>(a, b, out, Lb, M, k, P, s);
  }
  return launch_suffix<Fq<N>>(a, b, out, Lb, M, k, P, s);
}

template <int N, bool EXT = true>
int suffix_fold_at(const int32_t* in, int32_t* sums, int64_t* out, int G, int lw, int L, int ext,
                   const uint32_t* p, const uint32_t* one, uint32_t n0, int beta_abs,
                   cudaStream_t s) {
  const FieldParams<N> P = make_params<N>(p, one, n0, beta_abs);
  if (ext) {
    if constexpr (!EXT) return (int)cudaErrorInvalidValue;
    else return launch_suffix_fold<Fq2<N>>(in, sums, out, G, lw, L, P, s);
  }
  return launch_suffix_fold<Fq<N>>(in, sums, out, G, lw, L, P, s);
}

}  // namespace
