// NTT pass kernel for Hopper (sm_90a).
//
// Replaces the JAX package's whole-transform Pallas NTT
// (zokrates_tpu/kernels/ntt_pallas.py: _kernel_factory / _ntt_call /
// fft_core_pallas): decimation in time over bit-reversed input, stage s
// pairing elements at distance 2^s with the twiddle w_(2^(s+1))^j, over
// (batch, n) Montgomery elements.
//
// What bounds it on an H100: operations, n/2 Montgomery products per stage
// (264 32-bit multiplies each at N = 8 limbs, 588 at N = 12) against 16N B
// read and 16N B written per element once; each pass past the first adds a
// round trip of 4N B per element through device memory.
//
// Widths: N = 8 32-bit limbs (the 254/255-bit scalar fields) and N = 12
// (BW6-761's 377-bit scalar field); the C entry point takes N.
//
// Design. The TPU kernel kept a whole 2^15 transform in VMEM for all 15
// stages; a block here has at most 227 KB of shared memory, so a transform
// runs as passes of at most 10 stages (kernels/ntt_pallas.pass_plan: 2 up
// to 2^20, the stages split evenly, 7 + 8 at 2^15). Pass [s0, s0 + S)
// gives each tile the T = 2^S elements that differ in bits s0 .. s0+S-1
// of their index (one low position below s0, one high position above):
// they exchange only among themselves in these stages. A block holds
// 2^log_slots such tiles ("slots"), the same low position of several
// transforms or high positions, so one copy of the tile's twiddles in
// shared memory serves them all; slots past the batch are padding, never
// read or written. The block's E = slots * T elements sit in shared memory
// as N rows of 32-bit limbs (at N = 12 and 1024 elements, with their
// twiddles, 96 KB of the 227 KB a block may hold).
//
// Each thread holds the two elements of one butterfly a stage, read from
// and written back to shared memory, with a barrier after each stage. A
// CIOS product is a chain of ~130 dependent multiply-adds; a scheduler
// fills its multiplier from the chains of many warps, so the kernel keeps
// as many threads as the work has butterflies and blocks small (256
// elements; pass_plan): holding 4 or 8 elements a thread and running 2 or
// 3 stages in registers between exchanges measured slower at every batch
// the prove runs (fewer warps, more registers; PERF.md). Which bits of E
// a stage's threads take is a host plan per stage
// (ntt_pallas.thread_maps): the butterfly bit t is the thread's own, and
// the 32 lanes of a warp sit on bits of E below 10 that are distinct mod
// 5, so that with the XOR fold sw(i) = i ^ ((i >> 5) & 31) of every shared
// index the lanes of a warp hit 32 banks (data and twiddles alike; a
// twiddle's index shares the bits of its element below the stage).
// Twiddles: stage t of the tile at index (1 << t) | j, j < 2^t, loaded
// once a block from the host's (n-1, 8) table (stage s's 2^s powers of
// w_(2^(s+1)) at offset 2^s - 1, 32 B per twiddle).
//
// A block's tiles arrive as 16-byte loads (int64 words, or scratch and
// twiddles as 4 limbs), kInFlight in flight a thread before any is stored
// to shared memory: loads issued one after another would each wait out
// the device memory's latency.
//
// The first pass gathers the int64 16-bit-limb input in bit-reversed order
// (the reference left the bit reversal to XLA); passes between them write
// and read an element-major 32-bit scratch (batch, n, N) in place, 4N B an
// element (a whole sector at N = 8) whatever the tile's stride; the last pass writes
// int64 limbs. Every butterfly computes the plain version's u = x_o*w,
// x_e + u, x_e - u on canonical residues, stage after stage, so kernel and
// plain outputs agree limb for limb.
//
// Interface: a plain C function (ctypes) per pass, launched on the
// caller's stream; it returns a CUDA error code: cudaGetLastError() right
// after the launch, or cudaErrorInvalidValue for a plan it refuses.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kMaxStages = 10;    // stages a pass (T <= 1024)
constexpr int kMaxElems = 1024;   // elements a block (E), 2 a thread
constexpr int kMaxTidBits = 9;    // log2(kMaxElems / 2)
constexpr int kInFlight = 8;      // 16-byte loads a thread issues before it stores any

struct NttPass {
  int logn, s0, S, log_slots, batch, ntid;
  int tpos[kMaxStages][kMaxTidBits];  // stage t: the bit of E that bit k of the thread index sets
};

__device__ __forceinline__ int sw(int i) { return i ^ ((i >> 5) & 31); }

// four limbs into four limb rows of stride `stride`
__device__ __forceinline__ void put4(uint32_t* dst, int stride, const uint4& w) {
  dst[0] = w.x;
  dst[stride] = w.y;
  dst[2 * stride] = w.z;
  dst[3 * stride] = w.w;
}

// Copy of `count` items: each thread issues up to kInFlight loads
// (load(i, v) -> false for an item it skips) before it stores any.
template <class V, class Load, class Store>
__device__ __forceinline__ void staged_copy(int count, Load load, Store store) {
  for (int base = threadIdx.x; base < count; base += kInFlight * blockDim.x) {
    V v[kInFlight];
    bool ok[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * blockDim.x;
      ok[u] = i < count && load(i, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (ok[u]) store(base + u * blockDim.x, v[u]);
  }
}

// Stage t of the pass over the block's elements in shared memory (xs: N
// limb rows of stride LS; ws: the tile's twiddles, N rows of stride LT):
// each thread the butterfly of its element E0 (bit t clear) and E0 + 2^t.
template <int N>
__device__ __forceinline__ void ntt_stage(uint32_t* xs, const uint32_t* ws, int LS, int LT, int t, int ntid,
                                          const int* tpos, const FieldParams<N>& P) {
  int e0 = 0;
#pragma unroll
  for (int k = 0; k < kMaxTidBits; ++k)
    if (k < ntid) e0 |= ((threadIdx.x >> k) & 1) << tpos[k];
  const int i0 = sw(e0), i1 = sw(e0 | (1 << t));
  const int ti = sw((1 << t) | (e0 & ((1 << t) - 1)));
  Fq<N> xe, xo, w;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    xe.v[l] = xs[l * LS + i0];
    xo.v[l] = xs[l * LS + i1];
    w.v[l] = ws[l * LT + ti];
  }
  const Fq<N> u = mont_mul(xo, w, P);
  const Fq<N> ye = add(xe, u, P);
  const Fq<N> yo = sub(xe, u, P);
#pragma unroll
  for (int l = 0; l < N; ++l) {
    xs[l * LS + i0] = ye.v[l];
    xs[l * LS + i1] = yo.v[l];
  }
}

// (transform, global index) of block element E; false for a padding slot
__device__ __forceinline__ bool locate(const NttPass& pp, int E, size_t& bat, size_t& g) {
  const int s1 = pp.s0 + pp.S;
  const int hi_bits = pp.logn - s1;
  const size_t pair = ((size_t)(blockIdx.x >> pp.s0) << pp.log_slots) | (size_t)(E >> pp.S);
  bat = pair >> hi_bits;
  const size_t hi = pair & (((size_t)1 << hi_bits) - 1);
  const size_t lo = (size_t)blockIdx.x & (((size_t)1 << pp.s0) - 1);
  g = (hi << s1) | ((size_t)(E & ((1 << pp.S) - 1)) << pp.s0) | lo;
  return bat < (size_t)pp.batch;
}

// src: int64 16-bit limbs (the first pass, bit-reversed gather) or the
// 32-bit scratch; dst: int64 limbs (the last pass) or the scratch. An
// element is N limbs, kQ = N/4 16-byte quads of the scratch or the
// twiddle table.
template <int N>
__global__ void __launch_bounds__(kMaxElems / 2)
    ntt_pass_kernel(const void* src, void* dst, const uint32_t* __restrict__ tw, bool in_wide,
                    bool out_wide, NttPass pp, FieldParams<N> P) {
  constexpr int kQ = N / 4;
  extern __shared__ uint32_t ntt_smem[];
  const int T = 1 << pp.S;
  const int nE = T << pp.log_slots;
  const int LS = nE + 4, LT = T + 4;  // row strides: 4 mod 32 spreads a chunk's limbs over banks
  uint32_t* xs = ntt_smem;
  uint32_t* ws = ntt_smem + N * LS;
  const size_t n = (size_t)1 << pp.logn;

  if (in_wide) {  // one item per (element, limb): 16 B of int64 words
    const int64_t* x = static_cast<const int64_t*>(src);
    staged_copy<longlong2>(
        nE * N,
        [&](int i, longlong2& w) {
          size_t bat, g;
          if (!locate(pp, i / N, bat, g)) return false;
          const size_t gs = __brevll(g) >> (64 - pp.logn);  // bit-reversed source
          w = __ldg(reinterpret_cast<const longlong2*>(x + (bat * n + gs) * (2 * N)) + i % N);
          return true;
        },
        [&](int i, const longlong2& w) { xs[(i % N) * LS + sw(i / N)] = (uint32_t)w.x | ((uint32_t)w.y << 16); });
  } else {  // one item per quad of an element: 16 B of 32-bit limbs
    const uint32_t* x = static_cast<const uint32_t*>(src);
    staged_copy<uint4>(
        nE * kQ,
        [&](int i, uint4& w) {
          size_t bat, g;
          if (!locate(pp, i / kQ, bat, g)) return false;
          w = *reinterpret_cast<const uint4*>(x + (bat * n + g) * N + 4 * (i % kQ));
          return true;
        },
        [&](int i, const uint4& w) { put4(xs + 4 * (i % kQ) * LS + sw(i / kQ), LS, w); });
  }
  {  // the tile's twiddles, one item per quad of a twiddle (index 0 is unused)
    const size_t lo = (size_t)blockIdx.x & (((size_t)1 << pp.s0) - 1);
    staged_copy<uint4>(
        T * kQ,
        [&](int i, uint4& w) {
          const int ti = i / kQ;
          if (ti == 0) return false;
          const int t = 31 - __clz(ti);
          const size_t j = ((size_t)(ti - (1 << t)) << pp.s0) | lo;
          w = __ldg(reinterpret_cast<const uint4*>(tw + ((((size_t)1 << (pp.s0 + t)) - 1 + j) * N)) + i % kQ);
          return true;
        },
        [&](int i, const uint4& w) { put4(ws + 4 * (i % kQ) * LT + sw(i / kQ), LT, w); });
  }
  __syncthreads();

#pragma unroll 1
  for (int t = 0; t < pp.S; ++t) {
    ntt_stage<N>(xs, ws, LS, LT, t, pp.ntid, pp.tpos[t], P);
    __syncthreads();
  }

  // the stores, staged the same way: shared reads first, then the stores
  if (out_wide) {
    longlong2* y = static_cast<longlong2*>(dst);
    staged_copy<uint32_t>(
        nE * N,
        [&](int i, uint32_t& v) {
          v = xs[(i % N) * LS + sw(i / N)];
          return true;
        },
        [&](int i, const uint32_t& v) {
          size_t bat, g;
          if (locate(pp, i / N, bat, g)) y[(bat * n + g) * N + i % N] = make_longlong2(v & 0xFFFFu, v >> 16);
        });
  } else {
    uint32_t* y = static_cast<uint32_t*>(dst);
    staged_copy<uint4>(
        nE * kQ,
        [&](int i, uint4& w) {
          const uint32_t* r = xs + 4 * (i % kQ) * LS + sw(i / kQ);
          w = make_uint4(r[0], r[LS], r[2 * LS], r[3 * LS]);
          return true;
        },
        [&](int i, const uint4& w) {
          size_t bat, g;
          if (locate(pp, i / kQ, bat, g)) *reinterpret_cast<uint4*>(y + (bat * n + g) * N + 4 * (i % kQ)) = w;
        });
  }
}

template <int N>
int launch_ntt(const int64_t* x, int64_t* y, uint32_t* scratch, const uint32_t* tw, const NttPass& pp,
               size_t blocks, const uint32_t* p, const uint32_t* one, uint32_t n0, cudaStream_t stream) {
  // the largest block: 1024 elements and a 1024-twiddle tile, above the 48 KB default
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(ntt_pass_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               2 * N * (kMaxElems + 4) * (int)sizeof(uint32_t));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const FieldParams<N> P = make_params<N>(p, one, n0, 0);
  const bool in_wide = pp.s0 == 0;
  const bool out_wide = pp.s0 + pp.S == pp.logn;
  const int T = 1 << pp.S;
  const size_t smem = (size_t)N * ((T << pp.log_slots) + 4 + T + 4) * sizeof(uint32_t);
  ntt_pass_kernel<N><<<(unsigned)blocks, 1 << pp.ntid, smem, stream>>>(
      in_wide ? (const void*)x : (const void*)scratch, out_wide ? (void*)y : (void*)scratch, tw, in_wide,
      out_wide, pp, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass, stages [s0, s1) of a 2^logn transform over `batch` arrays, in
// blocks of 2^log_slots tiles of 2^(s1 - s0) elements; `tpos` holds, for
// each stage t of the pass, kMaxTidBits ints: the bit of the block's
// element index that each bit of the thread index sets (the others 0), as
// ntt_pallas.thread_maps gives them. The first pass (s0 == 0) reads x,
// (batch, n, 16) int64 16-bit limbs in natural order, bit-reversing it;
// the last (s1 == logn) writes y, same layout; other ends use scratch,
// (batch, n, n32) u32, in place. tw: (n-1, n32) u32 twiddles. n32: 32-bit
// limbs per element, 8 or 12 (x and y hold 2*n32 int64 words an element).
int zkt_ntt_pass(const int64_t* x, int64_t* y, uint32_t* scratch, const uint32_t* tw, int batch,
                 int logn, int s0, int s1, int log_slots, const int* tpos, int n32, const uint32_t* p,
                 const uint32_t* one, uint32_t n0, void* stream) {
  NttPass pp;
  pp.logn = logn;
  pp.s0 = s0;
  pp.S = s1 - s0;
  pp.log_slots = log_slots;
  pp.batch = batch;
  pp.ntid = pp.S + log_slots - 1;
  const int nbits = pp.S + log_slots;
  if (batch < 1 || s0 < 0 || pp.S < 1 || pp.S > kMaxStages || s1 > logn || logn > 40 || log_slots < 0 ||
      nbits > 10 || (n32 != 8 && n32 != 12))
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < pp.S; ++t) {
    unsigned seen = 1u << t;  // the stage's own bit, then each thread bit once
    for (int k = 0; k < kMaxTidBits; ++k) {
      const int b = tpos[t * kMaxTidBits + k];
      pp.tpos[t][k] = k < pp.ntid ? b : 0;
      if (k >= pp.ntid) continue;
      if (b < 0 || b >= nbits || (seen >> b) & 1u) return (int)cudaErrorInvalidValue;
      seen |= 1u << b;
    }
  }
  const size_t pairs = (size_t)batch << (logn - s1);
  const size_t blocks = ((pairs + ((size_t)1 << log_slots) - 1) >> log_slots) << s0;
  if (blocks >= (1u << 31)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n32 == 8) return launch_ntt<8>(x, y, scratch, tw, pp, blocks, p, one, n0, s);
  return launch_ntt<12>(x, y, scratch, tw, pp, blocks, p, one, n0, s);
}

}  // extern "C"
