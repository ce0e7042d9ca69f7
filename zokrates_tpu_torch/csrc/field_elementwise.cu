// Elementwise field kernels for Hopper (sm_90a): emul and ereduce_wide.
//
// emul_kernel replaces the JAX package's Pallas elementwise product
// (zokrates_tpu/kernels/pallas_field.py: _emul_call / emul): one Montgomery
// product a*b*R^-1 mod p per element, at N = 8, 12 or 24 32-bit limbs (24:
// BW6-761's 761-bit base field, GM17's query points over it).
// ereduce_kernel replaces its lazy-sum reduction (_ereduce_call /
// ereduce_wide): a carry sweep of the column sums gives 16-bit limbs res
// and a carry out, and res*R + carry*(2^(32N)*R mod p), each part through
// one Montgomery product, folds the value back into the canonical residue
// in [0, p); at N = 8 and at N = 12 (BW6-761's scalar field: the walk
// matvec's sums of its Groth16 prover).
//
// What bounds them on an H100: bytes. The public tensors are int64 words
// holding 16-bit limbs (the layout of the plain field ops), 16N B per
// element against its 4N B of payload. An emul reads two operands and
// writes one, 384 B at N = 8, against one CIOS product (264 32-bit
// multiplies): at 3.35 TB/s and 16.75e12 multiplies/s the bytes take about
// 7x longer than the multiplies (4.5x at N = 12; 1.7x at N = 24, where a
// read and a write of 384 B an element, b one row, meet 2,328 multiplies);
// ereduce_wide moves 256 B per element for two products. A narrower public
// layout is a later change.
//
// Both kernels run one tile walk (tile_walk), a byte-bound design: a block
// of kEmulThreads threads walks tiles of emul_tile(N) consecutive elements
// of one batch row, tile blockIdx.x, then every gridDim.x-th after it (the
// grid is as many blocks as fit on the card at once, so every block stays
// resident). Each tile's operands travel as 16-byte cp.async copies,
// consecutive threads on consecutive 16 B of device memory, into shared
// memory; two buffers per block, so the next tile's copy is in flight
// while the current one computes. In shared memory 16 bytes hold one
// 32-bit limb (its two int64 words); chunk c of tile element e sits at e*N
// + (c ^ swz(e)), so the threads of a quarter warp, each reading chunk c
// of its own element, hit eight distinct 16-byte bank groups (swz: e mod 8
// at N = 8 and 24, (e/2) mod 4 at N = 12, permuting c within an aligned
// group of 8 or 4 chunks: one group at 8, three at 24). Each thread
// computes emul_per_thread(N) elements, their chains independent, and
// writes the results over the input's chunks, from where the tile leaves
// as 16-byte stores, coalesced like the loads; the last tile of a row may
// be short.
//
// At 8 and 12 limbs a thread computes 2 elements with the inlined
// mont_mul, a tile is 128 elements and a block's two buffers of a and b
// take 64 or 96 KB of shared memory. At 24 limbs a tile of 128 would take
// 192 KB, one block an SM: there a thread computes 1 element, a tile is 64
// (96 KB with b's tile, 48 KB without), and the product is field.cuh's
// out-of-line mul (a 24-limb CIOS product is 2,328 multiplies; inlined
// twice a thread it would lengthen nvcc's compile for no gain).
//
// emul: b takes two forms: rows in a tile of its own (shared by the batch
// with a batch stride of 0, or one row per batch element), or one element
// per batch row (row stride 0: n^-1, Z(g)^-1, R^2), read once a tile into
// registers. a takes any batch stride (a[:, i] of a larger tensor is read
// in place).
//
// ereduce: one operand, the lazy sums as one row (see EreduceTile for
// its words in shared memory); totals of up to one tile take
// ereduce_lane_kernel, one thread an element, instead.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns a CUDA error code: cudaGetLastError() right after its
// launch, or the error of an argument it refuses.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kEmulThreads = 64;  // a block of the tile walk
// elements a thread computes, and a tile's elements, at N 32-bit limbs
__host__ __device__ constexpr int emul_per_thread(int N) { return N == 24 ? 1 : 2; }
__host__ __device__ constexpr int emul_tile(int N) { return kEmulThreads * emul_per_thread(N); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// shared-memory slot of chunk c (limb c) of tile element e
template <int N>
__device__ __forceinline__ int chunk_slot(int e, int c) {
  static_assert(N % 4 == 0, "the swizzle permutes aligned groups of 4 or 8 chunks");
  const int s = (N % 8 == 0) ? (e & 7) : ((e >> 1) & 3);
  return e * N + (c ^ s);
}

template <int N>
__device__ __forceinline__ Fq<N> load_slots(const longlong2* tile, int e) {
  Fq<N> x;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const longlong2 w = tile[chunk_slot<N>(e, c)];
    x.v[c] = (uint32_t)w.x | ((uint32_t)w.y << 16);
  }
  return x;
}

// Copies the a (and, unless B_ROW, the b) rows of one tile into buffer `buf`.
template <int N, bool B_ROW>
__device__ __forceinline__ void issue_tile(longlong2* buf, const int64_t* a, const int64_t* b,
                                           long long bi, long long r0, int cnt, long long a_bs,
                                           long long b_bs) {
  constexpr int kChunks = emul_tile(N) * N;
  const longlong2* ga = reinterpret_cast<const longlong2*>(a + bi * a_bs + r0 * 2 * N);
  for (int q = threadIdx.x; q < cnt * N; q += kEmulThreads) {
    const int e = q / N;
    cp_async16(buf + chunk_slot<N>(e, q - e * N), ga + q);
  }
  if constexpr (!B_ROW) {
    const longlong2* gb = reinterpret_cast<const longlong2*>(b + bi * b_bs + r0 * 2 * N);
    for (int q = threadIdx.x; q < cnt * N; q += kEmulThreads) {
      const int e = q / N;
      cp_async16(buf + kChunks + chunk_slot<N>(e, q - e * N), gb + q);
    }
  }
}

// The tile walk both kernels run (see the top of the file). Op is one
// kernel's part of it:
//   kOperands         16-byte chunk tiles a tile copies (1 or 2);
//   kOneRow           the operand is one row: a tile's row is 0, not a
//                     64-bit division of the tile by the tiles of a row;
//   issue(buf, bi, r0, cnt)   starts the copies of the cnt elements from
//                     element r0 of batch row bi into buffer buf;
//   compute(ta, bi, x)  the results of this thread's emul_per_thread(N)
//                     elements (threadIdx.x + k*kEmulThreads) of the tile
//                     in buffer ta, into x.
// The results go back over the tile's first operand as 16-bit limbs and
// leave from there; slots past cnt hold stale bytes, and their results are
// computed and never stored.
template <class Op>
__device__ __forceinline__ long long tile_row(long long tile, long long tiles_per_row) {
  if constexpr (Op::kOneRow)
    return 0;
  else
    return tile / tiles_per_row;
}

template <int N, class Op>
__device__ __forceinline__ void tile_walk(const Op& op, int64_t* __restrict__ out, long long L,
                                          long long tiles_per_row, long long ntiles) {
  extern __shared__ __align__(16) longlong2 tile_smem[];
  constexpr int kTile = emul_tile(N), kPerThread = emul_per_thread(N);
  constexpr int kBuf = Op::kOperands * kTile * N;  // one buffer: the operands' tiles
  long long tile = blockIdx.x;
  if (tile >= ntiles) return;
  {
    const long long bi = tile_row<Op>(tile, tiles_per_row);
    const long long r0 = (tile - bi * tiles_per_row) * kTile;
    op.issue(tile_smem, bi, r0, (int)min((long long)kTile, L - r0));
  }
  cp_async_commit();
  int stage = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < ntiles) {
      const long long bi = tile_row<Op>(next, tiles_per_row);
      const long long r0 = (next - bi * tiles_per_row) * kTile;
      op.issue(tile_smem + (stage ^ 1) * kBuf, bi, r0, (int)min((long long)kTile, L - r0));
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies (all but the group just committed)
    __syncthreads();

    const long long bi = tile_row<Op>(tile, tiles_per_row);
    const long long r0 = (tile - bi * tiles_per_row) * kTile;
    const int cnt = (int)min((long long)kTile, L - r0);
    longlong2* ta = tile_smem + stage * kBuf;
    Fq<N> x[kPerThread];
    op.compute(ta, bi, x);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = threadIdx.x + k * kEmulThreads;
#pragma unroll
      for (int c = 0; c < N; ++c) ta[chunk_slot<N>(e, c)] = make_longlong2(x[k].v[c] & 0xFFFFu, x[k].v[c] >> 16);
    }
    __syncthreads();

    longlong2* go = reinterpret_cast<longlong2*>(out + (bi * L + r0) * 2 * N);
    for (int q = threadIdx.x; q < cnt * N; q += kEmulThreads) {
      const int e = q / N;
      go[q] = ta[chunk_slot<N>(e, q - e * N)];
    }
    __syncthreads();  // the buffer is the copy target two tiles on
    stage ^= 1;
  }
}

template <int N, bool B_ROW>
struct EmulTile {
  static constexpr int kOperands = B_ROW ? 1 : 2;  // a's tile, then b's
  static constexpr bool kOneRow = false;
  const int64_t* a;
  const int64_t* b;
  long long a_bs, b_bs;
  FieldParams<N> P;

  __device__ __forceinline__ void issue(longlong2* buf, long long bi, long long r0, int cnt) const {
    issue_tile<N, B_ROW>(buf, a, b, bi, r0, cnt, a_bs, b_bs);
  }

  __device__ __forceinline__ void compute(const longlong2* ta, long long bi, Fq<N>* x) const {
    constexpr int kPerThread = emul_per_thread(N);
    Fq<N> y[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = threadIdx.x + k * kEmulThreads;
      x[k] = load_slots<N>(ta, e);
      if constexpr (B_ROW)
        y[k] = load_wide<N>(b + bi * b_bs);
      else
        y[k] = load_slots<N>(ta + emul_tile(N) * N, e);
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if constexpr (N == 24)
        x[k] = mul(x[k], y[k], P);
      else
        x[k] = mont_mul(x[k], y[k], P);
    }
  }
};

template <int N, bool B_ROW>
__global__ void __launch_bounds__(kEmulThreads) emul_kernel(const int64_t* __restrict__ a,
                                                             const int64_t* __restrict__ b,
                                                             int64_t* __restrict__ out, long long L,
                                                             long long tiles_per_row, long long ntiles,
                                                             long long a_bs, long long b_bs,
                                                             FieldParams<N> P) {
  tile_walk<N>(EmulTile<N, B_ROW>{a, b, a_bs, b_bs, P}, out, L, tiles_per_row, ntiles);
}

// ereduce's carry sweep over an element's 2N column sums, word pair
// (2i, 2i + 1) = word(i): the 16-bit limbs into res, the carry out
// returned. Nonnegative words < 2^63 never overflow the 64-bit carry.
template <int N, class Words>
__device__ __forceinline__ uint64_t carry_sweep(Words word, Fq<N>& res) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const longlong2 w = word(i);
    c += (uint64_t)w.x;
    const uint32_t lo = (uint32_t)c & 0xFFFFu;
    c >>= 16;
    c += (uint64_t)w.y;
    const uint32_t hi = (uint32_t)c & 0xFFFFu;
    c >>= 16;
    res.v[i] = lo | (hi << 16);
  }
  return c;
}

// res + carry * 2^(32N) mod p, canonical: res * (R mod p) * R^-1 = res mod
// p and carry * (R^2 mod p) * R^-1 = carry * R mod p, each a Montgomery
// product.
template <int N>
__device__ __forceinline__ Fq<N> fold_carry(const Fq<N>& res, uint64_t carry, const Fq<N>& r2,
                                            const FieldParams<N>& P) {
  Fq<N> emb;
  set_zero(emb);
  emb.v[0] = (uint32_t)carry;
  emb.v[1] = (uint32_t)(carry >> 32);
  return add(mont_mul(res, P.one, P), mont_mul(emb, r2, P), P);
}

// ereduce on the tile walk, over one operand: the (total,) lazy sums as
// one row. An element's 2N words are full column sums (< 2^47), not 16-bit
// limbs, so they stay 64-bit in shared memory: chunk c of element e is its
// word pair (2c, 2c + 1), at the same chunk_slot as emul's limb c, and the
// carry sweep reads it as one 16-byte word pair. Per quarter warp (the
// unit of a 16-byte shared access) that is emul's access, 8 consecutive
// elements' chunk c, on 8 distinct bank groups.
template <int N>
struct EreduceTile {
  static constexpr int kOperands = 1;
  static constexpr bool kOneRow = true;
  const int64_t* t;
  Fq<N> r2;
  FieldParams<N> P;

  __device__ __forceinline__ void issue(longlong2* buf, long long, long long r0, int cnt) const {
    issue_tile<N, true>(buf, t, nullptr, 0, r0, cnt, 0, 0);
  }

  __device__ __forceinline__ void compute(const longlong2* ta, long long, Fq<N>* x) const {
    constexpr int kPerThread = emul_per_thread(N);
    uint64_t carry[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = threadIdx.x + k * kEmulThreads;
      carry[k] = carry_sweep<N>([&](int i) { return ta[chunk_slot<N>(e, i)]; }, x[k]);
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) x[k] = fold_carry(x[k], carry[k], r2, P);
  }
};

template <int N>
__global__ void __launch_bounds__(kEmulThreads) ereduce_kernel(const int64_t* __restrict__ t,
                                                                int64_t* __restrict__ out, long long total,
                                                                long long ntiles, Fq<N> r2, FieldParams<N> P) {
  tile_walk<N>(EreduceTile<N>{t, r2, P}, out, total, ntiles, ntiles);
}

// The few-element shapes (the corrections' (3, 1) and (1, 3)): one thread
// an element, its words read straight from device memory. Launch latency
// bounds them, and the tile walk's copy through shared memory made them
// slower (PERF.md).
constexpr int kEreduceLaneMax = emul_tile(8);  // totals up to one tile (128 at 8 and 12 limbs)

template <int N>
__global__ void __launch_bounds__(kEreduceLaneMax) ereduce_lane_kernel(const int64_t* __restrict__ t,
                                                                       int64_t* __restrict__ out, long long total,
                                                                       Fq<N> r2, FieldParams<N> P) {
  const long long i = threadIdx.x;
  if (i >= total) return;
  const longlong2* src = reinterpret_cast<const longlong2*>(t + i * 2 * N);
  Fq<N> res;
  const uint64_t carry = carry_sweep<N>([&](int k) { return __ldg(src + k); }, res);
  store_wide(out + i * 2 * N, fold_carry(res, carry, r2, P));
}

// Blocks of `kernel` (kEmulThreads threads, smem bytes of dynamic shared
// memory) resident on the card at once: the grid of a persistent walk.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, long long* blocks) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kEmulThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) *blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return e;
}

template <int N, bool B_ROW>
int launch_emul(const int64_t* a, const int64_t* b, int64_t* out, long long B, long long L,
                long long a_bs, long long b_bs, const uint32_t* p, const uint32_t* one, uint32_t n0,
                cudaStream_t stream) {
  constexpr size_t smem = 2 * (B_ROW ? 1 : 2) * emul_tile(N) * N * sizeof(longlong2);
  // blocks resident on the card at once, found on the first launch
  static long long max_grid = 0;
  if (max_grid == 0) {
    const cudaError_t e = resident_blocks(emul_kernel<N, B_ROW>, smem, &max_grid);
    if (e != cudaSuccess) return (int)e;
  }
  const FieldParams<N> P = make_params<N>(p, one, n0, 0);
  const long long tiles_per_row = (L + emul_tile(N) - 1) / emul_tile(N);
  const long long ntiles = B * tiles_per_row;
  const unsigned grid = (unsigned)(ntiles < max_grid ? ntiles : max_grid);
  emul_kernel<N, B_ROW><<<grid, kEmulThreads, smem, stream>>>(a, b, out, L, tiles_per_row, ntiles, a_bs,
                                                              b_bs, P);
  return (int)cudaGetLastError();
}

// emul at N limbs: b one row (b_rs 0) or packed rows
template <int N>
int emul_at(const int64_t* a, const int64_t* b, int64_t* out, long long B, long long L, long long a_bs,
            long long b_bs, long long b_rs, const uint32_t* p, const uint32_t* one, uint32_t n0,
            cudaStream_t s) {
  return b_rs == 0 ? launch_emul<N, true>(a, b, out, B, L, a_bs, b_bs, p, one, n0, s)
                   : launch_emul<N, false>(a, b, out, B, L, a_bs, b_bs, p, one, n0, s);
}

template <int N>
int launch_ereduce(const int64_t* t, int64_t* out, long long total, const uint32_t* r2, const uint32_t* p,
                   const uint32_t* one, uint32_t n0, cudaStream_t stream) {
  constexpr size_t smem = 2 * emul_tile(N) * N * sizeof(longlong2);
  static long long max_grid = 0;
  if (max_grid == 0 && total > kEreduceLaneMax) {
    const cudaError_t e = resident_blocks(ereduce_kernel<N>, smem, &max_grid);
    if (e != cudaSuccess) return (int)e;
  }
  const FieldParams<N> P = make_params<N>(p, one, n0, 0);
  Fq<N> r2v;
  for (int i = 0; i < N; ++i) r2v.v[i] = r2[i];
  if (total <= kEreduceLaneMax) {
    ereduce_lane_kernel<N><<<1, kEreduceLaneMax, 0, stream>>>(t, out, total, r2v, P);
    return (int)cudaGetLastError();
  }
  const long long ntiles = (total + emul_tile(N) - 1) / emul_tile(N);
  const unsigned grid = (unsigned)(ntiles < max_grid ? ntiles : max_grid);
  ereduce_kernel<N><<<grid, kEmulThreads, smem, stream>>>(t, out, total, ntiles, r2v, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements a tile of emul_kernel at n32 32-bit limbs (0 at a width it has
// no instantiation of): kernels/pallas_field.EMUL_TILE[n32] must match.
int zkt_emul_tile(int n32) { return n32 == 8 || n32 == 12 || n32 == 24 ? emul_tile(n32) : 0; }

// a: (B, L) elements of n32 32-bit limbs (2*n32 int64 words each) at
// a + bi*a_bs + r*2*n32, rows packed; b at b + bi*b_bs + r*b_rs, with b_rs
// either 2*n32 (packed rows) or 0 (one element per batch row); out: (B, L)
// elements, packed. Strides in int64 words; a_bs and b_bs may be 0, and
// every element starts on 16 bytes. n32 is 8, 12 or 24.
int zkt_emul(const int64_t* a, const int64_t* b, int64_t* out, long long B, long long L,
             long long a_bs, long long b_bs, long long b_rs, int n32, const uint32_t* p,
             const uint32_t* one, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b_rs != 0 && b_rs != 2 * n32) return (int)cudaErrorInvalidValue;
  if (n32 == 8) return emul_at<8>(a, b, out, B, L, a_bs, b_bs, b_rs, p, one, n0, s);
  if (n32 == 12) return emul_at<12>(a, b, out, B, L, a_bs, b_bs, b_rs, p, one, n0, s);
  if (n32 == 24) return emul_at<24>(a, b, out, B, L, a_bs, b_bs, b_rs, p, one, n0, s);
  return (int)cudaErrorInvalidValue;
}

// t, out: `total` packed elements of n32 32-bit limbs (2*n32 int64 words
// each, 16-byte aligned); r2 = R^2 mod p as n32 32-bit limbs. n32 is 8 or
// 12.
int zkt_ereduce_wide(const int64_t* t, int64_t* out, long long total, int n32, const uint32_t* r2,
                     const uint32_t* p, const uint32_t* one, uint32_t n0, void* stream) {
  if (n32 == 8) return launch_ereduce<8>(t, out, total, r2, p, one, n0, (cudaStream_t)stream);
  if (n32 == 12) return launch_ereduce<12>(t, out, total, r2, p, one, n0, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
