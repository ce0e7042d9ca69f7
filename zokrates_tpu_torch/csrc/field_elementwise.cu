// Elementwise field kernels for Hopper (sm_90a): emul and ereduce_wide.
//
// emul_kernel replaces the JAX package's Pallas elementwise product
// (zokrates_tpu/kernels/pallas_field.py: _emul_call / emul): one Montgomery
// product a*b*R^-1 mod p per element, at N = 8 or 12 32-bit limbs.
// ereduce_kernel replaces its lazy-sum reduction (_ereduce_call /
// ereduce_wide): a carry sweep of the column sums gives 16-bit limbs res
// and a carry out, and res*R + carry*(2^256*R mod p), each part through
// one Montgomery product, folds the value back into the canonical residue
// in [0, p).
//
// What bounds them on an H100: bytes. The public tensors are int64 words
// holding 16-bit limbs (the layout of the plain field ops), 16N B per
// element against its 4N B of payload. An emul reads two operands and
// writes one, 384 B at N = 8, against one CIOS product (264 32-bit
// multiplies): at 3.35 TB/s and 16.75e12 multiplies/s the bytes take about
// 7x longer than the multiplies (4.5x at N = 12); ereduce_wide moves 256 B
// per element for two products. A narrower public layout is a later change.
//
// emul's design, for a byte-bound kernel: a block of kEmulThreads threads
// walks tiles of kEmulTile consecutive elements of one batch row, tile
// blockIdx.x, then every gridDim.x-th after it (the grid is as many blocks
// as fit on the card at once, so every block stays resident). Each tile's
// operands travel as 16-byte cp.async copies, consecutive threads on
// consecutive 16 B of device memory, into shared memory; two buffers per
// block, so the next tile's copy is in flight while the current one
// multiplies. In shared memory 16 bytes hold one 32-bit limb (its two
// int64 words); chunk c of tile element e sits at e*N + (c ^ swz(e)), so
// the threads of a quarter warp, each reading chunk c of its own element,
// hit eight distinct 16-byte bank groups (swz: e mod 8 at N = 8, (e/2) mod
// 4 at N = 12, both permuting c within an aligned group of 8 or 4 chunks).
// Each thread multiplies kEmulPerThread elements with the inlined
// mont_mul, their chains independent, and writes the products over a's
// chunks, from where the tile leaves as 16-byte stores, coalesced like the
// loads. b takes two forms: rows in a tile of its own (shared by the batch
// with a batch stride of 0, or one row per batch element), or one element
// per batch row (row stride 0: n^-1, Z(g)^-1, R^2), read once a tile into
// registers. a takes any batch stride (a[:, i] of a larger tensor is read
// in place); the last tile of a row may be short.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns a CUDA error code: cudaGetLastError() right after its
// launch, or the error of an argument it refuses.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kThreads = 256;     // ereduce_kernel
constexpr int kWords = 2 * NL;    // int64 words per 8-limb element
constexpr int kEmulThreads = 64;  // emul_kernel's block
constexpr int kEmulPerThread = 2;
constexpr int kEmulTile = kEmulThreads * kEmulPerThread;  // elements a tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// shared-memory slot of chunk c (limb c) of tile element e
template <int N>
__device__ __forceinline__ int chunk_slot(int e, int c) {
  static_assert(N % 4 == 0, "the swizzle permutes aligned groups of 4 chunks");
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
  constexpr int kChunks = kEmulTile * N;
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

template <int N, bool B_ROW>
__global__ void __launch_bounds__(kEmulThreads) emul_kernel(const int64_t* __restrict__ a,
                                                             const int64_t* __restrict__ b,
                                                             int64_t* __restrict__ out, long long L,
                                                             long long tiles_per_row, long long ntiles,
                                                             long long a_bs, long long b_bs,
                                                             FieldParams<N> P) {
  extern __shared__ __align__(16) longlong2 emul_smem[];
  constexpr int kChunks = kEmulTile * N;        // 16-byte chunks of one operand's tile
  constexpr int kBuf = (B_ROW ? 1 : 2) * kChunks;  // one buffer: a's tile, then b's
  long long tile = blockIdx.x;
  if (tile >= ntiles) return;
  {
    const long long bi = tile / tiles_per_row;
    const long long r0 = (tile - bi * tiles_per_row) * kEmulTile;
    issue_tile<N, B_ROW>(emul_smem, a, b, bi, r0, (int)min((long long)kEmulTile, L - r0), a_bs, b_bs);
  }
  cp_async_commit();
  int stage = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < ntiles) {
      const long long bi = next / tiles_per_row;
      const long long r0 = (next - bi * tiles_per_row) * kEmulTile;
      issue_tile<N, B_ROW>(emul_smem + (stage ^ 1) * kBuf, a, b, bi, r0,
                           (int)min((long long)kEmulTile, L - r0), a_bs, b_bs);
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies (all but the group just committed)
    __syncthreads();

    const long long bi = tile / tiles_per_row;
    const long long r0 = (tile - bi * tiles_per_row) * kEmulTile;
    const int cnt = (int)min((long long)kEmulTile, L - r0);
    longlong2* ta = emul_smem + stage * kBuf;
    // slots past cnt hold stale bytes: their products are computed and never stored
    Fq<N> x[kEmulPerThread], y[kEmulPerThread];
#pragma unroll
    for (int k = 0; k < kEmulPerThread; ++k) {
      const int e = threadIdx.x + k * kEmulThreads;
      x[k] = load_slots<N>(ta, e);
      if constexpr (B_ROW)
        y[k] = load_wide<N>(b + bi * b_bs);
      else
        y[k] = load_slots<N>(ta + kChunks, e);
    }
#pragma unroll
    for (int k = 0; k < kEmulPerThread; ++k) x[k] = mont_mul(x[k], y[k], P);
#pragma unroll
    for (int k = 0; k < kEmulPerThread; ++k) {
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
int launch_emul(const int64_t* a, const int64_t* b, int64_t* out, long long B, long long L,
                long long a_bs, long long b_bs, const uint32_t* p, const uint32_t* one, uint32_t n0,
                cudaStream_t stream) {
  constexpr size_t smem = 2 * (B_ROW ? 1 : 2) * kEmulTile * N * sizeof(longlong2);
  // blocks resident on the card at once, found on the first launch
  static long long max_grid = 0;
  if (max_grid == 0) {
    cudaError_t e = cudaFuncSetAttribute(emul_kernel<N, B_ROW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0, dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, emul_kernel<N, B_ROW>,
                                                                            kEmulThreads, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    max_grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  }
  const FieldParams<N> P = make_params<N>(p, one, n0, 0);
  const long long tiles_per_row = (L + kEmulTile - 1) / kEmulTile;
  const long long ntiles = B * tiles_per_row;
  const unsigned grid = (unsigned)(ntiles < max_grid ? ntiles : max_grid);
  emul_kernel<N, B_ROW><<<grid, kEmulThreads, smem, stream>>>(a, b, out, L, tiles_per_row, ntiles, a_bs,
                                                              b_bs, P);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads) ereduce_kernel(const int64_t* __restrict__ t,
                                                            int64_t* __restrict__ out,
                                                            long long total, Fq8 r2, FieldParams8 P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const longlong2* src = reinterpret_cast<const longlong2*>(t + i * kWords);
  // carry sweep: nonnegative words < 2^63 never overflow the 64-bit carry
  uint64_t c = 0;
  Fq8 res;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const longlong2 w = __ldg(src + k);
    c += (uint64_t)w.x;
    const uint32_t lo = (uint32_t)c & 0xFFFFu;
    c >>= 16;
    c += (uint64_t)w.y;
    const uint32_t hi = (uint32_t)c & 0xFFFFu;
    c >>= 16;
    res.v[k] = lo | (hi << 16);
  }
  Fq8 emb;
  set_zero(emb);
  emb.v[0] = (uint32_t)c;
  emb.v[1] = (uint32_t)(c >> 32);
  // res * (R mod p) * R^-1 = res mod p; carry * (R^2 mod p) * R^-1 = carry * 2^256 mod p
  store_wide(out + i * kWords, add(mul(res, P.one, P), mul(emb, r2, P), P));
}

unsigned grid_of(long long total) { return (unsigned)((total + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Elements a tile of emul_kernel: kernels/pallas_field.EMUL_TILE must match.
int zkt_emul_tile() { return kEmulTile; }

// a: (B, L) elements of n32 32-bit limbs (2*n32 int64 words each) at
// a + bi*a_bs + r*2*n32, rows packed; b at b + bi*b_bs + r*b_rs, with b_rs
// either 2*n32 (packed rows) or 0 (one element per batch row); out: (B, L)
// elements, packed. Strides in int64 words; a_bs and b_bs may be 0, and
// every element starts on 16 bytes. n32 is 8 or 12.
int zkt_emul(const int64_t* a, const int64_t* b, int64_t* out, long long B, long long L,
             long long a_bs, long long b_bs, long long b_rs, int n32, const uint32_t* p,
             const uint32_t* one, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b_rs != 0 && b_rs != 2 * n32) return (int)cudaErrorInvalidValue;
  if (n32 == 8)
    return b_rs == 0 ? launch_emul<8, true>(a, b, out, B, L, a_bs, b_bs, p, one, n0, s)
                     : launch_emul<8, false>(a, b, out, B, L, a_bs, b_bs, p, one, n0, s);
  if (n32 == 12)
    return b_rs == 0 ? launch_emul<12, true>(a, b, out, B, L, a_bs, b_bs, p, one, n0, s)
                     : launch_emul<12, false>(a, b, out, B, L, a_bs, b_bs, p, one, n0, s);
  return (int)cudaErrorInvalidValue;
}

// t, out: `total` packed elements; r2 = R^2 mod p as NL 32-bit limbs.
int zkt_ereduce_wide(const int64_t* t, int64_t* out, long long total, const uint32_t* r2,
                     const uint32_t* p, const uint32_t* one, uint32_t n0, void* stream) {
  const FieldParams8 P = make_params<NL>(p, one, n0, 0);
  Fq8 r2v;
  for (int i = 0; i < NL; ++i) r2v.v[i] = r2[i];
  ereduce_kernel<<<grid_of(total), kThreads, 0, (cudaStream_t)stream>>>(t, out, total, r2v, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
