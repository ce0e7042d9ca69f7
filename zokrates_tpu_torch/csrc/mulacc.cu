// Sparse-matvec multiply-accumulate walk for Hopper (sm_90a): mulacc_kernel.
//
// Replaces the JAX package's Pallas kernel of the same walk
// (zokrates_tpu/kernels/pallas_field.py: _mulacc_call / mulacc_walk),
// together with the gathers around it. The prover evaluates A·z, B·z and
// C·z over one row-sorted stream of COO records
// (ir/r1cs_device.build_mulacc_walk); lane m owns K consecutive records.
// For each record the lane gathers z[col], takes one Montgomery product
// coeff*z, and adds it limb by limb without carries into its 16-bit-limb
// accumulator; after a record whose flush flag is set (the last record of
// a row's run in the lane, or of the lane) it writes the accumulator to
// the record's flush slot and resets it. The caller reduces the slots and
// sums them per row.
//
// What bounds it on an H100 (PERF.md): at B = 16 proofs the products (one
// N-limb CIOS product, 264 32-bit multiplies at N = 8, 588 at N = 12, a
// proof and record); at B = 1 the bytes: z once (16N B a variable), the
// packed coefficients (4N B a record), cols and flags (4 B each) and the
// flushed sums (16N B a slot).
//
// Widths: N = 8 32-bit limbs (the 254/255-bit scalar fields) and N = 12
// (BW6-761's 377-bit scalar field); the C entry point takes N. The lazy
// sums' headroom does not depend on N: each 16-bit limb of a product adds
// below 2^16 to its own 32-bit word, so K <= 2^16 records a lane keep
// every word exact at any width, and the plan's MAX_ROW_TERMS = 2^15
// (ir/r1cs_device.py) keeps the sums below 2^31, as ereduce_wide takes
// them.
//
// Design. A first launch packs z's 16-bit limbs into 32-bit ones (32 B an
// element at N = 8, 2 loads to gather instead of 8; 16 sha256 proofs' z is
// 14 MB, within L2). Then one thread per (proof, lane) loops over the lane's K
// records, the 2N limb sums in registers as 32-bit words (exact for K <=
// 2^16; the wrapper checks). The plan's lane count sets the parallelism:
// groth16.walk_lanes takes lanes of few records, so even one proof has
// threads enough for 132 SMs. Blocks are proof-major, so the proofs in
// flight at once keep their z in L2, and at B >= 2 a block's warps walk
// the same 32 lanes for up to 4 proofs, so the plan's words they share
// come mostly from L1. The plan's arrays are lane-minor ([record][lane],
// coefficients [record][32-bit limb][lane]), so a warp loads 32
// consecutive words of each. The record after the current one is loaded
// while the current one multiplies (its column two records ahead). The
// product is the inlined mont_mul in N x 32-bit limbs (R = 2^(32N) in both
// layouts), split back into 16-bit limbs before the add, so the sums equal
// the plain version's, which adds 16-bit-limb products. Records past the
// stream's end (the padding: coefficient 0) take no product. A lane's
// flushes are consecutive slots, from lane_base[m] on; a warp's flushes
// of one record step leave through shared memory as whole 128-byte slots
// (flush_warp; 2N words a slot). Slots past the last flush (the padding of the slot count)
// are zeroed by the threads, M slots apart.
//
// Interface: a plain C function (ctypes), launched on the caller's
// stream; it returns cudaGetLastError() right after its launches, or the
// error of an argument it refuses.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kThreads = 128;           // a block: 4 warps
constexpr int kMaxProofsPerBlock = 4;   // a block's warps: up to 4 proofs on the same lanes

template <int N>
__device__ __forceinline__ Fq<N> load_coeff(const uint32_t* coeff, size_t k, size_t M, size_t m) {
  Fq<N> c;
#pragma unroll
  for (int i = 0; i < N; ++i) c.v[i] = __ldg(coeff + (k * N + i) * M + m);
  return c;
}

// element `col` of one proof's packed z: its 4N B as N/4 16-byte loads
template <int N>
__device__ __forceinline__ Fq<N> load_z(const uint4* zb, int col) {
  Fq<N> x;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const uint4 w = __ldg(zb + (size_t)(N / 4) * col + j);
    x.v[4 * j] = w.x;
    x.v[4 * j + 1] = w.y;
    x.v[4 * j + 2] = w.z;
    x.v[4 * j + 3] = w.w;
  }
  return x;
}

template <int N>
__device__ __forceinline__ void store_sums(int64_t* dst, const uint32_t* acc) {
  longlong2* v = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = make_longlong2(acc[2 * i], acc[2 * i + 1]);
}

// z's 16-bit limbs (int64 words) -> 32-bit limbs, one limb a thread: 16
// coalesced bytes in, 4 out
__global__ void __launch_bounds__(kThreads) pack_kernel(const longlong2* __restrict__ z, uint32_t* __restrict__ zp,
                                                         long long limbs) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= limbs) return;
  const longlong2 w = __ldg(z + i);
  zp[i] = (uint32_t)w.x | ((uint32_t)w.y << 16);
}

// Staging-buffer word of word w (0..2N-1) of entry e, in chunks of 4
// words (N/2 an entry). N = 8: chunk w / 4 sits at chunk (w / 4) ^ ((e / 2)
// mod 4) of the entry's four, so eight entries' chunk j (a quarter warp's
// 16-byte writes) fall on eight distinct bank groups. N = 12: the entry's
// six chunks rotate by e / 2, a bijection within the entry.
template <int N>
__device__ __forceinline__ int stage_word(int e, int w) {
  constexpr int kC = N / 2;
  const int c = (kC == 4) ? ((w >> 2) ^ ((e >> 1) & 3)) : (((w >> 2) + (e >> 1)) % kC);
  return e * 2 * N + ((c << 2) | (w & 3));
}

// The warp's flushes of one record step, written out coalesced: each
// flushing thread leaves its 2N sums in its warp's staging buffer (entry
// e = its rank among the warp's flushing threads, stage_word) with its
// slot, and resets them; then the warp stores the entries as int64
// words, 32 a store (at N = 8 two whole 128-byte slots).
template <int N>
__device__ __forceinline__ void flush_warp(bool flush, uint32_t* acc, size_t slot, uint32_t* wb, int* ws,
                                           int64_t* ob) {
  constexpr int kWords = 2 * N;
  const unsigned fl = __ballot_sync(0xFFFFFFFFu, flush);
  if (fl == 0) return;
  const int lane = threadIdx.x & 31;
  if (flush) {
    const int e = __popc(fl & ((1u << lane) - 1));
#pragma unroll
    for (int j = 0; j < kWords / 4; ++j)
      *reinterpret_cast<uint4*>(wb + stage_word<N>(e, 4 * j)) = make_uint4(acc[4 * j], acc[4 * j + 1],
                                                                             acc[4 * j + 2], acc[4 * j + 3]);
    ws[e] = (int)slot;
#pragma unroll
    for (int i = 0; i < kWords; ++i) acc[i] = 0;
  }
  __syncwarp();
  const int nf = __popc(fl);
  for (int q = lane; q < nf * kWords; q += 32) {
    const int e = q / kWords, w = q - e * kWords;
    ob[(size_t)ws[e] * kWords + w] = (int64_t)wb[stage_word<N>(e, w)];
  }
  __syncwarp();
}

// A block is kThreads / 32 warps: pb proofs (a power of two <= 4) times
// 4 / pb chunks of 32 lanes; warp w takes proof g*pb + w % pb of block
// group g = blockIdx.x / (M / lanes a block), so the warps of a block that
// share lanes read the same plan words, mostly from L1. Warps past the
// last proof exit.
template <int N>
__global__ void __launch_bounds__(kThreads) mulacc_kernel(const uint32_t* __restrict__ zp, long long m_vars,
                                                           const int32_t* __restrict__ cols,
                                                           const uint32_t* __restrict__ coeff,
                                                           const int32_t* __restrict__ flags,
                                                           const int32_t* __restrict__ lane_base,
                                                           int64_t* __restrict__ out, int B, int pb, int K, int M,
                                                           long long L, int n_flush, int P, FieldParams<N> Pm) {
  constexpr int kWords = 2 * N;  // int64 words (16-bit limbs) per element
  __shared__ __align__(16) uint32_t stage_sums[kThreads / 32][32 * kWords];
  __shared__ int stage_slot[kThreads / 32][32];
  const int warp = threadIdx.x >> 5;
  const int lanes_per_block = kThreads / pb;
  const int lane_blocks = M / lanes_per_block;
  const int g = blockIdx.x / lane_blocks;
  const size_t b = (size_t)g * pb + warp % pb;
  if (b >= (size_t)B) return;
  const int m = (blockIdx.x - g * lane_blocks) * lanes_per_block + (warp / pb) * 32 + (threadIdx.x & 31);
  const size_t Ms = (size_t)M;
  const uint4* zb = reinterpret_cast<const uint4*>(zp + b * (size_t)m_vars * N);
  int64_t* ob = out + b * (size_t)P * kWords;
  const uint32_t zero[kWords] = {};
  for (int s = n_flush + m; s < P; s += M) store_sums<N>(ob + (size_t)s * kWords, zero);

  // records of this lane before the padding
  const long long j0 = (long long)m * K;
  const int kend = (int)max(0LL, min((long long)K, L - j0));
  uint32_t acc[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) acc[i] = 0;
  size_t slot = (size_t)__ldg(lane_base + m);
  // prefetch: the next record's z and coefficient, the column after it;
  // past the lane's real records they read column 0 and the last record,
  // which are never multiplied
  int col = kend > 1 ? __ldg(cols + Ms + m) : 0;
  Fq<N> x = load_z<N>(zb, kend > 0 ? __ldg(cols + m) : 0);
  Fq<N> c = load_coeff<N>(coeff, 0, Ms, m);
  for (int k = 0; k < K; ++k) {
    const Fq<N> xn = load_z<N>(zb, col);
    const Fq<N> cn = load_coeff<N>(coeff, min(k + 1, K - 1), Ms, m);
    col = k + 2 < kend ? __ldg(cols + (size_t)(k + 2) * Ms + m) : 0;
    const int flush = __ldg(flags + (size_t)k * Ms + m);
    if (k < kend) {
      const Fq<N> prod = mont_mul(x, c, Pm);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[2 * i] += prod.v[i] & 0xFFFFu;
        acc[2 * i + 1] += prod.v[i] >> 16;
      }
    }
    flush_warp<N>(flush != 0, acc, slot, stage_sums[warp], stage_slot[warp], ob);
    slot += flush != 0;
    x = xn;
    c = cn;
  }
}

template <int N>
int launch_mulacc(const int64_t* z, uint32_t* zp, long long m_vars, const int32_t* cols, const uint32_t* coeff,
                  const int32_t* flags, const int32_t* lane_base, int64_t* out, int B, int K, int M, long long L,
                  int n_flush, int P, const uint32_t* p, const uint32_t* one, uint32_t n0, cudaStream_t s) {
  const long long limbs = (long long)B * m_vars * N;
  pack_kernel<<<(unsigned)((limbs + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      reinterpret_cast<const longlong2*>(z), zp, limbs);
  const FieldParams<N> Pm = make_params<N>(p, one, n0, 0);
  int pb = 1;  // proofs a block
  while (pb < kMaxProofsPerBlock && 2 * pb <= B) pb *= 2;
  const unsigned grid = (unsigned)((long long)(B + pb - 1) / pb * (M / (kThreads / pb)));
  mulacc_kernel<N><<<grid, kThreads, 0, s>>>(zp, m_vars, cols, coeff, flags, lane_base, out, B, pb, K, M, L,
                                             n_flush, P, Pm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// z: (B, m_vars, 2*n32) int64 Montgomery values (16-bit limbs), contiguous
// and 16-byte aligned; zp: (B, m_vars, n32) 32-bit scratch for their
// packed limbs; the plan's cols (K, M) int32, coeff (K, n32, M) 32-bit
// limbs, flags (K, M) int32, lane_base (M,) int32, all contiguous; out:
// (B, P, 2*n32) int64. L: records before the padding, n_flush: flushes
// before the slots' padding. M a multiple of the block (128), K <= 2^16.
// n32: 32-bit limbs per element, 8 or 12; p and one as n32 little-endian
// 32-bit limbs, n0 = -p^-1 mod 2^32. Two launches: z packed, then the
// walk.
int zkt_mulacc_walk(const int64_t* z, uint32_t* zp, long long m_vars, const int32_t* cols, const uint32_t* coeff,
                    const int32_t* flags, const int32_t* lane_base, int64_t* out, int B, int K, int M,
                    long long L, int n_flush, int P, int n32, const uint32_t* p, const uint32_t* one, uint32_t n0,
                    void* stream) {
  if (M <= 0 || M % kThreads || K <= 0 || K > (1 << 16) || B <= 0 || n_flush > P || m_vars <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n32 == 8)
    return launch_mulacc<8>(z, zp, m_vars, cols, coeff, flags, lane_base, out, B, K, M, L, n_flush, P, p, one, n0, s);
  if (n32 == 12)
    return launch_mulacc<12>(z, zp, m_vars, cols, coeff, flags, lane_base, out, B, K, M, L, n_flush, P, p, one, n0,
                             s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
