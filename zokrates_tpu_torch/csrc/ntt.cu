// Radix-2 NTT pass kernel for Hopper (sm_90a).
//
// Replaces the JAX package's whole-transform Pallas NTT
// (zokrates_tpu/kernels/ntt_pallas.py: _kernel_factory / _ntt_call /
// fft_core_pallas): decimation in time over bit-reversed input, stage s
// pairing elements at distance 2^s with the twiddle w_(2^(s+1))^j, over
// (batch, n) Montgomery elements.
//
// What bounds it on an H100: operations, for a transform held on chip (n/2
// Montgomery products per stage, 264 32-bit multiplies each, against 128 B
// read and 128 B written per element once); the passes below add a round
// trip of 32 B per element through device memory per extra pass.
//
// Design. The TPU kernel kept a whole 2^15 transform (2 MB as 16-bit limbs)
// in VMEM for all 15 stages; one block here has at most 227 KB of shared
// memory, and a 2^15 transform is 1 MiB even as 8 x 32-bit limbs. So a
// transform runs as passes of at most log2(T) = 10 stages, each pass one
// launch over tiles of T = 1024 elements held in shared memory (32 KB,
// limb-major so a warp's accesses are conflict-free), one butterfly per
// thread per stage (T/2 = 512 threads). Pass [s0, s1) gives each block the
// 2^(s1-s0) elements that differ in bits s0..s1-1, times C = T/2^(s1-s0)
// consecutive low positions: those elements exchange only among themselves
// in these stages. A transform of 2^k elements takes ceil(k/10) launches:
// 1 up to 2^10, 2 up to 2^20 (the prove's 2^15: stages [0,10) then
// [10,15) with C = 32). The first pass reads the int64 16-bit-limb input
// in bit-reversed order (the reference left the bit reversal to XLA; here
// it is the first pass's gather); passes between write and read a 32-bit
// limb-major scratch (batch, 8, n) in place; the last pass writes int64
// limbs. Twiddles come from the host: stage s's 2^s powers of
// w_(2^(s+1)) at offset 2^s - 1 of one (8, n-1) limb-major u32 table.
// Every butterfly computes the plain version's u = x_o*w, x_e + u, x_e - u
// in canonical residues, so kernel and plain outputs agree limb for limb.
//
// Interface: a plain C function (ctypes) per pass, launched on the
// caller's stream; it returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kMaxLogT = 10;
constexpr int kMaxThreads = 1 << (kMaxLogT - 1);

template <bool IN_WIDE, bool OUT_WIDE>
__global__ void __launch_bounds__(kMaxThreads) ntt_pass_kernel(const void* src, void* dst,
                                                                const uint32_t* __restrict__ tw,
                                                                int logn, int s0, int s1, int logT,
                                                                FieldParams8 P) {
  extern __shared__ uint32_t ntt_smem[];  // [NL][T]
  const int T = 1 << logT;
  const int logC = logT - (s1 - s0);
  const int C = 1 << logC;
  const size_t n = (size_t)1 << logn;
  const size_t tw_n = n - 1;
  const int chunk_bits = s0 - logC;
  const size_t chunk = (size_t)blockIdx.x & (((size_t)1 << chunk_bits) - 1);
  const size_t lo0 = chunk << logC;
  const size_t base = (((size_t)blockIdx.x >> chunk_bits) << s1) | lo0;
  const size_t bat = blockIdx.y;

  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    const size_t g = base | ((size_t)(e >> logC) << s0) | (size_t)(e & (C - 1));
    Fq8 x;
    if (IN_WIDE) {
      const size_t gs = __brevll(g) >> (64 - logn);  // bit-reversed source
      x = load_wide(static_cast<const int64_t*>(src) + (bat * n + gs) * (2 * NL));
    } else {
      const uint32_t* s = static_cast<const uint32_t*>(src) + bat * NL * n + g;
#pragma unroll
      for (int q = 0; q < NL; ++q) x.v[q] = s[q * n];
    }
#pragma unroll
    for (int q = 0; q < NL; ++q) ntt_smem[q * T + e] = x.v[q];
  }
  __syncthreads();

  for (int t = 0; t < s1 - s0; ++t) {
    const size_t off = ((size_t)1 << (s0 + t)) - 1;  // stage s0+t's twiddles
    for (int b = threadIdx.x; b < T / 2; b += blockDim.x) {
      const int hp = b >> logC;
      const int c = b & (C - 1);
      const int hj = hp & ((1 << t) - 1);
      const int ie = ((((hp >> t) << (t + 1)) | hj) << logC) | c;
      const int io = ie + (1 << (t + logC));
      const size_t j = ((size_t)hj << s0) | lo0 | (size_t)c;
      Fq8 xe, xo, w;
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        xe.v[q] = ntt_smem[q * T + ie];
        xo.v[q] = ntt_smem[q * T + io];
        w.v[q] = __ldg(tw + q * tw_n + off + j);
      }
      const Fq8 u = mul(xo, w, P);
      const Fq8 ye = add(xe, u, P);
      const Fq8 yo = sub(xe, u, P);
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        ntt_smem[q * T + ie] = ye.v[q];
        ntt_smem[q * T + io] = yo.v[q];
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    const size_t g = base | ((size_t)(e >> logC) << s0) | (size_t)(e & (C - 1));
    Fq8 y;
#pragma unroll
    for (int q = 0; q < NL; ++q) y.v[q] = ntt_smem[q * T + e];
    if (OUT_WIDE) {
      store_wide(static_cast<int64_t*>(dst) + (bat * n + g) * (2 * NL), y);
    } else {
      uint32_t* d = static_cast<uint32_t*>(dst) + bat * NL * n + g;
#pragma unroll
      for (int q = 0; q < NL; ++q) d[q * n] = y.v[q];
    }
  }
}

}  // namespace

extern "C" {

// One pass, stages [s0, s1) of a 2^logn transform over `batch` arrays.
// The first pass (s0 == 0) reads x, (batch, n, 2*NL) int64 in natural
// order, bit-reversing it; the last (s1 == logn) writes y, same layout;
// other ends use scratch, (batch, NL, n) u32, in place. s1 - s0 <= logT <=
// 10, and for s0 > 0, logT <= s0 + (s1 - s0), i.e. the tile's low run fits.
int zkt_ntt_pass(const int64_t* x, int64_t* y, uint32_t* scratch, const uint32_t* tw, int batch,
                 int logn, int s0, int s1, int logT, const uint32_t* p, const uint32_t* one,
                 uint32_t n0, void* stream) {
  const FieldParams8 P = make_params<NL>(p, one, n0, 0);
  const bool in_wide = s0 == 0;
  const bool out_wide = s1 == logn;
  const void* src = in_wide ? (const void*)x : (const void*)scratch;
  void* dst = out_wide ? (void*)y : (void*)scratch;
  const dim3 grid((unsigned)(((size_t)1 << logn) >> logT), (unsigned)batch);
  const int threads = 1 << (logT - 1);
  const size_t smem = (size_t)NL * sizeof(uint32_t) << logT;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_wide && out_wide)
    ntt_pass_kernel<true, true><<<grid, threads, smem, s>>>(src, dst, tw, logn, s0, s1, logT, P);
  else if (in_wide)
    ntt_pass_kernel<true, false><<<grid, threads, smem, s>>>(src, dst, tw, logn, s0, s1, logT, P);
  else if (out_wide)
    ntt_pass_kernel<false, true><<<grid, threads, smem, s>>>(src, dst, tw, logn, s0, s1, logT, P);
  else
    ntt_pass_kernel<false, false><<<grid, threads, smem, s>>>(src, dst, tw, logn, s0, s1, logT, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
