// Sparse-matvec multiply-accumulate walk for Hopper (sm_90a): mulacc_kernel.
//
// Replaces the JAX package's Pallas kernel of the same walk
// (zokrates_tpu/kernels/pallas_field.py: _mulacc_call / mulacc_walk). The
// prover evaluates A·z, B·z and C·z over one row-sorted stream of COO
// records (ir/r1cs_device.build_mulacc_walk); lane m owns K consecutive
// records. For each record the lane takes one Montgomery product
// coeff*z, adds it limb by limb without carries into its 16-bit-limb
// accumulator, writes the accumulator as the record's output, and resets
// the accumulator after a record whose flush flag is set (the last record
// of a row's run in the lane, or of the lane). The caller gathers the
// flushed records' outputs, reduces them and sums them per row.
//
// What bounds it on an H100: bytes. Per record it reads z and writes the
// snapshot as int64 words of 16-bit limbs (128 B each), reads the
// coefficient (128 B, shared by the batch) and a 4-byte flag, against one
// 8-limb CIOS product (264 32-bit multiplies): at 3.35 TB/s and 16.75e12
// multiplies/s the bytes of one proof's records take about 5x longer than
// its products. Writing only the flushed records, and gathering z inside
// the kernel, would cut the bytes; that is a later change.
//
// Design: one thread per (proof, lane), the TPU grid's sequential record
// axis being the thread's loop over its K records, with the 16 limb sums
// in registers as 32-bit words (exact for K <= 2^16; the wrapper checks).
// Every array is lane-minor ([proof][record][limb][lane]), so for each
// limb a warp loads and stores 32 consecutive words. The product is
// computed in 8 x 32-bit limbs (R = 2^256 in both layouts) and split back
// into 16-bit limbs before the add, so the sums equal the plain version's,
// which adds 16-bit-limb products.
//
// Interface: a plain C function (ctypes), launched on the caller's
// stream; it returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kThreads = 64;
constexpr int kLimbs = 2 * NL;  // 16-bit limbs per element

// one int64 word holding a 16-bit limb, through the read-only cache
__device__ __forceinline__ uint32_t limb(const int64_t* src) {
  return (uint32_t)__ldg(reinterpret_cast<const long long*>(src));
}

__global__ void __launch_bounds__(kThreads) mulacc_kernel(const int64_t* __restrict__ z,
                                                           const int64_t* __restrict__ coeff,
                                                           const int32_t* __restrict__ flags,
                                                           int64_t* __restrict__ out, int B, int K,
                                                           int M, FieldParams8 P) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (size_t)B * M) return;
  const size_t b = tid / M;
  const size_t m = tid - b * M;
  const size_t Ms = (size_t)M;
  const int64_t* zb = z + b * K * kLimbs * Ms;
  int64_t* ob = out + b * K * kLimbs * Ms;
  uint32_t acc[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) acc[i] = 0;
  for (int k = 0; k < K; ++k) {
    const size_t row = (size_t)k * kLimbs * Ms + m;
    Fq8 x, c;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      x.v[i] = limb(zb + row + (2 * i) * Ms) | (limb(zb + row + (2 * i + 1) * Ms) << 16);
      c.v[i] = limb(coeff + row + (2 * i) * Ms) | (limb(coeff + row + (2 * i + 1) * Ms) << 16);
    }
    const Fq8 prod = mul(x, c, P);
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      acc[2 * i] += prod.v[i] & 0xFFFFu;
      acc[2 * i + 1] += prod.v[i] >> 16;
    }
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) ob[row + i * Ms] = (int64_t)acc[i];
    if (__ldg(flags + (size_t)k * Ms + m) != 0) {
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) acc[i] = 0;
    }
  }
}

}  // namespace

extern "C" {

// z, out: (B, K, 16, M) int64; coeff: (K, 16, M) int64; flags: (K, M)
// int32; all contiguous. p and one as NL little-endian 32-bit limbs, n0 =
// -p^-1 mod 2^32.
int zkt_mulacc_walk(const int64_t* z, const int64_t* coeff, const int32_t* flags, int64_t* out,
                    int B, int K, int M, const uint32_t* p, const uint32_t* one, uint32_t n0,
                    void* stream) {
  const FieldParams8 P = make_params<NL>(p, one, n0, 0);
  const long long total = (long long)B * M;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  mulacc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(z, coeff, flags, out, B, K, M, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
