// Throughput probes for Hopper (sm_90a): the card's rate of 32-bit integer
// multiply-adds and of 8-limb CIOS Montgomery products.
//
// The counterpart of the JAX package's field-multiply calibration probe
// (exp/exp_calib.py, its Pallas multiply kernels), which measured the TPU's
// rate of limb products. Every bound_ms that chip_smoke.py reports divides
// 32-bit multiplies by a rate derived from the published float32 rate (64
// IMAD per SM per clock, 16.75e12/s at 700 W); these kernels measure it.
//
// Design: saturating kernels of their own, no memory traffic inside the
// loop. imad_probe runs four independent pairs of chains x = x*y + k,
// y = y*x + k (one IMAD each, no closed form the compiler could fold), 128
// IMAD per thread and iteration. mont_probe runs four independent chains
// a = mul(a, b) through field.cuh's mul, the CIOS product every kernel here
// calls. Each thread writes one word of its chains at the end so nothing is
// dead code. The caller times a launch with CUDA events and divides the
// count of operations by the time.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) imad_probe(uint32_t* __restrict__ out, int iters,
                                                       uint32_t k) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x[4], y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = tid + 2 * j + 1;
    y[j] = tid ^ (k + j);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = x[j] * y[j] + k;
        y[j] = y[j] * x[j] + k;
      }
    }
  }
  out[tid] = (x[0] ^ y[0]) + (x[1] ^ y[1]) + (x[2] ^ y[2]) + (x[3] ^ y[3]);
}

__global__ void __launch_bounds__(kThreads) mont_probe(uint32_t* __restrict__ out, int iters,
                                                       FieldParams8 P) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  Fq8 a[4], b;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    b.v[i] = P.one.v[i] ^ (tid * 0x9E3779B9u + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j].v[i] = P.one.v[i] + tid + j;
  }
  b.v[NL - 1] &= 0x0FFFFFFFu;  // below p
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j].v[NL - 1] &= 0x0FFFFFFFu;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = mul(a[j], b, P);
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) s += a[j].v[0] ^ a[j].v[NL - 1];
  out[tid] = s;
}

}  // namespace

extern "C" {

// out: blocks * 256 words. 128 IMAD per thread and iteration.
int zkt_probe_imad(uint32_t* out, int blocks, int iters, uint32_t k, void* stream) {
  imad_probe<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(out, iters, k);
  return (int)cudaGetLastError();
}

// out: blocks * 256 words. 4 Montgomery products per thread and iteration.
int zkt_probe_mont(uint32_t* out, int blocks, int iters, const uint32_t* p, const uint32_t* one,
                   uint32_t n0, void* stream) {
  const FieldParams8 P = make_params<NL>(p, one, n0, 0);
  mont_probe<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(out, iters, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
