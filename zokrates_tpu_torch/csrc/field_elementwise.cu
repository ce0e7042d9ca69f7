// Elementwise field kernels for Hopper (sm_90a): emul and ereduce_wide.
//
// emul_kernel replaces the JAX package's Pallas elementwise product
// (zokrates_tpu/kernels/pallas_field.py: _emul_call / emul): one Montgomery
// product a*b*R^-1 mod p per element. ereduce_kernel replaces its lazy-sum
// reduction (_ereduce_call / ereduce_wide): a carry sweep of the column
// sums gives 16-bit limbs res and a carry out, and res*R + carry*(2^256*R
// mod p), each part through one Montgomery product, folds the value back
// into the canonical residue in [0, p).
//
// What bounds them on an H100: bytes. The public tensors are int64 words
// holding 16-bit limbs (the layout of the plain field ops), 128 B per
// element against its 32 B of payload. An emul reads two operands and
// writes one, 384 B, against one 8-limb CIOS product (264 32-bit
// multiplies): at 3.35 TB/s and 16.75e12 multiplies/s the bytes take about
// 7x longer than the multiplies; ereduce_wide moves 256 B per element for
// two products. A narrower public layout is a later change.
//
// Design: one thread per element; its 16 words arrive as eight 16-byte
// loads and are packed into 8 x 32-bit limbs (R = 2^256 in both layouts, so
// Montgomery values pass unchanged). emul's operands take a batch stride,
// and b a row stride, each in int64 words and possibly 0: a per-batch
// slice of a larger tensor is read in place, and a row shared by the batch
// (a coefficient table) or by every element (n^-1, Z(g)^-1, R^2) is read
// through a stride of 0 and never expanded to a's size.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 2 * NL;  // int64 words per element

__global__ void __launch_bounds__(kThreads) emul_kernel(const int64_t* __restrict__ a,
                                                         const int64_t* __restrict__ b,
                                                         int64_t* __restrict__ out, long long L,
                                                         long long total, long long a_bs,
                                                         long long b_bs, long long b_rs,
                                                         FieldParams8 P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long bi = i / L;
  const long long r = i - bi * L;
  const Fq8 x = load_wide(a + bi * a_bs + r * kWords);
  const Fq8 y = load_wide(b + bi * b_bs + r * b_rs);
  store_wide(out + i * kWords, mul(x, y, P));
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

// a: (B, L) elements at a + bi*a_bs + r*2*NL; b at b + bi*b_bs + r*b_rs
// (strides in int64 words, b's may be 0); out: (B, L) elements, packed.
int zkt_emul(const int64_t* a, const int64_t* b, int64_t* out, long long B, long long L,
             long long a_bs, long long b_bs, long long b_rs, const uint32_t* p,
             const uint32_t* one, uint32_t n0, void* stream) {
  const FieldParams8 P = make_params<NL>(p, one, n0, 0);
  const long long total = B * L;
  emul_kernel<<<grid_of(total), kThreads, 0, (cudaStream_t)stream>>>(a, b, out, L, total, a_bs,
                                                                     b_bs, b_rs, P);
  return (int)cudaGetLastError();
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
