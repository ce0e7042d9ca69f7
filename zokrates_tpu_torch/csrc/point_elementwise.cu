// Standalone point kernels for Hopper (sm_90a): mixed_add_lm and
// accumulate_lm.
//
// mixed_add_kernel replaces the JAX package's Pallas kernel of the complete
// mixed Jacobian + affine add over limb-major coordinates
// (zokrates_tpu/kernels/pallas_field.py: mixed_add_kernel_factory /
// mixed_add_lm); accumulate_kernel replaces its bucket accumulation
// (accumulate_kernel_factory / accumulate_lm): per lane, chunk_len affine
// points each mixed-added into the bucket its digit names. In the port both
// carry the Groth16 phase-2 ceremony (kernels/ladder.py): mixed_add_kernel
// the scalar ladders of a contribution and of the column sums' terms,
// accumulate_kernel the column sums themselves.
//
// Both are templates over N, the 32-bit limbs of an element: N = 8 for
// BN254's base field, N = 12 for the BLS12 base fields, and for the mixed
// add N = 24 for BW6-761's base field (a contribution to a BW6-761 key; no
// path accumulates at 24 limbs, so accumulate_kernel has no 24-limb
// instantiation); the C entry points take nl and refuse another width.
//
// What bounds them on an H100: a mixed add reads 5 coordinates and writes
// 3 (512 B per point at 8 limbs as int32 rows of 16-bit limbs, 768 B at 12,
// 1,536 B at 24) against 11 Montgomery products (2904 32-bit multiplies at
// 8 limbs, 6468 at 12, 25,608 at 24): at 3.35 TB/s and 16.75e12
// multiplies/s the two take about the same time at 8 limbs, so the mixed
// add sits at the roofline's ridge, and it is bound by operations at 12
// and 24. At 24 limbs a thread holds five 24-word coordinates before its
// temporaries, more than the 255 registers a thread may have: ptxas spills
// the rest to local memory (its report is in chip_smoke.py's build log);
// the products are field.cuh's out-of-line mul, as at every width. The
// accumulation reads 132 B per lane
// and step and writes n_buckets * 192 B per lane once, against 11 products
// per step: bound by operations at chunk_len = 16.
//
// Design: one thread per point (mixed add) or per lane (accumulation), the
// TPU grid's block of lanes becoming the CUDA block (block = 256 threads,
// the wrapper checks that it divides the lane count). The layout is
// limb-major, [limb][lane], so for each limb a warp loads and stores 32
// consecutive words; limbs are packed into field.cuh's N x 32-bit form and
// split back at the store. The add is field.cuh's ec_mixed_add<Fq<N>, true>,
// the complete mixed add of the MSM walk: p_inf -> (Qx, Qy, one), P == Q
// doubles, P == -Q gives Z = 0, in the order of the plain
// _mixed_add_inline, so results are bit-equal to it.
//
// Where the TPU kernel keeps the lane's buckets in VMEM scratch and reads
// and writes them through a one-hot select over all buckets per step (a
// TPU has no per-lane addressing), the thread here indexes its bucket by
// the digit directly. The buckets live in the output tensor itself
// ([bucket][limb][lane], each thread touching only its own lane's words):
// the thread writes (R, R, 0) to every bucket first, then loads, adds and
// stores the one bucket a step names. That holds any n_buckets with no
// per-thread array, and a warp's bucket accesses stay coalesced; the
// buckets (n_buckets * 192 B a lane, 3 MB per 2^14 lanes at 16 buckets)
// stay in L2 between steps. Digit 0 and digits >= n_buckets touch no
// bucket, as in the reference.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkt;

namespace {

template <int N>
__global__ void mixed_add_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
                                 const int32_t* __restrict__ Z, const int32_t* __restrict__ Qx,
                                 const int32_t* __restrict__ Qy, int32_t* __restrict__ oX,
                                 int32_t* __restrict__ oY, int32_t* __restrict__ oZ, int n_pts,
                                 FieldParams<N> P) {
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)n_pts) return;
  const size_t Ns = (size_t)n_pts;
  Jac<Fq<N>> A;
  Fq<N> qx, qy;
  load(A.X, X, 0, Ns, lane);
  load(A.Y, Y, 0, Ns, lane);
  load(A.Z, Z, 0, Ns, lane);
  load(qx, Qx, 0, Ns, lane);
  load(qy, Qy, 0, Ns, lane);
  bool is_dbl;
  const Jac<Fq<N>> S = ec_mixed_add<Fq<N>, true>(A, qx, qy, is_dbl, P);
  store(oX, 0, Ns, lane, S.X);
  store(oY, 0, Ns, lane, S.Y);
  store(oZ, 0, Ns, lane, S.Z);
}

// digits: (chunk_len, R) read as unsigned; Qx, Qy: (chunk_len * ER, R),
// step t's limb rows at [t * ER, (t + 1) * ER); bX, bY, bZ: (n_buckets * ER,
// R), bucket b's limb rows at [b * ER, (b + 1) * ER); ER = 2N rows of 16-bit
// limbs a coordinate.
template <int N>
__global__ void accumulate_kernel(const int32_t* __restrict__ digits,
                                  const int32_t* __restrict__ Qx, const int32_t* __restrict__ Qy,
                                  int32_t* __restrict__ bX, int32_t* __restrict__ bY,
                                  int32_t* __restrict__ bZ, int chunk_len, int R, int n_buckets,
                                  FieldParams<N> P) {
  constexpr int ER = Rows<Fq<N>>::value;
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)R) return;
  const size_t Rs = (size_t)R;
  Fq<N> zero;
  set_zero(zero);
  for (int b = 0; b < n_buckets; ++b) {
    store(bX, (size_t)b * ER, Rs, lane, P.one);
    store(bY, (size_t)b * ER, Rs, lane, P.one);
    store(bZ, (size_t)b * ER, Rs, lane, zero);
  }
  for (int t = 0; t < chunk_len; ++t) {
    const uint32_t d = (uint32_t)__ldg(digits + (size_t)t * Rs + lane);
    if (d == 0 || d >= (uint32_t)n_buckets) continue;
    const size_t row = (size_t)d * ER;
    Jac<Fq<N>> B;
    Fq<N> qx, qy;
    load(B.X, bX, row, Rs, lane);
    load(B.Y, bY, row, Rs, lane);
    load(B.Z, bZ, row, Rs, lane);
    load(qx, Qx, (size_t)t * ER, Rs, lane);
    load(qy, Qy, (size_t)t * ER, Rs, lane);
    bool is_dbl;
    B = ec_mixed_add<Fq<N>, true>(B, qx, qy, is_dbl, P);
    store(bX, row, Rs, lane, B.X);
    store(bY, row, Rs, lane, B.Y);
    store(bZ, row, Rs, lane, B.Z);
  }
}

unsigned grid_of(int n, int block) { return (unsigned)((n + block - 1) / block); }

template <int N>
int mixed_add_at(const int32_t* X, const int32_t* Y, const int32_t* Z, const int32_t* Qx,
                 const int32_t* Qy, int32_t* oX, int32_t* oY, int32_t* oZ, int n_pts, int block,
                 const uint32_t* p, const uint32_t* one, uint32_t n0, cudaStream_t s) {
  const FieldParams<N> P = make_params<N>(p, one, n0, 0);
  mixed_add_kernel<N><<<grid_of(n_pts, block), block, 0, s>>>(X, Y, Z, Qx, Qy, oX, oY, oZ, n_pts, P);
  return (int)cudaGetLastError();
}

template <int N>
int accumulate_at(const int32_t* digits, const int32_t* Qx, const int32_t* Qy, int32_t* bX,
                  int32_t* bY, int32_t* bZ, int chunk_len, int R, int n_buckets, int block,
                  const uint32_t* p, const uint32_t* one, uint32_t n0, cudaStream_t s) {
  const FieldParams<N> P = make_params<N>(p, one, n0, 0);
  accumulate_kernel<N><<<grid_of(R, block), block, 0, s>>>(digits, Qx, Qy, bX, bY, bZ, chunk_len, R,
                                                           n_buckets, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X, Y, Z, Qx, Qy, oX, oY, oZ: (2*nl, N) int32 limb-major rows; block
// threads per CUDA block. nl 32-bit limbs per element (8, 12 or 24; another
// returns cudaErrorInvalidValue, launching nothing); p and one as nl
// little-endian 32-bit limbs, n0 = -p^-1 mod 2^32.
int zkt_mixed_add_lm(const int32_t* X, const int32_t* Y, const int32_t* Z, const int32_t* Qx,
                     const int32_t* Qy, int32_t* oX, int32_t* oY, int32_t* oZ, int N, int block, int nl,
                     const uint32_t* p, const uint32_t* one, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nl == 8) return mixed_add_at<8>(X, Y, Z, Qx, Qy, oX, oY, oZ, N, block, p, one, n0, s);
  if (nl == 12) return mixed_add_at<12>(X, Y, Z, Qx, Qy, oX, oY, oZ, N, block, p, one, n0, s);
  if (nl == 24) return mixed_add_at<24>(X, Y, Z, Qx, Qy, oX, oY, oZ, N, block, p, one, n0, s);
  return (int)cudaErrorInvalidValue;
}

int zkt_accumulate_lm(const int32_t* digits, const int32_t* Qx, const int32_t* Qy, int32_t* bX,
                      int32_t* bY, int32_t* bZ, int chunk_len, int R, int n_buckets, int block, int nl,
                      const uint32_t* p, const uint32_t* one, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nl == 8)
    return accumulate_at<8>(digits, Qx, Qy, bX, bY, bZ, chunk_len, R, n_buckets, block, p, one, n0, s);
  if (nl == 12)
    return accumulate_at<12>(digits, Qx, Qy, bX, bY, bZ, chunk_len, R, n_buckets, block, p, one, n0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
