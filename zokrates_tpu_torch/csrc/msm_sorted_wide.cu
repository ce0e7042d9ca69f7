// The sorted-MSM kernels of msm_kernels.cuh at 24 32-bit limbs over Fq:
// BW6-761's 761-bit base field, over which both of its groups lie (there
// is no Fq2 instantiation at this width). The same kernels, designs and
// layouts as msm_sorted.cu's 8- and 12-limb ones (walk_kernel,
// suffix_kernel, suffix_split_kernel, fold_ladder_kernel,
// fold_tree_kernel; they replace the JAX package's Pallas walk, suffix and
// fold epilogue in zokrates_tpu/kernels/msm_sorted.py, which it ran at
// BW6-761's 48 16-bit limbs), in a source of their own so that nvcc
// compiles them beside msm_sorted.cu instead of after it.
//
// At 24 limbs a Jacobian point is 72 words, as an Fq2<12> one: the kernels
// keep the same block sizes and shared-memory layouts (a split suffix
// block 72 KB, a fold tree of 512 lane sums 144 KB, as Fq2<12>'s) and let
// ptxas spill what the 255 registers of a thread do not hold. A 24-limb
// CIOS product is 2,328 32-bit multiplies; it stays one out-of-line
// function (field.cuh's mul), compiled once for every kernel. What bounds
// them: 32-bit multiplies, as at the other widths.
//
// Interface: the C entry points of msm_sorted.cu under their own names,
// with the same arguments; nl must be 24 and ext 0, anything else returns
// cudaErrorInvalidValue, launching nothing.

#include "msm_kernels.cuh"

extern "C" {

int zkt_msm_wide_walk(const int32_t* q, const int32_t* flags, int32_t* out, int32_t* coll, int K, int L, int S,
                      int nl, int ext, int mixed, int safe, const uint32_t* p, const uint32_t* one, uint32_t n0,
                      int beta_abs, void* stream) {
  if (nl != 24) return (int)cudaErrorInvalidValue;
  return walk_at<24, false>(q, flags, out, coll, K, L, S, ext, mixed, safe, p, one, n0, beta_abs,
                            (cudaStream_t)stream);
}

int zkt_msm_wide_suffix(const int32_t* a, const int32_t* b, int32_t* out, int Lb, int M, int k, int nl, int ext,
                        const uint32_t* p, const uint32_t* one, uint32_t n0, int beta_abs, void* stream) {
  if (nl != 24 || k < 1 || k > kSplitThreads || (k & (k - 1)) != 0 || Lb % k != 0)
    return (int)cudaErrorInvalidValue;
  return suffix_at<24, false>(a, b, out, Lb, M, k, ext, p, one, n0, beta_abs, (cudaStream_t)stream);
}

int zkt_msm_wide_suffix_fold(const int32_t* in, int32_t* sums, int64_t* out, int G, int lw, int L, int nl,
                             int ext, const uint32_t* p, const uint32_t* one, uint32_t n0, int beta_abs,
                             void* stream) {
  if (nl != 24) return (int)cudaErrorInvalidValue;
  return suffix_fold_at<24, false>(in, sums, out, G, lw, L, ext, p, one, n0, beta_abs, (cudaStream_t)stream);
}

}  // extern "C"
