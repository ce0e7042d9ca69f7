// Sorted-MSM bucket walk and suffix kernels for Hopper (sm_90a).
//
// walk_kernel replaces the JAX package's Pallas walk
// (zokrates_tpu/kernels/msm_sorted.py: walk_kernel_factory / _walk_call,
// modes "mixed" and "general"); suffix_kernel and suffix_split_kernel (one
// C entry point, zkt_msm_suffix) replace its suffix walk
// (suffix_kernel_factory / _suffix_call, fold=False); fold_ladder_kernel
// and fold_tree_kernel (one C entry point, zkt_msm_suffix_fold) replace
// the same kernel's fold=True epilogue (the multiplier ladder and the
// per-window lane tree), launched after suffix_kernel.
//
// What bounds them on an H100: 32-bit integer multiplies. A mixed add is
// 11 Montgomery products (also 11 when it doubles: 4 before the branch, 7
// in it), a complete add 16 (15 when it doubles), an Fq2 product three Fq
// products, and one N-limb CIOS product N*(2N+1) 32x32 products (N*(4N+1)
// 32-bit multiply results, low and high halves: 264 at N = 8, 588 at
// N = 12). The inputs are read once and each walk position's snapshot
// written once, a few hundred bytes per
// point op against tens of thousands of multiply instructions: far on
// the operations side of the roofline.
//
// Walk design: a lane's K positions are cut into sub-chunks of S
// positions, one thread for each (lane, sub-chunk); the wrapper picks S
// (msm_sorted.walk_split) so that the grid fills the card's 132 SMs where
// the lanes alone do not (2^14 threads: smaller sub-chunks add threads
// but also idle spans in each warp), and S = K (one thread per lane)
// where they do.
// What makes the cut exact: after a flush the accumulator has Z = 0, and
// both adds ignore X and Y of a P1 with Z = 0 (the mixed add returns
// (Qx, Qy, 1), the complete add P2), so a walk that begins at such a
// point from the zero triple computes the same limbs from there on as the
// sequential walk. A position is "effective" if it is not skipped and
// (complete add) its point is not at infinity: the complete add returns
// P1 for Q at infinity, which is a skip. A "start" is position 0, or an
// effective position with a flush after the lane's last effective
// position before it (or none before it). The thread of sub-chunk t owns
// the starts in [tS, (t+1)S): it walks from its first one up to the first
// start at or after (t+1)S (or K), past its sub-chunk's end if need be,
// and writes every snapshot on the way, the skips after a flush included
// (they hold its own accumulator with Z zeroed, as the sequential walk
// stores them). So every position is written by exactly one thread; a
// sub-chunk with no start writes nothing. A thread learns whether its
// accumulator is reset at tS by looking back from tS - 1 to the nearest
// flush or effective position, and reads a point's Z (complete add) only
// while its accumulator is reset, once a segment. A warp holds 32 neighbouring lanes of one
// sub-chunk and steps them through positions together, each thread
// masked to its own range, so loads and stores stay lane-contiguous
// ([position][row][lane]); the loop ends when every thread of the warp
// is done. coll is the OR over a lane's threads: the wrapper zeroes it
// and a thread writes 1 only on a hit. msm_sorted.walk_owners replays the
// ownership rule in Python. The doubling inside the adds is a branch
// (taken almost never) instead of the Pallas kernel's compute-and-select.
// All windows' lanes (and all point sets sharing a plan) go in one launch.
//
// Suffix design: the running sum acc = sum_t T_t (T_t = A_t + B_t) and
// the sum of running sums tot over a lane's Lb positions are one chain of
// 3*Lb dependent complete adds, and the lanes alone (1024 at the h16 MSM)
// fill 8 of the 132 SMs. The wrapper cuts each lane into k sub-chunks of c
// = Lb/k positions (msm_sorted.suffix_split: a power of two, 2^14 threads
// at most; k = 1 runs suffix_kernel, one thread per lane, as before). In
// suffix_split_kernel thread j of a lane walks its sub-chunk from the
// zero triple by the same loop, giving (a_j, u_j); then, since the lane's
// running sum at a position of sub-chunk j is S_{j-1} + the local one
// (S_j = a_0 + ... + a_j),
//   acc = S_{k-1},   tot = sum_j w_j,  w_j = u_j + c*S_{j-1} (w_0 = u_0).
// The lane's k threads share a block: S by an inclusive Hillis-Steele scan
// in shared memory (log2 k levels, S_j <- S_{j-d} + S_j), c*S_{j-1} by a
// double-and-add ladder over c's bits (as fold_ladder_kernel), the w_j by
// the pairwise halving tree w_j <- w_j + w_{j+s}: about 3c + 2 log2 k +
// log2 c dependent point ops a thread where one thread a lane runs 3 Lb.
// Points sit in shared memory limb-major (word i of thread t at
// [i*blockDim + t]): no bank conflicts for 96-288 B points. A block holds
// 128/k lanes, lane-minor (thread l + j*(128/k)), so a warp's loads cover
// runs of neighbouring lanes. suffix_plain replays this association add
// for add, so both give the same limbs; the reference's sequential loop
// gives the same group element.
//
// The fold epilogue is bound by operations too: per lane a ladder of up to
// log2((lw-1)*L) complete adds and doublings, then lw-1 complete adds per
// window in the tree, against 2*3*ER words read per lane. Where the TPU
// kernel ran a rotate-accumulate tree across its (S, 128) tile, it runs
// here as two launches. fold_ladder_kernel: one thread per lane over all
// G*lw lanes, in blocks of one warp so that they spread over as many SMs
// as there are warps (the chain of dependent point ops, not the issue
// rate, bounds a lane); each writes tot + base*acc to a scratch row.
// fold_tree_kernel: one block per window adds the lane sums by the
// pairwise halving tree, one thread per add at every level up to 256
// threads (two adds a thread at the top level of lw = 1024; at the Fq2
// instantiations' 255 registers a thread, 256 threads take all of an SM's
// 65,536), in shared memory (lw/2 * 12N B for Fq, lw/2 * 24N B for Fq2: at
// lw = 1024, 48 KB / 96 KB for N = 8, 72 KB / 144 KB for N = 12). Both
// follow the plain version's ladder and its tree a[:s] + a[s:2s] exactly,
// so the window sums equal the plain version's limb for limb; the TPU's
// rotation tree adds in another order and agrees with both as a group
// element.
//
// Layout (int32 rows of 16-bit Montgomery limbs, as the reference):
//   walk:   q     (K, IN_ROWS, L)  affine [x|y] (mixed) or Jacobian [X|Y|Z]
//           flags (K, L)           bit0 flush-after, bit1 skip
//           out   (K, 3*ER, L)     accumulator snapshot after each position
//           coll  (L,)             1 where the fast mixed add hit P1 == Q
//   suffix: a, b  (Lb, 3*ER, M)    2-slot dense bucket table, descending
//           out   (6*ER, M)        [acc | tot]: running sum and sum of sums
//           shared memory (split)  2 x 3*ER/2 x 128 words: the scan's S_j,
//                                  and u_j, then the tree's w_j
//   fold:   in    (6*ER, G*lw)     the suffix output, lanes of window w at
//                                  [w*lw, (w+1)*lw)
//           sums  (3*ER, G*lw)     scratch: the lane sums tot + base*acc
//           out   (3, G, ER)       int64 words of 16-bit limbs: X, Y, Z
// ER = 2N rows per Fq coordinate, 4N per Fq2 coordinate ([c0 | c1]).
//
// Widths: the kernels (msm_kernels.cuh) are instantiated here for N = 8
// (BN254's base field) and N = 12 (the base fields of BLS12-381 and
// BLS12-377), over Fq<N> and Fq2<N>; the C entry points take N and
// dispatch on it. msm_sorted_wide.cu instantiates them at N = 24 over
// Fq<24> (BW6-761's base field) under entry points of its own.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns cudaGetLastError() right after its launch, or
// cudaErrorInvalidValue, launching nothing, for a width it has no
// instantiation of.

#include "msm_kernels.cuh"

extern "C" {

// Field constants: nl 32-bit limbs per element (8 or 12; 24 is
// msm_sorted_wide.cu's), p and one as nl
// little-endian 32-bit limbs, n0 = -p^-1 mod 2^32, beta_abs = |u^2| for
// Fq2 (ext != 0). mixed=0 requires safe != 0 (the record-merge walk always
// uses complete adds). S: the positions of a sub-chunk, 1 <= S <= K,
// (K + S - 1) / S <= 65535; coll must hold zeros (threads only set it).
int zkt_msm_walk(const int32_t* q, const int32_t* flags, int32_t* out, int32_t* coll, int K, int L,
                 int S, int nl, int ext, int mixed, int safe, const uint32_t* p, const uint32_t* one,
                 uint32_t n0, int beta_abs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nl == 8) return walk_at<8>(q, flags, out, coll, K, L, S, ext, mixed, safe, p, one, n0, beta_abs, s);
  if (nl == 12) return walk_at<12>(q, flags, out, coll, K, L, S, ext, mixed, safe, p, one, n0, beta_abs, s);
  return (int)cudaErrorInvalidValue;
}

// k: sub-chunks a lane, a power of two <= 128 that divides Lb (1: one
// thread a lane); another k returns cudaErrorInvalidValue, launching
// nothing.
int zkt_msm_suffix(const int32_t* a, const int32_t* b, int32_t* out, int Lb, int M, int k, int nl, int ext,
                   const uint32_t* p, const uint32_t* one, uint32_t n0, int beta_abs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > kSplitThreads || (k & (k - 1)) != 0 || Lb % k != 0) return (int)cudaErrorInvalidValue;
  if (nl == 8) return suffix_at<8>(a, b, out, Lb, M, k, ext, p, one, n0, beta_abs, s);
  if (nl == 12) return suffix_at<12>(a, b, out, Lb, M, k, ext, p, one, n0, beta_abs, s);
  return (int)cudaErrorInvalidValue;
}

// Threads of a split suffix block, the most sub-chunks a lane (the
// wrapper's msm_sorted.SUFFIX_BLOCK; cuda.load checks that they agree).
int zkt_msm_suffix_block(void) { return kSplitThreads; }

// in: the suffix kernel's (6*ER, G*lw) [acc | tot] rows; sums: (3*ER,
// G*lw) scratch; out: (3, G, ER) int64 window sums. lw is a power of two
// <= 1024.
int zkt_msm_suffix_fold(const int32_t* in, int32_t* sums, int64_t* out, int G, int lw, int L,
                        int nl, int ext, const uint32_t* p, const uint32_t* one, uint32_t n0,
                        int beta_abs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nl == 8) return suffix_fold_at<8>(in, sums, out, G, lw, L, ext, p, one, n0, beta_abs, s);
  if (nl == 12) return suffix_fold_at<12>(in, sums, out, G, lw, L, ext, p, one, n0, beta_abs, s);
  return (int)cudaErrorInvalidValue;
}

const char* zkt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
