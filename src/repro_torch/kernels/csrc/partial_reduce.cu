// Fused score + PartialReduce kernels for Hopper (sm_90a): bf16 wgmma with
// an exact split of the f32 operands.
//
// One scan kernel, pr_scan_kernel<FUSED, FORM, QP>, templated on the
// selection (two-pass or fused), on the stored form of the database rows
// and on the bf16 parts of the queries (QP 3: f32 queries, split; QP 1:
// bf16 queries, the reference's dtype="bfloat16"), plus the carry-merge
// kernel pr_merge_kernel<G, CPL, STAGED>.  They replace the Pallas TPU
// kernels of src/repro/kernels/partial_reduce.py:
//
//   instantiation                        Pallas body it replaces
//   pr_scan_kernel<false, F32, 3>        _partial_reduce_kernel        :285 (B2)
//   pr_scan_kernel<false, BF16, 3>       _partial_reduce_kernel        :285
//   pr_scan_kernel<false, I8 | I4, 3>    _partial_reduce_kernel_scaled :300 (B3a)
//   pr_scan_kernel<true,  F32, 3>        _fused_kernel                 :316 (B1)
//   pr_scan_kernel<true,  BF16, 3>       _fused_kernel                 :316
//   pr_scan_kernel<true,  I8 | I4, 3>    _fused_kernel_scaled          :323 (B3b)
//   pr_scan_kernel<false, BF16, 1>       _partial_reduce_kernel        :285,
//                                        bf16 queries
//   pr_scan_kernel<false, I8 | I4, 1>    _partial_reduce_kernel_scaled :300,
//                                        bf16 queries
//   pr_scan_kernel<true,  BF16, 1>       _fused_kernel                 :316,
//                                        bf16 queries
//   pr_scan_kernel<true,  I8 | I4, 1>    _fused_kernel_scaled          :323,
//                                        bf16 queries
//   pr_merge_kernel<G, CPL, STAGED>      the rest of B1/B3b (_merge_topk_carry
//                                        :219): the carries of the splits
//                                        (see below) into one
//
// The one-pass forms (QP 1) are the reference's bf16 compute dtype: its
// queries and rows cast to bf16 (rows quantized from the bf16-cast values
// for int8 and int4), then _tile_winners' bf16 x bf16 product into f32.
// The queries are one bf16 part as they are, so the scan issues one wgmma
// pass where the split takes three; the epilogue and the merge are the
// same.  Every product of two bf16 values is exact in f32, so the kernel
// differs from its plain version only in the order of the f32 sum.
//
// all of them reading their tile as _load_db_tile :154 does.  The two-pass
// form (partial_reduce_pallas :352) writes every bin winner, (m, n_pad /
// bin) values and raw int32 global indices; the caller sentinelizes and
// merges.  The fused form (partial_reduce_fused_pallas :417) keeps a
// per-query top-k_scan carry and writes only that carry, once per split
// of the row range; the merge kernel folds the splits' carries into the
// (m, k_scan) result.
//
// What they compute, for queries q (m, d) f32 and stored rows x (n_pad, d):
//   score[i][j] = (sum_k q[i][k] * xhat[j][k]) * scale[j] + bias[j]
//   bin winner  = (max, lowest index among equal maxima) over each bin of
//                 2^log2_bin consecutive rows j,
// where xhat is x widened exactly (f32 as is; bf16; int8 codes; int4
// codes, two per byte, column 2c in the low nibble and 2c+1 in the high
// one, sign-extended) and the scale is applied only to the int8 and int4
// forms, as a product and then a sum rounded apart (__fmul_rn, __fadd_rn:
// nvcc would contract them into one FMA, which rounds once where the
// reference rounds twice).  The fused form pairs a masked winner (value
// <= MASK/2) with index -1 and keeps the k_scan best winners in the order
// (value descending, earlier row first): the reference's carry, a stable
// sort of all bin winners by descending value.  Each block inserts its
// winners in ascending row order with a strict '>' (ties keep the earlier
// entry), and the merge takes the lowest split first among equal values.
//
// Exactness of the tensor-core product.  The prologue splits each f32
// query value exactly into three bf16 terms, q = q0 + q1 + q2 (q0 =
// bf16(q), q1 = bf16(q - q0), q2 = bf16(q - q0 - q1); each residual is
// exact in f32 and the last fits bf16's 8 significant bits).  Every stored
// bf16, int8 (|c| <= 127) and int4 (|c| <= 7) value is exact in bf16, and
// a product of two bf16 values is exact in f32, so the three passes
// q2.x, q1.x, q0.x (smallest first, f32 accumulation) sum exact products.
// f32 rows are split the same way in registers, x = x0 + x1 + x2, and the
// six products q_i.x_j with i + j <= 2 are kept (the dropped ones are
// below 2^-24 of the product): the same instruction for every form,
// where 3xTF32 would need a second query layout and a second wgmma shape.
// What differs from an FFMA loop is only the order and rounding of the
// f32 sum, as it already differs from XLA's.
//
// Bound on an H100 SXM: the tensor-core passes, 3 (6 for f32) of
// 2*m*n_pad*d16 flops at 989 TFLOP/s bf16 (d16 = d rounded up to 16, the
// lanes the loop covers), against the stored bytes at 3.35 TB/s and the
// 4 CUDA-core instructions per score the function needs (bias, bin
// winner); chip_smoke.py prints all three, and beside them this
// epilogue's own count and the FFMA bound of the earlier kernel.
// The design:
//   * a block owns 128 queries (two consumer warpgroups of 64, the wgmma
//     N) and a bin-aligned range of rows; its queries, split, stay in
//     shared memory in wgmma's K-major core-matrix layout (no swizzle) for
//     the whole range (B operand), filled once in the prologue;
//   * a producer warp streams stages of 64 rows x 128 lanes in their
//     stored width with cp.async.bulk and an mbarrier ring of 2-4 stages,
//     ahead of the math: one copy a stage where the rows are one
//     contiguous run (d_pad <= 128: the Sift1M and Glove1.2M shapes),
//     else one a row into a pitch padded so the fragment loads hit
//     distinct banks (the kNN-LM datastore's d_pad = 2048: 16 stages of
//     128 lanes a tile, each summed apart and folded in, see the loop);
//   * each consumer warpgroup widens its 64 rows from the stage straight
//     into A fragments in registers (rows on the wgmma M side), hands the
//     stage back (after a proxy fence: the refill is an async-proxy write)
//     and, in its turn, issues m64n64k16 wgmmas for every pass; the turns
//     alternate between the warpgroups, so one's epilogue runs under the
//     other's products;
//   * the epilogue applies scale and bias on the accumulator and takes the
//     bin top-1 in registers (the thread's two rows, then a shuffle
//     butterfly over the warp's 8 row groups).  Bins of 16 rows and more:
//     each warp keeps its running winner of each query in its own slot of
//     a small shared table for the bin's stages, and one thread a query
//     combines the 4 warps' slots when the bin ends; bins of 1-8 rows go
//     through the table every stage.  The two-pass form writes the bin
//     winners, the fused form inserts them into the query's carry.
// The (m, n_pad) score matrix never reaches device memory (Eq. 20); only
// O(m * k_scan * splits) bytes leave the fused form.  The carry sits in
// shared memory for k_scan <= SMEM_K_SCAN; above that each block keeps it
// in its own (rows, k_scan) slice of the (splits, m, k_scan) output.  A
// query block whose split parts do not fit in shared memory with two
// stages (d above ~128 lanes for f32) reloads them at each stage.
// Measured limits (chip_smoke.py, PERF.md): ptxas serializes every wgmma
// of a kernel with a branch between a wgmma.fence and its wait, hence the
// k-step groups; the epilogue, not the tensor cores, sets the pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;        // rows per split unit (the C interface's tile)
constexpr int RT = 64;         // rows per stage: the wgmma M
constexpr int WQ = 64;         // queries per consumer warpgroup: the wgmma N
constexpr int BQ = 2 * WQ;     // queries per block
constexpr int CONSUMERS = 256; // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int KCH = 128;       // lanes per stage
constexpr int KSTEPS = KCH / 16;
constexpr int BPART = WQ * 16 * 2;  // one k-step of one split part, one warpgroup
constexpr int SLOTS = 16;      // winner slots per query and round
constexpr int TP = SLOTS + 1;  // pitch of the winner table
constexpr int MAX_STAGES = 4;
constexpr int SMEM_K_SCAN = 32;  // larger carries live in device memory
constexpr int MAX_SPLITS = 256;
constexpr float MASK = -FLT_MAX;  // stages.MASK_VALUE

// Stored forms of the database rows; the values are the C interface's
// `form` argument (kernels/partial_reduce.py FORMS).
enum Form : int { F32 = 0, BF16 = 1, I8 = 2, I4 = 3 };

__host__ __device__ constexpr bool is_scaled(int form) {
  return form == I8 || form == I4;
}
// Bytes of n stored elements.
__host__ __device__ constexpr int stored_bytes(int form, int n) {
  return form == F32 ? 4 * n : form == BF16 ? 2 * n : form == I8 ? n : n / 2;
}
// Shared pitch of one stage row of KCH lanes.  A warp's fragment load
// reads 4 elements (L bytes) of 8 rows; a pitch that is an odd multiple
// of max(4L, 16) puts the rows of one load phase on distinct banks.
__host__ __device__ constexpr int stage_pitch(int form) {
  return stored_bytes(form, KCH) +
         (stored_bytes(form, 16) > 16 ? stored_bytes(form, 16) : 16);
}
__host__ __device__ constexpr int stage_bytes(int form) {
  return RT * 4 * (is_scaled(form) ? 2 : 1) + RT * stage_pitch(form);
}

// Dynamic shared memory: 2 * MAX_STAGES mbarriers, the split queries of
// both warpgroups (b_ksteps k-steps), the stage ring, the winner table,
// the shared carries.
struct Smem {
  int b_off, b_wg, st_off, t_off, c_off, total;
};
__host__ __device__ inline Smem smem_layout(int form, int qparts, int b_ksteps,
                                            int carry_k, int stages) {
  Smem s;
  s.b_off = 128;
  s.b_wg = b_ksteps * qparts * BPART;
  s.st_off = s.b_off + 2 * s.b_wg;
  s.t_off = s.st_off + stages * stage_bytes(form);
  s.c_off = s.t_off + 2 * WQ * TP * 8;
  s.total = s.c_off + 2 * WQ * carry_k * 8;
  return s;
}

// --- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Hand a stage back to the producer.  The proxy fence orders this
// thread's reads of the stage (generic proxy) before the bulk copy that
// refills it (async proxy): without it a refill can land under reads
// still in flight.
__device__ __forceinline__ void release(uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_arrive(bar);
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// One consumer warpgroup (128 threads) at named barrier 1 + wg.
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}
// The warpgroups' turns to issue wgmmas: warpgroup w waits at named
// barrier 3 + w, then lets the other one go (3 + 1 - w).  With both
// warpgroups scanning, `n` is 256; alone, 128 (no wait).
__device__ __forceinline__ void turn_wait(int wg, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(3 + wg), "r"(n) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(4 - wg), "r"(n) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pin a register's value to this point of the instruction stream: the A
// fragments and accumulators of an asynchronous wgmma must be written
// before its wgmma.fence (else the compiler may move their definitions
// past the fence, and the wgmma reads stale values) and must not be
// reused before its wait.
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_acc(float (&acc)[32]) {
#pragma unroll
  for (int r = 0; r < 32; ++r) keep(acc[r]);
}

// Shared-memory matrix descriptor, no swizzle, K-major: core matrices of
// 8 rows x 16 bytes, the two k halves LBO bytes apart, consecutive 8-row
// groups SBO bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t LBO = 8 * WQ * 2;  // 1024: the second k half
  constexpr uint64_t SBO = 128;         // the next 8 queries
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) |
         ((SBO >> 4) << 32);
}

// d[64x64 f32] += a[64x16 bf16, registers] * b[16x64 bf16, shared].
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// --- operands -----------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
// x = x0 + x1 + x2 exactly, each part a bf16.
__device__ __forceinline__ void split3(float x, float (&p)[3]) {
  p[0] = __bfloat162float(__float2bfloat16_rn(x));
  const float r = __fsub_rn(x, p[0]);
  p[1] = __bfloat162float(__float2bfloat16_rn(r));
  p[2] = __bfloat162float(__float2bfloat16_rn(__fsub_rn(r, p[1])));
}
__device__ __forceinline__ int nibble(uint32_t b, int hi) {
  return hi ? ((int)(b << 24) >> 28) : ((int)(b << 28) >> 28);
}

// The fragment loads read, for k-step j, thread t (lane % 4) and row r,
// the 4 consecutive stored lanes 16j + 4t .. 16j + 4t + 3: slots 0, 1 go
// to the fragment's columns 2t, 2t+1 and slots 2, 3 to 2t+8, 2t+9.  The
// query operand is laid out with the same permutation of the 16 lanes
// (fill_queries), so the dot product is unchanged.
//
// Non-f32 forms: a[j] is row r0's (regs 0, 2) and r0+8's (1, 3) k-step
// j0 + j.
template <int FORM, int C>
__device__ __forceinline__ void load_frags(const char* rows, int P, int r0,
                                           int t, int j0, uint32_t (&a)[C][4]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int k = 16 * (j0 + j) + 4 * t;  // first stored lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const char* row = rows + (r0 + 8 * h) * P;
      uint32_t lo, hi;
      if constexpr (FORM == BF16) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + 2 * k);
        lo = v.x;
        hi = v.y;
      } else if constexpr (FORM == I8) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(row + k);
        lo = pack_bf16((float)(int8_t)(v), (float)(int8_t)(v >> 8));
        hi = pack_bf16((float)(int8_t)(v >> 16), (float)(int8_t)(v >> 24));
      } else {  // I4
        const uint32_t v = *reinterpret_cast<const uint16_t*>(row + k / 2);
        lo = pack_bf16((float)nibble(v, 0), (float)nibble(v, 1));
        hi = pack_bf16((float)nibble(v >> 8, 0), (float)nibble(v >> 8, 1));
      }
      a[j][h] = lo;
      a[j][2 + h] = hi;
    }
  }
}

// f32: the rows split in registers, a[part][j].
template <int C>
__device__ __forceinline__ void load_frags_f32(const char* rows, int P, int r0,
                                               int t, int j0,
                                               uint32_t (&a)[3][C][4]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(
          rows + (r0 + 8 * h) * P + 4 * (16 * (j0 + j) + 4 * t));
      float s0[3], s1[3], s2[3], s3[3];
      split3(v.x, s0);
      split3(v.y, s1);
      split3(v.z, s2);
      split3(v.w, s3);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        a[p][j][h] = pack_bf16(s0[p], s1[p]);
        a[p][j][2 + h] = pack_bf16(s2[p], s3[p]);
      }
    }
  }
}

// k-steps [j0, j0 + C) of one stage for one warpgroup: the fragments, the
// stage released (`empty`, when these are its last k-steps), then, in the
// warpgroup's turn, every pass's wgmmas into acc (QP query parts, k-step
// j's part p at block j * QP + p), issued, the turn passed on, and waited
// for.  So the tensor cores run one warpgroup's products
// while the other takes its epilogue.  Nothing branches between the
// fence and the wait: ptxas serializes the wgmmas of a kernel where a
// branch (a k-step guard, say) sits inside that window.
template <int FORM, int C, int QP>
__device__ __forceinline__ void stage_math(float (&acc)[32], const char* rows,
                                           int P, int r0, int t, int j0,
                                           uint32_t bq, uint32_t empty, int wg,
                                           int turn_n) {
  static_assert(QP == 3 || (QP == 1 && FORM != F32), "query parts");
  if constexpr (FORM == F32) {
    uint32_t a[3][C][4];
    load_frags_f32<C>(rows, P, r0, t, j0, a);
    if (empty) release(empty);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) keep(a[p][j][e]);
    fence_acc(acc);
    turn_wait(wg, turn_n);
    wgmma_fence();
    // the six products q_pq . x_px with pq + px <= 2, smallest first:
    // (2,0) (1,1) (0,2) (1,0) (0,1) (0,0)
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const int px = u < 3 ? u : (u < 5 ? u - 3 : 0);
      const int pq = u < 3 ? 2 - u : (u == 3 ? 1 : 0);
#pragma unroll
      for (int j = 0; j < C; ++j)
        wgmma_rs(acc, a[px][j], smem_desc(bq + ((j0 + j) * 3 + pq) * BPART));
    }
    wgmma_commit();
    turn_pass(wg, turn_n);
    wgmma_wait0();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) keep(a[p][j][e]);
  } else {
    uint32_t a[C][4];
    load_frags<FORM, C>(rows, P, r0, t, j0, a);
    if (empty) release(empty);
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(a[j][e]);
    fence_acc(acc);
    turn_wait(wg, turn_n);
    wgmma_fence();
#pragma unroll
    for (int p = QP - 1; p >= 0; --p)  // q2 . x, q1 . x, q0 . x; or q . x
#pragma unroll
      for (int j = 0; j < C; ++j)
        wgmma_rs(acc, a[j], smem_desc(bq + ((j0 + j) * QP + p) * BPART));
    wgmma_commit();
    turn_pass(wg, turn_n);
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(a[j][e]);
  }
  fence_acc(acc);
}

// One warpgroup's 64 queries, k-steps [k0, k0 + nk), into B: block
// (j, p) of BPART bytes holds part p's core matrices [k half][8-query
// group][8 queries][8 lanes].  QP 3: q is (m, ldq) f32, split exactly into
// three bf16 parts (split3; kernels/partial_reduce.py split_queries is its
// plain version).  QP 1: q is (m, ldq) bf16, stored as it is.
template <int QP>
__device__ void fill_queries(char* B, const void* __restrict__ qv, int m,
                             int ldq, int q0, int k0, int nk, int ct) {
  if constexpr (QP == 1) {
    const uint16_t* q = static_cast<const uint16_t*>(qv);
    for (int idx = ct; idx < nk * WQ * 4; idx += 128) {
      const int tq = idx & 3, n = (idx >> 2) % WQ, j = (idx >> 2) / WQ;
      uint2 v = make_uint2(0u, 0u);
      if (q0 + n < m)
        v = *reinterpret_cast<const uint2*>(q + (size_t)(q0 + n) * ldq +
                                            (k0 + j) * 16 + 4 * tq);
      char* blk = B + j * BPART + (n >> 3) * 128 + (n & 7) * 16 + 4 * tq;
      *reinterpret_cast<uint32_t*>(blk) = v.x;             // columns 2tq, 2tq+1
      *reinterpret_cast<uint32_t*>(blk + 8 * WQ * 2) = v.y;  // 2tq+8, 2tq+9
    }
    return;
  }
  const float* q = static_cast<const float*>(qv);
  for (int idx = ct; idx < nk * WQ * 4; idx += 128) {
    const int tq = idx & 3, n = (idx >> 2) % WQ, j = (idx >> 2) / WQ;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + n < m)
      v = *reinterpret_cast<const float4*>(q + (size_t)(q0 + n) * ldq +
                                           (k0 + j) * 16 + 4 * tq);
    float s0[3], s1[3], s2[3], s3[3];
    split3(v.x, s0);
    split3(v.y, s1);
    split3(v.z, s2);
    split3(v.w, s3);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      char* blk = B + (j * 3 + p) * BPART + (n >> 3) * 128 + (n & 7) * 16 + 4 * tq;
      *reinterpret_cast<uint32_t*>(blk) = pack_bf16(s0[p], s1[p]);  // columns 2tq, 2tq+1
      *reinterpret_cast<uint32_t*>(blk + 8 * WQ * 2) = pack_bf16(s2[p], s3[p]);  // 2tq+8, 2tq+9
    }
  }
}

__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// --- the scan -----------------------------------------------------------------

// Block (blockIdx.x, blockIdx.y) owns queries [128x, 128x + 128) and the
// split tiles [y * tiles_per_split, ...) of BN rows each; tiles_per_split
// is a multiple of the tiles in one bin, so no bin straddles two blocks.
template <bool FUSED, int FORM, int QP>
__global__ void __launch_bounds__(THREADS, 1)
pr_scan_kernel(const void* __restrict__ q, const char* __restrict__ db,
               const float* __restrict__ scale, const float* __restrict__ bias,
               int m, int nks, int d_pad, int n_pad, int log2_bin,
               int tiles_per_split, int k_scan, int carry_k, int resident,
               int stages, float* __restrict__ out_v, int* __restrict__ out_i,
               int out_cols) {
  constexpr bool SCALED = is_scaled(FORM);
  constexpr int SB = stage_bytes(FORM);
  constexpr int ROWS_OFF = RT * 4 * (SCALED ? 2 : 1);
  extern __shared__ __align__(128) char smem[];
  const Smem L = smem_layout(FORM, QP, resident ? nks : min(nks, KSTEPS),
                             carry_k, stages);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base, empty0 = base + 8 * MAX_STAGES;

  // The warp index as a warp-uniform value: ptxas serializes every wgmma
  // of a kernel whose warpgroup roles it cannot prove uniform.
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int nkc = (nks + KSTEPS - 1) / KSTEPS;  // stages per 64-row tile
  const int t_begin = blockIdx.y * tiles_per_split * (BN / RT);
  const int t_end = min(t_begin + tiles_per_split * (BN / RT), n_pad / RT);
  // Rows of at most KCH lanes are one contiguous run in device memory:
  // one bulk copy a stage, at their own pitch in shared memory.  Wider
  // rows go one copy a row, into the padded pitch.
  const int gpitch = stored_bytes(FORM, d_pad);
  const bool whole = d_pad <= KCH;
  const int P = whole ? gpitch : stage_pitch(FORM);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  const int wg = warp >> 2;       // consumer warpgroup (warp < 8)
  const int ct = tid & 127;       // thread within it
  const int q0 = blockIdx.x * BQ + wg * WQ;
  char* Bw = smem + L.b_off + wg * L.b_wg;
  if (warp < 8 && resident) {
    fill_queries<QP>(Bw, q, m, d_pad, q0, 0, nks, ct);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // Producer: stage (tile, kc) holds rows [64 tile, +64), lanes
    // [128 kc, +128) in their stored width (and, at kc == 0, the rows'
    // bias and scale).
    int it = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      for (int kc = 0; kc < nkc; ++kc, ++it) {
        const int s = it % stages;
        mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);
        const uint32_t st = base + L.st_off + s * SB;
        const int cb = stored_bytes(FORM, min(KCH, d_pad - kc * KCH));
        const uint32_t bytes =
            RT * cb + (kc == 0 ? ROWS_OFF : 0);
        if (lane == 0) mbar_expect_tx(full0 + 8 * s, bytes);
        __syncwarp();
        const char* src = db + (size_t)tile * RT * gpitch + stored_bytes(FORM, kc * KCH);
        if (whole) {
          if (lane == 2) bulk_g2s(st + ROWS_OFF, src, RT * cb, full0 + 8 * s);
        } else {
          for (int r = lane; r < RT; r += 32)
            bulk_g2s(st + ROWS_OFF + r * P, src + (size_t)r * gpitch, cb,
                     full0 + 8 * s);
        }
        if (kc == 0 && lane == 0)
          bulk_g2s(st, bias + (size_t)tile * RT, RT * 4, full0 + 8 * s);
        if (SCALED && kc == 0 && lane == 1)
          bulk_g2s(st + RT * 4, scale + (size_t)tile * RT, RT * 4, full0 + 8 * s);
      }
    }
    return;
  }

  // Consumers.  Warp wi of the warpgroup holds accumulator rows r0 = 16 wi
  // + g and r0 + 8 of each stage, and columns (queries) 8c + 2t + {0, 1}.
  const int wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * wi + g;
  const bool active = q0 < m;
  const int lb = log2_bin;
  const int stages_per_bin = lb > 6 ? (1 << (lb - 6)) : 1;
  float* Tv = reinterpret_cast<float*>(smem + L.t_off) + wg * WQ * TP * 2;
  int* Ti = reinterpret_cast<int*>(Tv + WQ * TP);

  // Thread ct < WQ owns query q0 + ct's bins and carry: in shared memory,
  // or in the block's own slice of out_* (splits, m, k_scan), which then
  // is the output itself.  A query past m keeps no device-memory carry.
  const int gq = q0 + ct;
  float* cv = nullptr;
  int* ci = nullptr;
  if (FUSED && ct < WQ) {
    if (carry_k) {
      cv = reinterpret_cast<float*>(smem + L.c_off) + (wg * WQ + ct) * carry_k * 2;
      ci = reinterpret_cast<int*>(cv + carry_k);
    } else if (gq < m) {
      const size_t o = ((size_t)blockIdx.y * m + gq) * k_scan;
      cv = out_v + o;
      ci = out_i + o;
    }
    if (cv != nullptr)
      for (int j = 0; j < k_scan; ++j) {
        cv[j] = MASK;
        ci[j] = -1;
      }
  }
  // Both warpgroups scan (the block has more than 64 queries): they take
  // turns at the tensor cores, the first turn warpgroup 0's.
  const bool both = blockIdx.x * BQ + WQ < m;
  const int turn_n = both ? 256 : 128;
  if (both && wg == 1) turn_pass(wg, turn_n);

  // One finished bin winner of query gq (thread ct < WQ), in row order.
  auto emit = [&](float v, int i) {
    if (FUSED) {
      if (cv == nullptr || !(v > cv[k_scan - 1])) return;  // ties keep the earlier
      const int wi_ = v > MASK * 0.5f ? i : -1;
      int pos = k_scan - 1;
      while (pos > 0 && v > cv[pos - 1]) {
        cv[pos] = cv[pos - 1];
        ci[pos] = ci[pos - 1];
        --pos;
      }
      cv[pos] = v;
      ci[pos] = wi_;
    } else if (gq < m) {
      const size_t o = (size_t)gq * out_cols + (i >> lb);
      out_v[o] = v;
      out_i[o] = i;
    }
  };
  // Thread ct < WQ combines its query's winner slots [0, nslot), in bins
  // of per_bin slots (lowest row among equal values: the slots of one bin
  // need not be in row order), and emits each bin's winner.
  auto take_slots = [&](int nslot, int per_bin) {
    for (int j0 = 0; j0 < nslot; j0 += per_bin) {
      float v = Tv[ct * TP + j0];
      int i = Ti[ct * TP + j0];
      for (int j = j0 + 1; j < j0 + per_bin; ++j)
        if (beats(Tv[ct * TP + j], Ti[ct * TP + j], v, i)) {
          v = Tv[ct * TP + j];
          i = Ti[ct * TP + j];
        }
      emit(v, i);
    }
  };

  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    float acc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = 0.f;
    float b[2] = {0.f, 0.f}, sc[2] = {1.f, 1.f};
    for (int kc = 0; kc < nkc; ++kc, ++it) {
      const int s = it % stages;
      mbar_wait(full0 + 8 * s, (it / stages) & 1);
      if (!active) {
        mbar_arrive(empty0 + 8 * s);
        continue;
      }
      const char* st = smem + L.st_off + s * SB;
      const int nk = min(KSTEPS, nks - kc * KSTEPS);
      if (!resident) {  // this stage's lanes of the queries
        wg_sync(wg);
        fill_queries<QP>(Bw, q, m, d_pad, q0, kc * KSTEPS, nk, ct);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        wg_sync(wg);
      }
      if (kc == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          b[h] = reinterpret_cast<const float*>(st)[r0 + 8 * h];
          if (SCALED) sc[h] = reinterpret_cast<const float*>(st)[RT + r0 + 8 * h];
        }
      }
      const uint32_t bq = smem_u32(Bw) + (resident ? kc * KSTEPS : 0) * QP * BPART;
      const char* rows = st + ROWS_OFF;
      const uint32_t empty = empty0 + 8 * s;
      // Each stage sums into an accumulator of its own, folded into the
      // tile's with a rounded add: the tensor cores' f32 accumulation
      // does not round to nearest, so its error grows with the products
      // it chains, and a chain over all of d (6 x 128 wgmmas at d=2048)
      // drifts past the tolerance the plain version is held to.  One
      // stage chains at most 48.  With one stage (d_pad <= 128) acc is
      // that stage's sum.  (Folding into a second array kept beside the
      // wgmma accumulator instead spilled the f32 form and serialized
      // its wgmmas.)
      float part[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) part[r] = 0.f;
      // A full stage in one group (two for f32, whose split rows would
      // not fit the registers at once); a shorter last one (d16 not a
      // multiple of 128) in groups of 4, 2 and 1 k-steps, the stage
      // released by the last.
      if (nk == KSTEPS && FORM == F32) {
        stage_math<FORM, 4, QP>(part, rows, P, r0, t, 0, bq, 0u, wg, turn_n);
        stage_math<FORM, 4, QP>(part, rows, P, r0, t, 4, bq, empty, wg, turn_n);
      } else if (nk == KSTEPS) {
        stage_math<FORM, KSTEPS, QP>(part, rows, P, r0, t, 0, bq, empty, wg, turn_n);
      } else {
        int j0 = 0;
        if (nk & 4) {
          stage_math<FORM, 4, QP>(part, rows, P, r0, t, j0, bq, nk & 3 ? 0u : empty, wg,
                                  turn_n);
          j0 += 4;
        }
        if (nk & 2) {
          stage_math<FORM, 2, QP>(part, rows, P, r0, t, j0, bq, nk & 1 ? 0u : empty, wg,
                                  turn_n);
          j0 += 2;
        }
        if (nk & 1) stage_math<FORM, 1, QP>(part, rows, P, r0, t, j0, bq, empty, wg, turn_n);
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[r] = kc == 0 ? part[r] : __fadd_rn(acc[r], part[r]);
    }
    if (!active) continue;

    // Epilogue: acc[4c + 2h + e] is row r0 + 8h, query 8c + 2t + e.
    const int grow = tile * RT + r0;  // global row of h = 0
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int h = (r >> 1) & 1;
      acc[r] = SCALED ? __fadd_rn(__fmul_rn(acc[r], sc[h]), b[h])
                      : __fadd_rn(acc[r], b[h]);
    }
    if (lb >= 4) {
      // Rows r0 and r0 + 8 in the thread, then a butterfly over the 8 row
      // groups g (lanes 4 apart): every lane ends with its warp's 16-row
      // winner of each of its 16 queries, and lanes g = 0 write them.
      float bv[16];
      int bi[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float v0 = acc[4 * (c >> 1) + (c & 1)], v1 = acc[4 * (c >> 1) + 2 + (c & 1)];
        bv[c] = v1 > v0 ? v1 : v0;
        bi[c] = v1 > v0 ? grow + 8 : grow;
      }
#pragma unroll
      for (int mask = 4; mask <= 16; mask <<= 1)
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv[c], mask);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[c], mask);
          if (beats(ov, oi, bv[c], bi[c])) {
            bv[c] = ov;
            bi[c] = oi;
          }
        }
      // Slot (q, wi) of the table is lane (g = 0, t)'s own: the warp's
      // running winner of query q over the bin's stages so far (later
      // stages are later rows: a tie keeps the earlier).  Once the bin's
      // last stage is in, one thread a query combines the 4 warps' slots
      // (or, for bins of 16 and 32 rows, the slots of each bin).
      const bool first = (tile & (stages_per_bin - 1)) == 0;
      if (g == 0) {
        float held[16];  // all loads before any store: no serial chain
#pragma unroll
        for (int c = 0; c < 16; ++c)
          held[c] = first ? MASK : Tv[(8 * (c >> 1) + 2 * t + (c & 1)) * TP + wi];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int slot = (8 * (c >> 1) + 2 * t + (c & 1)) * TP + wi;
          if (first || bv[c] > held[c]) {
            Tv[slot] = bv[c];
            Ti[slot] = bi[c];
          }
        }
      }
      if (((tile + 1) & (stages_per_bin - 1)) == 0) {
        wg_sync(wg);
        if (ct < WQ) take_slots(4, lb <= 4 ? 1 : min(1 << (lb - 4), 4));
        wg_sync(wg);  // the table has been read
      }
    } else {
      // Bins of 1-8 rows: lb shuffle levels over the row groups g.
      int bi[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) bi[r] = grow + 8 * ((r >> 1) & 1);
      for (int lv = 0; lv < lb; ++lv)
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const float ov = __shfl_xor_sync(0xffffffffu, acc[r], 4 << lv);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[r], 4 << lv);
          if (beats(ov, oi, acc[r], bi[r])) {
            acc[r] = ov;
            bi[r] = oi;
          }
        }
      const int nslot = RT >> lb;
      const bool holder = (g & ((1 << lb) - 1)) == 0;
      for (int round = 0; round * SLOTS < nslot; ++round) {
        wg_sync(wg);
        if (holder)
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const int slot = (r0 + 8 * ((r >> 1) & 1)) >> lb;
            if (slot / SLOTS != round) continue;
            const int q = 8 * (r >> 2) + 2 * t + (r & 1);
            Tv[q * TP + slot % SLOTS] = acc[r];
            Ti[q * TP + slot % SLOTS] = bi[r];
          }
        wg_sync(wg);
        if (ct < WQ) take_slots(min(nslot - round * SLOTS, SLOTS), 1);
      }
    }
  }

  if (both && wg == 0) turn_wait(wg, turn_n);  // warpgroup 1's last pass
  if (FUSED && carry_k && ct < WQ && gq < m) {
    // out_* are the split carries, (splits, m, k_scan).
    const size_t o = ((size_t)blockIdx.y * m + gq) * k_scan;
    for (int j = 0; j < k_scan; ++j) {
      out_v[o + j] = cv[j];
      out_i[o + j] = ci[j];
    }
  }
}

// --- the carry merge ----------------------------------------------------------
//
// pr_merge_kernel<G, CPL, STAGED> folds the splits' sorted carries,
// (splits, m, k_scan), into the (m, k_scan) result: the rest of the
// reference's one long carry (_merge_topk_carry :219), which the port cuts
// across blocks.  The result is a stable descending sort of the carries
// laid end to end: among equal values the lower split wins, within a
// split the carry's order holds, and -0.0 ties +0.0.  It moves
// splits*m*k_scan*8 bytes in and m*k_scan*8 out, a fraction of a
// microsecond at the main paths' plans: a launch, and the latency of each
// query's k_scan dependent steps, bound it.
//
// A group of G lanes (8, 16 or 32) takes a query; lane l owns the splits
// l, l + G, ... (CPL of them at most) and keeps each one's head in
// registers as a 64-bit key (head_key), indexed only under unrolled loops,
// so no array reaches local memory.  Each output is the largest head of
// the group, a shuffle butterfly of log2(G) steps; the one lane that holds
// it writes it and advances that head.  With STAGED the group first copies
// its query's carries into shared memory (cp.async, all in flight at
// once), so an advance reads shared memory; without it (the carries do not
// fit) it reads device memory.
constexpr int MERGE_WARPS = 4;          // warps per block at most
constexpr int MERGE_SMEM = 48 * 1024;   // staged bytes a block, as a rule

// The head of split s at value v: the value's bits ordered as unsigned
// integers (-0.0 as +0.0) above the inverted split.  Never 0, which marks
// a slot without a head.
__device__ __forceinline__ unsigned long long head_key(float v, int s) {
  uint32_t b = __float_as_uint(v == 0.f ? 0.f : v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (uint32_t)(MAX_SPLITS - s);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

template <int G, int CPL, bool STAGED>
__global__ void __launch_bounds__(32 * MERGE_WARPS)
    pr_merge_kernel(const float* __restrict__ part_v,
                    const int* __restrict__ part_i, int m, int k_scan,
                    int splits, float* __restrict__ out_v,
                    int* __restrict__ out_i) {
  extern __shared__ __align__(16) char merge_smem[];
  const int gl = threadIdx.x % G;     // lane in the group
  const int group = threadIdx.x / G;  // group in the block
  const int row = blockIdx.x * (blockDim.x / G) + group;
  const bool active = row < m;
  // Carry of split s at V[s * stride], I[s * stride].
  const float* V = part_v + (size_t)row * k_scan;
  const int* I = part_i + (size_t)row * k_scan;
  size_t stride = (size_t)m * k_scan;
  if constexpr (STAGED) {
    const int n = splits * k_scan;
    float* sv = reinterpret_cast<float*>(merge_smem) + (size_t)group * 2 * n;
    int* si = reinterpret_cast<int*>(sv + n);
    if (active) {
      // Entry e = s * k_scan + p, e = gl, gl + G, ...
      const int ds = G / k_scan, dp = G % k_scan;
      int s = gl / k_scan, p = gl % k_scan;
      for (int e = gl; e < n; e += G) {
        cp_async4(sv + e, V + s * stride + p);
        cp_async4(si + e, I + s * stride + p);
        s += ds;
        p += dp;
        if (p >= k_scan) {
          p -= k_scan;
          ++s;
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
    V = sv;
    I = si;
    stride = k_scan;
  }
  unsigned long long key[CPL];
  int pos[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int s = gl + G * c;
    pos[c] = 0;
    key[c] = active && s < splits ? head_key(V[s * stride], s) : 0ull;
  }
  unsigned long long best = 0;
  int bc = 0;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (key[c] > best) {
      best = key[c];
      bc = c;
    }
  const size_t o = (size_t)row * k_scan;
  for (int j = 0; j < k_scan; ++j) {
    unsigned long long top = best;
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, top, d);
      top = other > top ? other : top;
    }
    // Keys are unique (the split is in them): one lane of the group wins.
    if (active && best == top) {
      int p = 0;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c == bc) p = pos[c];
      const int s = gl + G * bc;
      const size_t at = s * stride + p;
      out_v[o + j] = V[at];
      out_i[o + j] = I[at];
      const unsigned long long next =
          p + 1 < k_scan ? head_key(V[at + 1], s) : 0ull;
      best = 0;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (c == bc) {
          key[c] = next;
          pos[c] = p + 1;
        }
      }
      int nb = 0;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (key[c] > best) {
          best = key[c];
          nb = c;
        }
      bc = nb;
    }
  }
}

// The merge's launch: G lanes a query, CPL splits a lane, `warps` warps a
// block and, if `bytes` > 0, that many bytes of carries staged in shared
// memory.  A block stages at most MERGE_SMEM bytes unless one warp's
// queries need more (up to the device's limit, `budget`); past that the
// heads are read from device memory.
struct MergePlan {
  int lanes, cpl, warps, bytes;
};
MergePlan merge_plan(int splits, int k_scan, int budget) {
  MergePlan p;
  p.lanes = splits <= 8 ? 8 : splits <= 16 ? 16 : 32;
  const int need = (splits + p.lanes - 1) / p.lanes;
  p.cpl = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  const long long warp_bytes = 32LL / p.lanes * splits * k_scan * 8;
  p.warps = warp_bytes <= MERGE_SMEM
                ? (int)(MERGE_SMEM / warp_bytes < MERGE_WARPS
                            ? MERGE_SMEM / warp_bytes
                            : MERGE_WARPS)
                : 1;
  p.bytes = warp_bytes <= budget ? (int)(p.warps * warp_bytes) : 0;
  if (!p.bytes) p.warps = MERGE_WARPS;
  return p;
}

template <int G, int CPL, bool STAGED>
int launch_merge_for(const MergePlan& p, const float* part_v,
                     const int* part_i, int m, int k_scan, int splits,
                     float* out_v, int* out_i, cudaStream_t stream) {
  if (p.bytes > MERGE_SMEM) {
    const cudaError_t err =
        cudaFuncSetAttribute(pr_merge_kernel<G, CPL, STAGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int queries = p.warps * (32 / G);
  pr_merge_kernel<G, CPL, STAGED><<<(m + queries - 1) / queries, 32 * p.warps,
                                    p.bytes, stream>>>(part_v, part_i, m,
                                                       k_scan, splits, out_v,
                                                       out_i);
  return (int)cudaGetLastError();
}

template <bool STAGED>
int launch_merge(const MergePlan& p, const float* part_v, const int* part_i,
                 int m, int k_scan, int splits, float* out_v, int* out_i,
                 cudaStream_t stream) {
#define PR_MERGE(G, CPL)                                                      \
  launch_merge_for<G, CPL, STAGED>(p, part_v, part_i, m, k_scan, splits,     \
                                   out_v, out_i, stream)
  switch (p.lanes * 16 + p.cpl) {
    case 8 * 16 + 1: return PR_MERGE(8, 1);
    case 16 * 16 + 1: return PR_MERGE(16, 1);
    case 32 * 16 + 1: return PR_MERGE(32, 1);
    case 32 * 16 + 2: return PR_MERGE(32, 2);
    case 32 * 16 + 4: return PR_MERGE(32, 4);
    case 32 * 16 + 8: return PR_MERGE(32, 8);
    default: return -1;
  }
#undef PR_MERGE
}

__global__ void pr_empty_kernel() {}

int check_scan_args(int form, int qparts, const void* scale, int m, int nks,
                    int d_pad, int n_pad, int log2_bin, int tiles_per_split,
                    int splits) {
  if (form < F32 || form > I4) return -1;
  if (qparts != 3 && (qparts != 1 || form == F32)) return -1;
  if (is_scaled(form) != (scale != nullptr)) return -1;
  if (m <= 0 || nks <= 0 || d_pad % 16 || 16 * nks > d_pad) return -1;
  if (form == I4 && d_pad % 32) return -1;  // 16-byte row chunks
  if (n_pad <= 0 || n_pad % BN) return -1;
  if (log2_bin < 0 || log2_bin > 30 || n_pad % (1 << log2_bin)) return -1;
  const int tiles_per_bin = log2_bin > 7 ? (1 << (log2_bin - 7)) : 1;
  if (tiles_per_split <= 0 || tiles_per_split % tiles_per_bin) return -1;
  if (splits <= 0 || splits > MAX_SPLITS) return -1;
  if ((long long)splits * tiles_per_split < n_pad / BN) return -1;
  return 0;
}

// The launch's shared-memory plan within `budget` bytes: the queries'
// split parts resident for the whole row range if they fit with two
// stages, else one stage's lanes reloaded at every stage; then as many
// stages as fit, up to MAX_STAGES.  Returns the bytes (> budget: no fit).
struct Plan {
  int carry_k, resident, stages, bytes;
};
Plan scan_plan(int form, int qparts, bool fused, int nks, int k_scan,
               int budget) {
  Plan p;
  p.carry_k = fused && k_scan <= SMEM_K_SCAN ? k_scan : 0;
  p.resident = smem_layout(form, qparts, nks, p.carry_k, 2).total <= budget;
  const int b_ksteps = p.resident ? nks : (nks < KSTEPS ? nks : KSTEPS);
  p.stages = MAX_STAGES;
  while (p.stages > 2 &&
         smem_layout(form, qparts, b_ksteps, p.carry_k, p.stages).total > budget)
    --p.stages;
  p.bytes = smem_layout(form, qparts, b_ksteps, p.carry_k, p.stages).total;
  return p;
}

int smem_budget(int* budget) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

template <bool FUSED, int FORM, int QP>
int launch_scan(const void* q, const void* db, const float* scale,
                const float* bias, int m, int nks, int d_pad, int n_pad,
                int log2_bin, int tiles_per_split, int splits, int k_scan,
                float* out_v, int* out_i, int out_cols, cudaStream_t stream) {
  int budget = 0;
  cudaError_t err = (cudaError_t)smem_budget(&budget);
  if (err != cudaSuccess) return (int)err;
  const Plan p = scan_plan(FORM, QP, FUSED, nks, k_scan, budget);
  const int carry_k = p.carry_k, resident = p.resident, stages = p.stages;
  const int bytes = p.bytes;
  if (bytes > budget) return -1;
  err = cudaFuncSetAttribute(pr_scan_kernel<FUSED, FORM, QP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + BQ - 1) / BQ, splits);
  pr_scan_kernel<FUSED, FORM, QP><<<grid, THREADS, bytes, stream>>>(
      q, static_cast<const char*>(db), scale, bias, m, nks, d_pad, n_pad,
      log2_bin, tiles_per_split, k_scan, carry_k, resident, stages, out_v,
      out_i, out_cols);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int launch_form(int form, int qparts, const void* q, const void* db,
                const float* scale, const float* bias, int m, int nks,
                int d_pad, int n_pad, int log2_bin, int tiles_per_split,
                int splits, int k_scan, float* out_v, int* out_i, int out_cols,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define PR_LAUNCH(F, QP)                                                      \
  launch_scan<FUSED, F, QP>(q, db, scale, bias, m, nks, d_pad, n_pad,         \
                            log2_bin, tiles_per_split, splits, k_scan, out_v, \
                            out_i, out_cols, st)
  switch (form * 4 + qparts) {
    case F32 * 4 + 3: return PR_LAUNCH(F32, 3);
    case BF16 * 4 + 3: return PR_LAUNCH(BF16, 3);
    case I8 * 4 + 3: return PR_LAUNCH(I8, 3);
    case I4 * 4 + 3: return PR_LAUNCH(I4, 3);
    case BF16 * 4 + 1: return PR_LAUNCH(BF16, 1);
    case I8 * 4 + 1: return PR_LAUNCH(I8, 1);
    case I4 * 4 + 1: return PR_LAUNCH(I4, 1);
    default: return -1;
  }
#undef PR_LAUNCH
}

}  // namespace

extern "C" {

// Error codes: 0 success, -1 bad arguments, >0 a cudaError_t.
const char* pr_error_string(int code) {
  if (code == -1) return "invalid arguments for the partial_reduce kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Two-pass: bin winners, out (m, n_pad >> log2_bin).  `q` holds the
// (m, d_pad) queries, f32 (qparts 3) or bf16 (qparts 1, not with f32
// rows), of which the first 16 * nks lanes (nks k-steps of 16: the lanes
// the function needs) are scanned; `db` holds rows of the stored `form`,
// d_pad lanes a row; `scale` is the (n_pad) per-row scale of the int8 and
// int4 forms, null for the others.
int pr_two_pass(int form, int qparts, const void* q, const void* db,
                const float* scale, const float* bias, int m, int nks,
                int d_pad, int n_pad, int log2_bin, int tiles_per_split,
                int splits, float* out_v, int* out_i, void* stream) {
  if (check_scan_args(form, qparts, scale, m, nks, d_pad, n_pad, log2_bin,
                      tiles_per_split, splits))
    return -1;
  return launch_form<false>(form, qparts, q, db, scale, bias, m, nks, d_pad,
                            n_pad, log2_bin, tiles_per_split, splits, 0, out_v,
                            out_i, n_pad >> log2_bin, stream);
}

// Fused scan: split carries, part (splits, m, k_scan); any k_scan >= 1.
int pr_fused_scan(int form, int qparts, const void* q, const void* db,
                  const float* scale, const float* bias, int m, int nks,
                  int d_pad, int n_pad, int log2_bin, int k_scan,
                  int tiles_per_split, int splits, float* part_v, int* part_i,
                  void* stream) {
  if (check_scan_args(form, qparts, scale, m, nks, d_pad, n_pad, log2_bin,
                      tiles_per_split, splits))
    return -1;
  if (k_scan <= 0) return -1;
  return launch_form<true>(form, qparts, q, db, scale, bias, m, nks, d_pad,
                           n_pad, log2_bin, tiles_per_split, splits, k_scan,
                           part_v, part_i, k_scan, stream);
}

// The shared-memory plan of one scan launch on the current device: its
// dynamic shared bytes (-1 for bad arguments, -2 if it does not fit), and
// in *stages and *resident the stage ring's depth and whether the
// queries' parts stay resident.
int pr_scan_plan(int form, int qparts, int fused, int nks, int k_scan,
                 int* stages, int* resident) {
  int budget = 0;
  if (form < F32 || form > I4 || nks <= 0 || k_scan < 0) return -1;
  if (qparts != 3 && (qparts != 1 || form == F32)) return -1;
  if (smem_budget(&budget)) return -1;
  const Plan p = scan_plan(form, qparts, fused != 0, nks, k_scan, budget);
  *stages = p.stages;
  *resident = p.resident;
  return p.bytes > budget ? -2 : p.bytes;
}

// Fused merge: (splits, m, k_scan) carries -> (m, k_scan).
int pr_merge(const float* part_v, const int* part_i, int m, int k_scan,
             int splits, float* out_v, int* out_i, void* stream) {
  int budget = 0;
  if (m <= 0 || k_scan <= 0 || splits <= 0 || splits > MAX_SPLITS) return -1;
  if (smem_budget(&budget)) return -1;
  const MergePlan p = merge_plan(splits, k_scan, budget);
  cudaStream_t st = (cudaStream_t)stream;
  return p.bytes ? launch_merge<true>(p, part_v, part_i, m, k_scan, splits,
                                      out_v, out_i, st)
                 : launch_merge<false>(p, part_v, part_i, m, k_scan, splits,
                                       out_v, out_i, st);
}

// The merge's plan on the current device: its lanes a query, splits a
// lane and warps a block, and the carries' bytes staged in shared memory
// a block (0: read from device memory).  -1 for bad arguments.
int pr_merge_plan(int splits, int k_scan, int* lanes, int* per_lane,
                  int* warps) {
  int budget = 0;
  if (k_scan <= 0 || splits <= 0 || splits > MAX_SPLITS) return -1;
  if (smem_budget(&budget)) return -1;
  const MergePlan p = merge_plan(splits, k_scan, budget);
  *lanes = p.lanes;
  *per_lane = p.cpl;
  *warps = p.warps;
  return p.bytes;
}

// One launch of an empty kernel: the floor under any launch's time.
int pr_empty(void* stream) {
  pr_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
