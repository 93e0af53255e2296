// Fused score + PartialReduce kernels for Hopper (sm_90a), IEEE f32 FFMA.
//
// One scan kernel, pr_scan_kernel<FUSED, FORM>, templated on the selection
// (two-pass or fused) and on the stored form of the database rows, plus
// the carry-merge kernel pr_merge_kernel.  They replace the Pallas TPU
// kernels of src/repro/kernels/partial_reduce.py:
//
//   instantiation                     Pallas body it replaces
//   pr_scan_kernel<false, F32>        _partial_reduce_kernel        :285 (B2)
//   pr_scan_kernel<false, BF16>       _partial_reduce_kernel        :285
//   pr_scan_kernel<false, I8 | I4>    _partial_reduce_kernel_scaled :300 (B3a)
//   pr_scan_kernel<true,  F32>        _fused_kernel                 :316 (B1)
//   pr_scan_kernel<true,  BF16>       _fused_kernel                 :316
//   pr_scan_kernel<true,  I8 | I4>    _fused_kernel_scaled          :323 (B3b)
//   pr_merge_kernel                   the rest of B1/B3b: the carries of the
//                                     splits (see below) into one
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
// where xhat is x converted to f32 exactly (f32 as is; bf16 by widening;
// int8 codes; int4 codes, two per byte, column 2c in the low nibble and
// 2c+1 in the high one, sign-extended) and the scale is applied only to
// the int8 and int4 forms, as a product and then a sum rounded apart
// (__fmul_rn, __fadd_rn: nvcc would contract them into one FMA, which
// rounds once where the reference rounds twice).  The dot product is an
// IEEE f32 FFMA loop for every form: the reference dequantizes, then
// multiplies in f32.
// The fused form pairs a masked winner (value <= MASK/2) with index -1
// and keeps the k_scan best winners in the order (value descending,
// earlier row first).  The reference's carry reaches the same order: its
// carry precedes each tile, its extraction takes the first lane, and
// carry and tile are each in ascending row order, so its output is a
// stable sort of all bin winners by descending value.  Here each block
// inserts winners in ascending row order with a strict '>' (ties keep the
// earlier entry), and the merge takes the lowest split first among equal
// values.  The carry lives in shared memory for k_scan <= 128; above that
// each block keeps it in its own (rows, k_scan) slice of the (splits, m,
// k_scan) output, which no other block touches, with the same rule.
//
// Bound on an H100 SXM: 2*m*n_pad*d FLOPs at the 67 TFLOP/s f32 rate (no
// TF32: it flips near-tie winners) against the stored bytes at 3.35 TB/s
// (n_pad*d times 4, 2, 1 or 0.5 bytes).  So the scan is bound by
// operations from about 40 queries (f32), 20 (bf16), 10 (int8) or 5
// (int4) up; at the Sift1M batch of 10,000 every form is bound by f32
// operations (38.3 ms), and the narrower forms buy no time there, only at
// a small batch.  The int4 form pads d to 256, so at d <= 128 it does
// twice the f32 form's operations.  This first version is a plain
// shared-memory SGEMM tile (64 queries x 128 rows, 4x8 outputs per
// thread, no double buffering) with the bin reduction in its epilogue:
// the (m, n_pad) score matrix never reaches device memory (Eq. 20), the
// rows cross HBM in their stored width and are widened to f32 only in
// shared memory, and only O(m * k_scan * splits) bytes leave the fused
// form.  The row range is split across blocks so that a small batch
// still fills the 132 SMs.  wgmma with 3xTF32 splitting, TMA and
// persistent blocks are later work.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // queries per block
constexpr int BN = 128;      // database rows per column tile
constexpr int BK = 16;       // depth per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads, each 4 rows x 8 columns
constexpr int AP = BM + 4;   // pitch of the transposed query stage
constexpr int BP = BN + 4;   // pitch of the transposed row stage
constexpr int SP = BN + 1;   // pitch of the score tile
constexpr int SMEM_K_SCAN = 128;  // larger carries live in device memory
constexpr int MAX_SPLITS = 64;
constexpr float MASK = -FLT_MAX;  // stages.MASK_VALUE

// Stored forms of the database rows; the values are the C interface's
// `form` argument (kernels/partial_reduce.py FORMS).
enum Form : int { F32 = 0, BF16 = 1, I8 = 2, I4 = 3 };

__host__ __device__ inline int seg_len(int log2_bin) {
  return log2_bin >= 7 ? BN : (1 << log2_bin);  // min(bin, BN)
}

size_t scan_smem_bytes(bool fused, int log2_bin, int k_scan) {
  size_t floats = (size_t)BK * AP + (size_t)BK * BP + (size_t)BM * SP;
  size_t bytes = floats * sizeof(float);
  if (fused) {
    int nseg = BN / seg_len(log2_bin);
    bytes += (size_t)BM * nseg * (sizeof(float) + sizeof(int));
    if (k_scan <= SMEM_K_SCAN)
      bytes += (size_t)BM * k_scan * (sizeof(float) + sizeof(int));
  }
  return bytes;
}

// Row stage: the BN x BK slice [k0, k0 + BK) of rows col0.. into Bs
// (k-major), widened to f32.  Each form reads only its stored bytes: f32
// two 16-byte loads a thread, bf16 one, int8 one 16-byte load on half the
// threads, int4 one 8-byte load (16 nibbles) on half the threads.  `d` is
// the logical width; an int4 row holds d / 2 bytes.
template <int FORM>
__device__ __forceinline__ void load_row_stage(const void* __restrict__ db,
                                               int d, int col0, int k0,
                                               float* Bs, int tid) {
  if constexpr (FORM == F32) {
    const float* x = static_cast<const float*>(db);
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {
      const int e = tid + rep * THREADS;
      const int r = e >> 2, kq = (e & 3) << 2;
      const float4 v = *reinterpret_cast<const float4*>(
          x + (size_t)(col0 + r) * d + k0 + kq);
      Bs[(kq + 0) * BP + r] = v.x;
      Bs[(kq + 1) * BP + r] = v.y;
      Bs[(kq + 2) * BP + r] = v.z;
      Bs[(kq + 3) * BP + r] = v.w;
    }
  } else if constexpr (FORM == BF16) {
    // A bf16 is the upper half of the f32 with the same value.
    const uint16_t* x = static_cast<const uint16_t*>(db);
    const int r = tid >> 1, kq = (tid & 1) << 3;
    const uint4 v = *reinterpret_cast<const uint4*>(
        x + (size_t)(col0 + r) * d + k0 + kq);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Bs[(kq + 2 * j) * BP + r] = __uint_as_float(w[j] << 16);
      Bs[(kq + 2 * j + 1) * BP + r] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else if constexpr (FORM == I8) {
    if (tid < BN) {
      const int8_t* x = static_cast<const int8_t*>(db);
      const int4 v = *reinterpret_cast<const int4*>(
          x + (size_t)(col0 + tid) * d + k0);
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          Bs[(4 * j + b) * BP + tid] = (float)(int8_t)(w[j] >> (8 * b));
    }
  } else {  // I4
    if (tid < BN) {
      const uint8_t* x = static_cast<const uint8_t*>(db);
      const uint2 v = *reinterpret_cast<const uint2*>(
          x + (size_t)(col0 + tid) * (d >> 1) + (k0 >> 1));
      const uint32_t w[2] = {v.x, v.y};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int byte = (int)((w[j] >> (8 * b)) & 0xffu);
          const int c = 2 * (4 * j + b);
          Bs[c * BP + tid] = (float)((int8_t)(byte << 4) >> 4);
          Bs[(c + 1) * BP + tid] = (float)((int8_t)byte >> 4);
        }
    }
  }
}

// Block (blockIdx.x, blockIdx.y) owns queries [64*x, 64*x + 64) and column
// tiles [y * tiles_per_split, ...) of BN rows each; tiles_per_split is a
// multiple of the tiles in one bin, so no bin straddles two blocks.
template <bool FUSED, int FORM>
__global__ void __launch_bounds__(THREADS)
pr_scan_kernel(const float* __restrict__ q, const void* __restrict__ db,
               const float* __restrict__ scale,
               const float* __restrict__ bias, int m, int d, int n_pad,
               int log2_bin, int tiles_per_split, int k_scan,
               float* __restrict__ out_v, int* __restrict__ out_i,
               int out_cols) {
  constexpr bool SCALED = FORM == I8 || FORM == I4;
  extern __shared__ float smem[];
  float* As = smem;                  // [BK][AP]  q tile, k-major
  float* Bs = As + BK * AP;          // [BK][BP]  row tile, k-major
  float* S = Bs + BK * BP;           // [BM][SP]  biased scores
  const int sl = seg_len(log2_bin);  // columns per bin inside one tile
  const int nseg = BN / sl;          // bins (or bin pieces) per tile
  float* Wv = S + BM * SP;           // [BM][nseg] winners (FUSED)
  int* Wi = reinterpret_cast<int*>(Wv + BM * nseg);
  float* Cv = reinterpret_cast<float*>(Wi + BM * nseg);  // [BM][k_scan]
  int* Ci = reinterpret_cast<int*>(Cv + BM * k_scan);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  const int n_tiles = n_pad / BN;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  const int tiles_per_bin = log2_bin > 7 ? (1 << (log2_bin - 7)) : 1;
  const bool smem_carry = k_scan <= SMEM_K_SCAN;

  // Thread r < BM owns query row0 + r's carry: in shared memory, or in
  // the block's own slice of out_* (splits, m, k_scan), which then is the
  // output itself.  A row past m has no slice and keeps no carry.
  float* cv = nullptr;
  int* ci = nullptr;
  if (FUSED && tid < BM) {
    if (smem_carry) {
      cv = Cv + tid * k_scan;
      ci = Ci + tid * k_scan;
    } else if (row0 + tid < m) {
      const size_t o = ((size_t)blockIdx.y * m + row0 + tid) * k_scan;
      cv = out_v + o;
      ci = out_i + o;
    }
    if (cv != nullptr) {
      for (int j = 0; j < k_scan; ++j) {
        cv[j] = MASK;
        ci[j] = -1;
      }
    }
  }
  float run_v = MASK;  // running winner of a bin wider than BN (tid < BM)
  int run_i = 0;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * BN;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      {  // 64 x 16 query stage: one float4 per thread
        const int r = tid >> 2, kq = (tid & 3) << 2;
        const int gr = row0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < m)
          v = *reinterpret_cast<const float4*>(q + (size_t)gr * d + k0 + kq);
        As[(kq + 0) * AP + r] = v.x;
        As[(kq + 1) * AP + r] = v.y;
        As[(kq + 2) * AP + r] = v.z;
        As[(kq + 3) * AP + r] = v.w;
      }
      load_row_stage<FORM>(db, d, col0, k0, Bs, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk * AP + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * BP + tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[kk * BP + 64 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Epilogue 1: biased (and, for int8/int4, scaled) scores into shared
    // memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if constexpr (SCALED)
          S[r * SP + c] = __fadd_rn(__fmul_rn(acc[i][j], scale[col0 + c]),
                                    bias[col0 + c]);
        else
          S[r * SP + c] = acc[i][j] + bias[col0 + c];
      }
    }
    __syncthreads();

    // Epilogue 2: top-1 of each (query, bin piece); a piece is a whole bin
    // unless the bin is wider than the tile, when a running winner carries
    // across the bin's tiles.  Strict '>' keeps the lowest index on ties.
    const bool bin_ends =
        tiles_per_bin == 1 || ((tile + 1) % tiles_per_bin) == 0;
    for (int p = tid; p < BM * nseg; p += THREADS) {
      const int r = p / nseg, s = p - r * nseg;
      const float* row = S + r * SP + s * sl;
      float best = row[0];
      int bi = 0;
      for (int t = 1; t < sl; ++t) {
        const float v = row[t];
        if (v > best) {
          best = v;
          bi = t;
        }
      }
      int gidx = col0 + s * sl + bi;
      if (tiles_per_bin > 1) {  // nseg == 1, so p == r == tid < BM
        if (tile % tiles_per_bin == 0 || best > run_v) {
          run_v = best;
          run_i = gidx;
        }
        best = run_v;
        gidx = run_i;
      }
      if (!bin_ends) continue;
      if (FUSED) {
        Wv[r * nseg + s] = best;
        Wi[r * nseg + s] = best > MASK * 0.5f ? gidx : -1;
      } else if (row0 + r < m) {
        const size_t o = (size_t)(row0 + r) * out_cols + ((col0 + s * sl) >> log2_bin);
        out_v[o] = best;
        out_i[o] = gidx;
      }
    }
    __syncthreads();

    // Epilogue 3 (fused): thread r inserts its query's winners, in
    // ascending row order, into the query's sorted carry.  The next write
    // of Wv comes after the next tile's __syncthreads, so no barrier is
    // needed here.
    if (FUSED && bin_ends && cv != nullptr) {
      for (int s = 0; s < nseg; ++s) {
        const float v = Wv[tid * nseg + s];
        if (!(v > cv[k_scan - 1])) continue;  // ties keep the earlier entry
        int pos = k_scan - 1;
        while (pos > 0 && v > cv[pos - 1]) {
          cv[pos] = cv[pos - 1];
          ci[pos] = ci[pos - 1];
          --pos;
        }
        cv[pos] = v;
        ci[pos] = Wi[tid * nseg + s];
      }
    }
  }

  if (FUSED && smem_carry && tid < BM && row0 + tid < m) {
    // out_* are the split carries, (splits, m, k_scan).
    const size_t o = ((size_t)blockIdx.y * m + row0 + tid) * k_scan;
    for (int j = 0; j < k_scan; ++j) {
      out_v[o + j] = cv[j];
      out_i[o + j] = ci[j];
    }
  }
}

// One thread per query: k-way merge of the splits' sorted carries.  Among
// equal values the lower split (earlier rows) wins, as in one long carry.
__global__ void pr_merge_kernel(const float* __restrict__ part_v,
                                const int* __restrict__ part_i, int m,
                                int k_scan, int splits,
                                float* __restrict__ out_v,
                                int* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  int head[MAX_SPLITS];
  for (int s = 0; s < splits; ++s) head[s] = 0;
  for (int j = 0; j < k_scan; ++j) {
    int bs = -1;
    float bv = 0.f;
    for (int s = 0; s < splits; ++s) {
      if (head[s] >= k_scan) continue;
      const float v = part_v[((size_t)s * m + row) * k_scan + head[s]];
      if (bs < 0 || v > bv) {
        bs = s;
        bv = v;
      }
    }
    out_v[(size_t)row * k_scan + j] = bv;
    out_i[(size_t)row * k_scan + j] =
        part_i[((size_t)bs * m + row) * k_scan + head[bs]];
    ++head[bs];
  }
}

int check_scan_args(int form, const float* scale, int m, int d, int n_pad,
                    int log2_bin, int tiles_per_split, int splits) {
  if (form < F32 || form > I4) return -1;
  if ((form == I8 || form == I4) != (scale != nullptr)) return -1;
  if (m <= 0 || d <= 0 || d % BK || n_pad <= 0 || n_pad % BN) return -1;
  if (log2_bin < 0 || log2_bin > 30 || n_pad % (1 << log2_bin)) return -1;
  const int tiles_per_bin = log2_bin > 7 ? (1 << (log2_bin - 7)) : 1;
  if (tiles_per_split <= 0 || tiles_per_split % tiles_per_bin) return -1;
  if (splits <= 0 || splits > MAX_SPLITS) return -1;
  if ((long long)splits * tiles_per_split < n_pad / BN) return -1;
  return 0;
}

template <bool FUSED, int FORM>
int launch_scan(const float* q, const void* db, const float* scale,
                const float* bias, int m, int d, int n_pad, int log2_bin,
                int tiles_per_split, int splits, int k_scan, float* out_v,
                int* out_i, int out_cols, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(FUSED, log2_bin, k_scan);
  cudaError_t err = cudaFuncSetAttribute(
      pr_scan_kernel<FUSED, FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + BM - 1) / BM, splits);
  pr_scan_kernel<FUSED, FORM><<<grid, THREADS, smem, stream>>>(
      q, db, scale, bias, m, d, n_pad, log2_bin, tiles_per_split, k_scan,
      out_v, out_i, out_cols);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int launch_form(int form, const float* q, const void* db, const float* scale,
                const float* bias, int m, int d, int n_pad, int log2_bin,
                int tiles_per_split, int splits, int k_scan, float* out_v,
                int* out_i, int out_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define PR_LAUNCH(F)                                                        \
  launch_scan<FUSED, F>(q, db, scale, bias, m, d, n_pad, log2_bin,          \
                        tiles_per_split, splits, k_scan, out_v, out_i,      \
                        out_cols, st)
  switch (form) {
    case F32: return PR_LAUNCH(F32);
    case BF16: return PR_LAUNCH(BF16);
    case I8: return PR_LAUNCH(I8);
    case I4: return PR_LAUNCH(I4);
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

// Two-pass: bin winners, out (m, n_pad >> log2_bin).  `db` holds rows of
// the stored `form`; `scale` is the (n_pad) per-row scale of the int8 and
// int4 forms, null for the others; `d` is the logical (query) width.
int pr_two_pass(int form, const float* q, const void* db, const float* scale,
                const float* bias, int m, int d, int n_pad, int log2_bin,
                int tiles_per_split, int splits, float* out_v, int* out_i,
                void* stream) {
  if (check_scan_args(form, scale, m, d, n_pad, log2_bin, tiles_per_split,
                      splits))
    return -1;
  return launch_form<false>(form, q, db, scale, bias, m, d, n_pad, log2_bin,
                            tiles_per_split, splits, 0, out_v, out_i,
                            n_pad >> log2_bin, stream);
}

// Fused scan: split carries, part (splits, m, k_scan); any k_scan >= 1.
int pr_fused_scan(int form, const float* q, const void* db,
                  const float* scale, const float* bias, int m, int d,
                  int n_pad, int log2_bin, int k_scan, int tiles_per_split,
                  int splits, float* part_v, int* part_i, void* stream) {
  if (check_scan_args(form, scale, m, d, n_pad, log2_bin, tiles_per_split,
                      splits))
    return -1;
  if (k_scan <= 0) return -1;
  return launch_form<true>(form, q, db, scale, bias, m, d, n_pad, log2_bin,
                           tiles_per_split, splits, k_scan, part_v, part_i,
                           k_scan, stream);
}

// Fused merge: (splits, m, k_scan) carries -> (m, k_scan).
int pr_merge(const float* part_v, const int* part_i, int m, int k_scan,
             int splits, float* out_v, int* out_i, void* stream) {
  if (m <= 0 || k_scan <= 0 || splits <= 0 || splits > MAX_SPLITS) return -1;
  const int threads = 128;
  pr_merge_kernel<<<(m + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(part_v, part_i, m, k_scan, splits,
                                            out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
