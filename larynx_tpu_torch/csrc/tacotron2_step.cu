// Tacotron2's autoregressive decoder steps as one persistent float32 kernel
// a call, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the step to XLA
// (larynx_tpu/models/tacotron2/model.py).  It is here because a decoder
// step is bound by the bytes of its weights, and the step as PyTorch ops is
// ~59 dependent launches of 2-13 us each whose GEMVs reach ~20% of the HBM
// rate.
//
// What it computes: n steps of models/tacotron2/model.py::_prenet and
// ::_decoder_step for B rows (B <= 8 a launch), in that order of
// mathematics, every product in full float32 FFMA:
//   prenet   x1 = drop(relu(W1 prev)), x2 = drop(relu(W2 x1))
//            drop(y) = keep ? y / (1 - p) : 0  (keep masks given per step)
//   attention LSTM   gates = Wa [x2 | ctx | ah] + ba -> (ah, ac)
//   attention        loc = Wd conv(w, cum) + processed memory
//                    e = v . tanh(Wq ah + loc), -1e9 where masked
//                    w = softmax(e), ctx = w . memory, cum += w
//   decoder LSTM     gates = Wdec [ah | ctx | dh] + bdec -> (dh, dc)
//   projection       [mel | gate] = Wp [dh | ctx] + bp
// writing mels [B, n, M] and gate logits [B, n], and the last state into
// the output state buffers (the input state is read at step 0 only).
//
// What bounds it: the bytes of the weights.  A step reads 18.2 M float32
// weights at NVIDIA's widths (72.7 MB; portbench/counts/tacotron2.py counts
// 75 MB with the rows' memory at B = 8, T = 96: 22.4 us at 3.35 TB/s), for
// 2 x B FLOP a weight: at B = 8, 4 FLOP a byte, far under the card's
// float32 ridge (20).  Every weight is streamed from device memory once a
// step; nothing is kept on chip across steps.  The design:
//
//   * one block of 256 threads on each SM, launched cooperatively, so that
//     the grid barriers between a step's 6 dependent stages cannot
//     deadlock; the barrier is a counter whose top bit flips once all
//     blocks arrived (release on the arrival, acquire on the spin's load).
//   * LSTM weights packed once per voice (ops/tacotron2_step.py::
//     pack_decoder): [W_ih | W_hh] joined, the four gate rows of hidden unit
//     j at rows 4j..4j+3, so one warp owns whole units: its lanes stream
//     the 4 rows' columns as float4 (16 bytes a lane, coalesced, L2
//     evict-first), keep the B rows' partial sums in registers, and reduce
//     them with a butterfly that leaves each lane a share of the sums; the
//     unit's cell update runs in that warp.  The rows' inputs sit in shared
//     memory; each float4 of inputs read there serves 4 weight rows.
//   * products off the critical chain run beside its latency-bound work,
//     and each stage streams 4-16 MB: (1) the prenet, on the blocks past
//     the LSTM units | attention W_hh ah(t-1); (2) attention LSTM prenet
//     columns and cell -> ah(t); (3) query | decoder W_ih ah(t); (4)
//     energies, softmax and context on B x parts blocks; (5) decoder W_ih
//     context and cell -> dh(t) | projection context columns | the next
//     step's attention W_ih context; (6) projection -> mel, gate | the next
//     step's location features and decoder W_hh dh(t).
//   * what a stage reads that no stage writes (the next stage's first
//     weights, into L2; the prenet's layer 1 and the location layers'
//     weights and processed memory, into shared memory) is fetched before
//     the grid barrier, so that after it only the step's new values are
//     waited for.
//   * no float atomics: every sum has one order, set by the widths and T
//     and never by B or a row's place in the batch (a batch row equals the
//     same row decoded alone, bit for bit, and a call repeats exactly).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include <algorithm>
#include <mutex>

#ifdef TACOTRON2_STEP_TIMES
#include "tacotron2_step_times.cuh"  // a profiling build's stage clocks
#else
__device__ __forceinline__ void mark(int, int, int) {}
__device__ __forceinline__ void calibrate(int) {}
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 8;   // batch rows a launch (ops/tacotron2_step.py::MAX_ROWS)
constexpr int kLocTile = 16;  // text positions a location-feature item
constexpr float kMaskValue = -1e9f;

// error codes past the CUDA runtime's
constexpr int kErrShape = 10001;
constexpr int kErrOccupancy = 10002;

struct Params {
  // packed weights (ops/tacotron2_step.py::pack_decoder)
  const float* w_pre1;   // [P, M]
  const float* w_pre2;   // [P, P]
  const float* w_att;    // [4 H1, P + E + H1], rows 4j + gate (i, f, g, o)
  const float* b_att;    // [4 H1]
  const float* w_dec;    // [4 H2, H1 + E + H2]
  const float* b_dec;    // [4 H2]
  const float* w_proj;   // [MO, H2 + E]: the mel's rows, the gate's, zero rows
  const float* b_proj;   // [MO]
  const float* w_query;  // [A, H1]
  const float* w_conv;   // [2, KL, F]
  const float* w_dense;  // [F, A]
  const float* w_v;      // [A]
  // inputs
  const float* memory;     // [B, T, E]
  const float* processed;  // [B, T, A]
  const float* mask;       // [B, T]
  const uint8_t* keep;     // [n, 2, B, P] or null (no dropout)
  const float* in_attn_h;  // [B, H1]
  const float* in_attn_c;
  const float* in_dec_h;   // [B, H2]
  const float* in_dec_c;
  const float* in_attn_w;  // [B, T]
  const float* in_attn_cum;
  const float* in_ctx;     // [B, E]
  const float* in_prev;    // [B, M], rows prev_stride apart
  // outputs
  float* attn_h;
  float* attn_c;
  float* dec_h;
  float* dec_c;
  float* attn_w;
  float* attn_cum;
  float* ctx;
  float* mels;   // [B, n, M]
  float* gates;  // [B, n]
  // scratch (tacotron2_step_scratch_floats)
  float* pre1;       // [B, P]
  float* pre2;       // [B, P]
  float* query;      // [B, A]
  float* loc;        // [B, T, A]
  float* part_att;   // [H1, 4 NB]
  float* part_dec;   // [H2, 4 NB]
  float* part_proj;  // [MO / 4, 4 NB]
  unsigned* barrier;
  int B, T, n, M, P, E, H1, H2, A, F, KL, MO, prev_stride;
  int attn_parts;    // context column parts per row (blocks per row)
  float keep_scale;  // 1 - p: a kept prenet value is divided by it
};

// ---------------------------------------------------------------------------
// Memory

// L2's policy for the streamed weights: evicted first, so that the
// memory, the location features and the state stay in L2 across steps
__device__ __forceinline__ unsigned long long evict_first() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// a streamed weight: read once a step, from HBM or the L2 prefetch, not
// kept in L1
__device__ __forceinline__ float4 ld_weight4(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(evict_first()));
  return v;
}

// data written inside the launch: from L2 (ld.global.cg), never a stale L1
// line; plain loads to the compiler, so it may batch them
__device__ __forceinline__ float4 ld_cg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }

__device__ __forceinline__ void prefetch_l2(const float* p, int floats) {
  asm volatile("cp.async.bulk.prefetch.L2.global.L2::cache_hint [%0], %1, %2;" ::"l"(p),
               "r"(floats * 4), "l"(evict_first())
               : "memory");
}

// float4 columns of a 4-row product a lane has in flight, per row: 2 x 32
// lanes x 16 bytes x 4 rows = 4 KB a warp, ~4 MB over the grid, enough to
// keep HBM busy without queueing the stages' other loads behind it
constexpr int kUnroll = 2;

// lanes 0-3 ask L2 for the first columns (one batch of loads) of a product's
// 4 rows of `k` columns
__device__ __forceinline__ void prefetch_rows4(const float* w, int ldw, int k, int lane) {
  k = min(k, 128 * kUnroll);
  if (lane < 4 && k > 0) prefetch_l2(w + (size_t)lane * ldw, k);
}


__device__ __forceinline__ void grid_sync(unsigned* bar, int step, int stage) {
  __syncthreads();
  mark(step, stage, 0);
  if (threadIdx.x == 0) {
    const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old, cur;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(bar), "r"(inc)
                 : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(cur) : "l"(bar) : "memory");
    } while (((old ^ cur) & 0x80000000u) == 0);
  }
  __syncthreads();
  mark(step, stage, 1);
}

// ---------------------------------------------------------------------------
// Warp products

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// Butterfly reduce-scatter of N values a lane over the warp's lanes, pairs
// of lanes combined at xor offsets 16, 8, 4, 2, 1 in that order whatever N:
// every value's sum has the same tree.  After it a[0 .. max(N / 32, 1)) of
// lane l hold the sums of values l * N / 32 + i (N >= 32), or of value
// l >> (5 - log2 N) (N < 32).
template <int N, int O>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* a, int lane) {
    if constexpr (O > 0) {
      if constexpr (N > 1) {
        const bool up = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const float send = up ? a[i] : a[i + N / 2];
          const float keep = up ? a[i + N / 2] : a[i];
          a[i] = keep + __shfl_xor_sync(kFull, send, O);
        }
        ReduceScatter<N / 2, O / 2>::run(a, lane);
      } else {
        a[0] += __shfl_xor_sync(kFull, a[0], O);
        ReduceScatter<1, O / 2>::run(a, lane);
      }
    }
  }
};

// acc[4 b + r] += sum over k < K of w[r * ldw + k] * xs[b * ldx + k]: the
// lane takes the float4 columns lane, lane + 32, ... in order
template <int NB>
__device__ __forceinline__ void gemv4(float (&acc)[4 * NB], const float* __restrict__ w,
                                      int ldw, const float* xs, int ldx, int K, int lane) {
  constexpr int U = kUnroll;
  const int K4 = K >> 2;
  for (int base = 0; base < K4; base += 32 * U) {
    float4 wv[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k4 = base + u * 32 + lane;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[u][r] = k4 < K4 ? ld_weight4(w + (size_t)r * ldw + 4 * k4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k4 = base + u * 32 + lane;
      if (k4 < K4) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 x = *reinterpret_cast<const float4*>(xs + b * ldx + 4 * k4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float& a = acc[4 * b + r];
            a = fmaf(wv[u][r].x, x.x, a);
            a = fmaf(wv[u][r].y, x.y, a);
            a = fmaf(wv[u][r].z, x.z, a);
            a = fmaf(wv[u][r].w, x.w, a);
          }
        }
      }
    }
  }
}

// The 4 rows x NB batch rows' sums of the warp's lanes -> wred[4 b + r]
// (the warp's own shared memory), read after it by any lane.
template <int NB>
__device__ __forceinline__ void reduce_rows4(float (&acc)[4 * NB], float* wred, int lane) {
  constexpr int V = 4 * NB;
  ReduceScatter<V, 16>::run(acc, lane);
  __syncwarp();
  if constexpr (V >= 32) {
#pragma unroll
    for (int i = 0; i < V / 32; ++i) wred[lane * (V / 32) + i] = acc[i];
  } else {
    constexpr int sh = 5 - ilog2(V);
    if ((lane & ((1 << sh) - 1)) == 0) wred[lane >> sh] = acc[0];
  }
  __syncwarp();
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[4 * NB]) {
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) acc[i] = 0.f;
}

// xs[b * K0 + k] = src0[b * stride0 + k] for b < B, 0 for B <= b < NB, and
// likewise src1 into xs + NB * K0 (K1 may be 0): the block's threads, a
// float4 each, 12 loads a thread in flight
template <int NB>
__device__ __forceinline__ void stage(float* xs, const float* src0, int stride0, int K0,
                                      const float* src1, int stride1, int K1, int B) {
  constexpr int kBatch = 12;
  const int n0 = NB * (K0 >> 2), total = n0 + NB * (K1 >> 2);
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const bool first = i < n0;
      const int K4 = (first ? K0 : K1) >> 2, j = first ? i : i - n0;
      const int b = j / max(K4, 1), k4 = j - b * K4;
      v[u] = (i < total && b < B)
                 ? ld_cg4((first ? src0 : src1) + (size_t)b * (first ? stride0 : stride1) + 4 * k4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) *reinterpret_cast<float4*>(xs + 4 * i) = v[u];
    }
  }
}

template <int NB>
__device__ __forceinline__ void stage(float* xs, const float* src, int stride, int K, int B) {
  stage<NB>(xs, src, stride, K, nullptr, 0, 0, B);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The LSTM cell of unit j for batch row b from its 4 gate sums (i, f, g, o).
__device__ __forceinline__ void lstm_cell(const float* g, const float* c_prev, float* c_out,
                                          float* h_out, int idx) {
  const float i = sigmoid(g[0]), f = sigmoid(g[1]), gg = tanhf(g[2]), o = sigmoid(g[3]);
  const float c = fmaf(f, c_prev[idx], __fmul_rn(i, gg));
  c_out[idx] = c;
  h_out[idx] = __fmul_rn(o, tanhf(c));
}

// Epilogues of a reduced 4-row product, by the lanes b < B (wred[4 b + r]):
// the sums into a unit's partial sums, added to them, through the prenet's
// ReLU and dropout, or with the partial sums and the bias into the cell.
template <int NB>
__device__ __forceinline__ void store_part(float* part, int j, const float* wred, int lane,
                                           int B) {
  if (lane < B) {
#pragma unroll
    for (int r = 0; r < 4; ++r) part[(size_t)j * 4 * NB + 4 * lane + r] = wred[4 * lane + r];
  }
}

// (Each epilogue issues its global loads before its first store: a store
// through a pointer the compiler cannot tell apart would hold back the
// loads after it, one round trip each.)
template <int NB>
__device__ __forceinline__ void add_part(float* part, int j, const float* wred, int lane, int B) {
  if (lane < B) {
    float* o = part + (size_t)j * 4 * NB + 4 * lane;
    const float4 old = ld_cg4(o);
    *reinterpret_cast<float4*>(o) =
        make_float4(old.x + wred[4 * lane], old.y + wred[4 * lane + 1],
                    old.z + wred[4 * lane + 2], old.w + wred[4 * lane + 3]);
  }
}

__device__ __forceinline__ void prenet_out(const Params& p, float* out, const uint8_t* keep,
                                           int q, const float* wred, int lane) {
  if (lane < p.B) {
    bool kept[4] = {true, true, true, true};
    if (keep) {
#pragma unroll
      for (int r = 0; r < 4; ++r) kept[r] = keep[(size_t)lane * p.P + 4 * q + r] != 0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float y = fmaxf(wred[4 * lane + r], 0.f);
      if (keep) y = kept[r] ? y / p.keep_scale : 0.f;
      out[(size_t)lane * p.P + 4 * q + r] = y;
    }
  }
}

template <int NB>
__device__ __forceinline__ void cell(const float* part, const float* bias, const float* c_prev,
                                     float* c_out, float* h_out, int H, int j, const float* wred,
                                     int lane, int B) {
  if (lane < B) {
    float g[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      g[r] = ld_cg(part + (size_t)j * 4 * NB + 4 * lane + r) + wred[4 * lane + r] +
             __ldg(bias + 4 * j + r);
    lstm_cell(g, c_prev, c_out, h_out, lane * H + j);
  }
}

// ---------------------------------------------------------------------------
// Block items

// Location features of the attention weights w, cum of step t (read where
// the step wrote them): loc[b, t, :] = processed[b, t, :] + Wd conv([w, cum]).
// A block takes items of kLocTile positions of one row, whose inputs that do
// not depend on the step (the conv's and the dense layer's weights, packed
// transposed: [2, KL, F] and [F, A], so that neighbouring threads read
// neighbouring filters and channels, and its first item's processed memory)
// :func:`loc_prepare` copies into shared memory before the grid barrier, so
// that after it only the attention weights are read.
struct LocSmem {
  float* wc;  // [2 KL][F]
  float* wd;  // [F][A]
  float* sw;  // [2][win]
  float* sf;  // [kLocTile][F]
  float* pm;  // [kLocTile][A]
  int win;
  __device__ LocSmem(const Params& p, float* smem) {
    const int nc = 2 * p.KL * p.F, nd = p.F * p.A;
    win = kLocTile + p.KL - 1;
    wc = smem;
    wd = wc + ((nc + 3) & ~3);
    sw = wd + nd;
    sf = sw + ((2 * win + 3) & ~3);
    pm = sf + kLocTile * p.F;
  }
};

__device__ __forceinline__ int loc_item_count(const Params& p) {
  return p.B * ((p.T + kLocTile - 1) / kLocTile);
}

// processed[b, t0 .. t0 + kLocTile) into pm (0 past T)
__device__ __forceinline__ void loc_processed(const Params& p, int it, float* pm) {
  constexpr int kBatch = 8;
  const int tiles = (p.T + kLocTile - 1) / kLocTile, A = p.A;
  const int b = it / tiles, t0 = (it - b * tiles) * kLocTile;
  for (int i0 = threadIdx.x; i0 < kLocTile * A; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, tt = i / A, t = t0 + tt;
      v[u] = i < kLocTile * A && t < p.T
                 ? __ldg(p.processed + ((size_t)b * p.T + t) * A + (i - tt * A))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < kLocTile * A) pm[i] = v[u];
    }
  }
}

__device__ void loc_prepare(const Params& p, float* smem) {
  constexpr int kBatch = 32;
  if ((int)blockIdx.x >= loc_item_count(p)) return;
  const LocSmem s(p, smem);
  const int nc = 2 * p.KL * p.F, nd = p.F * p.A, np = kLocTile * p.A;
  const int tiles = (p.T + kLocTile - 1) / kLocTile;
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x - b * tiles) * kLocTile;
  for (int i0 = threadIdx.x; i0 < nc + nd + np; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, j = i - nc - nd, tt = j / p.A, t = t0 + tt;
      v[u] = i < nc        ? __ldg(p.w_conv + i)
             : i < nc + nd ? __ldg(p.w_dense + i - nc)
             : i < nc + nd + np && t < p.T
                 ? __ldg(p.processed + ((size_t)b * p.T + t) * p.A + (j - tt * p.A))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nc)
        s.wc[i] = v[u];
      else if (i < nc + nd)
        s.wd[i - nc] = v[u];
      else if (i < nc + nd + np)
        s.pm[i - nc - nd] = v[u];
    }
  }
}

// After loc_prepare and a barrier of the block.
__device__ void loc_items(const Params& p, const float* w_prev, const float* cum_prev,
                          float* smem) {
  const int items = loc_item_count(p);
  if ((int)blockIdx.x >= items) return;
  const LocSmem s(p, smem);
  const int tiles = (p.T + kLocTile - 1) / kLocTile;
  const int F = p.F, A = p.A, KL = p.KL, win = s.win;
  const int pad = (KL - 1) / 2;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / tiles, t0 = (it - b * tiles) * kLocTile;
    __syncthreads();
    if (it != (int)blockIdx.x) loc_processed(p, it, s.pm);
    for (int i = threadIdx.x; i < 2 * win; i += kThreads) {
      const int c = i / win, t = t0 - pad + (i - c * win);
      s.sw[i] = (t >= 0 && t < p.T) ? ld_cg((c ? cum_prev : w_prev) + (size_t)b * p.T + t) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kLocTile * F; i += kThreads) {
      const int tt = i / F, f = i - tt * F;
      float acc = 0.f;
      for (int c = 0; c < 2; ++c) {
        const float* w = s.wc + c * KL * F + f;
        const float* x = s.sw + c * win + tt;
        for (int k = 0; k < KL; ++k) acc = fmaf(w[k * F], x[k], acc);
      }
      s.sf[i] = acc;
    }
    __syncthreads();
    constexpr int kRows = 8;  // positions a thread, sharing its channel's weights
    for (int i = threadIdx.x; i < A * (kLocTile / kRows); i += kThreads) {
      const int g = i / A, a = i - g * A;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int f = 0; f < F; f += 4) {
        const float w0 = s.wd[f * A + a], w1 = s.wd[(f + 1) * A + a];
        const float w2 = s.wd[(f + 2) * A + a], w3 = s.wd[(f + 3) * A + a];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(s.sf + (g * kRows + r) * F + f);
          acc[r] = fmaf(w0, x.x, acc[r]);
          acc[r] = fmaf(w1, x.y, acc[r]);
          acc[r] = fmaf(w2, x.z, acc[r]);
          acc[r] = fmaf(w3, x.w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int tt = g * kRows + r, t = t0 + tt;
        if (t < p.T) p.loc[((size_t)b * p.T + t) * A + a] = s.pm[tt * A + a] + acc[r];
      }
    }
  }
}

// Energies, softmax and context columns [part E/parts, (part + 1) E/parts)
// of batch row b; part 0 also writes the weights and their sum.  A warp
// takes the positions warp, warp + 8, ..., kPos of them in flight.
__device__ void attention_item(const Params& p, int b, int part, const float* cum_prev,
                               float* smem) {
  constexpr int kPos = 12;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.T, A = p.A, E = p.E;
  const int ep = E / p.attn_parts, c0 = part * ep;
  float* qs = smem;                       // [A]
  float* es = qs + A;                     // [T], energies then weights
  float* red = es + ((T + 3) & ~3);       // [32]
  float* cp = red + 32;                   // [kWarps][ep]
  __syncthreads();
  for (int a = tid; a < A; a += kThreads) qs[a] = ld_cg(p.query + (size_t)b * A + a);
  __syncthreads();
  for (int t0 = warp; t0 < T; t0 += kPos * kWarps) {
    float e[kPos], valid[kPos];
#pragma unroll
    for (int u = 0; u < kPos; ++u) {
      const int t = t0 + u * kWarps;
      e[u] = 0.f;
      valid[u] = t < T ? __ldg(p.mask + (size_t)b * T + t) : 0.f;
    }
    for (int a4 = lane; a4 < A / 4; a4 += 32) {
      float4 l[kPos];
#pragma unroll
      for (int u = 0; u < kPos; ++u) {
        const int t = t0 + u * kWarps;
        l[u] = t < T ? ld_cg4(p.loc + ((size_t)b * T + t) * A + 4 * a4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4 q = *reinterpret_cast<const float4*>(qs + 4 * a4);
      const float4 v = __ldg(reinterpret_cast<const float4*>(p.w_v) + a4);
#pragma unroll
      for (int u = 0; u < kPos; ++u) {
        e[u] = fmaf(v.x, tanhf(q.x + l[u].x), e[u]);
        e[u] = fmaf(v.y, tanhf(q.y + l[u].y), e[u]);
        e[u] = fmaf(v.z, tanhf(q.z + l[u].z), e[u]);
        e[u] = fmaf(v.w, tanhf(q.w + l[u].w), e[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPos; ++u) {
      const int t = t0 + u * kWarps;
      const float sum = warp_sum(e[u]);
      if (lane == 0 && t < T) es[t] = valid[u] > 0.f ? sum : kMaskValue;
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int t = tid; t < T; t += kThreads) m = fmaxf(m, es[t]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  float sum = 0.f;
  for (int t = tid; t < T; t += kThreads) {
    const float x = expf(es[t] - m);
    es[t] = x;
    sum += x;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[kWarps + warp] = sum;
  __syncthreads();
  float total = red[kWarps];
  for (int w = 1; w < kWarps; ++w) total += red[kWarps + w];
  for (int t = tid; t < T; t += kThreads) {
    const float w = es[t] / total;
    es[t] = w;
    if (part == 0) {
      const size_t o = (size_t)b * T + t;
      p.attn_w[o] = w;
      p.attn_cum[o] = ld_cg(cum_prev + o) + w;
    }
  }
  __syncthreads();
  const float* mem = p.memory + (size_t)b * T * E + c0;
  for (int c4 = lane; c4 < ep / 4; c4 += 32) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t0 = warp; t0 < T; t0 += kPos * kWarps) {
      float4 mv[kPos];
#pragma unroll
      for (int u = 0; u < kPos; ++u) {
        const int t = t0 + u * kWarps;
        mv[u] = t < T ? __ldg(reinterpret_cast<const float4*>(mem + (size_t)t * E) + c4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kPos; ++u) {
        const int t = t0 + u * kWarps;
        if (t < T) {
          const float w = es[t];
          acc.x = fmaf(w, mv[u].x, acc.x);
          acc.y = fmaf(w, mv[u].y, acc.y);
          acc.z = fmaf(w, mv[u].z, acc.z);
          acc.w = fmaf(w, mv[u].w, acc.w);
        }
      }
    }
    *reinterpret_cast<float4*>(cp + warp * ep + 4 * c4) = acc;
  }
  __syncthreads();
  for (int c = tid; c < ep; c += kThreads) {
    float s = cp[c];
    for (int w = 1; w < kWarps; ++w) s += cp[w * ep + c];
    p.ctx[(size_t)b * E + c0 + c] = s;
  }
}

// The prenet's layer 1 weights into shared memory at a pitch of M + 1
// floats (w1s, past pre1s [NB][P]), coalesced, on the prenet's blocks before
// the grid barrier of the step's first stage.
template <int NB>
__device__ void prenet_prepare(const Params& p, float* pre1s) {
  constexpr int kBatch = 20;
  const int M = p.M, P = p.P, M4 = M >> 2, pitch = M + 1;
  float* w1s = pre1s + NB * P;  // [P][M + 1]
  for (int i0 = threadIdx.x; i0 < P * M4; i0 += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < P * M4 ? __ldg(reinterpret_cast<const float4*>(p.w_pre1) + i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, row = i / M4, c = 4 * (i - row * M4);
      if (i < P * M4) {
        float* o = w1s + row * pitch + c;
        o[0] = v[u].x;
        o[1] = v[u].y;
        o[2] = v[u].z;
        o[3] = v[u].w;
      }
    }
  }
}

// The prenet on one of the prenet blocks, after prenet_prepare and a barrier:
// layer 1 in full into shared memory (pre1s [NB][P], a thread a row), then
// this block's quads of layer 2 (quads q0, q0 + 1, ... < q1, a warp's quads
// q0 + warp, q0 + warp + 8, ...) into p.pre2.  xs holds the last frames
// [NB][M].
template <int NB>
__device__ void prenet_block(const Params& p, const float* xs, float* pre1s, const uint8_t* keep,
                             int q0, int q1, float* wred, float (&acc)[4 * NB]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = p.B, M = p.M, P = p.P, pitch = M + 1;
  const float* w1s = pre1s + NB * P;
  for (int row = threadIdx.x; row < P; row += kThreads) {
    const float* w = w1s + row * pitch;
    bool kept[NB];  // loaded before the sums, which need none of them
#pragma unroll
    for (int b = 0; b < NB; ++b) kept[b] = !keep || (b < B && keep[(size_t)b * P + row] != 0);
    float y[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) y[b] = 0.f;
    for (int k = 0; k < M; k += 4) {
      const float w0 = w[k], w1 = w[k + 1], w2 = w[k + 2], w3 = w[k + 3];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 x = *reinterpret_cast<const float4*>(xs + b * M + k);
        y[b] = fmaf(w0, x.x, y[b]);
        y[b] = fmaf(w1, x.y, y[b]);
        y[b] = fmaf(w2, x.z, y[b]);
        y[b] = fmaf(w3, x.w, y[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float v = fmaxf(y[b], 0.f);
      if (keep) v = kept[b] ? v / p.keep_scale : 0.f;
      pre1s[b * P + row] = v;
    }
  }
  __syncthreads();
  for (int q = q0 + warp; q < q1; q += kWarps) {
    zero<NB>(acc);
    gemv4<NB>(acc, p.w_pre2 + (size_t)4 * q * P, P, pre1s, P, P, lane);
    reduce_rows4<NB>(acc, wred, lane);
    prenet_out(p, p.pre2, keep ? keep + (size_t)B * P : nullptr, q, wred, lane);
  }
}

// ---------------------------------------------------------------------------
// The kernel

template <int NB>
__global__ void __launch_bounds__(kThreads, 1) steps_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = gridDim.x * kWarps;
  const int gw = blockIdx.x * kWarps + warp;
  const int B = p.B, M = p.M, P = p.P, E = p.E, H1 = p.H1, H2 = p.H2, A = p.A;
  const int K1 = P + E + H1, K2 = H1 + E + H2, KP = H2 + E;
  constexpr int V = 4 * NB;
  // shared memory: the stage's inputs, each warp's sums, then a block item's
  const int stage_floats = (NB * max(max(M + H1, P + E), max(H1, H2 + E)) + 3) & ~3;
  float* const xs = smem;
  float* const wred = smem + stage_floats + warp * V;
  float* const item_smem = smem + stage_floats + kWarps * V;
  // hidden unit j of an LSTM runs on warp j (mod nw); the small products'
  // quads on the warps past the units, quad q on warp nw - 1 - q (mod nfree)
  const int nfree = nw > max(H1, H2) ? nw - max(H1, H2) : nw;
  const int qw = nw - 1 - gw < nfree ? nw - 1 - gw : INT_MAX;
  const int quads_query = A / 4, quads_proj = p.MO / 4;
  // the prenet's blocks are the last ones (those of free warps), each with
  // its share of layer 2's quads; the attention's blocks are the last B * parts
  const int pre_blocks = min(max(nfree / kWarps, 1), max(P / 4 / kWarps, 1));
  const int pre_first = gridDim.x - pre_blocks;
  const int quads_per_block = (P / 4 + pre_blocks - 1) / pre_blocks;
  const int attn_first = gridDim.x - B * p.attn_parts;
  float acc[V];

  const auto prefetch_prenet = [&]() {
    if ((int)blockIdx.x >= pre_first) {
      const int q0 = (blockIdx.x - pre_first) * quads_per_block;
      for (int q = q0 + warp; q < min(q0 + quads_per_block, P / 4); q += kWarps)
        prefetch_rows4(p.w_pre2 + (size_t)4 * q * P, P, P, lane);
    }
  };

  calibrate(0);
  // step 0's location features and the off-path products of its stage 1,
  // from the input state: the decoder LSTM's W_hh dh(-1) and the attention
  // LSTM's context columns
  loc_prepare(p, item_smem);
  __syncthreads();
  loc_items(p, p.in_attn_w, p.in_attn_cum, item_smem);
  stage<NB>(xs, p.in_dec_h, H2, H2, p.in_ctx, E, E, B);
  __syncthreads();
  for (int j = gw; j < H2; j += nw) {
    zero<NB>(acc);
    gemv4<NB>(acc, p.w_dec + (size_t)4 * j * K2 + H1 + E, K2, xs, H2, H2, lane);
    reduce_rows4<NB>(acc, wred, lane);
    store_part<NB>(p.part_dec, j, wred, lane, B);
  }
  for (int j = gw; j < H1; j += nw) {
    zero<NB>(acc);
    gemv4<NB>(acc, p.w_att + (size_t)4 * j * K1 + P, K1, xs + NB * H2, E, E, lane);
    reduce_rows4<NB>(acc, wred, lane);
    store_part<NB>(p.part_att, j, wred, lane, B);
  }
  prefetch_prenet();
  for (int j = gw; j < H1; j += nw)
    prefetch_rows4(p.w_att + (size_t)4 * j * K1 + P + E, K1, H1, lane);
  if ((int)blockIdx.x >= pre_first) {
    __syncthreads();
    prenet_prepare<NB>(p, item_smem);
  }

  for (int s = 0; s < p.n; ++s) {
    const bool first = s == 0, more = s + 1 < p.n;
    const float* prev = first ? p.in_prev : p.mels + (size_t)(s - 1) * M;
    const int prev_stride = first ? p.prev_stride : p.n * M;
    const float* attn_h_prev = first ? p.in_attn_h : p.attn_h;
    const float* attn_c_prev = first ? p.in_attn_c : p.attn_c;
    const float* dec_c_prev = first ? p.in_dec_c : p.dec_c;
    const float* cum_prev = first ? p.in_attn_cum : p.attn_cum;
    const uint8_t* keep = p.keep ? p.keep + (size_t)s * 2 * B * P : nullptr;

    // ---- stage 1: the prenet on its blocks | attention LSTM W_hh ah(t-1)
    grid_sync(p.barrier, s, 0);
    stage<NB>(xs, prev, prev_stride, M, attn_h_prev, H1, H1, B);
    __syncthreads();
    if ((int)blockIdx.x >= pre_first) {
      const int q0 = (blockIdx.x - pre_first) * quads_per_block;
      prenet_block<NB>(p, xs, item_smem, keep, q0, min(q0 + quads_per_block, P / 4), wred, acc);
    }
    for (int j = gw; j < H1; j += nw) {
      zero<NB>(acc);
      gemv4<NB>(acc, p.w_att + (size_t)4 * j * K1 + P + E, K1, xs + NB * M, H1, H1, lane);
      reduce_rows4<NB>(acc, wred, lane);
      add_part<NB>(p.part_att, j, wred, lane, B);
    }

    // ---- stage 2: attention LSTM prenet columns, bias and cell -> ah(t)
    for (int j = gw; j < H1; j += nw) prefetch_rows4(p.w_att + (size_t)4 * j * K1, K1, P, lane);
    grid_sync(p.barrier, s, 1);
    stage<NB>(xs, p.pre2, P, P, B);
    __syncthreads();
    for (int j = gw; j < H1; j += nw) {
      zero<NB>(acc);
      gemv4<NB>(acc, p.w_att + (size_t)4 * j * K1, K1, xs, P, P, lane);
      reduce_rows4<NB>(acc, wred, lane);
      cell<NB>(p.part_att, p.b_att, attn_c_prev, p.attn_c, p.attn_h, H1, j, wred, lane, B);
    }

    // ---- stage 3: query | decoder LSTM attention-h columns
    for (int q = qw; q < quads_query; q += nfree)
      prefetch_rows4(p.w_query + (size_t)4 * q * H1, H1, H1, lane);
    for (int j = gw; j < H2; j += nw) prefetch_rows4(p.w_dec + (size_t)4 * j * K2, K2, H1, lane);
    grid_sync(p.barrier, s, 2);
    stage<NB>(xs, p.attn_h, H1, H1, B);
    __syncthreads();
    for (int q = qw; q < quads_query; q += nfree) {
      zero<NB>(acc);
      gemv4<NB>(acc, p.w_query + (size_t)4 * q * H1, H1, xs, H1, H1, lane);
      reduce_rows4<NB>(acc, wred, lane);
      if (lane < B) {
#pragma unroll
        for (int r = 0; r < 4; ++r) p.query[(size_t)lane * A + 4 * q + r] = wred[4 * lane + r];
      }
    }
    for (int j = gw; j < H2; j += nw) {
      zero<NB>(acc);
      gemv4<NB>(acc, p.w_dec + (size_t)4 * j * K2, K2, xs, H1, H1, lane);
      reduce_rows4<NB>(acc, wred, lane);
      add_part<NB>(p.part_dec, j, wred, lane, B);
    }

    // ---- stage 4: energies, softmax and context on the attention's blocks;
    // the others prepare the next step's location features
    grid_sync(p.barrier, s, 3);
    if ((int)blockIdx.x >= attn_first) {
      const int item = blockIdx.x - attn_first;
      attention_item(p, item / p.attn_parts, item % p.attn_parts, cum_prev, item_smem);
    } else if (more) {
      loc_prepare(p, item_smem);
    }

    // ---- stage 5: decoder LSTM context columns, bias and cell -> dh(t) |
    // projection context columns | the next step's attention LSTM context
    // columns
    for (int q = qw; q < quads_proj; q += nfree)
      prefetch_rows4(p.w_proj + (size_t)4 * q * KP + H2, KP, E, lane);
    for (int j = gw; j < H2; j += nw)
      prefetch_rows4(p.w_dec + (size_t)4 * j * K2 + H1, K2, E, lane);
    if (more)
      for (int j = gw; j < H1; j += nw)
        prefetch_rows4(p.w_att + (size_t)4 * j * K1 + P, K1, E, lane);
    grid_sync(p.barrier, s, 4);
    stage<NB>(xs, p.ctx, E, E, B);
    __syncthreads();
    for (int q = qw; q < quads_proj; q += nfree) {
      zero<NB>(acc);
      gemv4<NB>(acc, p.w_proj + (size_t)4 * q * KP + H2, KP, xs, E, E, lane);
      reduce_rows4<NB>(acc, wred, lane);
      store_part<NB>(p.part_proj, q, wred, lane, B);
    }
    for (int j = gw; j < H2; j += nw) {
      zero<NB>(acc);
      gemv4<NB>(acc, p.w_dec + (size_t)4 * j * K2 + H1, K2, xs, E, E, lane);
      reduce_rows4<NB>(acc, wred, lane);
      cell<NB>(p.part_dec, p.b_dec, dec_c_prev, p.dec_c, p.dec_h, H2, j, wred, lane, B);
    }
    if (more) {
      for (int j = gw; j < H1; j += nw) {
        zero<NB>(acc);
        gemv4<NB>(acc, p.w_att + (size_t)4 * j * K1 + P, K1, xs, E, E, lane);
        reduce_rows4<NB>(acc, wred, lane);
        store_part<NB>(p.part_att, j, wred, lane, B);
      }
    }

    // ---- stage 6: projection -> mel, gate | the next step's location
    // features and decoder LSTM W_hh dh(t)
    for (int q = qw; q < quads_proj; q += nfree)
      prefetch_rows4(p.w_proj + (size_t)4 * q * KP, KP, H2, lane);
    if (more) {
      for (int j = gw; j < H2; j += nw)
        prefetch_rows4(p.w_dec + (size_t)4 * j * K2 + H1 + E, K2, H2, lane);
      if ((int)blockIdx.x >= attn_first) loc_prepare(p, item_smem);
    }
    grid_sync(p.barrier, s, 5);
    if (more) loc_items(p, p.attn_w, p.attn_cum, item_smem);
    stage<NB>(xs, p.dec_h, H2, H2, B);
    __syncthreads();
    for (int q = qw; q < quads_proj; q += nfree) {
      zero<NB>(acc);
      gemv4<NB>(acc, p.w_proj + (size_t)4 * q * KP, KP, xs, H2, H2, lane);
      reduce_rows4<NB>(acc, wred, lane);
      if (lane < B) {
        const float4 part = ld_cg4(p.part_proj + (size_t)q * V + 4 * lane);
        const float4 bias = __ldg(reinterpret_cast<const float4*>(p.b_proj) + q);
        const float y[4] = {part.x + wred[4 * lane] + bias.x, part.y + wred[4 * lane + 1] + bias.y,
                            part.z + wred[4 * lane + 2] + bias.z,
                            part.w + wred[4 * lane + 3] + bias.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * q + r;
          if (row < M)
            p.mels[((size_t)lane * p.n + s) * M + row] = y[r];
          else if (row == M)
            p.gates[(size_t)lane * p.n + s] = y[r];
        }
      }
    }
    if (more) {
      for (int j = gw; j < H2; j += nw) {
        zero<NB>(acc);
        gemv4<NB>(acc, p.w_dec + (size_t)4 * j * K2 + H1 + E, K2, xs, H2, H2, lane);
        reduce_rows4<NB>(acc, wred, lane);
        store_part<NB>(p.part_dec, j, wred, lane, B);
      }
      prefetch_prenet();
      for (int j = gw; j < H1; j += nw)
        prefetch_rows4(p.w_att + (size_t)4 * j * K1 + P + E, K1, H1, lane);
      if ((int)blockIdx.x >= pre_first) {
        __syncthreads();
        prenet_prepare<NB>(p, item_smem);
      }
    }
  }
  calibrate(2);
}

// ---------------------------------------------------------------------------
// Host side

struct Dims {
  int B, T, n, M, P, E, H1, H2, A, F, KL, prev_stride;
};

Dims read_dims(const int* d) {
  return Dims{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9], d[10], d[11]};
}

bool dims_ok(const Dims& d) {
  const bool pos = d.B >= 1 && d.B <= kMaxRows && d.T >= 1 && d.n >= 1 && d.F >= 1 && d.KL >= 1;
  const bool by4 = d.M % 4 == 0 && d.P % 4 == 0 && d.E % 4 == 0 && d.H1 % 4 == 0 &&
                   d.H2 % 4 == 0 && d.A % 4 == 0 && d.F % 4 == 0 && d.prev_stride % 4 == 0;
  const bool wide = d.M > 0 && d.P > 0 && d.E > 0 && d.H1 > 0 && d.H2 > 0 && d.A > 0 &&
                    d.prev_stride >= d.M;
  return pos && by4 && wide && d.KL % 2 == 1;
}

// The batch rows a block's registers hold: 1, the stream's and a single
// sentence's, or kMaxRows (rows past B run on zeros).  Two instantiations
// keep nvcc's build of the library short.
int rows_template(int B) { return B == 1 ? 1 : kMaxRows; }

int mo_rows(const Dims& d) { return (d.M + 1 + 3) / 4 * 4; }

// context column parts a row: as many blocks a row as keep 3/4 of the grid
// for the decoder's W_hh, each part at least 64 columns
int attn_parts(const Dims& d, int grid) {
  int parts = 1;
  while (4 * d.B * parts * 2 <= grid && d.E % (8 * parts) == 0 && d.E / (parts * 2) >= 64)
    parts *= 2;
  return parts;
}

size_t smem_floats(const Dims& d, int nb, int parts) {
  const int stage = nb * std::max(std::max(d.M + d.H1, d.P + d.E), std::max(d.H1, d.H2 + d.E));
  const int win = kLocTile + d.KL - 1;
  const int loc = ((2 * d.KL * d.F + 3) & ~3) + d.F * d.A + ((2 * win + 3) & ~3) +
                  kLocTile * d.F + kLocTile * d.A;
  const int attn = d.A + ((d.T + 3) & ~3) + 32 + kWarps * (d.E / parts);
  const int prenet = nb * d.P + d.P * (d.M + 1);
  return (size_t)((stage + 3) & ~3) + kWarps * 4 * nb + std::max(std::max(loc, attn), prenet);
}

size_t scratch_floats(const Dims& d) {
  const int nb = kMaxRows;
  return (size_t)2 * d.B * d.P + (size_t)d.B * d.A + (size_t)d.B * d.T * d.A +
         (size_t)(d.H1 + d.H2) * 4 * nb + (size_t)mo_rows(d) * nb + 4;
}

// per device: SMs, and per rows template the largest dynamic shared memory
// set so far and the blocks an SM then holds (set once, not at each launch,
// so a launch under stream capture makes no attribute calls)
constexpr int kDevices = 64;
std::mutex g_mutex;
int g_sms[kDevices];
int g_smem_set[kDevices][5];
int g_per_sm[kDevices][5];

template <int NB>
int geometry_nb(const Dims& d, int* grid, int* smem_bytes, int* parts, int* per_sm) {
  constexpr int slot = ilog2(NB);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = g_sms[dev];
  *grid = sms;
  *parts = attn_parts(d, sms);
  *smem_bytes = (int)(smem_floats(d, NB, *parts) * sizeof(float));
  if (d.B * *parts >= sms) return kErrShape;
  if (*smem_bytes > g_smem_set[dev][slot]) {
    err = cudaFuncSetAttribute(steps_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem_bytes);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, steps_kernel<NB>, kThreads,
                                                        *smem_bytes);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[dev][slot] = *smem_bytes;
    g_per_sm[dev][slot] = blocks;
  }
  *per_sm = g_per_sm[dev][slot];
  return *per_sm >= 1 ? 0 : kErrOccupancy;
}

int geometry(const Dims& d, int* grid, int* smem_bytes, int* parts, int* per_sm) {
  return rows_template(d.B) == 1 ? geometry_nb<1>(d, grid, smem_bytes, parts, per_sm)
                                 : geometry_nb<kMaxRows>(d, grid, smem_bytes, parts, per_sm);
}

template <int NB>
int launch_nb(const Params& p, int grid, int smem_bytes, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, steps_kernel<NB>, p);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" {

// dims = [B, T, n, M, P, E, H1, H2, A, F, KL, prev_stride]; the floats of
// scratch the launch needs
long long tacotron2_step_scratch_floats(const int* dims) {
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return -1;
  return (long long)scratch_floats(d);
}

// The launch plan on the current device: out = [grid blocks, threads a
// block, dynamic shared memory bytes, rows a block's registers hold (NB),
// context parts a row, blocks that fit on an SM].
int tacotron2_step_geometry(const int* dims, int* out) {
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return kErrShape;
  int grid = 0, smem = 0, parts = 0, per_sm = 0;
  const int err = geometry(d, &grid, &smem, &parts, &per_sm);
  out[0] = grid;
  out[1] = kThreads;
  out[2] = smem;
  out[3] = rows_template(d.B);
  out[4] = parts;
  out[5] = per_sm;
  return err;
}

// ptrs, in order: w_pre1, w_pre2, w_att, b_att, w_dec, b_dec, w_proj,
// b_proj, w_query, w_conv, w_dense, w_v, memory, processed, mask, keep (or
// null), in_attn_h, in_attn_c, in_dec_h, in_dec_c, in_attn_w, in_attn_cum,
// in_ctx, in_prev, attn_h, attn_c, dec_h, dec_c, attn_w, attn_cum, ctx,
// mels, gates, scratch.  Every tensor float32 and contiguous but prev (rows
// prev_stride floats apart), keep uint8.  Zeroes the grid barrier's word
// in scratch, then launches.  Returns 0 or an error code.
int tacotron2_steps(const void* const* ptrs, const int* dims, float keep_scale, void* stream) {
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return kErrShape;
  int grid = 0, smem = 0, parts = 0, per_sm = 0;
  int err = geometry(d, &grid, &smem, &parts, &per_sm);
  if (err != 0) return err;
  const auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  const auto o = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  Params p{};
  p.w_pre1 = f(0);
  p.w_pre2 = f(1);
  p.w_att = f(2);
  p.b_att = f(3);
  p.w_dec = f(4);
  p.b_dec = f(5);
  p.w_proj = f(6);
  p.b_proj = f(7);
  p.w_query = f(8);
  p.w_conv = f(9);
  p.w_dense = f(10);
  p.w_v = f(11);
  p.memory = f(12);
  p.processed = f(13);
  p.mask = f(14);
  p.keep = static_cast<const uint8_t*>(ptrs[15]);
  p.in_attn_h = f(16);
  p.in_attn_c = f(17);
  p.in_dec_h = f(18);
  p.in_dec_c = f(19);
  p.in_attn_w = f(20);
  p.in_attn_cum = f(21);
  p.in_ctx = f(22);
  p.in_prev = f(23);
  p.attn_h = o(24);
  p.attn_c = o(25);
  p.dec_h = o(26);
  p.dec_c = o(27);
  p.attn_w = o(28);
  p.attn_cum = o(29);
  p.ctx = o(30);
  p.mels = o(31);
  p.gates = o(32);
  float* scratch = o(33);
  p.B = d.B;
  p.T = d.T;
  p.n = d.n;
  p.M = d.M;
  p.P = d.P;
  p.E = d.E;
  p.H1 = d.H1;
  p.H2 = d.H2;
  p.A = d.A;
  p.F = d.F;
  p.KL = d.KL;
  p.MO = mo_rows(d);
  p.prev_stride = d.prev_stride;
  p.attn_parts = parts;
  p.keep_scale = keep_scale;
  const int nb = kMaxRows;
  p.pre1 = scratch;
  p.pre2 = p.pre1 + (size_t)d.B * d.P;
  p.query = p.pre2 + (size_t)d.B * d.P;
  p.loc = p.query + (size_t)d.B * d.A;
  p.part_att = p.loc + (size_t)d.B * d.T * d.A;
  p.part_dec = p.part_att + (size_t)d.H1 * 4 * nb;
  p.part_proj = p.part_dec + (size_t)d.H2 * 4 * nb;
  p.barrier = reinterpret_cast<unsigned*>(p.part_proj + (size_t)p.MO * nb);
  for (int i = 0; i < 34; ++i)
    if (i != 15 && ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = (int)cudaMemsetAsync(p.barrier, 0, sizeof(unsigned), st);
  if (err != 0) return err;
  return rows_template(d.B) == 1 ? launch_nb<1>(p, grid, smem, st)
                                 : launch_nb<kMaxRows>(p, grid, smem, st);
}

const char* tacotron2_step_error_string(int err) {
  if (err == kErrShape) return "shapes the step kernel does not take";
  if (err == kErrOccupancy) return "the step kernel does not fit on an SM";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
