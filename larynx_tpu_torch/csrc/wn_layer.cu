// Fused WaveGlow WN layer for Hopper (sm_90a), f32.
//
// Replaces both TPU kernels of larynx_tpu/ops/wn_layer.py:
//   K3  fused_wn_layer_state  (_kernel_state, pallas_call at :258)
//   K4  fused_wn_layer        (_kernel,       pallas_call at :332)
// One kernel, templated on the mode: the layer alone (K4, writes rs), or
// the layer with its state update on the first, a middle or the last layer
// of a WN stack (K3).
//
// What it computes, for h [B, T, 256], cond [B, T, CC] (channels-last,
// contiguous), ch = 256:
//   a  = h[t-d] @ W0 + h[t] @ W1 + h[t+d] @ W2 + cond[t] @ Wc + bias_a
//        (h zero outside [0, T); bias_a = b_in + b_cond)        [2ch]
//   g  = tanh(a[:ch]) * sigmoid(a[ch:])                          [ch]
//   rs = g @ Wrs + b_rs                                          [RS]
//   K4:    out = rs
//   K3:    h_out = h + rs[:ch], skip_out = skip + rs[ch:]  (middle)
//          h_out = h + rs[:ch], skip_out = rs[ch:]         (first)
//          skip_out = skip + rs, h untouched (RS = ch)     (last)
//          skip_out = rs, h untouched                      (first and last)
// h_out must not alias h: neighbouring tiles read h's halo.
//
// What bounds it: operations.  A time step costs 2 * (2ch * (3ch + CC) +
// ch * RS) = 1.70 MFLOP at ch=256, CC=640, RS=512 against ~(3 * 256 + 640)
// * 4 bytes of activation I/O (~300 FLOP/byte), and the weights (3.4 MB)
// are shared by every time step.  So the design feeds the tensor cores and
// keeps the pre-gate and gated activations on chip:
//
//   * one block per (64-step time tile, batch row), 8 warps.  The first
//     product [64, 3ch + CC] x [3ch + CC, 2ch] runs as a K loop over
//     32-column chunks of its A operand (a tap of h at offset -d, 0 or +d,
//     or a slice of cond), staged in shared memory by a 3-deep cp.async
//     ring; rows outside [0, T) are zero-filled, which is exactly the
//     conv's zero padding, for any dilation (no contiguous halo is held,
//     so d = 128 costs what d = 1 costs).
//   * each warp owns 32 channels and computes both their tanh and their
//     sigmoid columns for all 64 rows, so the gate is formed in registers;
//     the gated tile [64, 256] goes to shared memory as the A operand of
//     the second product, [64, 256] x [256, RS], whose accumulators feed
//     the state update straight from registers.
//   * every product is mma.sync m16n8k8 TF32 in a 3xTF32 split (a*b ~
//     a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, f32 accumulate): f32-level error
//     at three tensor-core products per FMA.
//   * the weights (3.4 MB per layer) cannot live in shared memory as the
//     TPU kernel keeps them in VMEM.  They are arranged in mma fragment
//     order once, at load (ops/wn_layer.py::pack_fragments), stay in the
//     50 MB L2, and go from L2 straight into registers one k-step ahead,
//     each warp reading its own columns as 512-byte coalesced rows; the
//     TF32 hi/lo split is done in registers (half the L2 traffic of a
//     pre-split copy).
// wgmma and TMA are the next step (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 256;           // WN channels
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // time steps per block
constexpr int kMC = kTile / 16;    // 16-row m-chunks; every warp covers all rows
constexpr int kKC = 32;            // K columns per staged A chunk
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kSA = kKC + 4;       // A chunk row stride (floats): conflict-free fragment loads
constexpr int kSG = kCh + 4;       // gated tile row stride
constexpr int kNC1 = 2 * kCh / (8 * kWarps);  // n-chunks per warp, first product (8)
constexpr size_t kSmemBytes = sizeof(float) * (kStages * kTile * kSA + kTile * kSG);

enum Mode { kRs = 0, kMid = 1, kFirst = 2, kLast = 3, kFirstLast = 4 };

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Output column of a warp's n-chunk nc: half (nc / 4) of the product's
// columns, the warp's 32 channels, 8 columns per chunk.
__device__ __forceinline__ int chunk_col(int warp, int nc) {
  return (nc >> 2) * kCh + warp * 32 + (nc & 3) * 8;
}

// acc[j][nc] += A[16 rows of chunk j][8 k] x B[8 k][8 cols of chunk nc] for
// one k-step: A from shared memory (row stride S), B fragments as loaded
// from the packed weights (float4 per pair of n-chunks).
template <int NC, int S>
__device__ __forceinline__ void mma_step(float (&acc)[kMC][NC][4], const float* a_base,
                                         const float4 (&bf)[NC / 2], int g, int t) {
  uint32_t bh[NC][2], bl[NC][2];
#pragma unroll
  for (int p = 0; p < NC / 2; ++p) {
    split(bf[p].x, bh[2 * p][0], bl[2 * p][0]);
    split(bf[p].y, bh[2 * p][1], bl[2 * p][1]);
    split(bf[p].z, bh[2 * p + 1][0], bl[2 * p + 1][0]);
    split(bf[p].w, bh[2 * p + 1][1], bl[2 * p + 1][1]);
  }
#pragma unroll
  for (int j = 0; j < kMC; ++j) {
    const float* p0 = a_base + (16 * j + g) * S + t;
    const float* p1 = p0 + 8 * S;
    const float av[4] = {p0[0], p1[0], p0[4], p1[4]};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split(av[q], ahi[q], alo[q]);
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
      mma_tf32(acc[j][nc], alo, bh[nc]);
      mma_tf32(acc[j][nc], ahi, bl[nc]);
      mma_tf32(acc[j][nc], ahi, bh[nc]);
    }
  }
}

template <int MODE, int RS>
__global__ void __launch_bounds__(kThreads, 1)
wn_layer_kernel(const float* __restrict__ h, const float* __restrict__ cond,
                const float* __restrict__ skip, const float4* __restrict__ frag_in,
                const float* __restrict__ bias_a, const float4* __restrict__ frag_rs,
                const float* __restrict__ b_rs, float* __restrict__ h_out,
                float* __restrict__ skip_out, float* __restrict__ rs_out, int T, int CC,
                int dil) {
  constexpr int kNC2 = RS / (8 * kWarps);  // n-chunks per warp, second product (8 or 4)
  constexpr bool kFirstMode = MODE == kFirst || MODE == kFirstLast;
  extern __shared__ __align__(16) float smem[];
  float* abuf = smem;                          // kStages x [kTile][kSA]
  float* gbuf = smem + kStages * kTile * kSA;  // [kTile][kSG]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int t0 = blockIdx.x * kTile;
  const size_t row0 = (size_t)blockIdx.y * T;  // first time step of this batch row
  const float* hb = h + row0 * kCh;
  const float* cb = cond + row0 * CC;
  const int n_chunks = (3 * kCh + CC) / kKC;

  // A chunk c (K columns [32c, 32c + 32)) -> ring stage s
  auto load_chunk = [&](int c, int s) {
    const int k0 = c * kKC;
    const float* src = cb;
    int ld = CC, off = 0, col = k0 - 3 * kCh;
    if (k0 < 3 * kCh) {
      src = hb;
      ld = kCh;
      off = (k0 / kCh - 1) * dil;
      col = k0 % kCh;
    }
    float* dst = abuf + s * kTile * kSA;
    for (int idx = threadIdx.x; idx < kTile * kKC / 4; idx += kThreads) {
      const int r = idx / (kKC / 4);
      const int q = idx % (kKC / 4);
      const int pos = t0 + r + off;
      const bool inside = pos >= 0 && pos < T;
      cp_async16(dst + r * kSA + 4 * q, src + (size_t)(inside ? pos : 0) * ld + col + 4 * q,
                 inside ? 16 : 0);
    }
  };

  // ---- first product: a = [h taps | cond] @ [W0; W1; W2; Wc] + bias_a
  float acc[kMC][kNC1][4];
#pragma unroll
  for (int nc = 0; nc < kNC1; ++nc) {
    const int col = chunk_col(warp, nc) + 2 * t;
    const float b0 = __ldg(bias_a + col), b1 = __ldg(bias_a + col + 1);
#pragma unroll
    for (int j = 0; j < kMC; ++j) {
      acc[j][nc][0] = b0; acc[j][nc][1] = b1; acc[j][nc][2] = b0; acc[j][nc][3] = b1;
    }
  }

  constexpr int kStep1 = kWarps * (kNC1 / 2) * 32;  // float4s of frag_in per k-step
  const float4* bsrc = frag_in + warp * (kNC1 / 2) * 32 + lane;
  const int n_steps = n_chunks * (kKC / 8);
  float4 bnext[kNC1 / 2];
#pragma unroll
  for (int p = 0; p < kNC1 / 2; ++p) bnext[p] = __ldg(bsrc + p * 32);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1's stage
    if (c + kStages - 1 < n_chunks) load_chunk(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const float* as = abuf + (c % kStages) * kTile * kSA;
#pragma unroll
    for (int kk = 0; kk < kKC / 8; ++kk) {
      const int ks = c * (kKC / 8) + kk;
      float4 bf[kNC1 / 2];
#pragma unroll
      for (int p = 0; p < kNC1 / 2; ++p) bf[p] = bnext[p];
      if (ks + 1 < n_steps) {
#pragma unroll
        for (int p = 0; p < kNC1 / 2; ++p)
          bnext[p] = __ldg(bsrc + (size_t)(ks + 1) * kStep1 + p * 32);
      }
      mma_step<kNC1, kSA>(acc, as + kk * 8, bf, g, t);
    }
  }
  cp_async_wait<0>();

  // ---- gate: the warp holds tanh column c in chunk nc and its sigmoid
  // partner c + ch in chunk nc + 4, at the same fragment positions
#pragma unroll
  for (int j = 0; j < kMC; ++j) {
#pragma unroll
    for (int nc = 0; nc < 4; ++nc) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * j + g + 8 * hr;
        float2 v;
        const float s0 = acc[j][nc + 4][2 * hr], s1 = acc[j][nc + 4][2 * hr + 1];
        v.x = tanhf(acc[j][nc][2 * hr]) * (1.0f / (1.0f + expf(-s0)));
        v.y = tanhf(acc[j][nc][2 * hr + 1]) * (1.0f / (1.0f + expf(-s1)));
        *reinterpret_cast<float2*>(gbuf + row * kSG + warp * 32 + nc * 8 + 2 * t) = v;
      }
    }
  }
  __syncthreads();

  // ---- second product: rs = g @ Wrs + b_rs
  float acc2[kMC][kNC2][4];
#pragma unroll
  for (int nc = 0; nc < kNC2; ++nc) {
    const int col = chunk_col(warp, nc) + 2 * t;
    const float b0 = __ldg(b_rs + col), b1 = __ldg(b_rs + col + 1);
#pragma unroll
    for (int j = 0; j < kMC; ++j) {
      acc2[j][nc][0] = b0; acc2[j][nc][1] = b1; acc2[j][nc][2] = b0; acc2[j][nc][3] = b1;
    }
  }
  constexpr int kStep2 = kWarps * (kNC2 / 2) * 32;
  const float4* rsrc = frag_rs + warp * (kNC2 / 2) * 32 + lane;
  float4 rnext[kNC2 / 2];
#pragma unroll
  for (int p = 0; p < kNC2 / 2; ++p) rnext[p] = __ldg(rsrc + p * 32);
  for (int ks = 0; ks < kCh / 8; ++ks) {
    float4 bf[kNC2 / 2];
#pragma unroll
    for (int p = 0; p < kNC2 / 2; ++p) bf[p] = rnext[p];
    if (ks + 1 < kCh / 8) {
#pragma unroll
      for (int p = 0; p < kNC2 / 2; ++p)
        rnext[p] = __ldg(rsrc + (size_t)(ks + 1) * kStep2 + p * 32);
    }
    mma_step<kNC2, kSG>(acc2, gbuf + ks * 8, bf, g, t);
  }

  // ---- epilogue: each thread owns (row, channel pair) elements of rs
#pragma unroll
  for (int j = 0; j < kMC; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int pos = t0 + 16 * j + g + 8 * hr;
      if (pos >= T) continue;
      const size_t step = row0 + pos;
#pragma unroll
      for (int nc = 0; nc < kNC2; ++nc) {
        const float2 v = make_float2(acc2[j][nc][2 * hr], acc2[j][nc][2 * hr + 1]);
        const int ch = warp * 32 + (nc & 3) * 8 + 2 * t;  // channel within its half
        if (MODE == kRs) {
          *reinterpret_cast<float2*>(rs_out + step * RS + (nc >> 2) * kCh + ch) = v;
        } else if (RS == 2 * kCh && nc < 4) {  // residual half
          const float2 hv = *reinterpret_cast<const float2*>(h + step * kCh + ch);
          *reinterpret_cast<float2*>(h_out + step * kCh + ch) = make_float2(hv.x + v.x, hv.y + v.y);
        } else {  // skip half, or all of rs on the last layer
          float2 sv = v;
          if (!kFirstMode) {
            const float2 old = *reinterpret_cast<const float2*>(skip + step * kCh + ch);
            sv = make_float2(old.x + v.x, old.y + v.y);
          }
          *reinterpret_cast<float2*>(skip_out + step * kCh + ch) = sv;
        }
      }
    }
  }
}

template <int MODE, int RS>
int launch(const float* h, const float* cond, const float* skip, const float* frag_in,
           const float* bias_a, const float* frag_rs, const float* b_rs, float* h_out,
           float* skip_out, float* rs, int B, int T, int CC, int dil, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wn_layer_kernel<MODE, RS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, B);
  wn_layer_kernel<MODE, RS><<<grid, kThreads, kSmemBytes, stream>>>(
      h, cond, skip, reinterpret_cast<const float4*>(frag_in), bias_a,
      reinterpret_cast<const float4*>(frag_rs), b_rs, h_out, skip_out, rs, T, CC, dil);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h [B, T, 256], cond [B, T, CC]; frag_in: [W0; W1; W2; Wc] ([3*256 + CC,
// 512]) and frag_rs: Wrs ([256, rs_out]) in fragment order (see
// ops/wn_layer.py::pack_fragments); bias_a [512], b_rs [rs_out].
// mode 0 (K4) writes rs [B, T, rs_out]; modes 1-4 (K3: middle, first,
// last, first and last) read skip (not on a first layer) and write skip_out
// [B, T, 256] and, unless last, h_out [B, T, 256].
// Returns the CUDA error code of the launch (0 on success).
int wn_layer_f32(const float* h, const float* cond, const float* skip, const float* frag_in,
                 const float* bias_a, const float* frag_rs, const float* b_rs, float* h_out,
                 float* skip_out, float* rs, int B, int T, int CC, int rs_out, int dil, int mode,
                 void* stream) {
  if (B < 1 || B > 65535 || T < 1 || CC < kKC || CC % kKC != 0 || dil < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = rs_out == 2 * kCh;
  if (!wide && rs_out != kCh) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kRs:
      if (!rs) return (int)cudaErrorInvalidValue;
      return wide ? launch<kRs, 2 * kCh>(h, cond, skip, frag_in, bias_a, frag_rs, b_rs, h_out,
                                         skip_out, rs, B, T, CC, dil, s)
                  : launch<kRs, kCh>(h, cond, skip, frag_in, bias_a, frag_rs, b_rs, h_out,
                                     skip_out, rs, B, T, CC, dil, s);
    case kMid:
      if (!wide || !skip || !h_out || !skip_out) return (int)cudaErrorInvalidValue;
      return launch<kMid, 2 * kCh>(h, cond, skip, frag_in, bias_a, frag_rs, b_rs, h_out,
                                   skip_out, rs, B, T, CC, dil, s);
    case kFirst:
      if (!wide || !h_out || !skip_out) return (int)cudaErrorInvalidValue;
      return launch<kFirst, 2 * kCh>(h, cond, skip, frag_in, bias_a, frag_rs, b_rs, h_out,
                                     skip_out, rs, B, T, CC, dil, s);
    case kLast:
      if (wide || !skip || !skip_out) return (int)cudaErrorInvalidValue;
      return launch<kLast, kCh>(h, cond, skip, frag_in, bias_a, frag_rs, b_rs, h_out, skip_out,
                                rs, B, T, CC, dil, s);
    case kFirstLast:
      if (wide || !skip_out) return (int)cudaErrorInvalidValue;
      return launch<kFirstLast, kCh>(h, cond, skip, frag_in, bias_a, frag_rs, b_rs, h_out,
                                     skip_out, rs, B, T, CC, dil, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* wn_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
