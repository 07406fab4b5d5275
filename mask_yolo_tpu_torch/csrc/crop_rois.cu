// Bilinear ROI crop for Hopper (sm_90a), tf.image.crop_and_resize semantics.
//
// Replaces the TPU kernel mask_yolo_tpu/ops/pallas_crop.py::crop_rois (body
// _crop_kernel, weights pallas_mask._interp_weights). Its plain PyTorch twin
// is mask_yolo_tpu_torch/ops/roi_align.py::crop_and_resize; the wrapper is
// mask_yolo_tpu_torch/ops/roi_crop.py::crop_rois.
//
//   fmap  [B, H, W, C]  float32 or bfloat16, NHWC contiguous
//   boxes [B, K, 4]     float32 normalized (x1, y1, x2, y2)
//   out   [B, K, P, P, C] in the fmap's dtype
//
// The TPU kernel computed the crop as two GEMMs (wy @ fmap, then wx @ tmp^T)
// because the MXU only does matrix products; its transpose between the two
// was what made it lose on the TPU. Here every output sample (b, k, py, px)
// is a 4-tap gather over C contiguous channels: the two rows y0, y1 and
// columns x0, x1 around the sample point, weighted by the tent weights,
// summed in f32 and rounded once to the output dtype.
//
// Bound: memory. Each output element costs 4 loads and ~6 flops, and the
// fmap of one image (28x28x256 bf16 = 392 KB on the detect path) stays in
// L2 across the K*P*P samples that read it, so device-memory traffic is
// about one read of the fmap plus one write of the crops. Design: one block
// per (b, k, py) row of samples; threadIdx.x walks channels in 16-byte
// vectors (4 f32 or 8 bf16), so a warp reads 512 contiguous bytes of one tap
// and writes 512 contiguous bytes of output; threadIdx.y walks px. The
// kernel allocates nothing and launches on the caller's stream.
//
// Sample coordinates reproduce interp_matrix (ops/roi_align.py) bit for bit
// in f32: the explicit _rn intrinsics stop nvcc from contracting the
// multiply-adds into FMAs, which would round differently.
//
// Backward (crop_rois_backward_f32): the gradient with respect to the fmap,
// which the TPU package left to XLA's autodiff of the separable crop
// (ops/roi_align.py::crop_and_resize). Each output sample (b, k, py, px)
// adds wy*wx*g[b, k, py, px, :] into its four taps of d_fmap; the boxes get
// no gradient. Twin: ops/roi_align.py::crop_and_resize_backward.
//
//   g      [B, K, P, P, C]  float32
//   d_fmap [B, H, W, C]     float32, fully written (no zeroing needed)
//
// Bound: memory. At the training shape (B=16, K=32, P=14, C=256) g is
// 102.8 MB and d_fmap 12.8 MB: >= 35 us at 3.35 TB/s. Design: a gather, not
// an atomic scatter, so the result is the same on every run, as XLA's is.
// A first small kernel computes the taps of every sample (b, k, p) along x
// and y once (the same Taps as the forward's, bit for bit) into a scratch
// buffer the wrapper allocates. Then one block owns one fmap row (b, y) and
// 64 channels. Its G <= 4 row groups of 64 threads split the sample rows
// (k, py) between them (busy fmap rows are touched by ~60 sample rows, and
// one thread walking them all waits on memory ~60 times over). Each group
// skips the rows whose y taps miss y and reads the P samples of the others
// (a warp reads 128 contiguous bytes of g per sample, several samples in
// flight: the px loop is unrolled), accumulating into its own shared-memory
// slab, in which thread c owns column c. The slabs are then summed in group
// order: every cell is summed in one fixed order, so the result is the same
// on every run. Each g row is read by the two blocks of the fmap rows it
// touches, which run side by side, so the second read mostly hits L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N channels moved as one aligned load/store (16 bytes when vectorized).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// The two input taps of one sample point and their tent weights.
struct Taps {
  int i0, i1;
  float w0, w1;
  bool valid;  // false: the sample lies outside the map and reads as 0
};

// Sample i of P along an axis of in_size pixels for the span [lo, hi]:
//   c = lo*n + (i/(P-1)) * ((hi-lo)*n)   (P > 1),   c = 0.5*(lo+hi)*n   (P == 1)
// with n = in_size - 1; weight of pixel g is max(0, 1 - |c - g|); the sample
// is zero when c < 0 or c > n.
__device__ __forceinline__ Taps sample(float lo, float hi, int in_size, int i, int P) {
  const float n = static_cast<float>(in_size - 1);
  float c;
  if (P > 1) {
    const float step = __fdiv_rn(static_cast<float>(i), static_cast<float>(P - 1));
    c = __fadd_rn(__fmul_rn(lo, n), __fmul_rn(step, __fmul_rn(__fsub_rn(hi, lo), n)));
  } else {
    c = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(lo, hi)), n);
  }
  Taps t;
  t.valid = (c >= 0.f) && (c <= n);
  if (!t.valid) {
    t.i0 = t.i1 = 0;
    t.w0 = t.w1 = 0.f;
    return t;
  }
  const float g0 = floorf(c);
  t.i0 = static_cast<int>(g0);
  t.i1 = t.i0 + 1;
  t.w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, g0))));
  t.w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, __fadd_rn(g0, 1.f)))));
  if (t.i1 > in_size - 1) {  // c == n exactly: the second tap has weight 0
    t.i1 = t.i0;
    t.w1 = 0.f;
  }
  return t;
}

template <typename T, int VEC>
__global__ void crop_rois_kernel(const T* __restrict__ fmap, const float* __restrict__ boxes,
                                 T* __restrict__ out, int H, int W, int C, int K, int P) {
  using PackT = Pack<T, VEC>;
  const int py = blockIdx.x % P;
  const int bk = blockIdx.x / P;  // b * K + k
  const int b = bk / K;
  const float x1 = boxes[4 * bk + 0];
  const float y1 = boxes[4 * bk + 1];
  const float x2 = boxes[4 * bk + 2];
  const float y2 = boxes[4 * bk + 3];
  const Taps ty = sample(y1, y2, H, py, P);

  const int cvecs = C / VEC;
  const T* img = fmap + static_cast<size_t>(b) * H * W * C;
  T* orow = out + static_cast<size_t>(blockIdx.x) * P * C;  // out[b, k, py, :, :]

  for (int px = threadIdx.y; px < P; px += blockDim.y) {
    const Taps tx = sample(x1, x2, W, px, P);
    const bool valid = ty.valid && tx.valid;
    PackT* dst = reinterpret_cast<PackT*>(orow + static_cast<size_t>(px) * C);
    const PackT* p00 = reinterpret_cast<const PackT*>(img + (static_cast<size_t>(ty.i0) * W + tx.i0) * C);
    const PackT* p01 = reinterpret_cast<const PackT*>(img + (static_cast<size_t>(ty.i0) * W + tx.i1) * C);
    const PackT* p10 = reinterpret_cast<const PackT*>(img + (static_cast<size_t>(ty.i1) * W + tx.i0) * C);
    const PackT* p11 = reinterpret_cast<const PackT*>(img + (static_cast<size_t>(ty.i1) * W + tx.i1) * C);
    for (int cv = threadIdx.x; cv < cvecs; cv += blockDim.x) {
      PackT r;
      if (valid) {
        const PackT a = p00[cv], bq = p01[cv], cq = p10[cv], d = p11[cv];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          // y first, then x: the order of the twin's two contractions
          const float t0 = ty.w0 * to_float(a.v[j]) + ty.w1 * to_float(cq.v[j]);
          const float t1 = ty.w0 * to_float(bq.v[j]) + ty.w1 * to_float(d.v[j]);
          r.v[j] = from_float<T>(tx.w0 * t0 + tx.w1 * t1);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) r.v[j] = from_float<T>(0.f);
      }
      dst[cv] = r;
    }
  }
}

template <typename T, int VEC>
int launch(const void* fmap, const void* boxes, void* out, int B, int H, int W, int C, int K,
           int P, cudaStream_t stream) {
  const int cvecs = C / VEC;
  dim3 block(cvecs < 128 ? cvecs : 128, 1);
  const int rows = 256 / static_cast<int>(block.x);
  block.y = rows < 1 ? 1 : (rows < P ? rows : P);
  const dim3 grid(static_cast<unsigned>(B) * K * P);
  crop_rois_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(fmap), static_cast<const float*>(boxes), static_cast<T*>(out), H, W,
      C, K, P);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors when the channel count and both pointers allow them,
// one channel per thread otherwise.
template <typename T>
int dispatch(const void* fmap, const void* boxes, void* out, int B, int H, int W, int C, int K,
             int P, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok = C % VEC == 0 && reinterpret_cast<uintptr_t>(fmap) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec_ok ? launch<T, VEC>(fmap, boxes, out, B, H, W, C, K, P, s)
                : launch<T, 1>(fmap, boxes, out, B, H, W, C, K, P, s);
}

constexpr int kBwdChannels = 64;  // channels per backward block (threads)

// The taps of one sample along one axis; w0 = w1 = 0 for a sample off the map.
struct alignas(16) TapRec {
  int i0, i1;
  float w0, w1;
};

// taps[((b*K + k)*P + p)*2 + axis], axis 0 = x, 1 = y.
__global__ void crop_taps_kernel(const float* __restrict__ boxes, TapRec* __restrict__ taps, int H,
                                 int W, int n, int P) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;  // (b*K + k)*P + p
  if (j >= n) return;
  const float* bx = boxes + 4 * (j / P);
  for (int axis = 0; axis < 2; ++axis) {
    const Taps t = axis == 0 ? sample(bx[0], bx[2], W, j % P, P) : sample(bx[1], bx[3], H, j % P, P);
    TapRec r;
    r.i0 = t.i0;
    r.i1 = t.i1;
    r.w0 = t.valid ? t.w0 : 0.f;
    r.w1 = t.valid ? t.w1 : 0.f;
    taps[2 * j + axis] = r;
  }
}

__global__ void crop_rois_backward_kernel(const float* __restrict__ g,
                                          const TapRec* __restrict__ taps,
                                          float* __restrict__ dfmap, int H, int W, int C, int K,
                                          int P) {
  extern __shared__ float smem[];  // [G][W][kBwdChannels], one slab per row group
  const int b = blockIdx.x / H;
  const int y = blockIdx.x % H;
  const int t = threadIdx.x;
  const int grp = threadIdx.y;
  const int G = blockDim.y;
  const int c = blockIdx.y * kBwdChannels + t;
  const bool active = c < C;
  float* acc = smem + grp * W * kBwdChannels;
  for (int x = 0; x < W; ++x) acc[x * kBwdChannels + t] = 0.f;

  // group grp takes sample rows i = grp, grp + G, ...; thread t touches only
  // column t of its own slab
  const TapRec* btaps = taps + static_cast<size_t>(b) * K * P * 2;
  for (int i = grp; active && i < K * P; i += G) {  // sample row i = k*P + py
    const TapRec ty = btaps[2 * i + 1];
    const float wy = (ty.i0 == y ? ty.w0 : 0.f) + (ty.i1 == y ? ty.w1 : 0.f);
    if (wy == 0.f) continue;
    const TapRec* xtaps = btaps + 2 * (i - i % P);  // the sample row's x taps
    const float* grow = g + (static_cast<size_t>(b) * K * P + i) * P * C + c;
#pragma unroll 7
    for (int px = 0; px < P; ++px) {
      const TapRec tx = xtaps[2 * px];
      const float v = wy * grow[static_cast<size_t>(px) * C];
      acc[tx.i0 * kBwdChannels + t] += tx.w0 * v;
      acc[tx.i1 * kBwdChannels + t] += tx.w1 * v;
    }
  }
  __syncthreads();
  if (!active) return;
  // the slabs summed in group order, so the result does not depend on timing
  float* drow = dfmap + static_cast<size_t>(b * H + y) * W * C + c;
  for (int x = grp; x < W; x += G) {
    float sum = 0.f;
    for (int j = 0; j < G; ++j) sum += smem[(j * W + x) * kBwdChannels + t];
    drow[static_cast<size_t>(x) * C] = sum;
  }
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch.

// taps: scratch of 32 * B * K * P bytes, 16-byte aligned. Returns
// cudaErrorInvalidValue, launching nothing, for a map so wide that one row
// group's slab exceeds 48 KB of shared memory (W > 192).
extern "C" int crop_rois_backward_f32(const void* g, const void* boxes, void* taps, void* dfmap,
                                      int B, int H, int W, int C, int K, int P, void* stream) {
  const size_t slab = sizeof(float) * static_cast<size_t>(W) * kBwdChannels;
  if (slab > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = B * K * P;
  crop_taps_kernel<<<(n + 127) / 128, 128, 0, s>>>(static_cast<const float*>(boxes),
                                                   static_cast<TapRec*>(taps), H, W, n, P);
  // up to 4 row groups, as many as 48 KB of shared memory hold
  int groups = 4;
  while (groups > 1 && groups * slab > 48 * 1024) --groups;
  const dim3 grid(static_cast<unsigned>(B) * H, (C + kBwdChannels - 1) / kBwdChannels);
  const dim3 block(kBwdChannels, groups);
  crop_rois_backward_kernel<<<grid, block, groups * slab, s>>>(
      static_cast<const float*>(g), static_cast<const TapRec*>(taps), static_cast<float*>(dfmap),
      H, W, C, K, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crop_rois_f32(const void* fmap, const void* boxes, void* out, int B, int H, int W,
                             int C, int K, int P, void* stream) {
  return dispatch<float>(fmap, boxes, out, B, H, W, C, K, P, stream);
}

extern "C" int crop_rois_bf16(const void* fmap, const void* boxes, void* out, int B, int H,
                              int W, int C, int K, int P, void* stream) {
  return dispatch<__nv_bfloat16>(fmap, boxes, out, B, H, W, C, K, P, stream);
}
