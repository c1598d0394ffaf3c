// Fused spatial-transformer decoder forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paig_reproduction_tpu/ops/pallas/st_decoder.py
// (_decode_kernel, launched from st_decode_pallas). Per frame and object it
// places the object's template and contents at the object's (x, y) with an
// axis-aligned bilinear warp (translation t = (img/2 - p)/T * sigma, scale
// sigma, align_corners=False, zero padding), shifts the warped mask logit
// back by -5, takes a softmax over the objects plus a constant background
// logit of 1 and composites the contents over the background. The output is
// written channels-last, [N, img, img, ch].
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// the inputs are a few KB, the output is N*img*img*ch*4 bytes (12.3 MB at
// the main path's N=1000, img=32, ch=3), so writing the output takes about
// 3.7 us. Each row of an interpolation matrix has at most two non-zeros,
// so a pixel needs 4 taps per plane: about 96 operations a pixel for two
// objects and three channels, 0.1 GFLOP at N=1000, about 1.5 us. The kernel
// is bound by the bytes it writes.
//
// Design: one block per frame. The block first stages the object planes
// (template + 5 and sigmoid(contents), [o][ch+1][T][T]) in shared memory,
// since every frame reads them; each thread then computes whole output
// pixels, reading at most 2x2 taps per plane, and keeps an online
// max/sum softmax over the background and the objects in registers. All
// arithmetic is f32; no tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCh = 3;
constexpr int kThreads = 256;

// Source coordinate of output pixel i along one axis, in template pixels:
// the same operations, in the same order, as the plain PyTorch decoder
// (models/decoder.py::_warp_weights).
__device__ __forceinline__ float source_coord(int i, float p, int img,
                                              int tmpl, float sigma) {
  float t = ((float)img / 2.0f - p) / (float)tmpl * sigma;
  float base = (2.0f * (float)i + 1.0f) / (float)img - 1.0f;
  float grid = sigma * base + t;
  return ((grid + 1.0f) * (float)tmpl - 1.0f) / 2.0f;
}

// The two taps of one interpolation-matrix row: indices clamped into the
// template, weights max(0, 1 - |src - j|), zero for a tap outside it.
__device__ __forceinline__ void taps(float src, int tmpl, int* j, float* w) {
  int j0 = (int)floorf(src);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int jk = j0 + k;
    bool inside = jk >= 0 && jk < tmpl;
    w[k] = inside ? fmaxf(0.0f, 1.0f - fabsf(src - (float)jk)) : 0.0f;
    j[k] = inside ? jk : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
st_decode_forward_kernel(const float* __restrict__ pos,        // [N, 2*o]
                         const float* __restrict__ tmpl_raw,   // [o, T, T]
                         const float* __restrict__ cont_raw,   // [o, T, T, ch]
                         const float* __restrict__ background, // [img, img, ch]
                         float* __restrict__ out,              // [N, img, img, ch]
                         int img, int tmpl, int n_objs, int ch, float sigma) {
  extern __shared__ float planes[];  // [o][ch + 1][T][T]
  const int plane = tmpl * tmpl;
  const int n_planes = ch + 1;

  for (int i = threadIdx.x; i < n_objs * plane; i += blockDim.x) {
    const int o = i / plane;
    const int r = i - o * plane;
    float* dst = planes + o * n_planes * plane + r;
    dst[0] = tmpl_raw[i] + 5.0f;
    for (int c = 0; c < ch; ++c)
      dst[(1 + c) * plane] = 1.0f / (1.0f + expf(-cont_raw[i * ch + c]));
  }
  __syncthreads();

  const int frame = blockIdx.x;
  const float* frame_pos = pos + (size_t)frame * 2 * n_objs;
  float* frame_out = out + (size_t)frame * img * img * ch;

  for (int px = threadIdx.x; px < img * img; px += blockDim.x) {
    const int h = px / img;
    const int w = px - h * img;

    // Online softmax over [background, objects]: running max m, running
    // sum s of exp(logit - m), running sum acc of exp(logit - m) * colour.
    float m = 1.0f;
    float s = 1.0f;
    float acc[kMaxCh];
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c)
      acc[c] = c < ch ? background[px * ch + c] : 0.0f;

    for (int o = 0; o < n_objs; ++o) {
      int jx[2], jy[2];
      float wx[2], wy[2];
      taps(source_coord(w, frame_pos[2 * o], img, tmpl, sigma), tmpl, jx, wx);
      taps(source_coord(h, frame_pos[2 * o + 1], img, tmpl, sigma), tmpl, jy,
           wy);
      const float* obj = planes + o * n_planes * plane;

      float val[kMaxCh + 1];
#pragma unroll
      for (int c = 0; c <= kMaxCh; ++c) {
        if (c > ch) break;
        const float* pl = obj + c * plane;
        // Wy * P first, then * Wx^T, as the plain decoder contracts.
        float r0 = wy[0] * pl[jy[0] * tmpl + jx[0]] +
                   wy[1] * pl[jy[1] * tmpl + jx[0]];
        float r1 = wy[0] * pl[jy[0] * tmpl + jx[1]] +
                   wy[1] * pl[jy[1] * tmpl + jx[1]];
        val[c] = r0 * wx[0] + r1 * wx[1];
      }

      const float logit = val[0] - 5.0f;
      if (logit > m) {
        const float scale = expf(m - logit);
        s = s * scale + 1.0f;
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c)
          if (c < ch) acc[c] = acc[c] * scale + val[1 + c];
        m = logit;
      } else {
        const float e = expf(logit - m);
        s += e;
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c)
          if (c < ch) acc[c] += e * val[1 + c];
      }
    }

    const float inv = 1.0f / s;
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c)
      if (c < ch) frame_out[px * ch + c] = acc[c] * inv;
  }
}

}  // namespace

// Launches the decoder on `stream`. Returns cudaGetLastError() after the
// launch (0 on success). The caller checks shapes, types and limits.
extern "C" int st_decode_forward(const float* pos, const float* tmpl_raw,
                                 const float* cont_raw,
                                 const float* background, float* out, int n,
                                 int img, int tmpl, int n_objs, int ch,
                                 float sigma, void* stream) {
  if (n == 0) return 0;
  const size_t smem = sizeof(float) * n_objs * (ch + 1) * tmpl * tmpl;
  st_decode_forward_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      pos, tmpl_raw, cont_raw, background, out, img, tmpl, n_objs, ch, sigma);
  return (int)cudaGetLastError();
}
