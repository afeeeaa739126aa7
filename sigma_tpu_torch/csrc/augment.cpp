// Native host-side augmentation core for the sigma_tpu_torch data pipeline.
//
// The reference feeds its GPU from 16 torch DataLoader workers running
// numpy/cv2 passes (normalize, crop, pad, mirror are each a full pass over
// the image buffer). Here the post-resize tail of the train augmentation
// (mirror -> normalize -> crop -> center-pad) is fused into ONE pass per
// output pixel, in C++ with OpenMP across rows. Loaded via ctypes
// (sigma_tpu_torch/data/native.py, which builds it at first use); the
// numpy path of sigma_tpu_torch/data/transforms.py is its semantic
// reference. A copy of the JAX package's sigma_tpu/data/native/augment.cpp.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC augment.cpp -o libsigmaaug.so

#include <cstdint>
#include <cstring>

extern "C" {

// Fused mirror+normalize+crop+pad for a HWC uint8 image.
//   src: (src_h, src_w, ch) uint8, C-contiguous
//   dst: (out_h, out_w, ch) float32, C-contiguous
//   crop_y/crop_x: top-left of the crop in the (possibly mirrored) source
//   pad_t/pad_l:   where the cropped region lands in dst (center padding)
//   copy_h/copy_w: size of the copied region
//   mean/std:      per-channel normalization ((x/255 - mean) / std)
//   pad_value:     fill for dst outside the copied region
void fused_image_aug(const uint8_t* src, float* dst,
                     int64_t src_h, int64_t src_w, int64_t ch,
                     int64_t out_h, int64_t out_w,
                     int64_t crop_y, int64_t crop_x,
                     int64_t pad_t, int64_t pad_l,
                     int64_t copy_h, int64_t copy_w,
                     const float* mean, const float* std_,
                     float pad_value, int mirror) {
  float scale[8];
  float shift[8];
  for (int64_t c = 0; c < ch; ++c) {
    scale[c] = 1.0f / (255.0f * std_[c]);
    shift[c] = -mean[c] / std_[c];
  }
#pragma omp parallel for schedule(static)
  for (int64_t oy = 0; oy < out_h; ++oy) {
    float* drow = dst + oy * out_w * ch;
    int64_t iy = oy - pad_t + crop_y;
    bool row_in = (oy >= pad_t) && (oy < pad_t + copy_h);
    if (!row_in) {
      for (int64_t i = 0; i < out_w * ch; ++i) drow[i] = pad_value;
      continue;
    }
    const uint8_t* srow = src + iy * src_w * ch;
    for (int64_t ox = 0; ox < out_w; ++ox) {
      float* dp = drow + ox * ch;
      if (ox < pad_l || ox >= pad_l + copy_w) {
        for (int64_t c = 0; c < ch; ++c) dp[c] = pad_value;
        continue;
      }
      int64_t ix = ox - pad_l + crop_x;
      if (mirror) ix = src_w - 1 - ix;
      const uint8_t* sp = srow + ix * ch;
      for (int64_t c = 0; c < ch; ++c) {
        dp[c] = (float)sp[c] * scale[c] + shift[c];
      }
    }
  }
}

// Fused mirror+crop+pad for a HW uint8 label map -> int32 with `pad_value`
// (255 = ignore) outside the copied region.
void fused_label_aug(const uint8_t* src, int32_t* dst,
                     int64_t src_h, int64_t src_w,
                     int64_t out_h, int64_t out_w,
                     int64_t crop_y, int64_t crop_x,
                     int64_t pad_t, int64_t pad_l,
                     int64_t copy_h, int64_t copy_w,
                     int32_t pad_value, int mirror) {
#pragma omp parallel for schedule(static)
  for (int64_t oy = 0; oy < out_h; ++oy) {
    int32_t* drow = dst + oy * out_w;
    int64_t iy = oy - pad_t + crop_y;
    bool row_in = (oy >= pad_t) && (oy < pad_t + copy_h);
    if (!row_in) {
      for (int64_t i = 0; i < out_w; ++i) drow[i] = pad_value;
      continue;
    }
    const uint8_t* srow = src + iy * src_w;
    for (int64_t ox = 0; ox < out_w; ++ox) {
      if (ox < pad_l || ox >= pad_l + copy_w) {
        drow[ox] = pad_value;
        continue;
      }
      int64_t ix = ox - pad_l + crop_x;
      if (mirror) ix = src_w - 1 - ix;
      drow[ox] = (int32_t)srow[ix];
    }
  }
}

}  // extern "C"
