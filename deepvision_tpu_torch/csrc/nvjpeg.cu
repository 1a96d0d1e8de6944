// JPEG decode (and encode) on the card through nvJPEG, with a plain C
// interface for ctypes (deepvision_tpu_torch/data/jpeg.py).
//
// Not a TPU kernel: the JAX reader decodes on the host with
// tf.io.decode_jpeg (deepvision_tpu/data/imagenet.py:138). The card's
// machine has no TensorFlow and no PIL, and the CUDA toolkit ships nvJPEG,
// so the port decodes a batch of JPEGs with nvjpegDecodeBatched into
// planar Y, Cb and Cr uint8 buffers that the caller allocated on the card,
// and ycc_to_rgb_kernel below turns them into interleaved RGB as libjpeg
// does. The decoder is nvJPEG's GPU_HYBRID backend, whose Huffman decode
// runs on the card for large batches (data/jpeg.py creates it, or raises;
// the hardware backend is refused on sm_90 with ARCH_MISMATCH).
// The encoder exists so that a machine without PIL can write JPEG records
// (chip_smoke.py).
//
// Why the colour stage is ours: nvJPEG's own interleaved RGB output
// replicates each chroma sample over its 2x2 block, where libjpeg (tf's and
// PIL's decoder) interpolates it ("fancy upsampling", 3/4 of the nearer and
// 1/4 of the farther sample on each axis); on the committed fixtures that
// put nvJPEG's RGB up to 20 steps (mean 3-4) off tf.io.decode_jpeg's, and
// libjpeg's upsampling and fixed-point JFIF conversion applied to nvJPEG's
// planes brings it to 3-4 steps (mean 1.0), the IDCTs' own difference.
// The kernel is one thread an output pixel, a row of blocks an image: a
// few byte loads and integer ops a pixel, bound by its bytes (Y, a
// quarter each of Cb and Cr read, three bytes written).
//
// Every function returns 0 on success, an nvjpegStatus_t (1-99) from
// nvJPEG, or 1000 + a cudaError_t from the runtime.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  int batch = 0;  // the batch size and output format the state was
  int format = -1;  // initialized for
};

struct Encoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

constexpr int kCudaBase = 1000;

}  // namespace

#define DV_NVJPEG(call)                          \
  do {                                           \
    nvjpegStatus_t s_ = (call);                  \
    if (s_ != NVJPEG_STATUS_SUCCESS) return (int)s_; \
  } while (0)

#define DV_CUDA(call)                                 \
  do {                                                \
    cudaError_t e_ = (call);                          \
    if (e_ != cudaSuccess) return kCudaBase + (int)e_; \
  } while (0)

extern "C" {

// A decoder on nvJPEG's ``backend`` (nvjpegBackend_t: 0 default, 1 hybrid,
// 2 GPU hybrid, 3 hardware) for the current device. Decoders and encoders
// live as long as the process (data/jpeg.py keeps one of each a card).
int dv_nvjpeg_create(int backend, void** out) {
  auto* d = new Decoder();
  nvjpegStatus_t s = nvjpegCreateEx(static_cast<nvjpegBackend_t>(backend),
                                    nullptr, nullptr, NVJPEG_FLAGS_DEFAULT,
                                    &d->handle);
  if (s != NVJPEG_STATUS_SUCCESS) {
    delete d;
    return (int)s;
  }
  s = nvjpegJpegStateCreate(d->handle, &d->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(d->handle);
    delete d;
    return (int)s;
  }
  *out = d;
  return 0;
}

// Header of one JPEG: out[0] height, out[1] width, out[2] components,
// out[3] chroma subsampling (nvjpegChromaSubsampling_t), out[4] and out[5]
// the height and width of its second component (0 for grayscale).
int dv_nvjpeg_info(void* p, const uint8_t* data, size_t length, int* out) {
  auto* d = static_cast<Decoder*>(p);
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  DV_NVJPEG(nvjpegGetImageInfo(d->handle, data, length, &components,
                               &subsampling, widths, heights));
  out[0] = heights[0];
  out[1] = widths[0];
  out[2] = components;
  out[3] = (int)subsampling;
  out[4] = components > 1 ? heights[1] : 0;
  out[5] = components > 1 ? widths[1] : 0;
  return 0;
}

// Decode ``n`` JPEGs, image i the bytes packed[offsets[i]:offsets[i+1]]
// in host memory, in nvJPEG's output ``format`` (nvjpegOutputFormat_t),
// plane c of image i to the device pointer dsts[3 * i + c] with row pitch
// pitches[3 * i + c] bytes (interleaved RGB uses plane 0 only), on
// ``stream``. Returns once the decode has finished on the stream (the
// caller may then free or reuse ``packed``, and nvJPEG its staging
// buffers).
int dv_nvjpeg_decode_batched(void* p, int n, int format,
                             const uint8_t* packed, const int64_t* offsets,
                             const uint64_t* dsts, const int* pitches,
                             void* stream_ptr) {
  auto* d = static_cast<Decoder*>(p);
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return 0;
  if (d->batch != n || d->format != format) {
    DV_NVJPEG(nvjpegDecodeBatchedInitialize(
        d->handle, d->state, n, 1, static_cast<nvjpegOutputFormat_t>(format)));
    d->batch = n;
    d->format = format;
  }
  std::vector<const unsigned char*> data(n);
  std::vector<size_t> lengths(n);
  std::vector<nvjpegImage_t> images(n);
  for (int i = 0; i < n; ++i) {
    data[i] = packed + offsets[i];
    lengths[i] = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    nvjpegImage_t img = {};
    for (int c = 0; c < 3; ++c) {
      img.channel[c] = reinterpret_cast<unsigned char*>(dsts[3 * i + c]);
      img.pitch[c] = static_cast<size_t>(pitches[3 * i + c]);
    }
    images[i] = img;
  }
  DV_NVJPEG(nvjpegDecodeBatched(d->handle, d->state, data.data(),
                                lengths.data(), images.data(), stream));
  DV_CUDA(cudaStreamSynchronize(stream));
  return 0;
}

// An encoder (nvJPEG's default backend) at ``quality``, 4:2:0 chroma.
int dv_nvjpeg_encoder_create(int quality, void** out) {
  auto* e = new Encoder();
  nvjpegStatus_t s = nvjpegCreateSimple(&e->handle);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderStateCreate(e->handle, &e->state, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsCreate(e->handle, &e->params, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsSetQuality(e->params, quality, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsSetSamplingFactors(e->params, NVJPEG_CSS_420,
                                              nullptr);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (e->params) nvjpegEncoderParamsDestroy(e->params);
    if (e->state) nvjpegEncoderStateDestroy(e->state);
    if (e->handle) nvjpegDestroy(e->handle);
    delete e;
    return (int)s;
  }
  *out = e;
  return 0;
}

// Encode one interleaved RGB uint8 image (device pointer ``rgb``, row
// pitch width * 3) on ``stream``; the JPEG goes to the host buffer ``out``
// of ``capacity`` bytes and its length to *length. A buffer too small
// returns -1 with the length needed in *length (encode again into a
// larger one).
int dv_nvjpeg_encode(void* p, const uint8_t* rgb, int height, int width,
                     uint8_t* out, size_t capacity, size_t* length,
                     void* stream_ptr) {
  auto* e = static_cast<Encoder*>(p);
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  nvjpegImage_t img = {};
  img.channel[0] = const_cast<unsigned char*>(rgb);
  img.pitch[0] = static_cast<size_t>(width) * 3;
  DV_NVJPEG(nvjpegEncodeImage(e->handle, e->state, e->params, &img,
                              NVJPEG_INPUT_RGBI, width, height, stream));
  size_t needed = 0;
  DV_NVJPEG(nvjpegEncodeRetrieveBitstream(e->handle, e->state, nullptr,
                                          &needed, stream));
  DV_CUDA(cudaStreamSynchronize(stream));
  *length = needed;
  if (needed > capacity) return -1;
  DV_NVJPEG(nvjpegEncodeRetrieveBitstream(e->handle, e->state, out,
                                          &needed, stream));
  DV_CUDA(cudaStreamSynchronize(stream));
  *length = needed;
  return 0;
}

}  // extern "C"

namespace {

// One image of a batch: offsets into the batch's Y, chroma and RGB
// buffers, its size, its chroma planes' size and subsampling factors.
struct YccImage {
  int64_t y_off, c_off, out_off;
  int h, w, ch, cw, hs, vs, gray, pad;  // an image has under 2^31 pixels
};

// libjpeg-turbo's fancy upsampling of one chroma sample (jdsample.c
// h2v2_fancy_upsample, h2v1_fancy_upsample), for output pixel (r, c).
__device__ __forceinline__ int chroma(const uint8_t* p, const YccImage& m,
                                      int r, int c) {
  if (m.hs == 1 && m.vs == 1) return p[(int64_t)r * m.cw + c];
  if (m.vs == 1) {  // h2v1: 3/4 nearer + 1/4 farther, bias 1 or 2
    const uint8_t* row = p + (int64_t)r * m.cw;
    int k = c >> 1;
    if (c & 1) {
      return k == m.cw - 1 ? row[k] : (3 * row[k] + row[k + 1] + 2) >> 2;
    }
    return k == 0 ? row[0] : (3 * row[k] + row[k - 1] + 1) >> 2;
  }
  // h2v2: column sums 3 * nearer row + farther row (edge rows repeated)
  int cr0 = r >> 1;
  int other = (r & 1) ? min(cr0 + 1, m.ch - 1) : max(cr0 - 1, 0);
  const uint8_t* a = p + (int64_t)cr0 * m.cw;
  const uint8_t* b = p + (int64_t)other * m.cw;
  int k = c >> 1;
  int sum = 3 * a[k] + b[k];
  if (c & 1) {
    if (k == m.cw - 1) return (sum * 4 + 7) >> 4;
    return (sum * 3 + 3 * a[k + 1] + b[k + 1] + 7) >> 4;
  }
  if (k == 0) return (sum * 4 + 8) >> 4;
  return (sum * 3 + 3 * a[k - 1] + b[k - 1] + 8) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// JFIF YCbCr -> RGB in libjpeg's fixed point (jdcolor.c, SCALEBITS 16).
// Block row blockIdx.y takes image blockIdx.y; its blocks stride over the
// image's pixels, one a thread.
__global__ void ycc_to_rgb_kernel(const uint8_t* __restrict__ y,
                                  const uint8_t* __restrict__ cb,
                                  const uint8_t* __restrict__ cr,
                                  uint8_t* __restrict__ out,
                                  const YccImage* __restrict__ images) {
  constexpr int kFixR = 91881;   // FIX(1.40200)
  constexpr int kFixB = 116130;  // FIX(1.77200)
  constexpr int kFixGr = 46802;  // FIX(0.71414)
  constexpr int kFixGb = 22554;  // FIX(0.34414)
  constexpr int kHalf = 1 << 15;
  const YccImage m = images[blockIdx.y];
  const int count = m.h * m.w;
  const uint8_t* yp = y + m.y_off;
  const uint8_t* cbp = cb + m.c_off;
  const uint8_t* crp = cr + m.c_off;
  uint8_t* op = out + m.out_off;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < count;
       p += gridDim.x * blockDim.x) {
    int r = p / m.w, c = p - r * m.w;
    int yv = yp[p];
    uint8_t* o = op + 3 * (int64_t)p;
    if (m.gray) {
      o[0] = o[1] = o[2] = (uint8_t)yv;
      continue;
    }
    int u = chroma(cbp, m, r, c) - 128;
    int v = chroma(crp, m, r, c) - 128;
    o[0] = clamp255(yv + ((kFixR * v + kHalf) >> 16));
    o[1] = clamp255(yv + ((-kFixGb * u + kHalf - kFixGr * v) >> 16));
    o[2] = clamp255(yv + ((kFixB * u + kHalf) >> 16));
  }
}

}  // namespace

extern "C" {

// Interleaved RGB of a batch decoded to planes: ``images`` (device memory)
// describes each of the ``n`` images in the batch's buffers ``y``, ``cb``,
// ``cr`` and ``out``; ``max_pixels`` is the largest image's pixel count.
// Launches on ``stream``.
int dv_ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                  uint8_t* out, const void* images, int n, int max_pixels,
                  void* stream_ptr) {
  if (n <= 0 || max_pixels <= 0) return 0;
  if (n > 65535) return kCudaBase + (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  int blocks = (max_pixels + threads - 1) / threads;
  dim3 grid(blocks < 64 ? blocks : 64, n);
  ycc_to_rgb_kernel<<<grid, threads, 0,
                      static_cast<cudaStream_t>(stream_ptr)>>>(
      y, cb, cr, out, static_cast<const YccImage*>(images));
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : kCudaBase + (int)e;
}

// sizeof(YccImage), which the caller's descriptors must match.
int dv_ycc_image_bytes(void) { return (int)sizeof(YccImage); }

}  // extern "C"
