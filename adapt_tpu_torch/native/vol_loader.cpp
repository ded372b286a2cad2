// Copy of adapt_tpu/native/vol_loader.cpp (the port builds and loads it
// itself: adapt_tpu_torch/native/__init__.py).
//
// Mitsuba3 binary .vol grid loader (native component; the reference ships a
// pybind11+OpenMP equivalent, bxdf/vol_loader/vol2numpy.cpp:34-131).
//
// Format: magic "VOL" + version byte 3, int32 encoding (1 = float32),
// int32 xres/yres/zres, int32 channels (1|3|6), 6 x float32 bbox, then
// float32 payload laid out [z][y][x][channel].
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Reads the header; fills dims[4] = {xres, yres, zres, channels}.
// Returns 0 on success, negative error code otherwise.
int vol_read_header(const char *path, int32_t *dims) {
    FILE *fp = std::fopen(path, "rb");
    if (!fp) return -1;
    char magic[4] = {0};
    if (std::fread(magic, 1, 4, fp) != 4 ||
        std::strncmp(magic, "VOL", 3) != 0 || magic[3] != 3) {
        std::fclose(fp);
        return -2;
    }
    int32_t encoding = 0;
    if (std::fread(&encoding, 4, 1, fp) != 1 || encoding != 1) {
        std::fclose(fp);
        return -3;
    }
    if (std::fread(dims, 4, 4, fp) != 4) {
        std::fclose(fp);
        return -4;
    }
    std::fclose(fp);
    // reject corrupt headers loudly: non-positive dims would make the
    // payload size wrap through (size_t) into a ~2^64 allocation
    if (dims[0] <= 0 || dims[1] <= 0 || dims[2] <= 0) return -6;
    int32_t c = dims[3];
    if (c != 1 && c != 3 && c != 6) return -5;
    return 0;
}

// Reads the payload into out[z*y*x*3] as RGB (mono broadcast / first three
// of six channels, matching reference vol2numpy.cpp:76-122). If force_mono,
// out has z*y*x floats of channel 0.
int vol_read(const char *path, float *out, int force_mono) {
    int32_t dims[4];
    int rc = vol_read_header(path, dims);
    if (rc) return rc;
    FILE *fp = std::fopen(path, "rb");
    if (!fp) return -1;
    // skip magic+version(4) + encoding(4) + dims(16) + bbox(24)
    std::fseek(fp, 4 + 4 + 16 + 24, SEEK_SET);
    const int64_t nvox = (int64_t)dims[0] * dims[1] * dims[2];
    const int32_t c = dims[3];
    std::vector<float> raw((size_t)(nvox * c));
    if ((int64_t)std::fread(raw.data(), 4, nvox * c, fp) != nvox * c) {
        std::fclose(fp);
        return -6;
    }
    std::fclose(fp);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t v = 0; v < nvox; ++v) {
        const float *src = raw.data() + v * c;
        if (force_mono) {
            out[v] = src[0];
        } else if (c == 1) {
            out[v * 3] = out[v * 3 + 1] = out[v * 3 + 2] = src[0];
        } else {  // 3 or 6 channels: take the first three
            out[v * 3] = src[0];
            out[v * 3 + 1] = src[1];
            out[v * 3 + 2] = src[2];
        }
    }
    return 0;
}

}  // extern "C"
