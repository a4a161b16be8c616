// Native host-side image runtime for rays1bench_tpu_torch: the port's own
// copy of rays1bench_tpu/runtime/native/imageio.cpp, functions unchanged.
//
// The reference's host runtime is C++ end to end (TGA writer
// src/common/common.h:80-122, pixel quantization rayweek1.cpp:765-775,
// result records common.h:47-77). The device computes linear radiance; the
// host-side finishing pipeline (tonemap: gamma = sqrt, *255.99
// quantization; multi-shard accumulation; TGA encode and decode) lives here
// as a small C++ library, loaded through ctypes by
// rays1bench_tpu_torch/runtime/native.py, whose numpy versions are the plain
// twins the tests hold it against.
//
// Build: python -m rays1bench_tpu_torch.runtime.build  (g++ -O3 -shared
// -fPIC, into build/rays1bench_tpu_torch/runtime/ at first use)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>

extern "C" {

// Tonemap linear radiance to 8-bit sRGB-ish the reference way:
// clamp to [0,1], gamma = sqrt (rayweek1.cpp:767), quantize *255.99 (:769).
// in:  n floats; out: n bytes.
void rt_tonemap_u8(const float* linear, uint8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = linear[i];
        v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
        out[i] = (uint8_t)(sqrtf(v) * 255.99f);
    }
}

// Average `num_shards` radiance buffers (each n floats) into out —
// the host-side analog of the reference's thread-join reduction
// (rayweek1.cpp:809-813) for multi-host shard assembly.
void rt_accumulate_mean(const float* const* shards, int num_shards,
                        float* out, int64_t n) {
    if (num_shards <= 0) return;
    const float inv = 1.0f / (float)num_shards;
    for (int64_t i = 0; i < n; ++i) {
        float acc = 0.0f;
        for (int s = 0; s < num_shards; ++s) acc += shards[s][i];
        out[i] = acc * inv;
    }
}

// Uncompressed 24-bit true-color TGA writer, byte-compatible with the
// reference's tga_write_rgb24 (common.h:86-122) but non-mutating: input is
// RGB row 0 = bottom; the BGR swap happens into a scratch row.
// Returns 0 on success, -1 on I/O error.
int rt_tga_write_rgb24(const char* path, int width, int height,
                       const uint8_t* rgb) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    uint8_t header[18] = {
        0, 0, 2,             // no id, no cmap, uncompressed true color
        0, 0, 0, 0, 0,       // cmap spec
        0, 0, 0, 0,          // x/y origin
        (uint8_t)(width & 0xFF), (uint8_t)((width >> 8) & 0xFF),
        (uint8_t)(height & 0xFF), (uint8_t)((height >> 8) & 0xFF),
        24, 0,               // bpp, descriptor (bottom-left origin)
    };
    if (fwrite(header, 1, 18, f) != 18) { fclose(f); return -1; }
    const int64_t row_bytes = (int64_t)width * 3;
    uint8_t* row = new uint8_t[row_bytes];
    for (int y = 0; y < height; ++y) {
        const uint8_t* src = rgb + (int64_t)y * row_bytes;
        for (int x = 0; x < width; ++x) {       // RGB -> BGR
            row[x * 3 + 0] = src[x * 3 + 2];
            row[x * 3 + 1] = src[x * 3 + 1];
            row[x * 3 + 2] = src[x * 3 + 0];
        }
        if (fwrite(row, 1, row_bytes, f) != (size_t)row_bytes) {
            delete[] row; fclose(f); return -1;
        }
    }
    delete[] row;
    fclose(f);
    return 0;
}

// Read an uncompressed 24-bit TGA written by rt_tga_write_rgb24 / the
// reference. Caller passes a buffer of width*height*3 bytes (use
// rt_tga_probe first). Returns 0 on success.
int rt_tga_probe(const char* path, int* width, int* height) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t h[18];
    if (fread(h, 1, 18, f) != 18) { fclose(f); return -1; }
    fclose(f);
    if (h[2] != 2 || h[16] != 24) return -2;
    *width = h[12] | (h[13] << 8);
    *height = h[14] | (h[15] << 8);
    return 0;
}

int rt_tga_read_rgb24(const char* path, uint8_t* rgb, int width, int height) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t h[18];
    if (fread(h, 1, 18, f) != 18) { fclose(f); return -1; }
    if (h[2] != 2 || h[16] != 24) { fclose(f); return -2; }
    if (fseek(f, 18 + h[0], SEEK_SET) != 0) { fclose(f); return -1; }
    const int64_t row_bytes = (int64_t)width * 3;
    uint8_t* row = new uint8_t[row_bytes];
    const bool top_down = (h[17] & 0x20) != 0;
    for (int y = 0; y < height; ++y) {
        if (fread(row, 1, row_bytes, f) != (size_t)row_bytes) {
            delete[] row; fclose(f); return -1;
        }
        const int dst_y = top_down ? (height - 1 - y) : y;
        uint8_t* dst = rgb + (int64_t)dst_y * row_bytes;
        for (int x = 0; x < width; ++x) {       // BGR -> RGB
            dst[x * 3 + 0] = row[x * 3 + 2];
            dst[x * 3 + 1] = row[x * 3 + 1];
            dst[x * 3 + 2] = row[x * 3 + 0];
        }
    }
    delete[] row;
    fclose(f);
    return 0;
}

}  // extern "C"
