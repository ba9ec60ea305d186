// Native image I/O for stereomatching.
//
// This framework's counterpart of the reference's native I/O layer
// (vendored stb_image decoder + src/image.c PPM writer): grayscale PNG
// decode/encode and the byte-exact ASCII PPM-P3 artifact renderer
// (reference write_image, src/image.c:71-88).  The pure-Python
// implementations in stereomatching/utils/imageio.py are the
// executable spec; this library must produce identical bytes and is
// loaded via ctypes when built (make -C native).
//
// Exposed C ABI (all return 0 on success, negative error codes):
//   stereo_png_read_gray   - decode 8-bit grayscale PNG into caller buffer
//   stereo_png_info        - probe width/height/color type
//   stereo_png_write_gray  - encode 8-bit grayscale PNG (filter-0 rows)
//   stereo_ppm_render      - render int64 plane as PPM-P3 ASCII bytes
//   stereo_ppm_size_bound  - upper bound for the render output buffer

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

enum {
    STEREO_OK = 0,
    STEREO_ERR_SIG = -1,      // not a PNG
    STEREO_ERR_FORMAT = -2,   // not 8-bit grayscale / interlaced
    STEREO_ERR_ZLIB = -3,
    STEREO_ERR_TRUNC = -4,
    STEREO_ERR_BOUNDS = -5,
    STEREO_ERR_ARG = -6,
};

// PPM pixel mappings (reference ImageType, src/image.h:15-19).
enum { IMTYPE_BINARY = 0, IMTYPE_GRAY_FLOAT = 1, IMTYPE_GRAY_INT = 2 };

static const unsigned char PNG_SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

static uint32_t be32(const unsigned char *p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static void put_be32(unsigned char *p, uint32_t v) {
    p[0] = (unsigned char)(v >> 24);
    p[1] = (unsigned char)(v >> 16);
    p[2] = (unsigned char)(v >> 8);
    p[3] = (unsigned char)v;
}

// Paeth predictor (PNG spec §9.4; same tie order as the Python spec).
static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

int stereo_png_info(const unsigned char *buf, int64_t len, int32_t *width,
                    int32_t *height, int32_t *color_type) {
    if (len < 33 || memcmp(buf, PNG_SIG, 8) != 0) return STEREO_ERR_SIG;
    // First chunk must be IHDR at offset 8.
    if (memcmp(buf + 12, "IHDR", 4) != 0) return STEREO_ERR_SIG;
    *width = (int32_t)be32(buf + 16);
    *height = (int32_t)be32(buf + 20);
    *color_type = buf[25];
    return STEREO_OK;
}

// Decode an 8-bit grayscale non-interlaced PNG into out[h*w].
int stereo_png_read_gray(const unsigned char *buf, int64_t len,
                         unsigned char *out, int32_t w, int32_t h) {
    if (len < 8 || memcmp(buf, PNG_SIG, 8) != 0) return STEREO_ERR_SIG;
    int64_t pos = 8;
    std::vector<unsigned char> idat;
    int32_t width = 0, height = 0;
    int depth = -1, ctype = -1, interlace = -1;
    while (pos + 12 <= len) {
        uint32_t clen = be32(buf + pos);
        const unsigned char *tag = buf + pos + 4;
        const unsigned char *chunk = buf + pos + 8;
        if (pos + 12 + clen > len) return STEREO_ERR_TRUNC;
        if (memcmp(tag, "IHDR", 4) == 0) {
            width = (int32_t)be32(chunk);
            height = (int32_t)be32(chunk + 4);
            depth = chunk[8];
            ctype = chunk[9];
            interlace = chunk[12];
        } else if (memcmp(tag, "IDAT", 4) == 0) {
            idat.insert(idat.end(), chunk, chunk + clen);
        } else if (memcmp(tag, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + clen;
    }
    if (width != w || height != h) return STEREO_ERR_ARG;
    if (ctype != 0 || depth != 8 || interlace != 0) return STEREO_ERR_FORMAT;

    const int64_t stride = width;
    const int64_t raw_len = (stride + 1) * (int64_t)height;
    std::vector<unsigned char> raw(raw_len);
    uLongf dest_len = (uLongf)raw_len;
    int zrc = uncompress(raw.data(), &dest_len, idat.data(), (uLong)idat.size());
    if (zrc != Z_OK) return STEREO_ERR_ZLIB;
    if ((int64_t)dest_len < raw_len) return STEREO_ERR_TRUNC;

    std::vector<unsigned char> prev(stride, 0);
    for (int32_t y = 0; y < height; y++) {
        const unsigned char *src = raw.data() + (int64_t)y * (stride + 1);
        unsigned char ftype = src[0];
        unsigned char *row = out + (int64_t)y * stride;
        const unsigned char *fs = src + 1;
        switch (ftype) {
        case 0:
            memcpy(row, fs, stride);
            break;
        case 1: {  // Sub
            int acc = 0;
            for (int64_t x = 0; x < stride; x++) {
                acc = (fs[x] + acc) & 0xFF;
                row[x] = (unsigned char)acc;
            }
            break;
        }
        case 2:  // Up
            for (int64_t x = 0; x < stride; x++)
                row[x] = (unsigned char)((fs[x] + prev[x]) & 0xFF);
            break;
        case 3: {  // Average
            int left = 0;
            for (int64_t x = 0; x < stride; x++) {
                row[x] = (unsigned char)((fs[x] + ((left + prev[x]) >> 1)) & 0xFF);
                left = row[x];
            }
            break;
        }
        case 4: {  // Paeth
            int left = 0, upleft = 0;
            for (int64_t x = 0; x < stride; x++) {
                row[x] = (unsigned char)((fs[x] + paeth(left, prev[x], upleft)) & 0xFF);
                upleft = prev[x];
                left = row[x];
            }
            break;
        }
        default:
            return STEREO_ERR_FORMAT;
        }
        memcpy(prev.data(), row, stride);
    }
    return STEREO_OK;
}

// Encode uint8 [h, w] as grayscale PNG (filter-0 rows, zlib level 9 ==
// the Python spec's zlib.compress(raw, 9), so outputs are byte-equal).
// out_len in: capacity; out: bytes written.
int stereo_png_write_gray(const unsigned char *pixels, int32_t w, int32_t h,
                          unsigned char *out, int64_t *out_len) {
    const int64_t stride = w;
    std::vector<unsigned char> raw((stride + 1) * (int64_t)h);
    for (int32_t y = 0; y < h; y++) {
        unsigned char *dst = raw.data() + (int64_t)y * (stride + 1);
        dst[0] = 0;
        memcpy(dst + 1, pixels + (int64_t)y * stride, stride);
    }
    uLongf comp_cap = compressBound((uLong)raw.size());
    std::vector<unsigned char> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 9) != Z_OK)
        return STEREO_ERR_ZLIB;

    const int64_t total = 8 + (12 + 13) + (12 + (int64_t)comp_cap) + 12;
    if (*out_len < total) return STEREO_ERR_BOUNDS;
    unsigned char *p = out;
    memcpy(p, PNG_SIG, 8);
    p += 8;

    auto chunk = [&](const char *tag, const unsigned char *payload, uint32_t n) {
        put_be32(p, n);
        memcpy(p + 4, tag, 4);
        if (n) memcpy(p + 8, payload, n);
        uLong crc = crc32(0L, Z_NULL, 0);
        crc = crc32(crc, p + 4, n + 4);
        put_be32(p + 8 + n, (uint32_t)crc);
        p += 12 + n;
    };

    unsigned char ihdr[13];
    put_be32(ihdr, (uint32_t)w);
    put_be32(ihdr + 4, (uint32_t)h);
    ihdr[8] = 8;   // bit depth
    ihdr[9] = 0;   // grayscale
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    chunk("IHDR", ihdr, 13);
    chunk("IDAT", comp.data(), (uint32_t)comp_cap);
    chunk("IEND", nullptr, 0);
    *out_len = p - out;
    return STEREO_OK;
}

// Upper bound on the PPM-P3 byte size for an h*w plane.
int64_t stereo_ppm_size_bound(int32_t w, int32_t h) {
    // header "P3\n{w} {h}\n255\n" <= 32; per pixel "255 255 255\n" <= 12.
    return 32 + (int64_t)w * h * 12;
}

// Render an int64 plane as ASCII PPM-P3 bytes, byte-identical to the
// reference's write_image (src/image.c:71-88): header "P3\n{w} {h}\n255\n"
// then one "{v} {v} {v}\n" line per pixel.
//   imtype 0 (BINARY):   v = (x == 1) ? 0 : 255        (src/image.c:45)
//   imtype 2 (GRAY_INT): v = (x-min)*255/(max-min)     (src/image.c:37-47,
//                        C long arithmetic; range 0 -> all zeros)
static const char *lut_line(int v, int *len) {
    // Precomputed "v v v\n" strings for the 256 in-range output values.
    static char lut[256][16];
    static int lut_len[256];
    static bool lut_init = false;
    if (!lut_init) {
        for (int q = 0; q < 256; q++)
            lut_len[q] = sprintf(lut[q], "%d %d %d\n", q, q, q);
        lut_init = true;
    }
    *len = lut_len[v];
    return lut[v];
}

int stereo_ppm_render(const int64_t *data, int32_t w, int32_t h,
                      int32_t imtype, unsigned char *out, int64_t *out_len) {
    const int64_t n = (int64_t)w * h;
    // Capacity check BEFORE any write: both mappings produce values in
    // 0..255, so the true worst case is the stereo_ppm_size_bound bound.
    if (*out_len < stereo_ppm_size_bound(w, h)) return STEREO_ERR_BOUNDS;
    if (imtype != IMTYPE_BINARY && imtype != IMTYPE_GRAY_INT)
        return STEREO_ERR_ARG;
    unsigned char *p = out;
    p += sprintf((char *)p, "P3\n%d %d\n255\n", w, h);

    int64_t mn = 0, mx = 0;
    if (imtype == IMTYPE_GRAY_INT) {
        mn = mx = data[0];
        for (int64_t i = 1; i < n; i++) {
            if (data[i] < mn) mn = data[i];
            if (data[i] > mx) mx = data[i];
        }
    }
    const int64_t rng = mx - mn;

    for (int64_t i = 0; i < n; i++) {
        int v;
        if (imtype == IMTYPE_BINARY) {
            v = (data[i] == 1) ? 0 : 255;
        } else {
            v = rng == 0 ? 0 : (int)((data[i] - mn) * 255 / rng);
        }
        int llen;
        const char *line = lut_line(v, &llen);
        memcpy(p, line, llen);
        p += llen;
    }
    *out_len = p - out;
    return STEREO_OK;
}

// GRAY_FLOAT renderer (reference src/image.c:46): v = (int)(x * 255.0),
// C truncation toward zero.  Brightness inputs are [0, 1) so v is
// normally 0..254, but out-of-range values are printed verbatim like
// the reference's %d would — so capacity is tracked per pixel.
int stereo_ppm_render_float(const double *data, int32_t w, int32_t h,
                            unsigned char *out, int64_t *out_len) {
    const int64_t n = (int64_t)w * h;
    const int64_t cap = *out_len;
    if (cap < 32) return STEREO_ERR_BOUNDS;
    unsigned char *p = out;
    p += sprintf((char *)p, "P3\n%d %d\n255\n", w, h);
    for (int64_t i = 0; i < n; i++) {
        long long v = (long long)(data[i] * 255.0);
        char tmp[80];
        int llen;
        const char *line;
        if (v >= 0 && v < 256) {
            line = lut_line((int)v, &llen);
        } else {
            llen = sprintf(tmp, "%lld %lld %lld\n", v, v, v);
            line = tmp;
        }
        if ((p - out) + llen > cap) return STEREO_ERR_BOUNDS;
        memcpy(p, line, llen);
        p += llen;
    }
    *out_len = p - out;
    return STEREO_OK;
}

}  // extern "C"
