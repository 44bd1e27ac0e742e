// Fast ASCII P3 PPM codec (native counterpart of io/ppm.py, whose Python
// codec is its plain version).
//
// The reference's Image::read/write (Code/image.cpp:53-133) stream ints
// through iostreams one at a time — fine for 64x64 textures, painful for
// 1920x1080 frames (~25 MB of ASCII).  This codec slurps the file and
// hand-scans integers (read), and emits via a preallocated byte buffer
// (write), reproducing the reference writer's exact byte layout:
// "P3\n<w> <h>\n255\n" then rows of "r g b  r g b ...\n" (two spaces
// between pixels, one between channels).
//
// C ABI for ctypes; no Python headers needed.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// The reader takes a file as the Python codec (io/ppm.py::read_ppm_plain)
// does: comments run from '#' to the next '\n'; tokens are runs of bytes
// other than ASCII whitespace (" \t\n\r\v\f", bytes.split()'s set); token 0
// is "P3", tokens 1 and 2 are the width and height, token 3 (maxval) is not
// read, and the next w*h*3 tokens are the values, any after them ignored.
// A number is what Python's int() takes from bytes in base 10: an optional
// sign, then digits with single '_' between them.

static bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f';
}

// Reads the whole file; -1 if it cannot be opened.
static int slurp(const char* path, std::vector<char>* buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf->resize(n > 0 ? n : 0);
    size_t got = std::fread(buf->data(), 1, buf->size(), f);
    std::fclose(f);
    buf->resize(got);
    return 0;
}

// Finds the next token at or after *i: [*s, *e); false at the end.
static bool next_token(const std::vector<char>& b, size_t* i, size_t* s, size_t* e) {
    size_t n = b.size(), k = *i;
    for (;;) {
        while (k < n && is_space(b[k])) k++;
        if (k < n && b[k] == '#') {
            while (k < n && b[k] != '\n') k++;
            continue;
        }
        break;
    }
    if (k >= n) {
        *i = k;
        return false;
    }
    *s = k;
    while (k < n && !is_space(b[k]) && b[k] != '#') k++;
    *e = *i = k;
    return true;
}

// Parses [s, e) as a base-10 int64: 0, -6 if it is not a number, -7 if it
// is out of the int64 range.
static int parse_int(const std::vector<char>& b, size_t s, size_t e, int64_t* out) {
    bool neg = false;
    if (s < e && (b[s] == '+' || b[s] == '-')) neg = b[s++] == '-';
    if (s == e || b[s] < '0' || b[s] > '9') return -6;
    const uint64_t lim = neg ? (uint64_t)INT64_MAX + 1 : (uint64_t)INT64_MAX;
    uint64_t v = 0;
    bool wide = false;
    for (size_t k = s; k < e; k++) {
        char c = b[k];
        if (c == '_') {
            if (k + 1 == e || b[k + 1] < '0' || b[k + 1] > '9') return -6;
            continue;
        }
        if (c < '0' || c > '9') return -6;
        unsigned d = (unsigned)(c - '0');
        if (v > (lim - d) / 10) wide = true;
        else v = v * 10 + d;
    }
    if (wide) return -7;
    *out = neg ? (int64_t)(0 - v) : (int64_t)v;
    return 0;
}

// Reads the header: 0 and w, h; -2 if token 0 is not "P3", -3 if the width
// or height is missing, not a number or outside [0, 2^31).
int ppm_read_header(const char* path, int32_t* w, int32_t* h) {
    std::vector<char> b;
    if (slurp(path, &b)) return -1;
    size_t i = 0, s, e;
    if (!next_token(b, &i, &s, &e) || e - s != 2 || b[s] != 'P' || b[s + 1] != '3') return -2;
    int64_t dims[2];
    for (int k = 0; k < 2; k++) {
        if (!next_token(b, &i, &s, &e) || parse_int(b, s, e, &dims[k]) ||
            dims[k] < 0 || dims[k] > INT32_MAX)
            return -3;
    }
    *w = (int32_t)dims[0];
    *h = (int32_t)dims[1];
    return 0;
}

// Reads the first `count` values after the header into out (caller-
// allocated), each clamped to [0,255] like the reference reader
// (Code/image.cpp:127); -5 if there are fewer, -6 or -7 if one of them is
// not a number or out of the int64 range.
int ppm_read_pixels(const char* path, uint8_t* out, int64_t count) {
    std::vector<char> b;
    if (slurp(path, &b)) return -1;
    size_t i = 0, s, e;
    for (int k = 0; k < 4; k++)  // "P3", w, h, maxval
        if (!next_token(b, &i, &s, &e)) return count ? -5 : 0;
    for (int64_t nv = 0; nv < count; nv++) {
        if (!next_token(b, &i, &s, &e)) return -5;
        int64_t v;
        int err = parse_int(b, s, e, &v);
        if (err) return err;
        out[nv] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
    return 0;
}

// Writes w*h*3 bytes as ASCII P3 with the reference's separators.
int ppm_write(const char* path, const uint8_t* img, int32_t w, int32_t h) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    // Worst case per pixel: "255 255 255  " = 13 bytes + row newline.
    std::vector<char> buf;
    buf.reserve((size_t)w * h * 13 + 64);
    char head[64];
    int hn = std::snprintf(head, sizeof(head), "P3\n%d %d\n255\n", w, h);
    buf.insert(buf.end(), head, head + hn);

    char tmp[4];
    auto put_int = [&](uint8_t v) {
        int len = 0;
        if (v >= 100) tmp[len++] = '0' + v / 100;
        if (v >= 10) tmp[len++] = '0' + (v / 10) % 10;
        tmp[len++] = '0' + v % 10;
        buf.insert(buf.end(), tmp, tmp + len);
    };

    const uint8_t* p = img;
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            put_int(p[0]);
            buf.push_back(' ');
            put_int(p[1]);
            buf.push_back(' ');
            put_int(p[2]);
            p += 3;
            if (x < w - 1) {
                buf.push_back(' ');
                buf.push_back(' ');
            }
        }
        buf.push_back('\n');
    }
    size_t wrote = std::fwrite(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    return wrote == buf.size() ? 0 : -2;
}

}  // extern "C"
