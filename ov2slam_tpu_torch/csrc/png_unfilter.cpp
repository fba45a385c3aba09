// Undo the per-row filters of a non-interlaced PNG image (PNG
// specification, section 9: filter method 0).
//
// `raw` is the inflated IDAT stream: `height` rows, each a filter-type
// byte followed by `row_bytes` filtered bytes. `out` receives the
// reconstructed rows, `height * row_bytes` bytes. `bpp` is the number of
// bytes per complete pixel (at bit depth 8: the channel count), the
// distance to the byte "to the left". Average and Paeth depend on the
// reconstructed byte to the left, so each row is one sequential pass.
//
// Returns 0, or -(r + 1) when row r has an unknown filter type.

#include <cstdint>
#include <cstdlib>
#include <cstring>

static inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

extern "C" int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                            int64_t row_bytes, int bpp) {
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t* src = raw + r * (row_bytes + 1);
        const uint8_t ftype = src[0];
        ++src;
        uint8_t* cur = out + r * row_bytes;
        const uint8_t* prev = r > 0 ? cur - row_bytes : nullptr;
        switch (ftype) {
        case 0:  // None
            std::memcpy(cur, src, static_cast<size_t>(row_bytes));
            break;
        case 1:  // Sub
            for (int64_t i = 0; i < row_bytes; ++i)
                cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:  // Up
            for (int64_t i = 0; i < row_bytes; ++i)
                cur[i] = static_cast<uint8_t>(src[i] + (prev ? prev[i] : 0));
            break;
        case 3:  // Average
            for (int64_t i = 0; i < row_bytes; ++i) {
                const int a = i >= bpp ? cur[i - bpp] : 0;
                const int b = prev ? prev[i] : 0;
                cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:  // Paeth
            for (int64_t i = 0; i < row_bytes; ++i) {
                const int a = i >= bpp ? cur[i - bpp] : 0;
                const int b = prev ? prev[i] : 0;
                const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                cur[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
            }
            break;
        default:
            return static_cast<int>(-(r + 1));
        }
    }
    return 0;
}
