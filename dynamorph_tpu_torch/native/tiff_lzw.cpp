// TIFF LZW decoder (Compression = 5), the variant of TIFF 6.0 section 13:
// codes of 9 to 12 bits, most significant bit first, ClearCode 256,
// EndOfInformation 257, and the code width growing one code early (at 511,
// 1023 and 2047 table entries), as libtiff reads it.
//
// Native backend for dynamorph_tpu_torch.io.tiff: cv2.imwrite stores its
// TIFFs with LZW by default, and a 2048 x 2048 uint16 frame is 8 MB of
// output, too much to decode in Python.
//
// Exposed as a C ABI for ctypes:
//   int64_t tiff_lzw_decode(const uint8_t* src, int64_t src_len,
//                           uint8_t* dst, int64_t dst_len)
// Decodes one strip until EndOfInformation, the end of the input or a full
// output buffer. Returns the number of bytes written, or -1 for a code that
// is not in the table (a corrupt strip).
//
// Built by dynamorph_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -pthread -o build/native/libtiff_lzw-<hash>.so

#include <cstdint>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kTable = 4096;

struct Bits {
    const uint8_t* src;
    int64_t len;
    int64_t pos = 0;          // next byte
    uint32_t acc = 0;         // bits not yet used, right-aligned
    int n = 0;                // how many

    // the next code of `width` bits, or -1 at the end of the input
    int read(int width) {
        while (n < width) {
            if (pos >= len) return -1;
            acc = (acc << 8) | src[pos++];
            n += 8;
        }
        n -= width;
        return static_cast<int>((acc >> n) & ((1u << width) - 1));
    }
};

}  // namespace

extern "C" {

int64_t tiff_lzw_decode(const uint8_t* src, int64_t src_len, uint8_t* dst,
                        int64_t dst_len) {
    // entry c: its last byte, the entry it extends, its length, first byte
    static thread_local uint8_t suffix[kTable];
    static thread_local int16_t prefix[kTable];
    static thread_local int32_t length[kTable];
    static thread_local uint8_t first[kTable];
    for (int i = 0; i < 256; ++i) {
        suffix[i] = static_cast<uint8_t>(i);
        first[i] = static_cast<uint8_t>(i);
        prefix[i] = -1;
        length[i] = 1;
    }
    Bits bits{src, src_len};
    int width = 9;
    int next = kFirst;
    int old = -1;
    int64_t out = 0;
    while (out < dst_len) {
        int code = bits.read(width);
        if (code < 0 || code == kEoi) break;
        if (code == kClear) {
            width = 9;
            next = kFirst;
            old = -1;
            continue;
        }
        if (old < 0) {                  // the first code after a clear
            if (code > 255) return -1;
            dst[out++] = static_cast<uint8_t>(code);
            old = code;
            continue;
        }
        uint8_t head;
        if (code < next) {
            head = first[code];
        } else if (code == next) {      // KwKwK: the entry being defined
            head = first[old];
        } else {
            return -1;
        }
        if (next < kTable) {
            suffix[next] = head;
            prefix[next] = static_cast<int16_t>(old);
            length[next] = length[old] + 1;
            first[next] = first[old];
            ++next;
            if (next >= (1 << width) - 1 && width < 12) ++width;
        }
        // write the string of `code` back to front, cut at the buffer end
        int32_t n = length[code];
        int64_t end = out + n;
        int c = code;
        for (int64_t p = end - 1; p >= out; --p) {
            if (p < dst_len) dst[p] = suffix[c];
            c = prefix[c];
        }
        out = end < dst_len ? end : dst_len;
        old = code;
    }
    return out;
}

}  // extern "C"
