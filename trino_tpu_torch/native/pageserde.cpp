// Native page-serde kernels: LZ4 block-format compression + xxh64-style checksum.
//
// Reference blueprint (SURVEY.md §2.10 items 2-3): Trino's page wire path uses
// SIMD-accelerated block encoding (simd/BlockEncodingSimdSupport.java) and
// pure-Java LZ4/ZSTD (aircompressor). Here the hot byte-level work is C++
// (-O3 auto-vectorized); framing/metadata stay in Python (runtime/serde.py).
//
// The LZ4 block format implemented is the public interchange format:
//   token(4b lit len | 4b match len) [lit len ext] literals
//   [2B little-endian offset] [match len ext]  (matches >= 4 bytes)
// Compressor: greedy single-probe hash table (LZ4 "fast" level).
//
// Exposed C ABI (ctypes):
//   int64 lz4_compress(const uint8_t* src, int64 n, uint8_t* dst, int64 cap)
//   int64 lz4_decompress(const uint8_t* src, int64 n, uint8_t* dst, int64 cap)
//   int64 lz4_max_compressed(int64 n)
//   uint64 hash64(const uint8_t* src, int64 n)

#include <cstdint>
#include <cstring>

extern "C" {

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash_seq(uint32_t v) {
    return (v * 2654435761u) >> 20;  // 12-bit table
}

int64_t lz4_max_compressed(int64_t n) { return n + n / 255 + 16; }

int64_t lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    if (n < 0 || cap < lz4_max_compressed(n)) return -1;
    const int64_t MINMATCH = 4;
    const int64_t MFLIMIT = 12;   // last bytes must be literals (format rule)
    uint8_t* op = dst;
    int64_t anchor = 0;
    int64_t table[1 << 12];
    for (auto& t : table) t = -1;

    int64_t i = 0;
    while (i + MFLIMIT <= n) {
        uint32_t h = hash_seq(read32(src + i));
        int64_t cand = table[h];
        table[h] = i;
        if (cand >= 0 && i - cand <= 65535 && read32(src + cand) == read32(src + i)) {
            // extend match forward (stop MFLIMIT-5 from the end per format)
            int64_t match_end_limit = n - 5;
            int64_t m = i + MINMATCH, c = cand + MINMATCH;
            while (m < match_end_limit && src[m] == src[c]) { ++m; ++c; }
            int64_t match_len = m - i;
            int64_t lit_len = i - anchor;
            // token
            uint8_t* token = op++;
            if (lit_len >= 15) {
                *token = 0xF0;
                int64_t rest = lit_len - 15;
                while (rest >= 255) { *op++ = 255; rest -= 255; }
                *op++ = (uint8_t)rest;
            } else {
                *token = (uint8_t)(lit_len << 4);
            }
            std::memcpy(op, src + anchor, lit_len);
            op += lit_len;
            // offset
            uint16_t off = (uint16_t)(i - cand);
            *op++ = (uint8_t)(off & 0xFF);
            *op++ = (uint8_t)(off >> 8);
            // match length (stored - MINMATCH)
            int64_t ml = match_len - MINMATCH;
            if (ml >= 15) {
                *token |= 0x0F;
                ml -= 15;
                while (ml >= 255) { *op++ = 255; ml -= 255; }
                *op++ = (uint8_t)ml;
            } else {
                *token |= (uint8_t)ml;
            }
            i += match_len;
            anchor = i;
        } else {
            ++i;
        }
    }
    // trailing literals
    int64_t lit_len = n - anchor;
    uint8_t* token = op++;
    if (lit_len >= 15) {
        *token = 0xF0;
        int64_t rest = lit_len - 15;
        while (rest >= 255) { *op++ = 255; rest -= 255; }
        *op++ = (uint8_t)rest;
    } else {
        *token = (uint8_t)(lit_len << 4);
    }
    std::memcpy(op, src + anchor, lit_len);
    op += lit_len;
    return op - dst;
}

int64_t lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        // literals
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        std::memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // last sequence has no match
        // match
        if (ip + 2 > iend) return -1;
        uint16_t off = (uint16_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        if (off == 0 || op - dst < off) return -1;
        int64_t ml = (token & 0x0F);
        if (ml == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                ml += b;
            } while (b == 255);
        }
        ml += 4;
        if (op + ml > oend) return -1;
        const uint8_t* mp = op - off;
        // overlapping copy must be byte-wise (off may be < 8)
        for (int64_t k = 0; k < ml; ++k) op[k] = mp[k];
        op += ml;
    }
    return op - dst;
}

uint64_t hash64(const uint8_t* src, int64_t n) {
    // 64-bit mix over 8-byte lanes (checksum for wire integrity, not crypto)
    uint64_t acc = 0x9E3779B97F4A7C15ull ^ (uint64_t)n;
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t lane;
        std::memcpy(&lane, src + i, 8);
        lane *= 0xC2B2AE3D27D4EB4Full;
        lane = (lane << 31) | (lane >> 33);
        acc = (acc ^ lane) * 0x9E3779B185EBCA87ull + 0x165667B19E3779F9ull;
    }
    uint64_t tail = 0;
    if (i < n) {
        std::memcpy(&tail, src + i, (size_t)(n - i));
        acc = (acc ^ tail) * 0xC2B2AE3D27D4EB4Full;
    }
    acc ^= acc >> 29;
    acc *= 0xBF58476D1CE4E5B9ull;
    acc ^= acc >> 32;
    return acc;
}

}  // extern "C"
