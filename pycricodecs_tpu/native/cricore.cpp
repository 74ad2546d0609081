// cricore: native host core for pycricodecs_tpu.
//
// Plain-C ABI (loaded via ctypes): CRILAYLA compress/decompress and the
// batched HCA frame unpacker (the serial bitstream half of HCA decode, which
// feeds dense SoA tensors to the JAX transform). Behaviour parity targets:
// crilayla.cpp:48-197 and clHCA_DecodeBlock_unpack (hca.cpp:1149-1205).
//
// Build: g++ -O3 -march=native -fPIC -shared cricore.cpp -o libcricore.so
#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CRC16 (poly 0x8005, MSB-first)
// ---------------------------------------------------------------------------
namespace {
struct CrcTable {
    uint16_t t[256];
    CrcTable() {
        for (int i = 0; i < 256; i++) {
            uint32_t s = i << 8;
            for (int b = 0; b < 8; b++)
                s = (s << 1) ^ ((s & 0x8000) ? 0x8005 : 0);
            t[i] = (uint16_t)(s & 0xFFFF);
        }
    }
};
// C++11 magic static: thread-safe one-time init (ctypes calls arrive from
// multiple Python threads with the GIL released)
const uint16_t* crc_table() {
    static const CrcTable tbl;
    return tbl.t;
}
}  // namespace

namespace {
// Slice-by-8 tables: S[k][v] = CRC16 of byte v followed by k zero bytes.
// Lets 8 input bytes fold with 8 independent lookups instead of an 8-deep
// serial chain (the frame-unpack hot path CRCs every 512-byte frame).
struct Crc8Table {
    uint16_t s[8][256];
    Crc8Table() {
        const uint16_t* t = crc_table();
        for (int v = 0; v < 256; v++) s[0][v] = t[v];
        for (int k = 1; k < 8; k++)
            for (int v = 0; v < 256; v++) {
                uint16_t p = s[k - 1][v];
                s[k][v] = (uint16_t)((p << 8) ^ t[p >> 8]);
            }
    }
};
const uint16_t (*crc8_table())[256] {
    static const Crc8Table tbl;
    return tbl.s;
}
}  // namespace

uint16_t cri_crc16(const uint8_t* data, uint32_t size) {
    const uint16_t* tbl = crc_table();
    const uint16_t (*s8)[256] = crc8_table();
    uint16_t s = 0;
    uint32_t i = 0;
    for (; i + 8 <= size; i += 8) {
        const uint8_t* b = data + i;
        s = (uint16_t)(s8[7][b[0] ^ (s >> 8)] ^ s8[6][b[1] ^ (s & 0xFF)]
                       ^ s8[5][b[2]] ^ s8[4][b[3]] ^ s8[3][b[4]]
                       ^ s8[2][b[5]] ^ s8[1][b[6]] ^ s8[0][b[7]]);
    }
    for (; i < size; i++)
        s = (uint16_t)((s << 8) ^ tbl[(s >> 8) ^ data[i]]);
    return s;
}

void cri_crc16_batch(const uint8_t* rows, uint32_t nrows, uint32_t rowlen,
                     uint16_t* out) {
    for (uint32_t r = 0; r < nrows; r++)
        out[r] = cri_crc16(rows + (uint64_t)r * rowlen, rowlen);
}

// ---------------------------------------------------------------------------
// CRILAYLA
// ---------------------------------------------------------------------------
namespace layla {

struct RevBitReader {
    const uint8_t* p;      // moves backward
    const uint8_t* begin;  // first valid byte
    uint32_t count = 0;    // bits buffered
    uint32_t acc = 0;
    bool underrun = false;
    RevBitReader(const uint8_t* end_minus_1, const uint8_t* begin_)
        : p(end_minus_1), begin(begin_) {}
    uint32_t get(uint32_t n) {
        while (count < n) {
            // bounds-checked per byte: a single token (e.g. the 0xFF
            // length-extension loop) can consume unbounded bytes, so the
            // caller's per-token check alone cannot prevent reads below
            // the buffer. Feed zeros and flag; zeros also terminate the
            // 0xFF loop.
            uint8_t byte = 0;
            if (p < begin) {
                underrun = true;
            } else {
                byte = *p--;
            }
            acc = (acc << 8) | byte;
            count += 8;
        }
        uint32_t v = (acc >> (count - n)) & ((1u << n) - 1);
        count -= n;
        return v;
    }
};

}  // namespace layla

// Decompress the LZ stream. src points at the compressed payload (after the
// 16-byte header); dst must hold decompress_size + 256 bytes. Returns bytes
// produced in the LZ region, or -1 on a malformed/hostile stream (bit reader
// underrun or back-reference outside the output buffer — the reference
// crashes on such inputs).
int64_t cri_layla_decompress(const uint8_t* src, uint32_t compressed_size,
                             uint32_t decompress_size, uint8_t* dst) {
    // raw 256-byte prefix sits after the compressed stream; it becomes the
    // head of the output
    std::memcpy(dst, src + compressed_size, 256);
    uint8_t* out_base = dst + 256;
    uint8_t* out_end = out_base + decompress_size;
    uint8_t* w = out_base + decompress_size - 1;  // write backward
    layla::RevBitReader br(src + compressed_size - 1, src);

    while (w >= out_base) {
        if (br.underrun) return -1;  // bitstream underrun
        if (br.get(1) == 0) {
            *w-- = (uint8_t)br.get(8);
        } else {
            uint32_t offset = br.get(13);
            uint32_t len = br.get(2);
            if (len == 3) {
                len += br.get(3);
                if (len == 10) {
                    len += br.get(5);
                    if (len == 41) {
                        uint32_t byte;
                        do {
                            byte = br.get(8);
                            len += byte;
                        } while (byte == 255);
                    }
                }
            }
            const uint8_t* r = w + offset + 3;
            if (r >= out_end) return -1;  // back-reference past buffer end
            len += 3;
            while (len-- && w >= out_base)
                *w-- = *r--;
        }
    }
    return br.underrun ? -1 : (int64_t)decompress_size;
}

// Compress src[0..src_len) with the reference's greedy backward matcher.
// dst must hold at least src_len + src_len/2 + 0x400 bytes (generous bound;
// worst case is 9 bits per literal + trailer). Returns total output length
// (header + stream + 256-byte prefix), or 0 if it would exceed dst_cap.
uint32_t cri_layla_compress(const uint8_t* src, uint32_t src_len,
                            uint8_t* dst, uint32_t dst_cap) {
    if (src_len < 0x101) return 0;
    // The %4 stream padding depends on the work buffer length mod 4; the
    // reference uses a buffer of exactly src_len bytes. Keep work_cap
    // congruent to src_len (mod 4) so the emitted bytes are identical, while
    // still leaving headroom for incompressible data.
    const uint32_t work_cap = src_len + ((src_len / 2 + 0x403) & ~3u);
    std::vector<uint8_t> work(work_cap, 0);
    int64_t m = (int64_t)work_cap - 1;
    uint64_t d = 0;
    uint32_t T = 0;

    auto flush = [&]() {
        while (T >= 8) {
            if (m < 0) return false;
            work[m--] = (uint8_t)((d >> (T - 8)) & 0xFF);
            T -= 8;
            d &= (T >= 64) ? ~0ull : ((1ull << T) - 1);
        }
        return true;
    };

    // Greedy backward matcher accelerated with 3-byte hash chains over the
    // candidate positions (exactly the reference's choices: longest match,
    // earliest candidate). Chains are kept in DESCENDING position order;
    // since n only decreases, candidates above the window (i >= n+3+0x2000)
    // expire permanently and are pruned from the head; the in-window chain
    // segment is collected and scanned in ascending order like the
    // reference's brute-force loop.
    const uint32_t HASH_BITS = 16;
    const uint32_t HASH_SIZE = 1u << HASH_BITS;
    std::vector<int32_t> head(HASH_SIZE, -1);
    std::vector<int32_t> nxt(src_len, -1);
    auto hash3 = [&](uint32_t p) {
        uint32_t v = (uint32_t)src[p] | ((uint32_t)src[p - 1] << 8)
                     | ((uint32_t)src[p - 2] << 16);
        return (v * 2654435761u) >> (32 - HASH_BITS);
    };
    // insert ascending so each bucket ends up descending from the head
    for (uint32_t p = 0x102; p < src_len; p++) {
        uint32_t h = hash3(p);
        nxt[p] = head[h];
        head[h] = (int32_t)p;
    }
    std::vector<uint32_t> cands;
    cands.reserve(0x2000);

    int64_t n = (int64_t)src_len - 1;
    while (n >= 0x100) {
        uint32_t j = (uint32_t)std::min<int64_t>(n + 3 + 0x2000, src_len);
        uint32_t best_len = 0, best_off = 0;
        uint32_t kmax = (uint32_t)(n - 0x100);
        if (kmax >= 2) {  // only matches of length >= 3 can win
            uint32_t h = hash3((uint32_t)n);
            // permanently drop candidates above the (monotonically
            // shrinking) window
            while (head[h] != -1 && (uint32_t)head[h] >= j)
                head[h] = nxt[head[h]];
            cands.clear();
            for (int32_t i = head[h]; i != -1 && i > (int64_t)n + 2;
                 i = nxt[i])
                cands.push_back((uint32_t)i);
            for (auto it = cands.rbegin(); it != cands.rend(); ++it) {
                uint32_t cand = *it;
                if (best_len) {
                    if (cand < best_len
                        || src[n - best_len] != src[cand - best_len])
                        continue;
                }
                uint32_t k = 0;
                while (k <= kmax && src[n - k] == src[cand - k]) k++;
                if (k > best_len) {
                    best_off = cand - (uint32_t)n - 3;
                    best_len = k;
                    if (best_len > kmax) break;  // maximal possible
                }
            }
            if (best_len < 3) best_len = 0;  // literal, same as reference
        } else {
            // short tail near the 0x100 boundary: brute force (tiny)
            for (uint32_t i = (uint32_t)n + 3; i < j; i++) {
                uint32_t k = 0;
                while (k <= kmax && src[n - k] == src[i - k]) k++;
                if (k > best_len) {
                    best_off = i - (uint32_t)n - 3;
                    best_len = k;
                }
            }
        }
        if (best_len < 3) {
            d = (d << 9) | src[n--];
            T += 9;
        } else {
            d = (((d << 1) | 1) << 13) | best_off;
            T += 14;
            n -= best_len;
            uint32_t p = best_len;
            if (p < 6) {
                d = (d << 2) | (p - 3);
                T += 2;
            } else if (p < 13) {
                d = (((d << 2) | 3) << 3) | (p - 6);
                T += 5;
            } else if (p < 44) {
                d = (((d << 5) | 0x1f) << 5) | (p - 13);
                T += 10;
            } else {
                d = (d << 10) | 0x3ff;
                T += 10;
                p -= 44;
                for (;;) {
                    if (!flush()) return 0;
                    if (p < 255) break;
                    d = (d << 8) | 0xff;
                    T += 8;
                    p -= 0xff;
                }
                d = (d << 8) | p;
                T += 8;
            }
        }
        if (!flush()) return 0;
    }
    if (T != 0) {
        if (m < 0) return 0;
        work[m--] = (uint8_t)(d << (8 - T));
    }
    if (m < 2) return 0;
    work[m--] = 0;
    work[m] = 0;
    while (((work_cap - m) & 3) != 0) {
        if (m < 1) return 0;
        work[--m] = 0;
    }
    uint32_t stream_len = (uint32_t)(work_cap - m);
    uint32_t total = stream_len + 0x110;
    if (total > dst_cap) return 0;
    // header
    std::memcpy(dst, "CRILAYLA", 8);
    uint32_t usize = src_len - 0x100;
    std::memcpy(dst + 8, &usize, 4);
    std::memcpy(dst + 12, &stream_len, 4);
    std::memcpy(dst + 16, work.data() + m, stream_len);
    std::memcpy(dst + 16 + stream_len, src, 0x100);
    return total;
}

// ---------------------------------------------------------------------------
// HCA batched frame unpack
// ---------------------------------------------------------------------------
namespace hca {

// Fast MSB-first reader. Requires 8 readable bytes past the logical end
// (callers pad their buffers). A cached 64-bit big-endian window serves most
// peeks without touching memory; it refills (one unaligned load + bswap)
// only when the requested bits fall outside it, which also covers backward
// skips (the unsigned diff wraps and forces a refill). Reads of up to 57
// bits are always available post-refill (window start is byte-aligned).
struct BitReader {
    const uint8_t* data;
    int size;  // bits
    int pos = 0;
    uint64_t cache = 0;
    int cbase = INT32_MIN / 2;  // bit offset of cache start; force 1st refill
    BitReader(const uint8_t* d, int bytes) : data(d), size(bytes * 8) {}
    inline void refill() {
        const int byte = pos >> 3;
        uint64_t v;
        std::memcpy(&v, data + byte, 8);
#if defined(__GNUC__)
        v = __builtin_bswap64(v);
#else
        v = ((v & 0xFFull) << 56) | ((v & 0xFF00ull) << 40) |
            ((v & 0xFF0000ull) << 24) | ((v & 0xFF000000ull) << 8) |
            ((v >> 8) & 0xFF000000ull) | ((v >> 24) & 0xFF0000ull) |
            ((v >> 40) & 0xFF00ull) | (v >> 56);
#endif
        cache = v;
        cbase = byte << 3;
    }
    inline uint32_t peek(int n) {
        if (n <= 0 || pos + n > size) return 0;
        uint32_t diff = (uint32_t)(pos - cbase);
        if (diff + (uint32_t)n > 64u) {
            refill();
            diff = (uint32_t)(pos & 7);
        }
        return (uint32_t)((cache << diff) >> (64 - n));
    }
    inline uint32_t read(int n) {
        uint32_t v = peek(n);
        pos += n;
        return v;
    }
    inline void skip(int n) { pos += n; }
};

}  // namespace hca

// Shared per-frame unpack body: scalefactor deltas, intensity / v2 HFR
// scales, ATH-driven resolutions (+ optional noise/valid band lists) and
// the spectrum codes. Used by BOTH cri_hca_unpack_frames (decode) and
// cri_hca_test_frames (key search) so the two cannot drift. `br` must sit
// just past the 32-bit frame header fields. Returns 0 or <0 on malformed
// bitstream values.
static int hca_unpack_frame_body(
    hca::BitReader& br, int packed_noise, int C, bool v3,
    int32_t hfr_group_count, int32_t min_resolution, int32_t max_resolution,
    const uint8_t* channel_type, const int32_t* coded_count,
    const uint8_t* ath, const uint8_t* invert_table,
    const uint8_t* max_bit_table, const uint8_t* read_bit_table,
    const int8_t* read_val_table,
    uint8_t* sfs_f, uint8_t* res_f, uint8_t* int_f, int16_t* qc_f,
    uint8_t* noises_f /* [C*128] or null */,
    int32_t* counts_f /* [C*2] or null */) {
    for (int c = 0; c < C; c++) {
        uint8_t* sf = sfs_f + (size_t)c * 128;
        std::memset(sf, 0, 128);
        int ct = channel_type[c];
        int cs_count = coded_count[c];
        int extra = 0;
        int delta_bits = br.read(3);
        if (!(ct == 2 || hfr_group_count <= 0 || !v3)) {
            extra = hfr_group_count;
            cs_count += extra;
            if (cs_count > 128) return -5;
        }
        if (delta_bits >= 6) {
            for (int i = 0; i < cs_count; i++) sf[i] = (uint8_t)br.read(6);
        } else if (delta_bits > 0) {
            int expected = (1 << delta_bits) - 1;
            int value = br.read(6);
            sf[0] = (uint8_t)value;
            for (int i = 1; i < cs_count; i++) {
                int delta = br.read(delta_bits);
                if (delta == expected) {
                    value = br.read(6);
                } else {
                    int test = value + (delta - (expected >> 1));
                    if (test < 0 || test >= 64) return -5;
                    value = (value - (expected >> 1) + delta) & 0x3F;
                }
                sf[i] = (uint8_t)value;
            }
        }
        for (int i = 0; i < extra; i++)
            sf[127 - i] = sf[cs_count - i];

        // intensity / v2 HFR scales
        uint8_t* inten = int_f + (size_t)c * 8;
        std::memset(inten, 0, 8);
        if (ct == 2) {
            if (!v3) {
                int value = br.peek(4);
                inten[0] = (uint8_t)value;
                if (value < 15) {
                    br.skip(4);
                    for (int i = 1; i < 8; i++) inten[i] = (uint8_t)br.read(4);
                }
            } else {
                int value = br.peek(4);
                if (value < 15) {
                    br.skip(4);
                    int dbits = br.read(2);
                    inten[0] = (uint8_t)value;
                    if (dbits == 3) {
                        for (int i = 1; i < 8; i++)
                            inten[i] = (uint8_t)br.read(4);
                    } else {
                        int bmax = (2 << dbits) - 1;
                        int bits = dbits + 1;
                        for (int i = 1; i < 8; i++) {
                            int delta = br.read(bits);
                            if (delta == bmax) {
                                value = br.read(4);
                            } else {
                                value = value - (bmax >> 1) + delta;
                                if (value > 15 || value < 0) return -5;
                            }
                            inten[i] = (uint8_t)value;
                        }
                    }
                } else {
                    br.skip(4);
                    for (int i = 0; i < 8; i++) inten[i] = 7;
                }
            }
        } else if (!v3) {
            for (int i = 0; i < hfr_group_count; i++)
                sf[128 - hfr_group_count + i] = (uint8_t)br.read(6);
        }

        // resolutions + optional noise/valid lists
        uint8_t* res = res_f + (size_t)c * 128;
        std::memset(res, 0, 128);
        int cc = coded_count[c];
        int noise_count = 0, valid_count = 0;
        uint8_t* noises = noises_f ? noises_f + (size_t)c * 128 : nullptr;
        int i = 0;
#if defined(__AVX2__)
        if (!noises) {
            // the noise/valid list build is order-dependent; without it the
            // per-band resolution derivation is elementwise (also feeds the
            // batched key scorer via cri_hca_test_frames)
            // widen the table unconditionally per call: the 72-int copy is
            // negligible next to the frame work, and both a once-flag and a
            // pointer key were wrong (stale values / ABA on a reallocated
            // address, respectively)
            alignas(32) int32_t inv32[72];
            for (int k = 0; k < 72; ++k)
                inv32[k] = k <= 65 ? invert_table[k] : 0;
            const __m256i vmaxr = _mm256_set1_epi32(max_resolution);
            const __m256i vminr = _mm256_set1_epi32(min_resolution);
            const __m256i seq = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
            const __m256i vpn = _mm256_set1_epi32(packed_noise);
            for (; i + 8 <= cc; i += 8) {
                __m256i sv = _mm256_cvtepu8_epi32(
                    _mm_loadl_epi64((const __m128i*)(sf + i)));
                __m256i av = _mm256_cvtepu8_epi32(
                    _mm_loadl_epi64((const __m128i*)(ath + i)));
                __m256i iv = _mm256_add_epi32(_mm256_set1_epi32(i), seq);
                __m256i nl = _mm256_add_epi32(
                    av, _mm256_srai_epi32(_mm256_add_epi32(vpn, iv), 8));
                __m256i cp = _mm256_sub_epi32(
                    _mm256_add_epi32(nl, _mm256_set1_epi32(1)),
                    _mm256_srai_epi32(
                        _mm256_mullo_epi32(sv, _mm256_set1_epi32(5)), 1));
                __m256i neg = _mm256_cmpgt_epi32(_mm256_setzero_si256(), cp);
                __m256i over = _mm256_cmpgt_epi32(cp,
                                                  _mm256_set1_epi32(65));
                __m256i idx = _mm256_min_epi32(
                    _mm256_max_epi32(cp, _mm256_setzero_si256()),
                    _mm256_set1_epi32(65));
                __m256i r = _mm256_i32gather_epi32(inv32, idx, 4);
                r = _mm256_andnot_si256(over, r);           // > 65 -> 0
                r = _mm256_blendv_epi8(r, _mm256_set1_epi32(15), neg);
                // exact scalar clamp order: r>max -> max, ELSE r<min -> min
                // (a min/max chain would differ on hostile min>max headers)
                __m256i gt = _mm256_cmpgt_epi32(r, vmaxr);
                __m256i lt = _mm256_cmpgt_epi32(vminr, r);
                r = _mm256_blendv_epi8(r, vmaxr, gt);
                r = _mm256_blendv_epi8(r, vminr, _mm256_andnot_si256(gt, lt));
                // s == 0 -> r = 0 (overrides the min-clamp, like the scalar
                // early-out)
                r = _mm256_and_si256(
                    r, _mm256_cmpgt_epi32(sv, _mm256_setzero_si256()));
                __m256i p16 = _mm256_packus_epi32(r, r);
                __m256i p8 = _mm256_packus_epi16(p16, p16);
                const uint32_t lo =
                    (uint32_t)_mm256_extract_epi32(p8, 0);
                const uint32_t hi =
                    (uint32_t)_mm256_extract_epi32(p8, 4);
                std::memcpy(res + i, &lo, 4);
                std::memcpy(res + i + 4, &hi, 4);
            }
        }
#endif
        for (; i < cc; i++) {
            int r = 0;
            int s = sf[i];
            if (s > 0) {
                int noise_level = ath[i] + ((packed_noise + i) >> 8);
                int curve_pos = noise_level + 1 - ((5 * s) >> 1);
                if (curve_pos < 0) r = 15;
                else if (curve_pos <= 65) r = invert_table[curve_pos];
                else r = 0;
                if (r > max_resolution) r = max_resolution;
                else if (r < min_resolution) r = min_resolution;
                if (noises) {
                    if (r < 1) noises[noise_count++] = (uint8_t)i;
                    else noises[127 - valid_count++] = (uint8_t)i;
                }
            }
            res[i] = (uint8_t)r;
        }
        if (counts_f) {
            counts_f[(size_t)c * 2 + 0] = noise_count;
            counts_f[(size_t)c * 2 + 1] = valid_count;
        }
    }

    // spectrum codes, subframe-major
    for (int s = 0; s < 8; s++) {
        for (int c = 0; c < C; c++) {
            const uint8_t* res = res_f + (size_t)c * 128;
            int16_t* out = qc_f + ((size_t)c * 8 + s) * 128;
            std::memset(out, 0, 128 * sizeof(int16_t));
            int cc = coded_count[c];
            for (int i = 0; i < cc; i++) {
                int r = res[i];
                int bits = max_bit_table[r];
                uint32_t code = br.read(bits);
                if (r > 7) {
                    int v = (1 - (int)((code & 1) << 1)) * (int)(code >> 1);
                    if (v == 0) br.skip(-1);
                    out[i] = (int16_t)v;
                } else {
                    int index = (r << 4) + code;
                    br.skip((int)read_bit_table[index] - bits);
                    out[i] = read_val_table[index];
                }
            }
        }
    }
    return 0;
}

// Per-frame unpack into SoA tensors. Layouts match ops/hca_frame.py.
// Returns 0 on success, <0 on bitstream error (-4 sync, -3 crc, -5 unpack).
int cri_hca_unpack_frames(
    const uint8_t* data, int32_t nframes, int32_t frame_size,
    const uint8_t* cipher, int32_t channels, int32_t version,
    int32_t hfr_group_count, int32_t min_resolution, int32_t max_resolution,
    const uint8_t* channel_type, const int32_t* coded_count,
    const uint8_t* ath, const uint8_t* invert_table,
    const uint8_t* max_bit_table, const uint8_t* read_bit_table,
    const int8_t* read_val_table,
    uint32_t* random_state,
    int16_t* qc, uint8_t* sfs_out, uint8_t* ress_out, uint8_t* intens_out,
    int32_t* noise_src, uint8_t* noise_sci, uint8_t* noise_mask,
    int32_t nthreads) {
    const int C = channels;
    const bool need_noise = (min_resolution == 0);
    const bool v3 = version > 0x0200;

    // per-frame noise bookkeeping (needed serially for the LCG ordering)
    std::vector<uint8_t> noises_all;
    std::vector<int32_t> counts_all;
    if (need_noise) {
        noises_all.resize((size_t)nframes * C * 128);
        counts_all.resize((size_t)nframes * C * 2);
    }

    std::vector<uint8_t> decbuf_all;
    int err = 0;

    auto unpack_frame = [&](int f) -> int {
        const uint8_t* frame = data + (size_t)f * frame_size;
        if (!(frame[0] == 0xFF && frame[1] == 0xFF)) return -4;
        if (cri_crc16(frame, frame_size) != 0) return -3;
        thread_local std::vector<uint8_t> dec;
        dec.resize(frame_size + 8);  // +8: BitReader overreads up to 8 bytes
        for (int i = 0; i < frame_size; i++) dec[i] = cipher[frame[i]];
        std::memset(dec.data() + frame_size, 0, 8);
        hca::BitReader br(dec.data(), frame_size);
        br.skip(16);
        int anl = br.read(9);
        int evb = br.read(7);
        int packed_noise = (anl << 8) - evb;

        uint8_t* sfs_f = sfs_out + ((size_t)f * C) * 128;
        uint8_t* res_f = ress_out + ((size_t)f * C) * 128;
        uint8_t* int_f = intens_out + ((size_t)f * C) * 8;
        int16_t* qc_f = qc + ((size_t)f * C) * 8 * 128;
        uint8_t* noises_f = need_noise
            ? noises_all.data() + (size_t)f * C * 128 : nullptr;
        int32_t* counts_f = need_noise
            ? counts_all.data() + (size_t)f * C * 2 : nullptr;
        return hca_unpack_frame_body(
            br, packed_noise, C, v3, hfr_group_count, min_resolution,
            max_resolution, channel_type, coded_count, ath, invert_table,
            max_bit_table, read_bit_table, read_val_table,
            sfs_f, res_f, int_f, qc_f, noises_f, counts_f);
    };

    // frames are independent at unpack time: thread across them
    int nt = nthreads > 0 ? nthreads : 1;
    if (nt > 1 && nframes > 4) {
        std::vector<std::thread> pool;
        std::vector<int> errs(nt, 0);
        int per = (nframes + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            pool.emplace_back([&, t]() {
                int lo = t * per, hi = std::min(nframes, (t + 1) * per);
                for (int f = lo; f < hi; f++) {
                    int e = unpack_frame(f);
                    if (e < 0) { errs[t] = e; return; }
                }
            });
        }
        for (auto& th : pool) th.join();
        for (int e : errs) if (e < 0) return e;
    } else {
        for (int f = 0; f < nframes; f++) {
            int e = unpack_frame(f);
            if (e < 0) return e;
        }
    }

    // serial LCG pass for noise-fill maps (v3 streams only)
    if (need_noise) {
        uint32_t random = *random_state;
        for (int f = 0; f < nframes; f++) {
            for (int s = 0; s < 8; s++) {
                for (int c = 0; c < C; c++) {
                    int nc = counts_all[((size_t)f * C + c) * 2 + 0];
                    int vc = counts_all[((size_t)f * C + c) * 2 + 1];
                    if (vc <= 0 || nc <= 0) continue;
                    const uint8_t* noises =
                        noises_all.data() + ((size_t)f * C + c) * 128;
                    const uint8_t* sf = sfs_out + ((size_t)f * C + c) * 128;
                    size_t base = (((size_t)f * C + c) * 8 + s) * 128;
                    for (int i = 0; i < nc; i++) {
                        random = 0x343FDu * random + 0x269EC3u;
                        int rindex = 128 - vc + (int)(((random & 0x7FFF) * vc) >> 15);
                        int nb = noises[i];
                        int vb = noises[rindex];
                        int sci = (int)sf[nb] - (int)sf[vb] + 62;
                        if (sci < 0) sci = 0;
                        noise_src[base + nb] = vb;
                        noise_sci[base + nb] = (uint8_t)sci;
                        noise_mask[base + nb] = 1;
                    }
                }
            }
        }
        *random_state = random;
    }
    (void)err;
    return 0;
}


// ---------------------------------------------------------------------------
// HCA batched frame pack (encoder back-end, PackFrame parity)
// ---------------------------------------------------------------------------
namespace hca {

// Append-only MSB-first writer: bits collect in a 64-bit accumulator and
// drain a byte at a time (the buffer is pre-zeroed by callers, so the final
// partial byte just ORs in). Out-of-bounds writes are dropped whole without
// advancing, like the masked per-byte writer this replaces. Callers must
// flush() before reading the buffer back (pack_frames does, before CRC).
struct BitWriter {
    uint8_t* buf;
    int size_bits;
    int pos = 0;
    uint64_t acc = 0;
    int nacc = 0;
    int bytepos = 0;
    BitWriter(uint8_t* b, int bytes) : buf(b), size_bits(bytes * 8) {}
    inline void write(uint32_t value, int n) {
        if (n <= 0 || n > 32 || pos + n > size_bits) return;
        value &= (n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1);
        pos += n;
        acc = (acc << n) | value;   // nacc < 8 on entry, so nacc + n < 40
        nacc += n;
        while (nacc >= 8) {
            nacc -= 8;
            buf[bytepos++] = (uint8_t)(acc >> nacc);
        }
    }
    inline void flush() {
        if (nacc > 0) {
            buf[bytepos] |= (uint8_t)((acc & ((1u << nacc) - 1))
                                      << (8 - nacc));
            acc = 0;
            nacc = 0;
        }
    }
};

}  // namespace hca

// Pack a run of encoded frames. Layouts mirror ops/hca_frame.pack_frame.
// quantized is int32 [F, C, 8, 128]; hfr_scales int32 [F, C, max(G,1)].
void cri_hca_pack_frames(
    int32_t nframes, int32_t frame_size, int32_t channels,
    int32_t hfr_group_count,
    const uint8_t* channel_type, const int32_t* coded_count,
    const int32_t* anl, const int32_t* evb,
    const uint8_t* sfs, const uint8_t* ress, const uint8_t* intens,
    const int32_t* hfr_scales, const int32_t* delta_bits,
    const int32_t* quantized,
    const uint8_t* q_bits_tab,   // [8,16]
    const uint8_t* q_val_tab,    // [8,16]
    const uint8_t* max_bits_tab, // [16]
    uint8_t* out,                // [F, frame_size]
    int32_t nthreads) {
    const int C = channels;
    const int G = hfr_group_count > 0 ? hfr_group_count : 1;

    auto pack_one = [&](int f) {
        uint8_t* frame = out + (size_t)f * frame_size;
        std::memset(frame, 0, frame_size);
        frame[0] = 0xFF;
        frame[1] = 0xFF;
        hca::BitWriter bw(frame + 2, frame_size - 2);
        bw.write((uint32_t)anl[f], 9);
        bw.write((uint32_t)evb[f], 7);
        for (int c = 0; c < C; c++) {
            int cc = coded_count[c];
            const uint8_t* sf = sfs + ((size_t)f * C + c) * 128;
            int db = delta_bits[(size_t)f * C + c];
            bw.write((uint32_t)db, 3);
            if (db != 0) {
                if (db == 6) {
                    for (int i = 0; i < cc; i++) bw.write(sf[i], 6);
                } else {
                    bw.write(sf[0], 6);
                    int max_delta = (1 << (db - 1)) - 1;
                    int escape = (1 << db) - 1;
                    for (int i = 1; i < cc; i++) {
                        int delta = (int)sf[i] - (int)sf[i - 1];
                        if (delta > max_delta || delta < -max_delta) {
                            bw.write((uint32_t)escape, db);
                            bw.write(sf[i], 6);
                        } else {
                            bw.write((uint32_t)(max_delta + delta), db);
                        }
                    }
                }
            }
            if (channel_type[c] == 2) {
                const uint8_t* in = intens + ((size_t)f * C + c) * 8;
                for (int i = 0; i < 8; i++) bw.write(in[i], 4);
            } else if (hfr_group_count > 0) {
                const int32_t* hs = hfr_scales + ((size_t)f * C + c) * G;
                for (int g = 0; g < hfr_group_count; g++)
                    bw.write((uint32_t)hs[g], 6);
            }
        }
        for (int s = 0; s < 8; s++) {
            for (int c = 0; c < C; c++) {
                int cc = coded_count[c];
                const uint8_t* res = ress + ((size_t)f * C + c) * 128;
                const int32_t* q = quantized + (((size_t)f * C + c) * 8 + s) * 128;
                for (int i = 0; i < cc; i++) {
                    int r = res[i];
                    int qv = q[i];
                    if (r == 0) continue;
                    if (r < 8) {
                        int bits = q_bits_tab[r * 16 + qv + 8];
                        bw.write(q_val_tab[r * 16 + qv + 8], bits);
                    } else if (r < 16) {
                        int bits = max_bits_tab[r] - 1;
                        bw.write((uint32_t)(qv < 0 ? -qv : qv), bits);
                        if (qv != 0) bw.write(qv > 0 ? 0u : 1u, 1);
                    }
                }
            }
        }
        bw.flush();
        uint16_t crc = cri_crc16(frame, frame_size - 2);
        frame[frame_size - 2] = (uint8_t)(crc >> 8);
        frame[frame_size - 1] = (uint8_t)crc;
    };

    int nt = nthreads > 0 ? nthreads : 1;
    if (nt > 1 && nframes > 8) {
        std::vector<std::thread> pool;
        int per = (nframes + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            pool.emplace_back([&, t]() {
                int lo = t * per, hi = std::min(nframes, (t + 1) * per);
                for (int f = lo; f < hi; f++) pack_one(f);
            });
        }
        for (auto& th : pool) th.join();
    } else {
        for (int f = 0; f < nframes; f++) pack_one(f);
    }
}


// ---------------------------------------------------------------------------
// ADX block-ADPCM serial recurrences
//
// Host fast path for single files / small batches where device dispatch
// latency dominates (the batched device path in ops/adx_kernels.py serves
// banks). Bit-exact mirrors of adx_decode_numpy /
// adx_encode_numpy in ops/adx_kernels.py (themselves parity-verified against
// the reference decoder adx.cpp:189-213 and encoder adx.cpp:215-273). All
// arithmetic in int64 with C truncation semantics, matching the numpy mirror.
// ---------------------------------------------------------------------------

static inline int64_t adx_clamp16(int64_t v) {
    return v > 0x7FFF ? 0x7FFF : (v < -0x8000 ? -0x8000 : v);
}

// Decode lanes [L, N]: out[l, t] = clamp(q*s + (c0*p1 >> 12) + (c1*p2 >> 12)).
// Lanes are independent; threads split the lane axis.
void cri_adx_decode_scan(const int32_t* codes, const int32_t* scales,
                         const int32_t* c0, const int32_t* c1,
                         const int32_t* h1, const int32_t* h2,
                         int32_t L, int64_t N, int16_t* out,
                         int32_t nthreads) {
    auto run = [&](int32_t lo, int32_t hi) {
        for (int32_t l = lo; l < hi; ++l) {
            const int32_t* q = codes + (size_t)l * N;
            const int32_t* s = scales + (size_t)l * N;
            const int32_t* a0 = c0 + (size_t)l * N;
            const int32_t* a1 = c1 + (size_t)l * N;
            int16_t* o = out + (size_t)l * N;
            int64_t p1 = h1[l], p2 = h2[l];
            for (int64_t t = 0; t < N; ++t) {
                int64_t v = (int64_t)q[t] * s[t]
                            + (((int64_t)a0[t] * p1) >> 12)
                            + (((int64_t)a1[t] * p2) >> 12);
                v = adx_clamp16(v);
                p2 = p1;
                p1 = v;
                o[t] = (int16_t)v;
            }
        }
    };
    int nt = nthreads > 0 ? nthreads
                          : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > L) nt = L;
    if (nt <= 1) { run(0, L); return; }
    std::vector<std::thread> pool;
    int32_t per = (L + nt - 1) / nt;
    for (int i = 0; i < nt; ++i) {
        int32_t lo = i * per, hi = std::min(L, lo + per);
        if (lo >= hi) break;
        pool.emplace_back(run, lo, hi);
    }
    for (auto& th : pool) th.join();
}

static inline int64_t adx_tdiv(int64_t a, int64_t b) {
    // C division already truncates toward zero
    return a / b;
}

// Encode lanes: pcm [L, B, spb] -> codes [L, B, spb], scale_raw [L, B],
// zero [L, B]. Mirrors adx_encode_numpy exactly (two passes per block:
// residual min/max against original history, then quantisation with
// simulated-decoder feedback; zero blocks carry original history).
void cri_adx_encode_scan(const int32_t* pcm, const int32_t* c0v,
                         const int32_t* c1v, const int32_t* h1v,
                         const int32_t* h2v, int32_t L, int32_t B,
                         int32_t spb, int32_t encoding_mode,
                         int32_t bit_depth, int32_t* codes,
                         int32_t* scale_raw_out, uint8_t* zero_out,
                         int32_t nthreads, int32_t scale_fix) {
    const int64_t limit = ((int64_t)1 << (bit_depth - 1)) - 1;
    auto run = [&](int32_t lo, int32_t hi) {
        for (int32_t l = lo; l < hi; ++l) {
            const int64_t a0 = c0v[l], a1 = c1v[l];
            int64_t h1 = h1v[l], h2 = h2v[l];
            for (int32_t b = 0; b < B; ++b) {
                const int32_t* blk = pcm + ((size_t)l * B + b) * spb;
                int32_t* cod = codes + ((size_t)l * B + b) * spb;
                // pass 1: residuals vs original-sample prediction
                int64_t mn = 0, mx = 0;
                int64_t p1 = h1, p2 = h2;
                for (int32_t t = 0; t < spb; ++t) {
                    int64_t r = (((int64_t)blk[t] * 4096) - a0 * p1 - a1 * p2)
                                >> 12;
                    if (r < mn) mn = r;
                    if (r > mx) mx = r;
                    p2 = p1;
                    p1 = blk[t];
                }
                bool zero = (mn == 0 && mx == 0);
                int64_t scale = std::max(adx_tdiv(mx, limit),
                                         adx_tdiv(mn, -(limit + 1)));
                // reference u16 truncation BEFORE the cap; not in scale_fix
                if (!scale_fix) scale &= 0xFFFF;
                if (scale > 0x1000) scale = 0x1000;
                int64_t scale_raw, scale_eff;
                if (encoding_mode == 4) {
                    int64_t power = 0;
                    if (scale >= 1) {
                        int64_t v = scale;
                        while (v > 1) { v >>= 1; ++power; }
                        ++power;  // floor(log2(scale)) + 1
                    }
                    scale_eff = (int64_t)1 << power;
                    scale_raw = 12 - power;
                } else if (encoding_mode == 2) {
                    scale_raw = scale & 0x1FFF;
                    scale_eff = scale;
                } else {
                    scale_raw = scale;
                    scale_eff = scale;
                }
                if (scale_eff < 1) scale_eff = 1;
                // pass 2: quantise with decoder feedback
                int64_t q1 = h1, q2 = h2;
                if (scale_fix) {
                    // decoder-exact arithmetic; see cri_adx_encode_blocks
                    const int64_t eff =
                        encoding_mode == 4 ? scale_eff : scale + 1;
                    for (int32_t t = 0; t < spb; ++t) {
                        const int64_t pred =
                            ((a0 * q1) >> 12) + ((a1 * q2) >> 12);
                        int64_t d = (int64_t)blk[t] - pred;
                        d = d > 0 ? d + (eff >> 1) : d - (eff >> 1);
                        d = adx_tdiv(d, eff);
                        if (d < -limit - 1) d = -limit - 1;
                        if (d > limit) d = limit;
                        const int64_t sim = adx_clamp16(d * eff + pred);
                        q2 = q1;
                        q1 = sim;
                        cod[t] = (int32_t)d;
                    }
                } else {
                for (int32_t t = 0; t < spb; ++t) {
                    int64_t d = (((int64_t)blk[t] * 4096) - a0 * q1 - a1 * q2)
                                >> 12;
                    d = d > 0 ? d + (scale_eff >> 1) : d - (scale_eff >> 1);
                    d = adx_tdiv(d, scale_eff);
                    if (d < -limit - 1) d = -limit - 1;
                    if (d > limit) d = limit;
                    int64_t sim = (((d * 4096) * scale_eff) + a0 * q1
                                   + a1 * q2) >> 12;
                    sim = adx_clamp16(sim);
                    q2 = q1;
                    q1 = sim;
                    cod[t] = (int32_t)d;
                }
                }
                if (zero) {
                    for (int32_t t = 0; t < spb; ++t) cod[t] = 0;
                    scale_raw = 0;
                    h1 = blk[spb - 1];
                    h2 = spb >= 2 ? blk[spb - 2] : h1;
                } else {
                    h1 = q1;
                    h2 = q2;
                }
                scale_raw_out[(size_t)l * B + b] = (int32_t)scale_raw;
                zero_out[(size_t)l * B + b] = zero ? 1 : 0;
            }
        }
    };
    int nt = nthreads > 0 ? nthreads
                          : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > L) nt = L;
    if (nt <= 1) { run(0, L); return; }
    std::vector<std::thread> pool;
    int32_t per = (L + nt - 1) / nt;
    for (int i = 0; i < nt; ++i) {
        int32_t lo = i * per, hi = std::min(L, lo + per);
        if (lo >= hi) break;
        pool.emplace_back(run, lo, hi);
    }
    for (auto& th : pool) th.join();
}


// ---------------------------------------------------------------------------
// ADX full block paths: raw block stream <-> PCM16, entirely in C++.
//
// Single-file fast paths equivalent to (and verified against) the composition
// of the host demux in models/adx.py::_decode_arrays_host with the lane scans
// above — the dense-lane variants remain the kernel layout used by the
// batched device pipeline. Reference behaviour: adx.cpp:189-213 (decode),
// adx.cpp:215-273 + 416-506 (encode).
// ---------------------------------------------------------------------------

// payload: [nblocks, C, block_size]; out: interleaved PCM16 [nblocks*spb, C].
// mode 2 takes coefficients from static_coef[predictor*2(+1)] per block;
// modes 3/4 use the fixed (c0, c1). Threads split the channel axis (each
// channel's recurrence is serial over all blocks).
void cri_adx_decode_blocks(const uint8_t* payload, int32_t nblocks,
                           int32_t C, int32_t block_size, int32_t bit_depth,
                           int32_t mode, int32_t c0f, int32_t c1f,
                           const int32_t* static_coef, const int32_t* h1v,
                           const int32_t* h2v, int16_t* out,
                           int32_t nthreads) {
    const int32_t spb = (block_size - 2) * 8 / bit_depth;
    const int32_t signbit = 1 << (bit_depth - 1);
    const int32_t full = 1 << bit_depth;
    auto run = [&](int32_t c) {
        int64_t p1 = h1v[c], p2 = h2v[c];
        for (int32_t b = 0; b < nblocks; ++b) {
            const uint8_t* blk =
                payload + ((size_t)b * C + c) * block_size;
            const int32_t scale_raw = (blk[0] << 8) | blk[1];
            int64_t scale, a0, a1;
            if (mode == 4) {
                scale = (int64_t)1 << ((12 - scale_raw) & 31);
                a0 = c0f;
                a1 = c1f;
            } else if (mode == 2) {
                const int32_t predictor = scale_raw >> 13;
                scale = (scale_raw & 0x1FFF) + 1;
                a0 = static_coef[predictor * 2];
                a1 = static_coef[predictor * 2 + 1];
            } else {
                scale = scale_raw + 1;
                a0 = c0f;
                a1 = c1f;
            }
            // MSB-first fixed-width code extraction from blk[2..block_size)
            uint64_t acc = 0;
            int navail = 0;
            const uint8_t* p = blk + 2;
            int16_t* o = out + (size_t)b * spb * C + c;
            for (int32_t t = 0; t < spb; ++t) {
                while (navail < bit_depth) {
                    acc = (acc << 8) | *p++;
                    navail += 8;
                }
                int32_t q =
                    (int32_t)((acc >> (navail - bit_depth)) & (full - 1));
                navail -= bit_depth;
                if (q & signbit) q -= full;
                int64_t v = q * scale + ((a0 * p1) >> 12) + ((a1 * p2) >> 12);
                v = adx_clamp16(v);
                p2 = p1;
                p1 = v;
                *o = (int16_t)v;
                o += C;
            }
        }
    };
    if (C <= 1 || nthreads == 1) {
        for (int32_t c = 0; c < C; ++c) run(c);
        return;
    }
    std::vector<std::thread> pool;
    for (int32_t c = 0; c < C; ++c) pool.emplace_back(run, c);
    for (auto& th : pool) th.join();
}

// pcm: deinterleaved [C, nblocks*spb] int16 (already padded to whole blocks);
// payload out: [nblocks, C, block_size] raw block stream (scale field +
// MSB-first packed codes). mode 2 ORs (filter << 13) into non-zero scale
// fields. Threads split the channel axis.
void cri_adx_encode_blocks(const int16_t* pcm, int32_t nblocks, int32_t C,
                           int32_t block_size, int32_t bit_depth,
                           int32_t mode, int32_t filter, int32_t c0f,
                           int32_t c1f, const int32_t* h1v,
                           const int32_t* h2v, uint8_t* payload,
                           int32_t nthreads, int32_t scale_fix) {
    const int32_t spb = (block_size - 2) * 8 / bit_depth;
    const int64_t limit = ((int64_t)1 << (bit_depth - 1)) - 1;
    const int64_t a0 = c0f, a1 = c1f;
    // Channels are independent serial chains (decoder feedback through
    // q1/q2).  A RANGE of channels is encoded by one thread with the chains
    // INTERLEAVED in the sample loop: the OoO window overlaps their ~20-
    // cycle dependency chains for ~NCx single-core throughput.  On the
    // 1-core bench host this beats the old channel-per-thread split (which
    // only context-switched there); nthreads > 1 still splits channel
    // ranges across threads for multi-core hosts.
    auto run_group = [&](int32_t c_lo, int32_t c_hi) {
        // 8 interleaved chains already saturate the issue ports; wider
        // ranges run in slices
        constexpr int32_t MAXG = 8;
        std::vector<int32_t> codbuf((size_t)MAXG * spb);
        int32_t* cod = codbuf.data();
        for (int32_t g0 = c_lo; g0 < c_hi; g0 += MAXG) {
            const int32_t NC = std::min<int32_t>(MAXG, c_hi - g0);
            int64_t h1[MAXG], h2[MAXG];
            const int16_t* ch[MAXG];
            for (int32_t g = 0; g < NC; ++g) {
                h1[g] = h1v[g0 + g];
                h2[g] = h2v[g0 + g];
                ch[g] = pcm + (size_t)(g0 + g) * nblocks * spb;
            }
#if defined(__AVX2__)
            // Scale-search residuals for t >= 2 use only IN-BLOCK original
            // samples (t = 0,1 use the carried decoder state), so they
            // precompute channel-wide in one 8-lane pass:
            //   r[i] = (x[i]*4096 - a0*x[i-1] - a1*x[i-2]) >> 12.
            // int32 is exact: |x*4096| < 2^27, |a0*x| < 2^29 (|coef| <= 8192).
            std::vector<int32_t> resbuf;
            if (spb >= 2) {
                const int32_t n = nblocks * spb;
                resbuf.resize((size_t)NC * n);
                const __m256i va0 = _mm256_set1_epi32((int32_t)a0);
                const __m256i va1 = _mm256_set1_epi32((int32_t)a1);
                for (int32_t g = 0; g < NC; ++g) {
                    const int16_t* x = ch[g];
                    int32_t* rb = resbuf.data() + (size_t)g * n;
                    int32_t i = 2;
                    for (; i + 8 <= n; i += 8) {
                        __m256i xv = _mm256_cvtepi16_epi32(
                            _mm_loadu_si128((const __m128i*)(x + i)));
                        __m256i x1 = _mm256_cvtepi16_epi32(
                            _mm_loadu_si128((const __m128i*)(x + i - 1)));
                        __m256i x2 = _mm256_cvtepi16_epi32(
                            _mm_loadu_si128((const __m128i*)(x + i - 2)));
                        __m256i r = _mm256_sub_epi32(
                            _mm256_slli_epi32(xv, 12),
                            _mm256_add_epi32(_mm256_mullo_epi32(va0, x1),
                                             _mm256_mullo_epi32(va1, x2)));
                        _mm256_storeu_si256((__m256i*)(rb + i),
                                            _mm256_srai_epi32(r, 12));
                    }
                    for (; i < n; ++i)
                        rb[i] = (int32_t)((((int64_t)x[i] * 4096)
                            - a0 * x[i - 1] - a1 * x[i - 2]) >> 12);
                }
            }
#endif
            for (int32_t b = 0; b < nblocks; ++b) {
                int64_t qdiv[MAXG], se4096[MAXG], scale_raw[MAXG];
                uint64_t magic[MAXG];
                bool zero[MAXG];
                for (int32_t g = 0; g < NC; ++g) {
                    const int16_t* blk = ch[g] + (size_t)b * spb;
                    int64_t mn = 0, mx = 0;
#if defined(__AVX2__)
                    if (spb >= 2) {
                        int64_t p1 = h1[g], p2 = h2[g];
                        for (int32_t t = 0; t < 2; ++t) {
                            int64_t r = (((int64_t)blk[t] * 4096)
                                         - a0 * p1 - a1 * p2) >> 12;
                            if (r < mn) mn = r;
                            if (r > mx) mx = r;
                            p2 = p1;
                            p1 = blk[t];
                        }
                        const int32_t* rb = resbuf.data()
                            + ((size_t)g * nblocks + b) * spb;
                        int32_t t = 2;
                        __m256i vmn = _mm256_setzero_si256();
                        __m256i vmx = _mm256_setzero_si256();
                        for (; t + 8 <= spb; t += 8) {
                            __m256i r =
                                _mm256_loadu_si256((const __m256i*)(rb + t));
                            vmn = _mm256_min_epi32(vmn, r);
                            vmx = _mm256_max_epi32(vmx, r);
                        }
                        alignas(32) int32_t tmp[8];
                        _mm256_store_si256((__m256i*)tmp, vmn);
                        for (int k = 0; k < 8; ++k) if (tmp[k] < mn) mn = tmp[k];
                        _mm256_store_si256((__m256i*)tmp, vmx);
                        for (int k = 0; k < 8; ++k) if (tmp[k] > mx) mx = tmp[k];
                        for (; t < spb; ++t) {
                            const int32_t r = rb[t];
                            if (r < mn) mn = r;
                            if (r > mx) mx = r;
                        }
                    } else
#endif
                    {
                        int64_t p1 = h1[g], p2 = h2[g];
                        for (int32_t t = 0; t < spb; ++t) {
                            int64_t r = (((int64_t)blk[t] * 4096)
                                         - a0 * p1 - a1 * p2) >> 12;
                            if (r < mn) mn = r;
                            if (r > mx) mx = r;
                            p2 = p1;
                            p1 = blk[t];
                        }
                    }
                    zero[g] = (mn == 0 && mx == 0);
                    int64_t scale = std::max(adx_tdiv(mx, limit),
                                             adx_tdiv(mn, -(limit + 1)));
                    // the reference assigns to unsigned short BEFORE the
                    // 0x1000 cap (adx.cpp:236): residuals >= 65536*limit
                    // wrap mod 65536.  Found by the randomized differential
                    // campaign (96kHz clip content at bitdepth 2).
                    // scale_fix mode does NOT reproduce the wrap — a
                    // wrapped near-zero scale quantises the block into
                    // garbage.
                    if (!scale_fix) scale &= 0xFFFF;
                    if (scale > 0x1000) scale = 0x1000;
                    int64_t scale_eff;
                    if (mode == 4) {
                        int64_t power = 0;
                        if (scale >= 1) {
                            int64_t v = scale;
                            while (v > 1) { v >>= 1; ++power; }
                            ++power;
                        }
                        scale_eff = (int64_t)1 << power;
                        scale_raw[g] = 12 - power;
                    } else if (mode == 2) {
                        scale_raw[g] = scale & 0x1FFF;
                        scale_eff = scale;
                    } else {
                        scale_raw[g] = scale;
                        scale_eff = scale;
                    }
                    if (scale_eff < 1) scale_eff = 1;
                    // Exact truncating division by the per-block scale via
                    // a round-up magic reciprocal (Granlund-Montgomery):
                    // with mul = floor(2^42/s)+1 we have mul*s = 2^42 + e,
                    // 1 <= e <= s, so floor(n*mul/2^42) = floor(n/s +
                    // n*e/(s*2^42)) = floor(n/s) whenever n*e < 2^42.
                    // Operands here are bounded n < 2^18 (residual +
                    // rounding half) and s <= 0x1001+1, so n*e < 2^31 —
                    // exact with huge margin.  This removes the ~22 cycle
                    // idiv from the quantiser's serial decoder-feedback
                    // chain (the reference keeps it: adx.cpp:260
                    // `Delta /= Scale`).
                    qdiv[g] = scale_fix
                        ? (mode == 4 ? scale_eff : scale + 1) : scale_eff;
                    magic[g] = (((uint64_t)1 << 42) / (uint64_t)qdiv[g]) + 1;
                    se4096[g] = scale_eff * 4096;
                }
                // interleaved quantise: NC independent decoder-feedback
                // chains advance together, one sample per chain per pass
                int64_t q1[MAXG], q2[MAXG];
                for (int32_t g = 0; g < NC; ++g) {
                    q1[g] = h1[g];
                    q2[g] = h2[g];
                }
                if (scale_fix) {
                    // quantise against the DECODER's exact arithmetic.  The
                    // reference encoder divides by Scale while the decoder
                    // multiplies by Scale+1 (modes 2/3, adx.cpp:193-206 vs
                    // 254-266) and rounds the prediction terms differently
                    // — the source of its documented high-bitdepth popping
                    // (README.md:133).  Same bitstream format; any ADX
                    // decoder (the reference included) plays these files,
                    // just closer to the source.
                    for (int32_t t = 0; t < spb; ++t) {
                        for (int32_t g = 0; g < NC; ++g) {
                            const int64_t eff = qdiv[g];
                            const int64_t pred = ((a0 * q1[g]) >> 12)
                                + ((a1 * q2[g]) >> 12);
                            int64_t d = (int64_t)ch[g][(size_t)b * spb + t]
                                - pred;
                            d = d > 0 ? d + (eff >> 1) : d - (eff >> 1);
                            const uint64_t ad = (uint64_t)(d < 0 ? -d : d);
                            int64_t q = (int64_t)((ad * magic[g]) >> 42);
                            if (d < 0) q = -q;
                            if (q < -limit - 1) q = -limit - 1;
                            if (q > limit) q = limit;
                            const int64_t sim = adx_clamp16(q * eff + pred);
                            q2[g] = q1[g];
                            q1[g] = sim;
                            cod[g * spb + t] = (int32_t)q;
                        }
                    }
                } else {
                    for (int32_t t = 0; t < spb; ++t) {
                        for (int32_t g = 0; g < NC; ++g) {
                            const int64_t pr = a0 * q1[g] + a1 * q2[g];
                            int64_t d = (((int64_t)ch[g][(size_t)b * spb + t]
                                          * 4096) - pr) >> 12;
                            const int64_t half = qdiv[g] >> 1;
                            d = d > 0 ? d + half : d - half;
                            const uint64_t ad = (uint64_t)(d < 0 ? -d : d);
                            int64_t q = (int64_t)((ad * magic[g]) >> 42);
                            if (d < 0) q = -q;
                            if (q < -limit - 1) q = -limit - 1;
                            if (q > limit) q = limit;
                            int64_t sim = (q * se4096[g] + pr) >> 12;
                            sim = adx_clamp16(sim);
                            q2[g] = q1[g];
                            q1[g] = sim;
                            cod[g * spb + t] = (int32_t)q;
                        }
                    }
                }
                for (int32_t g = 0; g < NC; ++g) {
                    const int16_t* blk = ch[g] + (size_t)b * spb;
                    int32_t* cg = cod + g * spb;
                    int64_t field;
                    if (zero[g]) {
                        for (int32_t t = 0; t < spb; ++t) cg[t] = 0;
                        field = 0;
                        h1[g] = blk[spb - 1];
                        h2[g] = spb >= 2 ? blk[spb - 2] : h1[g];
                    } else {
                        field = mode == 2
                            ? ((int64_t)filter << 13) | (scale_raw[g] & 0x1FFF)
                            : (scale_raw[g] & 0xFFFF);
                        h1[g] = q1[g];
                        h2[g] = q2[g];
                    }
                    uint8_t* pb = payload
                        + ((size_t)b * C + (g0 + g)) * block_size;
                    pb[0] = (uint8_t)((field >> 8) & 0xFF);
                    pb[1] = (uint8_t)(field & 0xFF);
                    // MSB-first fixed-width packing into pb[2..block_size)
                    uint64_t acc = 0;
                    int nbits = 0;
                    uint8_t* w = pb + 2;
                    const uint32_t mask = (1u << bit_depth) - 1;
                    for (int32_t t = 0; t < spb; ++t) {
                        acc = (acc << bit_depth) | ((uint32_t)cg[t] & mask);
                        nbits += bit_depth;
                        while (nbits >= 8) {
                            *w++ = (uint8_t)((acc >> (nbits - 8)) & 0xFF);
                            nbits -= 8;
                        }
                    }
                    if (nbits > 0)
                        *w++ = (uint8_t)((acc << (8 - nbits)) & 0xFF);
                }
            }
        }
    };
    int32_t nt = nthreads;
    if (nt <= 0) nt = 1;   // default: one thread, chains interleaved
    if (nt > C) nt = C;
    if (nt == 1) {
        run_group(0, C);
        return;
    }
    std::vector<std::thread> pool;
    const int32_t per = (C + nt - 1) / nt;
    for (int32_t c = 0; c < C; c += per)
        pool.emplace_back(run_group, c, std::min(C, c + per));
    for (auto& th : pool) th.join();
}


// ---------------------------------------------------------------------------
// HCA single-stream decode transform (dequant -> noise -> HFR -> intensity
// stereo -> IMDCT -> windowed overlap-add -> PCM16).
//
// Host fast path for single files, numerically identical to the JAX kernel
// ops/hca_kernels.py::hca_decode_transform_batched (same fp32 op order,
// single-rounded mul/add — the build uses -ffp-contract=off so no FMA
// contraction; reference behaviour hca.cpp:1207-1233, 1906-1972). All tables
// are passed in from ops/hca_tables.py, keeping one source of truth.
// ---------------------------------------------------------------------------

static inline int16_t hca_pcm16(float v) {
    // matches jnp convert-to-int32-then-clip (saturating, truncate toward 0)
    const float sc = v * 32768.0f;
    if (sc >= 32767.0f) return 32767;
    if (sc <= -32768.0f) return -32768;
    if (sc != sc) return 0;  // NaN guard (unreachable on valid streams)
    return (int16_t)(int32_t)sc;
}

// ---------------------------------------------------------------------------
// Per-channel IMDCT (7+7 stage butterfly network) + window overlap-add,
// emitting PCM16 into a contiguous [8][128] buffer. All 8 subframes of the
// channel travel together: the arrays are [128 spectral lines][8 subframe
// lanes], so one line is exactly one 256-bit vector. GCC refuses to
// auto-vectorize these loops ("complicated access pattern"), hence the
// explicit AVX2 twin below — bit-exact with the scalar path (same fp32 ops
// in the same order; the reversal permutes don't touch arithmetic).
// ---------------------------------------------------------------------------
static void hca_imdct_ola_scalar(const float* spc /*[8][128]*/, float* carry,
                                 const float* sn7, const float* cs7,
                                 const float* win, int16_t* pcmch) {
    alignas(32) float va[128][8], vb[128][8];
    for (int k = 0; k < 128; ++k)
        for (int t = 0; t < 8; ++t)
            va[k][t] = spc[t * 128 + k];
    float (*x)[8] = va;
    float (*y)[8] = vb;
    // part 1: add/sub tree (count1 groups of count2 pairs)
    {
        int count1 = 1, count2 = 64;
        for (int st = 0; st < 7; ++st) {
            for (int g = 0; g < count1; ++g) {
                const int base_i = g * count2 * 2;
                for (int j = 0; j < count2; ++j) {
                    const float* a = x[base_i + 2 * j];
                    const float* b = x[base_i + 2 * j + 1];
                    float* yo1 = y[base_i + j];
                    float* yo2 = y[base_i + count2 + j];
                    for (int u = 0; u < 8; ++u) {
                        yo1[u] = a[u] + b[u];
                        yo2[u] = a[u] - b[u];
                    }
                }
            }
            std::swap(x, y);
            count1 <<= 1;
            count2 >>= 1;
        }
    }
    // part 2: twiddle stages
    {
        int count1 = 64, count2 = 1;
        for (int st = 0; st < 7; ++st) {
            const float* sn = sn7 + st * 64;
            const float* cs = cs7 + st * 64;
            for (int g = 0; g < count1; ++g) {
                const int base_i = g * 2 * count2;
                for (int j = 0; j < count2; ++j) {
                    const float* a = x[base_i + j];
                    const float* b = x[base_i + count2 + j];
                    const float w1 = sn[g * count2 + j];
                    const float w2 = cs[g * count2 + j];
                    float* yo1 = y[base_i + j];
                    float* yo2 = y[base_i + 2 * count2 - 1 - j];
                    for (int u = 0; u < 8; ++u) {
                        yo1[u] = a[u] * w1 - b[u] * w2;
                        yo2[u] = a[u] * w2 + b[u] * w1;
                    }
                }
            }
            std::swap(x, y);
            count1 >>= 1;
            count2 <<= 1;
        }
    }
    // overlap-add: wave[k]    = w[k]*dct[64+k]    + prev[k]
    //              wave[64+k] = w[64+k]*dct[127-k] - prev[64+k]
    // where prev[k] = w[127-k]*pdct[63-k], prev[64+k] = w[63-k]*pdct[k]
    for (int t = 0; t < 8; ++t) {
        int16_t* o = pcmch + (size_t)t * 128;
        if (t == 0) {
            for (int k = 0; k < 64; ++k)
                o[k] = hca_pcm16(win[k] * x[64 + k][0]
                                 + win[127 - k] * carry[63 - k]);
            for (int k = 0; k < 64; ++k)
                o[64 + k] = hca_pcm16(win[64 + k] * x[127 - k][0]
                                      - win[63 - k] * carry[k]);
        } else {
            for (int k = 0; k < 64; ++k)
                o[k] = hca_pcm16(win[k] * x[64 + k][t]
                                 + win[127 - k] * x[63 - k][t - 1]);
            for (int k = 0; k < 64; ++k)
                o[64 + k] = hca_pcm16(win[64 + k] * x[127 - k][t]
                                      - win[63 - k] * x[k][t - 1]);
        }
    }
    for (int k = 0; k < 128; ++k) carry[k] = x[k][7];
}

#if defined(__AVX2__)
static inline __m256 hca_rev8(__m256 v) {
    const __m256i idx = _mm256_setr_epi32(7, 6, 5, 4, 3, 2, 1, 0);
    return _mm256_permutevar8x32_ps(v, idx);
}

// 16 floats (already scaled by 32768) -> 16 int16, matching hca_pcm16 lanewise
// (>=32767 -> 32767, <=-32768 -> -32768, NaN -> 0, else truncate toward 0).
static inline __m256i hca_clamp16x16(__m256 s0, __m256 s1) {
    const __m256 hi = _mm256_set1_ps(32767.0f);
    const __m256 lo = _mm256_set1_ps(-32768.0f);
    __m256i r[2];
    __m256 s[2] = {s0, s1};
    for (int i = 0; i < 2; ++i) {
        __m256 ge = _mm256_cmp_ps(s[i], hi, _CMP_GE_OQ);
        __m256 le = _mm256_cmp_ps(s[i], lo, _CMP_LE_OQ);
        __m256 un = _mm256_cmp_ps(s[i], s[i], _CMP_UNORD_Q);
        __m256i t = _mm256_cvttps_epi32(s[i]);
        t = _mm256_blendv_epi8(t, _mm256_set1_epi32(32767),
                               _mm256_castps_si256(ge));
        t = _mm256_blendv_epi8(t, _mm256_set1_epi32(-32768),
                               _mm256_castps_si256(le));
        t = _mm256_andnot_si256(_mm256_castps_si256(un), t);
        r[i] = t;
    }
    __m256i p = _mm256_packs_epi32(r[0], r[1]);
    return _mm256_permute4x64_epi64(p, _MM_SHUFFLE(3, 1, 2, 0));
}

static void hca_imdct_ola_avx2(const float* spc, float* carry,
                               const float* sn7, const float* cs7,
                               const float* win, const float* winr,
                               int16_t* pcmch) {
    alignas(32) float va[128][8], vb[128][8];
    for (int k = 0; k < 128; ++k)
        for (int t = 0; t < 8; ++t)
            va[k][t] = spc[t * 128 + k];
    float (*x)[8] = va;
    float (*y)[8] = vb;
    {
        int count1 = 1, count2 = 64;
        for (int st = 0; st < 7; ++st) {
            for (int g = 0; g < count1; ++g) {
                const int base_i = g * count2 * 2;
                for (int j = 0; j < count2; ++j) {
                    __m256 a = _mm256_load_ps(x[base_i + 2 * j]);
                    __m256 b = _mm256_load_ps(x[base_i + 2 * j + 1]);
                    _mm256_store_ps(y[base_i + j], _mm256_add_ps(a, b));
                    _mm256_store_ps(y[base_i + count2 + j],
                                    _mm256_sub_ps(a, b));
                }
            }
            std::swap(x, y);
            count1 <<= 1;
            count2 >>= 1;
        }
    }
    {
        int count1 = 64, count2 = 1;
        for (int st = 0; st < 7; ++st) {
            const float* sn = sn7 + st * 64;
            const float* cs = cs7 + st * 64;
            for (int g = 0; g < count1; ++g) {
                const int base_i = g * 2 * count2;
                for (int j = 0; j < count2; ++j) {
                    __m256 a = _mm256_load_ps(x[base_i + j]);
                    __m256 b = _mm256_load_ps(x[base_i + count2 + j]);
                    __m256 w1 = _mm256_set1_ps(sn[g * count2 + j]);
                    __m256 w2 = _mm256_set1_ps(cs[g * count2 + j]);
                    _mm256_store_ps(y[base_i + j],
                        _mm256_sub_ps(_mm256_mul_ps(a, w1),
                                      _mm256_mul_ps(b, w2)));
                    _mm256_store_ps(y[base_i + 2 * count2 - 1 - j],
                        _mm256_add_ps(_mm256_mul_ps(a, w2),
                                      _mm256_mul_ps(b, w1)));
                }
            }
            std::swap(x, y);
            count1 >>= 1;
            count2 <<= 1;
        }
    }
    // transpose [128][8] -> [8][128] in 8x8 blocks
    alignas(32) float dct[8][128];
    for (int k = 0; k < 128; k += 8) {
        __m256 r0 = _mm256_load_ps(x[k + 0]), r1 = _mm256_load_ps(x[k + 1]),
               r2 = _mm256_load_ps(x[k + 2]), r3 = _mm256_load_ps(x[k + 3]),
               r4 = _mm256_load_ps(x[k + 4]), r5 = _mm256_load_ps(x[k + 5]),
               r6 = _mm256_load_ps(x[k + 6]), r7 = _mm256_load_ps(x[k + 7]);
        __m256 t0 = _mm256_unpacklo_ps(r0, r1), t1 = _mm256_unpackhi_ps(r0, r1),
               t2 = _mm256_unpacklo_ps(r2, r3), t3 = _mm256_unpackhi_ps(r2, r3),
               t4 = _mm256_unpacklo_ps(r4, r5), t5 = _mm256_unpackhi_ps(r4, r5),
               t6 = _mm256_unpacklo_ps(r6, r7), t7 = _mm256_unpackhi_ps(r6, r7);
        __m256 s0 = _mm256_shuffle_ps(t0, t2, _MM_SHUFFLE(1, 0, 1, 0)),
               s1 = _mm256_shuffle_ps(t0, t2, _MM_SHUFFLE(3, 2, 3, 2)),
               s2 = _mm256_shuffle_ps(t1, t3, _MM_SHUFFLE(1, 0, 1, 0)),
               s3 = _mm256_shuffle_ps(t1, t3, _MM_SHUFFLE(3, 2, 3, 2)),
               s4 = _mm256_shuffle_ps(t4, t6, _MM_SHUFFLE(1, 0, 1, 0)),
               s5 = _mm256_shuffle_ps(t4, t6, _MM_SHUFFLE(3, 2, 3, 2)),
               s6 = _mm256_shuffle_ps(t5, t7, _MM_SHUFFLE(1, 0, 1, 0)),
               s7 = _mm256_shuffle_ps(t5, t7, _MM_SHUFFLE(3, 2, 3, 2));
        _mm256_store_ps(&dct[0][k], _mm256_permute2f128_ps(s0, s4, 0x20));
        _mm256_store_ps(&dct[1][k], _mm256_permute2f128_ps(s1, s5, 0x20));
        _mm256_store_ps(&dct[2][k], _mm256_permute2f128_ps(s2, s6, 0x20));
        _mm256_store_ps(&dct[3][k], _mm256_permute2f128_ps(s3, s7, 0x20));
        _mm256_store_ps(&dct[4][k], _mm256_permute2f128_ps(s0, s4, 0x31));
        _mm256_store_ps(&dct[5][k], _mm256_permute2f128_ps(s1, s5, 0x31));
        _mm256_store_ps(&dct[6][k], _mm256_permute2f128_ps(s2, s6, 0x31));
        _mm256_store_ps(&dct[7][k], _mm256_permute2f128_ps(s3, s7, 0x31));
    }
    // OLA on unit-stride rows: the reversed-index operands become reversed
    // copies (prerev[k] = pre[127-k]); each subframe's reversed row is the
    // next subframe's prerev
    alignas(32) float prerev[128], currev[128];
    for (int k = 0; k < 128; k += 8)
        _mm256_store_ps(prerev + k, hca_rev8(_mm256_loadu_ps(carry + 120 - k)));
    const float* pre = carry;
    const __m256 k32768 = _mm256_set1_ps(32768.0f);
    for (int t = 0; t < 8; ++t) {
        const float* cur = dct[t];
        for (int k = 0; k < 128; k += 8)
            _mm256_store_ps(currev + k,
                            hca_rev8(_mm256_loadu_ps(cur + 120 - k)));
        int16_t* o = pcmch + (size_t)t * 128;
        // win comes from numpy and pre may be the caller's carry vector:
        // neither is 32-byte aligned, so those loads must be loadu
        // (_mm256_load_ps on them is UB that only works while the compiler
        // folds the load into an alignment-tolerant memory operand)
        // o[k] = clamp((win[k]*cur[64+k] + win[127-k]*pre[63-k]) * 32768)
        for (int k = 0; k < 64; k += 16) {
            __m256 v0 = _mm256_add_ps(
                _mm256_mul_ps(_mm256_loadu_ps(win + k),
                              _mm256_load_ps(cur + 64 + k)),
                _mm256_mul_ps(_mm256_load_ps(winr + k),
                              _mm256_load_ps(prerev + 64 + k)));
            __m256 v1 = _mm256_add_ps(
                _mm256_mul_ps(_mm256_loadu_ps(win + k + 8),
                              _mm256_load_ps(cur + 72 + k)),
                _mm256_mul_ps(_mm256_load_ps(winr + k + 8),
                              _mm256_load_ps(prerev + 72 + k)));
            _mm256_storeu_si256((__m256i*)(o + k),
                hca_clamp16x16(_mm256_mul_ps(v0, k32768),
                               _mm256_mul_ps(v1, k32768)));
        }
        // o[64+k] = clamp((win[64+k]*cur[127-k] - win[63-k]*pre[k]) * 32768)
        for (int k = 0; k < 64; k += 16) {
            __m256 v0 = _mm256_sub_ps(
                _mm256_mul_ps(_mm256_loadu_ps(win + 64 + k),
                              _mm256_load_ps(currev + k)),
                _mm256_mul_ps(_mm256_load_ps(winr + 64 + k),
                              _mm256_loadu_ps(pre + k)));
            __m256 v1 = _mm256_sub_ps(
                _mm256_mul_ps(_mm256_loadu_ps(win + 72 + k),
                              _mm256_load_ps(currev + k + 8)),
                _mm256_mul_ps(_mm256_load_ps(winr + 72 + k),
                              _mm256_loadu_ps(pre + k + 8)));
            _mm256_storeu_si256((__m256i*)(o + 64 + k),
                hca_clamp16x16(_mm256_mul_ps(v0, k32768),
                               _mm256_mul_ps(v1, k32768)));
        }
        pre = cur;
        std::memcpy(prerev, currev, sizeof(currev));
    }
    std::memcpy(carry, dct[7], 128 * sizeof(float));
}
#endif  // __AVX2__

void cri_hca_decode_transform(
    const int16_t* qc,          // [F, C, 8, 128]
    const uint8_t* sf,          // [F, C, 128]
    const uint8_t* res,         // [F, C, 128]
    const uint8_t* inten,       // [F, C, 8]
    const int32_t* noise_src,   // [F, C, 8, 128] (apply_noise only)
    const uint8_t* noise_sci,   // [F, C, 8, 128]
    const uint8_t* noise_mask,  // [F, C, 8, 128]
    int32_t F, int32_t C, int32_t base_band, int32_t total_band,
    const int32_t* pairs, int32_t npairs,  // (primary, secondary) pairs
    int32_t apply_noise, int32_t apply_hfr, int32_t hfr_group_count,
    const uint8_t* hfr_is, const int32_t* hfr_src, const int32_t* hfr_group,
    int32_t hfr_zero,
    const float* scaling64, const float* range16, const float* conv128,
    const float* iratio16, const float* imdct_sin, const float* imdct_cos,
    const float* window128,
    int16_t* out) {             // [F, 8, 128, C] interleaved
    std::vector<uint8_t> is_secondary(C, 0);
    for (int32_t i = 0; i < npairs; ++i) is_secondary[pairs[2 * i + 1]] = 1;

    // per-channel spectra for the current frame + per-channel OLA carry
    std::vector<float> spec((size_t)C * 8 * 128);
    std::vector<float> base(128);
    std::vector<float> prev_dct((size_t)C * 128, 0.0f);
    alignas(32) float winr[128];
    for (int k = 0; k < 128; ++k) winr[k] = window128[127 - k];
    (void)winr;

    for (int32_t f = 0; f < F; ++f) {
        // --- per-channel dequant + noise + HFR -------------------------
        for (int32_t c = 0; c < C; ++c) {
            const size_t fc = (size_t)f * C + c;
            const uint8_t* sfr = sf + fc * 128;
            const uint8_t* rsr = res + fc * 128;
            float gain[128];
            for (int k = 0; k < 128; ++k)
                gain[k] = scaling64[sfr[k]] * range16[rsr[k]];
            for (int32_t t = 0; t < 8; ++t) {
                float* sp = spec.data() + ((size_t)c * 8 + t) * 128;
                const int16_t* q = qc + (fc * 8 + t) * 128;
                for (int k = 0; k < 128; ++k)
                    sp[k] = gain[k] * (float)q[k];
                if (apply_noise) {
                    const size_t off = (fc * 8 + t) * 128;
                    std::memcpy(base.data(), sp, 128 * sizeof(float));
                    for (int k = 0; k < 128; ++k)
                        if (noise_mask[off + k])
                            sp[k] = conv128[noise_sci[off + k]]
                                    * base[noise_src[off + k]];
                }
                if (apply_hfr && !is_secondary[c]) {
                    for (int k = 0; k < 128; ++k) {
                        if (hfr_is[k]) {
                            const int32_t g = hfr_group[k];
                            const int32_t gsc =
                                sfr[128 - hfr_group_count + g];
                            int32_t sci = gsc - (int32_t)sfr[hfr_src[k]] + 63;
                            if (sci < 0) sci = 0;
                            sp[k] = conv128[sci] * sp[hfr_src[k]];
                        }
                    }
                    if (hfr_zero >= 0 && hfr_zero < 128) sp[hfr_zero] = 0.0f;
                }
            }
        }
        // --- intensity stereo -------------------------------------------
        for (int32_t i = 0; i < npairs; ++i) {
            const int32_t pch = pairs[2 * i], sch = pairs[2 * i + 1];
            for (int32_t t = 0; t < 8; ++t) {
                const float rl =
                    iratio16[inten[((size_t)f * C + sch) * 8 + t]];
                const float rr = 2.0f - rl;
                float* lp = spec.data() + ((size_t)pch * 8 + t) * 128;
                float* rp = spec.data() + ((size_t)sch * 8 + t) * 128;
                for (int k = base_band; k < total_band; ++k) {
                    const float l = lp[k];
                    lp[k] = l * rl;
                    rp[k] = l * rr;
                }
            }
        }
        // --- IMDCT + overlap-add + PCM16 --------------------------------
        // Per-channel helper emits contiguous [8][128] PCM; interleave into
        // the [F, 8, 128, C] output afterwards (unit-stride stores in the
        // hot loops instead of stride-C scatter).
        for (int32_t c = 0; c < C; ++c) {
            float* carry = prev_dct.data() + (size_t)c * 128;
            const float* spc = spec.data() + (size_t)c * 8 * 128;
            alignas(32) int16_t pcmch[8 * 128];
#if defined(__AVX2__)
            hca_imdct_ola_avx2(spc, carry, imdct_sin, imdct_cos, window128,
                               winr, pcmch);
#else
            hca_imdct_ola_scalar(spc, carry, imdct_sin, imdct_cos, window128,
                                 pcmch);
#endif
            int16_t* o = out + ((size_t)f * 8 * 128) * C + c;
            if (C == 1) {
                std::memcpy(o, pcmch, sizeof(pcmch));
            } else {
                for (int i = 0; i < 8 * 128; ++i)
                    o[(size_t)i * C] = pcmch[i];
            }
        }
    }
}


// ---------------------------------------------------------------------------
// HCA encoder rate-control searches (BinarySearchLevel / BinarySearchBoundary
// + the top-band-zeroing fallback), per frame, threaded across frames.
//
// Mirrors ops/hca_encode_host.py::calc_used_bits / binary_search_level /
// binary_search_boundary / calc_delta_lengths exactly (reference behaviour
// hca.cpp:2708-2866). The numpy implementations re-evaluate every frame on
// every bisection step; here each frame runs its own search to convergence.
// ---------------------------------------------------------------------------

namespace hcaenc {

struct Tables {
    const uint8_t* curve;      // SCALE_TO_RESOLUTION_CURVE [59]
    const uint8_t* max_bits;   // QUANTIZED_SPECTRUM_MAX_BITS [16]
    const float* dead_zone;    // QUANTIZER_DEAD_ZONE [16]
    const float* inv_step;     // QUANTIZER_INVERSE_STEP_SIZE [16]
    const uint8_t* qbits;      // QUANTIZE_SPECTRUM_BITS [8][16]
};

static inline int32_t resolution_enc(int64_t sfv, int64_t noise,
                                     const uint8_t* curve) {
    if (sfv == 0) return 0;
    int64_t c = noise - (5 * sfv) / 2 + 2;
    if (c < 0) c = 0;
    if (c > 58) c = 58;
    return curve[c];
}

// Per-band bit cost for every possible resolution 0..15 (the only input the
// spectra contribute to CalculateUsedBits, hca.cpp:2763-2790). Precomputed
// once per frame so each bisection step is a table walk. Output layout is
// uint8 [C, 16 resolutions, 128 bands] (every value fits: res<8 cost is at
// most 8*4 bits, res>=8 is 8*(max_bits-1)+popcount <= 96) so the AVX2 twin
// can produce 32 bands per vector. Reads the subframe-major spectra
// directly ([C, 8, 128]).
static void band_costs(const float* scf,  // [C, 8, 128]
                       int32_t C, const Tables& tb,
                       uint8_t* cost) {    // [C, 16, 128]
#if defined(__AVX2__)
    const __m256i perm = _mm256_setr_epi32(0, 4, 1, 5, 2, 6, 3, 7);
    const __m256i k15 = _mm256_set1_epi32(15);
    const __m256 sgnmask = _mm256_castsi256_ps(_mm256_set1_epi32(0x7FFFFFFF));
    for (int32_t c = 0; c < C; ++c) {
        const float* scfc = scf + (size_t)c * 8 * 128;
        uint8_t* costc = cost + (size_t)c * 16 * 128;
        for (int32_t res = 0; res < 8; ++res) {
            const float ssi = tb.inv_step[res];
            const __m256 vssi = _mm256_set1_ps(ssi);
            const __m256 vup = _mm256_set1_ps(ssi + 1.0f);
            const __m256i vdown = _mm256_set1_epi32(
                (int32_t)(int64_t)std::trunc((double)ssi + 0.5 - 8.0));
            __m128i lut128 =
                _mm_loadu_si128((const __m128i*)(tb.qbits + (size_t)res * 16));
            __m256i lut = _mm256_broadcastsi128_si256(lut128);
            uint8_t* out = costc + (size_t)res * 128;
            for (int k0 = 0; k0 < 128; k0 += 32) {
                __m256i acc = _mm256_setzero_si256();
                for (int t = 0; t < 8; ++t) {
                    const float* base = scfc + (size_t)t * 128 + k0;
                    __m256i q0 = _mm256_cvttps_epi32(_mm256_add_ps(
                        _mm256_mul_ps(_mm256_loadu_ps(base + 0), vssi), vup));
                    __m256i q1 = _mm256_cvttps_epi32(_mm256_add_ps(
                        _mm256_mul_ps(_mm256_loadu_ps(base + 8), vssi), vup));
                    __m256i q2 = _mm256_cvttps_epi32(_mm256_add_ps(
                        _mm256_mul_ps(_mm256_loadu_ps(base + 16), vssi), vup));
                    __m256i q3 = _mm256_cvttps_epi32(_mm256_add_ps(
                        _mm256_mul_ps(_mm256_loadu_ps(base + 24), vssi), vup));
                    q0 = _mm256_sub_epi32(q0, vdown);
                    q1 = _mm256_sub_epi32(q1, vdown);
                    q2 = _mm256_sub_epi32(q2, vdown);
                    q3 = _mm256_sub_epi32(q3, vdown);
                    const __m256i z0 = _mm256_setzero_si256();
                    q0 = _mm256_min_epi32(_mm256_max_epi32(q0, z0), k15);
                    q1 = _mm256_min_epi32(_mm256_max_epi32(q1, z0), k15);
                    q2 = _mm256_min_epi32(_mm256_max_epi32(q2, z0), k15);
                    q3 = _mm256_min_epi32(_mm256_max_epi32(q3, z0), k15);
                    __m256i x = _mm256_packus_epi32(q0, q1);
                    __m256i y = _mm256_packus_epi32(q2, q3);
                    __m256i z = _mm256_packus_epi16(x, y);
                    z = _mm256_permutevar8x32_epi32(z, perm);
                    acc = _mm256_add_epi8(acc, _mm256_shuffle_epi8(lut, z));
                }
                _mm256_storeu_si256((__m256i*)(out + k0), acc);
            }
        }
        for (int32_t res = 8; res < 16; ++res) {
            const __m256 vdz = _mm256_set1_ps(tb.dead_zone[res]);
            const int32_t base_v = 8 * ((int32_t)tb.max_bits[res] - 1);
            uint8_t* out = costc + (size_t)res * 128;
            for (int k0 = 0; k0 < 128; k0 += 32) {
                __m256i e0 = _mm256_setzero_si256(), e1 = e0, e2 = e0, e3 = e0;
                for (int t = 0; t < 8; ++t) {
                    const float* base = scfc + (size_t)t * 128 + k0;
                    __m256 a0 = _mm256_and_ps(_mm256_loadu_ps(base + 0),
                                              sgnmask);
                    __m256 a1 = _mm256_and_ps(_mm256_loadu_ps(base + 8),
                                              sgnmask);
                    __m256 a2 = _mm256_and_ps(_mm256_loadu_ps(base + 16),
                                              sgnmask);
                    __m256 a3 = _mm256_and_ps(_mm256_loadu_ps(base + 24),
                                              sgnmask);
                    e0 = _mm256_sub_epi32(e0, _mm256_castps_si256(
                        _mm256_cmp_ps(a0, vdz, _CMP_GE_OQ)));
                    e1 = _mm256_sub_epi32(e1, _mm256_castps_si256(
                        _mm256_cmp_ps(a1, vdz, _CMP_GE_OQ)));
                    e2 = _mm256_sub_epi32(e2, _mm256_castps_si256(
                        _mm256_cmp_ps(a2, vdz, _CMP_GE_OQ)));
                    e3 = _mm256_sub_epi32(e3, _mm256_castps_si256(
                        _mm256_cmp_ps(a3, vdz, _CMP_GE_OQ)));
                }
                __m256i vb = _mm256_set1_epi32(base_v);
                e0 = _mm256_add_epi32(e0, vb);
                e1 = _mm256_add_epi32(e1, vb);
                e2 = _mm256_add_epi32(e2, vb);
                e3 = _mm256_add_epi32(e3, vb);
                __m256i x = _mm256_packus_epi32(e0, e1);
                __m256i y = _mm256_packus_epi32(e2, e3);
                __m256i z = _mm256_packus_epi16(x, y);
                z = _mm256_permutevar8x32_epi32(z, perm);
                _mm256_storeu_si256((__m256i*)(out + k0), z);
            }
        }
    }
#else
    for (int32_t c = 0; c < C; ++c) {
        const float* scfc = scf + (size_t)c * 8 * 128;
        uint8_t* costc = cost + (size_t)c * 16 * 128;
        for (int32_t k = 0; k < 128; ++k) {
            for (int32_t res = 0; res < 8; ++res) {
                const float ssi = tb.inv_step[res];
                const float shift_up = ssi + 1.0f;
                const int64_t shift_down =
                    (int64_t)std::trunc((double)ssi + 0.5 - 8.0);
                const uint8_t* qb = tb.qbits + (size_t)res * 16;
                int32_t bits = 0;
                for (int32_t t = 0; t < 8; ++t) {
                    int64_t q = (int64_t)std::truncf(
                        scfc[(size_t)t * 128 + k] * ssi + shift_up)
                        - shift_down;
                    if (q < 0) q = 0;
                    if (q > 15) q = 15;
                    bits += qb[q];
                }
                costc[(size_t)res * 128 + k] = (uint8_t)bits;
            }
            for (int32_t res = 8; res < 16; ++res) {
                const float dz = tb.dead_zone[res];
                int32_t extra = 0;
                for (int32_t t = 0; t < 8; ++t)
                    extra += std::fabs(scfc[(size_t)t * 128 + k]) >= dz;
                costc[(size_t)res * 128 + k] =
                    (uint8_t)(8 * ((int32_t)tb.max_bits[res] - 1) + extra);
            }
        }
    }
#endif
}

// CalculateOptimalDeltaLength + header length for one frame/channel
// (hca.cpp:2708-2750; mirrors calc_delta_lengths).
static void delta_length(const int32_t* sfc, int32_t cc, int32_t chan_type,
                         int32_t hfr_group_count, int32_t stereo_secondary,
                         int32_t* delta_bits_out, int32_t* header_len_out) {
    bool empty = true;
    for (int32_t k = 0; k < cc; ++k)
        if (sfc[k] != 0) { empty = false; break; }
    if (empty) {
        *delta_bits_out = 0;
        int64_t hl = 3;
        if (chan_type == stereo_secondary) hl += 32;
        else if (hfr_group_count > 0) hl += 6 * hfr_group_count;
        *header_len_out = (int32_t)hl;
        return;
    }
    int64_t min_len = 3 + 6 * (int64_t)cc;
    int64_t min_bits = 6;
    for (int64_t db = 1; db < 6; ++db) {
        const int64_t max_delta = ((int64_t)1 << (db - 1)) - 1;
        int64_t length = 3 + 6;
        for (int32_t k = 1; k < cc; ++k) {
            const int64_t d = std::llabs((int64_t)sfc[k] - sfc[k - 1]);
            length += d > max_delta ? db + 6 : db;
        }
        if (length < min_len) { min_len = length; min_bits = db; }
    }
    int64_t hl = min_len;
    if (chan_type == stereo_secondary) hl += 32;
    else if (hfr_group_count > 0) hl += 6 * hfr_group_count;
    *delta_bits_out = (int32_t)min_bits;
    *header_len_out = (int32_t)hl;
}

}  // namespace hcaenc

// Runs the per-frame rate-control: level search, top-band-zeroing fallback
// (mutates sf/delta_bits/header_len), and boundary search. Returns 0, or -1
// if any frame cannot fit (parity: "Unknown Encoding error").
int32_t cri_hca_search_levels(
    int32_t* sf,                // [F, C, 128] (mutated by fallback)
    const float* scaled,        // [F, C, 8, 128]
    int32_t* delta_bits,        // [F, C] (mutated by fallback)
    int32_t* header_len,        // [F, C] (mutated by fallback)
    int32_t F, int32_t C, int64_t avail,
    const int32_t* coded_count, const uint8_t* channel_type,
    int32_t stereo_secondary_tag, int32_t hfr_group_count,
    int32_t base_band, int32_t stereo_band,
    const uint8_t* curve, const uint8_t* max_bits, const float* dead_zone,
    const float* inv_step, const uint8_t* qbits,
    int32_t* level_out, int32_t* boundary_out, int32_t nthreads) {
    hcaenc::Tables tb{curve, max_bits, dead_zone, inv_step, qbits};
    std::vector<int32_t> rc(F, 0);
    auto run = [&](int32_t lo_f, int32_t hi_f) {
        std::vector<uint8_t> costs((size_t)C * 16 * 128);
        for (int32_t f = lo_f; f < hi_f; ++f) {
            int32_t* sff = sf + (size_t)f * C * 128;
            const float* scf_raw = scaled + (size_t)f * C * 8 * 128;
            hcaenc::band_costs(scf_raw, C, tb, costs.data());
            const uint8_t* scf = costs.data();
            int32_t* hlf = header_len + (size_t)f * C;
            int32_t* dbf = delta_bits + (size_t)f * C;
            // --- scalefactor-bucketed cost sums -------------------------
            // used_bits at eval_boundary 0 only depends on each band's
            // scalefactor VALUE (resolution = curve[level - (5*sf)/2 + 2]),
            // so fold the per-band cost rows into 63 buckets once per
            // frame: every bisection step becomes a 63-entry walk instead
            // of a full 128*C-band re-evaluation. Integer sums reassociate
            // exactly, so this is bit-identical to CalculateUsedBits
            // (hca.cpp:2763-2790; pinned against the numpy mirror by
            // test_native_rate_control_fallback_matches_numpy).
            int32_t bucket[64][16];
            int64_t level_const = 0;
            uint8_t present[64];
            int32_t npresent = 0;
            auto rebuild_buckets = [&]() {
                std::memset(bucket, 0, sizeof(bucket));
                level_const = 16 + 16 + 16;
                bool occupied[64] = {false};
                for (int32_t c = 0; c < C; ++c) {
                    level_const += hlf[c];
                    const int32_t cc = coded_count[c];
                    const int32_t* sfc = sff + (size_t)c * 128;
                    const uint8_t* cstc = scf + (size_t)c * 16 * 128;
                    for (int32_t k = 0; k < cc; ++k) {
                        const int32_t v = sfc[k];
                        if (v == 0) {
                            level_const += cstc[k];  // resolution 0 row
                        } else {
                            occupied[v] = true;
                            for (int32_t r = 0; r < 16; ++r)
                                bucket[v][r] += cstc[(size_t)r * 128 + k];
                        }
                    }
                }
                npresent = 0;
                for (int32_t v = 1; v < 64; ++v)
                    if (occupied[v]) present[npresent++] = (uint8_t)v;
            };
            rebuild_buckets();
            auto used_bits_level = [&](int64_t noise) -> int64_t {
                int64_t length = level_const;
                for (int32_t i = 0; i < npresent; ++i) {
                    const int32_t v = present[i];
                    int64_t cpos = noise - (5 * (int64_t)v) / 2 + 2;
                    if (cpos < 0) cpos = 0;
                    if (cpos > 58) cpos = 58;
                    length += bucket[v][tb.curve[cpos]];
                }
                return length;
            };
            // --- BinarySearchLevel (hca.cpp:2792-2807) ------------------
            auto search_level = [&]() -> int32_t {
                int64_t low = 0, high = 255, mid_value = 0;
                while (low != high) {
                    const int64_t mid = (low + high) / 2;
                    mid_value = used_bits_level(mid);
                    if (mid_value > avail) low = mid + 1;
                    else high = mid;
                }
                if (low == 255 && mid_value > avail) return -1;
                return (int32_t)low;
            };
            int32_t level = search_level();
            // --- fallback: zero top bands until it fits (2816-2828) -----
            if (level < 0) {
                int32_t highest = base_band + stereo_band - 1;
                while (level < 0) {
                    highest -= 2;
                    if (highest < 0) { rc[f] = -1; break; }
                    for (int32_t c = 0; c < C; ++c) {
                        sff[c * 128 + highest + 1] = 0;
                        sff[c * 128 + highest + 2] = 0;
                        hcaenc::delta_length(
                            sff + (size_t)c * 128, coded_count[c],
                            channel_type[c], hfr_group_count,
                            stereo_secondary_tag, dbf + c, hlf + c);
                    }
                    rebuild_buckets();  // sff and header lengths changed
                    level = search_level();
                }
                if (rc[f] != 0) continue;
            }
            level_out[f] = level;
            // --- BinarySearchBoundary (hca.cpp:2834-2850) ---------------
            // used_bits(level, eb) differs from used_bits(level, 0) only by
            // the bands below eb evaluating at noise level-1: precompute the
            // per-band cost delta once and prefix-sum it, making each
            // bisection step O(1). Integer sums — bit-identical.
            int32_t boundary = 0;
            if (level != 0) {
                const int64_t f_level = used_bits_level(level);
                int64_t P[129];
                P[0] = 0;
                for (int32_t e = 1; e <= 128; ++e) {
                    const int32_t k = e - 1;
                    int64_t d = 0;
                    for (int32_t c = 0; c < C; ++c) {
                        if (k >= coded_count[c]) continue;
                        const int32_t v = sff[(size_t)c * 128 + k];
                        if (v == 0) continue;  // resolution 0 at any noise
                        const uint8_t* cstc = scf + (size_t)c * 16 * 128;
                        const int32_t r_lo = hcaenc::resolution_enc(
                            v, (int64_t)level - 1, tb.curve);
                        const int32_t r_hi = hcaenc::resolution_enc(
                            v, (int64_t)level, tb.curve);
                        d += (int64_t)cstc[(size_t)r_lo * 128 + k]
                             - cstc[(size_t)r_hi * 128 + k];
                    }
                    P[e] = P[e - 1] + d;
                }
                auto used_at = [&](int64_t eb) -> int64_t {
                    return f_level + (eb > 0 ? P[eb] : 0);
                };
                int64_t low = 0, high = 127;
                while (std::llabs(high - low) > 1) {
                    const int64_t mid = (low + high) / 2;
                    const int64_t mv = used_at(mid);
                    if (avail < mv) high = mid - 1;
                    else low = mid;
                }
                if (low == high) {
                    boundary = low < 127 ? (int32_t)low : -1;
                } else {
                    const int64_t hi_val = used_at(high);
                    boundary = (int32_t)(hi_val > avail ? low : high);
                }
                if (boundary < 0) { rc[f] = -1; continue; }
            }
            boundary_out[f] = boundary;
        }
    };
    int nt = nthreads > 0 ? nthreads
                          : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > F) nt = F;
    if (nt <= 1) {
        run(0, F);
    } else {
        std::vector<std::thread> pool;
        const int32_t per = (F + nt - 1) / nt;
        for (int i = 0; i < nt; ++i) {
            const int32_t lo = i * per, hi = std::min(F, lo + per);
            if (lo >= hi) break;
            pool.emplace_back(run, lo, hi);
        }
        for (auto& th : pool) th.join();
    }
    for (int32_t f = 0; f < F; ++f)
        if (rc[f] != 0) return -1;
    return 0;
}


// ---------------------------------------------------------------------------
// HCA encoder MDCT: PCM16 timeline -> f32 spectra, 8 subframes per panel.
//
// Mirrors ops/hca_encode_host.py::run_mdct + dct4 exactly (reference
// hca.cpp:2470-2559): PcmToFloat, the shifted overlap windows, the DCT-IV
// first butterfly + 6 stages, shuffle, * 0.125f. Same fp32 op order
// (-ffp-contract=off). dct4_sin/dct4_cos are the flat twiddle buffers from
// ops/hca_tables.py (table for `bits` starts at (1 << bits) - 1).
// ---------------------------------------------------------------------------

#if defined(__AVX2__)
// 8x8-block transposes between subframe-major rows[8][128] and the
// [128 lines][8 lanes] panel layout the stage network runs in.
static inline void hca_tr8x8_in(const float* rows, int k0, float (*dst)[8]) {
    __m256 r0 = _mm256_loadu_ps(rows + 0 * 128 + k0),
           r1 = _mm256_loadu_ps(rows + 1 * 128 + k0),
           r2 = _mm256_loadu_ps(rows + 2 * 128 + k0),
           r3 = _mm256_loadu_ps(rows + 3 * 128 + k0),
           r4 = _mm256_loadu_ps(rows + 4 * 128 + k0),
           r5 = _mm256_loadu_ps(rows + 5 * 128 + k0),
           r6 = _mm256_loadu_ps(rows + 6 * 128 + k0),
           r7 = _mm256_loadu_ps(rows + 7 * 128 + k0);
    __m256 t0 = _mm256_unpacklo_ps(r0, r1), t1 = _mm256_unpackhi_ps(r0, r1),
           t2 = _mm256_unpacklo_ps(r2, r3), t3 = _mm256_unpackhi_ps(r2, r3),
           t4 = _mm256_unpacklo_ps(r4, r5), t5 = _mm256_unpackhi_ps(r4, r5),
           t6 = _mm256_unpacklo_ps(r6, r7), t7 = _mm256_unpackhi_ps(r6, r7);
    __m256 s0 = _mm256_shuffle_ps(t0, t2, _MM_SHUFFLE(1, 0, 1, 0)),
           s1 = _mm256_shuffle_ps(t0, t2, _MM_SHUFFLE(3, 2, 3, 2)),
           s2 = _mm256_shuffle_ps(t1, t3, _MM_SHUFFLE(1, 0, 1, 0)),
           s3 = _mm256_shuffle_ps(t1, t3, _MM_SHUFFLE(3, 2, 3, 2)),
           s4 = _mm256_shuffle_ps(t4, t6, _MM_SHUFFLE(1, 0, 1, 0)),
           s5 = _mm256_shuffle_ps(t4, t6, _MM_SHUFFLE(3, 2, 3, 2)),
           s6 = _mm256_shuffle_ps(t5, t7, _MM_SHUFFLE(1, 0, 1, 0)),
           s7 = _mm256_shuffle_ps(t5, t7, _MM_SHUFFLE(3, 2, 3, 2));
    _mm256_store_ps(dst[k0 + 0], _mm256_permute2f128_ps(s0, s4, 0x20));
    _mm256_store_ps(dst[k0 + 1], _mm256_permute2f128_ps(s1, s5, 0x20));
    _mm256_store_ps(dst[k0 + 2], _mm256_permute2f128_ps(s2, s6, 0x20));
    _mm256_store_ps(dst[k0 + 3], _mm256_permute2f128_ps(s3, s7, 0x20));
    _mm256_store_ps(dst[k0 + 4], _mm256_permute2f128_ps(s0, s4, 0x31));
    _mm256_store_ps(dst[k0 + 5], _mm256_permute2f128_ps(s1, s5, 0x31));
    _mm256_store_ps(dst[k0 + 6], _mm256_permute2f128_ps(s2, s6, 0x31));
    _mm256_store_ps(dst[k0 + 7], _mm256_permute2f128_ps(s3, s7, 0x31));
}

static inline void hca_tr8x8_out(float (*src)[8], int k0, float* rows) {
    __m256 r0 = _mm256_load_ps(src[k0 + 0]), r1 = _mm256_load_ps(src[k0 + 1]),
           r2 = _mm256_load_ps(src[k0 + 2]), r3 = _mm256_load_ps(src[k0 + 3]),
           r4 = _mm256_load_ps(src[k0 + 4]), r5 = _mm256_load_ps(src[k0 + 5]),
           r6 = _mm256_load_ps(src[k0 + 6]), r7 = _mm256_load_ps(src[k0 + 7]);
    __m256 t0 = _mm256_unpacklo_ps(r0, r1), t1 = _mm256_unpackhi_ps(r0, r1),
           t2 = _mm256_unpacklo_ps(r2, r3), t3 = _mm256_unpackhi_ps(r2, r3),
           t4 = _mm256_unpacklo_ps(r4, r5), t5 = _mm256_unpackhi_ps(r4, r5),
           t6 = _mm256_unpacklo_ps(r6, r7), t7 = _mm256_unpackhi_ps(r6, r7);
    __m256 s0 = _mm256_shuffle_ps(t0, t2, _MM_SHUFFLE(1, 0, 1, 0)),
           s1 = _mm256_shuffle_ps(t0, t2, _MM_SHUFFLE(3, 2, 3, 2)),
           s2 = _mm256_shuffle_ps(t1, t3, _MM_SHUFFLE(1, 0, 1, 0)),
           s3 = _mm256_shuffle_ps(t1, t3, _MM_SHUFFLE(3, 2, 3, 2)),
           s4 = _mm256_shuffle_ps(t4, t6, _MM_SHUFFLE(1, 0, 1, 0)),
           s5 = _mm256_shuffle_ps(t4, t6, _MM_SHUFFLE(3, 2, 3, 2)),
           s6 = _mm256_shuffle_ps(t5, t7, _MM_SHUFFLE(1, 0, 1, 0)),
           s7 = _mm256_shuffle_ps(t5, t7, _MM_SHUFFLE(3, 2, 3, 2));
    _mm256_storeu_ps(rows + 0 * 128 + k0, _mm256_permute2f128_ps(s0, s4, 0x20));
    _mm256_storeu_ps(rows + 1 * 128 + k0, _mm256_permute2f128_ps(s1, s5, 0x20));
    _mm256_storeu_ps(rows + 2 * 128 + k0, _mm256_permute2f128_ps(s2, s6, 0x20));
    _mm256_storeu_ps(rows + 3 * 128 + k0, _mm256_permute2f128_ps(s3, s7, 0x20));
    _mm256_storeu_ps(rows + 4 * 128 + k0, _mm256_permute2f128_ps(s0, s4, 0x31));
    _mm256_storeu_ps(rows + 5 * 128 + k0, _mm256_permute2f128_ps(s1, s5, 0x31));
    _mm256_storeu_ps(rows + 6 * 128 + k0, _mm256_permute2f128_ps(s2, s6, 0x31));
    _mm256_storeu_ps(rows + 7 * 128 + k0, _mm256_permute2f128_ps(s3, s7, 0x31));
}

// AVX2 twin of the scalar MDCT below — bit-exact: the sign-folded windowing
// identities ((-x)*y == -(x*y); a-b with b negated == add) round identically,
// and every stage performs the same fp32 ops in the same order, one spectral
// line per ymm vector.
static void hca_mdct_avx2(const int16_t* timeline, int32_t C, int32_t F,
                          const float* window128, const float* dct4_sin,
                          const float* dct4_cos, const int32_t* shuffle,
                          float* out) {
    const float inv = 1.0f / 32768.0f;
    const float* sin7 = dct4_sin + 127;
    const float* cos7 = dct4_cos + 127;
    const int64_t Tn = (int64_t)F * 8;
    alignas(32) float va[128][8], vb[128][8], vs[128][8];
    alignas(32) float rows[8][128];
    alignas(32) float wave[128], prev[128], wrev_lo[64], prevrev_hi[64];
    alignas(32) float w_rev63[64], w_tail[64], w_head[64], w_rev127[64];
    for (int k = 0; k < 64; ++k) {
        w_rev63[k] = window128[63 - k];
        w_tail[k] = window128[64 + k];
        w_head[k] = window128[k];
        w_rev127[k] = window128[127 - k];
    }
    for (int32_t c = 0; c < C; ++c) {
        std::memset(prev, 0, sizeof(prev));
        const int16_t* tl = timeline + (size_t)c * Tn * 128;
        for (int32_t f = 0; f < F; ++f) {
            for (int32_t t = 0; t < 8; ++t) {
                const int16_t* pc = tl + ((size_t)f * 8 + t) * 128;
                for (int k = 0; k < 128; k += 8) {
                    __m128i w16 = _mm_loadu_si128((const __m128i*)(pc + k));
                    __m256 vf = _mm256_cvtepi32_ps(_mm256_cvtepi16_epi32(w16));
                    _mm256_store_ps(wave + k,
                                    _mm256_mul_ps(vf, _mm256_set1_ps(inv)));
                }
                for (int k = 0; k < 64; k += 8)
                    _mm256_store_ps(wrev_lo + k,
                                    hca_rev8(_mm256_loadu_ps(wave + 56 - k)));
                for (int k = 0; k < 64; k += 8)
                    _mm256_store_ps(prevrev_hi + k,
                                    hca_rev8(_mm256_loadu_ps(prev + 120 - k)));
                float* r = rows[t];
                // scalar: a = w[63-k]*(-wave[64+k]); b = (-w[64+k])*wave[63-k]
                // r[k] = a - b  ==  fl(w[64+k]*wave[63-k] - w[63-k]*wave[64+k])
                for (int k = 0; k < 64; k += 8) {
                    __m256 p = _mm256_mul_ps(_mm256_load_ps(w_rev63 + k),
                                             _mm256_load_ps(wave + 64 + k));
                    __m256 q = _mm256_mul_ps(_mm256_load_ps(w_tail + k),
                                             _mm256_load_ps(wrev_lo + k));
                    _mm256_storeu_ps(r + k, _mm256_sub_ps(q, p));
                }
                // scalar: cc2 = w[k]*prev[k]; dd = (-w[127-k])*prev[127-k]
                // r[64+k] = cc2 - dd == fl(w[k]*prev[k] + w[127-k]*prev[127-k])
                for (int k = 0; k < 64; k += 8) {
                    __m256 cc2 = _mm256_mul_ps(_mm256_load_ps(w_head + k),
                                               _mm256_load_ps(prev + k));
                    __m256 rr = _mm256_mul_ps(_mm256_load_ps(w_rev127 + k),
                                              _mm256_load_ps(prevrev_hi + k));
                    _mm256_storeu_ps(r + 64 + k, _mm256_add_ps(cc2, rr));
                }
                std::memcpy(prev, wave, sizeof(wave));
            }
            for (int k = 0; k < 128; k += 8) hca_tr8x8_in(&rows[0][0], k, va);
            for (int i = 0; i < 64; ++i) {
                __m256 a = _mm256_load_ps(va[2 * i]);
                __m256 b = _mm256_load_ps(va[127 - 2 * i]);
                __m256 cw = _mm256_set1_ps(cos7[i]);
                __m256 sw = _mm256_set1_ps(sin7[i]);
                _mm256_store_ps(vb[2 * i],
                    _mm256_add_ps(_mm256_mul_ps(a, cw), _mm256_mul_ps(b, sw)));
                _mm256_store_ps(vb[2 * i + 1],
                    _mm256_sub_ps(_mm256_mul_ps(a, sw), _mm256_mul_ps(b, cw)));
            }
            for (int stage = 0; stage < 6; ++stage) {
                const int block_count = 1 << stage;
                const int bhs_bits = 5 - stage;
                const int bhs = 1 << bhs_bits;
                const float* sn = dct4_sin + ((1 << bhs_bits) - 1);
                const float* cs = dct4_cos + ((1 << bhs_bits) - 1);
                const int blk_len = 128 / block_count;
                for (int g = 0; g < block_count; ++g) {
                    float (*base)[8] = vb + g * blk_len;
                    for (int j = 0; j < bhs; ++j) {
                        __m256 fe = _mm256_load_ps(base[2 * j]);
                        __m256 fo = _mm256_load_ps(base[2 * j + 1]);
                        __m256 be = _mm256_load_ps(base[2 * bhs + 2 * j]);
                        __m256 bo = _mm256_load_ps(base[2 * bhs + 2 * j + 1]);
                        __m256 cw = _mm256_set1_ps(cs[j]);
                        __m256 sw = _mm256_set1_ps(sn[j]);
                        __m256 a2 = _mm256_sub_ps(fe, be);
                        __m256 b2 = _mm256_sub_ps(fo, bo);
                        _mm256_store_ps(base[2 * j], _mm256_add_ps(fe, be));
                        _mm256_store_ps(base[2 * j + 1], _mm256_add_ps(fo, bo));
                        _mm256_store_ps(base[2 * bhs + 2 * j],
                            _mm256_add_ps(_mm256_mul_ps(a2, cw),
                                          _mm256_mul_ps(b2, sw)));
                        _mm256_store_ps(base[2 * bhs + 2 * j + 1],
                            _mm256_sub_ps(_mm256_mul_ps(a2, sw),
                                          _mm256_mul_ps(b2, cw)));
                    }
                }
            }
            const __m256 kEighth = _mm256_set1_ps(0.125f);
            for (int k = 0; k < 128; ++k)
                _mm256_store_ps(vs[k],
                    _mm256_mul_ps(_mm256_load_ps(vb[shuffle[k]]), kEighth));
            float* of = out + (((size_t)f * C + c) * 8) * 128;
            for (int k = 0; k < 128; k += 8) hca_tr8x8_out(vs, k, of);
        }
    }
}
#endif  // __AVX2__

void cri_hca_mdct(const int16_t* timeline,  // [C, F*1024]
                  int32_t C, int32_t F, const float* window128,
                  const float* dct4_sin, const float* dct4_cos,
                  const int32_t* shuffle,   // [128]
                  float* out) {             // [F, C, 8, 128]
#if defined(__AVX2__)
    hca_mdct_avx2(timeline, C, F, window128, dct4_sin, dct4_cos, shuffle,
                  out);
    return;
#else
    const float inv = 1.0f / 32768.0f;
    const float* sin7 = dct4_sin + 127;
    const float* cos7 = dct4_cos + 127;
    const int64_t Tn = (int64_t)F * 8;
    alignas(32) float va[128][8], vb[128][8];
    std::vector<float> prev(128, 0.0f);  // previous subframe's wave
    std::vector<float> wave(128);
    for (int32_t c = 0; c < C; ++c) {
        std::fill(prev.begin(), prev.end(), 0.0f);
        const int16_t* tl = timeline + (size_t)c * Tn * 128;
        for (int32_t f = 0; f < F; ++f) {
            // scratch windows for the 8 subframes of this frame -> panels
            for (int32_t t = 0; t < 8; ++t) {
                const int16_t* pc = tl + ((size_t)f * 8 + t) * 128;
                for (int k = 0; k < 128; ++k) wave[k] = (float)pc[k] * inv;
                for (int k = 0; k < 64; ++k) {
                    const float a = window128[63 - k] * (-wave[64 + k]);
                    const float b = (-window128[64 + k]) * wave[63 - k];
                    va[k][t] = a - b;
                }
                for (int k = 0; k < 64; ++k) {
                    const float cc2 = window128[k] * prev[k];
                    const float dd = (-window128[127 - k]) * prev[127 - k];
                    va[64 + k][t] = cc2 - dd;
                }
                std::swap(wave, prev);
            }
            // DCT-IV first butterfly: temp[2i] = a*cos+b*sin,
            // temp[2i+1] = a*sin-b*cos with a=x[2i], b=x[127-2i]
            for (int i = 0; i < 64; ++i) {
                const float* a = va[2 * i];
                const float* b = va[127 - 2 * i];
                const float cw = cos7[i], sw = sin7[i];
                float* e = vb[2 * i];
                float* o = vb[2 * i + 1];
                for (int u = 0; u < 8; ++u) {
                    e[u] = a[u] * cw + b[u] * sw;
                    o[u] = a[u] * sw - b[u] * cw;
                }
            }
            // 6 in-place stages on vb
            for (int stage = 0; stage < 6; ++stage) {
                const int block_count = 1 << stage;
                const int bhs_bits = 5 - stage;
                const int bhs = 1 << bhs_bits;
                const float* sn = dct4_sin + ((1 << bhs_bits) - 1);
                const float* cs = dct4_cos + ((1 << bhs_bits) - 1);
                const int blk_len = 128 / block_count;  // = 2 * bhs * 2
                for (int g = 0; g < block_count; ++g) {
                    float (*base)[8] = vb + g * blk_len;
                    for (int j = 0; j < bhs; ++j) {
                        float* fe = base[2 * j];
                        float* fo = base[2 * j + 1];
                        float* be = base[2 * bhs + 2 * j];
                        float* bo = base[2 * bhs + 2 * j + 1];
                        const float cw = cs[j], sw = sn[j];
                        for (int u = 0; u < 8; ++u) {
                            const float a2 = fe[u] - be[u];
                            const float b2 = fo[u] - bo[u];
                            fe[u] = fe[u] + be[u];
                            fo[u] = fo[u] + bo[u];
                            be[u] = a2 * cw + b2 * sw;
                            bo[u] = a2 * sw - b2 * cw;
                        }
                    }
                }
            }
            // shuffle + * 0.125f -> out[f][c][t][k]
            float* of = out + (((size_t)f * C + c) * 8) * 128;
            for (int k = 0; k < 128; ++k) {
                const float* src = vb[shuffle[k]];
                for (int t = 0; t < 8; ++t)
                    of[(size_t)t * 128 + k] = src[t] * 0.125f;
            }
        }
    }
#endif
}


// ---------------------------------------------------------------------------
// HCA encoder elementwise stages (mirrors ops/hca_encode_host.py:
// calc_scalefactors + scale_spectra, calc_resolution_enc + quantize_spectra,
// calc_delta_lengths; reference hca.cpp:2611-2654, 2752-2761, 2878-2892,
// 2708-2750). Same fp32 op order as numpy (-ffp-contract=off).
// ---------------------------------------------------------------------------

// peak -> scalefactor -> scaled spectra. clamp_lim is np.float32(0.9999999).
void cri_hca_scalefactors_scale(const float* spectra,  // [F, C, 8, 128]
                                int32_t F, int32_t C,
                                const int32_t* coded_count,
                                const float* scaling64,
                                const float* qscaling64, float clamp_lim,
                                int32_t* sf_out,     // [F, C, 128]
                                float* scaled_out) { // [F, C, 8, 128]
#if defined(__AVX2__)
    // vectorised over bands: abs-max peaks, a fixed-6-step gather binary
    // search (64-entry table halves exactly 6 times), one qscaling gather
    // per band reused by all 8 subframes. Same compares/ops as the scalar
    // path below, so results are identical.
    const __m256 sgnmask = _mm256_castsi256_ps(_mm256_set1_epi32(0x7FFFFFFF));
    for (int64_t fc = 0; fc < (int64_t)F * C; ++fc) {
        const int32_t c = (int32_t)(fc % C);
        const int32_t cc = coded_count[c];
        const float* sp = spectra + (size_t)fc * 8 * 128;
        int32_t* sf = sf_out + (size_t)fc * 128;
        float* out = scaled_out + (size_t)fc * 8 * 128;
        alignas(32) float qs[128];
        for (int k0 = 0; k0 < 128; k0 += 8) {
            __m256 peak = _mm256_setzero_ps();
            for (int t = 0; t < 8; ++t)
                peak = _mm256_max_ps(peak, _mm256_and_ps(
                    _mm256_loadu_ps(sp + (size_t)t * 128 + k0), sgnmask));
            __m256i lo = _mm256_setzero_si256();
            __m256i hi = _mm256_set1_epi32(64);
            // 7 steps, not 6: the [0,64) range halves to width 1 after six
            // comparisons and the seventh resolves it (lo==hi afterwards).
            // With only six, peaks inside [table[0], table[1]) misclassify
            // as scalefactor 0 and the band is silenced.
            for (int it = 0; it < 7; ++it) {
                __m256i mid = _mm256_srai_epi32(_mm256_add_epi32(lo, hi), 1);
                // lanes already converged at lo==hi==64 would gather one
                // past the table; clamp the index (their blend outcome is
                // identical either way — the final min(lo,63) absorbs it)
                __m256 g = _mm256_i32gather_ps(
                    scaling64, _mm256_min_epi32(mid, _mm256_set1_epi32(63)),
                    4);
                __m256i take = _mm256_castps_si256(
                    _mm256_cmp_ps(g, peak, _CMP_LE_OQ));
                lo = _mm256_blendv_epi8(
                    lo, _mm256_add_epi32(mid, _mm256_set1_epi32(1)), take);
                hi = _mm256_blendv_epi8(mid, hi, take);
            }
            lo = _mm256_min_epi32(lo, _mm256_set1_epi32(63));
            // zero sf for k >= cc
            __m256i kidx = _mm256_add_epi32(
                _mm256_set1_epi32(k0), _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7));
            __m256i in_cc = _mm256_cmpgt_epi32(_mm256_set1_epi32(cc), kidx);
            lo = _mm256_and_si256(lo, in_cc);
            _mm256_storeu_si256((__m256i*)(sf + k0), lo);
            // qscaling gather; force 0 where sf==0 or k>=cc (the scalar
            // path never multiplies there — it writes literal 0.0f)
            __m256 q = _mm256_i32gather_ps(qscaling64, lo, 4);
            __m256i nz = _mm256_cmpgt_epi32(lo, _mm256_setzero_si256());
            q = _mm256_and_ps(q, _mm256_castsi256_ps(
                _mm256_and_si256(nz, in_cc)));
            _mm256_store_ps(qs + k0, q);
        }
        const __m256 vlim = _mm256_set1_ps(clamp_lim);
        const __m256 vnlim = _mm256_set1_ps(-clamp_lim);
        for (int t = 0; t < 8; ++t) {
            const float* row = sp + (size_t)t * 128;
            float* orow = out + (size_t)t * 128;
            for (int k0 = 0; k0 < 128; k0 += 8) {
                __m256 v = _mm256_mul_ps(_mm256_loadu_ps(row + k0),
                                         _mm256_load_ps(qs + k0));
                v = _mm256_min_ps(v, vlim);
                v = _mm256_max_ps(v, vnlim);
                // qs==0 lanes: scalar writes literal 0 (0*x could be -0/NaN
                // only for x inf/nan, impossible here; keep the and anyway)
                v = _mm256_and_ps(v, _mm256_cmp_ps(
                    _mm256_load_ps(qs + k0), _mm256_setzero_ps(),
                    _CMP_NEQ_OQ));
                _mm256_storeu_ps(orow + k0, v);
            }
        }
    }
#else
    for (int64_t fc = 0; fc < (int64_t)F * C; ++fc) {
        const int32_t c = (int32_t)(fc % C);
        const int32_t cc = coded_count[c];
        const float* sp = spectra + (size_t)fc * 8 * 128;
        int32_t* sf = sf_out + (size_t)fc * 128;
        float* out = scaled_out + (size_t)fc * 8 * 128;
        for (int k = 0; k < 128; ++k) {
            if (k >= cc) { sf[k] = 0; continue; }
            float peak = 0.0f;
            for (int t = 0; t < 8; ++t) {
                const float v = std::fabs(sp[t * 128 + k]);
                if (v > peak) peak = v;
            }
            // searchsorted(SCALING_TABLE, peak, side="right"): count <= peak
            int lo = 0, hi = 64;
            while (lo < hi) {
                const int mid = (lo + hi) / 2;
                if (scaling64[mid] <= peak) lo = mid + 1;
                else hi = mid;
            }
            sf[k] = lo < 63 ? lo : 63;
        }
        for (int t = 0; t < 8; ++t) {
            for (int k = 0; k < 128; ++k) {
                float v = 0.0f;
                if (k < cc && sf[k] != 0) {
                    v = sp[t * 128 + k] * qscaling64[sf[k]];
                    if (v > clamp_lim) v = clamp_lim;
                    if (v < -clamp_lim) v = -clamp_lim;
                }
                out[t * 128 + k] = v;
            }
        }
    }
#endif
}

// noise-level resolutions + spectrum quantisation.
void cri_hca_resolution_quantize(const int32_t* sf,   // [F, C, 128]
                                 const float* scaled, // [F, C, 8, 128]
                                 const int32_t* level, const int32_t* boundary,
                                 int32_t F, int32_t C,
                                 const int32_t* coded_count,
                                 const uint8_t* curve, const float* inv_step,
                                 int32_t* res_out,    // [F, C, 128]
                                 int32_t* q_out) {    // [F, C, 8, 128]
#if defined(__AVX2__)
    // vectorised over bands: curve/step lookups become gathers on widened
    // LUTs; the per-resolution shift constants are precomputed 16-entry
    // tables so no per-lane double math is needed. Identical ops/rounding
    // to the scalar path below.
    alignas(32) int32_t curve_i32[64];
    for (int i = 0; i < 64; ++i) curve_i32[i] = i <= 58 ? curve[i] : 0;
    alignas(32) float up_lut[16];
    alignas(32) int32_t down_lut[16];
    for (int r = 0; r < 16; ++r) {
        up_lut[r] = inv_step[r] + 1.0f;
        down_lut[r] = (int32_t)(int64_t)std::trunc((double)inv_step[r] + 0.5);
    }
    const __m256i seq = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
    for (int64_t fc = 0; fc < (int64_t)F * C; ++fc) {
        const int32_t f = (int32_t)(fc / C);
        const int32_t c = (int32_t)(fc % C);
        const int32_t cc = coded_count[c];
        const int32_t* sfr = sf + (size_t)fc * 128;
        const float* sc = scaled + (size_t)fc * 8 * 128;
        int32_t* res = res_out + (size_t)fc * 128;
        int32_t* q = q_out + (size_t)fc * 8 * 128;
        const __m256i vlevel = _mm256_set1_epi32(level[f]);
        const __m256i vbound = _mm256_set1_epi32(boundary[f]);
        for (int k0 = 0; k0 < 128; k0 += 8) {
            __m256i kidx = _mm256_add_epi32(_mm256_set1_epi32(k0), seq);
            __m256i in_cc = _mm256_cmpgt_epi32(_mm256_set1_epi32(cc), kidx);
            __m256i sfv = _mm256_loadu_si256((const __m256i*)(sfr + k0));
            // noise = level - (k < boundary)
            __m256i noise = _mm256_add_epi32(
                vlevel, _mm256_cmpgt_epi32(vbound, kidx));
            // cidx = clamp(noise - (5*sf)/2 + 2, 0, 58); sf >= 0 so /2 == >>1
            __m256i s52 = _mm256_srai_epi32(
                _mm256_mullo_epi32(sfv, _mm256_set1_epi32(5)), 1);
            __m256i cidx = _mm256_add_epi32(
                _mm256_sub_epi32(noise, s52), _mm256_set1_epi32(2));
            cidx = _mm256_max_epi32(cidx, _mm256_setzero_si256());
            cidx = _mm256_min_epi32(cidx, _mm256_set1_epi32(58));
            __m256i r = _mm256_i32gather_epi32(curve_i32, cidx, 4);
            // sf == 0 -> r = 0; k >= cc -> r = 0
            __m256i nz = _mm256_cmpgt_epi32(sfv, _mm256_setzero_si256());
            r = _mm256_and_si256(r, _mm256_and_si256(nz, in_cc));
            _mm256_storeu_si256((__m256i*)(res + k0), r);
            __m256 ssi = _mm256_i32gather_ps(inv_step, r, 4);
            __m256 up = _mm256_i32gather_ps(up_lut, r, 4);
            __m256i down = _mm256_i32gather_epi32(down_lut, r, 4);
            for (int t = 0; t < 8; ++t) {
                __m256 v = _mm256_loadu_ps(sc + (size_t)t * 128 + k0);
                __m256i qq = _mm256_sub_epi32(
                    _mm256_cvttps_epi32(
                        _mm256_add_ps(_mm256_mul_ps(v, ssi), up)),
                    down);
                qq = _mm256_and_si256(qq, in_cc);  // k >= cc -> 0
                _mm256_storeu_si256((__m256i*)(q + (size_t)t * 128 + k0), qq);
            }
        }
    }
#else
    for (int64_t fc = 0; fc < (int64_t)F * C; ++fc) {
        const int32_t f = (int32_t)(fc / C);
        const int32_t c = (int32_t)(fc % C);
        const int32_t cc = coded_count[c];
        const int32_t* sfr = sf + (size_t)fc * 128;
        const float* sc = scaled + (size_t)fc * 8 * 128;
        int32_t* res = res_out + (size_t)fc * 128;
        int32_t* q = q_out + (size_t)fc * 8 * 128;
        for (int k = 0; k < 128; ++k) {
            if (k >= cc) {
                res[k] = 0;
                for (int t = 0; t < 8; ++t) q[t * 128 + k] = 0;
                continue;
            }
            const int64_t noise =
                k < boundary[f] ? (int64_t)level[f] - 1 : level[f];
            const int32_t r = hcaenc::resolution_enc(sfr[k], noise, curve);
            res[k] = r;
            const float ssi = inv_step[r < 0 ? 0 : (r > 15 ? 15 : r)];
            const float shift_up = ssi + 1.0f;
            const int64_t shift_down =
                (int64_t)std::trunc((double)ssi + 0.5);
            for (int t = 0; t < 8; ++t)
                q[t * 128 + k] =
                    (int32_t)((int64_t)std::truncf(
                                  sc[t * 128 + k] * ssi + shift_up)
                              - shift_down);
        }
    }
#endif
}

// batch CalculateOptimalDeltaLength + header lengths.
void cri_hca_delta_lengths(const int32_t* sf,  // [F, C, 128]
                           int32_t F, int32_t C, const int32_t* coded_count,
                           const uint8_t* channel_type,
                           int32_t stereo_secondary_tag,
                           int32_t hfr_group_count,
                           int32_t* delta_bits,    // [F, C]
                           int32_t* header_len) {  // [F, C]
    for (int64_t fc = 0; fc < (int64_t)F * C; ++fc) {
        const int32_t c = (int32_t)(fc % C);
        hcaenc::delta_length(sf + (size_t)fc * 128, coded_count[c],
                             channel_type[c], hfr_group_count,
                             stereo_secondary_tag,
                             delta_bits + fc, header_len + fc);
    }
}


// EncodeIntensityStereo (hca.cpp:2561-2609; mirrors
// ops/hca_encode_host.py::encode_intensity_stereo). Mutates spectra and
// writes the secondary channel's intensity indices. f32 accumulation in band
// order; ratio clamps compare in f64 like the numpy path.
void cri_hca_intensity_stereo(float* spectra,     // [F, C, 8, 128]
                              uint8_t* intensity,  // [F, C, 8]
                              int32_t F, int32_t C, int32_t base_band,
                              int32_t total_band,
                              const uint8_t* channel_type,
                              int32_t stereo_primary_tag,
                              const float* bounds14) {
    const double sqrt2_2 = std::sqrt(2.0) / 2.0;
    for (int32_t c = 0; c + 1 < C; ++c) {
        if (channel_type[c] != stereo_primary_tag) continue;
        for (int32_t f = 0; f < F; ++f) {
            float* l = spectra + (((size_t)f * C + c) * 8) * 128;
            float* r = spectra + (((size_t)f * C + c + 1) * 8) * 128;
            uint8_t* qo = intensity + ((size_t)f * C + c + 1) * 8;
            for (int32_t t = 0; t < 8; ++t) {
                float* lt = l + (size_t)t * 128;
                float* rt = r + (size_t)t * 128;
                float e_l = 0.0f, e_r = 0.0f, e_t = 0.0f;
                for (int32_t k = base_band; k < total_band; ++k) {
                    e_l = e_l + std::fabs(lt[k]);
                    e_r = e_r + std::fabs(rt[k]);
                    e_t = e_t + std::fabs(lt[k] + rt[k]);
                }
                e_t = e_t * 2.0f;
                const float e_lr = e_r + e_l;
                const float stored = (2.0f * e_l) / e_lr;
                float ratio = e_lr / e_t;
                if ((double)ratio < 0.5) ratio = 0.5f;
                if ((double)ratio > sqrt2_2) ratio = (float)sqrt2_2;
                int32_t quant = 1;
                for (int32_t k = 1; k < 13; ++k)
                    quant += bounds14[k] >= stored;  // NaN compares false
                const bool has_energy = e_r > 0.0f || e_l > 0.0f;
                if (!has_energy) { quant = 0; ratio = 1.0f; }
                qo[t] = (uint8_t)quant;
                for (int32_t k = base_band; k < total_band; ++k) {
                    lt[k] = (lt[k] + rt[k]) * ratio;
                    rt[k] = 0.0f;
                }
            }
        }
    }
}


// ---------------------------------------------------------------------------
// HCA keycode testing: unpack N (cipher, frame) pairs independently with
// per-pair status, for batched key search (clHCA_TestBlock front half,
// hca.cpp:1004-1097; mirrors ops/hca_frame.py::test_block up to the float
// wave inspection, which runs batched on the device afterwards).
//
// statuses: -1 sync/crc/unpack/tail failure, -6 bit-position overrun,
// 1 = unpacked OK (wave scoring pending), 0 = silent frame (score 0).
// ---------------------------------------------------------------------------

void cri_hca_test_frames(
    const uint8_t* frames,    // [nframes, frame_size] raw (encrypted) frames
    const int32_t* frame_pre, // [nframes] key-independent precheck:
                              //   0 normal, 1 silent, -1 bad sync/crc
    int32_t nframes, int32_t frame_size,
    const uint8_t* ciphers, int32_t nkeys,  // [nkeys, 256]
    int32_t channels, int32_t version, int32_t hfr_group_count,
    int32_t min_resolution, int32_t max_resolution,
    const uint8_t* channel_type, const int32_t* coded_count,
    const uint8_t* ath, const uint8_t* invert_table,
    const uint8_t* max_bit_table, const uint8_t* read_bit_table,
    const int8_t* read_val_table,
    int32_t* status_out,      // [nkeys, nframes]
    int16_t* qc, uint8_t* sfs_out, uint8_t* ress_out, uint8_t* intens_out,
    int32_t nthreads) {       // SoA tensors: [nkeys*nframes, C, ...]
    const int C = channels;
    const bool v3 = version > 0x0200;
    const int64_t total = (int64_t)nkeys * nframes;

    auto test_one = [&](int64_t n) {
        const int64_t k = n / nframes;
        const int64_t f = n % nframes;
        const uint8_t* frame = frames + (size_t)f * frame_size;
        const uint8_t* cipher = ciphers + (size_t)k * 256;
        int32_t* status = status_out + n;
        // status-only mode (qc == nullptr): thread-local scratch SoA, used
        // by the cheap reject pass of the batched key search
        thread_local std::vector<uint8_t> scratch8;
        thread_local std::vector<int16_t> scratch16;
        uint8_t *sfs_f, *res_f, *int_f;
        int16_t* qc_f;
        if (qc != nullptr) {
            sfs_f = sfs_out + (size_t)n * C * 128;
            res_f = ress_out + (size_t)n * C * 128;
            int_f = intens_out + (size_t)n * C * 8;
            qc_f = qc + (size_t)n * C * 8 * 128;
        } else {
            scratch8.resize((size_t)C * (128 + 128 + 8));
            scratch16.resize((size_t)C * 8 * 128);
            sfs_f = scratch8.data();
            res_f = sfs_f + (size_t)C * 128;
            int_f = res_f + (size_t)C * 128;
            qc_f = scratch16.data();
        }
        std::memset(sfs_f, 0, (size_t)C * 128);
        std::memset(res_f, 0, (size_t)C * 128);
        std::memset(int_f, 0, (size_t)C * 8);
        std::memset(qc_f, 0, (size_t)C * 8 * 128 * sizeof(int16_t));

        if (frame_pre[f] != 0) {   // hoisted key-independent checks
            *status = frame_pre[f] == 1 ? 0 : -1;
            return;
        }

        thread_local std::vector<uint8_t> dec;
        dec.resize(frame_size + 8);
        for (int i = 0; i < frame_size; i++) dec[i] = cipher[frame[i]];
        std::memset(dec.data() + frame_size, 0, 8);
        hca::BitReader br(dec.data(), frame_size);
        br.skip(16);
        int anl = br.read(9);
        int evb = br.read(7);
        int packed_noise = (anl << 8) - evb;

        if (hca_unpack_frame_body(
                br, packed_noise, C, v3, hfr_group_count, min_resolution,
                max_resolution, channel_type, coded_count, ath, invert_table,
                max_bit_table, read_bit_table, read_val_table,
                sfs_f, res_f, int_f, qc_f, nullptr, nullptr) < 0) {
            *status = -1;
            return;
        }
        const int bits_max = frame_size * 8;
        if (br.pos + 14 > bits_max) { *status = -6; return; }
        const int byte_start = (br.pos / 8) + (br.pos % 8 ? 1 : 0);
        for (int i = byte_start; i < frame_size - 2; i++)
            if (dec[i] != 0) { *status = -1; return; }
        *status = 1;
    };

    int nt = nthreads > 0 ? nthreads
                          : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt <= 1 || total < 8) {
        for (int64_t n = 0; n < total; n++) test_one(n);
        return;
    }
    std::vector<std::thread> pool;
    const int64_t per = (total + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        const int64_t lo = t * per, hi = std::min(total, lo + per);
        if (lo >= hi) break;
        pool.emplace_back([&, lo, hi]() {
            for (int64_t n = lo; n < hi; n++) test_one(n);
        });
    }
    for (auto& th : pool) th.join();
}


// Batched HCA cipher-table init, type 56 (hca.cpp:539-617; mirrors
// utils/hca_crypt._cipher56). keys are the already-subkey-scrambled 64-bit
// keycodes; out is uint8 [K, 256]. Threaded across keys.
void cri_hca_cipher56_batch(const uint64_t* keys, int64_t nkeys,
                            uint8_t* out, int32_t nthreads) {
    auto init_row = [](uint32_t key, uint8_t* row) {
        const uint32_t mul = ((key & 1) << 3) | 5;
        const uint32_t add = (key & 0xE) | 1;
        key >>= 4;
        for (int i = 0; i < 16; i++) {
            key = (key * mul + add) & 0xF;
            row[i] = (uint8_t)key;
        }
    };
    auto run = [&](int64_t lo, int64_t hi) {
        uint8_t base[256], base_r[16], base_c[16];
        for (int64_t k = lo; k < hi; ++k) {
            uint64_t key = keys[k];
            if (key != 0) key -= 1;
            uint8_t kc[7];
            for (int i = 0; i < 7; i++) kc[i] = (uint8_t)(key >> (8 * i));
            const uint8_t seed[16] = {
                kc[1], (uint8_t)(kc[1] ^ kc[6]), (uint8_t)(kc[2] ^ kc[3]),
                kc[2], (uint8_t)(kc[2] ^ kc[1]), (uint8_t)(kc[3] ^ kc[4]),
                kc[3], (uint8_t)(kc[3] ^ kc[2]), (uint8_t)(kc[4] ^ kc[5]),
                kc[4], (uint8_t)(kc[4] ^ kc[3]), (uint8_t)(kc[5] ^ kc[6]),
                kc[5], (uint8_t)(kc[5] ^ kc[4]), (uint8_t)(kc[6] ^ kc[1]),
                kc[6]};
            init_row(kc[0], base_r);
            for (int r = 0; r < 16; r++) {
                init_row(seed[r], base_c);
                const uint8_t nb = (uint8_t)(base_r[r] << 4);
                for (int c = 0; c < 16; c++)
                    base[r * 16 + c] = nb | base_c[c];
            }
            uint8_t* table = out + (size_t)k * 256;
            std::memset(table, 0, 256);
            int x = 0, pos = 1;
            for (int i = 0; i < 256; i++) {
                x = (x + 17) & 0xFF;
                if (base[x] != 0 && base[x] != 0xFF) table[pos++] = base[x];
            }
            table[0] = 0;
            table[0xFF] = 0xFF;
        }
    };
    int nt = nthreads > 0 ? nthreads
                          : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt <= 1 || nkeys < 1024) { run(0, nkeys); return; }
    std::vector<std::thread> pool;
    const int64_t per = (nkeys + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        const int64_t lo = t * per, hi = std::min(nkeys, lo + per);
        if (lo >= hi) break;
        pool.emplace_back(run, lo, hi);
    }
    for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// MPEG Layer II frame unpack (AHX codec)
//
// Host fast path for ops/mp2_frame.py::unpack. The numpy path is the
// behavioural reference; this writes identical SoA tensors. One call
// unpacks a whole stream's frames (side info + sample codes).
// ---------------------------------------------------------------------------

namespace mp2 {

struct BitReader {
    const uint8_t* p;
    int64_t nbits;
    int64_t pos = 0;
    BitReader(const uint8_t* buf, int64_t nbytes)
        : p(buf), nbits(nbytes * 8) {}
    // MSB-first read; sets fail on overrun (caller aborts the frame)
    bool fail = false;
    inline uint32_t get(int n) {
        if (pos + n > nbits) { fail = true; return 0; }
        uint32_t v = 0;
        int64_t q = pos;
        pos += n;
        while (n > 0) {
            int byte = (int)(q >> 3);
            int bit = (int)(q & 7);
            int take = 8 - bit;
            if (take > n) take = n;
            v = (v << take)
                | ((uint32_t)(p[byte] >> (8 - bit - take)) & ((1u << take) - 1));
            q += take;
            n -= take;
        }
        return v;
    }
};

}  // namespace mp2

// Unpack `nframes` Layer II frames into SoA tensors.
//   frame_offsets[f]: byte offset of frame f in `data`;
//   frame_sizes[f]:   its size (incl. header);
//   nbal[sblimit]:    allocation field widths per subband;
//   classes[sblimit * 16]: quant levels per (subband, alloc index), 0 = none
//     (the LSF/MPEG-1 tables from ops/mp2_tables.py, padded to 16);
//   bounds[f]: first jointly-coded subband of frame f (mode_ext varies
//     per frame in joint stereo); crc_flag: 16-bit CRC after the header.
// Outputs: codes u16 [F, C, 36, 32], levels i32 [F, C, 32],
//          sfidx u8 [F, C, 3, 32] (all pre-zeroed by the caller).
// Returns 0, or -1 on a truncated/malformed frame.
int32_t cri_mp2_unpack_frames(
    const uint8_t* data, const int64_t* frame_offsets,
    const int32_t* frame_sizes, int32_t nframes,
    int32_t nch, int32_t sblimit, const int32_t* bounds, int32_t crc_flag,
    const int32_t* nbal, const int32_t* classes,
    uint16_t* codes, int32_t* levels, uint8_t* sfidx) {
    const int C = nch;
    for (int f = 0; f < nframes; f++) {
        const int32_t bound = bounds[f];
        mp2::BitReader br(data + frame_offsets[f], frame_sizes[f]);
        br.get(32);
        if (crc_flag) br.get(16);

        int32_t alloc[2][32] = {{0}};
        for (int sb = 0; sb < sblimit; sb++) {
            if (sb < bound) {
                for (int ch = 0; ch < C; ch++)
                    alloc[ch][sb] = classes[sb * 16 + br.get(nbal[sb])];
            } else {
                int32_t n = classes[sb * 16 + br.get(nbal[sb])];
                for (int ch = 0; ch < C; ch++) alloc[ch][sb] = n;
            }
        }
        int32_t scfsi[2][32] = {{0}};
        for (int sb = 0; sb < sblimit; sb++)
            for (int ch = 0; ch < C; ch++)
                if (alloc[ch][sb]) scfsi[ch][sb] = (int32_t)br.get(2);

        uint8_t* sf_f = sfidx + (size_t)f * C * 3 * 32;
        for (int sb = 0; sb < sblimit; sb++) {
            for (int ch = 0; ch < C; ch++) {
                if (!alloc[ch][sb]) continue;
                uint32_t a, b, c;
                switch (scfsi[ch][sb]) {
                    case 0: a = br.get(6); b = br.get(6); c = br.get(6); break;
                    case 1: a = b = br.get(6); c = br.get(6); break;
                    case 2: a = b = c = br.get(6); break;
                    default: a = br.get(6); b = c = br.get(6); break;
                }
                uint8_t* sf = sf_f + (size_t)ch * 3 * 32;
                sf[0 * 32 + sb] = (uint8_t)a;
                sf[1 * 32 + sb] = (uint8_t)b;
                sf[2 * 32 + sb] = (uint8_t)c;
            }
        }
        int32_t* lv_f = levels + (size_t)f * C * 32;
        for (int ch = 0; ch < C; ch++)
            for (int sb = 0; sb < sblimit; sb++)
                lv_f[(size_t)ch * 32 + sb] = alloc[ch][sb];

        uint16_t* q_f = codes + (size_t)f * C * 36 * 32;
        for (int gr = 0; gr < 12; gr++) {
            int row = gr * 3;
            for (int sb = 0; sb < sblimit; sb++) {
                bool shared = sb >= bound;
                int chs = shared ? 1 : C;
                for (int ch = 0; ch < chs; ch++) {
                    int32_t n = alloc[ch][sb];
                    if (!n) continue;
                    uint32_t v0, v1, v2;
                    if (n == 3 || n == 5 || n == 9) {
                        int gb = n == 3 ? 5 : (n == 5 ? 7 : 10);
                        uint32_t c = br.get(gb);
                        v0 = c % n; c /= n;
                        v1 = c % n;
                        v2 = c / n;
                    } else {
                        int b = 1;
                        while ((1 << b) - 1 < n) b++;
                        v0 = br.get(b); v1 = br.get(b); v2 = br.get(b);
                    }
                    int last = shared ? C : ch + 1;
                    for (int dch = shared ? 0 : ch; dch < last; dch++) {
                        uint16_t* q = q_f + (size_t)dch * 36 * 32;
                        q[(size_t)(row + 0) * 32 + sb] = (uint16_t)v0;
                        q[(size_t)(row + 1) * 32 + sb] = (uint16_t)v1;
                        q[(size_t)(row + 2) * 32 + sb] = (uint16_t)v2;
                    }
                }
            }
        }
        if (br.fail) return -1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// MP2/AHX host synthesis lane: dequantise + ISO synthesis filterbank +
// int16 rounding in one pass.  Factored V-FIFO form of the stacked matmul
// in ops/mp2_kernels.synthesize_np (same maths as ISO 11172-3 fig. A.2 /
// the reference decoder's windowed sum): per granule V = N @ S (64x32
// matrixing), then out[j] = sum_m D[64m+j]*V[t-2m][j]
//                                + D[64m+32+j]*V[t-2m-1][32+j]
// — 80 MACs/sample instead of synthesize_np's 512 (the stacked form
// re-derives the matrixing inside every window tap).
//
// Rounding contract: dequantisation replays numpy's exact op order
// ((2c+1-n)/n*sf elementwise), and both matrixing and window sums keep a
// fixed k-order / m-order accumulation with SEPARATE mul and add (no FMA),
// so the AVX2 twin, the scalar path, and -march variants all produce
// IDENTICAL bits; vs the numpy stacked matmul the factored form differs
// only in f64 association (~1e-15 relative), inside the package's 1-LSB
// engine fence (tests/test_ahx.py pins both engines to libmpg123).
//
//   codes  u16 [F, C, 36, 32]; levels i32 [F, C, 32]; sfidx u8 [F, C, 3, 32]
//   sf_table f64 [64] (mp2_tables.scalefactors)
//   nt     f64 [32][64]: synthesis matrixing N TRANSPOSED (nt[k][q]=N[q][k])
//   dwin   f64 [512]    (mp2_tables.synth_window)
//   pcm    i16 out [C, F*36*32]  (channel-major, like synthesize_np's input)
int32_t cri_mp2_synthesize(
    const uint16_t* codes, const int32_t* levels, const uint8_t* sfidx,
    int32_t F, int32_t C, const double* sf_table, const double* nt,
    const double* dwin, int16_t* pcm) {
    const int64_t T = (int64_t)F * 36;
    std::vector<double> ringbuf(16 * 64);
    double s[32], nlev[32], sfrow[3][32];
    for (int ch = 0; ch < C; ch++) {
        double* ring = ringbuf.data();
        std::memset(ring, 0, 16 * 64 * sizeof(double));
        int16_t* out = pcm + (size_t)ch * T * 32;
        for (int64_t t = 0; t < T; t++) {
            const int64_t f = t / 36;
            const int row = (int)(t % 36);
            if (row == 0) {          // per-frame dequant constants
                const int32_t* lv = levels + ((size_t)f * C + ch) * 32;
                const uint8_t* sfi = sfidx + ((size_t)f * C + ch) * 3 * 32;
                for (int sb = 0; sb < 32; sb++) {
                    nlev[sb] = lv[sb] > 0 ? (double)lv[sb] : 0.0;
                    for (int p = 0; p < 3; p++)
                        sfrow[p][sb] = sf_table[sfi[p * 32 + sb]];
                }
            }
            const uint16_t* cq = codes + (((size_t)f * C + ch) * 36
                                          + row) * 32;
            const double* sf = sfrow[row / 12];
            for (int sb = 0; sb < 32; sb++) {
                // numpy's exact elementwise order: ((2c + 1 - n) / n) * sf
                double n = nlev[sb];
                s[sb] = n > 0.0
                    ? ((2.0 * (double)cq[sb] + 1.0 - n) / n) * sf[sb]
                    : 0.0;
            }
            double* v = ring + (size_t)(t & 15) * 64;
#if defined(__AVX2__)
            {
                __m256d acc[16];
                const double* r0 = nt;
                __m256d sk = _mm256_set1_pd(s[0]);
                for (int q = 0; q < 16; q++)
                    acc[q] = _mm256_mul_pd(sk, _mm256_loadu_pd(r0 + q * 4));
                for (int k = 1; k < 32; k++) {
                    const double* rk = nt + (size_t)k * 64;
                    sk = _mm256_set1_pd(s[k]);
                    for (int q = 0; q < 16; q++)
                        acc[q] = _mm256_add_pd(acc[q],
                            _mm256_mul_pd(sk, _mm256_loadu_pd(rk + q * 4)));
                }
                for (int q = 0; q < 16; q++)
                    _mm256_storeu_pd(v + q * 4, acc[q]);
            }
#else
            for (int q = 0; q < 64; q++) v[q] = s[0] * nt[q];
            for (int k = 1; k < 32; k++) {
                const double* rk = nt + (size_t)k * 64;
                const double sk = s[k];
                for (int q = 0; q < 64; q++) v[q] += sk * rk[q];
            }
#endif
            // window: 8 even taps on V[t-2m][0:32], 8 odd on V[t-2m-1][32:64]
            double o[32];
#if defined(__AVX2__)
            {
                __m256d acc[8];
                const double* ve = ring + (size_t)(t & 15) * 64;
                for (int j = 0; j < 8; j++)
                    acc[j] = _mm256_mul_pd(_mm256_loadu_pd(dwin + j * 4),
                                           _mm256_loadu_pd(ve + j * 4));
                for (int m = 0; m < 8; m++) {
                    if (m) {
                        const double* vv = ring
                            + (size_t)((t - 2 * m) & 15) * 64;
                        const double* de = dwin + (size_t)m * 64;
                        for (int j = 0; j < 8; j++)
                            acc[j] = _mm256_add_pd(acc[j], _mm256_mul_pd(
                                _mm256_loadu_pd(de + j * 4),
                                _mm256_loadu_pd(vv + j * 4)));
                    }
                    const double* vo = ring
                        + (size_t)((t - 2 * m - 1) & 15) * 64 + 32;
                    const double* dd = dwin + (size_t)m * 64 + 32;
                    for (int j = 0; j < 8; j++)
                        acc[j] = _mm256_add_pd(acc[j], _mm256_mul_pd(
                            _mm256_loadu_pd(dd + j * 4),
                            _mm256_loadu_pd(vo + j * 4)));
                }
                for (int j = 0; j < 8; j++)
                    _mm256_storeu_pd(o + j * 4, acc[j]);
            }
#else
            for (int m = 0; m < 8; m++) {
                const double* vv = ring + (size_t)((t - 2 * m) & 15) * 64;
                const double* vo = ring
                    + (size_t)((t - 2 * m - 1) & 15) * 64 + 32;
                const double* de = dwin + (size_t)m * 64;
                const double* dd = de + 32;
                if (m == 0)
                    for (int j = 0; j < 32; j++) o[j] = de[j] * vv[j];
                else
                    for (int j = 0; j < 32; j++) o[j] += de[j] * vv[j];
                for (int j = 0; j < 32; j++) o[j] += dd[j] * vo[j];
            }
#endif
            int16_t* op = out + t * 32;
            for (int j = 0; j < 32; j++) {
                double y = std::floor(o[j] * 32768.0 + 0.5);
                if (y < -32768.0) y = -32768.0;
                if (y > 32767.0) y = 32767.0;
                op[j] = (int16_t)y;
            }
        }
    }
    return 0;
}

}  // extern "C"

