// Fast in-process ALAC decoder (C ABI, no external dependencies).
//
// The reference ingests firmware ALAC payloads by shelling out to the ffmpeg
// binary (reference parse.py:422-446); the rebuild's first in-process route
// (native/alac_shim.cpp) drives libavcodec, which costs a fresh codec
// context per file plus an AVPacket round trip per 128-sample firmware
// packet — several microseconds of framework overhead per packet, more
// than half of the decode budget at the firmware's packet geometry (~873
// packets per 10 s clip at 11162 Hz).
//
// This file is a from-scratch ALAC bitstream decoder for the subset the
// firmware emits (mono, 16-bit, SCE elements) that decodes an entire
// BER-framed payload in ONE call with zero per-packet allocations.  It is
// validated bit-exactly against libavcodec's decoder by
// tests/test_alac.py::TestFastDecoder on randomized corpora; the libavcodec
// shim remains the differential oracle and the fallback for anything this
// decoder rejects (stereo, >16-bit).
//
// Bitstream layout implemented (ALACSpecificConfig / "magic cookie",
// mono single-channel-element frames):
//   cookie: frameLength u32be, compatibleVersion u8, bitDepth u8,
//           pb u8 (rice history mult), mb u8 (rice initial history),
//           kb u8 (rice limit), numChannels u8, maxRun u16be,
//           maxFrameBytes u32be, avgBitRate u32be, sampleRate u32be
//   frame:  element tag (3) | instance (4) | unused (12, must be 0) |
//           partial-frame flag (1) | bytes-shifted (2) | verbatim flag (1)
//           [sample count (32) when partial]
//           compressed: decorr shift (8) | decorr weight (8) |
//             prediction type (4) | lpc quant (4) | rice mult modifier (3) |
//             lpc order (5) | lpc coefs (16 signed each, stored reversed) |
//             [extra-bits plane] | adaptive-rice residuals
//           verbatim: raw bitDepth-bit signed samples
//
// Exports:
//   apt_alac_fast_decode          — same signature/semantics as the shim's
//                                   apt_alac_decode (drop-in)
//   apt_alac_fast_decode_payload  — BER packet walk + decode in one pass
//                                   (firmware stream framing, io/alac_native.py)
//   apt_alac_fast_version / apt_alac_fast_last_error
//
// Build: io/alac_native.py compiles this file at first use with
// `g++ -O3 -fPIC -shared -std=c++17` into build/ (no libavcodec required).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

int64_t fail(const char* msg) {
    g_error = msg;
    return -1;
}

inline int ilog2(uint32_t x) {  // av_log2 semantics: ilog2(0) == 0
    return x ? 31 - __builtin_clz(x) : 0;
}

inline int32_t sign_extend(int32_t v, int bits) {
    const int s = 32 - bits;
    return (int32_t)((uint32_t)v << s) >> s;
}

inline int sign_only(int v) { return (v > 0) - (v < 0); }

// MSB-first bit reader over a padded buffer (>= 8 readable bytes past the
// end; the decode entry points copy payloads into a padded scratch).
struct BitReader {
    const uint8_t* data;
    size_t pos;       // bit cursor
    size_t size_bits; // logical payload size (overrun check only)

    BitReader(const uint8_t* d, size_t nbytes)
        : data(d), pos(0), size_bits(nbytes * 8) {}

    inline uint64_t peek64() const {
        const uint8_t* p = data + (pos >> 3);
        uint64_t v;
        std::memcpy(&v, p, 8);
        v = __builtin_bswap64(v);
        return v << (pos & 7);
    }
    inline uint32_t peek(int n) const {  // n in [1, 32]
        return (uint32_t)(peek64() >> (64 - n));
    }
    inline void skip(int n) { pos += (size_t)n; }
    inline uint32_t get(int n) {
        const uint32_t v = peek(n);
        pos += (size_t)n;
        return v;
    }
    // count of consecutive 1-bits, capped at 9; consumes the terminating
    // 0-bit unless the cap was hit (get_unary(gb, 0, 9) semantics)
    inline uint32_t unary9() {
        const uint64_t v = peek64();
        uint32_t ones = (~v) ? (uint32_t)__builtin_clzll(~v) : 64;
        if (ones > 9) ones = 9;
        pos += (ones < 9) ? ones + 1 : 9;
        return ones;
    }
    inline bool overrun() const { return pos > size_bits; }
};

struct CookieParams {
    uint32_t frame_length;
    int bit_depth;
    int rice_history_mult;   // pb
    int rice_initial_history; // mb
    int rice_limit;          // kb
    int channels;
};

bool parse_cookie(const uint8_t* cookie, int32_t len, CookieParams* cp) {
    if (len < 24) return false;
    cp->frame_length = ((uint32_t)cookie[0] << 24) | ((uint32_t)cookie[1] << 16) |
                       ((uint32_t)cookie[2] << 8) | cookie[3];
    cp->bit_depth = cookie[5];
    cp->rice_history_mult = cookie[6];
    cp->rice_initial_history = cookie[7];
    cp->rice_limit = cookie[8];
    cp->channels = cookie[9];
    return cp->frame_length > 0 && cp->frame_length <= (1u << 20);
}

// Adaptive-rice residual decode (one channel plane).
inline uint32_t decode_scalar(BitReader& br, int k, int bps) {
    uint32_t x = br.unary9();
    if (x > 8) {
        x = br.get(bps);
    } else if (k != 1) {
        const uint32_t extra = br.peek(k);
        x = (x << k) - x;
        if (extra > 1) {
            x += extra - 1;
            br.skip(k);
        } else {
            br.skip(k - 1);
        }
    }
    return x;
}

void rice_decompress(BitReader& br, int32_t* out, int n, int bps,
                     int rice_history_mult, int initial_history,
                     int rice_limit) {
    uint32_t history = (uint32_t)initial_history;
    int sign_modifier = 0;
    for (int i = 0; i < n; i++) {
        int k = ilog2((history >> 9) + 3);
        if (k > rice_limit) k = rice_limit;
#ifdef APT_TRACE
        fprintf(stderr, "s i=%d pos=%zu hist=%u k=%d\n", i, br.pos, history, k);
#endif
        uint32_t x = decode_scalar(br, k, bps) + (uint32_t)sign_modifier;
        sign_modifier = 0;
        out[i] = (int32_t)((x >> 1) ^ (uint32_t)-(int32_t)(x & 1));

        if (x > 0xffff)
            history = 0xffff;
        else
            history += x * (uint32_t)rice_history_mult -
                       ((history * (uint32_t)rice_history_mult) >> 9);

        // compressed runs of zeros
        if (history < 128 && i + 1 < n) {
            k = 7 - ilog2(history) + (int)((history + 16) >> 6);
            if (k > rice_limit) k = rice_limit;
            const uint32_t block_size = decode_scalar(br, k, 16);
#ifdef APT_TRACE
            fprintf(stderr, "z i=%d pos=%zu bs=%u k=%d\n", i, br.pos, block_size, k);
#endif
            if (block_size > 0) {
                uint32_t bs = block_size;
                if (bs >= (uint32_t)(n - i)) bs = (uint32_t)(n - i - 1);
                std::memset(out + i + 1, 0, bs * sizeof(int32_t));
                i += (int)bs;
            }
            if (block_size <= 0xffff) sign_modifier = 1;
            history = 0;
        }
    }
}

// Adaptive-LPC reconstruction (in-place capable: out may alias err).
void lpc_prediction(const int32_t* err, int32_t* out, int n, int bps,
                    int16_t* coefs, int order, int quant) {
    out[0] = err[0];
    if (n <= 1) return;
    if (order == 0) {
        if (out != err) std::memmove(out + 1, err + 1, (size_t)(n - 1) * 4);
        return;
    }
    if (order == 31) {  // plain first-order accumulation
        for (int i = 1; i < n; i++)
            out[i] = sign_extend(out[i - 1] + err[i], bps);
        return;
    }
    int i;
    for (i = 1; i <= order && i < n; i++)
        out[i] = sign_extend(out[i - 1] + err[i], bps);

    const int32_t* pred = out;
    for (; i < n; i++) {
        int error_val = err[i];
        const int32_t d = *pred++;
        int64_t val = 0;
        for (int j = 0; j < order; j++)
            val += (int64_t)(pred[j] - d) * coefs[j];
        int32_t v = (int32_t)((val + (1 << (quant - 1))) >> quant);
        out[i] = sign_extend(v + d + error_val, bps);

        const int error_sign = sign_only(error_val);
        if (error_sign) {
            for (int j = 0; j < order && error_val * error_sign > 0; j++) {
                int32_t dv = d - pred[j];
                const int sign = sign_only(dv) * error_sign;
                coefs[j] -= (int16_t)sign;
                dv *= sign;
                error_val -= (int)((dv >> quant) * (j + 1));
            }
        }
    }
}

struct Scratch {
    std::vector<int32_t> resid;
    std::vector<int32_t> extra;
    std::vector<uint8_t> padded;
};

thread_local Scratch g_scratch;

// Decode one mono SCE frame. Returns samples produced, or negative error.
int64_t decode_frame(BitReader& br, const CookieParams& cp, int16_t* out,
                     int64_t room) {
    const uint32_t element = br.get(3);
    // 0 = SCE; 3 = LFE (decodes identically to SCE — libavcodec accepts it
    // as a mono element, so match that)
    if (element != 0 && element != 3)
        return fail("fast decoder supports mono SCE/LFE frames only");
    br.skip(4);  // instance tag
    if (br.get(12) != 0) return fail("nonzero unused header bits");
    const bool partial = br.get(1);
    const int bytes_shifted = (int)br.get(2);
    if (bytes_shifted == 3) return fail("invalid bytes-shifted value");
    const bool verbatim = br.get(1);
    uint32_t n = partial ? br.get(32) : cp.frame_length;
    if (n == 0) return 0;
    if (n > cp.frame_length) return fail("frame sample count exceeds cookie frame length");

    const int extra_bits = bytes_shifted * 8;
    Scratch& s = g_scratch;
    if (s.resid.size() < n) {
        s.resid.resize(n);
        s.extra.resize(n);
    }
    int32_t* buf = s.resid.data();

    if (!verbatim) {
        br.skip(16);  // decorrelation shift + weight (unused for mono)
        const int pred_type = (int)br.get(4);
        const int lpc_quant = (int)br.get(4);
        const int rice_mult_mod = (int)br.get(3);
        const int lpc_order = (int)br.get(5);
        if ((uint32_t)lpc_order >= cp.frame_length)
            return fail("lpc order exceeds frame length");
        int16_t coefs[32];
        for (int j = lpc_order - 1; j >= 0; j--)
            coefs[j] = (int16_t)sign_extend((int32_t)br.get(16), 16);

        int32_t* extra_plane = s.extra.data();
        if (extra_bits) {
            for (uint32_t i = 0; i < n; i++)
                extra_plane[i] = (int32_t)br.get(extra_bits);
        }

        const int bps = cp.bit_depth - extra_bits + cp.channels - 1;
        rice_decompress(br, buf, (int)n, bps,
                        cp.rice_history_mult * rice_mult_mod / 4,
                        cp.rice_initial_history, cp.rice_limit);
        if (pred_type == 15) {
            // fixed-predictor pre-pass: first-order integrate the residuals
            lpc_prediction(buf, buf, (int)n, bps, nullptr, 31, 0);
        } else if (pred_type != 0) {
            return fail("unknown prediction type");
        }
        lpc_prediction(buf, buf, (int)n, bps, coefs, lpc_order, lpc_quant);
        if (extra_bits) {
            for (uint32_t i = 0; i < n; i++)
                buf[i] = (int32_t)(((uint32_t)buf[i] << extra_bits) |
                                   (uint32_t)extra_plane[i]);
        }
    } else {
        for (uint32_t i = 0; i < n; i++)
            buf[i] = sign_extend((int32_t)br.get(cp.bit_depth), cp.bit_depth);
    }

    if (br.overrun()) return fail("bitstream overrun (corrupt packet?)");

    const int64_t take = (int64_t)n < room ? (int64_t)n : room;
    for (int64_t i = 0; i < take; i++) out[i] = (int16_t)buf[i];
    return (int64_t)n;
}

int64_t decode_packets(const CookieParams& cp, const uint8_t* data,
                       const int32_t* pkt_sizes, int32_t n_pkts, int16_t* out,
                       int64_t out_cap) {
    // one padded copy of the whole stream so the 64-bit reader may overread
    int64_t total_bytes = 0;
    for (int32_t i = 0; i < n_pkts; i++) {
        if (pkt_sizes[i] < 0) return fail("negative packet size");
        total_bytes += pkt_sizes[i];
    }
    Scratch& s = g_scratch;
    if (s.padded.size() < (size_t)total_bytes + 16)
        s.padded.resize((size_t)total_bytes + 16);
    std::memcpy(s.padded.data(), data, (size_t)total_bytes);
    std::memset(s.padded.data() + total_bytes, 0, 16);

    const uint8_t* p = s.padded.data();
    int64_t written = 0;
    for (int32_t i = 0; i < n_pkts; i++) {
        BitReader br(p, (size_t)pkt_sizes[i]);
        const int64_t n = decode_frame(br, cp, out + written,
                                       out_cap > written ? out_cap - written : 0);
        if (n < 0) return n;
        written += n;
        p += pkt_sizes[i];
    }
    return written;
}

}  // namespace

extern "C" {

const char* apt_alac_fast_last_error() { return g_error.c_str(); }

uint32_t apt_alac_fast_version() { return 1; }

// Drop-in for apt_alac_decode (native/alac_shim.cpp): decode `n_pkts`
// concatenated ALAC packets into int16 PCM. Returns samples written (the
// true total even when it exceeds out_cap) or a negative error.
int64_t apt_alac_fast_decode(const uint8_t* cookie, int32_t cookie_len,
                             const uint8_t* data, const int32_t* pkt_sizes,
                             int32_t n_pkts, int16_t* out, int64_t out_cap) {
    g_error.clear();
    CookieParams cp;
    if (!parse_cookie(cookie, cookie_len, &cp))
        return fail("magic cookie must be >= 24 bytes with a sane frame length");
    if (cp.channels != 1) return fail("fast decoder supports mono only");
    if (cp.bit_depth != 16) return fail("fast decoder supports 16-bit only");
    return decode_packets(cp, data, pkt_sizes, n_pkts, out, out_cap);
}

// Decode a whole firmware BER-framed ALAC stream (the MARK payload layout
// walked by io/alac_native.py::split_ber_packets) in one pass: skip an
// optional duplicated MARK header (magic AD FB CA DE + 36 bytes), then
// repeat [3-byte packet header:
// BER size canonical-first padded to 2 bytes + 1 byte BER length][packet].
int64_t apt_alac_fast_decode_payload(const uint8_t* cookie, int32_t cookie_len,
                                     const uint8_t* payload, int64_t payload_len,
                                     int16_t* out, int64_t out_cap) {
    g_error.clear();
    CookieParams cp;
    if (!parse_cookie(cookie, cookie_len, &cp))
        return fail("magic cookie must be >= 24 bytes with a sane frame length");
    if (cp.channels != 1) return fail("fast decoder supports mono only");
    if (cp.bit_depth != 16) return fail("fast decoder supports 16-bit only");

    int64_t off = 0;
    if (payload_len >= 4 && payload[0] == 0xAD && payload[1] == 0xFB &&
        payload[2] == 0xCA && payload[3] == 0xDE)
        off = 4 + 36;

    // padded copy (see decode_packets)
    Scratch& s = g_scratch;
    const int64_t body = payload_len > off ? payload_len - off : 0;
    if (s.padded.size() < (size_t)body + 16) s.padded.resize((size_t)body + 16);
    std::memcpy(s.padded.data(), payload + off, (size_t)body);
    std::memset(s.padded.data() + body, 0, 16);

    const uint8_t* base = s.padded.data();
    int64_t pos = 0, written = 0;
    while (pos + 3 <= body) {
        // read_ber_integer(hdr, 2) over the first 2 header bytes (io/alac_native.py)
        int64_t size = 0;
        const uint8_t b0 = base[pos];
        if (b0 & 0x80) {
            size = ((int64_t)(b0 & 0x7F) << 7) | (base[pos + 1] & 0x7F);
        } else {
            size = b0 & 0x7F;
        }
        pos += 3;
        if (pos + size > body) break;  // truncated trailing packet: stop
        BitReader br(base + pos, (size_t)size);
        const int64_t n = decode_frame(br, cp, out + written,
                                       out_cap > written ? out_cap - written : 0);
        if (n < 0) return n;
        written += n;
        pos += size;
    }
    return written;
}

}  // extern "C"
