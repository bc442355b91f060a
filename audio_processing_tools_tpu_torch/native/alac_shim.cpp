// ALAC codec shim over libavcodec (C ABI, loaded via ctypes).
//
// The reference decodes firmware ALAC payloads by shelling out to the
// ffmpeg *binary* (reference parse.py:422-446).  This shim links the same
// decoder (libavcodec's ALAC implementation) in-process, so ingest works on
// hosts without an ffmpeg executable and without temp files.
//
// Exports:
//   apt_alac_decode  — decode concatenated ALAC packets (firmware magic
//                      cookie semantics) into int16 PCM
//   apt_alac_encode_frame — encode ONE <=frame_length-sample int16 frame
//                      into one ALAC packet (used by the fixture generator
//                      and the firmware-payload writer; ALAC frames are
//                      independent, so per-frame encoder instances are
//                      valid and each emitted packet carries an explicit
//                      sample count)
//   apt_alac_version — libavcodec version integer (0 if unavailable)
//
// Build: io/alac_native.py compiles this file at first use where
// -lavcodec -lavutil link, into build/.

#include <cstdint>
#include <cstring>
#include <string>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/opt.h>
}

namespace {

// 12-byte atom prefix (size + 'alac' + version/flags) that libavcodec's
// decoder expects in front of the 24-byte magic cookie.
void build_extradata(const uint8_t* cookie, int cookie_len, uint8_t* out) {
    std::memset(out, 0, 12);
    out[3] = static_cast<uint8_t>(12 + cookie_len);
    out[4] = 'a'; out[5] = 'l'; out[6] = 'a'; out[7] = 'c';
    std::memcpy(out + 12, cookie, cookie_len);
}

thread_local std::string g_error;

int64_t fail(const char* msg) {
    g_error = msg;
    return -1;
}

}  // namespace

extern "C" {

// Last error message for the calling thread ("" if none).
const char* apt_alac_last_error() { return g_error.c_str(); }

uint32_t apt_alac_version() { return avcodec_version(); }

// Decode `n_pkts` ALAC packets (payloads concatenated in `data`, sizes in
// `pkt_sizes`) using the 24-byte `cookie` for stream parameters. Writes up
// to `out_cap` int16 samples into `out`; returns the number written or a
// negative error.
int64_t apt_alac_decode(const uint8_t* cookie, int32_t cookie_len,
                        const uint8_t* data, const int32_t* pkt_sizes,
                        int32_t n_pkts, int16_t* out, int64_t out_cap) {
    g_error.clear();
    if (cookie_len < 24) return fail("magic cookie must be >= 24 bytes");

    const AVCodec* codec = avcodec_find_decoder(AV_CODEC_ID_ALAC);
    if (!codec) return fail("libavcodec has no ALAC decoder");
    AVCodecContext* ctx = avcodec_alloc_context3(codec);
    if (!ctx) return fail("avcodec_alloc_context3 failed");

    int64_t written = -1;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;

    ctx->extradata_size = 12 + cookie_len;
    ctx->extradata = static_cast<uint8_t*>(
        av_mallocz(ctx->extradata_size + AV_INPUT_BUFFER_PADDING_SIZE));
    if (!ctx->extradata) { avcodec_free_context(&ctx); return fail("oom"); }
    build_extradata(cookie, cookie_len, ctx->extradata);

    if (avcodec_open2(ctx, codec, nullptr) < 0) {
        avcodec_free_context(&ctx);
        return fail("avcodec_open2 failed (bad magic cookie?)");
    }

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame) { g_error = "oom"; goto done; }

    written = 0;
    {
        const uint8_t* p = data;
        for (int32_t i = 0; i < n_pkts; ++i) {
            const int32_t size = pkt_sizes[i];
            if (av_new_packet(pkt, size) < 0) {
                written = fail("av_new_packet failed");
                goto done;
            }
            std::memcpy(pkt->data, p, size);
            p += size;
            if (avcodec_send_packet(ctx, pkt) < 0) {
                av_packet_unref(pkt);
                written = fail("avcodec_send_packet failed (corrupt packet?)");
                goto done;
            }
            av_packet_unref(pkt);
            while (true) {
                const int r = avcodec_receive_frame(ctx, frame);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
                if (r < 0) { written = fail("avcodec_receive_frame failed"); goto done; }
                const int ns = frame->nb_samples;
                if (ctx->sample_fmt != AV_SAMPLE_FMT_S16P &&
                    ctx->sample_fmt != AV_SAMPLE_FMT_S16) {
                    av_frame_unref(frame);
                    written = fail("unexpected sample format (not 16-bit)");
                    goto done;
                }
                const int16_t* src =
                    reinterpret_cast<const int16_t*>(frame->extended_data[0]);
                const int64_t room = out_cap - written;
                const int64_t take = ns < room ? ns : room;
                if (take > 0) std::memcpy(out + written, src, take * 2);
                written += ns;  // report true total even if out_cap is short
                av_frame_unref(frame);
            }
        }
    }

done:
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&ctx);
    return written;
}

// Encode one int16 mono frame (n_samples <= frame_length) into a single
// ALAC packet. A fresh encoder instance is used per call, so the packet is
// a self-contained "partial frame" with an explicit sample count — exactly
// the firmware's 128-sample packet geometry when frame_length > n_samples
// is avoided by the caller chunking at 128.
//
// Returns the packet size written to `out` (capacity `out_cap`), or a
// negative error. If `cookie_out` is non-null, the encoder's 24-byte magic
// cookie is copied there (capacity must be >= 24).
int64_t apt_alac_encode_frame(const int16_t* pcm, int32_t n_samples,
                              int32_t sample_rate, uint8_t* out,
                              int64_t out_cap, uint8_t* cookie_out) {
    g_error.clear();
    const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_ALAC);
    if (!codec) return fail("libavcodec has no ALAC encoder");
    AVCodecContext* ctx = avcodec_alloc_context3(codec);
    if (!ctx) return fail("avcodec_alloc_context3 failed");

    int64_t result = -1;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int r = 0;

    ctx->sample_rate = sample_rate;
    ctx->sample_fmt = AV_SAMPLE_FMT_S16P;
#if LIBAVUTIL_VERSION_MAJOR >= 57
    av_channel_layout_default(&ctx->ch_layout, 1);
#else
    ctx->channels = 1;
    ctx->channel_layout = AV_CH_LAYOUT_MONO;
#endif
    // strict std so the encoder accepts any rate
    ctx->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;

    if (avcodec_open2(ctx, codec, nullptr) < 0) {
        avcodec_free_context(&ctx);
        return fail("avcodec_open2 (encoder) failed");
    }
    if (n_samples > ctx->frame_size) {
        avcodec_free_context(&ctx);
        return fail("n_samples exceeds encoder frame size");
    }
    if (cookie_out) {
        if (ctx->extradata_size < 36) {
            avcodec_free_context(&ctx);
            return fail("encoder extradata smaller than 36 bytes");
        }
        std::memcpy(cookie_out, ctx->extradata + 12, 24);
    }

    frame = av_frame_alloc();
    pkt = av_packet_alloc();
    if (!frame || !pkt) { g_error = "oom"; goto done; }
    frame->nb_samples = n_samples;
    frame->format = AV_SAMPLE_FMT_S16P;
#if LIBAVUTIL_VERSION_MAJOR >= 57
    av_channel_layout_default(&frame->ch_layout, 1);
#else
    frame->channels = 1;
    frame->channel_layout = AV_CH_LAYOUT_MONO;
#endif
    if (av_frame_get_buffer(frame, 0) < 0) { g_error = "frame alloc failed"; goto done; }
    std::memcpy(frame->data[0], pcm, static_cast<size_t>(n_samples) * 2);

    // one frame, then EOF: SMALL_LAST_FRAME lets n_samples < frame_size
    if (avcodec_send_frame(ctx, frame) < 0) { g_error = "send_frame failed"; goto done; }
    if (avcodec_send_frame(ctx, nullptr) < 0) { g_error = "flush failed"; goto done; }

    r = avcodec_receive_packet(ctx, pkt);
    if (r < 0) { g_error = "receive_packet failed"; goto done; }
    if (pkt->size > out_cap) { g_error = "output buffer too small"; goto done; }
    std::memcpy(out, pkt->data, pkt->size);
    result = pkt->size;

done:
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&ctx);
    return result;
}

}  // extern "C"
