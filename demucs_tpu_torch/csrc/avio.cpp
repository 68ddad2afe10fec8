// A thin C shim over libavformat/libavcodec (port of native/avio.cpp).
//
// Two uses: the any-format decode of read_audio and AudioFile (ogg, m4a,
// multi-stream .mp4, ...) where the ffmpeg binary is absent, with the same
// codec implementations the reference reaches through its ffmpeg subprocess
// (demucs/audio.py:28-140); and an independent oracle that the tests hold
// the port's own FLAC and mp3 codecs against.
//
// Flat C ABI, loaded with ctypes (demucs_tpu_torch/avio.py, which builds this
// file with g++ through demucs_tpu_torch/native.py). No pybind11.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>

namespace {

struct LogQuiet {
    LogQuiet() { av_log_set_level(AV_LOG_ERROR); }
} log_quiet_once;

void set_err(char* err, int errlen, const char* msg, int code = 0) {
    if (!err || errlen <= 0) return;
    if (code != 0) {
        char buf[128];
        av_strerror(code, buf, sizeof(buf));
        snprintf(err, errlen, "%s: %s", msg, buf);
    } else {
        snprintf(err, errlen, "%s", msg);
    }
}

// Append one decoded frame as interleaved samples. Integer formats widen to
// int32 verbatim (no rescale — exactness is the point); float formats store
// float32 bits in the same int32 buffer (caller reinterprets via *fmt).
// A frame whose channel count or sample format is not the stream's (a
// malformed or chained file that changes them mid-stream) is refused before
// anything is read: a planar frame with fewer channels has no plane
// extended_data[c] to read.
bool append_frame(const AVFrame* f, int channels, int format, bool as_float,
                  std::vector<int32_t>& out) {
    if (f->ch_layout.nb_channels != channels || f->format != format) return false;
    const int n = f->nb_samples;
    const size_t base = out.size();
    out.resize(base + (size_t)n * channels);
    int32_t* dst = out.data() + base;
    switch (f->format) {
    case AV_SAMPLE_FMT_S16: {
        const int16_t* src = (const int16_t*)f->extended_data[0];
        for (int i = 0; i < n * channels; i++) dst[i] = src[i];
        return !as_float;
    }
    case AV_SAMPLE_FMT_S16P:
        for (int c = 0; c < channels; c++) {
            const int16_t* src = (const int16_t*)f->extended_data[c];
            for (int i = 0; i < n; i++) dst[i * channels + c] = src[i];
        }
        return !as_float;
    case AV_SAMPLE_FMT_S32: {
        const int32_t* src = (const int32_t*)f->extended_data[0];
        memcpy(dst, src, sizeof(int32_t) * n * channels);
        return !as_float;
    }
    case AV_SAMPLE_FMT_S32P:
        for (int c = 0; c < channels; c++) {
            const int32_t* src = (const int32_t*)f->extended_data[c];
            for (int i = 0; i < n; i++) dst[i * channels + c] = src[i];
        }
        return !as_float;
    case AV_SAMPLE_FMT_FLT: {
        memcpy(dst, f->extended_data[0], sizeof(float) * n * channels);
        return as_float;
    }
    case AV_SAMPLE_FMT_FLTP: {
        float* fdst = (float*)dst;
        for (int c = 0; c < channels; c++) {
            const float* src = (const float*)f->extended_data[c];
            for (int i = 0; i < n; i++) fdst[i * channels + c] = src[i];
        }
        return as_float;
    }
    case AV_SAMPLE_FMT_DBL: {
        float* fdst = (float*)dst;
        const double* src = (const double*)f->extended_data[0];
        for (int i = 0; i < n * channels; i++) fdst[i] = (float)src[i];
        return as_float;
    }
    case AV_SAMPLE_FMT_DBLP: {
        float* fdst = (float*)dst;
        for (int c = 0; c < channels; c++) {
            const double* src = (const double*)f->extended_data[c];
            for (int i = 0; i < n; i++) fdst[i * channels + c] = (float)src[i];
        }
        return as_float;
    }
    case AV_SAMPLE_FMT_U8: {
        const uint8_t* src = (const uint8_t*)f->extended_data[0];
        for (int i = 0; i < n * channels; i++) dst[i] = (int32_t)src[i] - 128;
        return !as_float;
    }
    case AV_SAMPLE_FMT_U8P:
        for (int c = 0; c < channels; c++) {
            const uint8_t* src = (const uint8_t*)f->extended_data[c];
            for (int i = 0; i < n; i++)
                dst[i * channels + c] = (int32_t)src[i] - 128;
        }
        return !as_float;
    default:
        return false;
    }
}

bool fmt_is_float(int fmt) {
    return fmt == AV_SAMPLE_FMT_FLT || fmt == AV_SAMPLE_FMT_FLTP ||
           fmt == AV_SAMPLE_FMT_DBL || fmt == AV_SAMPLE_FMT_DBLP;
}

}  // namespace

extern "C" {

void avio_free(void* p) { av_free(p); }

// Decode the first audio stream of `path` entirely.
//   *out      -> av_malloc'd interleaved buffer (free with avio_free)
//   *fmt      -> 0: int32 samples (verbatim decoder values), 1: float32
//   *bits     -> bits_per_raw_sample if known, else container bit width
//   *container-> sample container width (16 or 32): integer decoders
//                left-justify raw samples in the container, so full-scale
//                normalization divides by 2^(container-1)
//   stream_ordinal: which AUDIO stream to decode (0-based among audio
//   streams), or -1 for libavformat's "best" pick.
// Returns 0 on success, negative on error (message in err).
int avio_decode_stream(const char* path, int stream_ordinal, void** out,
                       long long* frames, int* channels, int* samplerate,
                       int* fmt, int* bits, int* container,
                       char* err, int errlen) {
    AVFormatContext* ic = nullptr;
    AVCodecContext* ctx = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int ret = avformat_open_input(&ic, path, nullptr, nullptr);
    if (ret < 0) { set_err(err, errlen, "open_input", ret); return -1; }
    int rc = -1;
    do {
        ret = avformat_find_stream_info(ic, nullptr);
        if (ret < 0) { set_err(err, errlen, "find_stream_info", ret); break; }
        const AVCodec* dec = nullptr;
        int si = -1;
        if (stream_ordinal < 0) {
            si = av_find_best_stream(ic, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
        } else {
            int seen = 0;
            for (unsigned i = 0; i < ic->nb_streams; i++) {
                if (ic->streams[i]->codecpar->codec_type == AVMEDIA_TYPE_AUDIO
                    && seen++ == stream_ordinal) { si = (int)i; break; }
            }
            if (si >= 0)
                dec = avcodec_find_decoder(ic->streams[si]->codecpar->codec_id);
        }
        if (si < 0 || !dec) { set_err(err, errlen, "no such audio stream"); break; }
        AVStream* st = ic->streams[si];
        ctx = avcodec_alloc_context3(dec);
        if (!ctx) { set_err(err, errlen, "alloc codec ctx"); break; }
        ret = avcodec_parameters_to_context(ctx, st->codecpar);
        if (ret < 0) { set_err(err, errlen, "params_to_context", ret); break; }
        ret = avcodec_open2(ctx, dec, nullptr);
        if (ret < 0) { set_err(err, errlen, "codec open", ret); break; }

        const int ch = ctx->ch_layout.nb_channels;
        if (ch <= 0) { set_err(err, errlen, "bad channel count"); break; }
        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        std::vector<int32_t> buf;
        bool decided = false, as_float = false, ok = true, changed = false;
        int format = AV_SAMPLE_FMT_NONE;  // the stream's: its first frame's
        auto drain = [&]() {
            while (true) {
                int r = avcodec_receive_frame(ctx, frame);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
                if (r < 0) return false;
                if (!decided) {
                    format = frame->format;
                    as_float = fmt_is_float(format);
                    decided = true;
                }
                if (!append_frame(frame, ch, format, as_float, buf)) {
                    changed = frame->ch_layout.nb_channels != ch || frame->format != format;
                    return false;
                }
            }
        };
        while ((ret = av_read_frame(ic, pkt)) >= 0) {
            if (pkt->stream_index == si) {
                if (avcodec_send_packet(ctx, pkt) < 0 || !drain()) {
                    ok = false; av_packet_unref(pkt); break;
                }
            }
            av_packet_unref(pkt);
        }
        if (ok) {
            avcodec_send_packet(ctx, nullptr);  // flush
            ok = drain();
        }
        if (!ok) {
            set_err(err, errlen, changed
                ? "decode failed: the channel count or sample format changed mid-stream"
                : "decode failed");
            break;
        }
        if (buf.empty()) { set_err(err, errlen, "no samples decoded"); break; }

        void* mem = av_malloc(buf.size() * sizeof(int32_t));
        if (!mem) { set_err(err, errlen, "oom"); break; }
        memcpy(mem, buf.data(), buf.size() * sizeof(int32_t));
        *out = mem;
        *frames = (long long)(buf.size() / ch);
        *channels = ch;
        *samplerate = ctx->sample_rate;
        *fmt = as_float ? 1 : 0;
        const int cont = as_float ? 32
            : (ctx->sample_fmt == AV_SAMPLE_FMT_U8 ||
               ctx->sample_fmt == AV_SAMPLE_FMT_U8P) ? 8
            : (ctx->sample_fmt == AV_SAMPLE_FMT_S16 ||
               ctx->sample_fmt == AV_SAMPLE_FMT_S16P) ? 16 : 32;
        int b = ctx->bits_per_raw_sample;
        if (b == 0) b = cont;
        *bits = b;
        *container = cont;
        rc = 0;
    } while (false);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    avformat_close_input(&ic);
    return rc;
}

// Probe container metadata without decoding.
//   meta: per audio stream, 3 long longs: channels, samplerate, frame-count
//         estimate (stream duration in samples; 0 if unknown).
//   *duration_seconds: container-level duration (<0 if unknown).
// Returns the number of audio streams (clamped to max_streams written).
int avio_probe(const char* path, long long* meta, int max_streams,
               double* duration_seconds, char* err, int errlen) {
    AVFormatContext* ic = nullptr;
    int ret = avformat_open_input(&ic, path, nullptr, nullptr);
    if (ret < 0) { set_err(err, errlen, "open_input", ret); return -1; }
    ret = avformat_find_stream_info(ic, nullptr);
    if (ret < 0) {
        set_err(err, errlen, "find_stream_info", ret);
        avformat_close_input(&ic);
        return -1;
    }
    *duration_seconds = ic->duration > 0
        ? (double)ic->duration / AV_TIME_BASE : -1.0;
    int count = 0;
    for (unsigned i = 0; i < ic->nb_streams; i++) {
        const AVStream* st = ic->streams[i];
        if (st->codecpar->codec_type != AVMEDIA_TYPE_AUDIO) continue;
        if (count < max_streams) {
            long long nframes = 0;
            if (st->duration > 0 && st->time_base.den > 0)
                nframes = av_rescale(st->duration,
                                     (long long)st->codecpar->sample_rate
                                         * st->time_base.num,
                                     st->time_base.den);
            meta[3 * count + 0] = st->codecpar->ch_layout.nb_channels;
            meta[3 * count + 1] = st->codecpar->sample_rate;
            meta[3 * count + 2] = nframes;
        }
        count++;
    }
    avformat_close_input(&ic);
    return count;
}

// Encode interleaved PCM to a FLAC file with libavcodec's encoder.
//   pcm: int32 samples; 16-bit values for bits==16, 24-bit values for
//   bits==24 (the shim shifts into the S32 container as the encoder
//   expects). compression_level: 0..12 (ffmpeg's -compression_level).
int avio_encode_flac(const char* path, const int32_t* pcm, long long frames,
                     int channels, int samplerate, int bits,
                     int compression_level, char* err, int errlen) {
    if (bits != 16 && bits != 24) { set_err(err, errlen, "bits must be 16/24"); return -1; }
    AVFormatContext* oc = nullptr;
    AVCodecContext* ctx = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int ret = avformat_alloc_output_context2(&oc, nullptr, "flac", path);
    if (ret < 0 || !oc) { set_err(err, errlen, "alloc output", ret); return -1; }
    int rc = -1;
    bool opened_io = false;
    do {
        const AVCodec* enc = avcodec_find_encoder(AV_CODEC_ID_FLAC);
        if (!enc) { set_err(err, errlen, "no FLAC encoder"); break; }
        AVStream* st = avformat_new_stream(oc, nullptr);
        if (!st) { set_err(err, errlen, "new stream"); break; }
        ctx = avcodec_alloc_context3(enc);
        if (!ctx) { set_err(err, errlen, "alloc codec ctx"); break; }
        ctx->sample_rate = samplerate;
        av_channel_layout_default(&ctx->ch_layout, channels);
        ctx->sample_fmt = bits == 16 ? AV_SAMPLE_FMT_S16 : AV_SAMPLE_FMT_S32;
        ctx->bits_per_raw_sample = bits;
        ctx->compression_level = compression_level;
        ctx->time_base = AVRational{1, samplerate};
        if (oc->oformat->flags & AVFMT_GLOBALHEADER)
            ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        ret = avcodec_open2(ctx, enc, nullptr);
        if (ret < 0) { set_err(err, errlen, "codec open", ret); break; }
        ret = avcodec_parameters_from_context(st->codecpar, ctx);
        if (ret < 0) { set_err(err, errlen, "params_from_context", ret); break; }
        st->time_base = ctx->time_base;
        ret = avio_open(&oc->pb, path, AVIO_FLAG_WRITE);
        if (ret < 0) { set_err(err, errlen, "file open", ret); break; }
        opened_io = true;
        ret = avformat_write_header(oc, nullptr);
        if (ret < 0) { set_err(err, errlen, "write_header", ret); break; }

        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        const int step = ctx->frame_size > 0 ? ctx->frame_size : 4096;
        bool ok = true;
        auto pump = [&]() {
            while (true) {
                int r = avcodec_receive_packet(ctx, pkt);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
                if (r < 0) return false;
                av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
                pkt->stream_index = st->index;
                if (av_interleaved_write_frame(oc, pkt) < 0) return false;
            }
        };
        long long pos = 0;
        while (pos < frames && ok) {
            const int n = (int)((frames - pos) < step ? (frames - pos) : step);
            frame->nb_samples = n;
            frame->format = ctx->sample_fmt;
            av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
            frame->sample_rate = samplerate;
            if (av_frame_get_buffer(frame, 0) < 0) { ok = false; break; }
            if (bits == 16) {
                int16_t* dst = (int16_t*)frame->extended_data[0];
                for (long long i = 0; i < (long long)n * channels; i++)
                    dst[i] = (int16_t)pcm[pos * channels + i];
            } else {
                int32_t* dst = (int32_t*)frame->extended_data[0];
                for (long long i = 0; i < (long long)n * channels; i++)
                    dst[i] = pcm[pos * channels + i] << 8;  // 24-in-32, high
            }
            frame->pts = pos;
            ok = avcodec_send_frame(ctx, frame) >= 0 && pump();
            av_frame_unref(frame);
            pos += n;
        }
        if (ok) ok = avcodec_send_frame(ctx, nullptr) >= 0 && pump();
        if (!ok) { set_err(err, errlen, "encode failed"); break; }
        ret = av_write_trailer(oc);
        if (ret < 0) { set_err(err, errlen, "write_trailer", ret); break; }
        rc = 0;
    } while (false);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    if (opened_io) avio_closep(&oc->pb);
    avformat_free_context(oc);
    return rc;
}

// Multi-stream encode: write `nstreams` parallel audio streams (the
// reference's .stem.mp4 shape) into one container with the named encoder.
// `pcm` holds nstreams consecutive blocks of frames*channels interleaved
// normalized float32 samples. The single-stream avio_encode delegates here.
int avio_encode_multi(const char* path, const char* codec_name,
                      const float* pcm, int nstreams, long long frames,
                      int channels, int samplerate, long long bitrate,
                      char* err, int errlen) {
    if (nstreams < 1) { set_err(err, errlen, "nstreams must be >= 1"); return -1; }
    AVFormatContext* oc = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    std::vector<AVCodecContext*> ctxs(nstreams, nullptr);
    std::vector<AVStream*> sts(nstreams, nullptr);
    int ret = avformat_alloc_output_context2(&oc, nullptr, nullptr, path);
    if (ret < 0 || !oc) { set_err(err, errlen, "alloc output", ret); return -1; }
    int rc = -1;
    bool opened_io = false;
    do {
        const AVCodec* enc = avcodec_find_encoder_by_name(codec_name);
        if (!enc) { set_err(err, errlen, "encoder not found"); break; }
        // first supported format from a fidelity-ordered preference list
        static const AVSampleFormat prefs[] = {
            AV_SAMPLE_FMT_FLT, AV_SAMPLE_FMT_FLTP, AV_SAMPLE_FMT_S32,
            AV_SAMPLE_FMT_S32P, AV_SAMPLE_FMT_S16, AV_SAMPLE_FMT_S16P};
        AVSampleFormat fmt = AV_SAMPLE_FMT_NONE;
        if (enc->sample_fmts) {
            for (AVSampleFormat p : prefs) {
                for (const AVSampleFormat* f = enc->sample_fmts;
                     *f != AV_SAMPLE_FMT_NONE && fmt == AV_SAMPLE_FMT_NONE; f++)
                    if (*f == p) fmt = p;
                if (fmt != AV_SAMPLE_FMT_NONE) break;
            }
        }
        if (fmt == AV_SAMPLE_FMT_NONE) fmt = AV_SAMPLE_FMT_FLTP;

        bool ok = true;
        for (int s = 0; s < nstreams && ok; s++) {
            sts[s] = avformat_new_stream(oc, nullptr);
            AVCodecContext* ctx = avcodec_alloc_context3(enc);
            ctxs[s] = ctx;
            if (!sts[s] || !ctx) { set_err(err, errlen, "alloc stream"); ok = false; break; }
            ctx->sample_rate = samplerate;
            av_channel_layout_default(&ctx->ch_layout, channels);
            ctx->sample_fmt = fmt;
            if (bitrate > 0) ctx->bit_rate = bitrate;
            ctx->time_base = AVRational{1, samplerate};
            ctx->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
            if (oc->oformat->flags & AVFMT_GLOBALHEADER)
                ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
            ret = avcodec_open2(ctx, enc, nullptr);
            if (ret < 0) { set_err(err, errlen, "codec open", ret); ok = false; break; }
            ret = avcodec_parameters_from_context(sts[s]->codecpar, ctx);
            if (ret < 0) { set_err(err, errlen, "params_from_context", ret); ok = false; break; }
            sts[s]->time_base = ctx->time_base;
        }
        if (!ok) break;
        ret = avio_open(&oc->pb, path, AVIO_FLAG_WRITE);
        if (ret < 0) { set_err(err, errlen, "file open", ret); break; }
        opened_io = true;
        ret = avformat_write_header(oc, nullptr);
        if (ret < 0) { set_err(err, errlen, "write_header", ret); break; }

        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        const int step = ctxs[0]->frame_size > 0 ? ctxs[0]->frame_size : 4096;
        auto pump = [&](int s) {
            while (true) {
                int r = avcodec_receive_packet(ctxs[s], pkt);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
                if (r < 0) return false;
                av_packet_rescale_ts(pkt, ctxs[s]->time_base, sts[s]->time_base);
                pkt->stream_index = sts[s]->index;
                if (av_interleaved_write_frame(oc, pkt) < 0) return false;
            }
        };
        auto fill = [&](const float* src, int n) -> bool {
            switch (fmt) {
            case AV_SAMPLE_FMT_FLT:
                memcpy(frame->extended_data[0], src, sizeof(float) * n * channels);
                return true;
            case AV_SAMPLE_FMT_FLTP:
                for (int c = 0; c < channels; c++) {
                    float* dst = (float*)frame->extended_data[c];
                    for (int i = 0; i < n; i++) dst[i] = src[i * channels + c];
                }
                return true;
            case AV_SAMPLE_FMT_S16: {
                int16_t* dst = (int16_t*)frame->extended_data[0];
                for (long long i = 0; i < (long long)n * channels; i++)
                    dst[i] = (int16_t)lrintf(src[i] * 32767.0f);
                return true;
            }
            case AV_SAMPLE_FMT_S16P:
                for (int c = 0; c < channels; c++) {
                    int16_t* dst = (int16_t*)frame->extended_data[c];
                    for (int i = 0; i < n; i++)
                        dst[i] = (int16_t)lrintf(src[i * channels + c] * 32767.0f);
                }
                return true;
            case AV_SAMPLE_FMT_S32: {
                int32_t* dst = (int32_t*)frame->extended_data[0];
                for (long long i = 0; i < (long long)n * channels; i++)
                    dst[i] = (int32_t)lrintf(src[i] * 2147483520.0f);
                return true;
            }
            case AV_SAMPLE_FMT_S32P:
                for (int c = 0; c < channels; c++) {
                    int32_t* dst = (int32_t*)frame->extended_data[c];
                    for (int i = 0; i < n; i++)
                        dst[i] = (int32_t)lrintf(src[i * channels + c] * 2147483520.0f);
                }
                return true;
            default:
                return false;
            }
        };
        long long pos = 0;
        while (pos < frames && ok) {
            const int n = (int)((frames - pos) < step ? (frames - pos) : step);
            for (int s = 0; s < nstreams && ok; s++) {
                frame->nb_samples = n;
                frame->format = fmt;
                av_channel_layout_copy(&frame->ch_layout, &ctxs[s]->ch_layout);
                frame->sample_rate = samplerate;
                if (av_frame_get_buffer(frame, 0) < 0) { ok = false; break; }
                const float* src = pcm
                    + (long long)s * frames * channels + pos * channels;
                ok = fill(src, n);
                if (ok) {
                    frame->pts = pos;
                    ok = avcodec_send_frame(ctxs[s], frame) >= 0 && pump(s);
                }
                av_frame_unref(frame);
            }
            pos += n;
        }
        for (int s = 0; s < nstreams && ok; s++)
            ok = avcodec_send_frame(ctxs[s], nullptr) >= 0 && pump(s);
        if (!ok) { set_err(err, errlen, "encode failed"); break; }
        ret = av_write_trailer(oc);
        if (ret < 0) { set_err(err, errlen, "write_trailer", ret); break; }
        rc = 0;
    } while (false);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    for (AVCodecContext* ctx : ctxs)
        if (ctx) avcodec_free_context(&ctx);
    if (opened_io) avio_closep(&oc->pb);
    avformat_free_context(oc);
    return rc;
}

// Encode normalized float32 interleaved PCM with an arbitrary named
// libavcodec encoder (muxer guessed from the path extension) — used by the
// tests to synthesize ogg/m4a/... inputs for read_audio's any-format
// fallback. bitrate==0 leaves the encoder default.
int avio_encode(const char* path, const char* codec_name, const float* pcm,
                long long frames, int channels, int samplerate,
                long long bitrate, char* err, int errlen) {
    return avio_encode_multi(path, codec_name, pcm, 1, frames, channels,
                             samplerate, bitrate, err, errlen);
}

}  // extern "C"
