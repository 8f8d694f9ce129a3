// Native video decoder on the host (a copy of the JAX package's
// native/video_decode.cc; it stands in for the reference's decord C++
// dependency).  Demux/decode via libavformat/libavcodec, color-convert
// + resize via libswscale — the same libraries decord wraps — exposed as a
// plain C ABI loaded with ctypes.
//
// Contract (mirrors what the Python loader needs):
//   ov_probe(path, &n_frames, &fps, &w, &h)
//       exact frame count (container metadata when trustworthy, else a
//       packet-count pass — no decode), average fps, native geometry.
//   ov_decode_window(path, start, count, out_w, out_h, out)
//       decode frames [start, start+count), scaled to out_w x out_h RGB24,
//       written contiguously to `out` (count*out_h*out_w*3 bytes).  Frames
//       before `start` are decoded but NOT color-converted/scaled (the
//       expensive half for palette GIF / yuv420 -> RGB).  Returns frames
//       written, or a negative AVERROR.
//
// ctypes releases the GIL for the whole call, so thread-pool DataLoader
// workers scale across cores without the process-pool IPC cost.

#include <cstdint>
#include <cstring>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct Reader {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    int vs = -1;

    ~Reader() {
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
    }

    int open(const char* path, bool with_decoder) {
        int err = avformat_open_input(&fmt, path, nullptr, nullptr);
        if (err < 0) return err;
        err = avformat_find_stream_info(fmt, nullptr);
        if (err < 0) return err;
        const AVCodec* codec = nullptr;
        vs = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
        if (vs < 0) return vs;
        if (!with_decoder) return 0;
        if (!codec) return AVERROR_DECODER_NOT_FOUND;
        dec = avcodec_alloc_context3(codec);
        if (!dec) return AVERROR(ENOMEM);
        err = avcodec_parameters_to_context(dec, fmt->streams[vs]->codecpar);
        if (err < 0) return err;
        // single-threaded decode: the loader parallelizes across clips, and
        // per-clip decoder threads would oversubscribe the worker pool
        dec->thread_count = 1;
        return avcodec_open2(dec, codec, nullptr);
    }
};

}  // namespace

extern "C" {

int ov_probe(const char* path, int64_t* n_frames, double* fps,
             int* w, int* h) {
    Reader r;
    int err = r.open(path, /*with_decoder=*/false);
    if (err < 0) return err;
    AVStream* st = r.fmt->streams[r.vs];
    *w = st->codecpar->width;
    *h = st->codecpar->height;
    AVRational fr = st->avg_frame_rate;
    if (fr.num <= 0 || fr.den <= 0) fr = st->r_frame_rate;
    *fps = (fr.num > 0 && fr.den > 0) ? av_q2d(fr) : 0.0;

    if (st->nb_frames > 0) {
        *n_frames = st->nb_frames;
        return 0;
    }
    // no trustworthy metadata (GIF, some webm): count packets, no decode.
    // (1 packet == 1 frame for every video codec ffmpeg demuxes this way)
    int64_t count = 0;
    AVPacket* pkt = av_packet_alloc();
    if (!pkt) return AVERROR(ENOMEM);
    while (av_read_frame(r.fmt, pkt) >= 0) {
        if (pkt->stream_index == r.vs) ++count;
        av_packet_unref(pkt);
    }
    av_packet_free(&pkt);
    *n_frames = count;
    return 0;
}

int ov_decode_window(const char* path, int64_t start, int64_t count,
                     int out_w, int out_h, uint8_t* out) {
    if (count <= 0) return 0;
    Reader r;
    int err = r.open(path, /*with_decoder=*/true);
    if (err < 0) return err;

    AVPacket* pkt = av_packet_alloc();
    AVFrame* frm = av_frame_alloc();
    SwsContext* sws = nullptr;
    int64_t seen = 0, written = 0;
    const int64_t out_stride = (int64_t)out_w * 3;
    bool draining = false;

    while (written < count) {
        if (!draining) {
            err = av_read_frame(r.fmt, pkt);
            if (err < 0) {
                draining = true;  // EOF: flush the decoder's delayed frames
                avcodec_send_packet(r.dec, nullptr);
            } else if (pkt->stream_index != r.vs) {
                av_packet_unref(pkt);
                continue;
            } else {
                err = avcodec_send_packet(r.dec, pkt);
                av_packet_unref(pkt);
                if (err < 0 && err != AVERROR(EAGAIN)) break;
            }
        }
        while (written < count) {
            err = avcodec_receive_frame(r.dec, frm);
            if (err == AVERROR(EAGAIN)) {
                if (draining) goto done;  // decoder stalled after flush
                break;
            }
            if (err < 0) { draining = true; goto done; }  // AVERROR_EOF
            if (seen++ < start) { av_frame_unref(frm); continue; }
            if (!sws) {
                sws = sws_getContext(frm->width, frm->height,
                                     (AVPixelFormat)frm->format,
                                     out_w, out_h, AV_PIX_FMT_RGB24,
                                     SWS_BILINEAR, nullptr, nullptr, nullptr);
                if (!sws) { err = AVERROR(EINVAL); goto done; }
            }
            uint8_t* dst[4] = {out + written * out_h * out_stride,
                               nullptr, nullptr, nullptr};
            int dst_stride[4] = {(int)out_stride, 0, 0, 0};
            sws_scale(sws, frm->data, frm->linesize, 0, frm->height,
                      dst, dst_stride);
            ++written;
            av_frame_unref(frm);
        }
        if (draining && err < 0 && err != AVERROR(EAGAIN)) break;
    }
done:
    if (sws) sws_freeContext(sws);
    av_frame_free(&frm);
    av_packet_free(&pkt);
    return (int)written;
}

}  // extern "C"
