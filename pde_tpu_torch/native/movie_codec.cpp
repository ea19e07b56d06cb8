// Native FFV1 movie codec for MovieStorage (C ABI, loaded via ctypes).
//
// The port's own copy of pde_tpu's codec, built from this file.  It
// implements the encode/decode path that py-pde drives through an external
// ffmpeg subprocess (py-pde's pde/storage/movie.py):
// grayscale frames (8- or 16-bit) encoded losslessly with FFV1 into a
// container chosen by filename extension, with the version-1 JSON metadata
// stored in the container's "comment" tag.  Linking libavformat directly
// removes the subprocess + binary dependency: the same system libraries do
// the work in-process, which is the only way this path can execute in
// environments without an ffmpeg executable.
//
// Only AV_PIX_FMT_GRAY8 / AV_PIX_FMT_GRAY16LE are supported — MovieStorage
// stores 1d/2d scalar fields exclusively, so these are the only two pixel
// formats the Python layer can request.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/dict.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstring>
#include <string>
#include <vector>

namespace {

const bool g_quiet = [] {
    av_log_set_level(AV_LOG_ERROR);
    return true;
}();

thread_local std::string g_error;

void set_error(const std::string& where, int err = 0) {
    g_error = where;
    if (err != 0) {
        char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
        av_strerror(err, buf, sizeof(buf));
        g_error += ": ";
        g_error += buf;
    }
}

}  // namespace

extern "C" {

const char* mc_last_error() { return g_error.c_str(); }

// ---------------------------------------------------------------- writer --

struct MCW {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    AVStream* stream = nullptr;
    AVFrame* frame = nullptr;     // encoder pixel format
    AVFrame* in_frame = nullptr;  // packed input format (when converting)
    SwsContext* sws = nullptr;
    AVPixelFormat in_fmt = AV_PIX_FMT_NONE;
    AVPacket* pkt = nullptr;
    int width = 0, height = 0, in_row = 0;
    int64_t n_frames = 0;
    bool header_written = false;
};

static void mcw_free(MCW* w) {
    if (!w) return;
    if (w->fmt && w->header_written) av_write_trailer(w->fmt);
    if (w->codec) avcodec_free_context(&w->codec);
    if (w->frame) av_frame_free(&w->frame);
    if (w->in_frame) av_frame_free(&w->in_frame);
    if (w->sws) sws_freeContext(w->sws);
    if (w->pkt) av_packet_free(&w->pkt);
    if (w->fmt) {
        if (w->fmt->pb) avio_closep(&w->fmt->pb);
        avformat_free_context(w->fmt);
    }
    delete w;
}

static int mcw_drain(MCW* w) {
    for (;;) {
        int ret = avcodec_receive_packet(w->codec, w->pkt);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
        if (ret < 0) {
            set_error("avcodec_receive_packet", ret);
            return ret;
        }
        av_packet_rescale_ts(w->pkt, w->codec->time_base,
                             w->stream->time_base);
        w->pkt->stream_index = w->stream->index;
        ret = av_interleaved_write_frame(w->fmt, w->pkt);
        if (ret < 0) {
            set_error("av_interleaved_write_frame", ret);
            return ret;
        }
    }
}

// General writer: packed `in_pix` frames in, `codec_name`-encoded
// `out_pix` stream out (container from the filename extension).  When the
// formats differ the conversion runs through swscale in-process — the same
// conversion `ffmpeg -f rawvideo -pix_fmt <in> -i - -pix_fmt <out>` does.
// The frame rate is the rational fps_num/fps_den (fractional rates like
// 24000/1001 keep their exact timing, matching `ffmpeg -r`).
MCW* mcw_open3(const char* filename, int width, int height, int fps_num,
               int fps_den, const char* comment, const char* codec_name,
               const char* in_pix, const char* out_pix) {
    if (fps_num <= 0 || fps_den <= 0) {
        set_error("frame rate must be a positive rational");
        return nullptr;
    }
    MCW* w = new MCW();
    w->width = width;
    w->height = height;
    w->in_fmt = av_get_pix_fmt(in_pix);
    AVPixelFormat out_fmt = av_get_pix_fmt(out_pix);
    if (w->in_fmt == AV_PIX_FMT_NONE || out_fmt == AV_PIX_FMT_NONE) {
        set_error(std::string("unknown pixel format: ") + in_pix + "/" +
                  out_pix);
        mcw_free(w);
        return nullptr;
    }
    w->in_row = av_image_get_linesize(w->in_fmt, width, 0);
    if (w->in_row <= 0) {
        set_error("input pixel format must be packed single-plane");
        mcw_free(w);
        return nullptr;
    }
    int ret = avformat_alloc_output_context2(&w->fmt, nullptr, nullptr,
                                             filename);
    if (ret < 0 || !w->fmt) {
        set_error("avformat_alloc_output_context2", ret);
        mcw_free(w);
        return nullptr;
    }
    const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) {
        set_error(std::string("encoder not available: ") + codec_name);
        mcw_free(w);
        return nullptr;
    }
    w->stream = avformat_new_stream(w->fmt, nullptr);
    w->codec = avcodec_alloc_context3(codec);
    if (!w->stream || !w->codec) {
        set_error("stream/codec allocation failed");
        mcw_free(w);
        return nullptr;
    }
    w->codec->width = width;
    w->codec->height = height;
    w->codec->pix_fmt = out_fmt;
    w->codec->time_base = AVRational{fps_den, fps_num};
    w->codec->framerate = AVRational{fps_num, fps_den};
    w->stream->time_base = w->codec->time_base;
    // declare the rate explicitly — containers rewrite the stream
    // time_base to their own timescale, and readers estimating from a
    // handful of frames mis-derive fractional rates otherwise
    w->stream->avg_frame_rate = AVRational{fps_num, fps_den};
    if (w->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        w->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    ret = avcodec_open2(w->codec, codec, nullptr);
    if (ret < 0) {
        set_error("avcodec_open2", ret);
        mcw_free(w);
        return nullptr;
    }
    ret = avcodec_parameters_from_context(w->stream->codecpar, w->codec);
    if (ret < 0) {
        set_error("avcodec_parameters_from_context", ret);
        mcw_free(w);
        return nullptr;
    }
    if (comment && comment[0])
        av_dict_set(&w->fmt->metadata, "comment", comment, 0);
    if (!(w->fmt->oformat->flags & AVFMT_NOFILE)) {
        ret = avio_open(&w->fmt->pb, filename, AVIO_FLAG_WRITE);
        if (ret < 0) {
            set_error("avio_open", ret);
            mcw_free(w);
            return nullptr;
        }
    }
    ret = avformat_write_header(w->fmt, nullptr);
    if (ret < 0) {
        set_error("avformat_write_header", ret);
        mcw_free(w);
        return nullptr;
    }
    w->header_written = true;
    w->frame = av_frame_alloc();
    w->pkt = av_packet_alloc();
    if (!w->frame || !w->pkt) {
        set_error("frame/packet allocation failed");
        mcw_free(w);
        return nullptr;
    }
    w->frame->format = w->codec->pix_fmt;
    w->frame->width = width;
    w->frame->height = height;
    ret = av_frame_get_buffer(w->frame, 0);
    if (ret < 0) {
        set_error("av_frame_get_buffer", ret);
        mcw_free(w);
        return nullptr;
    }
    if (w->in_fmt != out_fmt) {
        w->sws = sws_getContext(width, height, w->in_fmt, width, height,
                                out_fmt, SWS_BILINEAR, nullptr, nullptr,
                                nullptr);
        w->in_frame = av_frame_alloc();
        if (!w->sws || !w->in_frame) {
            set_error("swscale setup failed");
            mcw_free(w);
            return nullptr;
        }
        w->in_frame->format = w->in_fmt;
        w->in_frame->width = width;
        w->in_frame->height = height;
        ret = av_frame_get_buffer(w->in_frame, 0);
        if (ret < 0) {
            set_error("av_frame_get_buffer(in)", ret);
            mcw_free(w);
            return nullptr;
        }
    }
    return w;
}

// Integer-fps convenience wrapper (kept for ABI stability).
MCW* mcw_open2(const char* filename, int width, int height, int fps,
               const char* comment, const char* codec_name,
               const char* in_pix, const char* out_pix) {
    return mcw_open3(filename, width, height, fps, 1, comment, codec_name,
                     in_pix, out_pix);
}

// Grayscale FFV1 writer — the MovieStorage format.
MCW* mcw_open(const char* filename, int width, int height, int bits,
              int fps, const char* comment) {
    if (bits != 8 && bits != 16) {
        set_error("bits_per_channel must be 8 or 16");
        return nullptr;
    }
    const char* pix = bits == 16 ? "gray16le" : "gray";
    return mcw_open2(filename, width, height, fps, comment, "ffv1", pix,
                     pix);
}

// `data` is height rows of width pixels, tightly packed (the rawvideo
// layout an `ffmpeg -f rawvideo -s WxH` pipe would consume).
int mcw_write(MCW* w, const uint8_t* data) {
    AVFrame* dst = w->sws ? w->in_frame : w->frame;
    int ret = av_frame_make_writable(dst);
    if (ret < 0) {
        set_error("av_frame_make_writable", ret);
        return ret;
    }
    for (int y = 0; y < w->height; ++y)
        std::memcpy(dst->data[0] + (size_t)y * dst->linesize[0],
                    data + (size_t)y * w->in_row, w->in_row);
    if (w->sws) {
        ret = av_frame_make_writable(w->frame);
        if (ret >= 0)
            ret = sws_scale(w->sws, w->in_frame->data, w->in_frame->linesize,
                            0, w->height, w->frame->data, w->frame->linesize);
        if (ret < 0) {
            set_error("sws_scale", ret);
            return ret;
        }
    }
    w->frame->pts = w->n_frames++;
    ret = avcodec_send_frame(w->codec, w->frame);
    if (ret < 0) {
        set_error("avcodec_send_frame", ret);
        return ret;
    }
    return mcw_drain(w);
}

int mcw_close(MCW* w) {
    int ret = 0;
    if (w->codec) {
        ret = avcodec_send_frame(w->codec, nullptr);  // flush
        if (ret >= 0) ret = mcw_drain(w);
    }
    mcw_free(w);
    return ret < 0 ? ret : 0;
}

// ---------------------------------------------------------------- reader --

struct MCR {
    int width = 0, height = 0, bits = 0;
    int64_t n_frames = 0;
    std::string comment;
    std::string pix_fmt;
    std::vector<uint8_t> data;
};

void mcr_close(MCR* r) { delete r; }

// Metadata-only probe: container + first-video-stream header, no decode
// (what `ffprobe -show_format -show_streams` reports).  n_frames is the
// header's nb_frames, or -1 when the container does not record it.
MCR* mcr_probe(const char* filename) {
    AVFormatContext* fmt = nullptr;
    int ret = avformat_open_input(&fmt, filename, nullptr, nullptr);
    if (ret < 0) {
        set_error("avformat_open_input", ret);
        return nullptr;
    }
    ret = avformat_find_stream_info(fmt, nullptr);
    if (ret < 0) {
        set_error("avformat_find_stream_info", ret);
        avformat_close_input(&fmt);
        return nullptr;
    }
    int stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                         nullptr, 0);
    if (stream_idx < 0) {
        set_error("no video stream", stream_idx);
        avformat_close_input(&fmt);
        return nullptr;
    }
    AVStream* stream = fmt->streams[stream_idx];
    MCR* r = new MCR();
    const AVDictionaryEntry* tag =
        av_dict_get(fmt->metadata, "comment", nullptr, 0);
    if (!tag) tag = av_dict_get(stream->metadata, "comment", nullptr, 0);
    if (tag) r->comment = tag->value;
    r->width = stream->codecpar->width;
    r->height = stream->codecpar->height;
    r->n_frames = stream->nb_frames > 0 ? stream->nb_frames : -1;
    const char* name =
        av_get_pix_fmt_name((AVPixelFormat)stream->codecpar->format);
    if (name) r->pix_fmt = name;
    if (stream->codecpar->format == AV_PIX_FMT_GRAY8)
        r->bits = 8;
    else if (stream->codecpar->format == AV_PIX_FMT_GRAY16LE)
        r->bits = 16;
    avformat_close_input(&fmt);
    return r;
}

// Opens the file, reads the container metadata, and decodes every frame of
// the first video stream into a contiguous buffer.  Movies written by
// MovieStorage are small (quantized 2d scalar series), so decode-all keeps
// the ABI trivial; random access happens on the Python side.
MCR* mcr_open(const char* filename) {
    AVFormatContext* fmt = nullptr;
    int ret = avformat_open_input(&fmt, filename, nullptr, nullptr);
    if (ret < 0) {
        set_error("avformat_open_input", ret);
        return nullptr;
    }
    ret = avformat_find_stream_info(fmt, nullptr);
    if (ret < 0) {
        set_error("avformat_find_stream_info", ret);
        avformat_close_input(&fmt);
        return nullptr;
    }
    int stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                         nullptr, 0);
    if (stream_idx < 0) {
        set_error("no video stream", stream_idx);
        avformat_close_input(&fmt);
        return nullptr;
    }
    AVStream* stream = fmt->streams[stream_idx];
    const AVCodec* codec = avcodec_find_decoder(stream->codecpar->codec_id);
    AVCodecContext* cctx = codec ? avcodec_alloc_context3(codec) : nullptr;
    if (!cctx || avcodec_parameters_to_context(cctx, stream->codecpar) < 0 ||
        avcodec_open2(cctx, codec, nullptr) < 0) {
        set_error("decoder setup failed");
        if (cctx) avcodec_free_context(&cctx);
        avformat_close_input(&fmt);
        return nullptr;
    }

    MCR* r = new MCR();
    // the muxer may upcase the tag key (matroska); av_dict_get matches
    // case-insensitively by default
    const AVDictionaryEntry* tag =
        av_dict_get(fmt->metadata, "comment", nullptr, 0);
    if (!tag) tag = av_dict_get(stream->metadata, "comment", nullptr, 0);
    if (tag) r->comment = tag->value;
    r->width = cctx->width;
    r->height = cctx->height;
    const char* pfname = av_get_pix_fmt_name(cctx->pix_fmt);
    if (pfname) r->pix_fmt = pfname;

    AVFrame* frame = av_frame_alloc();
    AVPacket* pkt = av_packet_alloc();
    bool failed = false;
    auto take = [&](AVFrame* f) {
        if (r->bits == 0) {
            if (f->format == AV_PIX_FMT_GRAY8)
                r->bits = 8;
            else if (f->format == AV_PIX_FMT_GRAY16LE)
                r->bits = 16;
            else {
                set_error("unsupported pixel format (gray8/gray16le only)");
                failed = true;
                return;
            }
        }
        const int row = r->width * (r->bits / 8);
        const size_t off = r->data.size();
        r->data.resize(off + (size_t)row * r->height);
        for (int y = 0; y < r->height; ++y)
            std::memcpy(r->data.data() + off + (size_t)y * row,
                        f->data[0] + (size_t)y * f->linesize[0], row);
        r->n_frames++;
    };
    while (!failed && av_read_frame(fmt, pkt) >= 0) {
        if (pkt->stream_index == stream_idx &&
            avcodec_send_packet(cctx, pkt) >= 0)
            while (!failed && avcodec_receive_frame(cctx, frame) >= 0)
                take(frame);
        av_packet_unref(pkt);
    }
    if (!failed && avcodec_send_packet(cctx, nullptr) >= 0)  // flush
        while (!failed && avcodec_receive_frame(cctx, frame) >= 0)
            take(frame);

    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&cctx);
    avformat_close_input(&fmt);
    if (failed) {
        delete r;
        return nullptr;
    }
    return r;
}

int mcr_width(MCR* r) { return r->width; }
int mcr_height(MCR* r) { return r->height; }
int mcr_bits(MCR* r) { return r->bits; }
int64_t mcr_nframes(MCR* r) { return r->n_frames; }
const char* mcr_comment(MCR* r) { return r->comment.c_str(); }
const char* mcr_pixfmt(MCR* r) { return r->pix_fmt.c_str(); }
const uint8_t* mcr_data(MCR* r) { return r->data.data(); }
int64_t mcr_data_size(MCR* r) { return (int64_t)r->data.size(); }

}  // extern "C"
