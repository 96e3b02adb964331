/* A stand-in for <libdeflate.h> over zlib: the raw-DEFLATE calls and the
 * CRC-32 that native/marginio.cc makes, as static inline functions, with
 * libdeflate's contracts (libdeflate.h of libdeflate 1.x):
 *
 *   libdeflate_deflate_decompress  raw inflate (windowBits -15) into a
 *       buffer of out_nbytes_avail bytes. With actual_out_nbytes_ret NULL
 *       the output must fill the buffer exactly, else
 *       LIBDEFLATE_SHORT_OUTPUT; a stream that does not fit gives
 *       LIBDEFLATE_INSUFFICIENT_SPACE, a bad or truncated stream
 *       LIBDEFLATE_BAD_DATA.
 *   libdeflate_deflate_compress    raw deflate at the compressor's level;
 *       0 when the output does not fit in out_nbytes_avail.
 *   libdeflate_crc32               zlib's crc32.
 *
 * The port's build (margin_tpu_torch/_ext.py) puts this directory on the
 * include path, and links -lz without -ldeflate, only when the system's
 * libdeflate does not compile and link. zlib's deflate writes other
 * compressed bytes than libdeflate's at the same level; the blocks decode
 * to the same data. */
#ifndef MARGIN_COMPAT_LIBDEFLATE_H
#define MARGIN_COMPAT_LIBDEFLATE_H

#include <limits.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

enum libdeflate_result {
    LIBDEFLATE_SUCCESS = 0,
    LIBDEFLATE_BAD_DATA = 1,
    LIBDEFLATE_SHORT_OUTPUT = 2,
    LIBDEFLATE_INSUFFICIENT_SPACE = 3,
};

struct libdeflate_decompressor {
    z_stream strm;
};

struct libdeflate_compressor {
    z_stream strm;
};

static inline struct libdeflate_decompressor*
libdeflate_alloc_decompressor(void) {
    struct libdeflate_decompressor* d =
        (struct libdeflate_decompressor*)calloc(1, sizeof(*d));
    if (d && inflateInit2(&d->strm, -15) != Z_OK) {
        free(d);
        d = NULL;
    }
    return d;
}

static inline void libdeflate_free_decompressor(
        struct libdeflate_decompressor* d) {
    if (!d) return;
    inflateEnd(&d->strm);
    free(d);
}

static inline enum libdeflate_result libdeflate_deflate_decompress(
        struct libdeflate_decompressor* d, const void* in, size_t in_nbytes,
        void* out, size_t out_nbytes_avail, size_t* actual_out_nbytes_ret) {
    if (in_nbytes > UINT_MAX || out_nbytes_avail > UINT_MAX)
        return LIBDEFLATE_BAD_DATA;
    z_stream* s = &d->strm;
    if (inflateReset(s) != Z_OK) return LIBDEFLATE_BAD_DATA;
    s->next_in = (Bytef*)in;
    s->avail_in = (uInt)in_nbytes;
    s->next_out = (Bytef*)out;
    s->avail_out = (uInt)out_nbytes_avail;
    int rc = inflate(s, Z_FINISH);
    if (rc != Z_STREAM_END) {
        /* output full with the stream unfinished: it did not fit; input
         * used up first: the stream is truncated */
        if ((rc == Z_BUF_ERROR || rc == Z_OK) && s->avail_out == 0 &&
            s->avail_in > 0)
            return LIBDEFLATE_INSUFFICIENT_SPACE;
        return LIBDEFLATE_BAD_DATA;
    }
    size_t got = out_nbytes_avail - s->avail_out;
    if (actual_out_nbytes_ret) {
        *actual_out_nbytes_ret = got;
    } else if (got != out_nbytes_avail) {
        return LIBDEFLATE_SHORT_OUTPUT;
    }
    return LIBDEFLATE_SUCCESS;
}

static inline struct libdeflate_compressor*
libdeflate_alloc_compressor(int compression_level) {
    if (compression_level < 0 || compression_level > 12) return NULL;
    /* libdeflate's levels 10-12 are its slow exhaustive ones; zlib stops
     * at 9 */
    int level = compression_level > 9 ? 9 : compression_level;
    struct libdeflate_compressor* c =
        (struct libdeflate_compressor*)calloc(1, sizeof(*c));
    if (c && deflateInit2(&c->strm, level, Z_DEFLATED, -15, 8,
                          Z_DEFAULT_STRATEGY) != Z_OK) {
        free(c);
        c = NULL;
    }
    return c;
}

static inline void libdeflate_free_compressor(
        struct libdeflate_compressor* c) {
    if (!c) return;
    deflateEnd(&c->strm);
    free(c);
}

static inline size_t libdeflate_deflate_compress_bound(
        struct libdeflate_compressor* c, size_t in_nbytes) {
    if (!c || in_nbytes > UINT_MAX)
        return in_nbytes + in_nbytes / 1000 + 5 * (in_nbytes / 16383 + 1) +
               64;
    return deflateBound(&c->strm, (uLong)in_nbytes);
}

static inline size_t libdeflate_deflate_compress(
        struct libdeflate_compressor* c, const void* in, size_t in_nbytes,
        void* out, size_t out_nbytes_avail) {
    if (in_nbytes > UINT_MAX || out_nbytes_avail > UINT_MAX) return 0;
    z_stream* s = &c->strm;
    if (deflateReset(s) != Z_OK) return 0;
    s->next_in = (Bytef*)in;
    s->avail_in = (uInt)in_nbytes;
    s->next_out = (Bytef*)out;
    s->avail_out = (uInt)out_nbytes_avail;
    if (deflate(s, Z_FINISH) != Z_STREAM_END) return 0;
    return out_nbytes_avail - s->avail_out;
}

static inline uint32_t libdeflate_crc32(uint32_t crc, const void* buffer,
                                        size_t len) {
    const Bytef* p = (const Bytef*)buffer;
    uLong c = crc;
    while (len > 0) {
        uInt n = len > UINT_MAX ? UINT_MAX : (uInt)len;
        c = crc32(c, p, n);
        p += n;
        len -= n;
    }
    return (uint32_t)c;
}

#endif /* MARGIN_COMPAT_LIBDEFLATE_H */
