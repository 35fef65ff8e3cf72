// Native host-side hot loops for dsrc_tpu.
//
// The accelerator owns the compute path (JAX/XLA); these are the host runtime pieces
// that the reference implements in C++ and that stay on the CPU here too:
// record-boundary scanning for the chunker (reference
// FastqStream.cpp:18-98), 2-bit packing fallbacks, and compressed-payload
// row compaction for archive serialization.  Exposed with a plain C ABI for
// ctypes (no pybind11 in this image).
//
// Build: make -C native   ->  libdsrc_host.so

#include <cstdint>
#include <cstring>

extern "C" {

// Scan a buffer for FASTQ record boundaries.
//
// A record boundary lies after newline k (0-based, global line index
// lines_before + k) iff (lines_before + k + 1) % 4 == 0.  Returns the number
// of newlines in buf and writes the byte position *after* the last record
// boundary to *cut (-1 if none).  Mirrors io/chunker.py's numpy scan.
int64_t dsrc_scan_records(const uint8_t* buf, int64_t n,
                          int64_t lines_before, int64_t* cut) {
    int64_t count = 0;
    int64_t last = -1;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    // phase: how many more newlines until the next boundary
    int64_t phase = 3 - (lines_before & 3);
    while (p < end) {
        const uint8_t* nl =
            static_cast<const uint8_t*>(memchr(p, '\n', end - p));
        if (!nl) break;
        if (phase == 0) {
            last = (nl - buf) + 1;
            phase = 3;
        } else {
            --phase;
        }
        ++count;
        p = nl + 1;
    }
    *cut = last;
    return count;
}

// 2-bit pack: n (multiple of 4) symbols in [0,3] -> n/4 bytes.
void dsrc_pack2(const uint8_t* syms, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i += 4) {
        out[i >> 2] = static_cast<uint8_t>(
            syms[i] | (syms[i + 1] << 2) | (syms[i + 2] << 4) |
            (syms[i + 3] << 6));
    }
}

void dsrc_unpack2(const uint8_t* packed, int64_t nbytes, uint8_t* out) {
    for (int64_t i = 0; i < nbytes; ++i) {
        uint8_t b = packed[i];
        out[4 * i] = b & 3;
        out[4 * i + 1] = (b >> 2) & 3;
        out[4 * i + 2] = (b >> 4) & 3;
        out[4 * i + 3] = (b >> 6) & 3;
    }
}

// Compact rANS payload rows: payload is [l][w_max] int32 holding u16 words;
// keep the first nwords[j] of each row, emitting little-endian u16.
// Returns total words written.
int64_t dsrc_compact_payload(const int32_t* payload, int64_t l,
                             int64_t w_max, const int32_t* nwords,
                             uint16_t* out) {
    int64_t k = 0;
    for (int64_t j = 0; j < l; ++j) {
        const int32_t* row = payload + j * w_max;
        int64_t nw = nwords[j];
        for (int64_t w = 0; w < nw; ++w) {
            out[k++] = static_cast<uint16_t>(row[w]);
        }
    }
    return k;
}

// Right-aligned variant: row j's words live at [w_max - nwords[j], w_max)
// (the device encoder's in-scan layout); emitted in that order.
int64_t dsrc_compact_payload_right(const int32_t* payload, int64_t l,
                                   int64_t w_max, const int32_t* nwords,
                                   uint16_t* out) {
    int64_t k = 0;
    for (int64_t j = 0; j < l; ++j) {
        const int32_t* row = payload + j * w_max;
        int64_t nw = nwords[j];
        for (int64_t w = w_max - nw; w < w_max; ++w) {
            out[k++] = static_cast<uint16_t>(row[w]);
        }
    }
    return k;
}

// Inverse: scatter a flat u16 word stream back into [l][w_max] rows.
void dsrc_expand_payload(const uint16_t* words, int64_t l, int64_t w_max,
                         const int32_t* nwords, int32_t* payload) {
    int64_t k = 0;
    for (int64_t j = 0; j < l; ++j) {
        int32_t* row = payload + j * w_max;
        int64_t nw = nwords[j];
        for (int64_t w = 0; w < nw; ++w) row[w] = words[k++];
        for (int64_t w = nw; w < w_max; ++w) row[w] = 0;
    }
}

// ---------------------------------------------------------------------------
// Semi-uniform block staging (compress side): one pass over the block text
// validating the 4-line layout (fixed read length, '+' separator line) and
// filling the quality/sequence matrices + concatenated title stream that
// models/block.py:_compress_semi feeds to the device kernels.  The numpy
// version runs ~6 separate passes (flatnonzero + fancy gathers + isin);
// this is the host-runtime analogue of the reference's scalar record
// parser (FastqParser.cpp:140-235) and keeps worker threads fed at chip
// rate.  Returns num_records, or -1 when the block is not semi-layout
// (caller falls back to the generic codec).
//
// buf[n] must end with '\n'.  qual_mat/seq_mat are [rpad, read_len]
// row-major, pre-zeroed by the caller; title_buf has capacity n;
// title_lens has capacity rpad.
int64_t dsrc_stage_semi(const uint8_t* buf, int64_t n, int64_t read_len,
                        int64_t rpad, uint8_t* qual_mat, uint8_t* seq_mat,
                        uint8_t* title_buf, int64_t* title_lens) {
    if (n <= 0 || buf[n - 1] != '\n' || read_len <= 0 || read_len > 8192)
        return -1;
    // seq/qual byte validity lookup: 1 = ACGTN, 2 = quality [33, 97)
    static uint8_t ok_tab[256];
    static bool init = false;
    if (!init) {
        for (int q = 33; q < 33 + 64; ++q) ok_tab[q] |= 2;
        ok_tab[static_cast<int>('A')] |= 1;
        ok_tab[static_cast<int>('C')] |= 1;
        ok_tab[static_cast<int>('G')] |= 1;
        ok_tab[static_cast<int>('T')] |= 1;
        ok_tab[static_cast<int>('N')] |= 1;
        init = true;
    }
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    int64_t rec = 0;
    int64_t tpos = 0;
    while (p < end) {
        if (rec >= rpad) return -1;
        // line 1: @title
        if (*p != '@') return -1;
        const uint8_t* nl = static_cast<const uint8_t*>(
            memchr(p, '\n', end - p));
        if (!nl) return -1;
        int64_t tl = nl - p - 1;
        memcpy(title_buf + tpos, p + 1, tl);
        tpos += tl;
        title_lens[rec] = tl;
        p = nl + 1;
        // line 2: sequence, exactly read_len of ACGTN
        if (end - p < read_len + 1 || p[read_len] != '\n') return -1;
        {
            uint8_t* dst = seq_mat + rec * read_len;
            for (int64_t i = 0; i < read_len; ++i) {
                if (!(ok_tab[p[i]] & 1)) return -1;
                dst[i] = p[i];
            }
        }
        p += read_len + 1;
        // line 3: exactly "+"
        if (end - p < 2 || p[0] != '+' || p[1] != '\n') return -1;
        p += 2;
        // line 4: quality, exactly read_len in [33, 97)
        if (end - p < read_len + 1 || p[read_len] != '\n') return -1;
        {
            uint8_t* dst = qual_mat + rec * read_len;
            for (int64_t i = 0; i < read_len; ++i) {
                if (!(ok_tab[p[i]] & 2)) return -1;
                dst[i] = p[i];
            }
        }
        p += read_len + 1;
        ++rec;
    }
    return rec;
}

// ---------------------------------------------------------------------------
// FASTQ text reassembly (decompress side): the mirror of dsrc_stage_semi for
// the whole decode path — scatter decoded title/sequence/quality streams
// back into 4-line records (reference BlockCompressor::ReadTags text
// layout, BlockCompressor.cpp:503-573; replaces the numpy _scatter_var
// passes in models/block.py:_layout).
//
// titles: concatenated title bytes with per-record title_lens;
// seq/qual: concatenated with per-record qual_lens (sequence length =
// qual_len + (color_space ? 1 : 0), the extra byte being primers[rec]);
// plus_rep repeats the title after '+'.  out must hold the exact total
// (computed by the caller from the length vectors).  Returns bytes written.
int64_t dsrc_layout_records(
    int64_t num_rec, const uint8_t* titles, const int64_t* title_lens,
    const uint8_t* seq, const uint8_t* qual, const int64_t* qual_lens,
    const uint8_t* primers, int32_t color_space, int32_t plus_rep,
    uint8_t* out) {
    uint8_t* o = out;
    int64_t toff = 0, qoff = 0;
    for (int64_t r = 0; r < num_rec; ++r) {
        int64_t tl = title_lens[r];
        int64_t ql = qual_lens[r];
        *o++ = '@';
        memcpy(o, titles + toff, tl);
        o += tl;
        *o++ = '\n';
        if (color_space) *o++ = primers[r];
        memcpy(o, seq + qoff, ql);
        o += ql;
        *o++ = '\n';
        *o++ = '+';
        if (plus_rep) {
            memcpy(o, titles + toff, tl);
            o += tl;
        }
        *o++ = '\n';
        memcpy(o, qual + qoff, ql);
        o += ql;
        *o++ = '\n';
        toff += tl;
        qoff += ql;
    }
    return o - out;
}

}  // extern "C"
