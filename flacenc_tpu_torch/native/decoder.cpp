// Clean-room FLAC stream decoder — the independent verification oracle.
//
// Written against the FLAC format specification (RFC 9639) ONLY. This
// file deliberately shares NO code with the Python component model
// (component/datatype.py, component/parser.py) or with the encoder-side
// C++ serializer (packer.cpp): it has its own MSB-first bit reader and
// computes CRC-8 (poly x^8+x^2+x+1) and CRC-16 (poly x^16+x^15+x^2+1)
// bitwise from the spec polynomials rather than via shared tables. It
// fills the role the third-party `claxon` crate plays in the reference's
// integrity tests (flacenc-rs/src/test_helper.rs:131-185): every
// encoded stream must decode sample-exact through a decoder that cannot
// share a bug with the encoder.
//
// Full-spec surface: metadata walk, frame headers (all block-size /
// sample-rate / sample-size codes, UTF-8-like numbers, CRC-8), constant
// / verbatim / fixed(0-4) / LPC(1-32) subframes, wasted bits, 4- and
// 5-bit partitioned Rice residuals including escape partitions, stereo
// decorrelation (left-side / right-side / mid-side), frame CRC-16.

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* data;
    int64_t nbits;
    int64_t pos = 0;
    bool fail = false;

    BitReader(const uint8_t* d, int64_t nbytes) : data(d), nbits(nbytes * 8) {}

    // read n (<= 57) bits MSB-first
    uint64_t get(int n) {
        if (pos + n > nbits) { fail = true; return 0; }
        uint64_t v = 0;
        int64_t p = pos;
        pos += n;
        while (n > 0) {
            int64_t byte = p >> 3;
            int off = (int)(p & 7);        // bits already consumed in byte
            int take = 8 - off;
            if (take > n) take = n;
            uint32_t bits = (uint32_t)((data[byte] >> (8 - off - take))
                                       & ((1u << take) - 1u));
            v = (v << take) | bits;
            n -= take;
            p += take;
        }
        return v;
    }

    int64_t get_signed(int n) {
        uint64_t v = get(n);
        if (n == 0) return 0;
        uint64_t sign = 1ull << (n - 1);
        return (int64_t)((v ^ sign)) - (int64_t)sign;
    }

    // count zero bits up to the terminating 1 bit (unary code)
    uint32_t unary() {
        uint32_t q = 0;
        for (;;) {
            if (pos >= nbits) { fail = true; return 0; }
            if (get(1)) return q;
            ++q;
            if (q > (1u << 30)) { fail = true; return 0; }
        }
    }

    void align_byte() { pos = (pos + 7) & ~(int64_t)7; }
    int64_t byte_pos() const { return pos >> 3; }
    bool at_end() const { return pos >= nbits; }
};

uint8_t crc8_update(uint8_t crc, uint8_t b) {
    crc ^= b;
    for (int i = 0; i < 8; ++i)
        crc = (uint8_t)((crc & 0x80) ? (crc << 1) ^ 0x07 : crc << 1);
    return crc;
}

uint16_t crc16_update(uint16_t crc, uint8_t b) {
    crc = (uint16_t)(crc ^ ((uint16_t)b << 8));
    for (int i = 0; i < 8; ++i)
        crc = (uint16_t)((crc & 0x8000) ? (crc << 1) ^ 0x8005 : crc << 1);
    return crc;
}

struct StreamInfo {
    uint32_t min_block = 0, max_block = 0;
    uint32_t rate = 0, channels = 0, bps = 0;
    uint64_t total_samples = 0;
    uint8_t md5[16] = {0};
};

// error codes (returned negated through the C API)
enum {
    OK = 0,
    E_MAGIC = 1,
    E_TRUNC = 2,
    E_METADATA = 3,
    E_SYNC = 4,
    E_HEADER = 5,
    E_CRC8 = 6,
    E_CRC16 = 7,
    E_SUBFRAME = 8,
    E_RESIDUAL = 9,
    E_CHANNELS = 10,
    E_UTF8 = 11,
};

int parse_stream_info(const uint8_t* body, int64_t len, StreamInfo* si) {
    if (len < 34) return E_METADATA;
    BitReader r(body, 34);
    si->min_block = (uint32_t)r.get(16);
    si->max_block = (uint32_t)r.get(16);
    r.get(24);  // min frame size
    r.get(24);  // max frame size
    si->rate = (uint32_t)r.get(20);
    si->channels = (uint32_t)r.get(3) + 1;
    si->bps = (uint32_t)r.get(5) + 1;
    si->total_samples = r.get(36);
    for (int i = 0; i < 16; ++i) si->md5[i] = (uint8_t)r.get(8);
    return r.fail ? E_TRUNC : OK;
}

// UTF-8-like coded number (up to 36 bits payload over 7 bytes)
int read_utf8like(BitReader& r, uint64_t* out) {
    uint32_t b0 = (uint32_t)r.get(8);
    if (r.fail) return E_TRUNC;
    int extra;
    uint64_t v;
    if ((b0 & 0x80) == 0x00) { extra = 0; v = b0; }
    else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
    else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
    else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
    else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
    else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
    else if (b0 == 0xFE) { extra = 6; v = 0; }
    else return E_UTF8;
    for (int i = 0; i < extra; ++i) {
        uint32_t b = (uint32_t)r.get(8);
        if (r.fail) return E_TRUNC;
        if ((b & 0xC0) != 0x80) return E_UTF8;
        v = (v << 6) | (b & 0x3F);
    }
    *out = v;
    return OK;
}

// Rice / escape residual for one subframe; res[0..warmup) left at 0.
int read_residual(BitReader& r, uint32_t block_size, uint32_t warmup,
                  int64_t* res) {
    uint32_t method = (uint32_t)r.get(2);
    if (r.fail) return E_TRUNC;
    if (method > 1) return E_RESIDUAL;
    int pbits = method ? 5 : 4;
    uint32_t escape = method ? 0x1F : 0x0F;
    uint32_t po = (uint32_t)r.get(4);
    uint32_t nparts = 1u << po;
    if (block_size % nparts != 0) return E_RESIDUAL;
    uint32_t plen = block_size >> po;
    // the first partition also carries the warmup gap: it must fit
    if (plen < warmup) return E_RESIDUAL;
    uint32_t t = warmup;
    for (uint32_t p = 0; p < nparts; ++p) {
        uint32_t count = plen - (p == 0 ? warmup : 0);
        uint32_t param = (uint32_t)r.get(pbits);
        if (r.fail) return E_TRUNC;
        if (param == escape) {
            uint32_t raw = (uint32_t)r.get(5);
            if (r.fail) return E_TRUNC;
            for (uint32_t i = 0; i < count; ++i, ++t)
                res[t] = raw ? r.get_signed((int)raw) : 0;
        } else {
            for (uint32_t i = 0; i < count; ++i, ++t) {
                uint32_t q = r.unary();
                uint32_t rem = param ? (uint32_t)r.get((int)param) : 0;
                if (r.fail) return E_TRUNC;
                uint64_t z = ((uint64_t)q << param) | rem;
                res[t] = (int64_t)(z >> 1) ^ -(int64_t)(z & 1);
            }
        }
    }
    return r.fail ? E_TRUNC : OK;
}

// one subframe -> out[0..block_size) (int64 workspace, exact arithmetic)
int read_subframe(BitReader& r, uint32_t block_size, int eff_bps,
                  int64_t* out) {
    if (r.get(1) != 0) return E_SUBFRAME;  // mandatory zero pad bit
    uint32_t type = (uint32_t)r.get(6);
    uint32_t wasted = 0;
    if (r.get(1)) wasted = r.unary() + 1;
    if (r.fail) return E_TRUNC;
    int bps = eff_bps - (int)wasted;
    if (bps <= 0 || bps > 33) return E_SUBFRAME;

    if (type == 0) {                       // CONSTANT
        int64_t v = r.get_signed(bps);
        for (uint32_t t = 0; t < block_size; ++t) out[t] = v;
    } else if (type == 1) {                // VERBATIM
        for (uint32_t t = 0; t < block_size; ++t) out[t] = r.get_signed(bps);
    } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
        uint32_t order = type & 0x07;
        if (order > block_size) return E_SUBFRAME;
        for (uint32_t t = 0; t < order; ++t) out[t] = r.get_signed(bps);
        // residual decodes in place (out[t] for t >= order), then the
        // cascade reconstructs front-to-back over already-final samples
        int rc = read_residual(r, block_size, order, out);
        if (rc) return rc;
        static const int64_t C[5][4] = {
            {0, 0, 0, 0},
            {1, 0, 0, 0},
            {2, -1, 0, 0},
            {3, -3, 1, 0},
            {4, -6, 4, -1},
        };
        for (uint32_t t = order; t < block_size; ++t) {
            int64_t pred = 0;
            for (uint32_t k = 0; k < order; ++k)
                pred += C[order][k] * out[t - 1 - k];
            out[t] += pred;
        }
    } else if (type & 0x20) {              // LPC, order = low 5 bits + 1
        uint32_t order = (type & 0x1F) + 1;
        if (order > block_size) return E_SUBFRAME;
        for (uint32_t t = 0; t < order; ++t) out[t] = r.get_signed(bps);
        uint32_t prec = (uint32_t)r.get(4);
        if (prec == 0x0F) return E_SUBFRAME;  // forbidden precision code
        prec += 1;
        int64_t shift = r.get_signed(5);
        if (shift < 0) return E_SUBFRAME;
        int64_t coefs[32];
        for (uint32_t k = 0; k < order; ++k)
            coefs[k] = r.get_signed((int)prec);
        if (r.fail) return E_TRUNC;
        int rc = read_residual(r, block_size, order, out);
        if (rc) return rc;
        for (uint32_t t = order; t < block_size; ++t) {
            int64_t acc = 0;
            for (uint32_t k = 0; k < order; ++k)
                acc += coefs[k] * out[t - 1 - k];
            out[t] += acc >> shift;
        }
    } else {
        return E_SUBFRAME;
    }
    if (r.fail) return E_TRUNC;
    if (wasted)
        for (uint32_t t = 0; t < block_size; ++t) out[t] <<= wasted;
    return OK;
}

}  // namespace

extern "C" {

// Decodes a complete FLAC stream.
//   data/len      : the raw .flac bytes
//   out           : interleaved int32 samples, capacity `cap` values
//   info_out[10]  : min_block, max_block, rate, channels, bps,
//                   total_samples(streaminfo), n_frames, n_samples,
//                   needed_capacity, reserved
//   md5_out[16]   : STREAMINFO md5 field
// Returns 0 on success, 1 if `cap` was too small (info_out[8] = needed;
// parse/CRC checks still ran), negative spec-violation codes otherwise.
int32_t flacenc_decode_stream(
    const uint8_t* data, int64_t len,
    int32_t* out, int64_t cap,
    int64_t* info_out, uint8_t* md5_out) {
    if (len < 4 || std::memcmp(data, "fLaC", 4) != 0) return -E_MAGIC;
    int64_t pos = 4;
    StreamInfo si;
    bool first = true, last = false;
    while (!last) {
        if (pos + 4 > len) return -E_TRUNC;
        uint8_t head = data[pos];
        last = (head & 0x80) != 0;
        uint32_t typetag = head & 0x7F;
        uint32_t blen = ((uint32_t)data[pos + 1] << 16)
                      | ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
        pos += 4;
        if (pos + blen > len) return -E_TRUNC;
        if (first) {
            if (typetag != 0) return -E_METADATA;
            int rc = parse_stream_info(data + pos, blen, &si);
            if (rc) return -rc;
            first = false;
        }
        pos += blen;
    }
    if (first) return -E_METADATA;
    if (si.channels < 1 || si.channels > 8) return -E_CHANNELS;

    int64_t n_out = 0, n_frames = 0;

    BitReader r(data, len);
    r.pos = pos * 8;

    int64_t work_cap = 65536;
    int64_t* work = new int64_t[8 * work_cap];

    int ret = OK;
    while (!r.at_end()) {
        // frames are byte aligned; tolerate nothing after the last frame
        int64_t frame_start = r.byte_pos();
        // --- frame header ---
        uint32_t sync = (uint32_t)r.get(14);
        if (r.fail) { ret = E_TRUNC; break; }
        if (sync != 0x3FFE) { ret = E_SYNC; break; }
        if (r.get(1) != 0) { ret = E_HEADER; break; }  // reserved
        r.get(1);  // blocking strategy (0 fixed / 1 variable)
        uint32_t bs_code = (uint32_t)r.get(4);
        uint32_t sr_code = (uint32_t)r.get(4);
        uint32_t ch_code = (uint32_t)r.get(4);
        uint32_t ss_code = (uint32_t)r.get(3);
        if (r.get(1) != 0) { ret = E_HEADER; break; }  // reserved
        uint64_t number;
        int rc = read_utf8like(r, &number);
        if (rc) { ret = rc; break; }
        uint32_t block_size;
        switch (bs_code) {
            case 0: ret = E_HEADER; break;
            case 1: block_size = 192; break;
            case 6: block_size = (uint32_t)r.get(8) + 1; break;
            case 7: block_size = (uint32_t)r.get(16) + 1; break;
            default:
                block_size = (bs_code <= 5) ? (576u << (bs_code - 2))
                                            : (256u << (bs_code - 8));
        }
        if (ret) break;
        uint32_t rate = 0;
        static const uint32_t kRates[12] = {
            0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
            32000, 44100, 48000, 96000,
        };
        if (sr_code == 0) rate = si.rate;
        else if (sr_code <= 11) rate = kRates[sr_code];
        else if (sr_code == 12) rate = (uint32_t)r.get(8) * 1000;
        else if (sr_code == 13) rate = (uint32_t)r.get(16);
        else if (sr_code == 14) rate = (uint32_t)r.get(16) * 10;
        else { ret = E_HEADER; break; }
        (void)rate;
        int bps;
        switch (ss_code) {
            case 0: bps = (int)si.bps; break;
            case 1: bps = 8; break;
            case 2: bps = 12; break;
            case 4: bps = 16; break;
            case 5: bps = 20; break;
            case 6: bps = 24; break;
            case 7: bps = 32; break;
            default: ret = E_HEADER; break;
        }
        if (ret) break;
        uint32_t nch;
        int mode = 0;  // 0 independent, 1 left-side, 2 right-side, 3 mid-side
        if (ch_code <= 7) { nch = ch_code + 1; }
        else if (ch_code <= 10) { nch = 2; mode = (int)ch_code - 7; }
        else { ret = E_CHANNELS; break; }
        if (nch != si.channels) { ret = E_CHANNELS; break; }
        // CRC-8 over the raw header bytes up to here
        if ((r.pos & 7) != 0) { ret = E_HEADER; break; }
        uint8_t crc8 = 0;
        for (int64_t b = frame_start; b < r.byte_pos(); ++b)
            crc8 = crc8_update(crc8, data[b]);
        if ((uint8_t)r.get(8) != crc8 || r.fail) { ret = E_CRC8; break; }

        if (block_size > work_cap) { ret = E_HEADER; break; }

        // --- subframes ---
        for (uint32_t c = 0; c < nch && !ret; ++c) {
            int off = 0;
            if (mode == 1 && c == 1) off = 1;       // side of left-side
            else if (mode == 2 && c == 0) off = 1;  // side of right-side
            else if (mode == 3 && c == 1) off = 1;  // side of mid-side
            ret = read_subframe(r, block_size, bps + off,
                                work + (int64_t)c * work_cap);
        }
        if (ret) break;
        r.align_byte();
        // CRC-16 over the whole frame up to here
        uint16_t crc16 = 0;
        for (int64_t b = frame_start; b < r.byte_pos(); ++b)
            crc16 = crc16_update(crc16, data[b]);
        if ((uint16_t)r.get(16) != crc16 || r.fail) { ret = E_CRC16; break; }

        // --- stereo decorrelation + interleave ---
        int64_t* c0 = work;
        int64_t* c1 = work + work_cap;
        for (uint32_t t = 0; t < block_size; ++t) {
            int64_t vals[8];
            if (mode == 0) {
                for (uint32_t c = 0; c < nch; ++c)
                    vals[c] = work[(int64_t)c * work_cap + t];
            } else if (mode == 1) {         // left-side: r = l - s
                vals[0] = c0[t];
                vals[1] = c0[t] - c1[t];
            } else if (mode == 2) {         // right-side: l = r + s
                vals[0] = c1[t] + c0[t];
                vals[1] = c1[t];
            } else {                        // mid-side
                int64_t m2 = (c0[t] << 1) | (c1[t] & 1);
                vals[0] = (m2 + c1[t]) >> 1;
                vals[1] = (m2 - c1[t]) >> 1;
            }
            for (uint32_t c = 0; c < nch; ++c) {
                if (n_out < cap) out[n_out] = (int32_t)vals[c];
                ++n_out;
            }
        }
        ++n_frames;
    }
    delete[] work;
    if (ret) return -ret;

    if (info_out) {
        info_out[0] = si.min_block;
        info_out[1] = si.max_block;
        info_out[2] = si.rate;
        info_out[3] = si.channels;
        info_out[4] = si.bps;
        info_out[5] = (int64_t)si.total_samples;
        info_out[6] = n_frames;
        info_out[7] = n_out;
        info_out[8] = n_out;
        info_out[9] = 0;
    }
    if (md5_out) std::memcpy(md5_out, si.md5, 16);
    return n_out > cap ? 1 : 0;
}

}  // extern "C"
