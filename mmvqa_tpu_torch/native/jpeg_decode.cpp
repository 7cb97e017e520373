// JPEG decoder for the host data path (C++, exposed via ctypes).
//
// Decodes to interleaved 8-bit RGB the way libjpeg(-turbo) does with its
// default settings, so that the result equals PIL's
// ``Image.open(path).convert("RGB")`` bit for bit:
//   - sequential Huffman coding (SOF0, SOF1), 8-bit samples, 1 or 3
//     components, any integral sampling factors, restart intervals, one
//     interleaved scan or one scan per component;
//   - progressive Huffman coding (SOF2) as jdphuff.c decodes it: every
//     scan's coefficients buffered for the whole image, DC first and
//     refinement scans (interleaved or not), AC first and refinement scans
//     (one component each, over the component's own block grid) with their
//     end-of-band runs; a restart resets the runs and the DC predictions.
//     libjpeg smooths the blocks of a progressive image whose low AC
//     coefficients did not all arrive to their last bit (jdcoefct.c,
//     smoothing_ok); such a file is refused rather than decoded otherwise;
//   - quantization tables latched at a component's first scan (jdinput.c);
//   - the ISLOW inverse DCT of jidctint.c (13-bit constants, 2 extra bits
//     after the first pass, the post-IDCT range-limit table);
//   - fancy upsampling of jdsample.c: the triangle filters h2v1, h1v2 and
//     h2v2 (context rows replicated at the image's top and bottom edges),
//     plain replication where a component is at most 2 samples wide or the
//     factors are other integers;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c (16 fraction bits);
//     grayscale replicated to R, G and B, as PIL's convert("RGB") does;
//     an Adobe marker with transform 0, or component ids 'R' 'G' 'B', means
//     RGB stored as is (jdapimin.c's default_decompress_parms).
// Lossless, hierarchical and arithmetic-coded files, 12-bit samples and 2-
// or 4-component (CMYK, YCCK) files are refused with a message.
//
// Built with the host's C++ compiler by mmvqa_tpu_torch/native/loader.py.
// The entry points take the file's bytes; they touch no Python object, so
// a ctypes call runs without the interpreter lock.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError(msg); }

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
    bool present = false;
    // JPEG spec F.2.2.3: codes of length l run from mincode[l] to
    // maxcode[l], their symbols start at vals[valptr[l]]
    int32_t mincode[17], maxcode[18], valptr[17];
    uint8_t vals[256];
    // codes of up to 8 bits by an 8-bit lookahead: length (0 = longer)
    uint8_t look_len[256], look_sym[256];

    void build(const uint8_t* counts, const uint8_t* symbols, int n) {
        std::memcpy(vals, symbols, n);
        int code = 0, k = 0;
        std::memset(look_len, 0, sizeof(look_len));
        for (int l = 1; l <= 16; ++l) {
            valptr[l] = k;
            mincode[l] = code;
            for (int i = 0; i < counts[l - 1]; ++i) {
                if (l <= 8) {
                    int shift = 8 - l;
                    for (int j = 0; j < (1 << shift); ++j) {
                        look_len[(code << shift) | j] = (uint8_t)l;
                        look_sym[(code << shift) | j] = symbols[k];
                    }
                }
                ++code;
                ++k;
            }
            maxcode[l] = counts[l - 1] ? code - 1 : -1;
            if (code > (1 << l)) fail("bad Huffman table");
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;
        present = true;
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;           // Huffman tables of the current scan
    int width_in_blocks = 0, height_in_blocks = 0;
    int bw = 0, bh = 0;           // allocated blocks (whole MCUs)
    int dw = 0, dh = 0;           // downsampled width and height
    int dc_pred = 0;
    std::vector<int16_t> coef;    // bw * bh blocks of 64, natural order
    bool latched = false;         // q holds the table of the first scan
    uint16_t q[64];
    // progressive: the point transform Al of the last scan that coded each
    // coefficient (zigzag order), -1 before any (jdinput.c's coef_bits)
    int coef_bits[64];
};

class Decoder {
  public:
    Decoder(const uint8_t* data, size_t n) : p_(data), end_(data + n) {}

    void read_headers();          // up to and including the frame header
    void decode(uint8_t* out);    // the rest: scans, IDCT, upsampling, colour
    int width = 0, height = 0, ncomp = 0;

  private:
    const uint8_t* p_;
    const uint8_t* end_;
    uint16_t qt_[4][64];
    bool qt_present_[4] = {false, false, false, false};
    Huffman dc_[4], ac_[4];
    Component comp_[4];
    int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
    int restart_interval_ = 0;
    bool jfif_ = false, adobe_ = false;
    int adobe_transform_ = -1;
    bool frame_seen_ = false;
    bool progressive_ = false;
    int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;  // the scan's band and bits
    int eobrun_ = 0;                         // blocks left in an end-of-band run
    // entropy-coded segment reader
    uint32_t bits_ = 0;
    int nbits_ = 0;
    bool at_marker_ = false;
    bool ran_out_ = false;  // the data ended inside a scan

    uint8_t byte() {
        if (p_ >= end_) fail("unexpected end of data");
        return *p_++;
    }
    int word() {
        int hi = byte();
        return (hi << 8) | byte();
    }
    int next_marker();
    void read_dqt(int len);
    void read_dht(int len);
    void read_sof(int marker, int len);
    void read_sos(int len, std::vector<int>& scan);
    void read_app(int marker, int len);
    void decode_scan(const std::vector<int>& scan);
    void decode_unit(Component& c, int16_t* block);
    void decode_block(Component& c, int16_t* block);
    void dc_first(Component& c, int16_t* block);
    void dc_refine(int16_t* block);
    void ac_first(Component& c, int16_t* block);
    void ac_refine(Component& c, int16_t* block);
    void check_complete() const;
    void restart(int n);
    void fill();
    int bit();
    int bits(int n);
    int receive_extend(int s);
    int decode_symbol(const Huffman& h);
    void idct_plane(const Component& c, std::vector<uint8_t>& plane) const;
    void upsample(const Component& c, const std::vector<uint8_t>& plane,
                  std::vector<uint8_t>& full) const;
};

int Decoder::next_marker() {
    // skip anything up to 0xFF, then fill bytes
    for (;;) {
        uint8_t b = byte();
        if (b != 0xFF) continue;
        while ((b = byte()) == 0xFF) {}
        if (b != 0) return b;
    }
}

void Decoder::read_dqt(int len) {
    const uint8_t* stop = p_ + len;
    while (p_ < stop) {
        int pq_tq = byte();
        int pq = pq_tq >> 4, tq = pq_tq & 15;
        if (tq > 3) fail("bad quantization table id");
        for (int i = 0; i < 64; ++i)
            qt_[tq][kNatural[i]] = (uint16_t)(pq ? word() : byte());
        qt_present_[tq] = true;
    }
}

void Decoder::read_dht(int len) {
    const uint8_t* stop = p_ + len;
    while (p_ < stop) {
        int tc_th = byte();
        int tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3) fail("bad Huffman table id");
        uint8_t counts[16], symbols[256];
        int n = 0;
        for (int i = 0; i < 16; ++i) n += counts[i] = byte();
        if (n > 256) fail("bad Huffman table");
        for (int i = 0; i < n; ++i) symbols[i] = byte();
        (tc ? ac_[th] : dc_[th]).build(counts, symbols, n);
    }
}

void Decoder::read_app(int marker, int len) {
    const uint8_t* start = p_;
    if (marker == 0xE0 && len >= 5 && std::memcmp(p_, "JFIF\0", 5) == 0)
        jfif_ = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p_, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = p_[11];
    }
    p_ = start + len;
}

void Decoder::read_sof(int marker, int len) {
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
        fail("lossless JPEG is not supported");
    if (marker == 0xC5 || marker == 0xC6)
        fail("hierarchical JPEG is not supported");
    if (marker >= 0xC9) fail("arithmetic-coded JPEG is not supported");
    if (frame_seen_) fail("more than one frame header");
    frame_seen_ = true;
    progressive_ = marker == 0xC2;
    const uint8_t* stop = p_ + len;
    int precision = byte();
    if (precision != 8)
        fail(std::to_string(precision) + "-bit JPEG is not supported");
    height = word();
    width = word();
    ncomp = byte();
    if (width <= 0 || height <= 0) fail("bad image size");
    if (ncomp == 4) fail("CMYK or YCCK JPEG is not supported");
    if (ncomp != 1 && ncomp != 3)
        fail(std::to_string(ncomp) + "-component JPEG is not supported");
    if (len != 6 + 3 * ncomp) fail("bad frame header");
    for (int i = 0; i < ncomp; ++i) {
        Component& c = comp_[i];
        c.id = byte();
        int hv = byte();
        c.h = hv >> 4;
        c.v = hv & 15;
        c.tq = byte();
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
            fail("bad component parameters");
        hmax_ = std::max(hmax_, c.h);
        vmax_ = std::max(vmax_, c.v);
    }
    p_ = stop;
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp; ++i) {
        Component& c = comp_[i];
        // jdinput.c's initial_setup (ceilings of products)
        c.width_in_blocks =
            (int)(((long)width * c.h + 8L * hmax_ - 1) / (8L * hmax_));
        c.height_in_blocks =
            (int)(((long)height * c.v + 8L * vmax_ - 1) / (8L * vmax_));
        c.dw = (int)(((long)width * c.h + hmax_ - 1) / hmax_);
        c.dh = (int)(((long)height * c.v + vmax_ - 1) / vmax_);
        c.bw = mcux_ * c.h;
        c.bh = mcuy_ * c.v;
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
}

void Decoder::read_sos(int len, std::vector<int>& scan) {
    if (!frame_seen_) fail("scan before the frame header");
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 4 + 2 * ns) fail("bad scan header");
    scan.clear();
    for (int i = 0; i < ns; ++i) {
        int id = byte(), t = byte();
        int k = 0;
        while (k < ncomp && comp_[k].id != id) ++k;
        if (k == ncomp) fail("scan names an unknown component");
        comp_[k].td = t >> 4;
        comp_[k].ta = t & 15;
        if (comp_[k].td > 3 || comp_[k].ta > 3) fail("bad Huffman table id");
        scan.push_back(k);
    }
    int ss = byte(), se = byte(), ahal = byte();
    int ah = ahal >> 4, al = ahal & 15;
    if (!progressive_) {
        if (ss != 0 || se != 63 || ahal != 0) fail("bad spectral selection");
        return;
    }
    // jdphuff.c's start_pass_phuff_decoder
    bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
    if (bad || (ah != 0 && al != ah - 1) || al > 13)
        fail("bad progression parameters");
    ss_ = ss;
    se_ = se;
    ah_ = ah;
    al_ = al;
    for (int k : scan)
        for (int i = ss; i <= se; ++i) comp_[k].coef_bits[i] = al;
}

// Bits come from the entropy-coded segment with 0xFF00 unstuffed; at a
// marker the reader stops and supplies zeros, as libjpeg does.
void Decoder::fill() {
    while (nbits_ <= 24) {
        int b = 0;
        if (!at_marker_ && p_ >= end_) ran_out_ = true;
        if (!at_marker_ && p_ < end_) {
            if (*p_ == 0xFF) {
                if (p_ + 1 < end_ && p_[1] == 0x00) {
                    b = 0xFF;
                    p_ += 2;
                } else {
                    at_marker_ = true;
                }
            } else {
                b = *p_++;
            }
        }
        bits_ |= (uint32_t)b << (24 - nbits_);
        nbits_ += 8;
    }
}

int Decoder::bit() {
    if (nbits_ == 0) fill();
    int b = (int)(bits_ >> 31);
    bits_ <<= 1;
    --nbits_;
    return b;
}

int Decoder::bits(int n) {
    if (nbits_ < n) fill();
    int v = (int)(bits_ >> (32 - n));
    bits_ <<= n;
    nbits_ -= n;
    return v;
}

int Decoder::receive_extend(int s) {
    if (s == 0) return 0;
    if (s > 16) fail("bad coefficient size");
    if (nbits_ < s) fill();
    int v = (int)(bits_ >> (32 - s));
    bits_ <<= s;
    nbits_ -= s;
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

int Decoder::decode_symbol(const Huffman& h) {
    if (!h.present) fail("scan uses an undefined Huffman table");
    if (nbits_ < 8) fill();
    int look = (int)(bits_ >> 24);
    int l = h.look_len[look];
    if (l) {
        bits_ <<= l;
        nbits_ -= l;
        return h.look_sym[look];
    }
    int code = 0;
    for (l = 1; l <= 16; ++l) {
        code = (code << 1) | bit();
        if (code <= h.maxcode[l] && h.maxcode[l] >= 0)
            return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
    fail("corrupt Huffman code");
}

void Decoder::decode_block(Component& c, int16_t* block) {
    int t = decode_symbol(dc_[c.td]);
    c.dc_pred += receive_extend(t);
    block[0] = (int16_t)c.dc_pred;
    const Huffman& ac = ac_[c.ta];
    for (int k = 1; k < 64;) {
        int rs = decode_symbol(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) fail("corrupt block");
            block[kNatural[k]] = (int16_t)receive_extend(s);
            ++k;
        } else {
            if (r != 15) break;
            k += 16;
        }
    }
}

void Decoder::decode_unit(Component& c, int16_t* block) {
    if (!progressive_)
        decode_block(c, block);
    else if (ss_ == 0)
        ah_ == 0 ? dc_first(c, block) : dc_refine(block);
    else
        ah_ == 0 ? ac_first(c, block) : ac_refine(c, block);
}

// jdphuff.c: decode_mcu_DC_first, decode_mcu_DC_refine, decode_mcu_AC_first
// and decode_mcu_AC_refine, one block at a time
void Decoder::dc_first(Component& c, int16_t* block) {
    int t = decode_symbol(dc_[c.td]);
    c.dc_pred += receive_extend(t);
    block[0] = (int16_t)(c.dc_pred * (1 << al_));
}

void Decoder::dc_refine(int16_t* block) {
    if (bit()) block[0] = (int16_t)(block[0] | (1 << al_));
}

void Decoder::ac_first(Component& c, int16_t* block) {
    if (eobrun_ > 0) {
        --eobrun_;
        return;
    }
    const Huffman& ac = ac_[c.ta];
    for (int k = ss_; k <= se_; ++k) {
        int rs = decode_symbol(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) fail("corrupt block");
            block[kNatural[k]] = (int16_t)(receive_extend(s) * (1 << al_));
        } else if (r == 15) {
            k += 15;
        } else {
            eobrun_ = (1 << r) + (r ? bits(r) : 0) - 1;
            break;
        }
    }
}

void Decoder::ac_refine(Component& c, int16_t* block) {
    const int p1 = 1 << al_, m1 = -p1;
    // a coefficient already nonzero takes one correction bit
    auto correct = [&](int16_t& coef) {
        if (bit() && (coef & p1) == 0)
            coef = (int16_t)(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss_;
    if (eobrun_ == 0) {
        const Huffman& ac = ac_[c.ta];
        for (; k <= se_; ++k) {
            int rs = decode_symbol(ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                s = bit() ? p1 : m1;  // a newly nonzero coefficient
            } else if (r != 15) {
                eobrun_ = (1 << r) + (r ? bits(r) : 0);
                break;  // the rest of the block takes the run's rule
            }
            // skip r zero coefficients, correcting the nonzero ones passed
            do {
                int16_t& coef = block[kNatural[k]];
                if (coef != 0)
                    correct(coef);
                else if (--r < 0)
                    break;
                ++k;
            } while (k <= se_);
            if (s) {
                if (k > 63) fail("corrupt block");
                block[kNatural[k]] = (int16_t)s;
            }
        }
    }
    if (eobrun_ > 0) {
        for (; k <= se_; ++k) {
            int16_t& coef = block[kNatural[k]];
            if (coef != 0) correct(coef);
        }
        --eobrun_;
    }
}

void Decoder::restart(int n) {
    bits_ = 0;
    nbits_ = 0;
    at_marker_ = false;
    int m = next_marker();
    if (m != 0xD0 + (n & 7)) fail("missing restart marker");
    for (int i = 0; i < ncomp; ++i) comp_[i].dc_pred = 0;
    eobrun_ = 0;
}

void Decoder::decode_scan(const std::vector<int>& scan) {
    bits_ = 0;
    nbits_ = 0;
    at_marker_ = false;
    for (int i = 0; i < ncomp; ++i) comp_[i].dc_pred = 0;
    eobrun_ = 0;
    for (int k : scan) {
        Component& c = comp_[k];
        if (c.latched) continue;
        if (!qt_present_[c.tq])
            fail("component uses an undefined quantization table");
        std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
        c.latched = true;
    }
    long units;  // MCUs of the scan
    bool single = scan.size() == 1;
    if (single) {
        const Component& c = comp_[scan[0]];
        units = (long)c.width_in_blocks * c.height_in_blocks;
    } else {
        units = (long)mcux_ * mcuy_;
    }
    int restarts = 0;
    for (long u = 0; u < units; ++u) {
        if (restart_interval_ && u && u % restart_interval_ == 0)
            restart(restarts++);
        if (single) {
            Component& c = comp_[scan[0]];
            long bx = u % c.width_in_blocks, by = u / c.width_in_blocks;
            decode_unit(c, &c.coef[((size_t)by * c.bw + bx) * 64]);
            continue;
        }
        long mx = u % mcux_, my = u / mcux_;
        for (int k : scan) {
            Component& c = comp_[k];
            for (int y = 0; y < c.v; ++y)
                for (int x = 0; x < c.h; ++x) {
                    size_t bx = mx * c.h + x, by = my * c.v + y;
                    decode_unit(c, &c.coef[(by * c.bw + bx) * 64]);
                }
        }
    }
    if (ran_out_) fail("unexpected end of data in a scan");
    bits_ = 0;
    nbits_ = 0;
    at_marker_ = false;
}

// jidctint.c (jpeg_idct_islow), 8x8, with its range-limit table
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int32_t descale(int64_t x, int n) {
    return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
}

struct RangeLimit {
    // prepare_range_limit_table (jdmaster.c) for 8-bit samples, offset so
    // that idct[x & 1023] is the post-IDCT sample of x (centred on 0)
    uint8_t table[5 * 256 + 128];
    const uint8_t* idct;
    RangeLimit() {
        uint8_t* t = table + 256;
        std::memset(table, 0, 256);
        for (int i = 0; i < 256; ++i) t[i] = (uint8_t)i;
        uint8_t* post = t + 128;
        for (int i = 128; i < 512; ++i) post[i] = 255;
        std::memset(post + 512, 0, 512 - 128);
        std::memcpy(post + 1024 - 128, t, 128);
        idct = post;
    }
};

const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
    int32_t ws[64];
    for (int col = 0; col < 8; ++col) {
        const int16_t* c = in + col;
        const uint16_t* qc = q + col;
        if (c[8] == 0 && c[16] == 0 && c[24] == 0 && c[32] == 0 &&
            c[40] == 0 && c[48] == 0 && c[56] == 0) {
            int32_t dc = ((int32_t)c[0] * qc[0]) * (1 << kPass1Bits);
            for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
            continue;
        }
        int64_t z2 = (int32_t)c[16] * qc[16], z3 = (int32_t)c[48] * qc[48];
        int64_t z1 = (z2 + z3) * F0_541;
        int64_t tmp2 = z1 + z3 * -F1_847;
        int64_t tmp3 = z1 + z2 * F0_765;
        z2 = (int32_t)c[0] * qc[0];
        z3 = (int32_t)c[32] * qc[32];
        int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
        int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int32_t)c[56] * qc[56];
        tmp1 = (int32_t)c[40] * qc[40];
        tmp2 = (int32_t)c[24] * qc[24];
        tmp3 = (int32_t)c[8] * qc[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1_175;
        tmp0 *= F0_298;
        tmp1 *= F2_053;
        tmp2 *= F3_072;
        tmp3 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 *= -F1_961;
        z4 *= -F0_390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = kConstBits - kPass1Bits;
        ws[0 * 8 + col] = descale(tmp10 + tmp3, n);
        ws[7 * 8 + col] = descale(tmp10 - tmp3, n);
        ws[1 * 8 + col] = descale(tmp11 + tmp2, n);
        ws[6 * 8 + col] = descale(tmp11 - tmp2, n);
        ws[2 * 8 + col] = descale(tmp12 + tmp1, n);
        ws[5 * 8 + col] = descale(tmp12 - tmp1, n);
        ws[3 * 8 + col] = descale(tmp13 + tmp0, n);
        ws[4 * 8 + col] = descale(tmp13 - tmp0, n);
    }
    const uint8_t* lim = kRange.idct;
    for (int row = 0; row < 8; ++row) {
        const int32_t* w = ws + row * 8;
        uint8_t* o = out + (size_t)row * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
            w[6] == 0 && w[7] == 0) {
            uint8_t dc = lim[descale(w[0], kPass1Bits + 3) & 1023];
            for (int i = 0; i < 8; ++i) o[i] = dc;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * F0_541;
        int64_t tmp2 = z1 + z3 * -F1_847;
        int64_t tmp3 = z1 + z2 * F0_765;
        int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
        int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1_175;
        tmp0 *= F0_298;
        tmp1 *= F2_053;
        tmp2 *= F3_072;
        tmp3 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 *= -F1_961;
        z4 *= -F0_390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = kConstBits + kPass1Bits + 3;
        o[0] = lim[descale(tmp10 + tmp3, n) & 1023];
        o[7] = lim[descale(tmp10 - tmp3, n) & 1023];
        o[1] = lim[descale(tmp11 + tmp2, n) & 1023];
        o[6] = lim[descale(tmp11 - tmp2, n) & 1023];
        o[2] = lim[descale(tmp12 + tmp1, n) & 1023];
        o[5] = lim[descale(tmp12 - tmp1, n) & 1023];
        o[3] = lim[descale(tmp13 + tmp0, n) & 1023];
        o[4] = lim[descale(tmp13 - tmp0, n) & 1023];
    }
}

void Decoder::idct_plane(const Component& c,
                         std::vector<uint8_t>& plane) const {
    int stride = c.bw * 8;
    plane.assign((size_t)stride * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                       &plane[(size_t)by * 8 * stride + bx * 8], stride);
}

// jdcoefct.c's smoothing_ok: with every component's DC begun, libjpeg
// smooths the output where a component's AC coefficients 1..9 (zigzag; 1..5
// before libjpeg-turbo 2.1) did not all arrive to their last bit
void Decoder::check_complete() const {
    for (int i = 0; i < ncomp; ++i)
        if (comp_[i].coef_bits[0] < 0) return;
    for (int i = 0; i < ncomp; ++i)
        for (int k = 1; k < 10; ++k)
            if (comp_[i].coef_bits[k] != 0)
                fail("progressive JPEG whose low AC coefficients are "
                     "incomplete (libjpeg's block smoothing) is not "
                     "supported");
}

// The component at full size (width x height), as jdsample.c upsamples it.
// Rows above the first and below the last real row repeat that row, as
// jdmainct.c's context pointers make them; the first and last columns'
// special cases equal the general rule with the column index clamped.
void Decoder::upsample(const Component& c, const std::vector<uint8_t>& plane,
                       std::vector<uint8_t>& full) const {
    int stride = c.bw * 8;
    full.assign((size_t)width * height, 0);
    auto at = [&](int y, int x) -> int {
        return plane[(size_t)y * stride + x];
    };
    auto clampy = [&](int y) { return y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y); };
    auto clampx = [&](int x) { return x < 0 ? 0 : (x >= c.dw ? c.dw - 1 : x); };
    int fh = hmax_ / c.h, fv = vmax_ / c.v;
    if (hmax_ % c.h || vmax_ % c.v) fail("non-integral sampling factors");
    uint8_t* o = full.data();
    if (fh == 1 && fv == 1) {
        for (int y = 0; y < height; ++y)
            std::memcpy(o + (size_t)y * width, &plane[(size_t)y * stride], width);
    } else if (fh == 2 && fv == 1 && c.dw > 2) {  // h2v1_fancy_upsample
        for (int y = 0; y < height; ++y)
            for (int x = 0; x < width; ++x) {
                int i = x >> 1, v3 = at(y, i) * 3;
                o[(size_t)y * width + x] = (uint8_t)(
                    x & 1 ? (v3 + at(y, clampx(i + 1)) + 2) >> 2
                          : (v3 + at(y, clampx(i - 1)) + 1) >> 2);
            }
    } else if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
        for (int y = 0; y < height; ++y) {
            int j = y >> 1, near = y & 1 ? clampy(j + 1) : clampy(j - 1);
            int bias = y & 1 ? 2 : 1;
            for (int x = 0; x < width; ++x)
                o[(size_t)y * width + x] =
                    (uint8_t)((at(j, x) * 3 + at(near, x) + bias) >> 2);
        }
    } else if (fh == 2 && fv == 2 && c.dw > 2) {  // h2v2_fancy_upsample
        std::vector<int> colsum(c.dw);
        for (int y = 0; y < height; ++y) {
            int j = y >> 1, near = y & 1 ? clampy(j + 1) : clampy(j - 1);
            for (int i = 0; i < c.dw; ++i) colsum[i] = at(j, i) * 3 + at(near, i);
            for (int x = 0; x < width; ++x) {
                int i = x >> 1, s3 = colsum[i] * 3;
                o[(size_t)y * width + x] = (uint8_t)(
                    x & 1 ? (s3 + colsum[clampx(i + 1)] + 7) >> 4
                          : (s3 + colsum[clampx(i - 1)] + 8) >> 4);
            }
        }
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
        for (int y = 0; y < height; ++y)
            for (int x = 0; x < width; ++x)
                o[(size_t)y * width + x] = (uint8_t)at(y / fv, x / fh);
    }
}

void Decoder::read_headers() {
    if (end_ - p_ < 2 || p_[0] != 0xFF || p_[1] != 0xD8) fail("not a JPEG file");
    p_ += 2;
    while (!frame_seen_) {
        int m = next_marker();
        if (m == 0xD9 || m == 0xDA) fail("no frame header");
        int len = word() - 2;
        if (len < 0 || end_ - p_ < len) fail("bad segment length");
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
            read_sof(m, len);
        } else if (m == 0xCC) {
            fail("arithmetic-coded JPEG is not supported");
        } else if (m == 0xDB) {
            read_dqt(len);
        } else if (m == 0xC4) {
            read_dht(len);
        } else if (m == 0xDD) {
            restart_interval_ = word();
        } else if (m >= 0xE0 && m <= 0xEF) {
            read_app(m, len);
        } else {
            p_ += len;
        }
    }
}

void Decoder::decode(uint8_t* out) {
    std::vector<int> scan;
    std::vector<bool> coded(ncomp, false);
    for (;;) {
        int m = next_marker();
        if (m == 0xD9) break;
        int len = word() - 2;
        if (len < 0 || end_ - p_ < len) fail("bad segment length");
        if (m == 0xDA) {
            read_sos(len, scan);
            decode_scan(scan);
            for (int k : scan) coded[k] = true;
            bool all = true;
            for (int i = 0; i < ncomp; ++i) all = all && coded[i];
            // a sequential file's samples are complete; a progressive one
            // reads scans up to the end of the image
            if (all && !progressive_) break;
        } else if (m == 0xDB) {
            read_dqt(len);
        } else if (m == 0xC4) {
            read_dht(len);
        } else if (m == 0xDD) {
            restart_interval_ = word();
        } else if (m == 0xCC) {
            fail("arithmetic-coded JPEG is not supported");
        } else if (m >= 0xC0 && m <= 0xCF) {
            fail("more than one frame header");
        } else {
            p_ += len;
        }
    }
    for (int i = 0; i < ncomp; ++i)
        if (!coded[i]) fail("a component has no scan");
    if (progressive_) check_complete();

    std::vector<uint8_t> plane, full[3];
    for (int i = 0; i < ncomp; ++i) {
        idct_plane(comp_[i], plane);
        upsample(comp_[i], plane, full[i]);
    }
    size_t n = (size_t)width * height;
    if (ncomp == 1) {
        for (size_t i = 0; i < n; ++i)
            out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
        return;
    }
    bool rgb;
    if (jfif_) {
        rgb = false;
    } else if (adobe_) {
        rgb = adobe_transform_ == 0;
    } else {
        rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
    }
    if (rgb) {
        for (size_t i = 0; i < n; ++i)
            for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
        return;
    }
    // jdcolor.c's build_ycc_rgb_table and ycc_rgb_convert
    static const struct Tables {
        int cr_r[256], cb_b[256];
        int32_t cr_g[256], cb_g[256];
        Tables() {
            const int64_t one_half = (int64_t)1 << 15;
            auto fix = [](double x) {
                return (int64_t)(x * (double)(1L << 16) + 0.5);
            };
            for (int i = 0; i < 256; ++i) {
                int64_t x = i - 128;
                cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
                cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
                cr_g[i] = (int32_t)(-fix(0.71414) * x);
                cb_g[i] = (int32_t)(-fix(0.34414) * x + one_half);
            }
        }
    } t;
    const uint8_t* lim = kRange.table + 256;  // sample_range_limit
    for (size_t i = 0; i < n; ++i) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        out[3 * i] = lim[y + t.cr_r[cr]];
        out[3 * i + 1] = lim[y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)];
        out[3 * i + 2] = lim[y + t.cb_b[cb]];
    }
}

void copy_message(const char* msg, char* err, int errlen) {
    if (err && errlen > 0) {
        std::strncpy(err, msg, errlen - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" {

// Width, height and component count from the headers. Returns 0, or -1
// with a message in ``err``.
int jpeg_probe(const uint8_t* data, size_t n, int* width, int* height,
               int* components, char* err, int errlen) {
    try {
        Decoder d(data, n);
        d.read_headers();
        *width = d.width;
        *height = d.height;
        *components = d.ncomp;
        return 0;
    } catch (const std::exception& e) {
        copy_message(e.what(), err, errlen);
        return -1;
    }
}

// Decodes into ``out``, height x width x 3 bytes (RGB). Returns 0, or -1
// with a message in ``err``.
int jpeg_decode_rgb(const uint8_t* data, size_t n, uint8_t* out, int width,
                    int height, char* err, int errlen) {
    try {
        Decoder d(data, n);
        d.read_headers();
        if (d.width != width || d.height != height)
            throw DecodeError("output size differs from the image's");
        d.decode(out);
        return 0;
    } catch (const std::exception& e) {
        copy_message(e.what(), err, errlen);
        return -1;
    }
}

}  // extern "C"
