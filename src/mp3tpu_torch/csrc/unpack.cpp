// mp3tpu native host unpacker (SURVEY.md B2/B4 C++ fast path).
//
// Mirrors mp3tpu.bitstream.unpack exactly (tested for bit-identical
// SymbolTensors against the pure-Python path): frame scan, side info,
// MPEG-1 + LSF scalefactors, 2-level-LUT Huffman decode, bit-reservoir
// assembly, band exponents and per-band stereo mixing matrices.
//
// C ABI only; loaded via ctypes (no pybind11 in this environment).
// Spec tables come from the generated spec_tables.h (single source of
// truth: the behaviorally extracted ISO 11172-3 Annex B data).
//
// Copy of src/mp3tpu/native/unpack.cpp (the C++ unpacker of the JAX
// package), kept in the port with its spec_tables.h; the code is the same.
// Build: mp3tpu_torch/kernels/build.py compiles it alone with g++ at first
// use (mp3tpu_torch/bitstream/native.py), no external deps.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512BW__) && defined(__AVX512VBMI2__) || \
    defined(__BMI2__) && defined(__AVX2__)
#include <immintrin.h>
#endif
#if defined(__AVX512BW__) && defined(__AVX512VBMI2__)
#define MP3TPU_AVX512_PACK 1
#endif

#include "spec_tables.h"

// Section-level cycle counters for the profile build only
// (make prof_driver). Index map: 0 scan, 1 sideinfo+crc+reservoir,
// 2 GranuleBits.init, 3 scalefactors, 4 big_values loop, 5 count1
// loop, 6 plane pack, 7 exponents, 8 stereo modes.
#ifdef MP3TPU_PROF_SECTIONS
#include <x86intrin.h>
extern "C" uint64_t mp3tpu_prof_cycles[16];
uint64_t mp3tpu_prof_cycles[16];
// per-table pair counts + fast-LUT hit counts (indices 0-31 tables,
// 32 = count1 quads, 33 = count1 fast hits)
extern "C" uint64_t mp3tpu_prof_pairs[40];
uint64_t mp3tpu_prof_pairs[40];
extern "C" uint64_t mp3tpu_prof_fasthits[40];
uint64_t mp3tpu_prof_fasthits[40];
#define PROF_PAIR(t) mp3tpu_prof_pairs[t]++
#define PROF_FASTHIT(t) mp3tpu_prof_fasthits[t]++
#define PROF_DECL uint64_t prof_t_ = __rdtsc()
#define PROF_ACC(i)                                     \
    do {                                                \
        uint64_t prof_n_ = __rdtsc();                   \
        mp3tpu_prof_cycles[i] += prof_n_ - prof_t_;     \
        prof_t_ = prof_n_;                              \
    } while (0)
#else
#define PROF_DECL
#define PROF_ACC(i)
#define PROF_PAIR(t)
#define PROF_FASTHIT(t)
#endif

namespace {

// ----------------------------------------------------------------- util

static inline uint64_t be64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return __builtin_bswap64(v);
}

// ------------------------------------------------------------ bit reader

struct BitReader {  // MSB-first over a bounded buffer
    const uint8_t* data;
    size_t nbytes;
    size_t pos = 0;  // bit position

    uint32_t read(int n) {
        if (n == 0) return 0;
        size_t byte = pos >> 3;
        int sh = int(pos & 7);
        uint64_t acc = 0;
        if (byte + 8 <= nbytes) {
            acc = be64(data + byte);
        } else {
            uint8_t tmp[8] = {0};
            size_t avail = nbytes > byte ? nbytes - byte : 0;
            if (avail > 8) avail = 8;
            memcpy(tmp, data + byte, avail);
            acc = be64(tmp);
        }
        pos += n;
        return uint32_t((acc << sh) >> (64 - n));
    }
    uint32_t read1() { return read(1); }
    void skip(int n) { pos += n; }
};

// granule-bounded reader: bits beyond `limit_bits` read as zero.
// Fixed-capacity buffer (part2_3_length is a 12-bit field, so a granule
// spans at most 512 bytes + guard) — no per-granule heap traffic.
// peek() is a single unaligned 8-byte load + bswap; measured faster
// here than a cached-accumulator reader (the load port is not the
// bottleneck and the accumulator adds a serial dependency chain).
struct GranuleBits {
    static const size_t CAP = 544;
    uint8_t buf[CAP];
    size_t pos = 0;            // bits consumed within the granule
    size_t nbits = 0;

    void init(const uint8_t* base, size_t base_len, size_t bit_off, size_t bits) {
        pos = 0;
        nbits = bits;
        size_t first = bit_off >> 3;
        size_t last = (bit_off + bits + 7) >> 3;
        int lead = int(bit_off - first * 8);
        size_t span = last - first;          // <= 513
        size_t copied = 0;
        if (first < base_len) {
            size_t avail = base_len - first;
            copied = avail < span ? avail : span;
            memcpy(buf, base + first, copied);
        }
        // zero the (short) region after the copied data + 16-byte guard
        memset(buf + copied, 0, (span - copied) + 16);
        // clear leading bits of first byte
        if (lead) buf[0] &= uint8_t(0xFFu >> lead);
        // clear bits past the granule end (at most the final data byte;
        // everything beyond it is already zero)
        size_t endbit = lead + bits;
        size_t endbyte = endbit >> 3;
        int rem = int(endbit & 7);
        if (endbyte < copied) {
            buf[endbyte] &= uint8_t(rem ? (0xFFu << (8 - rem)) : 0);
            memset(buf + endbyte + (rem ? 1 : 0), 0, copied - endbyte - (rem ? 1 : 0));
        }
        lead_ = lead;
    }
    int lead_ = 0;

    uint32_t peek(int n) const {
        size_t p = pos + lead_;
        size_t byte = p >> 3;
        int sh = int(p & 7);
        uint64_t acc = be64(buf + byte);
        return uint32_t((acc << sh) >> (64 - n));
    }
    uint32_t read(int n) {
        if (!n) return 0;
        uint32_t v = peek(n);
        pos += n;
        return v;
    }
    uint32_t read1() { return read(1); }
    void skip(int n) { pos += n; }
};

// Registerized bitstream cursor over a GranuleBits buffer: keeps the
// next >=33 bits left-aligned in a register and refills 4 bytes at a
// time — one load+shift per symbol instead of an unaligned be64 load
// per peek. Only used inside decode_spectrum's symbol loops (the host
// hot path); semantics are bit-identical to GranuleBits (the buffer is
// already end-masked, and the 16-byte guard covers the lookahead).
// (A position-only load-per-peek cursor was re-measured against this
// after the fused two-pair LUT landed: 0.574s vs 0.562s per 200
// fixture decodes — the accumulator stays.)
struct BitCur {
    const uint8_t* p;    // next byte to pull into acc
    uint64_t acc = 0;    // upcoming bits, left-aligned
    int cnt = 0;         // valid bits in acc
    int64_t used_ = 0;   // bits consumed since init

    void init(const GranuleBits& br) {
        size_t bitoff = br.pos + size_t(br.lead_);
        p = br.buf + (bitoff >> 3);
        acc = be64(p) << (bitoff & 7);
        cnt = 64 - int(bitoff & 7);
        p += 8;
        used_ = 0;
    }
    inline int64_t used() const { return used_; }
    inline uint32_t peek(int n) const { return uint32_t(acc >> (64 - n)); }
    inline void skip(int n) {
        if (!n) return;  // keeps cnt < 64 for the refill shift
        acc <<= n;
        cnt -= n;
        used_ += n;
        // Branchless byte-granular refill (every bit of acc is always
        // real stream data, so re-ORing overlapping bytes is a no-op;
        // cnt only drives the pointer arithmetic). The conditional
        // 4-byte refill this replaces mispredicted on the symbol loops'
        // irregular skip widths.
        acc |= be64(p) >> cnt;
        p += (63 - cnt) >> 3;
        cnt |= 56;
    }
    inline uint32_t read(int n) {
        if (!n) return 0;
        uint32_t v = peek(n);
        skip(n);
        return v;
    }
    inline uint32_t read1() { return read(1); }
};

// ----------------------------------------------------- huffman 2-level LUT

struct HuffLut {
    // root: 10 bits. entry: leaf = (len<<8)|xy (len>=1); 0x8000|subidx = subtable
    static const int ROOT_BITS = 10;
    static const int SUB_BITS = 9;
    std::vector<uint16_t> root;
    std::vector<uint16_t> subs;  // 512-entry blocks
    int linbits = 0;

    void build(const uint8_t* lens, const uint32_t* codes, int n, int ylen, int lb) {
        linbits = lb;
        root.assign(1 << ROOT_BITS, 0);
        for (int i = 0; i < n; i++) {
            int l = lens[i];
            if (l == 0) continue;
            uint32_t c = codes[i];
            uint16_t leaf = uint16_t((l << 8) | ((i / ylen) << 4) | (i % ylen));
            if (l <= ROOT_BITS) {
                uint32_t lo = c << (ROOT_BITS - l);
                for (uint32_t k = 0; k < (1u << (ROOT_BITS - l)); k++) root[lo + k] = leaf;
            } else {
                uint32_t prefix = c >> (l - ROOT_BITS);
                if (!(root[prefix] & 0x8000)) {
                    root[prefix] = uint16_t(0x8000 | (subs.size() / 512));
                    subs.resize(subs.size() + 512, 0);
                }
                uint32_t subidx = (root[prefix] & 0x7FFF) * 512;
                int sl = l - ROOT_BITS;  // <= 9
                uint32_t rest = c & ((1u << sl) - 1);
                uint32_t lo = rest << (SUB_BITS - sl);
                // store total length in subtable leaf
                uint16_t sleaf = uint16_t((l << 8) | ((i / ylen) << 4) | (i % ylen));
                for (uint32_t k = 0; k < (1u << (SUB_BITS - sl)); k++)
                    subs[subidx + lo + k] = sleaf;
            }
        }
    }

    // decode one pair; returns packed leaf (len<<8 | x<<4 | y)
    template <class R>
    inline uint16_t decode(R& br) const {
        uint16_t e = root[br.peek(ROOT_BITS)];
        if (e & 0x8000) {
            uint32_t sub = (e & 0x7FFF) * 512;
            uint32_t more = br.peek(ROOT_BITS + SUB_BITS) & ((1u << SUB_BITS) - 1);
            e = subs[sub + more];
        }
        br.skip(e >> 8);
        return e;
    }
};

static HuffLut g_luts[32];
static HuffLut g_c1[2];

// Sign-fused fast paths. The big_values fast LUT resolves up to TWO
// (x, y) pairs — code + signs + small linbits escapes folded in — from
// one 12-bit peek; it is built by SIMULATING the exact slow path on
// every 12-bit pattern (bit-identity with the 2-level LUT by
// construction), so escape tables 16-31 get a fast path too whenever
// code+linbits+signs fit the window and |value| <= 127. Count1 quads
// fuse up to FOUR quadruples (code + signs each) from one 10-bit peek
// the same way.
struct Fast2 {
    // 32-bit entries (16 KB/table keeps 3 active tables L1-resident):
    //   [31] valid1  [30] valid2  [29:26] btot  [25:22] b1
    //   one-pair:  [15:8] y1 int8, [7:0] x1 int8
    //   two-pair:  four 5-bit biased fields v+15 at [4:0] x1, [9:5] y1,
    //              [14:10] x2, [19:15] y2 (so |v| <= 15; wider folded
    //              escapes only ever land in one-pair entries)
    // Entry 0 (or a failed guard) -> slow path.
    std::vector<uint32_t> tab;  // 4096
};
static Fast2 g_fast2[32];
struct FastQ {
    // One 64-bit entry per 10-bit pattern (8 KB/table — meta and values
    // share a cache line): [63] valid | [61:56] total bits (nq quads) |
    // [55:52] first-quad bits | [51:48] nq (1..4) | [31:0] sixteen
    // 2-bit fields v+1 in line order, (v+1)=1 (zero) past 4*nq so the
    // expanded 16-value store is the correct rzero tail. count1 codes
    // are <= 6 bits + 4 signs = 10, so every pattern decodes at least
    // one quad and the entry is always valid for conforming tables.
    std::vector<uint64_t> tab;  // 1024
};
static FastQ g_fastq[2];
static bool g_init = false;

// MSB-first reader over a left-aligned bit pattern, zero-padded past
// `avail` bits — mirrors BitCur for LUT-build simulation. Decodes that
// consume more than `avail` bits are rejected by the caller via used.
struct SimReader {
    uint64_t acc;
    int used = 0;
    explicit SimReader(uint32_t pat, int width) {
        acc = uint64_t(pat) << (64 - width);
    }
    uint32_t peek(int n) const { return uint32_t((acc << used) >> (64 - n)); }
    uint32_t read(int n) {
        if (!n) return 0;
        uint32_t v = peek(n);
        used += n;
        return v;
    }
    uint32_t read1() { return read(1); }
    void skip(int n) { used += n; }
};

// Simulate one big_values pair decode (slow-path semantics exactly):
// returns bits consumed, or -1 if the decode needs bits past `avail`
// or hits an invalid/absent code. Values returned pre-signed.
static int sim_pair(const HuffLut& lut, SimReader& r, int avail,
                    int* vx, int* vy) {
    uint16_t e = lut.root[r.peek(HuffLut::ROOT_BITS)];
    if (e & 0x8000) {
        uint32_t sub = (e & 0x7FFF) * 512;
        uint32_t more = r.peek(HuffLut::ROOT_BITS + HuffLut::SUB_BITS) &
                        ((1u << HuffLut::SUB_BITS) - 1);
        e = lut.subs[sub + more];
    }
    if (!e) return -1;  // invalid code: keep the slow path's semantics
    r.skip(e >> 8);
    int x = (e >> 4) & 15, y = e & 15;
    if (x == 15 && lut.linbits) x += int(r.read(lut.linbits));
    if (x && r.read1()) x = -x;
    if (y == 15 && lut.linbits) y += int(r.read(lut.linbits));
    if (y && r.read1()) y = -y;
    if (r.used > avail) return -1;
    *vx = x;
    *vy = y;
    return r.used;
}

static void build_fast2(Fast2* f, const HuffLut& lut) {
    f->tab.assign(4096, 0);
    for (uint32_t pat = 0; pat < 4096; pat++) {
        SimReader r(pat, 12);
        int x0, y0;
        int b1 = sim_pair(lut, r, 12, &x0, &y0);
        // int8 payload: |v| > 127 stays on the slow path (which also
        // owns the has_big/has_escape tracking for such values)
        if (b1 < 0 || x0 < -127 || x0 > 127 || y0 < -127 || y0 > 127)
            continue;
        int x1, y1;
        int btot = sim_pair(lut, r, 12, &x1, &y1);
        bool two = btot >= 0 && x0 >= -15 && x0 <= 15 && y0 >= -15 &&
                   y0 <= 15 && x1 >= -15 && x1 <= 15 && y1 >= -15 && y1 <= 15;
        uint32_t e;
        if (two) {
            e = 0x80000000u | 0x40000000u | (uint32_t(btot) << 26) |
                (uint32_t(b1) << 22) |
                (uint32_t(y1 + 15) << 15) | (uint32_t(x1 + 15) << 10) |
                (uint32_t(y0 + 15) << 5) | uint32_t(x0 + 15);
        } else {
            e = 0x80000000u | (uint32_t(b1) << 26) | (uint32_t(b1) << 22) |
                (uint32_t(uint8_t(int8_t(y0))) << 8) |
                uint32_t(uint8_t(int8_t(x0)));
        }
        f->tab[pat] = e;
    }
}

// Simulate one count1 quad (slow-path semantics): returns bits
// consumed so far, or -1 past-avail/invalid. vals[4] in {-1,0,1}.
static int sim_quad(const HuffLut& c1, SimReader& r, int avail,
                    int16_t* vals) {
    uint16_t e = c1.root[r.peek(HuffLut::ROOT_BITS)];
    if (!e) return -1;
    r.skip(e >> 8);
    int quad = e & 0xFF;
    for (int j = 0; j < 4; j++) {
        int v = (quad >> (3 - j)) & 1;
        if (v && r.read1()) v = -1;
        vals[j] = int16_t(v);
    }
    if (r.used > avail) return -1;
    return r.used;
}

static void build_fastq(FastQ* f, const HuffLut& c1) {
    f->tab.assign(1024, 0);
    for (uint32_t pat = 0; pat < 1024; pat++) {
        SimReader r(pat, 10);
        uint32_t vals = 0;
        int nq = 0, btot = 0, b1 = 0;
        while (nq < 4) {
            int16_t q[4];
            SimReader save = r;
            int b = sim_quad(c1, r, 10, q);
            if (b < 0) {
                r = save;
                break;
            }
            for (int j = 0; j < 4; j++)
                vals |= uint32_t(q[j] + 1) << (2 * (nq * 4 + j));
            btot = b;
            if (nq == 0) b1 = b;
            nq++;
        }
        // fields past 4*nq get v+1 = 1 (value 0, the rzero tail)
        for (int j = nq * 4; j < 16; j++) vals |= 1u << (2 * j);
        if (nq > 0)
            f->tab[pat] = (1ull << 63) | (uint64_t(btot) << 56) |
                          (uint64_t(b1) << 52) | (uint64_t(nq) << 48) |
                          uint64_t(vals);
    }
}

static void init_crc_tab();

static void ensure_init() {
    if (g_init) return;
    for (int t = 1; t < 32; t++) {
        const HuffSpec& s = HUFF_SPECS[t];
        if (s.n) {
            g_luts[t].build(s.lens, s.codes, s.n, s.ylen, s.linbits);
            build_fast2(&g_fast2[t], g_luts[t]);
        }
    }
    g_c1[0].build(COUNT1A_LENS, COUNT1A_CODES, 16, 16, 0);
    g_c1[1].build(COUNT1B_LENS, COUNT1B_CODES, 16, 16, 0);
    build_fastq(&g_fastq[0], g_c1[0]);
    build_fastq(&g_fastq[1], g_c1[1]);
    init_crc_tab();
    g_init = true;
}

// -------------------------------------------------------------- headers

struct Header {
    int version;  // 3=MPEG1 2=MPEG2 0=MPEG2.5
    int crc;      // protected flag
    int bitrate;  // bits/s
    int sr;       // Hz
    int sr_idx9;  // index into SR_LIST
    int padding;
    int mode, mode_ext;
    int frame_bytes, samples, channels, ngr, side_bytes;
    bool lsf;
};

static const int BR1[16] = {0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320};
static const int BR2[16] = {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160};

static bool parse_header(uint32_t w, Header* h) {
    if ((w >> 21) != 0x7FF) return false;
    int ver = (w >> 19) & 3;
    if (ver == 1) return false;
    int layer = (w >> 17) & 3;
    if (layer != 1) return false;  // layer III
    int br = (w >> 12) & 15;
    if (br == 0 || br == 15) return false;
    int sr = (w >> 10) & 3;
    if (sr == 3) return false;
    h->version = ver;
    h->lsf = ver != 3;
    h->crc = !((w >> 16) & 1);
    h->bitrate = (h->lsf ? BR2[br] : BR1[br]) * 1000;
    static const int SRS[4][3] = {{11025, 12000, 8000}, {0, 0, 0},
                                  {22050, 24000, 16000}, {44100, 48000, 32000}};
    h->sr = SRS[ver][sr];
    for (int i = 0; i < 9; i++)
        if (SR_LIST[i] == h->sr) h->sr_idx9 = i;
    h->padding = (w >> 9) & 1;
    h->mode = (w >> 6) & 3;
    h->mode_ext = (w >> 4) & 3;
    h->samples = h->lsf ? 576 : 1152;
    h->frame_bytes = (h->samples / 8) * h->bitrate / h->sr + h->padding;
    h->channels = h->mode == 3 ? 1 : 2;
    h->ngr = h->lsf ? 1 : 2;
    h->side_bytes = h->lsf ? (h->channels == 1 ? 9 : 17)
                           : (h->channels == 1 ? 17 : 32);
    return true;
}

static uint32_t word_at(const uint8_t* d, size_t i) {
    return (uint32_t(d[i]) << 24) | (uint32_t(d[i + 1]) << 16) |
           (uint32_t(d[i + 2]) << 8) | uint32_t(d[i + 3]);
}

// --------------------------------------------------------- side info etc.

struct GranSI {
    int part2_3_length, big_values, global_gain, scalefac_compress;
    int window_switching, block_type, mixed;
    int table_select[3];
    int subblock_gain[3];
    int region0_count, region1_count, preflag, scalefac_scale, count1table_select;
};

struct SideInfo {
    int main_data_begin;
    int scfsi[2][4];
    GranSI gr[2][2];  // [granule][channel]
};

static void parse_side_info(BitReader& r, const Header& h, SideInfo* si) {
    if (h.lsf) {
        si->main_data_begin = r.read(8);
        r.skip(h.channels);
        memset(si->scfsi, 0, sizeof(si->scfsi));
    } else {
        si->main_data_begin = r.read(9);
        r.skip(h.channels == 1 ? 5 : 3);
        for (int c = 0; c < h.channels; c++)
            for (int i = 0; i < 4; i++) si->scfsi[c][i] = r.read1();
    }
    for (int g = 0; g < h.ngr; g++)
        for (int c = 0; c < h.channels; c++) {
            GranSI& gi = si->gr[g][c];
            gi.part2_3_length = r.read(12);
            gi.big_values = r.read(9);
            gi.global_gain = r.read(8);
            gi.scalefac_compress = r.read(h.lsf ? 9 : 4);
            gi.window_switching = r.read1();
            if (gi.window_switching) {
                gi.block_type = r.read(2);
                gi.mixed = r.read1();
                gi.table_select[0] = r.read(5);
                gi.table_select[1] = r.read(5);
                gi.table_select[2] = 0;
                for (int w = 0; w < 3; w++) gi.subblock_gain[w] = r.read(3);
                gi.region0_count = (gi.block_type == 2 && !gi.mixed) ? 8 : 7;
                gi.region1_count = 20 - gi.region0_count;
            } else {
                gi.block_type = 0;
                gi.mixed = 0;
                for (int t = 0; t < 3; t++) gi.table_select[t] = r.read(5);
                for (int w = 0; w < 3; w++) gi.subblock_gain[w] = 0;
                gi.region0_count = r.read(4);
                gi.region1_count = r.read(3);
            }
            gi.preflag = h.lsf ? 0 : r.read1();
            gi.scalefac_scale = r.read1();
            gi.count1table_select = r.read1();
        }
}

static uint16_t g_crc_tab[256];
static void init_crc_tab() {
    for (uint32_t b = 0; b < 256; b++) {
        uint32_t crc = b << 8;
        for (int i = 0; i < 8; i++)
            crc = (crc & 0x8000) ? ((crc << 1) ^ 0x8005) & 0xFFFF
                                 : (crc << 1) & 0xFFFF;
        g_crc_tab[b] = uint16_t(crc);
    }
}

static bool check_crc(const uint8_t* d, size_t off, const Header& h) {
    if (!h.crc) return true;
    uint32_t stored = (uint32_t(d[off + 4]) << 8) | d[off + 5];
    uint32_t crc = 0xFFFF;
    auto feed = [&](uint8_t b) {
        crc = ((crc << 8) ^ g_crc_tab[((crc >> 8) ^ b) & 0xFF]) & 0xFFFF;
    };
    feed(d[off + 2]);
    feed(d[off + 3]);
    for (int i = 0; i < h.side_bytes; i++) feed(d[off + 6 + i]);
    return crc == stored;
}

// -------------------------------------------------------- scalefactors

struct Scf {
    int32_t long_sf[22] = {0};
    int32_t short_sf[13][3] = {{0}};
    int32_t long_max[22] = {0};
    int32_t short_max[13][3] = {{0}};
    int preflag = 0;
    int intensity_scale = 0;
    int part2_bits = 0;
};

static void read_scf_mpeg1(GranuleBits& r, const GranSI& g, const int* scfsi,
                           const Scf* prev, int gr_idx, Scf* sf) {
    sf->preflag = g.preflag;
    int slen1 = SLEN1[g.scalefac_compress], slen2 = SLEN2[g.scalefac_compress];
    size_t start = r.pos;
    bool short_b = g.block_type == 2;
    if (short_b && !g.mixed) {
        for (int b = 0; b < 6; b++)
            for (int w = 0; w < 3; w++) sf->short_sf[b][w] = r.read(slen1);
        for (int b = 6; b < 12; b++)
            for (int w = 0; w < 3; w++) sf->short_sf[b][w] = r.read(slen2);
    } else if (short_b) {
        for (int b = 0; b < 8; b++) sf->long_sf[b] = r.read(slen1);
        for (int b = 3; b < 6; b++)
            for (int w = 0; w < 3; w++) sf->short_sf[b][w] = r.read(slen1);
        for (int b = 6; b < 12; b++)
            for (int w = 0; w < 3; w++) sf->short_sf[b][w] = r.read(slen2);
    } else {
        static const int grp[4][3] = {{0, 6, 0}, {6, 11, 0}, {11, 16, 1}, {16, 21, 1}};
        for (int gi = 0; gi < 4; gi++) {
            int lo = grp[gi][0], hi = grp[gi][1];
            int slen = grp[gi][2] ? slen2 : slen1;
            if (gr_idx == 1 && scfsi[gi] && prev) {
                for (int b = lo; b < hi; b++) sf->long_sf[b] = prev->long_sf[b];
            } else {
                for (int b = lo; b < hi; b++) sf->long_sf[b] = r.read(slen);
            }
        }
    }
    sf->part2_bits = int(r.pos - start);
}

static const int NSFB_NORMAL[3][3][4] = {
    {{6, 5, 5, 5}, {9, 9, 9, 9}, {6, 9, 9, 9}},
    {{6, 5, 7, 3}, {9, 9, 12, 6}, {6, 9, 12, 6}},
    {{11, 10, 0, 0}, {18, 18, 0, 0}, {15, 18, 0, 0}},
};
static const int NSFB_INT[3][3][4] = {
    {{7, 7, 7, 0}, {12, 12, 12, 0}, {6, 15, 12, 0}},
    {{6, 6, 6, 3}, {12, 9, 9, 6}, {6, 12, 9, 6}},
    {{8, 8, 5, 0}, {15, 12, 9, 0}, {6, 18, 9, 0}},
};

static void read_scf_lsf(GranuleBits& r, const GranSI& g, bool int_ch, Scf* sf) {
    int sfc = g.scalefac_compress;
    int btn = (g.window_switching && g.block_type == 2) ? (g.mixed ? 2 : 1) : 0;
    int slen[4];
    const int* nsfb;
    sf->preflag = 0;
    sf->intensity_scale = 0;
    if (int_ch) {
        sf->intensity_scale = sfc & 1;
        sfc >>= 1;
        if (sfc < 180) {
            slen[0] = sfc / 36; slen[1] = (sfc % 36) / 6; slen[2] = sfc % 6; slen[3] = 0;
            nsfb = NSFB_INT[0][btn];
        } else if (sfc < 244) {
            sfc -= 180;
            slen[0] = (sfc % 64) >> 4; slen[1] = (sfc % 16) >> 2; slen[2] = sfc % 4; slen[3] = 0;
            nsfb = NSFB_INT[1][btn];
        } else {
            sfc -= 244;
            slen[0] = sfc / 3; slen[1] = sfc % 3; slen[2] = 0; slen[3] = 0;
            nsfb = NSFB_INT[2][btn];
        }
    } else {
        if (sfc < 400) {
            slen[0] = (sfc >> 4) / 5; slen[1] = (sfc >> 4) % 5;
            slen[2] = (sfc & 15) >> 2; slen[3] = sfc & 3;
            nsfb = NSFB_NORMAL[0][btn];
        } else if (sfc < 500) {
            sfc -= 400;
            slen[0] = (sfc >> 2) / 5; slen[1] = (sfc >> 2) % 5; slen[2] = sfc & 3; slen[3] = 0;
            nsfb = NSFB_NORMAL[1][btn];
        } else {
            sfc -= 500;
            slen[0] = sfc / 3; slen[1] = sfc % 3; slen[2] = 0; slen[3] = 0;
            nsfb = NSFB_NORMAL[2][btn];
            sf->preflag = 1;
        }
    }
    size_t start = r.pos;
    int seq_v[60], seq_m[60], n = 0;
    for (int part = 0; part < 4; part++)
        for (int k = 0; k < nsfb[part]; k++) {
            seq_v[n] = slen[part] ? int(r.read(slen[part])) : 0;
            seq_m[n] = (1 << slen[part]) - 1;
            n++;
        }
    bool short_b = g.window_switching && g.block_type == 2;
    bool mixed = short_b && g.mixed;
    int i = 0;
    if (short_b && !mixed) {
        for (int b = 0; b < 12; b++)
            for (int w = 0; w < 3; w++)
                if (i < n) { sf->short_sf[b][w] = seq_v[i]; sf->short_max[b][w] = seq_m[i]; i++; }
    } else if (mixed) {
        for (int b = 0; b < 6; b++)
            if (i < n) { sf->long_sf[b] = seq_v[i]; sf->long_max[b] = seq_m[i]; i++; }
        for (int b = 3; b < 12; b++)
            for (int w = 0; w < 3; w++)
                if (i < n) { sf->short_sf[b][w] = seq_v[i]; sf->short_max[b][w] = seq_m[i]; i++; }
    } else {
        for (int b = 0; b < 21; b++)
            if (i < n) { sf->long_sf[b] = seq_v[i]; sf->long_max[b] = seq_m[i]; i++; }
    }
    sf->part2_bits = int(r.pos - start);
}

// ----------------------------------------------------------- band maps

// transmitted line -> band slot, per flavor (0 long, 1 short, 2 mixed)
struct BandMaps {
    int16_t map[3][576];
    void build(int sr9) {
        const int16_t* L = SFB_LONG + sr9 * 23;
        const int16_t* S = SFB_SHORT + sr9 * 14;
        for (int s = 0; s < 22; s++)
            for (int i = L[s]; i < L[s + 1]; i++) map[0][i] = int16_t(s);
        // short
        for (int s = 0; s < 13; s++) {
            int lo = S[s], hi = S[s + 1], width = hi - lo;
            for (int w = 0; w < 3; w++)
                for (int k = 0; k < width; k++)
                    map[1][3 * lo + w * width + k] = int16_t(22 + w * 13 + s);
        }
        // mixed
        for (int i = 0; i < 36; i++) map[2][i] = map[0][i];
        int start_sfb = 0;
        while (3 * S[start_sfb] < 36) start_sfb++;
        for (int s = start_sfb; s < 13; s++) {
            int lo = S[s], hi = S[s + 1], width = hi - lo;
            int base = 3 * lo < 36 ? 36 : 3 * lo;
            for (int w = 0; w < 3; w++)
                for (int k = 0; k < width; k++) {
                    int idx = base + w * width + k;
                    if (idx < 576) map[2][idx] = int16_t(22 + w * 13 + s);
                }
        }
    }
};

// -------------------------------------------------------------- spectrum

struct DecodeResult {
    // int16 is exact: |value| <= 15 + 2^13 - 1 = 8206 (escape maximum).
    // 592: the multi-quad fast path stores 16 values unconditionally
    // from pos <= 572 (tail slots are the zero rzero value).
    int16_t spec[592];
    int lines_used;
    bool overrun = false;
    bool has_escape = false;  // any |value| > 2047 (12-bit plane escape)
    bool has_big = false;     // any |value| > 127 (8-bit plane escape)
    int32_t slack;
};

// Resumable per-channel spectrum decode state. decode_spectrum runs it
// to completion for one channel; decode_spectrum_pair INTERLEAVES two
// independent channels' state machines in one loop so their serial
// peek->LUT->skip dependency chains overlap in the out-of-order core
// (the zstd-style two-stream Huffman trick — the bit windows of a
// granule's two channels are known from side info before decoding).
struct SpecCtx {
    BitCur cur;
    DecodeResult* out;
    GranuleBits* br;
    int64_t limit;
    size_t end_pos;
    int pos = 0;
    int bv2;
    int reg = -1;  // current big_values region; -1 = before the first
    int lim = 0;   // current region's line limit
    int phase = 0; // 0 = big_values, 1 = count1, 2 = done
    int region_lim[3];
    int region_tid[3];
    const HuffLut* lut = nullptr;
    const uint32_t* f2 = nullptr;
    const HuffLut* c1;
    const FastQ* fq;
};

static void init_spec(SpecCtx& s, GranuleBits& br, const GranSI& g, int sr9,
                      int part3, DecodeResult* out) {
    memset(out->spec, 0, sizeof(out->spec));
    out->overrun = false;
    s.out = out;
    s.br = &br;
    s.end_pos = br.pos + size_t(part3);
    s.cur.init(br);
    s.limit = part3;
    const int16_t* L = SFB_LONG + sr9 * 23;
    const int16_t* S = SFB_SHORT + sr9 * 14;
    int bv2 = g.big_values * 2;
    if (bv2 > 576) bv2 = 576;
    s.bv2 = bv2;
    int r1, r2;
    if (g.window_switching) {
        r1 = (g.block_type == 2 && !g.mixed) ? 3 * S[3] : L[8];
        r2 = bv2;
    } else {
        int i1 = g.region0_count + 1; if (i1 > 22) i1 = 22;
        int i2 = g.region0_count + 1 + g.region1_count + 1; if (i2 > 22) i2 = 22;
        r1 = L[i1];
        r2 = L[i2];
    }
    if (r1 > bv2) r1 = bv2;
    if (r2 > bv2) r2 = bv2;
    s.region_lim[0] = r1;
    s.region_lim[1] = r2;
    s.region_lim[2] = bv2;
    s.region_tid[0] = g.table_select[0];
    s.region_tid[1] = g.table_select[1];
    s.region_tid[2] = g.table_select[2];
    s.pos = 0;
    s.reg = -1;
    s.lim = 0;
    s.phase = 0;
    s.c1 = &g_c1[g.count1table_select];
    s.fq = &g_fastq[g.count1table_select];
}

// One decode step: a big_values symbol (or region transition) or a
// count1 step. Returns false once the channel is done. Semantics are
// the original single-channel loops', statement for statement.
static inline __attribute__((always_inline)) bool spec_step(SpecCtx& s) {
    DecodeResult* out = s.out;
    BitCur& cur = s.cur;
    if (s.phase == 0) {
        if (s.pos >= s.lim) {
            // advance to the next live region (one cheap step)
            for (;;) {
                s.reg++;
                if (s.reg >= 3 || s.pos >= s.bv2) { s.phase = 1; return true; }
                s.lim = s.region_lim[s.reg];
                if (s.lim <= s.pos) continue;
                int tid = s.region_tid[s.reg];
                // table 0 = all-zero; ids 4/14 are unused in the spec —
                // corrupt streams selecting them decode as zeros. Such a
                // region consumes no bits, so a granule whose bits end
                // where it starts has not overrun (as the Python unpacker)
                if (tid == 0 || g_luts[tid].root.empty()) {
                    s.pos = s.lim;
                    continue;
                }
                s.lut = &g_luts[tid];
                s.f2 = g_fast2[tid].tab.empty() ? nullptr
                                                : g_fast2[tid].tab.data();
                return true;
            }
        }
        // corrupt streams: big_values may claim more symbols than
        // part2_3_length holds — stop at the granule bit boundary
        if (cur.used() >= s.limit) {
            out->overrun = true;
            s.phase = 1;
            return true;
        }
        PROF_PAIR(s.region_tid[s.reg]);
        if (s.f2) {
            uint32_t fe = s.f2[cur.peek(12)];
            if (int32_t(fe) < 0) {  // valid1: pair fused in one lookup
                PROF_FASTHIT(s.region_tid[s.reg]);
                // Predicated emit — entry kind (one- vs two-pair) is
                // data-dependent and mispredicts badly as a branch.
                // Two pairs only when both fit the region AND the
                // granule bit budget (so the per-pair overrun check
                // between them could not have fired). spec[pos+2/3]
                // always written: zeros there are the correct rzero
                // value if the loop ends, else overwritten.
                bool two = (fe >> 30) & 1;
                int btot = int((fe >> 26) & 15);
                bool ok = two && s.pos + 4 <= s.lim &&
                          cur.used() + btot <= s.limit;
                int x0 = two ? int(fe & 31) - 15 : int(int8_t(fe));
                int y0 = two ? int((fe >> 5) & 31) - 15 : int(int8_t(fe >> 8));
                int x1 = ok ? int((fe >> 10) & 31) - 15 : 0;
                int y1 = ok ? int((fe >> 15) & 31) - 15 : 0;
                out->spec[s.pos] = int16_t(x0);
                out->spec[s.pos + 1] = int16_t(y0);
                out->spec[s.pos + 2] = int16_t(x1);
                out->spec[s.pos + 3] = int16_t(y1);
                cur.skip(ok ? btot : int((fe >> 22) & 15));
                s.pos += 2 + 2 * int(ok);
                return true;
            }
        }
        const HuffLut& lut = *s.lut;
        uint16_t e = lut.decode(cur);
        int x = (e >> 4) & 15, y = e & 15;
        if (x == 15 && lut.linbits) x += cur.read(lut.linbits);
        if (x && cur.read1()) x = -x;
        if (y == 15 && lut.linbits) y += cur.read(lut.linbits);
        if (y && cur.read1()) y = -y;
        if (x > 127 || x < -127 || y > 127 || y < -127) {
            out->has_big = true;
            if (x > 2047 || x < -2047 || y > 2047 || y < -2047)
                out->has_escape = true;
        }
        out->spec[s.pos] = int16_t(x);
        out->spec[s.pos + 1] = int16_t(y);
        s.pos += 2;
        return true;
    }
    if (s.phase == 1) {
        if (!(cur.used() < s.limit && s.pos <= 572)) {
            s.phase = 2;
            return false;
        }
        PROF_PAIR(32);
        uint64_t e64 = s.fq->tab[cur.peek(10)];
        if (int64_t(e64) < 0) {
            PROF_FASTHIT(32);
            int nq = int((e64 >> 48) & 15);
            int btot = int((e64 >> 56) & 63);
            uint32_t vals = uint32_t(e64);
            // multi-quad: up to 4 quads from one 10-bit peek, valid
            // only when every quad start stays inside both the line
            // region and the bit budget (so the per-quad loop checks
            // could not have fired between them)
            if (nq > 1 && cur.used() + btot <= s.limit &&
                s.pos + 4 * nq <= 576) {
#if defined(__BMI2__) && defined(__AVX2__)
                // expand 16 2-bit fields -> 16 int16 (v+1 values; the
                // tail past 4*nq holds 1 = rzero zero, safe to store)
                const uint64_t M = 0x0003000300030003ull;
                __m256i x = _mm256_set_epi64x(
                    int64_t(_pdep_u64(vals >> 24, M)),
                    int64_t(_pdep_u64((vals >> 16) & 0xFF, M)),
                    int64_t(_pdep_u64((vals >> 8) & 0xFF, M)),
                    int64_t(_pdep_u64(vals & 0xFF, M)));
                _mm256_storeu_si256(
                    reinterpret_cast<__m256i*>(out->spec + s.pos),
                    _mm256_sub_epi16(x, _mm256_set1_epi16(1)));
#else
                for (int j = 0; j < 16; j++)
                    out->spec[s.pos + j] =
                        int16_t(int((vals >> (2 * j)) & 3) - 1);
#endif
                cur.skip(btot);
                s.pos += 4 * nq;
                return true;
            }
            // single quad (reference semantics: decoded even if it
            // overruns the bit budget; the partial-quad discard in
            // finish_spec zeroes it again in that case)
            cur.skip(int((e64 >> 52) & 15));
            out->spec[s.pos + 0] = int16_t(int(vals & 3) - 1);
            out->spec[s.pos + 1] = int16_t(int((vals >> 2) & 3) - 1);
            out->spec[s.pos + 2] = int16_t(int((vals >> 4) & 3) - 1);
            out->spec[s.pos + 3] = int16_t(int((vals >> 6) & 3) - 1);
            s.pos += 4;
            return true;
        }
        uint16_t e = s.c1->decode(cur);
        int quad = e & 0xFF;
        for (int j = 0; j < 4; j++) {
            int v = (quad >> (3 - j)) & 1;
            if (v && cur.read1()) v = -1;
            out->spec[s.pos + j] = v;
        }
        s.pos += 4;
        return true;
    }
    return false;
}

static void finish_spec(SpecCtx& s) {
    DecodeResult* out = s.out;
    bool c1_overrun = s.cur.used() > s.limit;
    out->overrun = out->overrun || c1_overrun;
    out->slack = int32_t(s.limit - s.cur.used());
    int pos = s.pos;
    if (c1_overrun && pos >= 4) {
        // partial last count1 quadruple: discard it [common practice]
        for (int j = pos - 4; j < pos; j++) out->spec[j] = 0;
        pos -= 4;
    }
    out->lines_used = pos < 0 ? 0 : (pos < 576 ? pos : 576);
    s.br->pos = s.end_pos;
}


// Interleaved multi-window decode: one loop steps 2-4 independent
// state machines so their serial bit-cursor->LUT->skip dependency
// chains overlap in the out-of-order core (the zstd multi-stream
// Huffman trick). An MPEG-1 stereo frame exposes FOUR independent bit
// windows (2 granules x 2 channels, offsets known from side info), so
// the whole frame decodes in one fused loop. Outputs are bit-identical
// to sequential decode by construction — spec_step IS the
// single-channel step. Measured ~1.3x (2-way) over sequential by cycle
// count on the 1-core bench host.
static void decode_spectrum_multi(SpecCtx* const* v, int k) {
    PROF_DECL;
    switch (k) {
    case 4:
        // two 2-way pairs, not one 4-way loop: four live SpecCtx states
        // exceed the register budget and the spills cost more than the
        // extra ILP buys (measured: 4-way ~3% slower than 2x2)
        for (;;) {
            bool r0 = spec_step(*v[0]);
            bool r1 = spec_step(*v[1]);
            if (!(r0 | r1)) break;
        }
        for (;;) {
            bool r2 = spec_step(*v[2]);
            bool r3 = spec_step(*v[3]);
            if (!(r2 | r3)) break;
        }
        break;
    case 3:
        for (;;) {
            bool r0 = spec_step(*v[0]);
            bool r1 = spec_step(*v[1]);
            bool r2 = spec_step(*v[2]);
            if (!(r0 | r1 | r2)) break;
        }
        break;
    case 2:
        for (;;) {
            bool r0 = spec_step(*v[0]);
            bool r1 = spec_step(*v[1]);
            if (!(r0 | r1)) break;
        }
        break;
    default:
        for (int i = 0; i < k; i++)
            while (spec_step(*v[i])) {
            }
        break;
    }
    PROF_ACC(4);
    for (int i = 0; i < k; i++) finish_spec(*v[i]);
    PROF_ACC(5);
}

// --------------------------------------------------------------- stereo

// palette index layout: see mp3tpu/tables/stereo_palette.py (shared contract)
static const int IDX_LR = 0, IDX_MS = 1;
static inline int idx_mpeg1(int pos, bool ms) { return (ms ? 9 : 2) + pos; }
static inline int idx_lsf(int pos, int scale, bool ms) {
    return (ms ? 80 : 16) + scale * 32 + pos;
}

static void stereo_modes(const Header& h, const Scf& sf_r,
                         const bool* nonzero_band, bool lsf, uint8_t* out /*64*/) {
    memset(out, 0, 64);
    if (h.channels == 1) return;
    bool ms = h.mode == 1 && (h.mode_ext & 2);
    bool ist = h.mode == 1 && (h.mode_ext & 1);
    if (ms && !ist) {
        memset(out, IDX_MS, 64);
        return;
    }
    if (!ist) return;
    static const int groups[4][2] = {{0, 22}, {22, 35}, {35, 48}, {48, 61}};
    for (int gi = 0; gi < 4; gi++) {
        int lo = groups[gi][0], hi = groups[gi][1];
        int bound = 0;
        for (int sI = lo; sI < hi; sI++)
            if (nonzero_band[sI]) bound = sI - lo + 1;
        for (int j = 0; j < hi - lo; j++) {
            int slot = lo + j;
            if (j < bound) {
                out[slot] = ms ? IDX_MS : IDX_LR;
                continue;
            }
            int pos, illegal;
            if (slot < 22) {
                pos = sf_r.long_sf[slot];
                illegal = lsf ? sf_r.long_max[slot] : 7;
            } else {
                int w = (slot - 22) / 13, sb = (slot - 22) % 13;
                pos = sf_r.short_sf[sb][w];
                illegal = lsf ? sf_r.short_max[sb][w] : 7;
            }
            if (pos == illegal) {
                out[slot] = ms ? IDX_MS : IDX_LR;
                continue;
            }
            out[slot] = uint8_t(lsf ? idx_lsf(pos, sf_r.intensity_scale, ms)
                                    : idx_mpeg1(pos, ms));
        }
    }
}

// ------------------------------------------------------------ frame scan

struct Scan {
    std::vector<size_t> offsets;
    std::vector<Header> headers;
};

static bool scan_frames(const uint8_t* d, size_t len, Scan* out) {
    size_t pos = 0;
    while (pos + 4 <= len) {
        Header h;
        bool ok = false;
        if (parse_header(word_at(d, pos), &h) && pos + h.frame_bytes <= len + 4) {
            size_t nxt = pos + h.frame_bytes;
            if (nxt + 4 > len) {
                ok = true;
            } else {
                Header h2;
                ok = parse_header(word_at(d, nxt), &h2) && h2.version == h.version &&
                     h2.sr == h.sr;
            }
        }
        if (ok) {
            if (pos + h.frame_bytes > len) break;
            out->offsets.push_back(pos);
            out->headers.push_back(h);
            pos += h.frame_bytes;
        } else {
            pos += 1;
        }
    }
    return !out->headers.empty();
}

}  // namespace

// ------------------------------------------------------------------ ABI

extern "C" {

// Returns granule count (frames * ngr) or -1; fills meta[4] =
// {sample_rate, channels, version, n_frames}.
int mp3tpu_probe(const uint8_t* data, int64_t len, int32_t* meta) {
    ensure_init();
    Scan sc;
    if (!scan_frames(data, size_t(len), &sc)) return -1;
    const Header& h0 = sc.headers[0];
    meta[0] = h0.sr;
    meta[1] = h0.channels;
    meta[2] = h0.version;
    meta[3] = int32_t(sc.offsets.size());
    return int(sc.offsets.size()) * h0.ngr;
}

// Unpack the whole stream. Caller allocates arrays sized by mp3tpu_probe.
// Layouts match mp3tpu.bitstream.unpack.SymbolTensors.
// Layouts match mp3tpu.bitstream.unpack.SymbolTensors. When win > 0 the
// five per-granule outputs are written window-major into a batch tensor
// [n_win, n_streams, win, ...] at stream `stream_idx` (zero-copy batch
// assembly for the scheduler/bench); win == 0 means plain [G, ...].
// When is12_out != nullptr, the spectrum is additionally emitted packed:
// 12-bit signed big-endian pairs (3 bytes per 2 lines, 864 B per
// granule-channel) with values outside [-2047, 2047] clamped in the
// packed plane and carried exactly in an escape channel esc_out
// [G,2,16,2] = (line, value), line -1 = empty. Returns -2 if any
// granule-channel has more than 16 escapes (caller falls back to int16).
// Core frame-range unpacker. The bit reservoir is the ONLY state that
// crosses frames (scfsi sharing is frame-local), so it is externalized:
// callers stream a file window-by-window by carrying `reservoir`
// between calls (SURVEY.md §3.3 unpack_window / §5.7 seekpoint chunks).
// Output rows: with win==0, arrays hold [f1-f0 frames * ngr, ...] local
// rows (g_base subtracted); with win>0, absolute window-major batch
// rows [n_win, n_streams, win, ...] (zero-copy batch assembly).
static int unpack_range(const uint8_t* data, const Scan& sc,
                        int f0, int f1, int g_base,
                        std::vector<uint8_t>& reservoir,
                        int16_t* is_out, int16_t* exp_out, int8_t* bt_out,
                        uint8_t* mixed_out, uint8_t* smode_out,
                        int16_t* err_out, int32_t* slack_out,
                        int32_t* lines_out,
                        int32_t stream_idx, int32_t n_streams, int32_t win,
                        uint8_t* is12_out, int16_t* esc_out,
                        int32_t plane_bits) {
    // flag 0x10: exponents as the compact uint8[65] plane (gg + biased
    // band offsets); low nibble selects the spectrum plane width
    bool exp_bytes = (plane_bits & 0x10) != 0;
    plane_bits &= 0xF;
    const Header& h0 = sc.headers[0];
    bool lsf = h0.lsf;
    int sr9 = h0.sr_idx9;
    int nch = h0.channels;
    int ngr = h0.ngr;
    BandMaps bmaps;
    bmaps.build(sr9);

    Scf prev_sf[2];
    bool have_prev[2] = {false, false};
    GranuleBits br_gc[2][2];  // per granule x channel, reused per frame
    int16_t local_spec[2][576];  // int16 plane when is_out == nullptr

    auto row = [&](int g) -> size_t {  // window-major batch row index
        if (win <= 0) return size_t(g - g_base);
        return size_t(g / win) * size_t(n_streams) * win +
               size_t(stream_idx) * win + size_t(g % win);
    };

    for (size_t fi = size_t(f0); fi < size_t(f1); fi++) {
        PROF_DECL;
        size_t off = sc.offsets[fi];
        const Header& h = sc.headers[fi];
        size_t si_start = off + 4 + (h.crc ? 2 : 0);
        BitReader sir{data + si_start, size_t(h.side_bytes)};
        SideInfo si;
        parse_side_info(sir, h, &si);
        bool crc_ok = check_crc(data, off, h);

        size_t main_start = si_start + h.side_bytes;
        size_t main_len = off + h.frame_bytes - main_start;
        size_t frame_data_start = reservoir.size() >= size_t(si.main_data_begin)
                                      ? reservoir.size() - si.main_data_begin
                                      : SIZE_MAX;
        bool underflow = frame_data_start == SIZE_MAX;
        reservoir.insert(reservoir.end(), data + main_start, data + main_start + main_len);
        size_t bitpos = underflow ? 0 : frame_data_start * 8;
        PROF_ACC(1);

        // Phase 1 — per granule-channel: side-channel outputs, scf read,
        // spectrum-decode context init. All of a frame's bit windows
        // (up to 2 granules x 2 channels) are known once side info and
        // scalefactors are read, so phase 2 decodes them in ONE
        // interleaved loop (independent Huffman chains overlap).
        Scf sf_all[2][2];
        DecodeResult dr_all[2][2];
        SpecCtx sctx[2][2];
        bool active[2][2] = {{false, false}, {false, false}};
        SpecCtx* live[4];
        int nlive = 0;
        for (int gr = 0; gr < ngr; gr++) {
            int gidx = int(fi) * ngr + gr;
            int gl = gidx - g_base;  // local row for err/slack/lines
            if (!crc_ok) err_out[gl] |= 4;
            size_t gr_row = row(gidx);
            if (underflow) {
                err_out[gl] |= 1;
                for (int ch = 0; ch < nch; ch++) {
                    const GranSI& g = si.gr[gr][ch];
                    bt_out[gr_row * 2 + ch] = int8_t(g.block_type);
                    mixed_out[gr_row * 2 + ch] = uint8_t(g.mixed);
                }
                continue;
            }
            for (int ch = 0; ch < nch; ch++) {
                const GranSI& g = si.gr[gr][ch];
                bt_out[gr_row * 2 + ch] = int8_t(g.block_type);
                mixed_out[gr_row * 2 + ch] = uint8_t(g.mixed);
                GranuleBits& br = br_gc[gr][ch];
                br.init(reservoir.data(), reservoir.size(), bitpos,
                        size_t(g.part2_3_length));
                bitpos += g.part2_3_length;
                PROF_ACC(2);
                Scf& sf = sf_all[gr][ch];
                if (lsf) {
                    bool int_ch = (h.mode == 1 && (h.mode_ext & 1)) && ch == 1;
                    read_scf_lsf(br, g, int_ch, &sf);
                } else {
                    read_scf_mpeg1(br, g, si.scfsi[ch],
                                   have_prev[ch] ? &prev_sf[ch] : nullptr, gr, &sf);
                    if (gr == 0) { prev_sf[ch] = sf; have_prev[ch] = true; }
                }
                PROF_ACC(3);
                int part3 = g.part2_3_length - sf.part2_bits;
                if (part3 < 0) { err_out[gl] |= 8; continue; }
                init_spec(sctx[gr][ch], br, g, sr9, part3, &dr_all[gr][ch]);
                active[gr][ch] = true;
                live[nlive++] = &sctx[gr][ch];
            }
        }
        // Phase 2 — fused interleaved decode of the whole frame
        decode_spectrum_multi(live, nlive);
        PROF_ACC(15);  // scratch: spec total incl. call overhead
        // Phase 3 — per granule-channel: copy/pack planes, exponents,
        // then the granule's stereo-mode row
        for (int gr = 0; gr < ngr; gr++) {
            int gidx = int(fi) * ngr + gr;
            int gl = gidx - g_base;
            size_t gr_row = row(gidx);
            if (underflow) continue;
            Scf* sf_pair = sf_all[gr];
            for (int ch = 0; ch < nch; ch++) {
                if (!active[gr][ch]) continue;
                const GranSI& g = si.gr[gr][ch];
                Scf& sf = sf_all[gr][ch];
                DecodeResult& dr = dr_all[gr][ch];
                slack_out[gl * 2 + ch] = dr.slack;
                lines_out[gl * 2 + ch] = dr.lines_used;
                if (dr.overrun) err_out[gl] |= 2;
                // spec[i >= lines_used] is all-zero: copy/pack only the
                // live prefix, memset the tail (at 128 kbps the rzero
                // tail is typically ~half the 576 lines)
                int lines = dr.lines_used;
                int16_t* dst = is_out ? is_out + (gr_row * 2 + ch) * 576
                                      : local_spec[ch];
                memcpy(dst, dr.spec, size_t(lines) * 2);
                memset(dst + lines, 0, size_t(576 - lines) * 2);
                PROF_ACC(15);
                if (is12_out && plane_bits == 4) {
                    // 4-bit plane (288 B/gc): two lines per byte, nibble
                    // = value+7 for [-7,7], 15 = escape. The sideband is
                    // POSITION-FREE and TWO-LEVEL: int8[64] escape
                    // values in line order (the device recovers
                    // positions from the marker nibbles by cumsum
                    // rank); the rare |v|>127 escapes store marker -128
                    // and their exact value in an 8-slot second level
                    // ([64:72] low bytes, [72:80] high bytes), indexed
                    // by rank among -128 markers. 368 B/gc total, ~1.7x
                    // fewer staged bytes than the 8-bit plane; overflow
                    // (>64 escapes or >8 deep ones) -> caller widens.
                    uint8_t* p4 = is12_out + (gr_row * 2 + ch) * 288;
                    int8_t* esc = reinterpret_cast<int8_t*>(esc_out)
                                  + (gr_row * 2 + ch) * 80;
                    memset(esc, 0, 80);
                    int ne = 0, nbig = 0;
                    int pairs2 = (lines + 1) & ~1;
#ifdef MP3TPU_AVX512_PACK
                    // AVX-512 pack: all 9 64-line chunks unconditionally
                    // (the zero tail encodes to 0x77, exactly what the
                    // scalar path memsets). Escapes are pulled out in
                    // line order by masked compress-stores.
                    (void)pairs2;
                    const __m512i k7 = _mm512_set1_epi16(7);
                    const __m512i k15 = _mm512_set1_epi16(15);
                    const __m512i kff = _mm512_set1_epi32(0xFF);
                    for (int c0 = 0; c0 < 576; c0 += 64) {
                        __m512i v0 = _mm512_loadu_si512(dst + c0);
                        __m512i v1 = _mm512_loadu_si512(dst + c0 + 32);
                        __mmask32 e0 =
                            _mm512_cmpgt_epi16_mask(_mm512_abs_epi16(v0), k7);
                        __mmask32 e1 =
                            _mm512_cmpgt_epi16_mask(_mm512_abs_epi16(v1), k7);
                        __m512i n0 = _mm512_mask_blend_epi16(
                            e0, _mm512_add_epi16(v0, k7), k15);
                        __m512i n1 = _mm512_mask_blend_epi16(
                            e1, _mm512_add_epi16(v1, k7), k15);
                        // epi32 lane = lo16 | hi16<<16, both in [0,15]:
                        // byte = lo | hi<<4 = (x | x>>12) & 0xFF
                        __m512i b0 = _mm512_and_si512(
                            _mm512_or_si512(n0, _mm512_srli_epi32(n0, 12)), kff);
                        __m512i b1 = _mm512_and_si512(
                            _mm512_or_si512(n1, _mm512_srli_epi32(n1, 12)), kff);
                        _mm_storeu_si128(
                            reinterpret_cast<__m128i*>(p4 + (c0 >> 1)),
                            _mm512_cvtepi32_epi8(b0));
                        _mm_storeu_si128(
                            reinterpret_cast<__m128i*>(p4 + (c0 >> 1) + 16),
                            _mm512_cvtepi32_epi8(b1));
                        if (e0 | e1) {
                            alignas(64) int16_t tmp[64];
                            _mm512_mask_compressstoreu_epi16(tmp, e0, v0);
                            int k0 = __builtin_popcount(e0);
                            _mm512_mask_compressstoreu_epi16(tmp + k0, e1, v1);
                            int k = k0 + __builtin_popcount(e1);
                            for (int t = 0; t < k; t++) {
                                int v = tmp[t];
                                if (ne >= 64) return -2;
                                if (v >= -127 && v <= 127) {
                                    esc[ne++] = int8_t(v);
                                } else {
                                    if (nbig >= 8) return -2;
                                    esc[ne++] = -128;
                                    esc[64 + nbig] = int8_t(uint8_t(v & 255));
                                    esc[72 + nbig] = int8_t(v >> 8);
                                    nbig++;
                                }
                            }
                        }
                    }
#else
                    // 64-line chunks: escape-free chunks (most of the
                    // spectrum above the low bands) take a branchless
                    // pack the compiler vectorizes
                    for (int c0 = 0; c0 < pairs2; c0 += 64) {
                        int c1 = c0 + 64 < pairs2 ? c0 + 64 : pairs2;
                        int mx = 0;
                        for (int i = c0; i < c1; i++) {
                            int av = dst[i] < 0 ? -dst[i] : dst[i];
                            mx = av > mx ? av : mx;
                        }
                        if (mx <= 7) {
                            for (int i = c0; i < c1; i += 2)
                                p4[i >> 1] = uint8_t(uint32_t(dst[i] + 7) |
                                                     (uint32_t(dst[i + 1] + 7) << 4));
                            continue;
                        }
                        for (int i = c0; i < c1; i += 2) {
                            uint32_t nib[2];
                            for (int k = 0; k < 2; k++) {
                                int v = dst[i + k];
                                if (v > 7 || v < -7) {
                                    if (ne >= 64) return -2;
                                    if (v >= -127 && v <= 127) {
                                        esc[ne++] = int8_t(v);
                                    } else {
                                        if (nbig >= 8) return -2;
                                        esc[ne++] = -128;
                                        esc[64 + nbig] = int8_t(uint8_t(v & 255));
                                        esc[72 + nbig] = int8_t(v >> 8);
                                        nbig++;
                                    }
                                    nib[k] = 15;
                                } else {
                                    nib[k] = uint32_t(v + 7);
                                }
                            }
                            p4[i >> 1] = uint8_t(nib[0] | (nib[1] << 4));
                        }
                    }
                    // zero tail decodes as nibble 0 -> value -7 on a
                    // naive read; memset the encoded zero (0x77) instead
                    memset(p4 + (pairs2 >> 1), 0x77, size_t(288 - (pairs2 >> 1)));
#endif
                } else if (is12_out && plane_bits == 8) {
                    // 8-bit signed plane (576 B/gc): values in [-127,127]
                    // stored directly, larger carried in the escape
                    // sideband — 1.5x fewer staged bytes than 12-bit
                    int8_t* p8 = reinterpret_cast<int8_t*>(is12_out)
                                 + (gr_row * 2 + ch) * 576;
                    int16_t* esc = esc_out + (gr_row * 2 + ch) * 32;
                    for (int e = 0; e < 16; e++) { esc[e * 2] = -1; esc[e * 2 + 1] = 0; }
                    if (!dr.has_big) {  // common case: straight narrowing
                        for (int i = 0; i < lines; i++) p8[i] = int8_t(dst[i]);
                    } else {
                        int ne = 0;
                        for (int i = 0; i < lines; i++) {
                            int v = dst[i];
                            if (v > 127 || v < -127) {
                                if (ne >= 16) return -2;
                                esc[ne * 2] = int16_t(i);
                                esc[ne * 2 + 1] = int16_t(v);
                                ne++;
                                v = v > 0 ? 127 : -127;
                            }
                            p8[i] = int8_t(v);
                        }
                    }
                    memset(p8 + lines, 0, size_t(576 - lines));
                } else if (is12_out) {
                    uint8_t* p12 = is12_out + (gr_row * 2 + ch) * 864;
                    int16_t* esc = esc_out + (gr_row * 2 + ch) * 32;
                    for (int e = 0; e < 16; e++) { esc[e * 2] = -1; esc[e * 2 + 1] = 0; }
                    int pairs = (lines + 1) >> 1;
                    if (!dr.has_escape) {  // common case: branch-free pack
                        for (int i = 0; i < pairs * 2; i += 2) {
                            uint32_t ua = uint32_t(dst[i] & 0xFFF);
                            uint32_t ub = uint32_t(dst[i + 1] & 0xFFF);
                            p12[i / 2 * 3 + 0] = uint8_t(ua >> 4);
                            p12[i / 2 * 3 + 1] = uint8_t(((ua & 0xF) << 4) | (ub >> 8));
                            p12[i / 2 * 3 + 2] = uint8_t(ub & 0xFF);
                        }
                    } else {
                        int ne = 0;
                        for (int i = 0; i < pairs * 2; i += 2) {
                            int a = dst[i], b = dst[i + 1];
                            if (a > 2047 || a < -2047) {
                                if (ne >= 16) return -2;
                                esc[ne * 2] = int16_t(i); esc[ne * 2 + 1] = int16_t(a);
                                ne++; a = a > 0 ? 2047 : -2047;
                            }
                            if (b > 2047 || b < -2047) {
                                if (ne >= 16) return -2;
                                esc[ne * 2] = int16_t(i + 1); esc[ne * 2 + 1] = int16_t(b);
                                ne++; b = b > 0 ? 2047 : -2047;
                            }
                            uint32_t ua = uint32_t(a & 0xFFF), ub = uint32_t(b & 0xFFF);
                            p12[i / 2 * 3 + 0] = uint8_t(ua >> 4);
                            p12[i / 2 * 3 + 1] = uint8_t(((ua & 0xF) << 4) | (ub >> 8));
                            p12[i / 2 * 3 + 2] = uint8_t(ub & 0xFF);
                        }
                    }
                    memset(p12 + pairs * 3, 0, size_t(864 - pairs * 3));
                }
                PROF_ACC(6);
                // band exponents
                int gg = g.global_gain - 210;
                int shift = 2 * (g.scalefac_scale + 1);
                if (exp_bytes) {
                    // compact plane: [gg, (e - gg) + 128] as uint8[65]
                    // per gc — 2x fewer staged bytes. Offsets are in
                    // [-128, 0] for MPEG-1 (shift*(sf+pretab) <= 72,
                    // 8*sbg <= 56); out-of-range (possible under LSF)
                    // -> caller falls back to int16 exponents. Slots a
                    // granule's flavor never reads get offset 0 (the
                    // int16 plane stores 0 there; both are dead values
                    // masked by the flavor-selected band expansion).
                    uint8_t* eb = reinterpret_cast<uint8_t*>(exp_out)
                                  + (gr_row * 2 + ch) * 65;
                    eb[0] = uint8_t(g.global_gain);
                    memset(eb + 1, 128, 64);
                    for (int b = 0; b < 22; b++) {
                        int off = -shift * (sf.long_sf[b] + sf.preflag * PRETAB[b]);
                        if (off < -128) return -3;
                        eb[1 + b] = uint8_t(off + 128);
                    }
                    for (int w = 0; w < 3; w++)
                        for (int b = 0; b < 13; b++) {
                            int off = -8 * g.subblock_gain[w] - shift * sf.short_sf[b][w];
                            if (off < -128) return -3;
                            eb[1 + 22 + w * 13 + b] = uint8_t(off + 128);
                        }
                } else {
                    int16_t* eo = exp_out + (gr_row * 2 + ch) * 64;
                    for (int b = 0; b < 22; b++)
                        eo[b] = int16_t(gg - shift * (sf.long_sf[b] + sf.preflag * PRETAB[b]));
                    for (int w = 0; w < 3; w++)
                        for (int b = 0; b < 13; b++)
                            eo[22 + w * 13 + b] =
                                int16_t(gg - 8 * g.subblock_gain[w] - shift * sf.short_sf[b][w]);
                }
                PROF_ACC(7);
            }
            if (nch == 2) {
                const GranSI& g1 = si.gr[gr][1];
                bool nzb[64] = {false};
                // the nonzero-band boundary only matters for intensity
                // stereo; plain L/R and MS-only frames (the common case)
                // skip the spectrum scan entirely
                if (h.mode == 1 && (h.mode_ext & 1)) {
                    int fl = g1.block_type != 2 ? 0 : (g1.mixed ? 2 : 1);
                    const int16_t* spec1 = is_out ? is_out + (gr_row * 2 + 1) * 576
                                                  : local_spec[1];
                    int lines1 = lines_out[gl * 2 + 1];  // zero beyond
                    for (int i = 0; i < lines1; i++)
                        if (spec1[i]) nzb[bmaps.map[fl][i]] = true;
                }
                stereo_modes(h, sf_pair[1], nzb, lsf, smode_out + gr_row * 64);
                PROF_ACC(8);
            }
        }
        // trim reservoir
        if (reservoir.size() > 65536) {
            size_t cut = reservoir.size() - 1024;
            reservoir.erase(reservoir.begin(), reservoir.begin() + cut);
            if (bitpos >= cut * 8) { /* bitpos no longer used this frame */ }
        }
    }
    return (f1 - f0) * sc.headers[0].ngr;
}

int mp3tpu_unpack(const uint8_t* data, int64_t len,
                  int16_t* is_out,      // [G,2,576]
                  int16_t* exp_out,     // [G,2,64]
                  int8_t* bt_out,       // [G,2]
                  uint8_t* mixed_out,   // [G,2]
                  uint8_t* smode_out,   // [G,64]
                  int16_t* err_out,     // [G]
                  int32_t* slack_out,   // [G,2]
                  int32_t* lines_out,   // [G,2]
                  int32_t stream_idx, int32_t n_streams, int32_t win,
                  uint8_t* is12_out, int16_t* esc_out, int32_t plane_bits) {
    ensure_init();
    PROF_DECL;
    Scan sc;
    if (!scan_frames(data, size_t(len), &sc)) return -1;
    PROF_ACC(0);
    std::vector<uint8_t> reservoir;
    reservoir.reserve(size_t(len) < 65536 ? size_t(len) : 65536);
    return unpack_range(data, sc, 0, int(sc.offsets.size()), 0, reservoir,
                        is_out, exp_out, bt_out, mixed_out, smode_out,
                        err_out, slack_out, lines_out,
                        stream_idx, n_streams, win, is12_out, esc_out,
                        plane_bits);
}

// Windowed incremental unpack (SURVEY.md §3.3): decode frames [f0, f1)
// with the bit reservoir carried in a caller-owned state buffer
// (res_state/res_len, capacity res_cap >= 1024). Pass res_len=0 at
// stream start, or a reservoir pre-seeded with preceding frames' main
// data for a mid-stream (seek) start. Output arrays hold (f1-f0)*ngr
// local rows when win==0, or absolute window-major batch rows when
// win>0. Returns the granule count decoded, or <0 on error.
int mp3tpu_unpack_window(const uint8_t* data, int64_t len,
                         int32_t f0, int32_t f1,
                         uint8_t* res_state, int32_t* res_len,
                         int32_t res_cap,
                         int16_t* is_out, int16_t* exp_out, int8_t* bt_out,
                         uint8_t* mixed_out, uint8_t* smode_out,
                         int16_t* err_out, int32_t* slack_out,
                         int32_t* lines_out,
                         int32_t stream_idx, int32_t n_streams, int32_t win,
                         uint8_t* is12_out, int16_t* esc_out,
                         int32_t plane_bits) {
    ensure_init();
    Scan sc;
    if (!scan_frames(data, size_t(len), &sc)) return -1;
    if (f0 < 0 || f1 > int(sc.offsets.size()) || f0 > f1) return -1;
    std::vector<uint8_t> reservoir(res_state, res_state + *res_len);
    int r = unpack_range(data, sc, f0, f1, f0 * sc.headers[0].ngr, reservoir,
                         is_out, exp_out, bt_out, mixed_out, smode_out,
                         err_out, slack_out, lines_out,
                         stream_idx, n_streams, win, is12_out, esc_out,
                         plane_bits);
    if (r < 0) return r;
    // carry the reservoir tail (main_data_begin reaches back <= 511 B)
    size_t keep = reservoir.size() > 1024 ? 1024 : reservoir.size();
    if (int32_t(keep) > res_cap) keep = size_t(res_cap);
    memcpy(res_state, reservoir.data() + reservoir.size() - keep, keep);
    *res_len = int32_t(keep);
    return r;
}

}  // extern "C"
