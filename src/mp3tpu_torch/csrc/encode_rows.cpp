// mp3tpu native batched granule emitter (SURVEY.md E5/E6 fast path).
//
// Mirrors mp3tpu.encoder.huffcode.encode_granule bit-for-bit for R
// granule-channel rows at once (tested row-for-row against the Python
// emitter): scalefactor fields, three-region / window-switched pair
// coding with linbits escapes and signs, count1 quads. The Python
// emitter remains the semantics reference; this exists because Python
// emission, bit by bit, dominates a batch encode's wall.
//
// Copy of src/mp3tpu/native/encode_rows.cpp (the JAX package's row
// emitter), kept in the port; the code is the same.
// C ABI only; mp3tpu_torch/kernels/build.py compiles it with g++ into the
// unpacker's library, loaded via ctypes (mp3tpu_torch/bitstream/native.py).

#include <cstdint>
#include <cstring>

#include "spec_tables.h"

namespace {

struct BitOut {
    uint8_t* buf;
    size_t cap;
    size_t bitpos = 0;
    bool overflow = false;

    void put(uint32_t v, int n) {
        if (!n) return;
        size_t end = bitpos + size_t(n);
        if ((end + 7) / 8 > cap) {
            overflow = true;
            return;
        }
        for (int i = n - 1; i >= 0; i--) {
            size_t p = bitpos++;
            if ((v >> i) & 1) buf[p >> 3] |= uint8_t(0x80u >> (p & 7));
        }
    }
};

// huffcode.split_spectrum: trailing zeros form rzero (quad-aligned up),
// preceding |v|<=1 quads form count1, rest is big values.
static void split_spectrum(const int16_t* ix, int* bv, int* c1n) {
    int last = 0;
    for (int i = 575; i >= 0; i--)
        if (ix[i]) { last = i + 1; break; }
    if (!last) { *bv = 0; *c1n = 0; return; }
    int rz = (last + 3) & ~3;
    int c1 = rz;
    while (c1 >= 4) {
        bool small = true;
        for (int j = c1 - 4; j < c1; j++) {
            int v = ix[j] < 0 ? -ix[j] : ix[j];
            if (v > 1) { small = false; break; }
        }
        if (!small) break;
        c1 -= 4;
    }
    *bv = c1 / 2;
    *c1n = (rz - c1) / 4;
}

static int pick_sfc_long(const int16_t* sf) {
    int m1 = 0, m2 = 0;
    for (int b = 0; b < 11; b++) m1 = sf[b] > m1 ? sf[b] : m1;
    for (int b = 11; b < 21; b++) m2 = sf[b] > m2 ? sf[b] : m2;
    int need1 = 0, need2 = 0;
    { int v = m1; while (v) { need1++; v >>= 1; } }
    { int v = m2; while (v) { need2++; v >>= 1; } }
    int best = 0, cost = 1 << 30;
    for (int i = 0; i < 16; i++) {
        int s1 = SLEN1[i], s2 = SLEN2[i];
        if (s1 >= need1 && s2 >= need2) {
            int c = 11 * s1 + 10 * s2;
            if (c < cost) { best = i; cost = c; }
        }
    }
    return best;
}

static int pick_sfc_short(const int16_t* sf /*[3][12] window-major*/) {
    int m1 = 0, m2 = 0;
    for (int w = 0; w < 3; w++) {
        for (int b = 0; b < 6; b++) m1 = sf[w * 12 + b] > m1 ? sf[w * 12 + b] : m1;
        for (int b = 6; b < 12; b++) m2 = sf[w * 12 + b] > m2 ? sf[w * 12 + b] : m2;
    }
    int need1 = 0, need2 = 0;
    { int v = m1; while (v) { need1++; v >>= 1; } }
    { int v = m2; while (v) { need2++; v >>= 1; } }
    int best = 0, cost = 1 << 30;
    for (int i = 0; i < 16; i++) {
        int s1 = SLEN1[i], s2 = SLEN2[i];
        if (s1 >= need1 && s2 >= need2) {
            int c = 18 * (s1 + s2);
            if (c < cost) { best = i; cost = c; }
        }
    }
    return best;
}

static void emit_pairs(BitOut& w, const int16_t* ix, int lo, int hi, int tid) {
    if (tid == 0 || hi <= lo) return;
    const HuffSpec& s = HUFF_SPECS[tid];
    if (!s.n) return;
    int xl = s.n / s.ylen;
    for (int i = lo; i < hi; i += 2) {
        int x = ix[i], y = ix[i + 1];
        int ax = x < 0 ? -x : x, ay = y < 0 ? -y : y;
        int cx = ax < xl - 1 ? ax : xl - 1;
        int cy = ay < s.ylen - 1 ? ay : s.ylen - 1;
        w.put(s.codes[cx * s.ylen + cy], s.lens[cx * s.ylen + cy]);
        if (xl == 16) {
            if (ax >= 15) w.put(uint32_t(ax - 15), s.linbits);
            if (ax > 0) w.put(x < 0 ? 1u : 0u, 1);
            if (ay >= 15) w.put(uint32_t(ay - 15), s.linbits);
            if (ay > 0) w.put(y < 0 ? 1u : 0u, 1);
        } else {
            if (ax > 0) w.put(x < 0 ? 1u : 0u, 1);
            if (ay > 0) w.put(y < 0 ? 1u : 0u, 1);
        }
    }
}

// huffcode._regions_long
static void regions_long(int bv2, int sr9, int* r0c, int* r1c,
                         int* r1, int* r2) {
    const int16_t* bands = SFB_LONG + sr9 * 23;
    int bidx = 0;
    while (bidx < 23 && bands[bidx] < bv2) bidx++;  // searchsorted left
    int a = bidx / 3;
    if (a > 15) a = 15;
    if (a < 0) a = 0;
    int b = bidx - a - 1;
    if (b > 7) b = 7;
    if (b < 0) b = 0;
    if (a + 1 + b + 1 > 22) b = 22 - a - 2;
    int i1 = a + 1 < 22 ? a + 1 : 22;
    int i2 = a + 1 + b + 1 < 22 ? a + 1 + b + 1 : 22;
    *r0c = a;
    *r1c = b;
    *r1 = bands[i1] < bv2 ? bands[i1] : bv2;
    *r2 = bands[i2] < bv2 ? bands[i2] : bv2;
}

}  // namespace

extern "C" {

// Emit R granule-channel rows. Layouts:
//   ix [R,576] int16, block_type [R] u8, use_sf [R] u8,
//   long_sf [R,21] int16, short_sf [R,36] int16 (window-major [3][12]),
//   tsel [R,3] int16, c1table [R] u8,
//   out_bits [R, cap_bytes] u8 (caller-zeroed),
//   out_meta [R,6] int32: {p23, big_values, sfc, r0c, r1c, ovf}
// Returns 0, or -1 if any row overflowed cap_bytes (its ovf flag set).
int mp3tpu_encode_rows(const int16_t* ix, const uint8_t* block_type,
                       const uint8_t* use_sf, const int16_t* long_sf,
                       const int16_t* short_sf, const int16_t* tsel,
                       const uint8_t* c1table, int32_t sr9, int32_t R,
                       uint8_t* out_bits, int32_t cap_bytes,
                       int32_t* out_meta) {
    int any_ovf = 0;
    for (int r = 0; r < R; r++) {
        const int16_t* row = ix + size_t(r) * 576;
        BitOut w{out_bits + size_t(r) * cap_bytes, size_t(cap_bytes)};
        int bt = block_type[r];
        int bv, c1n;
        split_spectrum(row, &bv, &c1n);
        int bv2 = bv * 2;
        int sfc = 0;
        // long scalefactor layout covers block types 0/1/3
        // (start/stop keep the long spectrum + long sfb bands)
        if (use_sf[r] && bt != 2) {
            const int16_t* sf = long_sf + size_t(r) * 21;
            bool anysf = false;
            for (int b = 0; b < 21; b++) anysf |= sf[b] != 0;
            if (anysf) {
                sfc = pick_sfc_long(sf);
                int s1 = SLEN1[sfc], s2 = SLEN2[sfc];
                for (int b = 0; b < 11; b++) w.put(uint32_t(sf[b]), s1);
                for (int b = 11; b < 21; b++) w.put(uint32_t(sf[b]), s2);
            }
        }
        if (use_sf[r] && bt == 2) {
            const int16_t* sf = short_sf + size_t(r) * 36;
            bool anysf = false;
            for (int k = 0; k < 36; k++) anysf |= sf[k] != 0;
            if (anysf) {
                sfc = pick_sfc_short(sf);
                int s1 = SLEN1[sfc], s2 = SLEN2[sfc];
                // sfb-major, window-minor [§2.4.2.7 non-mixed short]
                for (int b = 0; b < 6; b++)
                    for (int win = 0; win < 3; win++)
                        w.put(uint32_t(sf[win * 12 + b]), s1);
                for (int b = 6; b < 12; b++)
                    for (int win = 0; win < 3; win++)
                        w.put(uint32_t(sf[win * 12 + b]), s2);
            }
        }
        const int16_t* ts = tsel + size_t(r) * 3;
        int r0c, r1c;
        if (bt != 0) {
            int r1 = bt == 2 ? 36 : SFB_LONG[sr9 * 23 + 8];
            if (r1 > bv2) r1 = bv2;
            r0c = bt == 2 ? 8 : 7;
            r1c = 20 - r0c;
            emit_pairs(w, row, 0, r1, ts[0]);
            emit_pairs(w, row, r1, bv2, ts[1]);
        } else {
            int r1, r2;
            regions_long(bv2, sr9, &r0c, &r1c, &r1, &r2);
            emit_pairs(w, row, 0, r1, ts[0]);
            emit_pairs(w, row, r1, r2, ts[1]);
            emit_pairs(w, row, r2, bv2, ts[2]);
        }
        // count1 quads
        int c1t = c1table[r];
        for (int q = 0; q < c1n; q++) {
            const int16_t* quad = row + bv2 + 4 * q;
            int idx = 0;
            for (int j = 0; j < 4; j++) {
                int v = quad[j] < 0 ? -quad[j] : quad[j];
                idx |= (v & 1) << (3 - j);
            }
            if (c1t == 0)
                w.put(COUNT1A_CODES[idx], COUNT1A_LENS[idx]);
            else
                w.put(uint32_t(15 - idx), 4);
            for (int j = 0; j < 4; j++)
                if (quad[j]) w.put(quad[j] < 0 ? 1u : 0u, 1);
        }
        int32_t* m = out_meta + size_t(r) * 6;
        m[0] = int32_t(w.bitpos);
        m[1] = bv;
        m[2] = sfc;
        m[3] = r0c;
        m[4] = r1c;
        m[5] = w.overflow ? 1 : 0;
        any_ovf |= w.overflow;
    }
    return any_ovf ? -1 : 0;
}

}  // extern "C"
