// mp3tpu native stream mux (SURVEY.md E6, batch fast path).
//
// Mirrors encoder/mux_packed.assemble_stream byte-for-byte (tested):
// CBR frame sizing with the padding-slot accumulator, the exact
// ReservoirMux walk (byte-aligned granule starts, 511-byte back-window
// clamp), OR-splicing each granule's packed part2+part3 bytes into the
// logical main-data stream at its bit offset, MPEG-1 Layer III side
// info, headers, physical frame slicing. The Python implementation in
// mux_packed.py stays the semantics reference.
//
// Exists because the mux is a host-serial term of the batch encode wall:
// per-granule numpy OR-shifts and per-frame Python side-info packing are
// replaced by one pass over the stream.
//
// Copy of src/mp3tpu/native/mux_stream.cpp (the JAX package's stream mux),
// kept in the port; the code is the same.
// C ABI only; mp3tpu_torch/kernels/build.py compiles it with g++ into the
// unpacker's library, loaded via ctypes (mp3tpu_torch/bitstream/native.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct BitPut {
    uint8_t* buf;
    size_t bitpos = 0;
    void put(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; i--) {
            size_t p = bitpos++;
            if ((v >> i) & 1) buf[p >> 3] |= uint8_t(0x80u >> (p & 7));
        }
    }
};

}  // namespace

extern "C" int64_t mp3tpu_mux_stream(
    const uint8_t* bits_bytes, int64_t n_gc, int64_t cap,
    const int32_t* p23, const int32_t* bv, const int32_t* gg,
    const int32_t* sfc, const int32_t* block_type,
    const int32_t* tsel /* [n_gc,3] */, const int32_t* sbg /* [n_gc,3] */,
    const int32_t* r0c, const int32_t* r1c, const int32_t* c1t,
    const uint8_t* ms_f /* [n_frames] */,
    int32_t nch, int32_t sr_idx, int32_t br_idx,
    int32_t sample_rate, int32_t bitrate_bps, int32_t max_back,
    uint8_t* out, int64_t out_cap) {
    if (nch < 1 || nch > 2 || n_gc <= 0 || n_gc % (2 * nch)) return -1;
    if (max_back < 0 || max_back > 511) return -1;
    const int64_t n_frames = n_gc / (2 * nch);
    const int side_bytes = nch == 1 ? 17 : 32;
    const int hdr_len = 4 + side_bytes;
    const int64_t MAX_BACK = max_back;  // ReservoirMux.MAX_BACK (caller)

    // FrameSizer: CBR frame lengths with the padding-slot accumulator
    int32_t* fbytes = (int32_t*)malloc(size_t(n_frames) * 8);
    if (!fbytes) return -1;
    int32_t* fpad = fbytes + n_frames;
    {
        int64_t base = 144LL * bitrate_bps / sample_rate;
        int64_t rem = (144LL * bitrate_bps) % sample_rate;
        int64_t acc = 0;
        for (int64_t f = 0; f < n_frames; f++) {
            acc += rem;
            if (acc >= sample_rate) {
                acc -= sample_rate;
                fbytes[f] = int32_t(base + 1);
                fpad[f] = 1;
            } else {
                fbytes[f] = int32_t(base);
                fpad[f] = 0;
            }
        }
    }

    // reservoir walk: per-gc bit offsets + per-frame main_data_begin
    int64_t* off = (int64_t*)malloc(size_t(n_gc) * 8 + size_t(n_frames) * 8);
    if (!off) { free(fbytes); return -1; }
    int64_t* mdb_f = off + n_gc;
    int64_t stream_bits = 0, placed_bytes = 0;
    for (int64_t f = 0; f < n_frames; f++) {
        int64_t mdb = placed_bytes - stream_bits / 8;
        if (mdb < 0 || mdb > 511) { free(off); free(fbytes); return -2; }
        mdb_f[f] = mdb;
        int64_t g0 = f * 2 * nch;
        for (int i = 0; i < 2 * nch; i++) {
            off[g0 + i] = stream_bits;
            stream_bits += p23[g0 + i];
        }
        stream_bits = (stream_bits + 7) & ~7LL;
        placed_bytes += int64_t(fbytes[f]) - hdr_len;  // frame capacity bytes
        if (stream_bits > placed_bytes * 8) { free(off); free(fbytes); return -3; }
        int64_t excess = placed_bytes - stream_bits / 8 - MAX_BACK;
        if (excess > 0) stream_bits += excess * 8;
    }

    const int64_t total = placed_bytes + n_frames * hdr_len;
    if (out_cap < total) { free(off); free(fbytes); return -4; }

    // logical main-data stream: OR each granule's shifted bytes in
    uint8_t* data = (uint8_t*)calloc(size_t(placed_bytes) + 4, 1);
    if (!data) { free(off); free(fbytes); return -1; }
    for (int64_t i = 0; i < n_gc; i++) {
        int64_t nb = p23[i];
        if (nb <= 0) continue;
        int64_t nby = (nb + 7) / 8;
        if (nby > cap) nby = cap;
        const uint8_t* src = bits_bytes + i * cap;
        int64_t base = off[i] >> 3;
        int sh = int(off[i] & 7);
        uint8_t* dst = data + base;
        if (sh == 0) {
            for (int64_t k = 0; k < nby; k++) dst[k] |= src[k];
        } else {
            uint8_t prev = 0;
            for (int64_t k = 0; k < nby; k++) {
                dst[k] |= uint8_t((prev << (8 - sh)) | (src[k] >> sh));
                prev = src[k];
            }
            dst[nby] |= uint8_t(prev << (8 - sh));
        }
    }

    // headers + side info + physical frame slicing
    memset(out, 0, size_t(total));
    int64_t pos = 0;   // logical main-data cursor (bytes)
    int64_t op = 0;    // output cursor
    for (int64_t f = 0; f < n_frames; f++) {
        BitPut w{out + op};
        w.put(0x7FF, 11); w.put(0b11, 2); w.put(0b01, 2); w.put(1, 1);
        w.put(uint32_t(br_idx), 4); w.put(uint32_t(sr_idx), 2);
        w.put(uint32_t(fpad[f]), 1); w.put(0, 1);
        bool ms = ms_f[f] != 0;
        if (nch == 1) w.put(0b11, 2);
        else w.put(ms ? 0b01 : 0b00, 2);
        w.put(ms ? 0b10 : 0, 2);
        w.put(0, 1); w.put(1, 1); w.put(0, 2);
        // side info
        w.put(uint32_t(mdb_f[f]), 9);
        w.put(0, nch == 1 ? 5 : 3);
        for (int c = 0; c < nch; c++) w.put(0, 4);  // scfsi
        for (int64_t i = f * 2 * nch; i < (f + 1) * 2 * nch; i++) {
            int wsw = block_type[i] ? 1 : 0;
            w.put(uint32_t(p23[i]), 12);
            w.put(uint32_t(bv[i]), 9);
            w.put(uint32_t(gg[i]), 8);
            w.put(uint32_t(sfc[i]), 4);
            w.put(uint32_t(wsw), 1);
            if (wsw) {
                w.put(uint32_t(block_type[i]), 2); w.put(0, 1);
                w.put(uint32_t(tsel[i * 3 + 0]), 5);
                w.put(uint32_t(tsel[i * 3 + 1]), 5);
                w.put(uint32_t(sbg[i * 3 + 0]), 3);
                w.put(uint32_t(sbg[i * 3 + 1]), 3);
                w.put(uint32_t(sbg[i * 3 + 2]), 3);
            } else {
                w.put(uint32_t(tsel[i * 3 + 0]), 5);
                w.put(uint32_t(tsel[i * 3 + 1]), 5);
                w.put(uint32_t(tsel[i * 3 + 2]), 5);
                w.put(uint32_t(r0c[i]), 4);
                w.put(uint32_t(r1c[i]), 3);
            }
            w.put(0, 1); w.put(0, 1); w.put(uint32_t(c1t[i]), 1);
        }
        op += hdr_len;
        int64_t capb = fbytes[f] - hdr_len;
        memcpy(out + op, data + pos, size_t(capb));
        op += capb;
        pos += capb;
    }

    free(data);
    free(off);
    free(fbytes);
    return total;
}
