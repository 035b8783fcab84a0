// ASan/UBSan fuzz harness for the native unpacker (SURVEY.md §5.2).
// Feeds random byte strings and mutated copies of stdin (if provided)
// through mp3tpu_probe/mp3tpu_unpack. Exits nonzero on any sanitizer
// report (the sanitizer aborts).
//
// Copy of src/mp3tpu/native/fuzz_main.cpp (the JAX package's fuzz harness),
// kept in the port; the code is the same. mp3tpu_torch/kernels/build.py
// links it with unpack.cpp under -fsanitize=address,undefined
// (build_tool("fuzz_main.cpp")); mp3tpu_torch/sanitize.py runs it.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int mp3tpu_probe(const uint8_t* data, int64_t len, int32_t* meta);
int mp3tpu_unpack(const uint8_t* data, int64_t len, int16_t*, int16_t*,
                  int8_t*, uint8_t*, uint8_t*, int16_t*, int32_t*, int32_t*,
                  int32_t, int32_t, int32_t, uint8_t*, int16_t*, int32_t);
}

static uint64_t rng_state = 0x9E3779B97F4A7C15ull;
static uint32_t xrand() {
    rng_state ^= rng_state << 13;
    rng_state ^= rng_state >> 7;
    rng_state ^= rng_state << 17;
    return uint32_t(rng_state);
}

static void run_one(const std::vector<uint8_t>& buf) {
    int32_t meta[4];
    int g = mp3tpu_probe(buf.data(), int64_t(buf.size()), meta);
    if (g <= 0) return;
    std::vector<int16_t> is(size_t(g) * 2 * 576);
    std::vector<int16_t> exps(size_t(g) * 2 * 64);
    std::vector<int8_t> bt(size_t(g) * 2);
    std::vector<uint8_t> mixed(size_t(g) * 2), smode(size_t(g) * 64);
    std::vector<int16_t> err(size_t(g), 0);
    std::vector<int32_t> slack(size_t(g) * 2), lines(size_t(g) * 2);
    std::vector<uint8_t> is12(size_t(g) * 2 * 864);
    // esc sized for the largest sideband (4-bit mode: 64 int16/gc)
    std::vector<int16_t> esc(size_t(g) * 2 * 64);
    // rotate plane modes (incl. byte-exponent flag 0x10) so every
    // packer path sees hostile input
    static int32_t planes[4] = {12, 8, 4, 4 | 0x10};
    static int pi = 0;
    mp3tpu_unpack(buf.data(), int64_t(buf.size()), is.data(), exps.data(),
                  bt.data(), mixed.data(), smode.data(), err.data(),
                  slack.data(), lines.data(), 0, 1, 0, is12.data(), esc.data(),
                  planes[pi++ % 4]);
}

int main(int argc, char** argv) {
    int iters = argc > 1 ? atoi(argv[1]) : 200;
    // random byte strings
    for (int i = 0; i < iters; i++) {
        std::vector<uint8_t> buf(64 + xrand() % 20000);
        for (auto& b : buf) b = uint8_t(xrand());
        // salt with syncwords so frames parse sometimes
        for (size_t k = 0; k + 4 < buf.size(); k += 97) {
            buf[k] = 0xFF;
            buf[k + 1] = 0xFB;
        }
        run_one(buf);
    }
    // mutated copies of a real stream from stdin
    std::vector<uint8_t> base;
    int c;
    while ((c = getchar()) != EOF) base.push_back(uint8_t(c));
    if (!base.empty()) {
        for (int i = 0; i < iters; i++) {
            std::vector<uint8_t> buf = base;
            for (int m = 0; m < 64; m++)
                buf[xrand() % buf.size()] ^= uint8_t(1 + xrand() % 255);
            run_one(buf);
        }
    }
    printf("fuzz ok\n");
    return 0;
}
