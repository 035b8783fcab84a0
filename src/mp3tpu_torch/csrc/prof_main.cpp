// Profiling harness: decode a stream from stdin N times through
// mp3tpu_unpack in the bench configuration (4-bit packed plane +
// position-free escape sideband + byte exponents), printing the
// per-section cycle breakdown when built with -DMP3TPU_PROF_SECTIONS.
// Usage: prof_main [iters] < stream.mp3
//
// Copy of src/mp3tpu/native/prof_main.cpp (the JAX package's profiling
// harness), kept in the port; the code is the same.
// mp3tpu_torch/kernels/build.py links it with unpack.cpp at -O3
// -march=native -DMP3TPU_PROF_SECTIONS (build_tool("prof_main.cpp"));
// mp3tpu_torch/sanitize.py's profile part runs it and parses its table.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" {
int mp3tpu_probe(const uint8_t* data, int64_t len, int32_t* meta);
int mp3tpu_unpack(const uint8_t* data, int64_t len, int16_t*, int16_t*,
                  int8_t*, uint8_t*, uint8_t*, int16_t*, int32_t*, int32_t*,
                  int32_t, int32_t, int32_t, uint8_t*, int16_t*, int32_t);
#ifdef MP3TPU_PROF_SECTIONS
extern uint64_t mp3tpu_prof_cycles[16];
extern uint64_t mp3tpu_prof_pairs[40];
extern uint64_t mp3tpu_prof_fasthits[40];
#endif
}
int main(int argc, char** argv) {
    int iters = argc > 1 ? atoi(argv[1]) : 50;
    std::vector<uint8_t> buf;
    int c;
    while ((c = getchar()) != EOF) buf.push_back(uint8_t(c));
    int32_t meta[4];
    int g = mp3tpu_probe(buf.data(), (int64_t)buf.size(), meta);
    if (g <= 0) return 1;
    std::vector<int16_t> exps(size_t(g)*2*65);  // uint8[65] plane fits
    std::vector<int8_t> bt(size_t(g)*2);
    std::vector<uint8_t> mixed(size_t(g)*2), smode(size_t(g)*64);
    std::vector<int16_t> err(size_t(g), 0);
    std::vector<int32_t> slack(size_t(g)*2), lines(size_t(g)*2);
    std::vector<uint8_t> is4(size_t(g)*2*288);
    std::vector<int16_t> esc(size_t(g)*2*40);  // int8[80]/gc fits
    for (int i = 0; i < iters; i++) {
        int r = mp3tpu_unpack(buf.data(), (int64_t)buf.size(), nullptr,
                              exps.data(), bt.data(), mixed.data(),
                              smode.data(), err.data(), slack.data(),
                              lines.data(), 0, 1, 0,
                              is4.data(), esc.data(), 4 | 0x10);
        if (r < 0) { printf("widen needed: %d\n", r); return 1; }
    }
    printf("done %d granules x %d iters\n", g, iters);
#ifdef MP3TPU_PROF_SECTIONS
    static const char* names[16] = {
        "scan_frames", "sideinfo+crc+resv", "granulebits_init",
        "scalefactors", "huff_big_values", "huff_count1", "plane_pack",
        "exponents", "stereo_modes", "", "", "", "", "", "",
        "spec_total(outer)"};
    uint64_t tot = 0;
    for (int i = 0; i < 15; i++) tot += mp3tpu_prof_cycles[i];
    for (int i = 0; i < 16; i++)
        if (mp3tpu_prof_cycles[i])
            printf("%-18s %12llu cyc  %5.1f%%\n", names[i],
                   (unsigned long long)mp3tpu_prof_cycles[i],
                   100.0 * double(mp3tpu_prof_cycles[i]) / double(tot));
    printf("%-18s %12llu cyc\n", "total(0-14)", (unsigned long long)tot);
    printf("\npairs by table (32=count1 quads); fast-LUT hit rate:\n");
    for (int i = 0; i < 33; i++)
        if (mp3tpu_prof_pairs[i])
            printf("  t%-3d %10llu  fast %5.1f%%\n", i,
                   (unsigned long long)mp3tpu_prof_pairs[i],
                   100.0 * double(mp3tpu_prof_fasthits[i]) /
                       double(mp3tpu_prof_pairs[i]));
#endif
    return 0;
}
