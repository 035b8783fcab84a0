"""The benchmark of mp3tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <config>.<traffic> --seed N \
        --seconds S --trace 0|1

Run from the root of a checkout on a host with the card(s) the cell asks
for. The last line of standard output is the result (see
benchmark/mp3bench/main.py); without a card it exits non-zero and prints
no result. Every build and kernel cache of the program goes to fixed
directories inside the checkout, so only a checkout's first run builds.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, "build", "bench_cache")
os.environ["MP3TPU_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "mp3tpu_torch")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    if not os.path.isdir(os.path.join(ROOT, "src", "mp3tpu_torch")):
        print(f"no program under {ROOT}/src/mp3tpu_torch: run from a "
              "checkout of the repository", file=sys.stderr)
        sys.exit(2)
    from mp3bench.main import main
    sys.exit(main(sys.argv[1:], T0))
