"""``python3 -m m3bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from m3bench.run import main

    sys.exit(main(sys.argv[1:], T_START))
