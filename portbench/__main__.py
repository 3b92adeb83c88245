import time

START = time.perf_counter()     # before torch and the port are imported

if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(start=START))
