"""Small cells for the CPU: the benchmark's cells with their traffic cut
so that a test holds them, and the stream's input and check cut with
them (conftest.py sets ``SMALL_CONSTANTS`` on the harness's modules)."""

from portbench.harness import common

SMALL = {"render": {"batch": 4, "seconds_per_stream": 0.16, "pool": 2},
         "stream": {},
         "fit": {"batch": 4, "seconds_per_stream": 0.08, "pool": 3}}
SMALL_CONSTANTS = {"stream": {"INPUT_BLOCKS": 120, "CHECK_BLOCKS": 60}}
SEED = 2 ** 31 + 977


def small_cell(name: str):
    cell = common.load_cell(name)
    cell.traffic.update(SMALL[cell.kind])
    return cell


def run_small(name: str, seconds: float = 0.3, seed: int = SEED) -> dict:
    import time
    from portbench import run
    return run.run_cell(small_cell(name), seed, seconds, False,
                        device="cpu", t_start=time.perf_counter())
