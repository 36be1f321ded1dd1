"""setup.capture_s: the seconds the program spent warming up and capturing
its CUDA graphs (every plan, every kind), by its own counters over the
whole run (benchmark/stages.py)."""

from benchmark import stages


def read(trace):
    counts = stages.counters()
    return None if counts is None else sum(v["prepare_s"] for v in counts.values())
