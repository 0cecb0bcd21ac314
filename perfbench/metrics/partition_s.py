"""Mean seconds per solve of the solver's ``partition`` span, the partition (core/partition.py), host work.
It moves tts_s."""


def read(window, log):
    return sum(t["partition_s"] for t in window.timings) / len(window.timings)
