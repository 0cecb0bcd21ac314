"""Mean seconds per solve of the solver's ``merge`` span, the merge (core/merge.py): its plan on the host and its scan on the device.
It moves tts_s."""


def read(window, log):
    return sum(t["merge_s"] for t in window.timings) / len(window.timings)
