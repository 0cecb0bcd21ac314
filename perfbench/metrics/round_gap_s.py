"""Mean seconds per solve in which the device waits between the batched
QAOA's rounds: each solve's ``round_gap_s`` timing, the time on the device
from one ``qaoa_round`` span's end to the next one's start, summed over the
solve (0 for a solve in one round). None where the solver records no such
span. It moves tts_s."""


def read(window, log):
    gaps = [t["round_gap_s"] for t in window.timings if "round_gap_s" in t]
    return sum(gaps) / len(gaps) if gaps else None
