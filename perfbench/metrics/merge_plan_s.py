"""Mean seconds per solve of the solver's ``merge_plan`` span: the merge
plan built on the host (core/merge.py's ``build_merge_plan``, a loop over
every edge) and the beam width. None where the solver records no such span.
It moves tts_s."""


def read(window, log):
    plans = [t["merge_plan_s"] for t in window.timings if "merge_plan_s" in t]
    return sum(plans) / len(plans) if plans else None
