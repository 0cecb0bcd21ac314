"""Mean seconds per solve of the solver's ``merge_scan`` span: the merge's
level steps on the device (core/merge.py's ``merge_scan``) through the
host's read of the assignment, so it holds the device's work. None where the
solver records no such span. It moves tts_s."""


def read(window, log):
    scans = [t["merge_scan_s"] for t in window.timings if "merge_scan_s" in t]
    return sum(scans) / len(scans) if scans else None
