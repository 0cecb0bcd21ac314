"""The solver's kernels' share of their roofline, in %: over the traced
window, Σ launches × least time (perfbench/counts, at the qubits of the cell
and the rows of a batch) over Σ device time of the kernels those counts
cover. The share of all device time in kernels without a count goes on an
earlier line, with each count's own share and the window's batches. It
moves tts_s.

Every launch is priced at the mean rows of the window's batches (calls of
``solve_batch_on_device``, ``Window.batches``): each count's work is linear
in its rows, and every call launches each kernel as often as the others,
so this is the sum over the batches, uneven ones too. A call makes one cost
table, so the window's ``cutvals`` launches must equal its batches; where
they do not, or where no batch was recorded, the reader gives nothing."""

from perfbench.lib.counts import kernel_counts, least_s_of, owner


def read(window, log):
    if window.trace is None or window.launches is None:
        return None
    batches = window.batches
    tables = window.launches.get("cutvals", 0)
    if not batches or tables != len(batches):
        log(f"kernels_roofline: {tables} cutvals launches against {len(batches)} batches "
            "(one cost table a batch): no share")
        return None
    rows = sum(batches) / len(batches)
    counts = kernel_counts()
    spent = dict.fromkeys(counts, 0)
    other = total = 0
    for name, _, dur in window.trace.ops:
        total += dur
        mod = owner(name, counts)
        if mod is None:
            other += dur
        else:
            spent[mod.__name__.rsplit(".", 1)[1]] += dur
    least = {k: window.launches.get(m.OP, 0) * least_s_of(m, rows, window.config["n_qubits"])
             for k, m in counts.items()}
    parts = [f"{k} {100 * least[k] / (spent[k] / 1e9):.2f}% of {spent[k] / 1e9:.4f} s"
             for k in counts if spent[k]]
    log(f"kernels_roofline by count: batches {batches}, cutvals launches {tables}; "
        f"{'; '.join(parts)}; device time without a count "
        f"{other / 1e9:.4f} of {total / 1e9:.4f} s ({100 * other / max(total, 1):.2f}%)")
    covered = sum(spent.values())
    if covered == 0:
        return None
    return 100.0 * sum(least[k] for k in counts if spent[k]) / (covered / 1e9)
