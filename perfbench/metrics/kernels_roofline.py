"""The solver's kernels' share of their roofline, in %: over the traced
window, Σ launches × least time (perfbench/counts, at the qubits of the cell
and the rows of a batch) over Σ device time of the kernels those counts
cover, each sum over the cards, each card's launches at its own batches.
The share of all device time in kernels without a count goes on an
earlier line, with each count's own share and the window's batches. It
moves tts_s.

Every launch is priced at the mean rows of its card's batches (calls of
``solve_batch_on_device``, ``Card.batches``): each count's work is linear
in its rows, and every call launches each kernel as often as the others,
so this is the sum over the batches, uneven ones too. A call makes one cost
table, so a card's ``cutvals`` launches must equal its batches; where they
do not, or where no batch was recorded, the reader gives nothing."""

from perfbench.lib.counts import kernel_counts, least_s_of, owner


def read(window, log):
    cards = window.cards
    if not cards or cards[0].trace is None or cards[0].launches is None:
        return None
    counts = kernel_counts()
    least = dict.fromkeys(counts, 0)
    spent = dict.fromkeys(counts, 0)
    other = total = 0
    seen = []
    for r, card in enumerate(cards):
        batches = card.batches
        tables = card.launches.get("cutvals", 0)
        where = f" on card {r}" if len(cards) > 1 else ""
        if not batches or tables != len(batches):
            log(f"kernels_roofline: {tables} cutvals launches against {len(batches)} batches "
                f"(one cost table a batch){where}: no share")
            return None
        seen.append(f"batches {batches}, cutvals launches {tables}{where}")
        rows = sum(batches) / len(batches)
        for k, m in counts.items():
            least[k] += card.launches.get(m.OP, 0) * least_s_of(m, rows, window.config["n_qubits"])
        for name, _, dur in card.trace.ops:
            total += dur
            mod = owner(name, counts)
            if mod is None:
                other += dur
            else:
                spent[mod.__name__.rsplit(".", 1)[1]] += dur
    parts = [f"{k} {100 * least[k] / (spent[k] / 1e9):.2f}% of {spent[k] / 1e9:.4f} s"
             for k in counts if spent[k]]
    log(f"kernels_roofline by count: {'; '.join(seen)}; {'; '.join(parts)}; device time "
        f"without a count {other / 1e9:.4f} of {total / 1e9:.4f} s "
        f"({100 * other / max(total, 1):.2f}%)")
    covered = sum(spent.values())
    if covered == 0:
        return None
    return 100.0 * sum(least[k] for k in counts if spent[k]) / (covered / 1e9)
