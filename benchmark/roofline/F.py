"""Kernel F (csrc/align_scan_df.cu): the double-float forced-alignment scan.
Per real frame of an utterance and position of its automaton: five
double-float adds, four compares and two guards. Bytes: the gathered
(hi, lo) scores read and the jumps written."""

NAMES = ("align_fwd_df",)
PEAK = "fp32"
DF_ADD, DF_CMP = 20, 3
POS_OPS = 5 * DF_ADD + 4 * DF_CMP + 2


def count(work):
    if "align_cells" not in work:
        return None
    cells = work["align_cells"]
    return cells * POS_OPS, cells * (8 + 1)
