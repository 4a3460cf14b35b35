"""Kernel C (csrc/am_scores_df.cu): double-float max-approximated GMM scores.
Per real frame, active density and dimension: add_f 10, two double-float
multiplies of 10, a double-float add of 20 (an FMA counted as two); per
frame and density: the half 2, two adds of 20, the minimum 3. Bytes: the
features read, the tables read once, the (hi, lo) scores written."""

NAMES = ("am_scores_df_kernel",)
PEAK = "fp32"
DF_ADD, DF_CMP = 20, 3
ELEMENT_OPS = 10 + 2 * 10 + DF_ADD
DENSITY_OPS = 2 + 2 * DF_ADD + DF_CMP


def count(work):
    if not {"frames", "densities", "dim", "mixtures"} <= work.keys():
        return None
    n, J, dim, S = work["frames"], work["densities"], work["dim"], work["mixtures"]
    ops = n * J * (dim * ELEMENT_OPS + DENSITY_OPS)
    nbytes = 4 * n * dim + 8 * (2 * J * dim + 2 * J) + 8 * n * S
    return ops, nbytes
