"""Kernel H (csrc/em_pass_df.cu): the double-float E-step pass. Per live row
(a frame of an E-step or AM-score pass) and density slot of its aligned
mixture, kernel C's operations: per dimension add_f 10, two double-float
multiplies of 10, a double-float add of 20; per slot the half, two adds and
the minimum. The float64 sums (5 operations a row and dimension) are left
out: under a hundredth of the count. Bytes: the frames read once."""

NAMES = ("em_tile_kernel", "em_block_sums_kernel", "em_state_sums_kernel")
PEAK = "fp32"
DF_ADD, DF_CMP = 20, 3
ELEMENT_OPS = 10 + 2 * 10 + DF_ADD
DENSITY_OPS = 2 + 2 * DF_ADD + DF_CMP


def count(work):
    if not {"estep_rows", "estep_densities", "dim"} <= work.keys():
        return None
    n, D, dim = work["estep_rows"], work["estep_densities"], work["dim"]
    return n * D * (dim * ELEMENT_OPS + DENSITY_OPS), n * dim * 4
