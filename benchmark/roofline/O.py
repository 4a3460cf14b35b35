"""Kernel O (csrc/quantized_scores.cu): the int8 quantized max-approximated
scores. 2 * frames * active densities * dim int8 operations (the products of
the quantized frames with the quantized means) at the int8 peak. Bytes: the
float32 features read, the scores written, the tables (a quantized mean, its
square and its constant a density) read once."""

NAMES = ("quantized_mma_kernel", "quantized_scores_kernel")
PEAK = "int8"


def count(work):
    if not {"frames", "densities", "dim", "mixtures"} <= work.keys():
        return None
    n, J, dim, S = work["frames"], work["densities"], work["dim"], work["mixtures"]
    return 2 * n * J * dim, n * dim * 4 + n * S * 4 + J * (dim + 8)
