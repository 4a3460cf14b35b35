from .linear_seg import linear_segmentation_approximation, linear_segmentation_running_sums, linear_alignment_mapping  # noqa: F401
from .viterbi import align_batch, align_batch_chunked, AlignerTables  # noqa: F401
