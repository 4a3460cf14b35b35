from .frontend import (  # noqa: F401
    SignalAnalysisConfig,
    add_deltas,
    process_features,
    extract_features,
    extract_features_batch,
    mel_filterbank_matrix,
    dct_matrix,
)
