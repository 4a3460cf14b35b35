from .frontend import (  # noqa: F401
    SignalAnalysisConfig,
    add_deltas,
    process_features,
    extract_features,
    mel_filterbank_matrix,
    dct_matrix,
)
