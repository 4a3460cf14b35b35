from .decoder import Recognizer, DecoderTables, decode_batch  # noqa: F401
from .edit_distance import EDAccumulator, edit_distance  # noqa: F401
from .online import OnlineRecognizer, OnlineWctsRecognizer  # noqa: F401
