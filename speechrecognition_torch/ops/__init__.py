from .mahalanobis import mahalanobis_scores, pack_to_mahalanobis  # noqa: F401
