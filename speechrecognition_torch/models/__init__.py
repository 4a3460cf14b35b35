from .gmm import MixtureModel, VarianceModel, ScorePack  # noqa: F401
