"""Model zoo, weight carry-over, the TorchModel inference stage and the
TorchLearner training stage."""

__all__ = ["TorchLearner"]


def __getattr__(name):
    if name == "TorchLearner":
        from .trainer import TorchLearner
        return TorchLearner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
