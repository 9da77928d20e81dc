"""Model zoo, weight carry-over, the TorchModel inference stage, the
TorchLearner training stage and the classical learners. Each name loads its
module on first use."""

_EXPORTS = {
    "TorchLearner": "trainer",
    **{name: "classical" for name in (
        "LogisticRegression", "LogisticRegressionModel", "LinearRegression",
        "LinearRegressionModel", "NaiveBayes", "NaiveBayesModel",
        "DecisionTreeClassifier", "DecisionTreeRegressor",
        "RandomForestClassifier", "RandomForestRegressor", "GBTClassifier",
        "GBTRegressor", "MultilayerPerceptronClassifier",
        "MLPClassificationModel")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
