"""AutoML stages of the port: TrainClassifier/TrainRegressor, Featurize,
ValueIndexer, ComputeModelStatistics, FindBestModel and TuneHyperparameters
(the port of ``mmlspark_tpu/automl``; the fleet tuning backend of
``trials.py``/``scheduler.py`` is ROADMAP.md Queue 1 item 13b). Each name
loads its module on first use."""

_EXPORTS = {
    "metrics": None,
    "Featurize": "featurize", "FeaturizeModel": "featurize",
    "ComputeModelStatistics": "model_statistics",
    "ComputePerInstanceStatistics": "model_statistics",
    "TrainClassifier": "train_classifier", "TrainRegressor": "train_classifier",
    "TrainedClassifierModel": "train_classifier",
    "TrainedRegressorModel": "train_classifier",
    "BestModel": "tune", "DefaultHyperparams": "tune",
    "DiscreteHyperParam": "tune", "FindBestModel": "tune",
    "GridSpace": "tune", "HyperparamBuilder": "tune", "RandomSpace": "tune",
    "RangeHyperParam": "tune", "TuneHyperparameters": "tune",
    "TuneHyperparametersModel": "tune",
    "IndexToValue": "value_indexer", "ValueIndexer": "value_indexer",
    "ValueIndexerModel": "value_indexer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{_EXPORTS[name] or name}", __name__)
    return mod if _EXPORTS[name] is None else getattr(mod, name)
