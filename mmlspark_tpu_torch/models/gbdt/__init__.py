"""Level-wise gradient-boosted trees (the LightGBM stages) on the port's
engine, with the histogram and predict kernels of ``ops/gbdt_kernels.py``."""

from . import engine
from .engine import GBDTParams, TreeEnsemble, fit_gbdt, predict, predict_raw
from .stages import (LightGBMClassificationModel, LightGBMClassifier,
                     LightGBMRegressionModel, LightGBMRegressor)

__all__ = ["engine", "GBDTParams", "TreeEnsemble", "fit_gbdt", "predict",
           "predict_raw", "LightGBMClassifier", "LightGBMClassificationModel",
           "LightGBMRegressor", "LightGBMRegressionModel"]
