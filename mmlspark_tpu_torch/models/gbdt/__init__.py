"""Gradient-boosted trees (the LightGBM stages), level-wise and leaf-wise, on
the port's engine, with the histogram and predict kernels of
``ops/gbdt_kernels.py``."""

from . import engine
from .engine import GBDTParams, TreeEnsemble, fit_gbdt, predict, predict_raw
from .leafwise import LeafwiseEnsemble
from .stages import (LightGBMClassificationModel, LightGBMClassifier,
                     LightGBMRegressionModel, LightGBMRegressor)

__all__ = ["engine", "GBDTParams", "TreeEnsemble", "LeafwiseEnsemble",
           "fit_gbdt", "predict",
           "predict_raw", "LightGBMClassifier", "LightGBMClassificationModel",
           "LightGBMRegressor", "LightGBMRegressionModel"]
