"""Inference predictor API."""
from .api import (  # noqa: F401
    AnalysisConfig, AnalysisPredictor, PaddleTensor, create_paddle_predictor)
