"""Inference API: AnalysisConfig, AnalysisPredictor, create_paddle_predictor.

A predictor loads a saved inference model (io.load_inference_model) into
its own Scope and serves it through its own Executor. The model runs on
the card unless the config asks for the CPU with ``disable_gpu()``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

__all__ = ["AnalysisConfig", "AnalysisPredictor", "PaddleTensor",
           "create_paddle_predictor"]


class AnalysisConfig:
    """Knob-compatible subset of the reference's analysis config."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._use_gpu = True
        self._device_id = 0

    def set_model(self, x, y=None):
        if y is None:
            self._model_dir = x
        else:
            self._prog_file, self._params_file = x, y

    def model_dir(self):
        return self._model_dir

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def disable_gpu(self):
        self._use_gpu = False

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = device_id

    def use_gpu(self):
        return self._use_gpu

    def place(self):
        from ..core.place import CPUPlace, CUDAPlace
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()


class PaddleTensor:
    """Input/output value for Predictor.run."""

    def __init__(self, data=None, name=""):
        self.name = name
        self.data = np.asarray(data) if data is not None else None

    @property
    def shape(self):
        return list(self.data.shape)

    def as_ndarray(self):
        return self.data


class AnalysisPredictor:
    def __init__(self, config: AnalysisConfig, _share_from=None):
        from ..core.scope import Scope, scope_guard
        from ..executor import Executor
        from .. import io as fio

        self.config = config
        if _share_from is not None:
            # clone(): share program, weights and executor (and so its
            # cache counters)
            self._scope = _share_from._scope
            self._exe = _share_from._exe
            self._program = _share_from._program
            self._feed_names = list(_share_from._feed_names)
            self._fetch_names = list(_share_from._fetch_names)
            return
        self._scope = Scope()
        self._exe = Executor(config.place())
        d = config.model_dir()
        model_file = params_file = None
        if d is None:
            # combined-file form: set_model(prog_file, params_file)
            pf = config.prog_file()
            if pf is None:
                raise ValueError(
                    "AnalysisConfig needs set_model(model_dir) or "
                    "set_model(prog_file, params_file)")
            d = os.path.dirname(pf) or "."
            model_file = os.path.basename(pf)
            params_file = os.path.basename(config.params_file()) \
                if config.params_file() else None
        with scope_guard(self._scope):
            self._program, self._feed_names, fetch_vars = \
                fio.load_inference_model(d, self._exe,
                                         model_filename=model_file,
                                         params_filename=params_file)
        self._fetch_names = [v.name for v in fetch_vars]

    def run(self, inputs: List[PaddleTensor]) -> List[PaddleTensor]:
        feed = {}
        for i, t in enumerate(inputs):
            feed[t.name or self._feed_names[i]] = t.data
        outs = self.run_dict(feed)
        return [PaddleTensor(o, n) for o, n in zip(outs, self._fetch_names)]

    def run_dict(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """{input name: ndarray} -> fetch outputs in get_output_names()
        order (the serving engine's worker path)."""
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names,
                             scope=self._scope)

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def clone(self):
        """A predictor over the SAME program, weights and executor."""
        return AnalysisPredictor(self.config, _share_from=self)

    def program(self):
        return self._program


def create_paddle_predictor(config: AnalysisConfig) -> AnalysisPredictor:
    return AnalysisPredictor(config)
