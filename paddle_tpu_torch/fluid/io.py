"""fluid.io of the port: the v1 save/load surface (paddle_tpu/fluid/io.py;
reference python/paddle/fluid/io.py: save_persistables :620,
load_persistables, save/load_inference_model) over ``static.save`` /
``static.load``."""
from __future__ import annotations

import os

from ..static import (load_inference_model, save_inference_model)  # noqa: F401


def save_persistables(executor, dirname, main_program=None, filename=None):
    from ..static import default_main_program, save as _save
    program = main_program or default_main_program()
    path = os.path.join(dirname, filename or "params")
    _save(program, path)
    return path


def load_persistables(executor, dirname, main_program=None, filename=None):
    from ..static import default_main_program, load as _load
    program = main_program or default_main_program()
    path = os.path.join(dirname, filename or "params")
    _load(program, path)
