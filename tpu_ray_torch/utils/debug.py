"""Numeric sanitizers (counterpart of `tpu_ray/utils/debug.py`): the
render's failure modes are numeric, NaNs or infinities escaping a kernel
or a backward, so the tools here find them.

  * `assert_finite(tree)`: a sweep of the float tensors in dicts, lists,
    tuples and dataclasses;
  * `checked(fn)`: fn, raising ValueError when an output is not finite;
  * `nan_debug()`: autograd's anomaly mode, which names the forward op
    whose backward made a NaN.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch


def _floats(tree, path: str):
    """(path, array) of every floating-point tensor or array in the tree."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield path, tree
    elif isinstance(tree, np.ndarray):
        if np.issubdtype(tree.dtype, np.floating):
            yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _floats(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _floats(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _floats(getattr(tree, f.name), f"{path}.{f.name}")


def _not_finite(tree, name: str) -> list:
    bad = []
    for path, x in _floats(tree, name):
        ok = bool(torch.isfinite(x).all()) if isinstance(x, torch.Tensor) else bool(
            np.isfinite(x).all())
        if not ok:
            bad.append(path)
    return bad


def assert_finite(tree, name: str = "tree") -> None:
    """Raise AssertionError naming every non-finite float leaf of the tree."""
    bad = _not_finite(tree, name)
    if bad:
        raise AssertionError(f"non-finite values in {name}: {bad}")


def checked(fn: Callable) -> Callable:
    """fn, raising ValueError when any float tensor it returns holds a NaN
    or an infinity. Usage: img = checked(render_image)(scene, cfg)."""

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        bad = _not_finite(out, getattr(fn, "__name__", "output"))
        if bad:
            raise ValueError(f"non-finite output: {bad}")
        return out

    return wrapper


@contextlib.contextmanager
def nan_debug():
    """Autograd's anomaly mode inside the block: a backward that makes a NaN
    raises, with the traceback of the forward op that caused it."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
