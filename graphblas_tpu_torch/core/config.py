"""Global config: ``config.get/set``, ``config[key]`` and
``with config.set(...):`` as a context manager (the surface of
graphblas_tpu/core/config.py).

``device`` is the torch device every entry point builds its tensors on.
It defaults to ``"cuda"``; a caller that wants the CPU asks for it with
``config.set(device="cpu")``.  There is no quiet fallback: with the default
and no GPU, :func:`device` raises.
``auto_sparse_limit``: a Matrix with more elements than this is
sparse-backed, a smaller one is a dense (values, valid) store
(graphblas_tpu/core/matrix.py:56).  ``dense_limit``: the largest sparse
Matrix, in elements, that an operation without a sparse path may densify
(graphblas_tpu/core/base.py:139).
"""

import contextlib

import torch

__all__ = ["Config", "config", "device"]


class _Missing:
    def __repr__(self):
        return "<missing>"


_MISSING = _Missing()


def _normalize(key):
    return key.replace("-", "_")


class _ConfigSet(contextlib.AbstractContextManager):
    def __init__(self, config, updates):
        self._config = config
        self._old = {k: config._values.get(k, _MISSING) for k in updates}
        config._values.update(updates)

    def __exit__(self, *exc):
        for k, v in self._old.items():
            if v is _MISSING:
                self._config._values.pop(k, None)
            else:
                self._config._values[k] = v
        return False


class Config:
    def __init__(self, defaults=None):
        self._values = dict(defaults or {})

    def get(self, key, default=_MISSING):
        key = _normalize(key)
        if key in self._values:
            return self._values[key]
        if default is not _MISSING:
            return default
        raise KeyError(key)

    def set(self, arg=None, **kwargs):
        updates = {}
        if arg:
            updates.update({_normalize(k): v for k, v in arg.items()})
        updates.update({_normalize(k): v for k, v in kwargs.items()})
        return _ConfigSet(self, updates)

    def __getitem__(self, key):
        return self.get(key)

    def __setitem__(self, key, value):
        self._values[_normalize(key)] = value

    def __contains__(self, key):
        return _normalize(key) in self._values

    def __repr__(self):
        return f"Config({self._values!r})"


config = Config({
    "auto_sparse_limit": 1 << 22,
    "dense_limit": 1 << 26,
    "device": "cuda",
})


def device():
    """The torch device new collections live on (see module docstring)."""
    dev = torch.device(config["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "graphblas_tpu_torch runs on a CUDA device by default and none "
            "is available; ask for the CPU with "
            "graphblas_tpu_torch.config.set(device='cpu')")
    return dev
