"""Experiment registry (port of ``mach3_tpu/samples/registry.py``).

The reference's extension point is C++ subclassing of ``SampleHandlerFD``
(``python/samples.cpp:393-456``). Here an experiment is a named builder
function returning the model bundle; the in-repo toy is registered as
``toy``.
"""
from __future__ import annotations

from typing import Callable, Protocol

from ..core.exceptions import ConfigError


class ExperimentBundle(Protocol):
    """What a builder returns: anything exposing ``.model`` (a FitModel),
    ``.samples`` and ``.names``, as the toy's ``ToyExperiment`` does."""

    model: object
    samples: list
    names: list[str]


_REGISTRY: dict[str, Callable[..., ExperimentBundle]] = {}


def register_experiment(name: str):
    """Decorator: ``@register_experiment("my_exp")`` over a builder function
    taking keyword arguments."""

    def wrap(fn: Callable[..., ExperimentBundle]):
        if name in _REGISTRY:
            raise ConfigError(f"Experiment '{name}' already registered")
        _REGISTRY[name] = fn
        return fn

    return wrap


def build_experiment(name: str, **kwargs) -> ExperimentBundle:
    """The experiment ``name`` built with ``kwargs`` (e.g. ``device="cpu"``)."""
    if name not in _REGISTRY:
        raise ConfigError(
            f"Unknown experiment '{name}' (registered: {', '.join(sorted(_REGISTRY)) or 'none'})"
        )
    return _REGISTRY[name](**kwargs)


def list_experiments() -> list[str]:
    return sorted(_REGISTRY)


def _build_toy(**kwargs) -> ExperimentBundle:
    from ..tutorial.toy import build_toy

    return build_toy(**kwargs)


_REGISTRY["toy"] = _build_toy
