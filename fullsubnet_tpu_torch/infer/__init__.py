"""Inference runtime: the Inferencer and its CLI (every offline strategy),
and the streaming engines over their numpy hosts (``streaming.py``,
``host.py``).

The names below are exported lazily (PEP 562): importing the CLI or the
numpy host loads no engine."""

import importlib

_EXPORTS = {
    "Inferencer": "inferencer",
    "MultiStreamEnhancer": "streaming",
    "StreamingEnhancer": "streaming",
    "StreamingFastFullSubNet": "streaming",
    "StreamingFullBand": "streaming",
    "StreamingFullSubNet": "streaming",
    "StreamingISTFT": "streaming",
    "StreamingImprovedFullSubNet": "streaming",
    "make_streaming_engine": "streaming",
    "MultiStreamHost": "host",
    "StreamingWaveHost": "host",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
