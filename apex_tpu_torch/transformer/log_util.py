"""The transformer subsystem's logger — counterpart of
``apex_tpu/transformer/log_util.py`` (≙ ``apex/transformer/log_util.py``
:: ``get_transformer_logger``, ``set_logging_level``)."""

import logging

__all__ = ["get_transformer_logger", "set_logging_level"]

_BASE = "apex_tpu_torch.transformer"


def get_transformer_logger(name: str = _BASE) -> logging.Logger:
    """The logger ``name`` under the subsystem's (a bare name is put
    under it)."""
    if not name.startswith(_BASE):
        name = f"{_BASE}.{name}"
    return logging.getLogger(name)


def set_logging_level(verbosity) -> None:
    """Set the transformer subsystem's log level (an int or a name)."""
    logging.getLogger(_BASE).setLevel(verbosity)
