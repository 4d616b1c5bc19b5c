"""Structured logging shim (the JAX package's ``utils/logging.py``).

structlog when it is installed, else a stdlib-logging adapter with the
same ``logger.info(msg, **kv)`` call shape.  The trainer reports its
progress through this logger (the card's machine has no tqdm).
"""

from __future__ import annotations

import logging


class _KVLoggerAdapter:
    """Minimal structlog-like facade over ``logging``."""

    def __init__(self, name: str):
        self._log = logging.getLogger(name)
        if not logging.getLogger().handlers and not self._log.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(
                logging.Formatter("[%(levelname)s] %(message)s"))
            self._log.addHandler(handler)
            self._log.setLevel(logging.INFO)

    def _fmt(self, event: str, kw) -> str:
        if kw:
            kv = " ".join(f"{k}={v!r}" for k, v in kw.items())
            return f"{event} {kv}"
        return event

    def debug(self, event, **kw):
        self._log.debug(self._fmt(event, kw))

    def info(self, event, **kw):
        self._log.info(self._fmt(event, kw))

    def warning(self, event, **kw):
        self._log.warning(self._fmt(event, kw))

    def error(self, event, **kw):
        self._log.error(self._fmt(event, kw))


def get_logger(name: str = "ml_trainer_tpu_torch"):
    try:
        import structlog

        return structlog.get_logger(name)
    except ImportError:
        return _KVLoggerAdapter(name)
