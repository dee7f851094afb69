"""Logging configuration: JSON or text structured logging.

A copy of the JAX package's ``observability/logging_config.py``, for the port's
logger tree (``triple_hybrid_rag_tpu_torch``). Standard library only.
"""

from __future__ import annotations

import json
import logging
import sys
import time


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, message, + extra fields."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        for key, value in record.__dict__.items():
            if key.startswith("ctx_"):
                payload[key[4:]] = value
        return json.dumps(payload, default=str)


def configure_logging(
    level: str = "INFO",
    fmt: str = "text",  # "text" | "json"
    stream=None,
    logger_name: str = "triple_hybrid_rag_tpu_torch",
) -> logging.Logger:
    """Configure the framework's logger tree (idempotent)."""
    logger = logging.getLogger(logger_name)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()
    handler = logging.StreamHandler(stream or sys.stderr)
    if fmt == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    logger.addHandler(handler)
    logger.propagate = False
    return logger


def get_logger(name: str = "triple_hybrid_rag_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)
