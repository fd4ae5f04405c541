"""Structured logging (counterpart of ``mlmc_tpu/tool/log.py``).

A standard-logging setup with a structured key=value formatter; the
Sampler emits progress events through ``get_logger`` so operational runs
are greppable.
"""
import logging
import sys

_CONFIGURED = False


class KeyValueFormatter(logging.Formatter):
    """'ts level logger msg k=v k=v' lines; extras come from ``extra=``."""

    def format(self, record):
        base = "{} {} {} {}".format(
            self.formatTime(record, "%H:%M:%S"),
            record.levelname[0],
            record.name.removeprefix("mlmc_tpu_torch."),
            record.getMessage())
        fields = getattr(record, "fields", None)
        if fields:
            base += " " + " ".join(
                "{}={}".format(k, v) for k, v in fields.items())
        return base


def configure(level=logging.INFO, stream=None):
    """Install the mlmc_tpu_torch log handler (idempotent)."""
    global _CONFIGURED
    logger = logging.getLogger("mlmc_tpu_torch")
    if _CONFIGURED:
        logger.setLevel(level)
        return logger
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(KeyValueFormatter())
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    _CONFIGURED = True
    return logger


def get_logger(name):
    return logging.getLogger("mlmc_tpu_torch." + name)


def event(logger, msg, **fields):
    """Structured info event: ``event(log, "collected", level=1, n=512)``."""
    logger.info(msg, extra={"fields": fields})
