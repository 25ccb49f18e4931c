"""Counterpart of ``deeplearning_cfn_tpu/utils/logging.py``.

The same ``time level file:line msg`` line format and the same credential
scrubbing, so the serving plane's logs read as the JAX package's do.
"""

from __future__ import annotations

import logging
import os
import re
import sys

_FORMAT = "%(asctime)s %(levelname)s %(filename)s:%(lineno)s %(message)s"

_SECRET_RE = re.compile(
    r"(token|secret|password|credential|authorization)[\"']?\s*[:=]\s*[\"']?([^\s\"',}]+)",
    re.IGNORECASE,
)


def scrub(text: str) -> str:
    """Redact credential-looking values from a string before logging."""
    return _SECRET_RE.sub(lambda m: f"{m.group(1)}=<redacted>", text)


class _ScrubFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        # Scrub the rendered message: secrets usually arrive through %-args.
        try:
            rendered = record.getMessage()
        except Exception:
            return True
        scrubbed = scrub(rendered)
        if scrubbed != rendered:
            record.msg = scrubbed
            record.args = ()
        return True


# name -> absolute paths of the file sinks already attached, so a later
# get_logger(name, log_file=...) attaches its file instead of dropping it.
_configured: dict[str, set[str]] = {}


def _add_file_sink(logger: logging.Logger, log_file: str) -> None:
    fileh = logging.FileHandler(log_file)
    fileh.setFormatter(logging.Formatter(_FORMAT))
    fileh.addFilter(_ScrubFilter())
    logger.addHandler(fileh)


def get_logger(name: str = "dlcfn", log_file: str | None = None) -> logging.Logger:
    """Return a logger writing `time level file:line msg` lines to stderr,
    and to ``log_file`` (or ``$DLCFN_LOG_FILE`` at first configuration) too.
    Calling again with a different ``log_file`` attaches that sink as well."""
    logger = logging.getLogger(name)
    sinks = _configured.get(name)
    if sinks is None:
        sinks = _configured[name] = set()
        logger.setLevel(os.environ.get("DLCFN_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
        stream = logging.StreamHandler(sys.stderr)
        stream.setFormatter(logging.Formatter(_FORMAT))
        stream.addFilter(_ScrubFilter())
        logger.addHandler(stream)
        log_file = log_file or os.environ.get("DLCFN_LOG_FILE")
    if log_file:
        resolved = os.path.abspath(log_file)
        if resolved not in sinks:
            sinks.add(resolved)
            _add_file_sink(logger, log_file)
    return logger
