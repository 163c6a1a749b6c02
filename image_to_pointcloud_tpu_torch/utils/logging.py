"""Structured (JSON-lines) logging for the serving runtime.

The reference declares ``python-json-logger`` in its requirements but
never imports it (backend/requirements.txt:19 — SURVEY.md §5); its logs
are emoji-narrated plain text. Here JSON logging actually works: enable
with ``--log-json`` (or ``IPC_TPU_LOG_JSON=1``) and every record becomes
one machine-parseable line for log aggregation.
"""

from __future__ import annotations

import datetime
import json
import logging

__all__ = ["JsonFormatter", "configure_logging"]


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            # Timezone-aware UTC: aggregators correlating hosts across
            # timezones (or a DST change) need the offset explicit.
            "ts": datetime.datetime.fromtimestamp(
                record.created, tz=datetime.timezone.utc
            ).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def configure_logging(json_lines: bool = False, level: int = logging.INFO) -> None:
    handler = logging.StreamHandler()
    if json_lines:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(levelname)s:%(name)s:%(message)s")
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
