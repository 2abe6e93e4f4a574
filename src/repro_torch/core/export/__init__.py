"""Report export (port of ``repro.core.export``): schema-v9 JSON and the
Perfetto timeline."""
from __future__ import annotations

import json

from .perfetto import chrome_trace, export_perfetto
from .serialize import SCHEMA, report_from_dict, report_to_dict


def export_json(report, path: str, *, include_lint: bool = False) -> str:
    """Write ``report`` as schema-v9 JSON (with the ``lint`` section when
    ``include_lint``); returns the path."""
    with open(path, "w") as f:
        json.dump(report_to_dict(report, include_lint=include_lint), f,
                  indent=1)
    return path


def load_json(path: str):
    """Read a report file (schema v1 ... v9) back into a ``CommReport``."""
    with open(path) as f:
        return report_from_dict(json.load(f))


__all__ = ["SCHEMA", "chrome_trace", "export_json", "export_perfetto",
           "load_json", "report_from_dict", "report_to_dict"]
