"""Parse duration strings like "1:30:00" or "90" into timedelta objects.

Port of :mod:`pde_tpu.utils.parse_duration` (the port keeps its own copy).
"""

from __future__ import annotations

import re
from datetime import timedelta

_DURATION_RE = re.compile(
    r"^((?P<days>-?\d+)\s*(d|days?)\s*,?\s*)?"
    r"((?P<hours>-?\d+):(?=\d+:\d+))?"
    r"((?P<minutes>-?\d+):)?"
    r"(?P<seconds>-?\d+(\.\d+)?)$"
)


def parse_duration(value: str) -> timedelta:
    """Parse a duration string into a :class:`datetime.timedelta`."""
    match = _DURATION_RE.match(value.strip())
    if not match:
        raise ValueError(f"Cannot parse duration `{value}`")
    parts = {k: float(v) for k, v in match.groupdict().items() if v is not None}
    return timedelta(
        days=parts.get("days", 0),
        hours=parts.get("hours", 0),
        minutes=parts.get("minutes", 0),
        seconds=parts.get("seconds", 0),
    )
