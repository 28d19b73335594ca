"""Round/date stamping for benchmark artifacts, the PyTorch port's copy of
``deepearth_tpu/utils/artifacts.py`` (plain Python, but importing the JAX
package's imports JAX).

Every JSON artifact a tools/bench_* script writes carries
``measured_round`` (from the repo-root ROUND file, bumped once per build
round) and ``measured_at`` (UTC) so downstream aggregators — bench.py's
detail blob, the per-round BENCH_r{N}.json — can tell a fresh measurement
from a stale embed.
"""

from __future__ import annotations

import datetime
import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def current_round() -> int | None:
    try:
        with open(os.path.join(_REPO, "ROUND")) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def round_stamp() -> dict:
    """Fields to merge into an artifact dict at write time."""
    return {
        "measured_round": current_round(),
        "measured_at": datetime.datetime.now(datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ"),
    }
