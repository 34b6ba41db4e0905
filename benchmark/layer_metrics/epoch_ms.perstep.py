"""ms per batch epoch in this cell (the reading is _epoch_ms.py's)."""

from benchmark.layer_metrics._epoch_ms import read  # noqa: F401
