"""Metric history, a copy of ``Loggers`` in
``deepvision_tpu/train/loggers.py``: ``{metric: {"epochs": [...],
"value": [...]}}``, JSON-serializable so that it rides inside the
checkpoint. (The TensorBoard writer is not ported.)
"""

from __future__ import annotations

import json

__all__ = ["Loggers"]


class Loggers:
    def __init__(self):
        self.data: dict[str, dict[str, list]] = {}

    def log_metrics(self, epoch: int, metrics: dict[str, float]) -> None:
        for name, value in metrics.items():
            series = self.data.setdefault(name, {"epochs": [], "value": []})
            series["epochs"].append(int(epoch))
            series["value"].append(float(value))

    def latest(self, name: str):
        vals = self.data.get(name, {}).get("value", [])
        return vals[-1] if vals else None

    def to_json(self) -> str:
        return json.dumps(self.data)

    @classmethod
    def from_json(cls, s: str) -> "Loggers":
        out = cls()
        out.data = json.loads(s)
        return out
