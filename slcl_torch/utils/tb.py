"""TensorBoard scalars (counterpart of ``slcl_tpu/utils/tb.py``; reference
SummaryWriter usage, utils_.py:48-66). Writes nothing, with the JAX
package's message, when ``tensorboardX`` cannot be imported: ``log.jsonl``
is then the record, in both packages."""
from __future__ import annotations

from typing import Dict


class TBWriter:
    def __init__(self, log_dir: str, enabled: bool = True):
        self._writer = None
        if enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError as e:
                print(f"TBWriter: tensorboardX unavailable ({e}); "
                      "TB scalars disabled — log.jsonl remains the record")
            else:
                self._writer = SummaryWriter(log_dir)

    def scalars(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        if self._writer is None:
            return
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(f"{prefix}{k}", v, step)

    def close(self):
        if self._writer is not None:
            self._writer.close()
