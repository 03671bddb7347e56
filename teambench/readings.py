"""What a run measured, as the metric readers (``metrics/<name>.py``) read it.

A reader returns ``None`` where the run holds nothing for it to read (no
trace in a ``--trace 0`` run, no kernel of a family, no table of peaks for
the card); the harness then leaves the metric out of the line.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional

from teambench import work


@dataclasses.dataclass
class Readings:
    shape: Any                         # the driver's sizes, as the work functions take them
    precision: Dict[str, str]          # the config's: "gemm", "attention", "peak"
    batch: int                         # items a step
    n_batches: int                     # steps in the window
    window_s: float                    # the window, host clock (or the traced range)
    setup_s: float
    latencies_ms: List[float]          # each batch, start to end on the stream
    peak_mem_bytes: int                # the window's max_memory_allocated
    peaks: Optional[Dict[str, float]]  # the card's published peaks (peaks.json)
    host_ms: Optional[float] = None    # mean host span of encode_image on an idle device
    busy_s: Optional[float] = None     # union of device intervals in the traced window
    layer_s: Dict[str, float] = dataclasses.field(default_factory=dict)   # by kernel families' layer
    layer_work: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)

    def img_per_s(self) -> float:
        return self.n_batches * self.batch / self.window_s

    def latency_quantile_ms(self, q: int) -> Optional[float]:
        """The q-th percentile of the batches' latencies (needs two or more)."""
        if len(self.latencies_ms) < 2:
            return None
        return statistics.quantiles(self.latencies_ms, n=100, method="inclusive")[q - 1]

    def layer_ms(self, layer: str) -> Optional[float]:
        """Device milliseconds a step in the kernels of the families of
        ``layer``, in the traced window."""
        s = self.layer_s.get(layer)
        return 1e3 * s / self.n_batches if s else None

    def roofline_pct(self, layer: str) -> Optional[float]:
        """The bound of the layer's work (its families' ``work`` function at
        the config's precision for it) over its measured time, in percent:
        the same work whatever kernels do it."""
        t, name = self.layer_ms(layer), self.layer_work.get(layer)
        if t is None or name is None or self.peaks is None:
            return None
        ops = work.WORK[name](self.shape, self.batch, self.precision[name])
        return 100.0 * 1e3 * work.bound_seconds(ops, self.peaks) / t
