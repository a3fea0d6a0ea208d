"""Console progress with a live Hz readout.

Counterpart of event_flow_tpu/data/progress.py (reference:
dataloader/utils.py ProgressBar suffix, forward passes per second);
eval_flow.py drives it when the config's ``vis.bars`` is set.
"""

import sys
import time

__all__ = ["ProgressPrinter"]


class ProgressPrinter:
    """Every ``every`` ticks, rewrite one line with the label (the file
    of slot 0), the windows so far and their rate."""

    def __init__(self, enabled=True, every=25):
        self.enabled = enabled
        self.every = every
        self._n = 0
        self._t0 = time.perf_counter()
        self._label = ""

    def tick(self, label=None):
        if not self.enabled:
            return
        if label is not None:
            self._label = label
        self._n += 1
        if self._n % self.every == 0:
            hz = self._n / max(time.perf_counter() - self._t0, 1e-9)
            sys.stdout.write(
                f"\r{self._label}  {self._n} windows  {hz:7.1f} Hz  ")
            sys.stdout.flush()

    def finish(self):
        if self.enabled and self._n:
            sys.stdout.write("\n")
