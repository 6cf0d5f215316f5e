"""perfwatch (the port's copy of two parts of the JAX package's
`perfwatch/`; its ledger, gate and microbench suite wait):

- ``recorder.py`` — `FlightRecorder` and the process `RECORDER`: a bounded
  ring of structured events (breaker trips, watchdog fires, chaos
  decisions, soundness violations, SLO breach onsets) and a post-mortem
  bundle on the fatal ones;
- ``timer.py``    — `ensure_host`: the serving tier's dispatch-latency
  clock closes over finished work on the card.
"""

from gethsharding_tpu_torch.perfwatch.recorder import (  # noqa: F401
    RECORDER,
    FlightRecorder,
)
from gethsharding_tpu_torch.perfwatch.timer import ensure_host  # noqa: F401
