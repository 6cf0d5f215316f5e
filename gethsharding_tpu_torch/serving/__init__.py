"""Verification serving layer: dynamic micro-batching for the hot path (the
port's copy of the JAX package's `serving/`).

A request-coalescing tier between the actors and the batched kernels:
concurrent callers' small batches become aggregate dispatches on the card.

- ``classes.py``  — admission classes (interactive, bulk audit, catch-up)
  and the thread-local `admission_class` tag;
- ``queue.py``    — bounded admission queue: per-request futures,
  deadline-based flush, explicit backpressure (block / shed), tenant
  quotas, class expiry;
- ``batcher.py``  — the dynamic micro-batcher: coalesces concurrent
  requests per operation into single backend calls, capped at the
  sigbackend's quarter-pow2 bucket shapes;
- ``pipeline.py`` — double-buffered dispatch: host-side aggregation of
  batch N+1 overlaps the dispatch of batch N, on one dispatch thread;
- ``backend.py``  — ``ServingSigBackend``: the drop-in `SigBackend`
  wrapper plus the async ``submit()`` future API, and
  ``ClassedSigBackend``, its fixed-class view.
"""

from gethsharding_tpu_torch.serving.backend import (  # noqa: F401
    ClassedSigBackend,
    ServingConfig,
    ServingSigBackend,
)
from gethsharding_tpu_torch.serving.batcher import (  # noqa: F401
    SERVING_OPS,
    MicroBatcher,
)
from gethsharding_tpu_torch.serving.classes import (  # noqa: F401
    ADMISSION_CLASSES,
    CLASS_BULK_AUDIT,
    CLASS_CATCHUP,
    CLASS_INTERACTIVE,
    admission_class,
)
from gethsharding_tpu_torch.serving.pipeline import (  # noqa: F401
    PipelinedDispatcher,
)
from gethsharding_tpu_torch.serving.queue import (  # noqa: F401
    AdmissionQueue,
    ClassDeadlineExceeded,
    QueueClosed,
    Request,
    ServingOverloadError,
    TenantQuotaExceeded,
)
