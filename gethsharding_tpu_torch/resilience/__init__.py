"""Fault-tolerance layer of the port: the retry executor of the notary's
shardp2p body fetch, the DAS fetchers and the netstore, and the
crash-safe vote journal (the parts of the JAX package's `resilience/`
that the node needs; the breaker, watchdog, chaos and soundness wrappers
wait, ROADMAP.md queue A).

- ``errors.py``  — `TransientError`, `FetchAborted`;
- ``policy.py``  — `RetryPolicy` (with its deadline), `RetryExecutor`,
  `poll_probe`, `DEFAULT_RETRYABLE`;
- ``journal.py`` — `VoteJournal`: (shard, period) votes and the audit
  high-water mark through `db/kv`, replayed on notary start.
"""

from gethsharding_tpu_torch.resilience.errors import (  # noqa: F401
    FetchAborted,
    TransientError,
)
from gethsharding_tpu_torch.resilience.journal import VoteJournal  # noqa: F401
from gethsharding_tpu_torch.resilience.policy import (  # noqa: F401
    DEFAULT_RETRYABLE,
    POLL_MISS,
    RetryExecutor,
    RetryPolicy,
    poll_probe,
)
