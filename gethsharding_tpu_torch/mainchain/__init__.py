"""How the port's actors reach the chain hosting the SMC: `SMCClient` on
the in-process `SimulatedMainchain`, its accounts, and the bulk reads of
`mirror.py`."""

from gethsharding_tpu_torch.mainchain.accounts import (  # noqa: F401
    Account,
    AccountManager,
)
from gethsharding_tpu_torch.mainchain.client import SMCClient  # noqa: F401
