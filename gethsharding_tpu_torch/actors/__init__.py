"""Actor services of the port: notary, proposer, observer, syncer,
simulator, txpool (each a `base.Service`; `node/backend.py::ShardNode`
composes them). Import them from their modules: this package imports
nothing, so `mainchain/mirror.py` can build on `actors/base.py`."""
