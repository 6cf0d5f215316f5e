"""The Sharding Manager Contract on the port: the scalar state machine
(`state_machine.SMC`), the in-process mainchain that hosts it
(`chain.SimulatedMainchain`, whose vote-log replay check runs the batched
vote kernel of `ops/smc.py`) and the dev chain's consensus engine
(`engine.FakeEngine`)."""
