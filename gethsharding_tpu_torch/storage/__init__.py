"""Content-addressed chunk storage (the port's copy of the JAX package's
`storage/`): the BMT chunk hash (`bmt`), the tree chunker over a KV store
(`chunker`) and the networked chunk store over shardp2p (`netstore`), which
the DAS plane files and serves extended chunks through."""
