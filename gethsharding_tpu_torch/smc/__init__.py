"""The SMC helpers the vote batch and the stress builder need."""
