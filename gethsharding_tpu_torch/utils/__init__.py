"""Byte wrappers and the RLP codec the port's transactions and trie need."""
