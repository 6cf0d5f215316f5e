"""Host scalar crypto the port needs: keccak256, the bn256 subset and
secp256k1 ECDSA."""
