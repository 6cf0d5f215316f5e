"""Host scalar crypto the port needs: keccak256 and the bn256 subset."""
