"""The storage pieces the DAS verifier needs: the BMT chunk hash and the
netstore chunk address."""
