"""Host-side ed25519: the pure-Python RFC 8032 module and `PubKey`."""
