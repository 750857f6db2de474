"""Networks of the port, in torch's (B, C, L) layout."""
